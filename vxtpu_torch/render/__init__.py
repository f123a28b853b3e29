"""March and shade (the CUDA kernels, their plain versions, fused frames,
the composable pipeline) and the differentiable soft renderers (plain,
and on the field-sampling kernels)."""
