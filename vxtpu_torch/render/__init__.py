"""March and shade (the CUDA kernels, their plain versions, fused frames)
and the differentiable soft renderers (plain, and on the field-sampling
kernels)."""
