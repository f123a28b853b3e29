"""March and shade: the CUDA kernels, their plain versions, fused frames."""
