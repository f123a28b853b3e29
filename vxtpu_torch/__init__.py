"""vxtpu_torch: the PyTorch / CUDA port of vxtpu for NVIDIA Hopper GPUs.

Mirrors vxtpu's layout (world/, camera/, render/, train/, app/, obs/,
native/). The hard-voxel marches (fused with shading, and the row-major
march of the composable pipeline) and the soft renderer's field
sampling run in hand-written CUDA kernels (csrc/march.cu,
csrc/march_packed.cu, csrc/sample.cu, built by _build.py at first use); each kernel has a plain PyTorch version in the
same module, which runs for CPU tensors. Entry points make their tensors
on the GPU unless asked for the CPU (device.py). This package never
imports JAX or vxtpu.
"""
