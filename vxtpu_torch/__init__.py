"""vxtpu_torch: the PyTorch / CUDA port of vxtpu for NVIDIA Hopper GPUs.

Mirrors vxtpu's layout (world/, camera/, render/, app/). The hard-voxel
march + shade runs in hand-written CUDA kernels (csrc/march.cu, built by
_build.py at first use); each kernel has a plain PyTorch version in the
same module, which runs for CPU tensors. This package never imports JAX
or vxtpu.
"""
