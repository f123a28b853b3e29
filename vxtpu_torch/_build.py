"""Build and load the CUDA kernels of ``vxtpu_torch/csrc``.

The sources are compiled at first use with nvcc, one nvcc process per
source, all started together, and linked into one shared library with a
plain C interface, loaded with ctypes (no PyTorch headers, so the build
takes seconds). The library lands in ``vxtpu_torch/_build/`` under a name
derived from a hash of the sources and flags, so an edit to a source
rebuilds it. A failed build raises with nvcc's output.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_PKG = Path(__file__).resolve().parent
SRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P, _I = ctypes.c_void_p, ctypes.c_int


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").exists():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA "
                           "kernels of vxtpu_torch are built with it")
    return found


def _sources() -> list[Path]:
    return sorted(SRC_DIR.glob("*.cu"))


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libvxtpu_torch_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile csrc/*.cu into the shared library unless it exists; returns
    its path. nvcc's output (ptxas register and spill counts) is kept in
    a ``.log`` file beside the library."""
    so = library_path()
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    tag = f"{so.stem}.{os.getpid()}"
    jobs = []
    for src in _sources():
        obj = BUILD_DIR / f"{tag}.{src.stem}.o"
        cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
        jobs.append((cmd, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    log, failed = [], None
    for cmd, _, proc in jobs:
        out, _ = proc.communicate()
        log.append(f"$ {' '.join(cmd)}\n{out}")
        if proc.returncode and failed is None:
            failed = (cmd, proc.returncode, out)
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    if failed is None:
        cmd = [nvcc, "-shared", "-o", str(tmp), *(str(o) for _, o, _ in jobs)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        log.append(f"$ {' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
        if proc.returncode:
            failed = (cmd, proc.returncode, proc.stdout + proc.stderr)
    for _, obj, _ in jobs:
        obj.unlink(missing_ok=True)
    so.with_suffix(".log").write_text("".join(log))
    if failed is not None:
        cmd, rc, out = failed
        raise RuntimeError(f"nvcc failed ({rc}):\n{' '.join(cmd)}\n{out}")
    os.replace(tmp, so)
    return so


@functools.cache
def load() -> ctypes.CDLL:
    """Build if needed, load, and declare the C entry points."""
    lib = ctypes.CDLL(str(build()))
    lib.vx_march_shade.argtypes = [
        _P, _P, _P, _I, _P, _I, _I, _I, _I, _P, _P, _P,   # inputs, params
        _P, _P, _P, _P, _P, _P,                           # outputs
        _P]                                               # stream
    lib.vx_march_shade.restype = _I
    lib.vx_march_shade_blocks_per_sm.argtypes = [_I, _I]
    lib.vx_march_shade_blocks_per_sm.restype = _I
    lib.vx_shade.argtypes = [_P, _P, _P, _P, _P, _P, _P, _I, _P, _I, _P, _P,
                             _P, _P]
    lib.vx_shade.restype = _I
    lib.vx_march_resume.argtypes = [
        _P, _P, _P, _I, _P, _P, _P, _P, _I, _I, _I, _I,   # inputs, params
        _P, _P, _P, _P, _P, _P, _P,                       # outputs
        _P]                                               # stream
    lib.vx_march_resume.restype = _I
    lib.vx_march_probe.argtypes = [
        _P, _P, _I, _P, _I, _I, _I, _I, _I, _I, _I, _I,   # inputs, params
        _P,                                               # output
        _P]                                               # stream
    lib.vx_march_probe.restype = _I
    lib.vx_march_probe_blocks_per_sm.argtypes = [_I, _I, _I, _I, _I, _I, _I]
    lib.vx_march_probe_blocks_per_sm.restype = _I
    lib.vx_march_packed.argtypes = [
        _P, _P, _P, _I, _P, _I, _I, _I, _I,               # inputs, params
        _P, _P, _P, _P, _P,                               # outputs
        _P]                                               # stream
    lib.vx_march_packed.restype = _I
    lib.vx_march_packed_blocks_per_sm.argtypes = []
    lib.vx_march_packed_blocks_per_sm.restype = _I
    lib.vx_sample_fwd.argtypes = [_P, _P, _P, _P, _I, _I, _P, _I, _I, _P,
                                  _P]
    lib.vx_sample_fwd.restype = _I
    lib.vx_sample_bwd.argtypes = [_P, _P, _P, _P, _I, _I, _P, _I, _I, _I, _I,
                                  _P, _P, _P, _P]
    lib.vx_sample_bwd.restype = _I
    lib.vx_sample_ray_sum.argtypes = [_P, _I, _I, _P, _P, _P, _P, _P]
    lib.vx_sample_ray_sum.restype = _I
    _L, _F = ctypes.c_int64, ctypes.c_float
    lib.vx_tv_fwd.argtypes = [_P, _L, _F, _F, _P, _I, _P, _P]
    lib.vx_tv_fwd.restype = _I
    lib.vx_tv_bwd.argtypes = [_P, _L, _P, _F, _F, _P, _P]
    lib.vx_tv_bwd.restype = _I
    lib.vx_adam_step.argtypes = [_P, _P, _P, _P, _L, _F, _F, _F, _F, _F, _F,
                                 _P]
    lib.vx_adam_step.restype = _I
    lib.vx_error_string.argtypes = [_I]
    lib.vx_error_string.restype = ctypes.c_char_p
    return lib


def error_string(code: int) -> str:
    return f"{code} ({load().vx_error_string(code).decode()})"
