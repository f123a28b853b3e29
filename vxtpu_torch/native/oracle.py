"""ctypes binding of the repository's native C++ DDA oracle,
``native/dda_oracle.cpp`` (counterpart of ``vxtpu/native/oracle.py``): an
independent per-ray reimplementation of the reference march in C++, for
tests that hold ``render/kernel_ref.march_ref`` to it. Host code, not a
render path. Built with g++ at first use into ``vxtpu_torch/_build/``,
keyed by a hash of the source and the flags.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import numpy as np

_PKG = Path(__file__).resolve().parent.parent
SRC = _PKG.parent / "native" / "dda_oracle.cpp"
BUILD_DIR = _PKG / "_build"
_FLAGS = ["-O2", "-shared", "-fPIC", "-std=c++17"]
_LIB = None
_LIB_ERR: str | None = None


def _build_lib() -> Path:
    if not SRC.exists():
        raise RuntimeError(f"{SRC} not found")
    h = hashlib.sha256(" ".join(_FLAGS).encode() + SRC.read_bytes())
    out = BUILD_DIR / f"libvxoracle_{h.hexdigest()[:16]}.so"
    if out.exists():
        return out
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        raise RuntimeError("no C++ compiler on PATH")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    subprocess.run([cxx, *_FLAGS, "-o", str(tmp), str(SRC)], check=True,
                   capture_output=True, text=True)
    os.replace(tmp, out)
    return out


def _get_lib():
    global _LIB, _LIB_ERR
    if _LIB is not None or _LIB_ERR is not None:
        return _LIB
    try:
        lib = ctypes.CDLL(str(_build_lib()))
        u8p = ctypes.POINTER(ctypes.c_uint8)
        f32p = ctypes.POINTER(ctypes.c_float)
        i32p = ctypes.POINTER(ctypes.c_int32)
        lib.vx_march.restype = None
        lib.vx_march.argtypes = [
            u8p,                                                 # occ
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,      # X, Y, Z
            f32p, f32p,                                          # o, d
            f32p,                                                # t_max
            ctypes.c_int64,                                      # n
            ctypes.c_int32,                                      # max_steps
            u8p, f32p, i32p, f32p, i32p,     # hit, t, voxel, normal, steps
        ]
        _LIB = lib
    except (OSError, RuntimeError, subprocess.CalledProcessError) as e:
        _LIB_ERR = str(e)
    return _LIB


def native_available() -> bool:
    return _get_lib() is not None


def _host(x, dtype) -> np.ndarray:
    if hasattr(x, "detach"):
        x = x.detach().cpu().numpy()
    return np.ascontiguousarray(np.asarray(x, dtype))


def march_native(o, d, occ, dims: tuple[int, int, int], max_steps: int,
                 t_max=None) -> dict:
    """March rays o, d [N, 3] (tensors on any device, or arrays) through
    the occupancy [X, Y, Z] with the native oracle; a dict of numpy
    arrays with HitRecord's fields (hit, t, voxel, normal, steps). t_max:
    optional [N], as ``kernel_ref.march_ref`` reads it."""
    lib = _get_lib()
    if lib is None:
        raise RuntimeError(f"native oracle unavailable: {_LIB_ERR}")
    X, Y, Z = dims
    o, d = _host(o, np.float32), _host(d, np.float32)
    occ = _host(occ, np.uint8).reshape(-1)
    if occ.size != X * Y * Z:
        raise ValueError(f"occupancy of {occ.size} cells for dims {dims}")
    n = o.shape[0]
    if o.shape != (n, 3) or d.shape != (n, 3):
        raise ValueError(f"rays o {o.shape}, d {d.shape}: want [N, 3]")
    t_max = (np.full((n,), 1.0e30, np.float32) if t_max is None
             else _host(t_max, np.float32))

    hit = np.empty((n,), np.uint8)
    t = np.empty((n,), np.float32)
    voxel = np.empty((n, 3), np.int32)
    normal = np.empty((n, 3), np.float32)
    steps = np.empty((n,), np.int32)

    def ptr(a, ty):
        return a.ctypes.data_as(ctypes.POINTER(ty))

    lib.vx_march(ptr(occ, ctypes.c_uint8), X, Y, Z,
                 ptr(o, ctypes.c_float), ptr(d, ctypes.c_float),
                 ptr(t_max, ctypes.c_float), n, max_steps,
                 ptr(hit, ctypes.c_uint8), ptr(t, ctypes.c_float),
                 ptr(voxel, ctypes.c_int32), ptr(normal, ctypes.c_float),
                 ptr(steps, ctypes.c_int32))
    return dict(hit=hit.astype(bool), t=t, voxel=voxel, normal=normal,
                steps=steps)
