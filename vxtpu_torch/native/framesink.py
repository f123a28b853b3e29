"""ctypes binding of the repository's native asynchronous frame sink,
``native/framesink.cpp`` (counterpart of ``vxtpu/native/framesink.py``):
a C++ worker pool that PNG-encodes and writes frames off the render loop.
Built with g++ at first use into ``vxtpu_torch/_build/``. Host I/O, not a
device kernel.
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
SRC = _PKG.parent / "native" / "framesink.cpp"
BUILD_DIR = _PKG / "_build"
_FLAGS = ["-O2", "-shared", "-fPIC", "-std=c++17", "-pthread"]
_LIB = None
_LIB_ERR: str | None = None


def _build_lib() -> Path:
    if not SRC.exists():
        raise RuntimeError(f"{SRC} not found")
    h = hashlib.sha256(" ".join(_FLAGS).encode() + SRC.read_bytes())
    out = BUILD_DIR / f"libvxframesink_{h.hexdigest()[:16]}.so"
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
        lib.fs_create.restype = ctypes.c_void_p
        lib.fs_create.argtypes = [ctypes.c_int, ctypes.c_int]
        lib.fs_submit.restype = None
        lib.fs_submit.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                  ctypes.c_int, ctypes.c_int, u8p]
        lib.fs_flush.restype = ctypes.c_long
        lib.fs_flush.argtypes = [ctypes.c_void_p]
        lib.fs_destroy.restype = None
        lib.fs_destroy.argtypes = [ctypes.c_void_p]
        lib.fs_write_png.restype = ctypes.c_int
        lib.fs_write_png.argtypes = [ctypes.c_char_p, ctypes.c_int,
                                     ctypes.c_int, u8p]
        _LIB = lib
    except Exception as e:
        _LIB_ERR = str(e)
    return _LIB


def framesink_available() -> bool:
    return _get_lib() is not None


def _to_rgb8(img) -> np.ndarray:
    if hasattr(img, "detach"):
        img = img.detach().cpu().numpy()
    a = np.asarray(img)
    if a.dtype != np.uint8:
        a = (np.clip(a, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
    if a.ndim != 3 or a.shape[2] != 3:
        raise ValueError(f"frames are [H, W, 3], got {a.shape}")
    return np.ascontiguousarray(a)


class FrameSink:
    """Async PNG writer. submit() copies the frame into the native queue and
    returns (bounded backpressure); flush() blocks until every frame is on
    disk and returns the count of failed writes (0 = clean)."""

    def __init__(self, workers: int = 2, max_queue: int = 8):
        lib = _get_lib()
        if lib is None:
            raise RuntimeError(f"native framesink unavailable: {_LIB_ERR}")
        self._lib = lib
        self._h = lib.fs_create(workers, max_queue)

    def submit(self, path: str, img) -> None:
        a = _to_rgb8(img)
        h, w = a.shape[:2]
        self._lib.fs_submit(self._h, path.encode(), w, h,
                            a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))

    def flush(self) -> int:
        return int(self._lib.fs_flush(self._h))

    def close(self) -> None:
        if self._h is not None:
            self._lib.fs_destroy(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.flush()
        self.close()


def write_png(path: str, img) -> None:
    """Synchronous native PNG write (one frame, no pool)."""
    lib = _get_lib()
    if lib is None:
        raise RuntimeError(f"native framesink unavailable: {_LIB_ERR}")
    a = _to_rgb8(img)
    h, w = a.shape[:2]
    if not lib.fs_write_png(path.encode(), w, h,
                            a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))):
        raise IOError(f"native png write failed: {path}")
