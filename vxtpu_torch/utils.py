"""Image helpers: a dependency-free PNG writer and reader (PyTorch's GPU
installs need not ship an imaging library, and the cross-check frame in
``vxtpu_torch/data`` is a PNG)."""

from __future__ import annotations

import struct
import zlib

import numpy as np
import torch


def to_uint8_image(img) -> np.ndarray:
    """[H, W, 3] float in [0, 1] -> uint8 (round to nearest, no gamma)."""
    if isinstance(img, torch.Tensor):
        img = img.detach().cpu().numpy()
    return (np.clip(np.asarray(img), 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)


def _chunk(tag: bytes, data: bytes) -> bytes:
    crc = zlib.crc32(tag + data) & 0xFFFFFFFF
    return struct.pack(">I", len(data)) + tag + data + struct.pack(">I", crc)


def save_png(path: str, img) -> None:
    """Write an [H, W, 3] float image in [0, 1] as an 8-bit RGB PNG."""
    arr = to_uint8_image(img)
    h, w, c = arr.shape
    if c != 3:
        raise ValueError(f"save_png wants [H, W, 3], got {arr.shape}")
    raw = np.concatenate([np.zeros((h, 1), np.uint8), arr.reshape(h, w * 3)],
                         axis=1)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)))
        f.write(_chunk(b"IDAT", zlib.compress(raw.tobytes(), 9)))
        f.write(_chunk(b"IEND", b""))


def load_png(path: str) -> np.ndarray:
    """Read an 8-bit RGB PNG as ``save_png`` writes it (one IDAT stream,
    filter type 0 on every row) -> uint8 [H, W, 3]."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError(f"{path}: not a PNG")
    pos, idat, hdr = 8, [], None
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        tag = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + length]
        if tag == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat.append(body)
        pos += 12 + length
    w, h, depth, ctype, _, _, interlace = hdr
    if (depth, ctype, interlace) != (8, 2, 0):
        raise ValueError(f"{path}: not an 8-bit RGB non-interlaced PNG")
    rows = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    rows = rows.reshape(h, w * 3 + 1)
    if rows[:, 0].any():
        raise ValueError(f"{path}: rows use PNG filters; save_png writes none")
    return rows[:, 1:].reshape(h, w, 3).copy()
