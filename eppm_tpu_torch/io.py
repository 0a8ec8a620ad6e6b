"""Image and flow file I/O in NumPy: Netpbm (PPM/PGM) and Middlebury .flo
(copies of ``eppm_tpu/io/ppm.py`` and ``eppm_tpu/io/flo.py``, which the
port cannot import: ``import eppm_tpu`` imports jax).

PNM spec: the reference loader ``bao_loadimage_ppm``
(basic/bao_basic.cpp:137-218) reads binary P6; P5 and the ASCII variants
P2/P3 and 16-bit maxval are read as well.  .flo spec
(3rdparty/middlebury/flowIO.cpp): little-endian float32 tag 202021.25,
int32 width, int32 height, then (u, v) float32 pairs in row-major order.
"""

from __future__ import annotations

import numpy as np

TAG_FLOAT = 202021.25

__all__ = ["read_ppm", "write_ppm", "read_flo", "write_flo", "TAG_FLOAT"]


def _read_tokens(data: bytes, count: int, pos: int):
    """Read whitespace-separated header tokens, skipping '#' comments."""
    tokens = []
    n = len(data)
    while len(tokens) < count:
        while pos < n and data[pos : pos + 1].isspace():
            pos += 1
        if pos < n and data[pos : pos + 1] == b"#":
            while pos < n and data[pos : pos + 1] != b"\n":
                pos += 1
            continue
        start = pos
        while pos < n and not data[pos : pos + 1].isspace():
            pos += 1
        if start == pos:
            raise ValueError("truncated PNM header")
        tokens.append(data[start:pos])
    return tokens, pos


def read_ppm(path: str) -> np.ndarray:
    """Read a PNM file -> uint8/uint16 array of shape (H, W, 3) or (H, W)."""
    with open(path, "rb") as f:
        data = f.read()
    magic = data[:2]
    if magic not in (b"P2", b"P3", b"P5", b"P6"):
        raise ValueError(f"unsupported PNM magic {magic!r} in {path}")
    tokens, pos = _read_tokens(data, 3, 2)
    w, h, maxval = (int(t) for t in tokens)
    if maxval <= 0 or maxval > 65535:
        raise ValueError(f"bad maxval {maxval} in {path}")
    channels = 3 if magic in (b"P3", b"P6") else 1
    dtype = np.uint8 if maxval < 256 else np.dtype(">u2")
    if magic in (b"P5", b"P6"):
        pos += 1  # single whitespace byte after maxval (bao_basic.cpp:171)
        arr = np.frombuffer(data, dtype=dtype, count=w * h * channels,
                            offset=pos)
    else:
        arr = np.array(data[pos:].split(), dtype=np.int64).astype(dtype)
        if arr.size != w * h * channels:
            raise ValueError(f"bad ASCII pixel count in {path}")
    arr = arr.astype(np.uint8 if maxval < 256 else np.uint16)
    return arr.reshape((h, w, 3) if channels == 3 else (h, w))


def write_ppm(path: str, img: np.ndarray) -> None:
    """Write a uint8 array of shape (H, W, 3) as P6 or (H, W) as P5."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise ValueError("write_ppm expects uint8")
    if img.ndim == 3 and img.shape[2] == 3:
        magic, (h, w) = b"P6", img.shape[:2]
    elif img.ndim == 2:
        magic, (h, w) = b"P5", img.shape
    else:
        raise ValueError(f"bad image shape {img.shape}")
    with open(path, "wb") as f:
        f.write(magic + b"\n%d %d\n255\n" % (w, h))
        f.write(img.tobytes())


def read_flo(path: str) -> np.ndarray:
    """Read a .flo file -> float32 array of shape (H, W, 2) as (u, v)."""
    with open(path, "rb") as f:
        tag = np.frombuffer(f.read(4), dtype="<f4")[0]
        if not np.isclose(tag, TAG_FLOAT):
            raise ValueError(f"bad .flo tag {tag} in {path}")
        w, h = np.frombuffer(f.read(8), dtype="<i4")
        if not (0 < w < 99999 and 0 < h < 99999):
            raise ValueError(f"bad .flo dims {w}x{h} in {path}")
        data = np.frombuffer(f.read(int(w) * int(h) * 8), dtype="<f4")
    if data.size != w * h * 2:
        raise ValueError(f"truncated .flo file {path}")
    return data.reshape(int(h), int(w), 2).copy()


def write_flo(path: str, flow: np.ndarray) -> None:
    """Write a float32 (H, W, 2) flow array as .flo."""
    flow = np.asarray(flow, dtype="<f4")
    if flow.ndim != 3 or flow.shape[2] != 2:
        raise ValueError(f"bad flow shape {flow.shape}")
    h, w = flow.shape[:2]
    with open(path, "wb") as f:
        f.write(np.float32(TAG_FLOAT).tobytes())
        f.write(np.array([w, h], dtype="<i4").tobytes())
        f.write(flow.tobytes())
