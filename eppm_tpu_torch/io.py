"""Image and flow file I/O in NumPy: Netpbm (PPM/PGM), PNG, Middlebury
.flo and KITTI's 16-bit PNG flow (copies of ``eppm_tpu/io/ppm.py``,
``png.py``, ``flo.py`` and ``kitti.py``, which the port cannot import:
``import eppm_tpu`` imports jax).  Pure Python: the JAX package's optional
native library is not used.

PNM spec: the reference loader ``bao_loadimage_ppm``
(basic/bao_basic.cpp:137-218) reads binary P6; P5 and the ASCII variants
P2/P3 and 16-bit maxval are read as well.  .flo spec
(3rdparty/middlebury/flowIO.cpp): little-endian float32 tag 202021.25,
int32 width, int32 height, then (u, v) float32 pairs in row-major order.
KITTI 2012/2015 flow: a 16-bit RGB PNG, channels 1-2 (u, v) * 64 + 2^15,
channel 3 the validity mask.
"""

from __future__ import annotations

import os
import struct
import zlib
from concurrent.futures import ThreadPoolExecutor

import numpy as np

TAG_FLOAT = 202021.25
IMAGE_EXTS = (".ppm", ".pgm", ".pnm", ".png")

__all__ = ["read_ppm", "write_ppm", "read_png", "write_png", "read_image",
           "read_image_batch", "read_flo", "write_flo", "read_png16",
           "write_png16", "read_kitti_flow", "write_kitti_flow", "TAG_FLOAT",
           "IMAGE_EXTS"]


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


# PNG (spec subset of ``eppm_tpu/io/png.py``: bit depth 8 or 16, gray,
# truecolor or truecolor + alpha, no interlace, no palette)
_PNG_SIG = b"\x89PNG\r\n\x1a\n"
_PNG_CHANNELS = {0: 1, 2: 3, 6: 4}  # colour type -> samples per pixel


def _png_chunk(tag: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))


def write_png(path: str, img: np.ndarray) -> None:
    """Write (H, W[, C]) uint8/uint16 as a gray / RGB / RGBA PNG."""
    img = np.asarray(img)
    if img.dtype == np.uint8:
        depth, arr = 8, np.ascontiguousarray(img)
    elif img.dtype == np.uint16:
        depth, arr = 16, np.ascontiguousarray(img, ">u2")
    else:
        raise ValueError(f"write_png expects uint8/uint16, got {img.dtype}")
    if img.ndim == 2:
        ctype = 0
    elif img.ndim == 3 and img.shape[2] in (3, 4):
        ctype = 2 if img.shape[2] == 3 else 6
    else:
        raise ValueError(f"write_png expects (H,W), (H,W,3) or (H,W,4); "
                         f"got {img.shape}")
    h, w = img.shape[:2]
    ihdr = struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0, 0)
    raw = b"".join(b"\x00" + arr[y].tobytes() for y in range(h))
    with open(path, "wb") as f:
        f.write(_PNG_SIG)
        f.write(_png_chunk(b"IHDR", ihdr))
        f.write(_png_chunk(b"IDAT", zlib.compress(raw, 6)))
        f.write(_png_chunk(b"IEND", b""))


def _png_unfilter(raw: bytes, h: int, w: int, bpp: int) -> np.ndarray:
    """Undo the PNG scanline filters -> (h, w * bpp) uint8 rows; ``bpp``
    is the bytes per pixel (the filter unit).  None, Sub and Up are
    vectorised over the row; Average and Paeth walk the columns,
    vectorised over the bpp byte lanes."""
    stride = w * bpp
    out = np.empty((h, stride), np.uint8)
    pos = 0
    prev = np.zeros(stride, np.int32)
    for y in range(h):
        ftype = raw[pos]
        pos += 1
        line = np.frombuffer(raw, np.uint8, stride, pos).astype(np.int32)
        pos += stride
        if ftype == 0:
            cur = line
        elif ftype == 1:  # Sub: modular running sums per byte lane
            cur = line.copy()
            for r in range(bpp):
                cur[r::bpp] = np.cumsum(cur[r::bpp]) & 0xFF
        elif ftype == 2:  # Up
            cur = (line + prev) & 0xFF
        elif ftype in (3, 4):  # Average, Paeth
            px = line.reshape(w, bpp)
            up = prev.reshape(w, bpp)
            cur2 = np.empty((w, bpp), np.int32)
            left = np.zeros(bpp, np.int32)
            upleft = np.zeros(bpp, np.int32)
            for x in range(w):
                if ftype == 3:
                    pred = (left + up[x]) >> 1
                else:
                    p = left + up[x] - upleft
                    pa, pb, pc = (np.abs(p - left), np.abs(p - up[x]),
                                  np.abs(p - upleft))
                    pred = np.where((pa <= pb) & (pa <= pc), left,
                                    np.where(pb <= pc, up[x], upleft))
                left = (px[x] + pred) & 0xFF
                upleft = up[x]
                cur2[x] = left
            cur = cur2.reshape(stride)
        else:
            raise ValueError(f"unsupported PNG filter {ftype}")
        out[y] = cur.astype(np.uint8)
        prev = cur
    return out


def read_png(path: str) -> np.ndarray:
    """Read a PNG -> (H, W) or (H, W, C) array, uint8 or uint16."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != _PNG_SIG:
        raise ValueError(f"{path}: not a PNG")
    pos = 8
    idat = b""
    w = h = depth = ctype = None
    while pos + 8 <= len(data):
        (length,) = struct.unpack(">I", data[pos : pos + 4])
        tag = data[pos + 4 : pos + 8]
        body = data[pos + 8 : pos + 8 + length]
        pos += 12 + length
        if tag == b"IHDR":
            w, h, depth, ctype, _, _, ilace = struct.unpack(">IIBBBBB", body)
            if depth not in (8, 16) or ctype not in _PNG_CHANNELS or ilace:
                raise ValueError(
                    f"{path}: only 8/16-bit gray/RGB/RGBA non-interlaced "
                    f"PNGs supported (depth={depth} ctype={ctype} "
                    f"interlace={ilace})")
        elif tag == b"IDAT":
            idat += body
        elif tag == b"IEND":
            break
    if w is None:
        raise ValueError(f"{path}: missing IHDR chunk")
    nch = _PNG_CHANNELS[ctype]
    rows = _png_unfilter(zlib.decompress(idat), h, w, nch * (depth // 8))
    if depth == 8:
        out = rows.reshape(h, w, nch)
    else:
        pairs = rows.reshape(h, w, nch, 2).astype(np.uint16)
        out = pairs[..., 0] * 256 + pairs[..., 1]
    return out[:, :, 0] if nch == 1 else out


def write_png16(path: str, img: np.ndarray) -> None:
    """Write (H, W, 3) uint16 as a 16-bit truecolor PNG."""
    img = np.asarray(img)
    if img.ndim != 3 or img.shape[2] != 3:
        raise ValueError("write_png16 expects (H, W, 3)")
    write_png(path, img.astype(np.uint16))


def read_png16(path: str) -> np.ndarray:
    """Read a 16-bit truecolor PNG -> (H, W, 3) uint16."""
    img = read_png(path)
    if img.dtype != np.uint16 or img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"{path}: expected 16-bit truecolor PNG, got "
                         f"{img.dtype} shape {img.shape}")
    return img


def read_kitti_flow(path: str):
    """A KITTI flow PNG -> (flow (H, W, 2) float32, valid (H, W) bool);
    the flow is 0 where it is not valid."""
    img = read_png16(path)
    flow = (img[..., :2].astype(np.float32) - 2**15) / 64.0
    valid = img[..., 2] > 0
    flow[~valid] = 0.0
    return flow, valid


def write_kitti_flow(path: str, flow, valid=None) -> None:
    """Write (H, W, 2) flow (and an (H, W) validity mask, all valid by
    default) as a KITTI flow PNG: 1/64 px, rounded, clipped to 16 bits."""
    flow = np.asarray(flow, np.float32)
    h, w = flow.shape[:2]
    if valid is None:
        valid = np.ones((h, w), bool)
    out = np.zeros((h, w, 3), np.uint16)
    q = np.clip(flow * 64.0 + 2**15, 0, 2**16 - 1)
    out[..., :2] = (q + 0.5).astype(np.uint16)
    out[..., 2] = np.asarray(valid).astype(np.uint16)
    write_png16(path, out)


def read_image(path: str) -> np.ndarray:
    """A frame as (H, W, 3) RGB from PPM/PGM/PNM or PNG, or as a last
    resort from anything PIL reads, converted to RGB
    (``eppm_tpu/io/__init__.py::read_image``): gray replicated to three
    channels, alpha dropped, a 16-bit PNG scaled to uint8.  PIL is
    imported only for such a file, and its absence raises ValueError."""
    low = path.lower()
    if low.endswith((".ppm", ".pgm", ".pnm")):
        img = read_ppm(path)
    elif low.endswith(".png"):
        img = read_png(path)
        if img.dtype == np.uint16:
            img = (img // 257).astype(np.uint8)
    else:
        try:
            from PIL import Image
        except ImportError as e:
            raise ValueError(f"{path}: only {'/'.join(IMAGE_EXTS)} are read "
                             f"without PIL ({e})")
        with Image.open(path) as im:
            return np.asarray(im.convert("RGB"))
    if img.ndim == 2:
        img = np.repeat(img[..., None], 3, axis=2)
    elif img.shape[2] == 4:
        img = img[..., :3]
    return np.ascontiguousarray(img)


def read_image_batch(paths, nthreads: int = 0) -> np.ndarray:
    """(N, H, W, 3) uint8 stack of same-shaped frames, decoded on a thread
    pool (zlib and file reads release the interpreter lock)."""
    paths = list(paths)
    nthreads = nthreads or min(8, os.cpu_count() or 1)
    with ThreadPoolExecutor(max_workers=nthreads) as ex:
        return np.stack(list(ex.map(read_image, paths)))
