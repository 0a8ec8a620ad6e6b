"""Image resampling: Gaussian filter, bilinear resize, Gaussian pyramid
(counterpart of ``eppm_tpu/ops/resize.py``, same index arithmetic and
the same order of float operations).

Spec (reference ``basic/bao_basic_cuda.cuh``):
  - Gaussian filter (:397-481): edge-clamped taps, separable, the weights
    normalized over the full window.
  - Bilinear resize (:484-615): source coordinate fx = (x+1)/ratio - 1,
    taps at clamp(floor(fx)) and clamp(floor(fx)+1), weight
    clip(fx - floor(fx), 0, 1).  ``torch.nn.functional.interpolate`` uses
    another coordinate rule, so the indices are built here.
  - Gaussian pyramid (:619-664): level i filters level 0 with sigma
    i*baseSigma (radius 3 sigma), then resizes by ratio**i.

All functions take float tensors of shape (H, W) or (H, W, C).
"""

from __future__ import annotations

import functools
import math
from typing import List, Sequence, Tuple

import numpy as np
import torch

from ._util import fma32, inv32, pad_edge

__all__ = ["gaussian_filter", "bilinear_resize", "gaussian_pyramid",
           "pyramid_dims"]


def gaussian_filter(
    img: torch.Tensor, sigma: float, radius: int, raw_u8=None
) -> torch.Tensor:
    """Gaussian blur with edge-replicated taps (bao_basic_cuda.cuh:397-417).

    ``raw_u8`` is the uint8 frame that ``img`` was normalized from
    (img = float(raw_u8) * f32(1/255)).  The JAX program reads the centre
    tap of its first (vertical) pass from the raw frame, with 1/255 folded
    into the tap weight: float(raw_u8) * f32(w_c * f32(1/255)), the other
    taps from ``img`` (XLA's optimized HLO of the pre-smoothing); passing
    the raw frame reproduces that rounding."""
    if radius <= 0:
        return img
    k = np.arange(-radius, radius + 1, dtype=np.float64)
    w = np.exp(-(k * k) / (2.0 * sigma * sigma))
    w = (w / w.sum()).astype(np.float32)
    for axis in (0, 1):
        padded = pad_edge(img, radius if axis == 0 else 0,
                          radius if axis == 1 else 0)
        taps = [padded.narrow(axis, i, img.shape[axis]) for i in range(len(w))]
        ws = [float(wi) for wi in w]
        if raw_u8 is not None and axis == 0:
            taps[radius] = raw_u8.to(torch.float32)
            ws[radius] = float(w[radius] * np.float32(inv32(255.0)))
        # the multiply-adds fuse as XLA's CPU backend fuses them:
        # fma(t0, w0, t1*w1), then fma(t_i, w_i, acc)
        acc = fma32(taps[0], ws[0], taps[1] * ws[1])
        for t, wi in zip(taps[2:], ws[2:]):
            acc = fma32(t, wi, acc)
        img = acc
    return img


def _resize_axis_indices(
    out_size: int, in_size: int, ratio: float, shift: int = 0
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Static (i0, i1, frac) for one axis, reference semantics: floor
    (equal to the reference's truncation wherever both are defined, see
    ``eppm_tpu/ops/resize.py::_resize_axis_indices``), clip, (x+1)/r-1.
    ``shift`` offsets the taps for an input tile carrying ``shift`` halo
    rows or columns (floor commutes with the integer shift)."""
    x = np.arange(out_size, dtype=np.float64)
    fx = (x + 1.0) / ratio - 1.0
    xx = np.floor(fx)
    dx = np.clip(fx - xx, 0.0, 1.0)
    i0 = np.clip(xx.astype(np.int64) + shift, 0, in_size - 1)
    i1 = np.clip(xx.astype(np.int64) + 1 + shift, 0, in_size - 1)
    return i0, i1, dx.astype(np.float32)


@functools.lru_cache(maxsize=None)
def _axis_tables(out_size: int, in_size: int, ratio: float, shift: int,
                 device: torch.device):
    """``_resize_axis_indices`` on ``device``: (i0, i1) int64 and frac
    float32, made once per set and never freed, so a resize copies
    nothing from the host (a copy would wait for the device, and a CUDA
    graph holds the tables' addresses).  A pair needs a few sets per
    level."""
    return tuple(torch.from_numpy(a).to(device)
                 for a in _resize_axis_indices(out_size, in_size, ratio,
                                               shift))


def bilinear_resize(
    img: torch.Tensor, out_h: int, out_w: int, ratio: float,
    fused: bool = False, shift: int = 0,
) -> torch.Tensor:
    """Bilinear resize with the reference's coordinate mapping; ``ratio``
    is out/in scale (0.5**i for pyramid levels, 2.0 for flow upsampling).
    ``fused``: each a * (1 - f) + b * f as XLA's CPU backend fuses it
    where the resize makes up its own program (the temporal init,
    ``pipeline._coarse_init``): fma32(a, 1 - f, b * f).  ``shift``: the
    input is a tile with ``shift`` halo rows and columns on each side
    and the output the tile's own upsampled pixels (the clamps then bind
    at the halo's edge, which holds the globally clamped values)."""
    h, w = img.shape[0], img.shape[1]
    y0, y1, fy = _axis_tables(out_h, h, float(ratio), shift, img.device)
    x0, x1, fx = _axis_tables(out_w, w, float(ratio), shift, img.device)
    tail = (1,) * (img.dim() - 2)
    fy = fy.reshape((-1, 1) + tail)
    fx = fx.reshape((1, -1) + tail)
    r0 = img.index_select(0, y0)
    r1 = img.index_select(0, y1)

    def lerp(a, b, f):
        if fused:
            return fma32(a, 1.0 - f, b * f)
        return a * (1.0 - f) + b * f

    def row(r):
        return lerp(r.index_select(1, x0), r.index_select(1, x1), fx)

    return lerp(row(r0), row(r1), fy)


def pyramid_dims(
    h: int, w: int, max_depth: int, ratio: float = 0.5
) -> List[Tuple[int, int]]:
    """Per-level dims, truncated (bao_basic.h:196-211;
    ``eppm_tpu/ops/resize.py::pyramid_dims``): ``max(max_depth, 1)``
    levels of (int(h * ratio^i), int(w * ratio^i))."""
    depth = max(max_depth, 1)
    return [(int(h * ratio**i), int(w * ratio**i)) for i in range(depth)]


def gaussian_pyramid(
    img: torch.Tensor, dims: Sequence[Tuple[int, int]], ratio: float = 0.5
) -> List[torch.Tensor]:
    """Gaussian pyramid with the reference sigma schedule
    (bao_cuda_construct_gauss_pyramid, bao_basic_cuda.cuh:619-641)."""
    levels = [img]
    base_sigma = 1.0 / ratio - 1.0
    n = int(math.log(0.25) / math.log(ratio))
    n_sigma = base_sigma * n
    w0 = img.shape[1]
    for i in range(1, len(dims)):
        oh, ow = dims[i]
        if i <= n:
            sigma = base_sigma * i
            smoothed = gaussian_filter(img, sigma, int(sigma * 3))
            levels.append(bilinear_resize(smoothed, oh, ow, ratio**i))
        else:
            src = levels[i - n]
            smoothed = gaussian_filter(src, n_sigma, int(n_sigma * 3))
            eff_ratio = (ratio**i) * w0 / src.shape[1]
            levels.append(bilinear_resize(smoothed, oh, ow, eff_ratio))
    return levels
