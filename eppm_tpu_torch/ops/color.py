"""Colour utilities and the Middlebury flow visualisation (counterpart of
``eppm_tpu/ops/color.py``).

Spec sources: luminance 0.3R + 0.6G + 0.1B (bao_pmflow_census_kernel.cu:41;
the one copy lives in ``ops/census.py``); the Middlebury colour wheel (55
entries; RY=15, YG=6, GC=4, CB=11, BM=13, MR=6: 3rdparty/middlebury/
colorcode.cpp, device rewrite basic/bao_basic_cuda.cuh:743-845).  The
visualisation runs on the flow's device.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..config import UNKNOWN_FLOW_THRESH
from ._util import f32, fma32, inv32
from .census import luminance

__all__ = [
    "rgb2yuv", "yuv2rgb", "rgb2luv", "luminance", "make_color_wheel",
    "flow_to_color",
]


def _lin3(img: torch.Tensor, c0: float, c1: float, c2: float,
          const: float = 0.0) -> torch.Tensor:
    """c0 R + c1 G + c2 B + const as XLA's CPU backend evaluates the JAX
    package's expression: the first product fused into the first sum, the
    third fused into the next, the constants folded into one sum."""
    acc = fma32(img[..., 0], f32(c0), img[..., 1] * f32(c1))
    acc = fma32(img[..., 2], f32(c2), acc)
    return acc + f32(const) if const else acc


def rgb2yuv(img: torch.Tensor) -> torch.Tensor:
    """BT.601-style RGB -> YUV on uint8-range values with the reference's
    coefficients, +128 chroma offset, +0.5 rounding and [0, 255] clamp
    (bao_rgb2yuv_pixel, basic/bao_basic.h:736-746)."""
    y = _lin3(img, 0.299, 0.587, 0.114, 0.5)
    u = _lin3(img, -0.169, -0.331, 0.5, 128.0 + 0.5)
    v = _lin3(img, 0.5, -0.419, -0.081, 128.0 + 0.5)
    return torch.stack([y, u, v], -1).clamp(0.0, 255.0)


def yuv2rgb(img: torch.Tensor) -> torch.Tensor:
    """Inverse of ``rgb2yuv`` with the reference's (asymmetric)
    coefficients (bao_yuv2rgb_pixel, basic/bao_basic.h:757-770)."""
    y = img[..., 0]
    u = img[..., 1] - 128.0
    v = img[..., 2] - 128.0
    r = fma32(v, f32(1.4), y)
    g = fma32(v, f32(-0.71417), fma32(u, f32(-0.3437), y))
    b = fma32(u, f32(1.77), y)
    return (torch.stack([r, g, b], -1) + 0.5).clamp(0.0, 255.0)


def rgb2luv(img: torch.Tensor) -> torch.Tensor:
    """RGB (uint8 range) -> CIE LUV rescaled to [0, 255] per channel
    (bao_rgb2luv_pixel, basic/bao_basic.h:629-670).  XLA's CPU arithmetic
    of the JAX package's expression: a product of constants folded into
    one float32 constant, a product feeding a sum fused (``fma32``), the
    cube root as x ** float32(1/3)."""
    x = _lin3(img, 0.4125, 0.3576, 0.1804)
    y = _lin3(img, 0.2125, 0.7154, 0.0721)
    z = _lin3(img, 0.0193, 0.1192, 0.9502)
    l0 = y * inv32(255.0)
    # XLA's cube root is pow(x, float32(1/3)): taken in float64, rounded
    cbrt = l0.to(torch.float64).pow(f32(1.0 / 3.0)).to(torch.float32)
    L = torch.where(l0 > f32(0.008856), fma32(cbrt, 116.0, -16.0),
                    y * _fold(903.3, 255.0))
    const = fma32(z, 3.0, fma32(y, 15.0, x))
    nz = const != 0
    den = torch.where(nz, const, 1.0)
    u_p = torch.where(nz, x * 4.0 / den, 4.0)
    v_p = torch.where(nz, y * 9.0 / den, f32(0.6))
    l13 = L * 13.0
    us = fma32(l13, u_p + f32(-0.19784977571475), f32(83.138))
    vs = fma32(l13, v_p + f32(-0.46834507665248), f32(134.104))
    return torch.stack([
        L * _fold(255.0, 100.0),
        (us * _fold(255.0, 258.343)).clamp_max(255.0),
        (vs * _fold(255.0, 241.518)).clamp_max(255.0),
    ], -1)


def _fold(a: float, b: float) -> float:
    """a / b as XLA folds ``(t * a) / b`` and ``(t / b) * a``: float32(a)
    times the float32 reciprocal of b, rounded to float32."""
    return float(np.float32(a) * np.float32(inv32(b)))


def make_color_wheel() -> np.ndarray:
    """55x3 float colour wheel in [0, 1] (colorcode.cpp makecolorwheel)."""
    RY, YG, GC, CB, BM, MR = 15, 6, 4, 11, 13, 6
    segments = [
        (RY, lambda t: (1.0, t, 0.0)),
        (YG, lambda t: (1.0 - t, 1.0, 0.0)),
        (GC, lambda t: (0.0, 1.0, t)),
        (CB, lambda t: (0.0, 1.0 - t, 1.0)),
        (BM, lambda t: (t, 0.0, 1.0)),
        (MR, lambda t: (1.0, 0.0, 1.0 - t)),
    ]
    rows = [f(i / n) for n, f in segments for i in range(n)]
    return np.asarray(rows, dtype=np.float64)


def flow_to_color(flow: torch.Tensor,
                  max_rad: Optional[float] = None) -> torch.Tensor:
    """Middlebury colour coding of an (H, W, 2) flow -> (H, W, 3) uint8 on
    the flow's device.  ``max_rad`` None normalises by the largest flow
    magnitude in the image (flow_tools.cpp:200-231), else by ``max_rad``;
    unknown flow renders black."""
    u, v = flow[..., 0], flow[..., 1]
    unknown = (u.abs() > UNKNOWN_FLOW_THRESH) | (v.abs() > UNKNOWN_FLOW_THRESH)
    u = torch.where(unknown, 0.0, u)
    v = torch.where(unknown, 0.0, v)
    rad = torch.sqrt(u * u + v * v)
    if max_rad is None:
        norm = rad.max().clamp_min(1e-9)
    else:
        norm = torch.tensor(max(float(max_rad), 1e-9), dtype=torch.float32,
                            device=flow.device)
    u, v, rad = u / norm, v / norm, rad / norm
    wheel = torch.from_numpy(make_color_wheel().astype(np.float32)).to(
        flow.device)
    ncols = wheel.shape[0]
    a = torch.atan2(-v, -u) / np.float32(np.pi)
    fk = (a + 1.0) / 2.0 * (ncols - 1)
    k0 = torch.floor(fk).to(torch.int64)
    k1 = (k0 + 1) % ncols
    f = (fk - k0)[..., None]
    col = (1.0 - f) * wheel[k0] + f * wheel[k1]
    radc = rad.clamp_min(0.0)[..., None]
    col = torch.where(radc <= 1.0, 1.0 - radc * (1.0 - col), col * 0.75)
    col = torch.where(unknown[..., None], 0.0, col)
    return (255.0 * col).to(torch.uint8)
