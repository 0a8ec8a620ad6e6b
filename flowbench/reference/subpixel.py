"""Subpixel flow refinement by quadratic cost-surface fitting (counterpart
of ``eppm_tpu/ops/subpixel.py``; the JAX module has no Pallas kernel, so
this stage is plain PyTorch here too).

Spec: ``d_subpixel_refine`` (bao_pmflow_refine_kernel.cu:393-633).  For
each pixel with a valid integer target t: the bilateral AD+census patch
cost at the 5x5 half-pixel grid t + (dx, dy)/2, a least-squares fit of
a x^2 + b y^2 + c xy + d x + e y + f, and the flow moved to the
quadratic's stationary point when it lies within +-3 grid units.  Taps
sample images through the cubic B-spline filter of the NVIDIA bicubic
sampler (bicubicTexture_kernel.cuh:40-105, half-texel origin), census
through a census transform of the 2x bicubic-upsampled image
(bao_pmflow_census_kernel.cu:115-181).  Frame 2 is warped once by the
integer flow, so every tap is a static shift of one of four phase images.

Arithmetic: ``exp_cephes`` where the JAX package calls ``jnp.exp``,
divisions by constants as multiplications by their float32 reciprocals,
every sum in a fixed order (taps one after another, the 6x25 least-squares
operator in float64): the card and the CPU compute the same values.
"""

from __future__ import annotations

import functools
import math
from typing import Tuple

import numpy as np
import torch

from .config import UNKNOWN_FLOW_THRESH, SubpixelConfig
from ._util import (exp_cephes, f32, fma32, grid, inv32, pad_edge,
                    popcount8, shift2d, trunc_i32)
from .census import census_transform
from .cost import maxabs3
from .dense import warp_pack

__all__ = [
    "bspline_weights",
    "bicubic_shift",
    "bicubic_resize2x",
    "census_2x",
    "subpixel_refine",
]

# Taps per chunk: one chunk's frame-2 taps are one (CHUNK, H, W, 3)
# tensor, 622 MB at 1080p.
CHUNK = 25


def bspline_weights(a: float) -> Tuple[float, float, float, float]:
    """Cubic B-spline filter weights w0..w3 at fractional phase ``a``
    (bicubicTexture_kernel.cuh:28-51)."""
    w0 = (1.0 / 6.0) * (-(a**3) + 3 * a * a - 3 * a + 1)
    w1 = (1.0 / 6.0) * (3 * a**3 - 6 * a * a + 4)
    w2 = (1.0 / 6.0) * (-3 * a**3 + 3 * a * a + 3 * a + 1)
    w3 = (1.0 / 6.0) * (a**3)
    return w0, w1, w2, w3


def bicubic_shift(img: torch.Tensor, offy: float, offx: float) -> torch.Tensor:
    """Sample ``img`` at (y + offy, x + offx) for a static fractional
    offset with the reference sampler's semantics: the half-texel origin
    (x -= 0.5), then the separable 4x4 B-spline filter; borders clamp."""

    def axis_pass(a: torch.Tensor, off: float, axis: int) -> torch.Tensor:
        x = off - 0.5
        px = math.floor(x)
        terms = [(px - 1 + k, f32(wk))
                 for k, wk in enumerate(bspline_weights(x - px)) if wk != 0.0]

        def tap(o):
            return shift2d(a, o if axis == 0 else 0, o if axis == 1 else 0)

        # XLA's CPU form of the JAX package's sum t0 + t1 + ...: the
        # second product, then the others fused in (fma32) in order
        acc = tap(terms[1][0]) * terms[1][1]
        for o, wk in terms[:1] + terms[2:]:
            acc = fma32(tap(o), wk, acc)
        return acc

    return axis_pass(axis_pass(img, offy, 0), offx, 1)


def bicubic_resize2x(img: torch.Tensor) -> torch.Tensor:
    """2x bicubic upsampling, the source sampled at (y/2, x/2) as the
    census-2x path reads it (bao_pmflow_census_kernel.cu:115-181)."""
    h, w = img.shape[0], img.shape[1]
    out = img.new_empty((2 * h, 2 * w) + tuple(img.shape[2:]))
    for py in (0, 1):
        for px in (0, 1):
            out[py::2, px::2] = bicubic_shift(img, py * 0.5, px * 0.5)
    return out


def census_2x(img: torch.Tensor) -> torch.Tensor:
    """Census transform of the 2x bicubic-upsampled image -> (2H, 2W)."""
    return census_transform(bicubic_resize2x(img))


def _phases(img: torch.Tensor) -> torch.Tensor:
    """(4, H, W, 3): ``img`` sampled at the half-pixel phases, index
    2 * frac_y + frac_x (value(q + e) = phase[frac(e)](q + floor(e)))."""
    return torch.stack([bicubic_shift(img, fy, fx)
                        for fy in (0.0, 0.5) for fx in (0.0, 0.5)])


def _taps(R: int):
    return [(i, j) for i in range(-R, R + 1, 2) for j in range(-R, R + 1, 2)]


def _positions(nr: int):
    return [(dy, dx) for dy in range(-nr, nr + 1) for dx in range(-nr, nr + 1)]


# The tables below are made once per set and device and never freed: a
# call copies nothing from the host (a copy would wait for the device, and
# a CUDA graph holds the tables' addresses).

@functools.lru_cache(maxsize=None)
def _tap_weights(R: int, sig_s2: float, device: torch.device):
    """The spatial weights of the taps, float32, one (CHUNK, 1, 1) tensor
    a chunk of ``CHUNK`` taps."""
    taps = _taps(R)
    gws = [f32(math.exp(-(j * j) / sig_s2) * math.exp(-(i * i) / sig_s2))
           for i, j in taps]
    return [torch.tensor(gws[c0 : c0 + CHUNK], dtype=torch.float32,
                         device=device)[:, None, None]
            for c0 in range(0, len(taps), CHUNK)]


@functools.lru_cache(maxsize=None)
def _fit_operator(nr: int, device: torch.device) -> torch.Tensor:
    """pinv(A) of the quadratic's design matrix over the positions, the
    pseudo-inverse in float64 numpy, rounded to float32 values and held
    as float64 (6, (2 nr + 1)^2)."""
    A = np.asarray([[dx * dx, dy * dy, dx * dy, dx, dy, 1.0]
                    for (dy, dx) in _positions(nr)], np.float64)
    P = torch.from_numpy(np.linalg.pinv(A).astype(np.float32))
    return P.to(device).double()


def subpixel_refine(
    flow: torch.Tensor,
    img1: torch.Tensor,
    img2: torch.Tensor,
    cfg: SubpixelConfig = SubpixelConfig(),
) -> torch.Tensor:
    """Quadratic-fit subpixel refinement of an integer flow field.

    flow: (H, W, 2); img1/img2: (H, W, 3) in [0, 1].  Returns the refined
    flow; pixels whose fit is rejected (stationary point beyond +-3
    half-pixels, degenerate quadratic, unknown flow or out-of-image
    target) keep their input flow."""
    h, w = img1.shape[0], img1.shape[1]
    dev = flow.device
    up = cfg.up_factor
    R = cfg.patch_radius
    nr = cfg.neighborhood_radius
    sig_s2 = cfg.sigma_spatial**2
    inv_lam_ad2 = inv32(0.1 * 0.1)          # LAMBDA_AD (defs.h:51)
    inv_lam_cen2 = inv32((0.3 * 8) ** 2)    # LAMBDA_CENSUS * CENSUS_MAX_DIFF
    inv_sig_r2 = inv32(cfg.sigma_range**2)

    ys, xs = grid(h, w, dev)
    u, v = flow[..., 0], flow[..., 1]
    unknown = (u > UNKNOWN_FLOW_THRESH) | (v > UNKNOWN_FLOW_THRESH)
    gx = trunc_i32(torch.where(unknown, 0.0, u))
    gy = trunc_i32(torch.where(unknown, 0.0, v))
    tx, ty = xs + gx, ys + gy
    valid = ~unknown & (tx >= 0) & (tx < w) & (ty >= 0) & (ty < h)

    # warp once: every frame-2 tap becomes a static shift of J
    pack2 = torch.cat([img2, torch.zeros_like(img2[..., :1])], -1)
    center1 = img1
    center2 = warp_pack(pack2, gx, gy)[..., :3]  # img2 at the integer target
    PAD = R + nr + 2
    PAD2 = 2 * PAD
    ph1 = torch.stack([pad_edge(p, PAD, PAD) for p in _phases(center1)])
    ph2 = torch.stack([pad_edge(p, PAD, PAD) for p in _phases(center2)])
    c1p = pad_edge(census_2x(center1), PAD2, PAD2)
    c2p = pad_edge(census_2x(center2), PAD2, PAD2)

    def at(ph, num_y: int, num_x: int) -> torch.Tensor:
        """The phase image of half-pixel offset (num_y, num_x) / 2."""
        ky, py = divmod(num_y, 2)
        kx, px = divmod(num_x, 2)
        return ph[2 * py + px, PAD + ky : PAD + ky + h,
                  PAD + kx : PAD + kx + w]

    def cen(cp, i: int, j: int) -> torch.Tensor:
        """The 2x census at (2y + i, 2x + j)."""
        return cp[PAD2 + i : PAD2 + i + 2 * h : 2,
                  PAD2 + j : PAD2 + j + 2 * w : 2]

    taps = _taps(R)
    gws = _tap_weights(R, sig_s2, dev)
    positions = _positions(nr)
    costs = []
    for dy, dx in positions:
        acc_c = torch.zeros((h, w), dtype=torch.float32, device=dev)
        acc_w = torch.zeros((h, w), dtype=torch.float32, device=dev)
        for c0 in range(0, len(taps), CHUNK):
            chunk = taps[c0 : c0 + CHUNK]
            p1 = torch.stack([at(ph1, i, j) for i, j in chunk])
            p2 = torch.stack([at(ph2, i + dy, j + dx) for i, j in chunk])
            s1 = torch.stack([cen(c1p, i, j) for i, j in chunk])
            s2 = torch.stack([cen(c2p, i + dy, j + dx) for i, j in chunk])
            ad = maxabs3(p1, p2)
            c_ad = 1.0 - exp_cephes(-(ad * ad) * inv_lam_ad2)
            ham = popcount8(s1 ^ s2).to(torch.float32)
            c_cen = 1.0 - exp_cephes(-(ham * ham) * inv_lam_cen2)
            dr1 = maxabs3(center1, p1)
            dr2 = maxabs3(center2, p2)
            wgt = exp_cephes(-(dr1 * dr1 + dr2 * dr2) * inv_sig_r2) * \
                gws[c0 // CHUNK]
            wc = wgt * (c_ad + c_cen)
            for t in range(len(chunk)):
                acc_c = acc_c + wc[t]
                acc_w = acc_w + wgt[t]
        cost = acc_c / acc_w.clamp_min(1e-30)
        # out-of-image positions read cost 2.0 (refine_kernel.cu:560-566)
        nx = tx.to(torch.float32) + f32(dx / up)
        ny = ty.to(torch.float32) + f32(dy / up)
        inb = (nx >= 0) & (nx < w) & (ny >= 0) & (ny < h)
        costs.append(torch.where(inb, cost, 2.0))
    B = torch.stack(costs)  # (25, H, W)

    # the constant least-squares operator X = pinv(A) @ B (``_fit_operator``);
    # the 25 products are summed in float64 (exact products, any order: no
    # device dependence) and rounded once
    X = torch.einsum("kn,nhw->khw", _fit_operator(nr, dev),
                     B.double()).to(torch.float32)
    a, b, c, d, e = X[0], X[1], X[2], X[3], X[4]
    denorm = c * c - 4.0 * a * b
    safe = torch.where(denorm == 0, 1.0, denorm)
    subx = (2.0 * d * b - c * e) / safe
    suby = (2.0 * a * e - c * d) / safe
    accept = (valid & (denorm != 0) & (subx.abs() <= 3)
              & (suby.abs() <= 3))
    inv_up = inv32(up)
    new_u = (gx.to(torch.float32) * f32(up) + subx) * inv_up
    new_v = (gy.to(torch.float32) * f32(up) + suby) * inv_up
    return torch.stack([torch.where(accept, new_u, u),
                        torch.where(accept, new_v, v)], -1)
