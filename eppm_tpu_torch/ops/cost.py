"""Bilateral AD + census patch cost: frame packing and the exact
(gathered) cost of the coarse matcher (counterpart of
``eppm_tpu/ops/cost.py``).

Spec: ``_d_compute_patch_dist`` (bao_pmflow_kernel.cu:255-301).  Per tap
d of the patch grid, between p1 in frame 1 and the target p2 in frame 2:

  ad    = max_c |I1(p1+d) - I2(p2+d)|               (max over R, G, B)
  c_ad  = 1 - exp(-ad^2 / lambda_ad^2)
  ham   = popcount(census1(p1+d) XOR census2(p2+d))
  c_cen = 1 - exp(-ham^2 / (lambda_census*8)^2)
  w     = exp(-(dr1^2 + dr2^2) / sigma_r^2) * G(d)
  cost  = sum(w * (c_ad + c_cen)) / sum(w)

with dr1 = max_c |I1(p1) - I1(p1+d)|, dr2 = max_c |I2(p2) - I2(p2+d)| and
G the separable spatial Gaussian.  Frames are packed (H, W, 4) float32:
r, g, b and the census signature stored as a float.

The exact stage gathers frame-2 taps at per-pixel targets; it is not a
Pallas kernel in the JAX package and stays plain torch here.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import numpy as np
import torch

from ..config import CostConfig
from ._util import exp_cephes, ftz, inv32, pad_edge, popcount8, shift2d

__all__ = ["pack_frame", "make_patch_stack", "patch_cost_stack", "tap_weight",
           "cost_constants"]


def pack_frame(img: torch.Tensor, census: torch.Tensor) -> torch.Tensor:
    """Pack (H, W, 3) float image + (H, W) int census -> (H, W, 4) f32."""
    return torch.cat(
        [img.to(torch.float32), census.to(torch.float32)[..., None]], dim=-1
    )


def maxabs3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    d = (a - b).abs()
    return torch.maximum(torch.maximum(d[..., 0], d[..., 1]), d[..., 2])


def cost_constants(cfg: CostConfig):
    """(1/lambda_ad^2, 1/(lambda_census*8)^2, 1/sigma_r^2) as float32
    values: the reference divides by the first two (which ``jit`` turns
    into multiplications by float32 reciprocals) and multiplies by the
    third (a Python double, rounded to float32)."""
    lam_ad2 = cfg.lambda_ad * cfg.lambda_ad
    lam_cen2 = (cfg.lambda_census * cfg.census_max_diff) ** 2
    inv_sig_r2 = 1.0 / (cfg.sigma_range * cfg.sigma_range)
    return inv32(lam_ad2), inv32(lam_cen2), float(np.float32(inv_sig_r2))


def tap_weight(dy: int, dx: int, sigma_spatial: float) -> float:
    """Spatial Gaussian of a tap, rounded to float32 as the JAX package
    stores it."""
    s2 = sigma_spatial * sigma_spatial
    g = math.exp(-(dy * dy) / s2) * math.exp(-(dx * dx) / s2)
    return float(torch.tensor(g, dtype=torch.float32))


def make_patch_stack(
    pack2: torch.Tensor,
    offsets2: Sequence[Tuple[int, int]],
    dtype=None,
) -> torch.Tensor:
    """Pre-shifted tap stack (H2, W2, (T+1)*4): group t holds
    pack2[clip(y+dy_t), clip(x+dx_t)], the last group the (0, 0) center.
    With the stack built once, the exact cost of any target field is one
    row gather (``eppm_tpu/ops/cost.py::make_patch_stack``)."""
    stack = torch.cat(
        [shift2d(pack2, dy, dx) for (dy, dx) in offsets2] + [pack2], dim=-1
    )
    if dtype is not None:
        stack = stack.to(dtype)
    return stack


def patch_cost_stack(
    pack1: torch.Tensor,
    stack2: torch.Tensor,
    txs: torch.Tensor,
    tys: torch.Tensor,
    cfg: CostConfig,
    offsets2: Sequence[Tuple[int, int]],
) -> torch.Tensor:
    """Exact bilateral AD+census cost of K target fields (K, H, W) int32
    against a ``make_patch_stack`` stack -> (K, H, W) float32.  Frame-1
    taps follow ``cfg.tap_offsets``; ``offsets2`` must be the stack's."""
    K, H, W = txs.shape
    H2, W2 = stack2.shape[0], stack2.shape[1]
    T = len(offsets2)
    R = cfg.patch_radius
    inv_lam_ad2, inv_lam_cen2, inv_sig_r2 = cost_constants(cfg)

    pad1 = pad_edge(pack1, R, R)
    flat = stack2.reshape(H2 * W2, 4 * (T + 1))
    idx = (tys.clamp(0, H2 - 1) * W2 + txs.clamp(0, W2 - 1)).reshape(-1)
    taps2 = flat[idx.long()].reshape(K, H, W, T + 1, 4).to(torch.float32)
    center2 = taps2[..., T, :3]
    center1 = pack1[..., :3]

    cost_sum = torch.zeros((K, H, W), dtype=torch.float32, device=pack1.device)
    weight_sum = torch.zeros_like(cost_sum)
    for t, ((i1, j1), _) in enumerate(zip(cfg.tap_offsets, offsets2)):
        gw = tap_weight(i1, j1, cfg.sigma_spatial)
        p1 = pad1[R + i1 : R + i1 + H, R + j1 : R + j1 + W]
        p2 = taps2[..., t, :]
        ad = maxabs3(p1[None, ..., :3], p2[..., :3])
        c_ad = 1.0 - exp_cephes(-(ad * ad) * inv_lam_ad2)
        ham = popcount8(
            p1[None, ..., 3].to(torch.int32) ^ p2[..., 3].to(torch.int32)
        ).to(torch.float32)
        c_cen = 1.0 - exp_cephes(-(ham * ham) * inv_lam_cen2)
        dr1 = maxabs3(center1, p1[..., :3])[None]
        dr2 = maxabs3(center2, p2[..., :3])
        w = ftz(exp_cephes(-(dr1 * dr1 + dr2 * dr2) * inv_sig_r2) * gw)
        cost_sum = cost_sum + w * (c_ad + c_cen)
        weight_sum = weight_sum + w
    return cost_sum / weight_sum.clamp_min(1e-30)
