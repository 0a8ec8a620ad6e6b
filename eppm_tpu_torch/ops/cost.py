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

The plane-fitting variant (:334-513) evaluates frame-2 taps under four
affine hypotheses and keeps the least cost; at integral query points each
hypothesis is a static integer tap table (``plane_offsets``).

The gathered costs (the exact stage, the plane-fitting re-search of
``refine_impl="gather"``) read frame-2 taps at per-pixel targets; they are
not Pallas kernels in the JAX package and stay plain torch here.
"""

from __future__ import annotations

import math
from typing import Iterable, List, Sequence, Tuple

import numpy as np
import torch

from ..config import CostConfig
from ._util import exp_cephes, ftz, inv32, pad_edge, popcount8, shift2d

__all__ = ["pack_frame", "make_patch_stack", "patch_cost_stack", "tap_weight",
           "cost_constants", "ad_census", "bilateral_cost", "PLANE_COEFS",
           "plane_offsets",
           "patch_cost_planefitting", "patch_cost_ad_l2", "quantize_cost",
           "TAP_CHUNK"]

# Taps per partial sum of the cost (the JAX package's ``cost_tap_chunk``).
TAP_CHUNK = 25

# Plane-fitting affine hypothesis coefficients (u_x, u_y, v_x, v_y)
# (bao_pmflow_kernel.cu:319-332).
PLANE_COEFS = (
    (0.177, -0.011, -0.003, 0.301),   # COEF_FL_*
    (0.125, -0.357, 0.009, 0.308),    # COEF_LEFT_*
    (0.205, 0.370, 0.011, 0.296),     # COEF_RIGHT_*
)


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


def ad_census(p1: torch.Tensor, p2: torch.Tensor, inv_lam_ad2: float,
              inv_lam_cen2: float) -> torch.Tensor:
    """c_ad + c_cen of tap pairs (packs p1, p2): the term of the cost that
    depends on the two taps alone, not on the centres or the spatial
    weight.  Kernel A's terms pass computes the same operations."""
    ad = maxabs3(p1[..., :3], p2[..., :3])
    c_ad = 1.0 - exp_cephes(-(ad * ad) * inv_lam_ad2)
    x = p1[..., 3].to(torch.int32) ^ p2[..., 3].to(torch.int32)
    ham = popcount8(x).to(torch.float32)
    c_cen = 1.0 - exp_cephes(-(ham * ham) * inv_lam_cen2)
    return c_ad + c_cen


def bilateral_cost(
    taps: Iterable[Tuple[torch.Tensor, torch.Tensor]],
    center1: torch.Tensor,
    center2: torch.Tensor,
    gws: Sequence[float],
    cfg: CostConfig,
    chunk: int,
) -> torch.Tensor:
    """sum(w * (c_ad + c_cen)) / max(sum(w), 1e-30) over the (p1, p2) tap
    pairs ``taps`` (packs, in table order; p2 may carry a leading
    candidate dim) with spatial weights ``gws``, the RGB centres
    ``center1`` and ``center2`` giving the range weights.  Taps sum in
    partial sums of ``chunk`` taps, as the JAX package's scans do; the
    weight is its single ``exp(-(dr1^2 + dr2^2)/sigma_r^2) * G(d)``.
    Kernel A computes the same operations in the same order."""
    inv_lam_ad2, inv_lam_cen2, inv_sig_r2 = cost_constants(cfg)
    cost_sum = weight_sum = part_c = part_w = 0.0
    n = len(gws)
    for t, ((p1, p2), gw) in enumerate(zip(taps, gws)):
        dr1 = maxabs3(center1, p1[..., :3])
        dr2 = maxabs3(center2, p2[..., :3])
        wgt = ftz(exp_cephes(-(dr1 * dr1 + dr2 * dr2) * inv_sig_r2) * gw)
        part_c = part_c + wgt * ad_census(p1, p2, inv_lam_ad2, inv_lam_cen2)
        part_w = part_w + wgt
        if (t + 1) % chunk == 0 or t + 1 == n:
            cost_sum = cost_sum + part_c
            weight_sum = weight_sum + part_w
            part_c = part_w = 0.0
    return cost_sum / weight_sum.clamp_min(1e-30)


def quantize_cost(cost: torch.Tensor) -> torch.Tensor:
    """Round a cost to the 2^-17 grid, so argmin ties resolve alike
    across implementations."""
    return torch.round(cost * 131072.0) * (1.0 / 131072.0)


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
    pad1 = pad_edge(pack1, R, R)
    flat = stack2.reshape(H2 * W2, 4 * (T + 1))
    idx = (tys.clamp(0, H2 - 1) * W2 + txs.clamp(0, W2 - 1)).reshape(-1)
    taps2 = flat[idx.long()].reshape(K, H, W, T + 1, 4).to(torch.float32)
    taps1 = list(cfg.tap_offsets)[:T]
    pairs = ((pad1[R + i1 : R + i1 + H, R + j1 : R + j1 + W], taps2[..., t, :])
             for t, (i1, j1) in enumerate(taps1))
    gws = [tap_weight(i1, j1, cfg.sigma_spatial) for (i1, j1) in taps1]
    # the JAX form sums every tap in one running sum: one chunk
    return bilateral_cost(pairs, pack1[..., :3], taps2[..., T, :3], gws, cfg,
                          chunk=len(gws))


def plane_offsets(cfg: CostConfig) -> List[Tuple[Tuple[int, int], ...]]:
    """Static frame-2 tap tables of the 4 plane hypotheses: hypothesis 0
    is fronto-parallel (the frame-1 grid); 1-3 warp tap (i, j) to
    floor(i + j*v_x + i*v_y), floor(j + j*u_x + i*u_y) — point-sampled
    texture reads at integral query points (bao_pmflow_kernel.cu:402-407),
    so the tables reach a little past the patch radius."""
    tables = [tuple(cfg.tap_offsets)]
    for ux, uy, vx, vy in PLANE_COEFS:
        tables.append(tuple(
            (int(math.floor(i + j * vx + i * vy)),
             int(math.floor(j + j * ux + i * uy)))
            for (i, j) in cfg.tap_offsets
        ))
    return tables


def patch_cost_offsets(
    pack1: torch.Tensor,
    pack2: torch.Tensor,
    tx: torch.Tensor,
    ty: torch.Tensor,
    cfg: CostConfig,
    offsets2: Sequence[Tuple[int, int]],
) -> torch.Tensor:
    """Gathered cost at absolute targets (tx, ty) (H, W) int32 with frame-2
    tap offsets ``offsets2`` (frame-1 taps follow ``cfg.tap_offsets``);
    every read clamps to the frame -> (H, W) float32, unquantized
    (``eppm_tpu/ops/cost.py::_patch_cost_offsets``)."""
    H, W = tx.shape
    H2, W2 = pack2.shape[0], pack2.shape[1]
    R = cfg.patch_radius
    pad1 = pad_edge(pack1, R, R)
    flat2 = pack2.reshape(H2 * W2, 4)

    def at2(dy: int, dx: int) -> torch.Tensor:
        cy = (ty + dy).clamp(0, H2 - 1)
        cx = (tx + dx).clamp(0, W2 - 1)
        return flat2[(cy * W2 + cx).long()]

    taps1 = list(cfg.tap_offsets)
    pairs = ((pad1[R + i1 : R + i1 + H, R + j1 : R + j1 + W], at2(i2, j2))
             for (i1, j1), (i2, j2) in zip(taps1, offsets2))
    gws = [tap_weight(i1, j1, cfg.sigma_spatial) for (i1, j1) in taps1]
    return bilateral_cost(pairs, pack1[..., :3], at2(0, 0)[..., :3], gws, cfg,
                          chunk=TAP_CHUNK)


def patch_cost_planefitting(
    pack1: torch.Tensor,
    pack2: torch.Tensor,
    tx: torch.Tensor,
    ty: torch.Tensor,
    cfg: CostConfig,
) -> torch.Tensor:
    """Least gathered cost over the 4 plane hypotheses
    (bao_pmflow_kernel.cu:334-513; ``eppm_tpu/ops/cost.py::
    patch_cost_planefitting``)."""
    cost = None
    for offsets2 in plane_offsets(cfg):
        c = patch_cost_offsets(pack1, pack2, tx, ty, cfg, offsets2)
        cost = c if cost is None else torch.minimum(cost, c)
    return cost


def patch_cost_ad_l2(img1: torch.Tensor, img2: torch.Tensor, tx: torch.Tensor,
                     ty: torch.Tensor, cfg: CostConfig = CostConfig()
                     ) -> torch.Tensor:
    """Unweighted robust-AD cost of the targets (tx, ty) over the tap grid
    (bao_pmflow_kernel.cu:555-586), the mean of 1 - exp(-ad^2 / lambda_ad^2);
    used by the still-region suppressor (:2072-2095)."""
    h, w = img1.shape[0], img1.shape[1]
    R = cfg.patch_radius
    inv_lam_ad2 = inv32(cfg.lambda_ad * cfg.lambda_ad)
    pad1 = pad_edge(img1, R, R)
    flat = img2.reshape(-1, 3)
    acc = torch.zeros((h, w), dtype=torch.float32, device=img1.device)
    taps = list(cfg.tap_offsets)
    for i, j in taps:
        p1 = pad1[R + i : R + i + h, R + j : R + j + w]
        cy = (ty + i).clamp(0, h - 1)
        cx = (tx + j).clamp(0, w - 1)
        ad = maxabs3(p1, flat[(cy * w + cx).long()])
        acc = acc + (1.0 - exp_cephes(-(ad * ad) * inv_lam_ad2))
    return acc * inv32(len(taps))
