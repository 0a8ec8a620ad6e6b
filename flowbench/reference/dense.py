"""Dense warp-and-residual flow refinement (counterpart of
``eppm_tpu/ops/dense.py``), and the plain PyTorch version of the
residual-cost kernel (``ops/cuda_cost.py``).

Refinement splits each pixel's target as t(p) = p + g(p) + c, with g the
truncated integer flow and c a small search offset: frame 2 is warped
once by g (one gather), and the cost of candidate c reads the warped
frame at p + c + d for every tap d — a static shift.  The derivation and
its accuracy argument are in the JAX package's module docstring.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

from .config import FLT_MAX, UNKNOWN_FLOW_THRESH, CostConfig
from ._util import f32, grid, pad_edge, shift2d, trunc_i32
from .cost import (TAP_CHUNK, ad_census, bilateral_cost, cost_constants,
                   plane_offsets, quantize_cost, tap_weight)

__all__ = [
    "center_out_offsets",
    "median3",
    "median3_flow",
    "warp_pack",
    "residual_costs",
    "residual_costs_multiwarp",
    "cost_terms",
    "dense_refine_flow",
    "cost_tables",
]


def center_out_offsets(radius: int, shape: str = "square") -> List[Tuple[int, int]]:
    """(dy, dx) residual candidates ordered center-out: (0,0) first, then
    by Chebyshev ring and squared distance.  Argmin ties keep the first
    candidate, so the order decides tied pixels (quantized costs make ties
    common); ``shape="plus"`` keeps the L1 ball only."""
    cands = [
        (m, n)
        for m in range(-radius, radius + 1)
        for n in range(-radius, radius + 1)
    ]
    if shape == "plus":
        cands = [c for c in cands if abs(c[0]) + abs(c[1]) <= radius]
    elif shape != "square":
        raise ValueError(f"unknown candidate shape {shape!r}")
    cands.sort(key=lambda c: (max(abs(c[0]), abs(c[1])),
                              c[0] * c[0] + c[1] * c[1], c))
    return cands


# The 19-comparator 3x3 median network of eppm_tpu/ops/dense.py::median3.
_MEDIAN9 = (
    (0, 1), (3, 4), (6, 7), (1, 2), (4, 5), (7, 8), (0, 1), (3, 4),
    (6, 7), (0, 3), (5, 8), (4, 7), (3, 6), (1, 4), (2, 5), (4, 7),
    (4, 2), (6, 4), (4, 2),
)


def median3(x: torch.Tensor) -> torch.Tensor:
    """3x3 median of a 2D field (any dtype), edge-replicated borders."""
    vals = [shift2d(x, dy, dx) for dy in (-1, 0, 1) for dx in (-1, 0, 1)]
    for i, j in _MEDIAN9:
        vals[i], vals[j] = (
            torch.minimum(vals[i], vals[j]), torch.maximum(vals[i], vals[j])
        )
    return vals[4]


def median3_flow(flow: torch.Tensor) -> torch.Tensor:
    """Per-component 3x3 median of an (H, W, 2) flow field."""
    return torch.stack([median3(flow[..., 0]), median3(flow[..., 1])], dim=-1)


def warp_pack(
    pack2: torch.Tensor, gx: torch.Tensor, gy: torch.Tensor, gather_dtype=None,
    origin: Tuple[int, int] = (0, 0),
) -> torch.Tensor:
    """J(p) = pack2 at (clamp(y + gy(p)), clamp(x + gx(p))): one flat
    gather of all 4 channels.  ``gather_dtype`` (bfloat16) rounds the
    gathered values through that dtype (``EPPMConfig.dense_warp_bf16``).
    ``origin`` is the global position of (gx, gy)'s top-left pixel, for
    a tile with a halo against the whole frame 2: the position clamps
    come first, so a halo pixel beyond the frame's border warps as the
    edge-padded warp of the whole frame does."""
    h2, w2 = pack2.shape[0], pack2.shape[1]
    h, w = gx.shape
    ys, xs = grid(h, w, gx.device)
    cy = ((ys + origin[0]).clamp(0, h2 - 1) + gy).clamp(0, h2 - 1)
    cx = ((xs + origin[1]).clamp(0, w2 - 1) + gx).clamp(0, w2 - 1)
    if gather_dtype is not None:
        pack2 = pack2.to(gather_dtype)
    flat = pack2.reshape(h2 * w2, pack2.shape[2])
    out = flat[(cy * w2 + cx).long()]
    return out.to(torch.float32)


def _cost_from_stack(
    pack1: torch.Tensor,
    frames: torch.Tensor,
    m: int,
    cfg: CostConfig,
    taps2: Sequence[Tuple[int, int]],
    tap_chunk: int = TAP_CHUNK,
    plane_fronto: bool = False,
) -> torch.Tensor:
    """Shared plain cost: ``frames`` is (K, H+2m, W+2m, 4) — candidate k's
    frame-2 region, already offset by its candidate and edge-padded by
    ``m`` >= every |tap| — against pack1 (H, W, 4) -> (K, H, W) on the
    2^-17 grid.  Frame-1 taps follow ``cfg.tap_offsets``, frame-2 taps the
    table ``taps2`` (the same grid, or a plane hypothesis's); the frame-2
    range-weight centre stays the candidate's own pixel.

    Taps sum in partial sums of ``tap_chunk`` in the form XLA's CPU code
    gives ``eppm_tpu``'s program (``bilateral_cost``); ``plane_fronto``
    marks the plane mode's fronto table, whose weights XLA sums apart."""
    h, w = pack1.shape[0], pack1.shape[1]
    taps1 = list(cfg.tap_offsets)
    R = _reach(taps1)
    pad1 = pad_edge(pack1, R, R)
    pairs = ((pad1[R + dy : R + dy + h, R + dx : R + dx + w],
              frames[:, m + ey : m + ey + h, m + ex : m + ex + w])
             for (dy, dx), (ey, ex) in zip(taps1, taps2))
    gws = [tap_weight(dy, dx, cfg.sigma_spatial) for (dy, dx) in taps1]
    cost = bilateral_cost(pairs, pack1[..., :3],
                          frames[:, m : m + h, m : m + w, :3], gws, cfg,
                          chunk=tap_chunk, plane_fronto=plane_fronto)
    return quantize_cost(cost)


def _reach(taps: Sequence[Tuple[int, int]]) -> int:
    return max(max(abs(i), abs(j)) for (i, j) in taps)


def cost_tables(cfg: CostConfig, use_planes: bool):
    """Frame-2 tap tables of the cost: the 4 plane hypotheses, or the
    frame-1 grid alone."""
    return plane_offsets(cfg) if use_planes else [tuple(cfg.tap_offsets)]


def residual_costs(
    pack1: torch.Tensor,
    warped2: torch.Tensor,
    cand_offsets: Sequence[Tuple[int, int]],
    cfg: CostConfig,
    use_planes: bool = False,
    tap_chunk: int = TAP_CHUNK,
) -> torch.Tensor:
    """Cost of each residual candidate, densely: candidate c at pixel p
    compares pack1(p+d) with warped2(clamp(p+c+d2)) over the tap grid,
    d2 from each frame-2 tap table, and keeps the least cost over the
    tables -> (K, H, W) float32 on the 2^-17 grid.  ``use_planes`` takes
    the 4 plane hypotheses (the reference's re-search space), else the
    fronto-parallel grid alone.

    The plain version of kernel A (``ops/cuda_cost.py``) and the port of
    ``eppm_tpu/ops/dense.py::residual_costs``."""
    h, w = pack1.shape[0], pack1.shape[1]
    tables = cost_tables(cfg, use_planes)
    m = max(_reach(t) for t in tables)
    cmax = _reach(cand_offsets)
    P = cmax + m
    pad2 = pad_edge(warped2, P, P)
    frames = torch.stack([
        pad2[P + cy - m : P + cy + m + h, P + cx - m : P + cx + m + w]
        for (cy, cx) in cand_offsets
    ])
    cost = None
    for b, table in enumerate(tables):
        c = _cost_from_stack(pack1, frames, m, cfg, table, tap_chunk,
                             plane_fronto=use_planes and b == 0)
        cost = c if cost is None else torch.minimum(cost, c)
    return cost


def residual_costs_multiwarp(
    pack1: torch.Tensor, warped_stack: torch.Tensor, cfg: CostConfig,
    tap_chunk: int = TAP_CHUNK,
) -> torch.Tensor:
    """Cost at candidate (0, 0) of K separately warped frames
    (K, H, W, 4) -> (K, H, W): the plain version of kernel A's multiwarp
    mode (``eppm_tpu/ops/pallas_cost.py::residual_costs_multiwarp_pallas``)."""
    m = _reach(cfg.tap_offsets)
    frames = torch.stack([pad_edge(wk, m, m) for wk in warped_stack])
    return _cost_from_stack(pack1, frames, m, cfg, cfg.tap_offsets,
                            tap_chunk)


def cost_terms(
    pack1: torch.Tensor,
    frames: torch.Tensor,
    maps: Sequence[Tuple[int, int, int]],
    reach: int,
    cfg: CostConfig,
) -> torch.Tensor:
    """The AD + census term of the residual cost, once per shifted pixel:
    for each map (f, sy, sx) and each u of the padded domain
    [-R, H+R) x [-R, W+R) (R = ``reach``), ``ad_census`` between
    pack1[clamp(u)] and frames[f][clamp(u + s)] -> (M, H+2R, W+2R) float32.
    ``frames`` is (H, W, 4) (f = 0) or (F, H, W, 4).

    The cost's tap d of candidate c with frame-2 tap e reads these two
    pixels at u = p + d, s = c + e - d (both clamps of the plain version
    are of the unclamped sums), so ``residual_costs`` takes its c_ad + c_cen
    from map s at u: the plain version of kernel A's terms pass
    (``ops/cuda_cost.py::cost_terms_cuda``)."""
    frames = frames[None] if frames.dim() == 3 else frames
    h, w = pack1.shape[0], pack1.shape[1]
    R = reach
    inv_lam_ad2, inv_lam_cen2, _ = cost_constants(cfg)
    pad1 = pad_edge(pack1, R, R)
    S = R + max(max(abs(sy), abs(sx)) for (_, sy, sx) in maps)
    padded = {}
    out = []
    for f, sy, sx in maps:
        if f not in padded:
            padded[f] = pad_edge(frames[f], S, S)
        p2 = padded[f][S - R + sy : S + R + sy + h, S - R + sx : S + R + sx + w]
        out.append(ad_census(pad1, p2, inv_lam_ad2, inv_lam_cen2))
    return torch.stack(out)


def dense_refine_flow(
    flow: torch.Tensor,
    pack1: torch.Tensor,
    pack2: torch.Tensor,
    cfg: CostConfig,
    search_radius: int = 1,
    cand_shape: str = "square",
    gather_dtype=None,
    use_planes: bool = False,
    subpixel_fit: bool = False,
    subpixel_min_curv: float = 0.0,
    tap_chunk: int = TAP_CHUNK,
    origin: Tuple[int, int] = (0, 0),
) -> torch.Tensor:
    """Search the candidates around trunc(flow) with the residual cost on
    the once-warped frame 2 (fronto-parallel, or the least over the 4
    plane hypotheses with ``use_planes``).  Unknown flow resets to 0,
    candidates whose true target leaves frame 2 are skipped, ties keep the
    first candidate (``eppm_tpu/ops/dense.py::dense_refine_flow``).

    ``subpixel_fit``: where the centre candidate wins and its four axis
    neighbours are in frame 2, a 1-D parabola through the three costs of
    each axis moves the flow by at most half a pixel, where the axis
    curvature exceeds ``max(subpixel_min_curv, 1e-8)``.

    ``origin``: ``flow`` and ``pack1`` are a tile (with its halo) whose
    top-left pixel sits at that global position in ``pack2``'s frame;
    the warp and the in-frame test of a candidate take global
    coordinates, so the tile's interior, away from the halo by the
    candidates' and taps' reach, equals the whole frame's call."""
    h, w = flow.shape[:2]
    h2, w2 = pack2.shape[0], pack2.shape[1]
    ys, xs = grid(h, w, flow.device)
    ys, xs = ys + origin[0], xs + origin[1]
    u, v = flow[..., 0], flow[..., 1]
    unknown = (u > UNKNOWN_FLOW_THRESH) | (v > UNKNOWN_FLOW_THRESH)
    gx = trunc_i32(torch.where(unknown, 0.0, u))
    gy = trunc_i32(torch.where(unknown, 0.0, v))
    warped2 = warp_pack(pack2, gx, gy, gather_dtype, origin)

    cand_offsets = center_out_offsets(search_radius, cand_shape)
    costs = residual_costs(pack1, warped2, cand_offsets, cfg,
                           use_planes=use_planes, tap_chunk=tap_chunk)
    best_dy, best_dx, _ = argmin_candidates(
        costs, cand_offsets, ys + gy, xs + gx, h2, w2, init=999999.0
    )
    out_u = (gx + best_dx).to(torch.float32)
    out_v = (gy + best_dy).to(torch.float32)
    if subpixel_fit:
        k_of = {off: k for k, off in enumerate(cand_offsets)}
        cc, cl, cr, cu, cd = (
            torch.where(_in_frame(ys + gy + m, xs + gx + n, h2, w2),
                        costs[k_of[(m, n)]], FLT_MAX)
            for m, n in ((0, 0), (0, -1), (0, 1), (-1, 0), (1, 0)))
        valid = ((best_dy == 0) & (best_dx == 0) & (cl < FLT_MAX)
                 & (cr < FLT_MAX) & (cu < FLT_MAX) & (cd < FLT_MAX))
        # float32 constants, as the JAX package's weakly typed ones
        floor = f32(max(float(subpixel_min_curv), 1e-8))
        eps = f32(1e-8)

        def fit(lo, hi):
            den = lo - 2.0 * cc + hi
            d = 0.5 * (lo - hi) / den.clamp_min(eps)
            return torch.where(den > floor, d.clamp(-0.5, 0.5), 0.0)

        out_u = out_u + torch.where(valid, fit(cl, cr), 0.0)
        out_v = out_v + torch.where(valid, fit(cu, cd), 0.0)
    out = torch.stack([out_u, out_v], dim=-1)
    return torch.where(unknown[..., None], 0.0, out)


def _in_frame(ty, tx, h2: int, w2: int) -> torch.Tensor:
    return (tx >= 0) & (tx < w2) & (ty >= 0) & (ty < h2)


def argmin_candidates(
    costs: torch.Tensor,
    cand_offsets: Sequence[Tuple[int, int]],
    ty0: torch.Tensor,
    tx0: torch.Tensor,
    h2: int,
    w2: int,
    init: float = FLT_MAX,
):
    """First strict minimum over candidates whose target (ty0+m, tx0+n)
    lies in frame 2 -> (best_dy, best_dx, best_cost); (0, 0) and ``init``
    where no candidate beats ``init``."""
    best_cost = torch.full(ty0.shape, init, dtype=torch.float32,
                           device=costs.device)
    best_dy = torch.zeros(ty0.shape, dtype=torch.int32, device=costs.device)
    best_dx = torch.zeros_like(best_dy)
    for k, (m, n) in enumerate(cand_offsets):
        ck = torch.where(_in_frame(ty0 + m, tx0 + n, h2, w2), costs[k],
                         FLT_MAX)
        better = ck < best_cost
        best_cost = torch.where(better, ck, best_cost)
        best_dy = torch.where(better, m, best_dy)
        best_dx = torch.where(better, n, best_dx)
    return best_dy, best_dx, best_cost
