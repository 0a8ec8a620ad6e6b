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

import functools
import math
from typing import Iterable, List, Sequence, Tuple

import numpy as np
import torch

from ..config import CostConfig
from ._util import (exp_cephes, f32, fma32, ftz, inv32, pad_edge, popcount8,
                    shift2d)

__all__ = ["pack_frame", "make_patch_stack", "patch_cost_stack", "tap_weight",
           "cost_constants", "ad_census", "census_lut", "bilateral_cost",
           "PLANE_COEFS", "plane_offsets", "patch_cost_offsets", "patch_cost",
           "patch_cost_candidates", "patch_cost_scaled",
           "scaled_tap_offsets", "patch_cost_planefitting",
           "patch_cost_ad_l2", "quantize_cost", "TAP_CHUNK"]

# Taps per partial sum of the cost: the default of ``EPPMConfig.
# cost_tap_chunk``, which every cost takes as its ``tap_chunk``.  The JAX
# package pads the tap tables to whole chunks with taps of spatial weight
# 0; those add exact zeros to the last partial sum, so the port ends the
# last chunk early instead.
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
    return f32(g)


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
    plane_fronto: bool = False,
) -> torch.Tensor:
    """sum(w * (c_ad + c_cen)) / max(sum(w), 1e-30) over the (p1, p2) tap
    pairs ``taps`` (packs, in table order; p2 may carry a leading
    candidate dim) with spatial weights ``gws``, the RGB centres
    ``center1`` and ``center2`` giving the range weights
    ``w = exp(-(dr1^2 + dr2^2)/sigma_r^2) * G(d)``.  Taps sum in partial
    sums of ``chunk`` taps, as the JAX package's scans do, added in chunk
    order.  Each tap's terms are computed once, in table order.

    The arithmetic is XLA's CPU code for ``eppm_tpu/ops/dense.py::
    residual_costs`` (kernel A's), read from its optimised HLO and IR and
    held to the program the pipeline compiles at every call site
    (``tools/torch_xla_arith.py --sites``); it depends on the call's
    shape.  The exponent dr1^2 + dr2^2 is one fused multiply-add,
    fma(dr1, dr1, dr2^2), except with one chunk and more than one
    candidate: XLA then drops the scan over the chunks and computes dr1^2,
    the same for every candidate, in a fusion of its own, so the sum is
    fma(dr2, dr2, dr1^2).  Each chunk is padded to ``chunk`` taps of
    weight 0, which add exact zeros: ``_window_chunk`` sums a chunk of
    more than ``WINDOW`` taps, ``_lane_chunk`` a shorter one.  With one
    chunk the weights join the cost's lanes, except in the fronto table
    of the plane mode (``plane_fronto``), whose weights XLA sums in a
    fusion of their own, each pixel's taps in sequence."""
    inv_lam_ad2, inv_lam_cen2, inv_sig_r2 = cost_constants(cfg)
    n = len(gws)
    one_chunk = n <= chunk
    dr1_apart = (one_chunk and center2.dim() > center1.dim()
                 and center2.shape[0] > 1)
    pairs = zip(taps, gws)
    cost_sum = weight_sum = 0.0
    for c0 in range(0, n, chunk):
        terms = []
        for _ in range(min(chunk, n - c0)):
            (p1, p2), gw = next(pairs)
            dr1 = maxabs3(center1, p1[..., :3])
            dr2 = maxabs3(center2, p2[..., :3])
            if dr1_apart:
                arg = fma32(dr2, dr2, dr1 * dr1)
            else:
                arg = fma32(dr1, dr1, dr2 * dr2)
            e = exp_cephes(-arg * inv_sig_r2)
            terms.append((e, gw, ftz(e * gw),
                          ad_census(p1, p2, inv_lam_ad2, inv_lam_cen2)))
        if chunk > WINDOW:
            part_c, part_w = _window_chunk(terms, chunk)
        else:
            part_c, part_w = _lane_chunk(terms, chunk,
                                         one_chunk and not plane_fronto)
        cost_sum = cost_sum + part_c
        weight_sum = weight_sum + part_w
    return cost_sum / weight_sum.clamp_min(1e-30)


# XLA's CPU reductions: LLVM vectorises a reduction loop in LANES float32
# lanes (AVX2), and XLA first splits a reduction of more than WINDOW
# elements into windows of WINDOW (its tree-reduction rewrite).
LANES = 8
WINDOW = 32


def _lane_tree(lane):
    """The halving tree that reduces ``LANES`` lanes to one value."""
    return ((lane[0] + lane[4]) + (lane[2] + lane[6])) + \
        ((lane[1] + lane[5]) + (lane[3] + lane[7]))


def _lane_chunk(terms, chunk: int, weight_lanes: bool):
    """One chunk's (cost, weight) partial sums from its taps' (e, g, w, E)
    in table order, as XLA's CPU code sums a chunk padded to ``chunk`` <=
    ``WINDOW`` taps in one loop.  Of the padded taps, the first ``chunk
    // LANES * LANES`` go to lane t % LANES (lanes the real taps do not
    reach stay 0), the lanes meet in ``_lane_tree`` and the rest follow in
    sequence.  The cost: lane += w * E fused (the first tap's product
    rounded alone).  The weight, with ``weight_lanes``: the same lanes of
    w, then fma(e, g, lane); else in sequence, w of the first tap, then
    fma(e, g, acc).  Kernel A computes the same operations
    (``csrc/cost.cu``)."""
    full = chunk // LANES * LANES
    weight_lanes = weight_lanes and full > 0
    lane_c, lane_w = [0.0] * LANES, [0.0] * LANES
    cost = weight = None
    for t, (e, g, w, term) in enumerate(terms):
        if t < full:
            i = t % LANES
            lane_c[i] = fma32(w, term, lane_c[i])
            if weight_lanes:
                lane_w[i] = w if t < LANES else fma32(e, g, lane_w[i])
        else:
            cost = fma32(w, term, _lane_tree(lane_c) if cost is None
                         else cost)
            if weight_lanes:
                weight = fma32(e, g, _lane_tree(lane_w) if weight is None
                               else weight)
        if not weight_lanes:
            weight = w if t == 0 else fma32(e, g, weight)
    if cost is None:
        cost = _lane_tree(lane_c)
    if weight is None:
        weight = _lane_tree(lane_w)
    return cost, weight


def _window_chunk(terms, chunk: int):
    """One chunk's (cost, weight) partial sums, as XLA's CPU code sums a
    chunk padded to ``chunk`` > ``WINDOW`` taps: the products w * E and
    the weights w rounded, the padded chunk split into windows of
    ``WINDOW`` after half the padding to a whole number of windows (the
    lesser half) in front, each window summed in sequence, the windows
    added in order."""
    n_win = -(-chunk // WINDOW)
    front = (n_win * WINDOW - chunk) // 2
    cost = weight = 0.0
    for s in range(n_win):
        part_c = part_w = 0.0
        for _, _, w, term in terms[max(s * WINDOW - front, 0):
                                   max((s + 1) * WINDOW - front, 0)]:
            part_c = part_c + w * term
            part_w = part_w + w
        cost = cost + part_c
        weight = weight + part_w
    return cost, weight


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
    # The JAX form adds the taps to one running sum in an unrolled loop,
    # and XLA's CPU backend fuses its multiply-adds: dr1^2 + dr2^2 into
    # fma(dr1, dr1, dr2^2) and each cost_sum + w * term into fma(w, term,
    # cost_sum).
    inv_lam_ad2, inv_lam_cen2, inv_sig_r2 = cost_constants(cfg)
    center1, center2 = pack1[..., :3], taps2[..., T, :3]
    cost_sum = weight_sum = torch.zeros(txs.shape, dtype=torch.float32,
                                        device=txs.device)
    for t, (i1, j1) in enumerate(list(cfg.tap_offsets)[:T]):
        p1 = pad1[R + i1 : R + i1 + H, R + j1 : R + j1 + W]
        p2 = taps2[..., t, :]
        dr1 = maxabs3(center1, p1[..., :3])
        dr2 = maxabs3(center2, p2[..., :3])
        wgt = ftz(exp_cephes(-fma32(dr1, dr1, dr2 * dr2) * inv_sig_r2)
                  * tap_weight(i1, j1, cfg.sigma_spatial))
        cost_sum = fma32(wgt, ad_census(p1, p2, inv_lam_ad2, inv_lam_cen2),
                         cost_sum)
        weight_sum = weight_sum + wgt
    return cost_sum / weight_sum.clamp_min(1e-30)


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


@functools.lru_cache(maxsize=None)
def census_lut(inv_lam_cen2: float, device=None) -> torch.Tensor:
    """c_cen of every XOR of two 8-bit census signatures (256,) float32,
    computed by the operations of ``ad_census``: looking a term up here
    gives its bits.  Made once per device and never freed (a CUDA graph
    holds its address)."""
    ham = popcount8(torch.arange(256, dtype=torch.int32, device=device))
    ham = ham.to(torch.float32)
    return 1.0 - exp_cephes(-(ham * ham) * inv_lam_cen2)


@functools.lru_cache(maxsize=None)
def _column(vals, dtype, device) -> torch.Tensor:
    """The values as a (T, 1, 1, 1) tensor on ``device``, made once and
    never freed (a CUDA graph holds its address)."""
    return torch.tensor(vals, dtype=dtype, device=device).view(-1, 1, 1, 1)


@functools.lru_cache(maxsize=None)
def _chunk_tables(taps1, taps2, sigma_spatial: float, base: int, h: int,
                  w: int, device, chunk: int = TAP_CHUNK):
    """Per chunk of ``chunk`` taps, on ``device``: the frame-1 row and
    column indices into a pack padded by ``base`` ((T, h, 1), (T, 1, w)),
    the frame-2 offsets (T, 1, 1, 1) int32 (None for ``taps2=None``) and
    the spatial weights (T, 1, 1, 1) float32.  Made once per set and
    never freed, so a call copies nothing from the host (a copy would
    wait for the device) and a CUDA graph that holds the tables'
    addresses finds them in place."""
    def col(vals, dtype):
        return _column(tuple(vals), dtype, device)

    out = []
    for c0 in range(0, len(taps1), chunk):
        part = taps1[c0 : c0 + chunk]
        iy = col([base + i for i, _ in part], torch.int64)[:, :, 0]
        ix = col([base + j for _, j in part], torch.int64)[:, 0]
        iy = iy + torch.arange(h, device=device)[:, None]
        ix = ix + torch.arange(w, device=device)
        off2 = None
        if taps2 is not None:
            part2 = taps2[c0 : c0 + chunk]
            off2 = (col([i for i, _ in part2], torch.int32),
                    col([j for _, j in part2], torch.int32))
        gws = col([tap_weight(i, j, sigma_spatial) for i, j in part],
                  torch.float32)
        out.append((part, iy, ix, off2, gws))
    return out


def _chunk_sums(parts) -> torch.Tensor:
    """sum(w * term) / max(sum(w), 1e-30) from per-chunk (w * term, w)
    stacks (T, ...): the taps of a chunk add in table order into the
    chunk's partial sums, the partial sums in chunk order, every product
    rounded."""
    cost_sum = weight_sum = 0.0
    for prods, wgts in parts:
        part_c, part_w = prods[0], wgts[0]
        for t in range(1, prods.shape[0]):
            part_c = part_c + prods[t]
            part_w = part_w + wgts[t]
        cost_sum = cost_sum + part_c
        weight_sum = weight_sum + part_w
    return cost_sum / weight_sum.clamp_min(1e-30)


def _as_fields(*fields: torch.Tensor):
    """(H, W) fields as (1, H, W), and whether to drop the candidate dim
    again."""
    single = fields[0].dim() == 2
    return [f[None] if single else f for f in fields], single


def _gather(flat: torch.Tensor, ty, tx, h: int, w: int) -> torch.Tensor:
    """Rows of ``flat`` (h * w, C) at (ty, tx), each clamped to the frame
    (CUDA texture clamp addressing)."""
    return flat[(ty.clamp(0, h - 1) * w + tx.clamp(0, w - 1)).long()]


def _weight_and_ad(center1, center2, p1, p2, gws, inv_sig_r2: float,
                   inv_lam_ad2: float):
    """The range-and-space weights w and the AD terms c_ad of a chunk of
    tap pairs (frame-1 taps p1 (T, 1, H, W, 4), frame-2 taps p2 (T, K, H,
    W, 4), spatial weights gws (T, 1, 1, 1)), every product rounded."""
    dr1 = maxabs3(center1, p1[..., :3])
    dr2 = maxabs3(center2, p2[..., :3])
    wgt = ftz(exp_cephes(-(dr1 * dr1 + dr2 * dr2) * inv_sig_r2) * gws)
    ad = maxabs3(p1[..., :3], p2[..., :3])
    return wgt, 1.0 - exp_cephes(-(ad * ad) * inv_lam_ad2)


def patch_cost_offsets(
    pack1: torch.Tensor,
    pack2: torch.Tensor,
    tx: torch.Tensor,
    ty: torch.Tensor,
    cfg: CostConfig,
    offsets2: Sequence[Tuple[int, int]],
    pack1_halo: int = 0,
    tap_chunk: int = TAP_CHUNK,
) -> torch.Tensor:
    """Gathered cost at absolute targets (tx, ty), int32 (H, W) or K
    candidate fields (K, H, W), with frame-2 tap offsets ``offsets2``
    (frame-1 taps follow ``cfg.tap_offsets``); every frame-2 read clamps
    to the frame -> float32 of the targets' shape, unquantized
    (``eppm_tpu/ops/cost.py::_patch_cost_offsets``).  ``pack1`` may carry
    ``pack1_halo`` rows and columns of context on each side (a tile).

    Each chunk of ``tap_chunk`` taps is one pass over (T, K, H, W)
    tensors: one gather of the frame-2 taps, then the range weights and
    the AD + census terms of all its taps at once (the census term looked
    up in ``census_lut``).  Only the running sums stay a loop, in table
    order: the result is the bits of the same sums taken one tap at a
    time, at a few hundred launches a call instead of ~230 a tap."""
    (tx, ty), single = _as_fields(tx, ty)
    H, W = tx.shape[-2:]
    H2, W2 = pack2.shape[0], pack2.shape[1]
    R = cfg.patch_radius
    pad_extra = max(R - pack1_halo, 0)
    base = pack1_halo + pad_extra
    pad1 = pad_edge(pack1, pad_extra, pad_extra) if pad_extra else pack1
    flat2 = pack2.reshape(H2 * W2, 4)
    inv_lam_ad2, inv_lam_cen2, inv_sig_r2 = cost_constants(cfg)
    lut = census_lut(inv_lam_cen2, pack1.device)
    center1 = pad1[base : base + H, base : base + W, :3]
    center2 = _gather(flat2, ty, tx, H2, W2)[..., :3]
    parts = []
    for _, iy, ix, (dy2, dx2), gws in _chunk_tables(
            tuple(cfg.tap_offsets), tuple(offsets2), cfg.sigma_spatial, base,
            H, W, pack1.device, tap_chunk):
        p1 = pad1[iy, ix][:, None]
        p2 = _gather(flat2, ty + dy2, tx + dx2, H2, W2)
        wgt, c_ad = _weight_and_ad(center1, center2, p1, p2, gws,
                                   inv_sig_r2, inv_lam_ad2)
        x = p1[..., 3].to(torch.int64) ^ p2[..., 3].to(torch.int64)
        parts.append((wgt * (c_ad + lut[x]), wgt))
    cost = _chunk_sums(parts)
    return cost[0] if single else cost


def patch_cost(pack1, pack2, tx, ty, cfg: CostConfig = CostConfig(),
               pack1_halo: int = 0, tap_chunk: int = TAP_CHUNK
               ) -> torch.Tensor:
    """Fronto-parallel gathered AD + census cost (bao_pmflow_kernel.cu:
    255-301; ``eppm_tpu/ops/cost.py::patch_cost``): (H, W) targets ->
    (H, W) float32, unquantized."""
    return patch_cost_offsets(pack1, pack2, tx, ty, cfg, cfg.tap_offsets,
                              pack1_halo, tap_chunk)


def patch_cost_candidates(pack1, pack2, txs, tys,
                          cfg: CostConfig = CostConfig(),
                          tap_chunk: int = TAP_CHUNK) -> torch.Tensor:
    """The fronto cost of K candidate fields (K, H, W) -> (K, H, W), all K
    in one pass (``eppm_tpu/ops/cost.py::patch_cost_candidates``)."""
    return patch_cost_offsets(pack1, pack2, txs, tys, cfg, cfg.tap_offsets,
                              tap_chunk=tap_chunk)


def scaled_tap_offsets(taps, scale: torch.Tensor):
    """Frame-2 offsets (floor(dy * s), floor(dx * s)) of the scaled
    cost, int32 (T, *scale.shape): the float32 product of the tap offset
    and the per-pixel scale, floored (``eppm_tpu/ops/cost.py:432-433``).
    """
    shape = (-1,) + (1,) * scale.dim()
    fy = _column(tuple(i for i, _ in taps), torch.float32, scale.device)
    fx = _column(tuple(j for _, j in taps), torch.float32, scale.device)
    return (torch.floor(fy.view(shape) * scale).to(torch.int32),
            torch.floor(fx.view(shape) * scale).to(torch.int32))


def patch_cost_scaled(pack1, pack2, tx, ty, scale,
                      cfg: CostConfig = CostConfig(),
                      tap_chunk: int = TAP_CHUNK) -> torch.Tensor:
    """Scaled-patch bilateral AD cost (_d_compute_patch_dist_scaled,
    bao_pmflow_kernel.cu:588-634; ``eppm_tpu/ops/cost.py::
    patch_cost_scaled``): frame-2 taps at clamp(t + floor(d * scale)) with
    a per-pixel float32 ``scale``; no census term (the reference
    comments it out).  Targets and scale (H, W) or (K, H, W); chunks of
    ``tap_chunk`` taps as in ``patch_cost_offsets``."""
    (tx, ty, scale), single = _as_fields(tx, ty, scale)
    H, W = tx.shape[-2:]
    H2, W2 = pack2.shape[0], pack2.shape[1]
    R = cfg.patch_radius
    pad1 = pad_edge(pack1, R, R)
    flat2 = pack2.reshape(H2 * W2, 4)
    inv_lam_ad2, _, inv_sig_r2 = cost_constants(cfg)
    center2 = _gather(flat2, ty, tx, H2, W2)[..., :3]
    parts = []
    for chunk, iy, ix, _, gws in _chunk_tables(
            tuple(cfg.tap_offsets), None, cfg.sigma_spatial, R, H, W,
            pack1.device, tap_chunk):
        p1 = pad1[iy, ix][:, None]
        oy, ox = scaled_tap_offsets(chunk, scale)
        p2 = _gather(flat2, ty + oy, tx + ox, H2, W2)
        wgt, c_ad = _weight_and_ad(pack1[..., :3], center2, p1, p2, gws,
                                   inv_sig_r2, inv_lam_ad2)
        parts.append((wgt * c_ad, wgt))
    cost = _chunk_sums(parts)
    return cost[0] if single else cost


def patch_cost_planefitting(
    pack1: torch.Tensor,
    pack2: torch.Tensor,
    tx: torch.Tensor,
    ty: torch.Tensor,
    cfg: CostConfig,
    tap_chunk: int = TAP_CHUNK,
    pack1_halo: int = 0,
) -> torch.Tensor:
    """Least gathered cost over the 4 plane hypotheses
    (bao_pmflow_kernel.cu:334-513; ``eppm_tpu/ops/cost.py::
    patch_cost_planefitting``); targets (H, W) or (K, H, W), ``pack1``
    with ``pack1_halo`` rows and columns of context as in
    ``patch_cost_offsets``."""
    cost = None
    for offsets2 in plane_offsets(cfg):
        c = patch_cost_offsets(pack1, pack2, tx, ty, cfg, offsets2,
                               pack1_halo, tap_chunk)
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
