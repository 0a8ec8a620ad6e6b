"""Dense coarse-level matcher (counterpart of ``eppm_tpu/ops/match.py``).

Two engines, fused: a global descriptor argmax (every pixel scores every
target with a descriptor dot product — large-displacement recall, the
role of PatchMatch's random init) and a dense local descent down a
mini-pyramid with the true bilateral AD+census cost, followed by dense
jump-flood propagation, a polish sweep and an exact-cost stage (kernel F
on the card, ``exact_best_of`` its plain version).  Returns
absolute int32 target fields and their cost, for one direction
(``match_coarse``) or both (``match_coarse_bidi``).

Quantization is the JAX package's, so argmin decisions agree across
implementations: costs on a 2^-17 grid, descriptor scores x4096 with the
first maximum winning, candidates in center-out order.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import torch

from ..config import FLT_MAX, CostConfig, MatchConfig
from ._util import f32, grid, shift2d, trunc_i32
from .census import census_transform
from .cost import (TAP_CHUNK, make_patch_stack, pack_frame, patch_cost_stack,
                   quantize_cost)
from .cuda_cost import residual_costs_auto, residual_costs_multiwarp_auto
from .dense import argmin_candidates, center_out_offsets, median3, warp_pack
from .resize import bilinear_resize, gaussian_filter

__all__ = [
    "patch_descriptors",
    "global_argmax",
    "global_match",
    "global_match_bidi",
    "descend_level",
    "rescore",
    "rescore_multi",
    "propagate_dense",
    "match_coarse",
    "match_coarse_bidi",
    "exact_best_of",
]


def patch_descriptors(
    pack: torch.Tensor, cfg: MatchConfig, stride: int = 1
) -> torch.Tensor:
    """Per-pixel patch descriptor (H, W, D) bfloat16: per tap of a
    stride-``desc_tap_stride`` grid of radius ``desc_radius``, the RGB
    values and 8 census sign bits, each scaled by the tap's spatial
    Gaussian.  ``stride`` subsamples the output grid (before the cast)."""
    r, s = cfg.desc_radius, cfg.desc_tap_stride
    sig2 = cfg.desc_sigma_spatial**2
    census = pack[..., 3].to(torch.int32)
    bits = torch.stack(
        [((census >> b) & 1).to(torch.float32) - 0.5 for b in range(8)], dim=-1
    ) * (2.0 * cfg.desc_census_scale)
    rgb = pack[..., :3]
    feats = []
    for dy in range(-r, r + 1, s):
        for dx in range(-r, r + 1, s):
            gw = f32(math.exp(-(dy * dy + dx * dx) / sig2))
            feats.append(shift2d(rgb, dy, dx) * gw)
            feats.append(shift2d(bits, dy, dx) * gw)
    out = torch.cat(feats, dim=-1)
    if stride > 1:
        out = out[::stride, ::stride]
    return out.to(torch.bfloat16)


def _score_sweep(desc1: torch.Tensor, desc2: torch.Tensor, block: int,
                 bwd: bool):
    """The global score sweep over frame-2 blocks of ``block`` targets:
    argmin |a-b|^2 == argmax (a.b - |b|^2/2), scores rounded x4096, the
    first maximum winning.  Returns the forward argmax (N1,) int32 (a
    running maximum, strict > across blocks) and, with ``bwd``, the
    backward one (N2,) int32 (each block's columns over all of frame 1).

    The JAX package multiplies the bf16 descriptors with a float32
    result.  Here the bf16 values are multiplied and summed in float64: a
    product of two bf16 values has 16 significant bits, so a sum of them
    is exact, whatever order the CPU's or the GPU's matrix product sums
    in, as long as every product's lowest bit lies within float64's 53
    bits of the largest partial sum.  At the default descriptor (sums
    below 2^10) that holds while no nonzero feature is below 2^-15.
    Frames with black regions break it: smoothing leaves features near
    2^-20 at their edges (``eppm_tpu_torch/testing.py::dark_rows``),
    and there a sum may round, differently in another
    order; a target can then change only where a score lies within that
    rounding of a half step (``chip_smoke.py`` holds the card to the CPU
    on such data).  Where the condition holds, the scores, their x4096
    rounding and the argmaxes are the same on every device; against the
    JAX package's float32 sums they differ only where a score lies
    within float32 rounding of a half step.  (A bf16 torch matmul would
    round every score to bf16; a float32 one sums in a device-dependent
    order, and on the GPU may use TF32.  No float32 product is taken, so
    the TF32 switches do not apply.)"""
    n1, n2 = desc1.shape[0], desc2.shape[0]
    d1 = desc1.to(torch.float64)
    d2 = desc2.to(torch.float64)
    half_norm2 = 0.5 * (d2 * d2).sum(dim=1)
    half_norm1 = 0.5 * (d1 * d1).sum(dim=1) if bwd else None
    dev = desc1.device
    best_s = torch.full((n1,), -math.inf, dtype=torch.float64, device=dev)
    best_i = torch.zeros((n1,), dtype=torch.int32, device=dev)
    cols = []
    ar1 = torch.arange(n1, dtype=torch.int32, device=dev)[:, None]
    for j0 in range(0, n2, block):
        raw = d1 @ d2[j0 : j0 + block].T
        # fwd: first maximum within the block, strict > across blocks
        scores = torch.round((raw - half_norm2[None, j0 : j0 + block]) * 4096.0)
        i = torch.argmax(scores, dim=1)
        s = torch.gather(scores, 1, i[:, None])[:, 0]
        better = s > best_s
        best_s = torch.where(better, s, best_s)
        best_i = torch.where(better, i.to(torch.int32) + j0, best_i)
        if bwd:
            # this block's columns are complete; explicit first index
            bscores = torch.round((raw - half_norm1[:, None]) * 4096.0)
            is_max = bscores == bscores.max(dim=0).values[None, :]
            cols.append(torch.where(is_max, ar1, 2**30).min(dim=0).values)
    return best_i, (torch.cat(cols) if bwd else None)


def global_argmax(d1: torch.Tensor, d2: torch.Tensor,
                  block: int = 2048) -> torch.Tensor:
    """Index of the first best frame-2 row for every frame-1 row:
    (N1, D), (N2, D) bf16 -> (N1,) int32.  The plain version of kernel D
    (``ops/cuda_match.py``) and of the JAX package's
    ``global_match_xla`` / ``pallas_match.py::_match_kernel``."""
    return _score_sweep(d1, d2, block, bwd=False)[0]


def global_match(
    desc1: torch.Tensor, desc2: torch.Tensor, block: int = 2048
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-pixel SSD-argmin target over all of frame 2: (ty, tx) int32
    absolute target fields for frame 1 (``eppm_tpu/ops/match.py::
    global_match``).  Kernel D for CUDA tensors at every size, the plain
    version for CPU tensors."""
    from .cuda_match import global_argmax_auto

    h, w, d = desc1.shape
    w2 = desc2.shape[1]
    best_i = global_argmax_auto(desc1.reshape(h * w, d).contiguous(),
                                desc2.reshape(-1, d).contiguous(), block)
    return (best_i // w2).reshape(h, w), (best_i % w2).reshape(h, w)


def global_match_bidi(
    desc1: torch.Tensor, desc2: torch.Tensor, block: int = 2048
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Both directions of the global match from one score sweep
    (``_score_sweep``): returns (t1y, t1x, t2y, t2x).  The JAX package
    computes this sweep outside Pallas; so does the port, in float64
    matrix products."""
    h, w = desc1.shape[0], desc1.shape[1]
    h2, w2 = desc2.shape[0], desc2.shape[1]
    d = desc1.shape[2]
    fwd, bwd = _score_sweep(desc1.reshape(h * w, d), desc2.reshape(h2 * w2, d),
                            block, bwd=True)
    return (
        (fwd // w2).reshape(h, w), (fwd % w2).reshape(h, w),
        (bwd // w).reshape(h2, w2), (bwd % w).reshape(h2, w2),
    )


def _int_flow(flow: torch.Tensor):
    """(gy, gx) int32 = trunc of an (H, W, 2) flow, saturating as XLA
    does (a warm-start flow may hold ``UNKNOWN_FLOW``)."""
    return trunc_i32(flow[..., 1]), trunc_i32(flow[..., 0])


def _as_flow(gx: torch.Tensor, gy: torch.Tensor) -> torch.Tensor:
    return torch.stack([gx.to(torch.float32), gy.to(torch.float32)], dim=-1)


def rescore(pack1, pack2, gy, gx, cost_cfg: CostConfig,
            tap_chunk: int = TAP_CHUNK) -> torch.Tensor:
    """True cost of the integer offset field (gy, gx): one warp + one
    dense evaluation at candidate (0, 0)."""
    warped = warp_pack(pack2, gx, gy)
    return residual_costs_auto(pack1, warped, [(0, 0)], cost_cfg,
                               tap_chunk=tap_chunk)[0]


def rescore_multi(pack1, pack2, gys, gxs, cost_cfg: CostConfig,
                  tap_chunk: int = TAP_CHUNK):
    """True cost of K integer offset fields (K, H, W) -> (K, H, W): the K
    warps are one gather, the costs one kernel-A launch (multiwarp)."""
    k, h, w = gys.shape
    h2, w2 = pack2.shape[0], pack2.shape[1]
    ys, xs = grid(h, w, pack1.device)
    cy = (ys[None] + gys).clamp(0, h2 - 1)
    cx = (xs[None] + gxs).clamp(0, w2 - 1)
    flat = pack2.reshape(h2 * w2, pack2.shape[2])
    warped = flat[(cy * w2 + cx).reshape(-1).long()].reshape(
        k, h, w, pack2.shape[2]
    )
    return residual_costs_multiwarp_auto(pack1, warped, cost_cfg, tap_chunk)


def propagate_dense(pack1, pack2, flow, cost, steps, cost_cfg: CostConfig,
                    tap_chunk: int = TAP_CHUNK):
    """Dense jump-flood propagation: each round tries the 4 axial
    neighbors' offsets at the step distance plus the 3x3 offset median,
    rescored with the true cost and kept on strict improvement."""
    h, w = flow.shape[0], flow.shape[1]
    h2, w2 = pack2.shape[0], pack2.shape[1]
    ys, xs = grid(h, w, flow.device)
    gy, gx = _int_flow(flow)
    for step in steps:
        shifts = ((0, -step), (0, step), (-step, 0), (step, 0))
        gxs = torch.stack([shift2d(gx, dy, dx) for dy, dx in shifts]
                          + [median3(gx)])
        gys = torch.stack([shift2d(gy, dy, dx) for dy, dx in shifts]
                          + [median3(gy)])
        costs = rescore_multi(pack1, pack2, gys, gxs, cost_cfg, tap_chunk)
        inb = (
            (xs[None] + gxs >= 0) & (xs[None] + gxs < w2)
            & (ys[None] + gys >= 0) & (ys[None] + gys < h2)
        )
        costs = torch.where(inb, costs, FLT_MAX)
        for i in range(gxs.shape[0]):
            better = costs[i] < cost
            gx = torch.where(better, gxs[i], gx)
            gy = torch.where(better, gys[i], gy)
            cost = torch.where(better, costs[i], cost)
    return _as_flow(gx, gy), cost


def descend_level(pack1, pack2, flow, radius: int, cost_cfg: CostConfig,
                  tap_chunk: int = TAP_CHUNK):
    """One dense warp + (2r+1)^2 residual argmin sweep; returns the
    updated integer flow and its cost."""
    h, w = pack1.shape[0], pack1.shape[1]
    h2, w2 = pack2.shape[0], pack2.shape[1]
    gy, gx = _int_flow(flow)
    ys, xs = grid(h, w, flow.device)
    warped = warp_pack(pack2, gx, gy)
    cands = center_out_offsets(radius)
    costs = residual_costs_auto(pack1, warped, cands, cost_cfg,
                                tap_chunk=tap_chunk)
    best_dy, best_dx, best_cost = argmin_candidates(
        costs, cands, ys + gy, xs + gx, h2, w2
    )
    return _as_flow(gx + best_dx, gy + best_dy), best_cost


def _mini_pyramid(img, levels: int, ratio: float = 0.5, pack0=None):
    """Packs of a cascaded Gaussian mini-pyramid below the coarse level
    (level 0 = input resolution, ``pack0`` reused)."""
    h, w = img.shape[0], img.shape[1]
    if pack0 is None:
        pack0 = pack_frame(img, census_transform(img))
    packs = [pack0]
    base_sigma = 1.0 / ratio - 1.0
    cur = img
    for i in range(1, levels + 1):
        oh, ow = int(h * ratio**i), int(w * ratio**i)
        smoothed = gaussian_filter(cur, base_sigma, int(base_sigma * 3))
        cur = bilinear_resize(smoothed, oh, ow, ratio)
        packs.append(pack_frame(cur, census_transform(cur)))
    return packs


def _mini_levels(h: int, w: int, match_cfg: MatchConfig) -> int:
    """Mini-pyramid depth: levels keep min(h, w) >= ``min_level_dim``."""
    levels = 0
    while (
        levels < match_cfg.descent_levels
        and min(h, w) // 2 ** (levels + 1) >= match_cfg.min_level_dim
    ):
        levels += 1
    return levels


def _make_mini_cost(cost_cfg: CostConfig, match_cfg: MatchConfig) -> CostConfig:
    """Mini-level sweeps use a proportionally smaller, stride-1 patch."""
    return dataclasses.replace(
        cost_cfg,
        patch_radius=match_cfg.mini_patch_radius,
        patch_stride=1,
        sigma_spatial=0.5 * match_cfg.mini_patch_radius,
    )


def _descend_chain(packs_a, packs_b, tiny_targets, match_cfg, cost_cfg,
                   mini_cost, tap_chunk: int = TAP_CHUNK):
    """Tiny-level global targets -> descend the mini-pyramid with dense
    residual sweeps -> (flow, cost) at the coarse level."""
    tiny_a, tiny_b = packs_a[-1], packs_b[-1]
    t_y, t_x = tiny_targets
    ys, xs = grid(tiny_a.shape[0], tiny_a.shape[1], tiny_a.device)
    flow = _as_flow(t_x - xs, t_y - ys)
    flow, cost = descend_level(
        tiny_a, tiny_b, flow, match_cfg.descent_radius, mini_cost, tap_chunk
    )
    for lvl in range(len(packs_a) - 2, -1, -1):
        oh, ow = packs_a[lvl].shape[0], packs_a[lvl].shape[1]
        flow = bilinear_resize(flow, oh, ow, 2.0) * 2.0
        cc = cost_cfg if lvl == 0 else mini_cost
        flow, cost = descend_level(
            packs_a[lvl], packs_b[lvl], flow, match_cfg.descent_radius, cc,
            tap_chunk
        )
    return flow, cost


def _merge_proposal(pack_a, pack_b, flow, cost, pgy, pgx, cost_cfg,
                    tap_chunk: int = TAP_CHUNK):
    """Merge an integer offset-field proposal by true-cost argmin
    (out-of-image never wins)."""
    h, w = flow.shape[0], flow.shape[1]
    prop_cost = rescore(pack_a, pack_b, pgy, pgx, cost_cfg, tap_chunk)
    ys, xs = grid(h, w, flow.device)
    inb = (
        (xs + pgx >= 0) & (xs + pgx < pack_b.shape[1])
        & (ys + pgy >= 0) & (ys + pgy < pack_b.shape[0])
    )
    prop_cost = torch.where(inb, prop_cost, FLT_MAX)
    better = prop_cost < cost
    flow = torch.where(better[..., None], _as_flow(pgx, pgy), flow)
    return flow, torch.where(better, prop_cost, cost)


def _coarse_targets_from_global(p_y, p_x, s: int, h: int, w: int):
    """Global-argmax targets (on a stride-s grid) -> full-resolution
    integer offset fields (nearest upsampling of the proposal flow)."""
    if s > 1:
        ys_s, xs_s = grid(p_y.shape[0], p_y.shape[1], p_y.device)
        fy = (p_y - ys_s) * s
        fx = (p_x - xs_s) * s
        pgy = fy.repeat_interleave(s, 0).repeat_interleave(s, 1)[:h, :w]
        pgx = fx.repeat_interleave(s, 0).repeat_interleave(s, 1)[:h, :w]
        return pgy, pgx
    ys, xs = grid(h, w, p_y.device)
    return p_y - ys, p_x - xs


def _start_direction(packs_a, packs_b, tiny_targets, match_cfg, cost_cfg,
                     mini_cost, init_flow=None, tap_chunk: int = TAP_CHUNK):
    """(flow, cost) of one direction before the coarse proposals.

    Without a warm start: the descent chain from the tiny-level global
    targets, or zero flow and its cost where the coarse level has no mini
    level below it.  With ``init_flow`` (this direction's temporal warm
    start, at the coarse level) under ``warm_skip_global``: one dense
    residual sweep around it in place of both; otherwise the init is
    merged as a true-cost proposal."""
    pack_a, pack_b = packs_a[0], packs_b[0]
    if init_flow is not None and match_cfg.warm_skip_global:
        return descend_level(pack_a, pack_b, init_flow,
                             match_cfg.descent_radius, cost_cfg, tap_chunk)
    if tiny_targets is not None:
        flow, cost = _descend_chain(packs_a, packs_b, tiny_targets,
                                    match_cfg, cost_cfg, mini_cost, tap_chunk)
    else:
        z = torch.zeros(pack_a.shape[:2], dtype=torch.int32,
                        device=pack_a.device)
        flow, cost = _as_flow(z, z), rescore(pack_a, pack_b, z, z, cost_cfg,
                                             tap_chunk)
    if init_flow is not None:
        igy, igx = _int_flow(init_flow)
        flow, cost = _merge_proposal(pack_a, pack_b, flow, cost, igy, igx,
                                     cost_cfg, tap_chunk)
    return flow, cost


def _finish_direction(pack_a, pack_b, flow, cost, proposal, s: int,
                      match_cfg, cost_cfg, tap_chunk: int = TAP_CHUNK):
    """Merge the coarse global proposal (targets on a stride-s grid), if
    there is one, then polish (``_polish_direction``)."""
    if proposal is not None:
        h, w = flow.shape[0], flow.shape[1]
        pgy, pgx = _coarse_targets_from_global(*proposal, s, h, w)
        flow, cost = _merge_proposal(pack_a, pack_b, flow, cost, pgy, pgx,
                                     cost_cfg, tap_chunk)
    return _polish_direction(pack_a, pack_b, flow, cost, match_cfg, cost_cfg,
                             tap_chunk)


def match_coarse(
    img1: torch.Tensor,
    img2: torch.Tensor,
    cost_cfg: CostConfig,
    match_cfg: MatchConfig,
    pack1=None,
    pack2=None,
    init_flow=None,
    tap_chunk: int = TAP_CHUNK,
):
    """Coarse-level dense matching, frame 1 -> frame 2: (tx, ty, cost),
    absolute int32 targets and their cost (``eppm_tpu/ops/match.py::
    match_coarse``).  Its global matches run through kernel D on the card
    (``global_match``).  ``init_flow`` (H, W, 2) is a temporal warm start
    at this level: merged as a proposal, or, with
    ``match_cfg.warm_skip_global``, in place of the global stages.
    Every cost sums its taps in partial sums of ``tap_chunk``."""
    h, w = img1.shape[0], img1.shape[1]
    skip = init_flow is not None and match_cfg.warm_skip_global
    levels = 0 if skip else _mini_levels(h, w, match_cfg)
    packs1 = _mini_pyramid(img1, levels, pack0=pack1)
    packs2 = _mini_pyramid(img2, levels, pack0=pack2)
    tiny = None
    if levels > 0:
        tiny = global_match(patch_descriptors(packs1[-1], match_cfg),
                            patch_descriptors(packs2[-1], match_cfg),
                            match_cfg.global_block)
    flow, cost = _start_direction(packs1, packs2, tiny, match_cfg, cost_cfg,
                                  _make_mini_cost(cost_cfg, match_cfg),
                                  init_flow, tap_chunk)
    proposal, s = None, 1
    if match_cfg.global_at_coarse and not skip:
        # the argmax costs N1*N2: above the threshold the proposal grid
        # subsamples by 2 on both frames
        s = 2 if h * w > match_cfg.global_stride_threshold else 1
        proposal = global_match(
            patch_descriptors(packs1[0], match_cfg, stride=s),
            patch_descriptors(packs2[0], match_cfg, stride=s),
            match_cfg.global_block)
    return _finish_direction(packs1[0], packs2[0], flow, cost, proposal, s,
                             match_cfg, cost_cfg, tap_chunk)


def match_coarse_bidi(
    img1: torch.Tensor,
    img2: torch.Tensor,
    cost_cfg: CostConfig,
    match_cfg: MatchConfig,
    pack1=None,
    pack2=None,
    init_flow=None,
    tap_chunk: int = TAP_CHUNK,
):
    """Bidirectional coarse matching: ((tx1, ty1, c1), (tx2, ty2, c2)),
    sharing the mini-pyramids, descriptors and the global score sweep
    between the directions (``eppm_tpu/ops/match.py::match_coarse_bidi``).
    For frames of one size each direction equals a ``match_coarse`` call.
    ``init_flow`` seeds the forward direction and its negation the
    backward one."""
    h, w = img1.shape[0], img1.shape[1]
    h2, w2 = img2.shape[0], img2.shape[1]
    skip = init_flow is not None and match_cfg.warm_skip_global
    levels = 0 if skip else min(_mini_levels(h, w, match_cfg),
                                _mini_levels(h2, w2, match_cfg))
    packs1 = _mini_pyramid(img1, levels, pack0=pack1)
    packs2 = _mini_pyramid(img2, levels, pack0=pack2)
    mini_cost = _make_mini_cost(cost_cfg, match_cfg)

    tiny_f = tiny_b = None
    if levels > 0:
        t1y, t1x, t2y, t2x = global_match_bidi(
            patch_descriptors(packs1[-1], match_cfg),
            patch_descriptors(packs2[-1], match_cfg), match_cfg.global_block)
        tiny_f, tiny_b = (t1y, t1x), (t2y, t2x)
    flow_f, cost_f = _start_direction(packs1, packs2, tiny_f, match_cfg,
                                      cost_cfg, mini_cost, init_flow,
                                      tap_chunk)
    flow_b, cost_b = _start_direction(
        packs2, packs1, tiny_b, match_cfg, cost_cfg, mini_cost,
        None if init_flow is None else -init_flow, tap_chunk)

    prop_f = prop_b = None
    s = 1
    if match_cfg.global_at_coarse and not skip:
        s = 2 if max(h * w, h2 * w2) > match_cfg.global_stride_threshold else 1
        p1y, p1x, p2y, p2x = global_match_bidi(
            patch_descriptors(packs1[0], match_cfg, stride=s),
            patch_descriptors(packs2[0], match_cfg, stride=s),
            match_cfg.global_block)
        prop_f, prop_b = (p1y, p1x), (p2y, p2x)
    fwd = _finish_direction(packs1[0], packs2[0], flow_f, cost_f, prop_f, s,
                            match_cfg, cost_cfg, tap_chunk)
    bwd = _finish_direction(packs2[0], packs1[0], flow_b, cost_b, prop_b, s,
                            match_cfg, cost_cfg, tap_chunk)
    return fwd, bwd


def exact_best_of(pack1, pack2, cgxs, cgys, cur, cfg: CostConfig,
                  strict: bool = True):
    """One step of the exact stage over K candidate offset fields (K, H,
    W) int32: their exact quantized cost (``patch_cost_stack`` on the
    bfloat16 tap stack of ``cfg.tap_offsets``; targets outside frame 2
    masked to FLT_MAX), the first per-pixel least of them accepted
    against the incumbent ``cur`` = (gx, gy, cost) on a strictly lower
    cost (``strict``) or at equality -> the new (gx, gy, cost).  With
    ``cur`` None, one field (K = 1) scored, unmasked: (gx, gy, cost).
    The plain version of kernel F (``ops/cuda_exact.py``), which
    ``exact_best_of_auto`` takes for CPU tensors."""
    h, w = cgxs.shape[-2:]
    h2, w2 = pack2.shape[0], pack2.shape[1]
    ys, xs = grid(h, w, pack1.device)
    offs2 = cfg.tap_offsets
    stack2 = make_patch_stack(pack2, offs2, dtype=torch.bfloat16)

    def exact_multi(cgxs, cgys, mask_oob=True):
        """Exact quantized cost of K offset fields (K, H, W)."""
        ctxs = xs[None] + cgxs
        ctys = ys[None] + cgys
        ck = quantize_cost(
            patch_cost_stack(pack1, stack2, ctxs, ctys, cfg, offs2))
        if mask_oob:
            inb = (ctxs >= 0) & (ctxs < w2) & (ctys >= 0) & (ctys < h2)
            ck = torch.where(inb, ck, FLT_MAX)
        return ck

    if cur is None:
        return cgxs[0], cgys[0], exact_multi(cgxs, cgys, mask_oob=False)[0]
    gx0, gy0, cost0 = cur
    ck = exact_multi(cgxs, cgys)
    i1 = torch.argmin(ck, dim=0)[None]
    cbest = torch.gather(ck, 0, i1)[0]
    cgx = torch.gather(cgxs, 0, i1)[0]
    cgy = torch.gather(cgys, 0, i1)[0]
    win = (cbest < cost0) if strict else (cbest <= cost0)
    return (torch.where(win, cgx, gx0), torch.where(win, cgy, gy0),
            torch.where(win, cbest, cost0))


def _polish_direction(pack1, pack2, flow, cost, match_cfg: MatchConfig,
                      cost_cfg: CostConfig, tap_chunk: int = TAP_CHUNK):
    """Shared tail of the coarse matcher: dense jump-flood propagation,
    the final polish sweep, and the exact-cost stage (symmetric gathered
    cost on a bf16 tap stack: polish ring, propagation, median consensus),
    one ``exact_best_of`` a step: kernel F on the card."""
    from .cuda_exact import exact_best_of_auto

    h, w = flow.shape[0], flow.shape[1]
    if match_cfg.prop_steps:
        flow, cost = propagate_dense(
            pack1, pack2, flow, cost, match_cfg.prop_steps, cost_cfg,
            tap_chunk
        )
    if match_cfg.final_radius > 0:
        flow, cost = descend_level(
            pack1, pack2, flow, match_cfg.final_radius, cost_cfg, tap_chunk
        )
    ys, xs = grid(h, w, flow.device)
    gy, gx = _int_flow(flow)
    if match_cfg.exact_polish_radius <= 0:
        return xs + gx, ys + gy, cost

    exact_cfg = dataclasses.replace(
        cost_cfg, patch_stride=match_cfg.exact_tap_stride
    )

    def best_of(cgxs, cgys, cur, strict=True):
        return exact_best_of_auto(pack1, pack2, cgxs, cgys, cur, exact_cfg,
                                  strict)

    # incumbent, exactly scored (unmasked)
    gx, gy, cost = best_of(gx[None], gy[None], None)
    ring = [c for c in center_out_offsets(match_cfg.exact_polish_radius)
            if c != (0, 0)]
    cgys = torch.stack([gy + m for (m, _) in ring])
    cgxs = torch.stack([gx + n for (_, n) in ring])
    gx, gy, cost = best_of(cgxs, cgys, (gx, gy, cost))
    for step in match_cfg.exact_prop_steps:
        shifts = ((0, -step), (0, step), (-step, 0), (step, 0))
        cgys = torch.stack([shift2d(gy, dy, dx) for dy, dx in shifts])
        cgxs = torch.stack([shift2d(gx, dy, dx) for dy, dx in shifts])
        gx, gy, cost = best_of(cgxs, cgys, (gx, gy, cost))
    for _ in range(match_cfg.exact_median_rounds):
        gx, gy, cost = best_of(median3(gx)[None], median3(gy)[None],
                               (gx, gy, cost), strict=False)
    return xs + gx, ys + gy, cost
