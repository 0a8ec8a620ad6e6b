"""Coarse-level occlusion reconstruction (counterpart of the orchestration
half of ``eppm_tpu/ops/pallas_wmf.py``, lines 614-863: the JAX package
keeps it beside its Pallas kernel; here the kernel module holds only the
kernel and this module the chain that calls it).

Default order (``RefineConfig.wmf_fill_first``): fill the LR-invalidated
holes from the 4 scan directions, let frame-2 evidence re-decide holes
that are visible there (photometric arbitration: kernel F's arbitration
rule on the card, ``ops/cuda_exact.py``), a second fill pass for
the corners no direction reaches, one frozen-valid WMF polish per
dilation (kernel C), then 3x3 median majority rounds over the holes.
The legacy order (``wmf_fill_first=False``, the reference's schedule,
compute_flow .cpp:236-243): ``wmf_coarse_iters`` Jacobi iterations of
the WMF over the holes (kernel C), then one hole fill.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..config import FLT_MAX, INVALID_LOCATION, RefineConfig
from ..utils import trace
from ._util import grid
from .cost import make_patch_stack, patch_cost_stack
from .cuda_wmf import weighted_median_filter_auto
from .dense import median3
from .refine import fill_holes

__all__ = ["arbitration_candidates", "arbitrate_holes",
           "wmf_polish_occlusions", "coarse_occlusion_reconstruct"]


def arbitration_candidates(tx, cands, orig):
    """The arbitration's candidate fields as offsets from the pixel
    (``eppm_tpu/ops/pallas_wmf.py::_photometric_arbitrate``): the 4
    directional fill sources (offsets ROUNDED here, where the fill
    truncates), each flagged by its direction's ``found``, and the pixel's
    own pre-LR match ``orig``, flagged where a directional source agrees
    with it within 2 px -> (gx, gy) int32 and flags bool, (K, H, W) each,
    K = 5 (4 without ``orig``)."""
    h, w = tx.shape
    ys, xs = grid(h, w, tx.device)
    fields = []
    for found, gox, goy in cands:
        gx = torch.round(gox).to(torch.int32)
        gy = torch.round(goy).to(torch.int32)
        fields.append((found, gx, gy, xs + gx, ys + gy))
    if orig is not None:
        otx, oty = orig
        agree = torch.zeros((h, w), dtype=torch.bool, device=tx.device)
        for found, _, _, ctx, cty in fields:
            d = torch.maximum((ctx - otx).abs(), (cty - oty).abs())
            agree = agree | (found & (d <= 2))
        # x + (otx - x) wraps back to otx in int32
        fields.append((agree, otx - xs, oty - ys, otx, oty))
    return (torch.stack([f[1] for f in fields]),
            torch.stack([f[2] for f in fields]),
            torch.stack([f[0] for f in fields]))


def arbitrate_holes(pack1, pack2, cgxs, cgys, masks, cur, fill, cost_cfg,
                    thresh: float):
    """Re-decide each hole's fill by the exact patch cost where the scene
    is visible in frame 2: the K candidate offset fields ``cgxs``,
    ``cgys`` (K, H, W) int32 scored by ``patch_cost_stack`` on frame 2's
    float32 tap stack (unquantized), each masked to FLT_MAX unless its
    flag in ``masks`` is set and its target lies in frame 2; a hole of the
    LR-checked targets ``cur`` = (tx, ty) adopts the first least
    candidate's target when that cost is below ``thresh``, every other
    pixel keeps the fill ``fill`` = (ftx, fty).  The plain version of
    kernel F's arbitration rule (``ops/cuda_exact.py``), which
    ``arbitrate_holes_auto`` takes for CPU tensors."""
    tx, ty = cur
    ftx, fty = fill
    h, w = tx.shape
    h2, w2 = pack2.shape[0], pack2.shape[1]
    ys, xs = grid(h, w, tx.device)
    txs = xs[None] + cgxs
    tys = ys[None] + cgys
    offs = cost_cfg.tap_offsets
    stack2 = make_patch_stack(pack2, offs)
    costs = patch_cost_stack(pack1, stack2, txs, tys, cost_cfg, offs)
    inb = (txs >= 0) & (txs < w2) & (tys >= 0) & (tys < h2)
    costs = torch.where(masks & inb, costs, FLT_MAX)
    cmin = costs.min(dim=0).values
    kbest = torch.argmin(costs, dim=0)  # first minimum
    btx = torch.gather(txs, 0, kbest[None])[0]
    bty = torch.gather(tys, 0, kbest[None])[0]

    hole = (tx < 0) | (ty < 0)
    use = hole & (cmin < thresh)
    return torch.where(use, btx, ftx), torch.where(use, bty, fty)


def _photometric_arbitrate(
    tx, ty, ftx, fty, cands, packs, cost_cfg, thresh: float, orig,
):
    """The photometric arbitration of the fill
    (``eppm_tpu/ops/pallas_wmf.py::_photometric_arbitrate``): the candidate
    fields in plain torch, then one launch of kernel F's arbitration rule
    on the card (``arbitrate_holes`` on the CPU)."""
    from .cuda_exact import arbitrate_holes_auto

    cgxs, cgys, masks = arbitration_candidates(tx, cands, orig)
    return arbitrate_holes_auto(packs[0], packs[1], cgxs, cgys, masks,
                                (tx, ty), (ftx, fty), cost_cfg, thresh)


def wmf_polish_occlusions(
    tx, ty, img, cfg: RefineConfig = RefineConfig(), num_iter: int = 1,
    dilations: Tuple[int, ...] = (1,),
    fill_patch_radius: int = 0,
    accept_thresh: float = 0.0,
    fill_linear_baseline: int = 0,
    fill_linear_slope_tol: float = 0.3,
    packs=None,
    cost_cfg=None,
    fill_cost_thresh: float = 0.0,
    orig=None,
):
    """Fill-then-polish occlusion reconstruction
    (``eppm_tpu/ops/pallas_wmf.py::wmf_polish_occlusions``)."""
    arbitrate = (
        packs is not None and cost_cfg is not None and fill_cost_thresh > 0
    )
    if arbitrate:
        ftx, fty, cands = fill_holes(
            tx, ty, img, patch_radius=fill_patch_radius,
            linear_baseline=fill_linear_baseline,
            linear_slope_tol=fill_linear_slope_tol,
            return_candidates=True,
        )
        ftx, fty = _photometric_arbitrate(
            tx, ty, ftx, fty, cands, packs, cost_cfg, fill_cost_thresh, orig,
        )
    else:
        ftx, fty = fill_holes(
            tx, ty, img, patch_radius=fill_patch_radius,
            linear_baseline=fill_linear_baseline,
            linear_slope_tol=fill_linear_slope_tol,
        )
    # corners no scan direction reaches keep INVALID after one pass; a
    # second single-pixel fill over the first pass's output reaches them
    h, w = ftx.shape
    sent = INVALID_LOCATION // 2
    ftx2, fty2 = fill_holes(ftx, fty, img)
    ftx = torch.where(ftx > sent, ftx, ftx2)
    fty = torch.where(fty > sent, fty, fty2)
    # last resort (whole image occluded): zero offset
    ys, xs = grid(h, w, tx.device)
    ftx = torch.where(ftx > sent, ftx, xs)
    fty = torch.where(fty > sent, fty, ys)
    hole = (tx < 0) | (ty < 0)
    cur = (ftx, fty)
    for d in dilations:
        nxt = weighted_median_filter_auto(
            tx, ty, img, cfg, num_iter, only_occlusion=True,
            polish_init=cur, dilation=d,
        )
        if d > 1 and accept_thresh > 0:
            agree = ((nxt[0] - cur[0]).abs().to(torch.float32)
                     <= accept_thresh) & (
                (nxt[1] - cur[1]).abs().to(torch.float32) <= accept_thresh)
            keep = hole & ~agree
            nxt = (torch.where(keep, cur[0], nxt[0]),
                   torch.where(keep, cur[1], nxt[1]))
        cur = nxt
    return cur


def coarse_occlusion_reconstruct(tx, ty, img, rcfg: RefineConfig,
                                 packs=None, cost_cfg=None, orig=None):
    """The coarse level's occlusion chain
    (``eppm_tpu/ops/pallas_wmf.py::coarse_occlusion_reconstruct``).
    Under ``wmf_fill_first``: one frozen-valid polish iteration per
    dilation (one iteration is that pass's fixed point), then median
    majority rounds over the holes.  Otherwise the legacy order:
    ``wmf_coarse_iters`` occlusion-only Jacobi iterations, then
    ``fill_holes``, the two marked for the tracer as ``occlusion.wmf``
    and ``occlusion.fill`` inside ``compute_flow``'s ``occlusion``
    stage.  Either way the optional full-image WMF passes follow."""
    if rcfg.wmf_fill_first:
        hole = (tx < 0) | (ty < 0)
        tx, ty = wmf_polish_occlusions(
            tx, ty, img, rcfg, num_iter=1,
            dilations=rcfg.wmf_polish_dilations,
            fill_patch_radius=rcfg.fill_patch_radius,
            accept_thresh=rcfg.wmf_polish_accept_thresh,
            fill_linear_baseline=rcfg.fill_linear_baseline,
            fill_linear_slope_tol=rcfg.fill_linear_slope_tol,
            packs=packs, cost_cfg=cost_cfg,
            fill_cost_thresh=rcfg.fill_photometric_thresh,
            orig=orig,
        )
        if rcfg.fill_median_rounds > 0:
            ys, xs = grid(tx.shape[0], tx.shape[1], tx.device)
            ox = (tx - xs).to(torch.float32)
            oy = (ty - ys).to(torch.float32)
            for _ in range(rcfg.fill_median_rounds):
                ox = torch.where(hole, median3(ox), ox)
                oy = torch.where(hole, median3(oy), oy)
            tx = torch.where(hole, ox.to(torch.int32) + xs, tx)
            ty = torch.where(hole, oy.to(torch.int32) + ys, ty)
    else:
        trace.submark("occlusion.wmf")
        tx, ty = weighted_median_filter_auto(
            tx, ty, img, rcfg, num_iter=rcfg.wmf_coarse_iters,
            only_occlusion=True,
        )
        trace.submark("occlusion.fill")
        tx, ty = fill_holes(tx, ty, img)
    if rcfg.wmf_coarse_full_iters > 0:
        tx, ty = weighted_median_filter_auto(
            tx, ty, img, rcfg, num_iter=rcfg.wmf_coarse_full_iters,
            only_occlusion=False,
        )
    return tx, ty
