"""Flow refinement chain (counterpart of ``eppm_tpu/ops/refine.py``):
left-right check, outlier removal, hole filling, NNF<->flow conversion,
the gathered plane-fitting re-search (``blf_refine_flow``,
``refine_impl="gather"``), the plain PyTorch versions of kernel B
(``flow_smoothing``) and kernel C (``weighted_median_filter``), and the
reference's utility stages that its default path does not call
(``median_filter``, ``guide_image_smoothing``, ``flow_cutoff``,
``eliminate_still_region``).

Conventions (identical to the reference, bao_pmflow_refine_kernel.cu):
  - NNF = absolute int32 target coordinates (tx, ty); INVALID_LOCATION
    marks culled pixels, FLT_MAX their cost (:46,62-63).
  - A pixel is occluded/invalid when tx < 0 or ty < 0 (:213,304).
  - flow = target - position; unknown flow = 1e10 (:644-653).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch

from .config import (
    FLT_MAX,
    INVALID_LOCATION,
    UNKNOWN_FLOW,
    UNKNOWN_FLOW_THRESH,
    CostConfig,
    RefineConfig,
)
from ._util import (exp_cephes, f32, fma32, ftz, grid, inv32, pad_edge,
                    trunc_i32)
from .cost import TAP_CHUNK, patch_cost_ad_l2, patch_cost_planefitting

__all__ = [
    "lr_check",
    "outlier_removal",
    "weighted_median_filter",
    "fill_holes",
    "nnf_to_flow",
    "flow_to_nnf",
    "flow_smoothing",
    "blf_refine_flow",
    "median_filter",
    "guide_image_smoothing",
    "flow_cutoff",
    "eliminate_still_region",
]

# Taps per partial sum of the smoothing and supports per partial sum of
# the weighted median (the JAX package's scan chunks); kernels B and C sum
# in the same partials.
SMOOTH_CHUNK = 21
WMF_CHUNK = 27


def _pad_const(a: torch.Tensor, r: int, value: float) -> torch.Tensor:
    """Constant pad of the two leading dims by r."""
    h, w = a.shape[0], a.shape[1]
    out = torch.full((h + 2 * r, w + 2 * r) + tuple(a.shape[2:]), value,
                     dtype=a.dtype, device=a.device)
    out[r : r + h, r : r + w] = a
    return out


def _lr_check_one(tx, ty, cost, tx2, ty2, thresh: int):
    """One direction of d_left_right_check (refine_kernel.cu:53-76)."""
    h, w = tx.shape
    ys, xs = grid(h, w, tx.device)
    oob = (tx < 0) | (tx >= w) | (ty < 0) | (ty >= h)
    idx = (ty.clamp(0, h - 1) * w + tx.clamp(0, w - 1)).long()
    back_x = tx2.reshape(-1)[idx]
    back_y = ty2.reshape(-1)[idx]
    incons = ((back_x - xs).abs() > thresh) | ((back_y - ys).abs() > thresh)
    bad = oob | incons
    return (
        torch.where(bad, INVALID_LOCATION, tx),
        torch.where(bad, INVALID_LOCATION, ty),
        torch.where(bad, FLT_MAX, cost),
    )


def lr_check(tx1, ty1, cost1, tx2, ty2, cost2, thresh: int = 0):
    """Bidirectional left-right check in the reference's launch order
    (refine_kernel.cu:89-90): direction 2 is checked against the already
    culled direction 1."""
    ntx1, nty1, nc1 = _lr_check_one(tx1, ty1, cost1, tx2, ty2, thresh)
    ntx2, nty2, nc2 = _lr_check_one(tx2, ty2, cost2, ntx1, nty1, thresh)
    return ntx1, nty1, nc1, ntx2, nty2, nc2


def outlier_removal(tx, ty, cost, cfg: RefineConfig = RefineConfig()):
    """Invalidate isolated displacements (refine_kernel.cu:149-193): a
    non-occluded pixel survives when at least (2R+1)^2/2 in-image window
    neighbors carry a displacement within +-STAT_SIM_THRESH in both
    components; ``stat_proportional`` and the collapse guard follow
    ``eppm_tpu/ops/refine.py::outlier_removal``."""
    h, w = tx.shape
    r = cfg.stat_radius
    ys, xs = grid(h, w, tx.device)
    ox = (tx - xs).to(torch.float32)
    oy = (ty - ys).to(torch.float32)
    pox = _pad_const(ox, r, 1e9)
    poy = _pad_const(oy, r, 1e9)
    vfield = ((tx >= 0) | (ty >= 0)).to(torch.float32)
    pval = _pad_const(vfield, r, 0.0)
    count = torch.zeros((h, w), dtype=torch.float32, device=tx.device)
    vcount = torch.zeros_like(count)
    for dy in range(-r, r + 1):
        for dx in range(-r, r + 1):
            nox = pox[r + dy : r + dy + h, r + dx : r + dx + w]
            noy = poy[r + dy : r + dy + h, r + dx : r + dx + w]
            sim = ((nox - ox).abs() <= cfg.stat_sim_thresh) & (
                (noy - oy).abs() <= cfg.stat_sim_thresh
            )
            count = count + sim.to(torch.float32)
            vcount = vcount + pval[r + dy : r + dy + h, r + dx : r + dx + w]
    occluded = (tx < 0) & (ty < 0)  # skipped pixels (refine_kernel.cu:156)
    prop_thresh = torch.floor(vcount / 2.0).clamp_min(4.0)
    if cfg.stat_proportional:
        cull = (~occluded) & (count < prop_thresh)
    else:
        cull = (~occluded) & (count < cfg.stat_count_thresh)
        if cfg.stat_collapse_guard > 0:
            n_valid = vfield.sum().clamp_min(1.0)
            kept = (vfield * (~cull).to(torch.float32)).sum()
            collapse = kept / n_valid < cfg.stat_collapse_guard
            cull = torch.where(collapse, (~occluded) & (count < prop_thresh),
                               cull)
    return (
        torch.where(cull, INVALID_LOCATION, tx),
        torch.where(cull, INVALID_LOCATION, ty),
        torch.where(cull, FLT_MAX, cost),
    )


def _wmf_tables(cfg: RefineConfig, dilation: int):
    """Window offsets (raster order, dilated) and their float32 spatial
    weights taken on the UNDILATED offsets."""
    r = cfg.wmf_radius
    sig_s2 = cfg.wmf_sigma_spatial**2
    offs = [(dy * dilation, dx * dilation)
            for dy in range(-r, r + 1) for dx in range(-r, r + 1)]
    gws = np.asarray(
        [math.exp(-(dy * dy) / sig_s2) * math.exp(-(dx * dx) / sig_s2)
         for dy in range(-r, r + 1) for dx in range(-r, r + 1)],
        np.float32,
    )
    return offs, gws


def weighted_median_filter(
    tx,
    ty,
    img,
    cfg: RefineConfig = RefineConfig(),
    num_iter: int = 1,
    only_occlusion: bool = False,
    polish_init: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    dilation: int = 1,
):
    """Weighted-median displacement filter (refine_kernel.cu:206-286),
    Jacobi iterations; the plain version of kernel C (``ops/cuda_wmf.py``).

    Every valid displacement of the window is a candidate; the winner
    minimizes the bilateral-weighted L-inf deviation from the window's
    valid displacements (first minimum in raster order).  ``polish_init``
    (tx_fill, ty_fill) is the frozen-valid polish mode: holes start from
    the fill and are re-medianed from originally-valid data only; the
    output is fully valid.  ``dilation`` scales the offsets, not the
    spatial weights."""
    h, w = tx.shape
    r = cfg.wmf_radius
    sig_r2 = cfg.wmf_sigma_range**2
    ys, xs = grid(h, w, tx.device)
    offs, gws = _wmf_tables(cfg, dilation)
    reach = r * dilation
    pimg = pad_edge(img, reach, reach)

    valid0 = ((tx >= 0) & (ty >= 0)).to(torch.float32)
    if polish_init is not None:
        ftx, fty = polish_init
        tx = torch.where(valid0 > 0, tx, ftx)
        ty = torch.where(valid0 > 0, ty, fty)

    def window(a, dy, dx):
        return a[reach + dy : reach + dy + h, reach + dx : reach + dx + w]

    # support weights without validity: iteration-invariant
    wimg = []
    for (dy, dx), g in zip(offs, gws):
        d = (window(pimg, dy, dx) - img).abs()
        dr = torch.maximum(torch.maximum(d[..., 0], d[..., 1]), d[..., 2])
        wimg.append((float(g), exp_cephes(-(dr * dr) * inv32(sig_r2))))

    for _ in range(num_iter):
        ox = (tx - xs).to(torch.float32)
        oy = (ty - ys).to(torch.float32)
        valid = valid0 if polish_init is not None else (
            ((tx >= 0) & (ty >= 0)).to(torch.float32))
        pox = _pad_const(ox, reach, 0.0)
        poy = _pad_const(oy, reach, 0.0)
        pvalid = _pad_const(valid, reach, 0.0)
        # window values, one plane per offset: the candidates and the
        # supports are the same samples
        wox = torch.stack([window(pox, dy, dx) for (dy, dx) in offs])
        woy = torch.stack([window(poy, dy, dx) for (dy, dx) in offs])
        wval = torch.stack([window(pvalid, dy, dx) for (dy, dx) in offs])
        # all candidates at once; supports summed in raster order, in
        # chunks of ``WMF_CHUNK`` like the JAX oracle's scan
        cost = torch.zeros_like(wox)
        weight_sum = torch.zeros((h, w), dtype=torch.float32, device=tx.device)
        for c0 in range(0, len(offs), WMF_CHUNK):
            part_c = torch.zeros_like(wox)
            part_w = torch.zeros_like(weight_sum)
            for s in range(c0, min(c0 + WMF_CHUNK, len(offs))):
                g, e = wimg[s]
                ws = ftz(wval[s] * g * e)
                dev = torch.maximum((wox - wox[s]).abs(),
                                    (woy - woy[s]).abs())
                part_c = part_c + ws * dev
                part_w = part_w + ws
            cost = cost + part_c
            weight_sum = weight_sum + part_w
        cost = torch.where(wval > 0, cost, FLT_MAX)
        best_cost = torch.full((h, w), FLT_MAX, dtype=torch.float32,
                               device=tx.device)
        best_ox, best_oy = ox, oy
        for c in range(len(offs)):
            better = (weight_sum > 0) & (cost[c] < best_cost)
            best_cost = torch.where(better, cost[c], best_cost)
            best_ox = torch.where(better, wox[c], best_ox)
            best_oy = torch.where(better, woy[c], best_oy)
        # negative reconstructed targets are not written (refine_kernel.cu:286)
        found = (
            (best_cost < FLT_MAX)
            & (best_ox + xs.to(torch.float32) >= 0)
            & (best_oy + ys.to(torch.float32) >= 0)
        )
        new_tx = torch.where(found, best_ox.to(torch.int32) + xs, tx)
        new_ty = torch.where(found, best_oy.to(torch.int32) + ys, ty)
        if polish_init is not None:
            occ = valid0 == 0
        elif only_occlusion:
            occ = (tx < 0) | (ty < 0)  # refine_kernel.cu:213
        else:
            occ = torch.ones_like(found)
        tx = torch.where(occ, new_tx, tx)
        ty = torch.where(occ, new_ty, ty)
    return tx, ty


def fill_holes(tx, ty, img, patch_radius: int = 0,
               linear_baseline: int = 0, linear_slope_tol: float = 0.3,
               linear_max_slope: float = 1.0,
               return_candidates: bool = False):
    """Fill occlusions from the color-nearest of the first valid
    displacement in each of the 4 scan directions (refine_kernel.cu:
    297-371), with the JAX package's patch-SAD color test
    (``patch_radius``), linear extrapolation (``linear_baseline``) and
    ``return_candidates``; the unbounded scans are cumulative-max index
    propagations.  Holes with no valid pixel in any direction keep
    INVALID (see ``eppm_tpu/ops/refine.py::fill_holes``)."""
    h, w = tx.shape
    ys, xs = grid(h, w, tx.device)
    valid = (tx >= 0) & (ty >= 0)
    ox = (tx - xs).to(torch.float32)
    oy = (ty - ys).to(torch.float32)

    def nearest(axis: int, reverse: bool):
        """Index along ``axis`` of the nearest valid pixel strictly before
        (after, for reverse) each position; -1 where none exists."""
        size = w if axis == 1 else h
        coords = (xs if axis == 1 else ys).contiguous()
        v = valid
        if reverse:
            v = v.flip(axis)
        idx = torch.where(v, coords, -1)
        acc = torch.cummax(idx, dim=axis).values
        # exclusive shift: drop self, prepend "none"
        none = torch.full_like(acc.narrow(axis, 0, 1), -1)
        acc = torch.cat([none, acc.narrow(axis, 0, size - 1)], dim=axis)
        if reverse:
            acc = acc.flip(axis)
            acc = torch.where(acc >= 0, size - 1 - acc, -1)
        return acc

    pr = patch_radius
    if pr > 0:
        pimg = pad_edge(img, pr, pr)

    def take(field, idx, axis):
        if field.dim() == 3:
            idx = idx[..., None].expand(-1, -1, field.shape[2])
        return torch.gather(field, axis, idx.long())

    dirs = []
    for axis, reverse in ((1, False), (1, True), (0, False), (0, True)):
        nidx = nearest(axis, reverse)
        found = nidx >= 0
        size = w if axis == 1 else h
        coords = xs if axis == 1 else ys
        nidxc = nidx.clamp(0, size - 1)
        gox = take(ox, nidxc, axis)
        goy = take(oy, nidxc, axis)
        if linear_baseline > 0:
            # first-order extrapolation: two slope estimates over b and 2b
            # behind the nearest valid pixel, accepted where they agree
            b = linear_baseline
            step = b if reverse else -b
            i1 = nidx + step
            i2 = nidx + 2 * step
            ok = found & (i1 >= 0) & (i1 < size) & (i2 >= 0) & (i2 < size)
            i1c = i1.clamp(0, size - 1)
            i2c = i2.clamp(0, size - 1)
            ok = ok & take(valid, i1c, axis) & take(valid, i2c, axis)
            inv_b = 1.0 / float(b)
            dist = (coords - nidxc).abs().to(torch.float32)

            def slope(field, g0):
                v1 = take(field, i1c, axis)
                v2 = take(field, i2c, axis)
                s1 = (g0 - v1) * inv_b
                s2 = (v1 - v2) * inv_b
                agree = ok & ((s1 - s2).abs() <= linear_slope_tol)
                s = ((g0 - v2) * (0.5 * inv_b)).clamp(
                    -linear_max_slope, linear_max_slope
                )
                return torch.where(agree, s, 0.0)

            # a fused multiply-add, as XLA's CPU backend computes it
            gox = fma32(slope(ox, gox), dist, gox)
            goy = fma32(slope(oy, goy), dist, goy)
        if pr == 0:
            d = (take(img, nidxc, axis) - img).abs()
            pixdiff = torch.maximum(torch.maximum(d[..., 0], d[..., 1]),
                                    d[..., 2])
        else:
            # patch SAD between the hole's and the source's neighborhoods
            acc = torch.zeros((h, w), dtype=torch.float32, device=tx.device)
            for dy in range(-pr, pr + 1):
                for dx in range(-pr, pr + 1):
                    S = pimg[pr + dy : pr + dy + h, pr + dx : pr + dx + w]
                    d = (take(S, nidxc, axis) - S).abs()
                    acc = acc + torch.maximum(
                        torch.maximum(d[..., 0], d[..., 1]), d[..., 2]
                    )
            pixdiff = acc * inv32((2 * pr + 1) ** 2)
        pixdiff = torch.where(found, pixdiff, FLT_MAX)
        dirs.append((pixdiff, gox, goy, found))

    best_diff = torch.full((h, w), FLT_MAX, dtype=torch.float32,
                           device=tx.device)
    best_ox, best_oy = ox, oy
    any_found = torch.zeros((h, w), dtype=torch.bool, device=tx.device)
    for pixdiff, gox, goy, found in dirs:  # order: left, right, up, down
        better = found & (pixdiff < best_diff)
        best_diff = torch.where(better, pixdiff, best_diff)
        best_ox = torch.where(better, gox, best_ox)
        best_oy = torch.where(better, goy, best_oy)
        any_found = any_found | found

    fill = (~valid) & any_found
    new_tx = torch.where(fill, best_ox.to(torch.int32) + xs, tx)
    new_ty = torch.where(fill, best_oy.to(torch.int32) + ys, ty)
    if return_candidates:
        return new_tx, new_ty, [(found, gox, goy)
                                for (_, gox, goy, found) in dirs]
    return new_tx, new_ty


def nnf_to_flow(tx, ty):
    """Absolute targets -> float offsets (refine_kernel.cu:636-655)."""
    h, w = tx.shape
    ys, xs = grid(h, w, tx.device)
    invalid = (tx <= INVALID_LOCATION) | (ty <= INVALID_LOCATION)
    u = torch.where(invalid, UNKNOWN_FLOW, (tx - xs).to(torch.float32))
    v = torch.where(invalid, UNKNOWN_FLOW, (ty - ys).to(torch.float32))
    return torch.stack([u, v], dim=-1)


def flow_to_nnf(flow):
    """Float offsets -> absolute targets, truncating toward zero
    (refine_kernel.cu:657-676)."""
    h, w = flow.shape[:2]
    ys, xs = grid(h, w, flow.device)
    u, v = flow[..., 0], flow[..., 1]
    unknown = (u > UNKNOWN_FLOW_THRESH) | (v > UNKNOWN_FLOW_THRESH)
    tx = trunc_i32(u) + xs
    ty = trunc_i32(v) + ys
    return (torch.where(unknown, INVALID_LOCATION, tx),
            torch.where(unknown, INVALID_LOCATION, ty))


def smoothing_weights(cfg: RefineConfig) -> np.ndarray:
    """(2r+1)^2 float32 spatial weights of the flow smoothing window,
    row-major over (dy, dx) — shared by the plain version and kernel B."""
    r = cfg.blf_radius
    sig_s2 = cfg.blf_sigma_spatial**2
    return np.asarray(
        [math.exp(-(dy * dy) / sig_s2) * math.exp(-(dx * dx) / sig_s2)
         for dy in range(-r, r + 1) for dx in range(-r, r + 1)],
        np.float32,
    )


def chunk_sum21(terms):
    """The float32 sum of up to ``SMOOTH_CHUNK`` = 21 terms (missing ones
    +0) in the order XLA's CPU backend sums the JAX package's chunk of
    weighted flows (its reduction over the chunk, vectorised 8 wide):
    s_i = t_i + t_(i+8) for i < 8, then ((s0 + s4) + (s2 + s6)) + ((s1 +
    s5) + (s3 + s7)), then ((that + t16) + t18) + (t17 + t19), then + t20.
    Kernel B sums each chunk in the same order."""
    t = list(terms) + [torch.zeros_like(terms[0])] * (21 - len(terms))
    s = [t[i] + t[i + 8] for i in range(8)]
    a = [s[i] + s[i + 4] for i in range(4)]
    r = (a[0] + a[2]) + (a[1] + a[3])
    return (((r + t[16]) + t[18]) + (t[17] + t[19])) + t[20]


def flow_smoothing(flow, img, cfg: RefineConfig = RefineConfig()):
    """Joint-bilateral flow smoothing (refine_kernel.cu:764-826), the
    plain version of kernel B (``ops/cuda_smooth.py``): image-guided
    weights over radius 2*sigma_s, unknown-flow and out-of-image taps
    skipped; a pixel whose window holds no known flow keeps its value."""
    h, w = flow.shape[:2]
    r = cfg.blf_radius
    sig_r2 = cfg.blf_sigma_range**2
    pflow = _pad_const(flow, r, UNKNOWN_FLOW)
    pimg = pad_edge(img, r, r)
    gws = smoothing_weights(cfg)
    offs = [(dy, dx) for dy in range(-r, r + 1) for dx in range(-r, r + 1)]
    fsum = torch.zeros((h, w, 2), dtype=torch.float32, device=flow.device)
    wsum = torch.zeros((h, w), dtype=torch.float32, device=flow.device)
    # Taps in row-major order, summed in chunks of ``SMOOTH_CHUNK`` like the JAX
    # oracle's scan; within a chunk the weights add in sequence and the
    # weighted flows in XLA's CPU order (``chunk_sum21``).  Bit-equality
    # matters here: the next level truncates the smoothed flow.
    for c0 in range(0, len(offs), SMOOTH_CHUNK):
        prods = []
        part_w = torch.zeros_like(wsum)
        for k in range(c0, min(c0 + SMOOTH_CHUNK, len(offs))):
            dy, dx = offs[k]
            f = pflow[r + dy : r + dy + h, r + dx : r + dx + w]
            p = pimg[r + dy : r + dy + h, r + dx : r + dx + w]
            known = (f[..., 0] <= UNKNOWN_FLOW_THRESH) & (
                f[..., 1] <= UNKNOWN_FLOW_THRESH
            )
            d = (p - img).abs()
            dr = torch.maximum(torch.maximum(d[..., 0], d[..., 1]), d[..., 2])
            wgt = ftz(exp_cephes(-(dr * dr) * inv32(sig_r2)) * float(gws[k])) * (
                known.to(torch.float32))
            prods.append(torch.where(known[..., None], wgt[..., None] * f, 0.0))
            part_w = part_w + wgt
        fsum = fsum + chunk_sum21(prods)
        wsum = wsum + part_w
    out = fsum / wsum.clamp_min(1e-30)[..., None]
    return torch.where((wsum > 0)[..., None], out, flow)


def blf_refine_flow(flow, pack1, pack2, cost_cfg: CostConfig,
                    tap_chunk: int = TAP_CHUNK,
                    origin: Tuple[int, int] = (0, 0), pack1_halo: int = 0):
    """3x3 re-search with the gathered plane-fitting cost around
    trunc(flow) (d_bilateral_refine_flow_planefitting,
    bao_pmflow_kernel.cu:2005-2041; ``eppm_tpu/ops/refine.py::
    blf_refine_flow``).  Candidates whose target leaves frame 2 are
    skipped; the centre starts at the sentinel cost 999999 (:2020-2023)
    and a candidate wins on a strictly lower cost; unknown flow resets to
    0.  The costs sum their taps in partial sums of ``tap_chunk``.

    ``flow`` may be a tile whose top-left pixel sits at the global
    position ``origin``; ``pack1`` is then the matching tile of frame 1
    with ``pack1_halo`` rows and columns of context on each side, and
    ``pack2`` the whole frame 2."""
    h, w = flow.shape[:2]
    h2, w2 = pack2.shape[0], pack2.shape[1]
    ys, xs = grid(h, w, flow.device)
    ys, xs = ys + origin[0], xs + origin[1]
    u, v = flow[..., 0], flow[..., 1]
    unknown = (u > UNKNOWN_FLOW_THRESH) | (v > UNKNOWN_FLOW_THRESH)
    cx = trunc_i32(torch.where(unknown, 0.0, u)) + xs
    cy = trunc_i32(torch.where(unknown, 0.0, v)) + ys
    best_cost = torch.full((h, w), 999999.0, dtype=torch.float32,
                           device=flow.device)
    best_tx, best_ty = cx, cy
    for m in (-1, 0, 1):
        for n in (-1, 0, 1):
            # the reference's loop order: m steps x, n steps y
            tx, ty = cx + m, cy + n
            inb = (tx >= 0) & (tx < w2) & (ty >= 0) & (ty < h2)
            tx, ty = tx.clamp(0, w2 - 1), ty.clamp(0, h2 - 1)
            cost = patch_cost_planefitting(pack1, pack2, tx, ty, cost_cfg,
                                           tap_chunk, pack1_halo)
            better = torch.where(inb, cost, FLT_MAX) < best_cost
            best_cost = torch.where(better, cost, best_cost)
            best_tx = torch.where(better, tx, best_tx)
            best_ty = torch.where(better, ty, best_ty)
    out = torch.stack([(best_tx - xs).to(torch.float32),
                       (best_ty - ys).to(torch.float32)], dim=-1)
    return torch.where(unknown[..., None], 0.0, out)


def median_filter(img, radius: int = 2):
    """Channel-wise (2r+1)^2 median with edge-clamped taps
    (d_median_filtering, refine_kernel.cu:921-974)."""
    h, w = img.shape[0], img.shape[1]
    p = pad_edge(img, radius, radius)
    taps = torch.stack([p[radius + dy : radius + dy + h,
                          radius + dx : radius + dx + w]
                        for dy in range(-radius, radius + 1)
                        for dx in range(-radius, radius + 1)])
    return taps.sort(dim=0).values[taps.shape[0] // 2]


def guide_image_smoothing(img, cfg: RefineConfig = RefineConfig(),
                          median_radius: int = 2):
    """Guide-image pre-smoothing (baoCudaImageSmoothing,
    refine_kernel.cu:915-1054): a 5x5 channel-wise median, then a
    bilateral filter of the median's output guided by itself (the
    reference averages the original image, discarding the median: the
    JAX package composes the two as evidently intended, and so does
    this).  Taps outside the image are skipped; the sums run in chunks of
    ``SMOOTH_CHUNK`` taps in ``flow_smoothing``'s order."""
    med = median_filter(img, median_radius)
    h, w = img.shape[0], img.shape[1]
    r = cfg.blf_radius
    inv_sig_r2 = inv32(cfg.blf_sigma_range**2)
    pimg = pad_edge(med, r, r)
    inside = _pad_const(torch.ones((h, w), dtype=torch.float32,
                                   device=img.device), r, 0.0)
    gws = smoothing_weights(cfg)
    offs = [(dy, dx) for dy in range(-r, r + 1) for dx in range(-r, r + 1)]
    psum = torch.zeros((h, w, 3), dtype=torch.float32, device=img.device)
    wsum = torch.zeros((h, w), dtype=torch.float32, device=img.device)
    for c0 in range(0, len(offs), SMOOTH_CHUNK):
        prods = []
        part_w = torch.zeros_like(wsum)
        for k in range(c0, min(c0 + SMOOTH_CHUNK, len(offs))):
            dy, dx = offs[k]
            p = pimg[r + dy : r + dy + h, r + dx : r + dx + w]
            v = inside[r + dy : r + dy + h, r + dx : r + dx + w]
            d = (p - med).abs()
            dr = torch.maximum(torch.maximum(d[..., 0], d[..., 1]), d[..., 2])
            wgt = ftz(exp_cephes(-(dr * dr) * inv_sig_r2) * float(gws[k])) * v
            prods.append(wgt[..., None] * p)
            part_w = part_w + wgt
        psum = psum + chunk_sum21(prods)
        wsum = wsum + part_w
    return psum / wsum.clamp_min(1e-30)[..., None]


def flow_cutoff(flow, max_val: float):
    """Clamp to +-max_val (refine_kernel.cu:891-912)."""
    return flow.clamp(-max_val, max_val)


def eliminate_still_region(flow, img1, img2,
                           cost_cfg: CostConfig = CostConfig(),
                           min_cost: float = 0.1):
    """Zero the flow where the identity displacement already matches well
    (baoEliminateStillRegionFlow, bao_pmflow_kernel.cu:2072-2095)."""
    h, w = flow.shape[:2]
    ys, xs = grid(h, w, flow.device)
    cost = patch_cost_ad_l2(img1, img2, xs, ys, cost_cfg)
    still = cost <= f32(min_cost)
    return torch.where(still[..., None], 0.0, flow)
