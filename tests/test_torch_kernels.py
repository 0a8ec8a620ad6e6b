"""The port's CUDA kernels (A: residual cost, with its plane mode; B: flow
smoothing; C: weighted median; D: global descriptor argmax; E: PatchMatch's
gathered cost and fold; F: the dense matcher's exact stage) and their
dispatch.

Tests marked ``gpu`` build the kernels with nvcc and run them against
their plain PyTorch versions on the card (run them on a GPU host, which
has no jax, with ``python -m pytest --noconftest
tests/test_torch_kernels.py``); without a CUDA device they skip.  The others run anywhere: the dispatchers take the plain
version only for CPU tensors, a kernel wrapper given anything else
raises, and the main path hands each kernel arguments it accepts."""

import collections
import dataclasses

import numpy as np
import pytest
import torch

from eppm_tpu_torch import pipeline
from eppm_tpu_torch.config import DEFAULT_CONFIG as CFG
from eppm_tpu_torch.config import (FLT_MAX, INVALID_LOCATION, PLANES_CONFIG,
                                   UNKNOWN_FLOW, UPSTREAM_CONFIG, RefineConfig)
from eppm_tpu_torch.ops import _build, cuda_cost, cuda_exact, cuda_match
from eppm_tpu_torch.ops import cuda_patchmatch, cuda_smooth, cuda_wmf, match
from eppm_tpu_torch.ops import occlusion
from eppm_tpu_torch.ops import patchmatch as pm
from eppm_tpu_torch.ops._util import grid
from eppm_tpu_torch.ops.census import census_transform
from eppm_tpu_torch.ops.cost import (ad_census, census_lut, cost_constants,
                                     make_patch_stack, pack_frame,
                                     patch_cost_stack, plane_offsets,
                                     quantize_cost)
from eppm_tpu_torch.ops.dense import center_out_offsets
from eppm_tpu_torch.ops.refine import fill_holes
from eppm_tpu_torch.testing import dark_rows
from test_torch_argmax_plan import texture_rows

# The suite runs several test processes per host: one torch thread each
# keeps them from oversubscribing the cores.
torch.set_num_threads(1)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels build and run only on "
                    "the GPU host (chip_smoke.py runs the same checks)")
    return torch.device("cuda", 0)


def _packs(h, w, seed=0, device="cpu"):
    rng = np.random.default_rng(seed)
    img1 = rng.random((h, w, 3)).astype(np.float32)
    img2 = np.roll(img1, (1, -2), (0, 1)) * np.float32(0.9)
    out = []
    for img in (img1, img2):
        t = torch.from_numpy(img).to(device)
        out.append((t, pack_frame(t, census_transform(t))))
    return out


def _wmf_inputs(h, w, seed=0, device="cpu"):
    rng = np.random.default_rng(seed)
    ys, xs = np.mgrid[0:h, 0:w]
    tx = (xs + 2 + rng.integers(-1, 2, (h, w))).astype(np.int32)
    ty = (ys - 1 + rng.integers(-1, 2, (h, w))).astype(np.int32)
    holes = rng.random((h, w)) < 0.2
    holes[h // 3 : h // 2, w // 3 : w // 2] = True
    tx[holes] = INVALID_LOCATION
    ty[holes] = INVALID_LOCATION
    img = rng.random((h, w, 3)).astype(np.float32)
    return (torch.from_numpy(tx).to(device), torch.from_numpy(ty).to(device),
            torch.from_numpy(img).to(device))


def _descriptors(n1, n2, d=275, seed=0, device="cpu"):
    """(N1, D), (N2, D) bf16 rows; D = 275 as at the defaults (not a
    multiple of 8)."""
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.normal(0, 0.3, (n, d)).astype(np.float32))
            .to(torch.bfloat16).to(device) for n in (n1, n2)]


# the kernels that the default path launches
DEFAULT_PATH = (cuda_cost.TERMS, cuda_cost.SINGLE, cuda_cost.MULTIWARP,
                cuda_smooth.PAIRED, cuda_wmf.KERNEL)


def _counts(kernels=DEFAULT_PATH + (cuda_cost.PLANES, cuda_match.KERNEL,
                                    cuda_smooth.KERNEL,
                                    cuda_patchmatch.KERNEL,
                                    cuda_exact.KERNEL)):
    return tuple(k.launches for k in kernels)


# the exact stage's cost: the default taps at the exact stage's stride
EXACT_CFG = dataclasses.replace(CFG.cost,
                                patch_stride=CFG.match.exact_tap_stride)
EXACT_RULES = [(1, "score"), (1, "strict"), (1, "equal"), (4, "strict"),
               (4, "equal"), (8, "strict"), (8, "equal")]


def _old_exact_stage(pack1, pack2, exact_cfg, h, w):
    """The exact stage's two closures as ``ops/match.py::
    _polish_direction`` held them before kernel F, verbatim (with their
    setup): the oracle of ``exact_best_of``."""
    ys, xs = grid(h, w, pack1.device)
    h2, w2 = pack2.shape[0], pack2.shape[1]
    offs2 = exact_cfg.tap_offsets
    stack2 = make_patch_stack(pack2, offs2, dtype=torch.bfloat16)

    def exact_multi(cgxs, cgys, mask_oob=True):
        """Exact quantized cost of K offset fields (K, H, W)."""
        ctxs = xs[None] + cgxs
        ctys = ys[None] + cgys
        ck = quantize_cost(
            patch_cost_stack(pack1, stack2, ctxs, ctys, exact_cfg, offs2))
        if mask_oob:
            inb = (ctxs >= 0) & (ctxs < w2) & (ctys >= 0) & (ctys < h2)
            ck = torch.where(inb, ck, FLT_MAX)
        return ck

    def best_of(cgxs, cgys, cur, strict=True):
        """First per-pixel minimum over K candidate fields, accepted
        against the incumbent (strictly, or at equality)."""
        gx0, gy0, cost0 = cur
        ck = exact_multi(cgxs, cgys)
        i1 = torch.argmin(ck, dim=0)[None]
        cbest = torch.gather(ck, 0, i1)[0]
        cgx = torch.gather(cgxs, 0, i1)[0]
        cgy = torch.gather(cgys, 0, i1)[0]
        win = (cbest < cost0) if strict else (cbest <= cost0)
        return (torch.where(win, cgx, gx0), torch.where(win, cgy, gy0),
                torch.where(win, cbest, cost0))

    return exact_multi, best_of


# frame 2 repeats every EXACT_PERIOD columns, so targets that far apart
# cost alike away from its borders: ties between candidates, and between
# a candidate and the incumbent
EXACT_PERIOD = 8


def _exact_case(k, h, w, h2, w2, seed, device="cpu"):
    """Packs and fields for kernel F: frame 1 (h, w) random, frame 2 (h2,
    w2) random rows repeating every ``EXACT_PERIOD`` columns; an
    incumbent offset field near (2, -1) and its unmasked cost; K candidate
    fields around it, with (row 0) targets at frame 2's clamped edges and
    just past them, (row 1) candidate 0 tying with the incumbent a period
    to its right, (row 2) the incumbent far left and every candidate
    farther left (all masked), the incumbent's cost FLT_MAX on its first
    columns, (row 3) offsets near the int32 ends whose targets wrap, and
    on every third column candidate 1 a period right of candidate 0."""
    rng = np.random.default_rng(seed)
    img1 = rng.random((h, w, 3)).astype(np.float32)
    img2 = np.tile(rng.random((h2, EXACT_PERIOD, 3)).astype(np.float32),
                   (1, -(-w2 // EXACT_PERIOD), 1))[:, :w2]
    p1, p2 = (pack_frame(t, census_transform(t)).to(device).contiguous()
              for t in (torch.from_numpy(img1),
                        torch.from_numpy(np.ascontiguousarray(img2))))
    xs = np.arange(w)[None, :]
    gx0 = (2 + rng.integers(-2, 3, (h, w))).astype(np.int64)
    gy0 = (-1 + rng.integers(-2, 3, (h, w))).astype(np.int64)
    cgx = gx0[None] + rng.integers(-3, 4, (k, h, w))
    cgy = gy0[None] + rng.integers(-2, 3, (k, h, w))
    cgx[:, 0, :] = (np.array([w2 - 1, w2, 0, -1] * w)[:w][None] - xs
                    + np.arange(k)[:, None] % 2)
    cgx[0, 1], cgy[0, 1] = gx0[1] + EXACT_PERIOD, gy0[1]
    gx0[2] = -1000
    cgx[:, 2] = -1000 * (np.arange(k) + 2)[:, None]
    cgx[:, 3, ::2] = 2**31 - 2 - np.arange(k)[:, None]
    cgx[:, 3, 1::2] = -(2**31) + np.arange(k)[:, None]
    if k >= 2:
        cgx[1, :, ::3], cgy[1, :, ::3] = (cgx[0, :, ::3] + EXACT_PERIOD,
                                          cgy[0, :, ::3])
    gx0, gy0, cgx, cgy = (torch.from_numpy(a.astype(np.int32)).to(device)
                          .contiguous() for a in (gx0, gy0, cgx, cgy))
    exact_multi, _ = _old_exact_stage(p1, p2, EXACT_CFG, h, w)
    cost0 = exact_multi(gx0[None], gy0[None], mask_oob=False)[0]
    cost0[2, :4] = FLT_MAX
    return p1, p2, (gx0, gy0, cost0), cgx, cgy


def _old_photometric_arbitrate(
    tx, ty, ftx, fty, cands, packs, cost_cfg, thresh: float, orig,
):
    """``ops/occlusion.py::_photometric_arbitrate`` as it was before kernel
    F's arbitration rule, verbatim: the oracle of ``arbitrate_holes``."""
    p1, p2 = packs
    h, w = tx.shape
    h2, w2 = p2.shape[0], p2.shape[1]
    ys, xs = grid(h, w, tx.device)

    fields = []
    for found, gox, goy in cands:
        ctx = xs + torch.round(gox).to(torch.int32)
        cty = ys + torch.round(goy).to(torch.int32)
        fields.append((found, ctx, cty))
    if orig is not None:
        otx, oty = orig
        agree = torch.zeros((h, w), dtype=torch.bool, device=tx.device)
        for found, ctx, cty in fields:
            d = torch.maximum((ctx - otx).abs(), (cty - oty).abs())
            agree = agree | (found & (d <= 2))
        fields.append((agree, otx, oty))

    txs = torch.stack([f[1] for f in fields])
    tys = torch.stack([f[2] for f in fields])
    offs = cost_cfg.tap_offsets
    stack2 = make_patch_stack(p2, offs)
    costs = patch_cost_stack(p1, stack2, txs, tys, cost_cfg, offs)
    masked = []
    for k, (found, ctx, cty) in enumerate(fields):
        inb = (ctx >= 0) & (ctx < w2) & (cty >= 0) & (cty < h2)
        masked.append(torch.where(found & inb, costs[k], FLT_MAX))
    costs = torch.stack(masked)
    cmin = costs.min(dim=0).values
    kbest = torch.argmin(costs, dim=0)  # first minimum
    btx = torch.gather(txs, 0, kbest[None])[0]
    bty = torch.gather(tys, 0, kbest[None])[0]

    hole = (tx < 0) | (ty < 0)
    use = hole & (cmin < thresh)
    return torch.where(use, btx, ftx), torch.where(use, bty, fty)


# the arbitration's cases: K = 5 (the 4 directions and the pre-LR match),
# K = 4 (no pre-LR match), an all-hole field, and a threshold equal to a
# hole's least cost
ARB_CASES = ["K=5", "K=4", "all holes", "cost at the threshold"]


def _arbitration_costs(p1, p2, cgxs, cgys, masks, cost_cfg):
    """The arbitration's masked costs (K, H, W), as the oracle makes
    them."""
    h, w = cgxs.shape[1:]
    ys, xs = grid(h, w, p1.device)
    txs, tys = xs[None] + cgxs, ys[None] + cgys
    offs = cost_cfg.tap_offsets
    costs = patch_cost_stack(p1, make_patch_stack(p2, offs), txs, tys,
                             cost_cfg, offs)
    inb = (txs >= 0) & (txs < p2.shape[1]) & (tys >= 0) & (tys < p2.shape[0])
    return torch.where(masks & inb, costs, FLT_MAX)


def _arbitration_case(case, h, w, seed, device="cpu"):
    """The photometric arbitration's inputs at one level: frame 2 frame 1
    shifted by (-2, 1) and darkened; pre-LR matches near that shift; holes
    (a fifth of the pixels and a block; every pixel for "all holes"); the
    fill and its 4 directional candidates from ``fill_holes``, then
    direction 0 not found on a third of the pixels, direction 1's offsets
    pushed past frame 2's left edge on every fourth row and direction 2's
    moved by half a pixel (ties that rounding to even decides).  Returns
    the arguments of ``_photometric_arbitrate`` and the threshold: the
    default, or for "cost at the threshold" the least cost of the hole
    whose least cost is the median of the holes' finite ones (the pixel
    keeps the fill), and that pixel."""
    rng = np.random.default_rng(seed)
    img1 = rng.random((h, w, 3)).astype(np.float32)
    img2 = np.roll(img1, (1, -2), (0, 1)) * np.float32(0.9)
    p1, p2 = (pack_frame(t, census_transform(t)).contiguous()
              for t in (torch.from_numpy(img1), torch.from_numpy(img2)))
    ys, xs = np.mgrid[0:h, 0:w]
    otx = (xs - 2 + rng.integers(-1, 2, (h, w))).astype(np.int32)
    oty = (ys + 1 + rng.integers(-1, 2, (h, w))).astype(np.int32)
    holes = rng.random((h, w)) < 0.2
    holes[h // 3 : h // 2, w // 4 : w // 2] = True
    if case == "all holes":
        holes[:] = True
    tx = torch.from_numpy(np.where(holes, INVALID_LOCATION, otx)
                          .astype(np.int32))
    ty = torch.from_numpy(np.where(holes, INVALID_LOCATION, oty)
                          .astype(np.int32))
    img = torch.from_numpy(img1)
    ftx, fty, cands = fill_holes(tx, ty, img, return_candidates=True)
    lost = torch.from_numpy(rng.random((h, w)) < 0.33)
    cands[0] = (cands[0][0] & ~lost, cands[0][1], cands[0][2])
    left = torch.zeros((h, w), dtype=torch.bool)
    left[::4] = True
    cands[1] = (cands[1][0], torch.where(left, cands[1][1] - w, cands[1][1]),
                cands[1][2])
    cands[2] = (cands[2][0], cands[2][1] + 0.5, cands[2][2] - 0.5)
    orig = (torch.from_numpy(otx), torch.from_numpy(oty))
    if case == "K=4":
        orig = None
    thresh, at = CFG.refine.fill_photometric_thresh, None
    if case == "cost at the threshold":
        cgxs, cgys, masks = occlusion.arbitration_candidates(tx, cands, orig)
        cmin = _arbitration_costs(p1, p2, cgxs, cgys, masks,
                                  CFG.cost).min(dim=0).values
        finite = torch.from_numpy(holes) & (cmin < FLT_MAX)
        vals = cmin[finite].sort().values
        mid = vals[len(vals) // 2]
        at = tuple(int(v) for v in ((cmin == mid) & finite).nonzero()[0])
        thresh = float(mid)
    dev = torch.device(device)
    args = (tx.to(dev), ty.to(dev), ftx.to(dev), fty.to(dev),
            [tuple(t.to(dev) for t in c) for c in cands],
            (p1.to(dev), p2.to(dev)), CFG.cost, thresh,
            None if orig is None else tuple(t.to(dev) for t in orig))
    return args, at


# --- anywhere -------------------------------------------------------------


def test_kernel_wrappers_refuse_cpu_tensors():
    (img, p1), (_, p2) = _packs(8, 12)
    flow = torch.zeros((8, 12, 2))
    tx, ty, wimg = _wmf_inputs(8, 12)
    d1, d2 = _descriptors(5, 7)
    r = max(max(abs(v) for v in t) for t in CFG.cost.tap_offsets)
    terms = torch.zeros((1, 8 + 2 * r, 12 + 2 * r))
    cost = torch.zeros((8, 12))
    calls = [
        lambda: cuda_cost.residual_costs_cuda(p1, p2, [(0, 0)], CFG.cost),
        lambda: cuda_cost.residual_costs_planes_cuda(p1, p2, [(0, 0)],
                                                     CFG.cost),
        lambda: cuda_match.global_argmax_cuda(d1, d2),
        lambda: cuda_cost.residual_costs_multiwarp_cuda(p1, p2[None],
                                                        CFG.cost),
        lambda: cuda_cost.cost_terms_cuda(p1, p2, [(0, 0, 0)], CFG.cost,
                                          [CFG.cost.tap_offsets]),
        lambda: cuda_cost.cost_sums_cuda(cuda_cost.SINGLE, p1, p2, terms,
                                         [(0, 0, 0)], CFG.cost,
                                         [CFG.cost.tap_offsets]),
        lambda: cuda_smooth.flow_smoothing_cuda(flow, img, CFG.refine),
        lambda: cuda_wmf.weighted_median_filter_cuda(tx, ty, wimg,
                                                     CFG.refine),
        lambda: cuda_patchmatch.patch_cost_tables_cuda(
            p1, p2, tx, ty, CFG.cost, [CFG.cost.tap_offsets]),
        lambda: cuda_patchmatch.select_candidates_cuda(
            p1, p2, tx, ty, cost, tx[None], ty[None], CFG.cost,
            [CFG.cost.tap_offsets]),
        lambda: cuda_patchmatch.propagate_candidates_cuda(
            p1, p2, tx, ty, cost, 1, CFG.cost, [CFG.cost.tap_offsets]),
        lambda: cuda_exact.exact_best_of_cuda(p1, p2, tx[None], ty[None],
                                              None, EXACT_CFG),
        lambda: cuda_exact.exact_best_of_cuda(p1, p2, tx[None], ty[None],
                                              (tx, ty, cost), EXACT_CFG),
        lambda: cuda_exact.arbitrate_holes_cuda(
            p1, p2, tx[None], ty[None], (tx >= 0)[None], (tx, ty), (tx, ty),
            CFG.cost, 0.6),
    ]
    before = _counts()
    for call in calls:
        with pytest.raises(ValueError, match="CUDA"):
            call()
    assert _counts() == before


def test_dispatchers_take_plain_versions_on_cpu_only():
    (img, p1), (_, p2) = _packs(8, 12)
    flow = torch.zeros((8, 12, 2))
    tx, ty, wimg = _wmf_inputs(8, 12)
    d1, d2 = _descriptors(5, 7)
    before = _counts()
    cuda_cost.residual_costs_auto(p1, p2, [(0, 0)], CFG.cost)
    cuda_cost.residual_costs_auto(p1, p2, [(0, 0)], CFG.cost, use_planes=True)
    cuda_match.global_argmax_auto(d1, d2)
    cuda_cost.residual_costs_multiwarp_auto(p1, p2[None], CFG.cost)
    cuda_smooth.flow_smoothing_auto(flow, img, CFG.refine)
    cuda_wmf.weighted_median_filter_auto(tx, ty, wimg, CFG.refine)
    tables = [CFG.cost.tap_offsets]
    cost = cuda_patchmatch.patch_cost_tables_auto(p1, p2, tx, ty, CFG.cost,
                                                  tables)
    assert torch.equal(cost, cuda_patchmatch.patch_cost_tables(
        p1, p2, tx, ty, CFG.cost, tables))
    txs, tys = torch.stack([tx, tx + 1]), torch.stack([ty - 1, ty])
    for got, want in (
            (cuda_patchmatch.select_candidates_auto(
                p1, p2, tx, ty, cost, txs, tys, CFG.cost, tables),
             pm.select_candidates(p1, p2, tx, ty, cost, txs, tys, CFG.cost,
                                  tables)),
            (cuda_patchmatch.propagate_candidates_auto(
                p1, p2, tx, ty, cost, 2, CFG.cost, tables),
             pm.propagate_candidates(p1, p2, tx, ty, cost, 2, CFG.cost,
                                     tables))):
        assert all(torch.equal(g, w) for g, w in zip(got, want))
    cur = (tx, ty, cost)
    for strict in (True, False):
        got = cuda_exact.exact_best_of_auto(p1, p2, txs, tys, cur, EXACT_CFG,
                                            strict)
        want = match.exact_best_of(p1, p2, txs, tys, cur, EXACT_CFG, strict)
        assert all(torch.equal(g, w) for g, w in zip(got, want))
    fill = (tx.abs(), ty.abs())
    got = cuda_exact.arbitrate_holes_auto(p1, p2, txs, tys, txs >= 0,
                                          (tx, ty), fill, CFG.cost, 0.6)
    want = occlusion.arbitrate_holes(p1, p2, txs, tys, txs >= 0, (tx, ty),
                                     fill, CFG.cost, 0.6)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert _counts() == before
    meta = torch.empty((8, 12, 4), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        cuda_cost.residual_costs_auto(meta, meta, [(0, 0)], CFG.cost)
    with pytest.raises(ValueError, match="unsupported device"):
        cuda_smooth.flow_smoothing_auto(meta[..., :2], meta[..., :3],
                                        CFG.refine)
    with pytest.raises(ValueError, match="unsupported device"):
        cuda_match.global_argmax_auto(meta[0].bfloat16(), meta[0].bfloat16())
    with pytest.raises(ValueError, match="unsupported device"):
        cuda_patchmatch.patch_cost_tables_auto(meta, meta, tx, ty, CFG.cost,
                                               tables)
    with pytest.raises(ValueError, match="unsupported device"):
        cuda_exact.exact_best_of_auto(meta, meta, tx[None], ty[None], None,
                                      EXACT_CFG)
    with pytest.raises(ValueError, match="unsupported device"):
        cuda_exact.arbitrate_holes_auto(meta, meta, tx[None], ty[None],
                                        (tx >= 0)[None], (tx, ty), (tx, ty),
                                        CFG.cost, 0.6)


@pytest.mark.parametrize("k,rule", EXACT_RULES)
@pytest.mark.parametrize("frame2", [(20, 28), (17, 40)])
def test_exact_best_of_is_the_old_exact_stage(k, rule, frame2):
    """``exact_best_of_auto`` on CPU tensors returns exactly what the
    exact stage's closures returned before kernel F: the incumbent's
    unmasked score, or the first least of K candidate fields accepted
    strictly or at equality, with targets at and past frame 2's clamped
    edges, far outside it and wrapping past the int32 ends, ties between
    candidates and with the incumbent, and a frame 2 of another size."""
    h, w = 20, 28
    p1, p2, cur, cgx, cgy = _exact_case(k, h, w, *frame2, seed=k + 7)
    exact_multi, best_of = _old_exact_stage(p1, p2, EXACT_CFG, h, w)
    if rule == "score":
        got = cuda_exact.exact_best_of_auto(p1, p2, cur[0][None],
                                            cur[1][None], None, EXACT_CFG)
        want = (cur[0], cur[1],
                exact_multi(cur[0][None], cur[1][None], mask_oob=False)[0])
    else:
        strict = rule == "strict"
        got = cuda_exact.exact_best_of_auto(p1, p2, cgx, cgy, cur,
                                            EXACT_CFG, strict)
        want = best_of(cgx, cgy, cur, strict)
        # the case holds what it is meant to: ties the rule decides
        other = best_of(cgx, cgy, cur, not strict)
        assert not torch.equal(want[0], other[0])
        ck = exact_multi(cgx, cgy)
        if k >= 2:
            assert bool(((ck[0] == ck[1]) & (cgx[0] != cgx[1])
                         & (ck[0] < FLT_MAX)).any())
        assert bool((ck == FLT_MAX).any()) and bool((ck < FLT_MAX).any())
    assert all(torch.equal(g, v) for g, v in zip(got, want))


@pytest.mark.parametrize("case", ARB_CASES)
@pytest.mark.parametrize("hw", [(20, 28), (17, 40)])
def test_arbitration_is_the_old_photometric_arbitrate(case, hw):
    """``_photometric_arbitrate`` on CPU tensors (the candidate fields,
    then ``arbitrate_holes_auto``'s plain version) returns exactly what it
    returned before kernel F's arbitration rule: K = 5 and K = 4,
    candidates not found, targets outside frame 2, rounding ties, an
    all-hole field, and a hole whose least cost equals the threshold,
    which keeps the fill."""
    h, w = hw
    args, at = _arbitration_case(case, h, w, seed=sum(hw) + len(case))
    tx, ty, ftx, fty, cands, packs, cost_cfg, thresh, orig = args
    before = cuda_exact.KERNEL.launches
    got = occlusion._photometric_arbitrate(*args)
    assert cuda_exact.KERNEL.launches == before
    want = _old_photometric_arbitrate(*args)
    assert all(torch.equal(g, v) for g, v in zip(got, want))
    # the case holds what it is meant to
    cgxs, cgys, masks = occlusion.arbitration_candidates(tx, cands, orig)
    assert cgxs.shape[0] == (4 if case == "K=4" else 5)
    hole = (tx < 0) | (ty < 0)
    took = hole & ((got[0] != ftx) | (got[1] != fty))
    if case == "all holes":
        assert bool(hole.all()) and not bool(masks.any())
        assert not bool(took.any())
        return
    costs = _arbitration_costs(*packs, cgxs, cgys, masks, cost_cfg)
    unmasked = _arbitration_costs(*packs, cgxs, cgys,
                                  torch.ones_like(masks), cost_cfg)
    # a candidate not found that would have won, and a target outside
    # frame 2 whose flag is set
    assert bool((hole & ~masks[0] & (unmasked[0] < thresh)).any())
    ys, xs = grid(h, w, tx.device)
    outside = (xs[None] + cgxs < 0)[1] & masks[1]
    assert bool(outside.any()) and bool((costs[1][outside] == FLT_MAX).all())
    assert bool(took.any())
    if at is not None:
        k = int(torch.argmin(costs[:, at[0], at[1]]))
        assert float(costs[k, at[0], at[1]]) == thresh
        assert (int(got[0][at]), int(got[1][at])) == (int(ftx[at]),
                                                        int(fty[at]))
        assert (int(xs[at] + cgxs[k][at]), int(ys[at] + cgys[k][at])) != (
            int(ftx[at]), int(fty[at]))


def test_census_lut_gives_ad_census_bits():
    """Kernels E and F look the census term up in ``census_lut``: for
    every pair of 8-bit signatures on taps of one colour (so c_ad is
    exactly 0), ``ad_census`` equals the table's entry for their XOR."""
    inv_lam_ad2, inv_lam_cen2, _ = cost_constants(EXACT_CFG)
    a, b = torch.meshgrid(torch.arange(256), torch.arange(256),
                          indexing="ij")
    rgb = torch.full((256, 256, 3), 0.25)
    p1 = torch.cat([rgb, a[..., None].float()], dim=-1)
    p2 = torch.cat([rgb, b[..., None].float()], dim=-1)
    assert torch.equal(ad_census(p1, p2, inv_lam_ad2, inv_lam_cen2),
                       census_lut(inv_lam_cen2)[a ^ b])


def test_argument_checks_reject_what_the_kernels_do_not_take():
    (img, p1), (_, p2) = _packs(8, 12)
    cands = [(0, 0, 0)]
    cuda_cost.check_cost_args(p1, p2, 1, cands, CFG.cost)
    with pytest.raises(ValueError, match="float32"):
        cuda_cost.check_cost_args(p1.double(), p2, 1, cands, CFG.cost)
    with pytest.raises(ValueError, match="contiguous"):
        cuda_cost.check_cost_args(p1, p2.transpose(0, 1).contiguous()
                                  .transpose(0, 1), 1, cands, CFG.cost)
    with pytest.raises(ValueError, match="boundary"):
        flat = torch.zeros(8 * 12 * 4 + 1)
        cuda_cost.check_cost_args(p1, flat[1:].view(8, 12, 4), 1, cands,
                                  CFG.cost)
    with pytest.raises(ValueError, match="candidates"):
        cuda_cost.check_cost_args(p1, p2, 1, [(0, 0, 0)] * 129, CFG.cost)
    planes = cuda_cost.cost_tables(CFG.cost, True)
    cuda_cost.check_cost_args(p1, p2, 1, cands, CFG.cost, planes)
    with pytest.raises(ValueError, match="tables"):
        cuda_cost.check_cost_args(p1, p2, 1, cands, CFG.cost, planes * 2)
    with pytest.raises(ValueError, match="tables"):
        cuda_cost.check_cost_args(p1, p2, 1, cands, CFG.cost,
                                  [planes[1][:-1]])
    d1, d2 = _descriptors(5, 7)
    cuda_match.check_argmax_args(d1, d2)
    with pytest.raises(ValueError, match="bfloat16"):
        cuda_match.check_argmax_args(d1.float(), d2)
    with pytest.raises(ValueError, match="shape"):
        cuda_match.check_argmax_args(d1, d2[:, :-1])
    with pytest.raises(ValueError, match="features"):
        cuda_match.check_argmax_args(*_descriptors(2, 3, d=769))
    with pytest.raises(ValueError, match="shape"):
        cuda_smooth.check_smooth_args(torch.zeros((8, 12, 3)), img,
                                      CFG.refine)
    tx, ty, wimg = _wmf_inputs(8, 12)
    with pytest.raises(ValueError, match="int32"):
        cuda_wmf.check_wmf_args(tx.long(), ty, wimg, CFG.refine)
    # kernel E
    check = cuda_patchmatch.check_patchmatch_args
    tables = [CFG.cost.tap_offsets]
    cost = torch.zeros((8, 12))
    txs, tys = tx.repeat(4, 1, 1), ty.repeat(4, 1, 1)
    check(p1, p2, txs, tys, CFG.cost, tables)
    check(p1, p2, tx, ty, CFG.cost, tables, state=(tx, ty, cost))
    check(p1, p2, tx[2:-2, 2:-2].contiguous(), ty[2:-2, 2:-2].contiguous(),
          CFG.cost, tables, pack1_halo=2)
    check(p1, p2, txs, tys, CFG.cost, plane_offsets(CFG.cost))
    bad = [  # (match, arguments, keywords)
        ("int32", (p1, p2, txs.long(), tys), {}),
        ("float32", (p1.double(), p2, txs, tys), {}),
        ("float32", (p1, p2, tx, ty), dict(state=(tx, ty, cost.double()))),
        ("shape", (p1, p2, txs, tys[:2]), {}),
        ("shape", (p1, p2, tx, ty), dict(state=(tx, ty, cost[:4]))),
        ("shape", (p1, p2, tx[0], ty[0]), {}),
        ("contiguous", (p1, p2, txs.transpose(1, 2).contiguous()
                        .transpose(1, 2), tys), {}),
        ("contiguous", (p1.transpose(0, 1).contiguous().transpose(0, 1), p2,
                        txs, tys), {}),
        ("boundary", (p1, torch.zeros(8 * 12 * 4 + 1)[1:].view(8, 12, 4),
                      txs, tys), {}),
        ("candidates", (p1, p2, tx.repeat(33, 1, 1), ty.repeat(33, 1, 1)),
         {}),
        ("halo", (p1, p2, tx, ty), dict(pack1_halo=1)),
        ("chunk", (p1, p2, txs, tys), dict(tap_chunk=0)),
    ]
    for match_, args, kw in bad:
        with pytest.raises(ValueError, match=match_):
            check(*args, CFG.cost, tables, **kw)
    wide = dataclasses.replace(CFG.cost, patch_stride=1)   # 361 taps
    with pytest.raises(ValueError, match="taps"):
        check(p1, p2, txs, tys, wide, [wide.tap_offsets])
    far = dataclasses.replace(CFG.cost, patch_radius=33, patch_stride=11)
    with pytest.raises(ValueError, match="within"):
        check(p1, p2, txs, tys, far, [far.tap_offsets])
    for many in (tables * 5, [tables[0][:-1]]):
        with pytest.raises(ValueError, match="tables"):
            check(p1, p2, txs, tys, CFG.cost, many)


def _exact_bad_args(name):
    """Kernel F's arguments with one fault: (arguments, config, match)."""
    (_, p1), (_, p2) = _packs(8, 12)
    tx, ty, _ = _wmf_inputs(8, 12)
    cost = torch.zeros((8, 12))
    cgx, cgy = tx.repeat(4, 1, 1), ty.repeat(4, 1, 1)
    cur = (tx, ty, cost)
    wide = dataclasses.replace(EXACT_CFG, patch_stride=1)   # 361 taps
    far = dataclasses.replace(EXACT_CFG, patch_radius=33, patch_stride=11)
    return {
        "int64 offsets": ((p1, p2, cgx.long(), cgy, cur), EXACT_CFG, "int32"),
        "float64 pack": ((p1.double(), p2, cgx, cgy, cur), EXACT_CFG,
                         "float32"),
        "float64 cost": ((p1, p2, cgx, cgy, (tx, ty, cost.double())),
                         EXACT_CFG, "float32"),
        "(H, W) offsets": ((p1, p2, tx, ty, cur), EXACT_CFG,
                           r"\(K, H, W\)"),
        "offsets unlike": ((p1, p2, cgx, cgy[:2], cur), EXACT_CFG, "shape"),
        "incumbent's shape": ((p1, p2, cgx, cgy, (tx, ty, cost[:4])),
                              EXACT_CFG, "shape"),
        "frame 1's shape": ((p1[:6], p2, cgx, cgy, cur), EXACT_CFG, "shape"),
        "strided offsets": ((p1, p2, cgx.transpose(1, 2).contiguous()
                             .transpose(1, 2), cgy, cur), EXACT_CFG,
                            "contiguous"),
        "strided pack": ((p1, p2.transpose(0, 1).contiguous()
                          .transpose(0, 1), cgx, cgy, cur), EXACT_CFG,
                         "contiguous"),
        "misaligned pack": ((p1, torch.zeros(8 * 12 * 4 + 1)[1:]
                             .view(8, 12, 4), cgx, cgy, cur), EXACT_CFG,
                            "boundary"),
        "33 candidates": ((p1, p2, tx.repeat(33, 1, 1), ty.repeat(33, 1, 1),
                           cur), EXACT_CFG, "candidates"),
        "scoring 4 fields": ((p1, p2, cgx, cgy, None), EXACT_CFG,
                             "one field"),
        "361 taps": ((p1, p2, cgx, cgy, cur), wide, "taps"),
        "taps beyond the reach": ((p1, p2, cgx, cgy, cur), far, "within"),
    }[name]


@pytest.mark.parametrize("name", [
    "int64 offsets", "float64 pack", "float64 cost", "(H, W) offsets",
    "offsets unlike", "incumbent's shape", "frame 1's shape",
    "strided offsets", "strided pack", "misaligned pack", "33 candidates",
    "scoring 4 fields", "361 taps", "taps beyond the reach"])
def test_exact_args_checks_reject_what_kernel_f_does_not_take(name):
    """``check_exact_args`` passes the exact stage's arguments (one
    scored field; 8, 32 candidates against an incumbent) and refuses
    each fault: dtypes, shapes, contiguity, alignment, the candidate
    and tap limits."""
    (_, p1), (_, p2) = _packs(8, 12)
    tx, ty, _ = _wmf_inputs(8, 12)
    cur = (tx, ty, torch.zeros((8, 12)))
    check = cuda_exact.check_exact_args
    check(p1, p2, tx[None], ty[None], None, EXACT_CFG)
    for k in (8, 32):
        check(p1, p2, tx.repeat(k, 1, 1), ty.repeat(k, 1, 1), cur, EXACT_CFG)
    args, cfg, match_ = _exact_bad_args(name)
    with pytest.raises(ValueError, match=match_):
        check(*args, cfg)


def _arbitrate_bad_args(name):
    """Kernel F's arbitration arguments with one fault: (arguments,
    config, match)."""
    (_, p1), (_, p2) = _packs(8, 12)
    tx, ty, _ = _wmf_inputs(8, 12)
    cgx, cgy = tx.repeat(5, 1, 1), ty.repeat(5, 1, 1)
    masks = cgx >= 0
    cur = fill = (tx, ty)
    wide = dataclasses.replace(CFG.cost, patch_stride=1)    # 361 taps
    return {
        "uint8 flags": ((p1, p2, cgx, cgy, masks.to(torch.uint8), cur,
                         fill), CFG.cost, "bool"),
        "flags' shape": ((p1, p2, cgx, cgy, masks[:4], cur, fill),
                         CFG.cost, "shape"),
        "int64 targets": ((p1, p2, cgx, cgy, masks, (tx.long(), ty), fill),
                          CFG.cost, "int32"),
        "fill's shape": ((p1, p2, cgx, cgy, masks, cur, (tx[:4], ty)),
                         CFG.cost, "shape"),
        "float64 pack": ((p1.double(), p2, cgx, cgy, masks, cur, fill),
                         CFG.cost, "float32"),
        "(H, W) offsets": ((p1, p2, tx, ty, masks, cur, fill), CFG.cost,
                           r"\(K, H, W\)"),
        "33 candidates": ((p1, p2, tx.repeat(33, 1, 1), ty.repeat(33, 1, 1),
                           (tx >= 0).repeat(33, 1, 1), cur, fill), CFG.cost,
                          "candidates"),
        "361 taps": ((p1, p2, cgx, cgy, masks, cur, fill), wide, "taps"),
    }[name]


@pytest.mark.parametrize("name", [
    "uint8 flags", "flags' shape", "int64 targets", "fill's shape",
    "float64 pack", "(H, W) offsets", "33 candidates", "361 taps"])
def test_arbitrate_args_checks_reject_what_kernel_f_does_not_take(name):
    """``check_arbitrate_args`` passes the arbitration's arguments (K = 4
    and 5 at the default taps) and raises, naming the fault, on each
    argument the arbitration rule does not take."""
    check = cuda_exact.check_arbitrate_args
    (_, p1), (_, p2) = _packs(8, 12)
    tx, ty, _ = _wmf_inputs(8, 12)
    for k in (4, 5):
        check(p1, p2, tx.repeat(k, 1, 1), ty.repeat(k, 1, 1),
              (tx >= 0).repeat(k, 1, 1), (tx, ty), (tx, ty), CFG.cost)
    args, cfg, match_ = _arbitrate_bad_args(name)
    with pytest.raises(ValueError, match=match_):
        check(*args, cfg)


def test_main_path_hands_kernels_arguments_they_take(monkeypatch):
    """Run the slice on the CPU with each dispatcher wrapped in its
    kernel's argument check: every call the kernels would get passes."""
    seen = collections.Counter()

    def wrap(mod, name, check):
        orig = getattr(mod, name)

        def checked(*args, **kwargs):
            check(*args, **kwargs)
            seen[name] += 1
            return orig(*args, **kwargs)

        monkeypatch.setattr(mod, name, checked)

    def single(p1, w2, cands, cfg, use_planes=False, tap_chunk=25):
        cuda_cost.check_cost_args(p1, w2, 1, [(a, b, 0) for a, b in cands],
                                  cfg, cuda_cost.cost_tables(cfg, use_planes))
        assert tap_chunk == 25   # the default cost_tap_chunk

    def multi(p1, stack, cfg, tap_chunk=25):
        assert tap_chunk == 25
        k = stack.shape[0]
        cuda_cost.check_cost_args(p1, stack, k, [(0, 0, i) for i in range(k)],
                                  cfg)

    def wmf(tx, ty, img, cfg, num_iter=1, only_occlusion=False,
            polish_init=None, dilation=1):
        cuda_wmf.check_wmf_args(tx, ty, img, cfg, polish_init, dilation)

    for mod in (cuda_cost, match):
        wrap(mod, "residual_costs_auto", single)
    wrap(match, "residual_costs_multiwarp_auto", multi)
    wrap(pipeline, "flow_smoothing_auto", cuda_smooth.check_smooth_args)
    wrap(occlusion, "weighted_median_filter_auto", wmf)
    rng = np.random.default_rng(0)
    img1 = torch.from_numpy((rng.random((48, 64, 3)) * 255).astype(np.uint8))
    img2 = torch.roll(img1, (1, -2), (0, 1))
    flow = pipeline.compute_flow(img1, img2)
    assert tuple(flow.shape) == (48, 64, 2)
    assert set(seen) == {"residual_costs_auto", "residual_costs_multiwarp_auto",
                         "flow_smoothing_auto", "weighted_median_filter_auto"}


def test_patchmatch_path_hands_kernel_e_arguments_it_takes(monkeypatch):
    """The PatchMatch engine through ``compute_flow`` on the CPU with
    kernel E's dispatchers wrapped in its argument check: every call
    passes, 102 a pair (two directions of an init and 10 iterations of 4
    propagation rounds and a random search); the dense matcher's
    dispatchers are not called."""
    seen = collections.Counter()
    E = cuda_patchmatch

    def wrap(name, check):
        orig = getattr(E, name)

        def checked(*args, **kwargs):
            check(*args, **kwargs)
            seen[name] += 1
            return orig(*args, **kwargs)

        monkeypatch.setattr(E, name, checked)

    def costs(p1, p2, tx, ty, cfg, tables, pack1_halo=0, tap_chunk=25):
        E.check_patchmatch_args(p1, p2, tx, ty, cfg, tables, pack1_halo,
                                tap_chunk)

    def select(p1, p2, tx, ty, cost, txs, tys, cfg, tables, tap_chunk=25):
        assert txs.dim() == 3
        E.check_patchmatch_args(p1, p2, txs, tys, cfg, tables, 0, tap_chunk,
                                (tx, ty, cost))

    def propagate(p1, p2, tx, ty, cost, step, cfg, tables, tap_chunk=25):
        assert step >= 1
        E.check_patchmatch_args(p1, p2, tx, ty, cfg, tables, 0, tap_chunk,
                                (tx, ty, cost))

    wrap("patch_cost_tables_auto", costs)
    wrap("select_candidates_auto", select)
    wrap("propagate_candidates_auto", propagate)
    for mod in (cuda_cost, match):
        monkeypatch.setattr(mod, "residual_costs_multiwarp_auto",
                            lambda *a, **k: pytest.fail("dense matcher"))
    rng = np.random.default_rng(3)
    img1 = torch.from_numpy((rng.random((48, 64, 3)) * 255).astype(np.uint8))
    img2 = torch.roll(img1, (1, -2), (0, 1))
    cfg = dataclasses.replace(CFG, match_engine="patchmatch")
    assert tuple(pipeline.compute_flow(img1, img2, cfg).shape) == (48, 64, 2)
    iters = cfg.patchmatch.num_iters
    assert seen == {"patch_cost_tables_auto": 2,
                    "propagate_candidates_auto":
                        2 * iters * len(cfg.patchmatch.prop_steps),
                    "select_candidates_auto": 2 * iters}
    assert sum(seen.values()) == 102


@pytest.mark.parametrize("config,calls", [("default", 8), ("patchmatch", 0),
                                          ("upstream", 0)])
def test_dense_path_hands_kernel_f_arguments_it_takes(monkeypatch, config,
                                                      calls):
    """``compute_flow`` on the CPU with kernel F's dispatchers wrapped in
    their argument checks: under ``DEFAULT_CONFIG`` every call passes, 8
    of the exact stage a pair (each direction: the incumbent's score, the
    8-ring, one step-2 propagation round of 4, one median round at
    equality) and one of the arbitration (K = 5, the default taps and
    threshold); the PatchMatch engine calls the arbitration alone, and
    ``UPSTREAM_CONFIG`` (the legacy occlusion order) neither."""
    seen, arbitrated = [], []
    orig = cuda_exact.exact_best_of_auto
    orig_arb = cuda_exact.arbitrate_holes_auto

    def checked(p1, p2, cgxs, cgys, cur, cfg, strict=True):
        cuda_exact.check_exact_args(p1, p2, cgxs, cgys, cur, cfg)
        assert cfg == EXACT_CFG
        seen.append((cgxs.shape[0], cur is None, strict))
        return orig(p1, p2, cgxs, cgys, cur, cfg, strict)

    def checked_arb(p1, p2, cgxs, cgys, masks, cur, fill, cfg, thresh):
        cuda_exact.check_arbitrate_args(p1, p2, cgxs, cgys, masks, cur, fill,
                                        cfg)
        assert cfg == CFG.cost
        arbitrated.append((cgxs.shape[0], thresh))
        return orig_arb(p1, p2, cgxs, cgys, masks, cur, fill, cfg, thresh)

    monkeypatch.setattr(cuda_exact, "exact_best_of_auto", checked)
    monkeypatch.setattr(cuda_exact, "arbitrate_holes_auto", checked_arb)
    cfg = {"default": CFG,
           "patchmatch": dataclasses.replace(CFG, match_engine="patchmatch"),
           "upstream": UPSTREAM_CONFIG}[config]
    rng = np.random.default_rng(4)
    img1 = torch.from_numpy((rng.random((48, 64, 3)) * 255).astype(np.uint8))
    img2 = torch.roll(img1, (1, -2), (0, 1))
    assert tuple(pipeline.compute_flow(img1, img2, cfg).shape) == (48, 64, 2)
    assert len(seen) == calls
    if calls:
        assert seen == [(1, True, True), (8, False, True), (4, False, True),
                        (1, False, False)] * 2
    # the fill-first chain's arbitration: once a pair, but not in the
    # legacy occlusion order
    arbitrations = 0 if config == "upstream" else 1
    assert arbitrated == [(5, CFG.refine.fill_photometric_thresh)] * (
        arbitrations)


def test_plane_and_match_paths_hand_kernels_arguments_they_take(
        monkeypatch):
    """The plane-mode refine passes and the single-direction matcher on
    the CPU, with kernel A's and kernel D's dispatchers wrapped in their
    argument checks."""
    seen = collections.Counter()
    orig_cost = cuda_cost.residual_costs_auto
    orig_argmax = cuda_match.global_argmax_auto

    def cost(p1, w2, cands, cfg, use_planes=False, tap_chunk=25):
        cuda_cost.check_cost_args(p1, w2, 1, [(a, b, 0) for a, b in cands],
                                  cfg, cuda_cost.cost_tables(cfg, use_planes))
        seen["planes" if use_planes else "fronto"] += 1
        return orig_cost(p1, w2, cands, cfg, use_planes, tap_chunk)

    def argmax(d1, d2, block=2048):
        cuda_match.check_argmax_args(d1, d2)
        seen["argmax"] += 1
        return orig_argmax(d1, d2, block)

    for mod in (cuda_cost, match):
        monkeypatch.setattr(mod, "residual_costs_auto", cost)
    monkeypatch.setattr(cuda_match, "global_argmax_auto", argmax)
    rng = np.random.default_rng(1)
    img1 = torch.from_numpy((rng.random((48, 64, 3)) * 255).astype(np.uint8))
    img2 = torch.roll(img1, (1, -2), (0, 1))
    cfg = dataclasses.replace(CFG, dense_pass1_planes=True,
                              dense_pass2_planes=True)
    assert tuple(pipeline.compute_flow(img1, img2, cfg).shape) == (48, 64, 2)
    assert seen["planes"] > 0
    lv1, pk1 = pipeline.prepare_pyramids(img1, CFG)
    lv2, pk2 = pipeline.prepare_pyramids(img2, CFG)
    match.match_coarse(lv1[0], lv2[0], CFG.cost, CFG.match, pk1[0], pk2[0])
    assert seen["argmax"] == 2  # the tiny level and the coarse proposals


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.nvcc_path()
    assert _build.library_path().name.startswith("libeppm_kernels-")
    assert "--fmad=false" in _build.NVCC_FLAGS
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS


def test_build_compiles_each_source_and_raises_on_a_failed_one(
        monkeypatch, tmp_path):
    """One nvcc per source with the compile flags; a failed compile
    raises with its output, links nothing and leaves no library."""
    calls = tmp_path / "calls"
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(f'#!/bin/sh\necho "$@" >> {calls}\n'
                    'case "$*" in *match.cu*) echo "error: broken"; exit 1;; '
                    'esac\n')
    nvcc.chmod(0o755)
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="broken"):
        _build.build_library()
    lines = [c.split() for c in calls.read_text().splitlines()]
    srcs = sorted(p.name for p in _build.CSRC_DIR.glob("*.cu"))
    assert sorted(c[-1].rsplit("/", 1)[-1] for c in lines) == srcs
    assert all("-c" in c and "--fmad=false" in c for c in lines)
    assert not list((tmp_path / "build").rglob("*.so"))


# --- on the card ----------------------------------------------------------


@pytest.mark.gpu
@pytest.mark.parametrize("radius,cfg_name", [(0, "cost"), (1, "cost"),
                                             (1, "pass2"), (3, "cost")])
def test_kernel_a_matches_plain(cuda, radius, cfg_name):
    cfg = {"cost": CFG.cost, "pass2": CFG.pass2_cost}[cfg_name]
    (_, p1), (_, p2) = _packs(70, 90, device=cuda)
    cands = center_out_offsets(radius)
    n = cuda_cost.SINGLE.launches
    got = cuda_cost.residual_costs_auto(p1, p2, cands, cfg)
    assert cuda_cost.SINGLE.launches == n + 1
    want = cuda_cost.residual_costs(p1, p2, cands, cfg)
    assert torch.equal(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("chunk", [7, 49])
def test_kernel_a_tap_chunk_matches_plain(cuda, chunk):
    """``cost_tap_chunk`` reaches kernel A's partial sums in each mode:
    identical to the plain version at the same chunk."""
    (_, p1), (_, p2) = _packs(50, 70, device=cuda)
    cands = center_out_offsets(1)
    for planes in (False, True):
        got = cuda_cost.residual_costs_auto(p1, p2, cands, CFG.cost, planes,
                                            chunk)
        want = cuda_cost.residual_costs(p1, p2, cands, CFG.cost, planes,
                                        chunk)
        assert torch.equal(got, want)
    stack = torch.stack([torch.roll(p2, s, 1) for s in range(5)])
    got = cuda_cost.residual_costs_multiwarp_auto(p1, stack, CFG.cost, chunk)
    want = cuda_cost.residual_costs_multiwarp(p1, stack, CFG.cost, chunk)
    assert torch.equal(got, want)


@pytest.mark.gpu
def test_kernel_a_multiwarp_matches_plain(cuda):
    (_, p1), (_, p2) = _packs(50, 70, device=cuda)
    stack = torch.stack([torch.roll(p2, s, 1) for s in range(5)])
    n = cuda_cost.MULTIWARP.launches
    got = cuda_cost.residual_costs_multiwarp_auto(p1, stack, CFG.cost)
    assert cuda_cost.MULTIWARP.launches == n + 1
    want = cuda_cost.residual_costs_multiwarp(p1, stack, CFG.cost)
    assert torch.equal(got, want)


# Kernel A's costs lie on a grid of 2^-17 (``ops/dense.py``); the plane
# mode sums its fronto-parallel table in another of XLA's per-site forms
# than the fronto mode does, so its least over the tables may exceed the
# fronto mode's cost by one step of that grid where the two sums round
# to neighbouring steps (4 of the 31,500 costs below under ``pass2``).
GRID_STEP = 2.0 ** -17

PLANE_COSTS = {"cost": CFG.cost, "pass2": CFG.pass2_cost,
               "stride2": dataclasses.replace(CFG.cost, patch_stride=2)}


@pytest.mark.parametrize("cfg_name", ["cost", "pass2", "stride2"])
def test_plane_mode_is_within_a_grid_step_of_the_fronto_mode(cfg_name):
    """The plain version on the CPU: both modes' costs lie on the 2^-17
    grid, and the least over the 4 plane tables never exceeds the fronto
    mode's cost by more than one step of it."""
    cfg = PLANE_COSTS[cfg_name]
    (_, p1), (_, p2) = _packs(50, 70)
    cands = center_out_offsets(1)
    got = cuda_cost.residual_costs(p1, p2, cands, cfg, use_planes=True)
    fronto = cuda_cost.residual_costs(p1, p2, cands, cfg)
    for c in (got, fronto):
        assert torch.equal(c / GRID_STEP, torch.round(c / GRID_STEP))
    assert bool((got <= fronto + GRID_STEP).all())
    # the slanted tables win somewhere: the least is not table 0 alone
    assert bool((got < fronto).any())


@pytest.mark.gpu
@pytest.mark.parametrize("cfg_name", ["cost", "pass2", "stride2"])
def test_kernel_a_planes_matches_plain(cuda, cfg_name):
    cfg = PLANE_COSTS[cfg_name]
    (_, p1), (_, p2) = _packs(50, 70, device=cuda)
    cands = center_out_offsets(1)
    n = cuda_cost.PLANES.launches
    got = cuda_cost.residual_costs_auto(p1, p2, cands, cfg, use_planes=True)
    assert cuda_cost.PLANES.launches == n + 1
    want = cuda_cost.residual_costs(p1, p2, cands, cfg, use_planes=True)
    assert torch.equal(got, want)
    # the plain version on the CPU gives the card's costs bit for bit
    assert torch.equal(got.cpu(), cuda_cost.residual_costs(
        p1.cpu(), p2.cpu(), cands, cfg, use_planes=True))
    # the plane tables of one launch stay in place for the next, after a
    # fronto launch with tables of its own; the least over the plane
    # tables exceeds the fronto cost by at most one grid step
    fronto = cuda_cost.residual_costs_auto(p1, p2, cands, cfg)
    again = cuda_cost.residual_costs_auto(p1, p2, cands, cfg, use_planes=True)
    torch.cuda.synchronize()
    assert torch.equal(again, got)
    assert bool((got <= fronto + GRID_STEP).all())


@pytest.mark.gpu
@pytest.mark.parametrize("planes", [True, False], ids=["planes", "default"])
def test_plane_launches_a_replay(cuda, planes):
    """``cuda_cost.PLANES.launches`` over one replay of a pair's graph:
    2 a fine level under ``PLANES_CONFIG`` (both refine passes), none
    under ``DEFAULT_CONFIG``."""
    cfg = PLANES_CONFIG if planes else CFG
    h, w = 48, 64
    (img1, _), (img2, _) = _packs(h, w, device=cuda)
    pipeline.compute_flow_jit(img1, img2, cfg=cfg)
    n = cuda_cost.PLANES.launches
    pipeline.compute_flow_jit(img1, img2, cfg=cfg)
    torch.cuda.synchronize()
    fine = len(cfg.pyramid.level_dims(h, w)) - 1
    assert fine == 2
    assert cuda_cost.PLANES.launches - n == (2 * fine if planes else 0)


@pytest.mark.gpu
def test_kernel_a_matches_plain_on_a_frame_smaller_than_the_reach(cuda):
    """5x7 frames against taps reaching 9 px: every tap, candidate and
    frame-2 read clamps, and the terms run over a padded domain larger
    than the frame.  Fronto (radius 3), multiwarp and plane mode; each
    wrapper call launches the terms pass and its own count once."""
    (_, p1), (_, p2) = _packs(5, 7, device=cuda)
    stack = torch.stack([torch.roll(p2, s, 1) for s in range(5)])
    cands = center_out_offsets(3)
    counts = (cuda_cost.TERMS, cuda_cost.SINGLE, cuda_cost.MULTIWARP,
              cuda_cost.PLANES)
    before = [c.launches for c in counts]
    got = [cuda_cost.residual_costs_cuda(p1, p2, cands, CFG.cost),
           cuda_cost.residual_costs_multiwarp_cuda(p1, stack, CFG.cost),
           cuda_cost.residual_costs_planes_cuda(p1, p2, cands[:9], CFG.cost)]
    assert [c.launches - b for c, b in zip(counts, before)] == [3, 1, 1, 1]
    want = [cuda_cost.residual_costs(p1, p2, cands, CFG.cost),
            cuda_cost.residual_costs_multiwarp(p1, stack, CFG.cost),
            cuda_cost.residual_costs(p1, p2, cands[:9], CFG.cost, True)]
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.gpu
@pytest.mark.parametrize("planes", [False, True])
def test_kernel_a_terms_pass_matches_plain(cuda, planes):
    """The terms pass alone against ``cost_terms``, on the maps of a
    radius-1 search (9 fronto maps, or the 100 of the plane mode)."""
    (_, p1), (_, p2) = _packs(40, 56, device=cuda)
    cands = [(cy, cx, 0) for cy, cx in center_out_offsets(1)]
    tables = cuda_cost.cost_tables(CFG.cost, planes)
    plan = cuda_cost.cost_plan(cands, CFG.cost.tap_offsets, tables)
    n = cuda_cost.TERMS.launches
    got = cuda_cost.cost_terms_cuda(p1, p2, cands, CFG.cost, tables)
    assert cuda_cost.TERMS.launches == n + 1
    assert got.shape == (100 if planes else 9, 40 + 18, 56 + 18)
    assert torch.equal(got, cuda_cost.cost_terms(p1, p2, plan.maps, 9,
                                                 CFG.cost))


def _pm_targets(k, h, w, seed, device):
    """K candidate fields and an incumbent for kernel E: targets around
    the frame, x = w and y = h among them, some far outside it (in row 2
    the incumbent at x = -1000 and the candidates at -2000, -3000, ...:
    every read clamps alike, so their costs tie), a duplicate candidate
    and one equal to the incumbent."""
    rng = np.random.default_rng(seed)
    tx = rng.integers(-3, w + 4, (k + 1, h, w)).astype(np.int32)
    ty = rng.integers(-3, h + 4, (k + 1, h, w)).astype(np.int32)
    tx[:, 0, :3], ty[:, 1, :3] = w, h
    # the incumbent far left, and candidates farther left that tie with it
    tx[:, 2] = -1000 * np.arange(1, k + 2)[:, None]
    ty[:, 2] = ty[0, 2]
    if k >= 2:
        tx[2, 3], ty[2, 3] = tx[1, 3], ty[1, 3]   # a duplicate
    tx[k, 4], ty[k, 4] = tx[0, 4], ty[0, 4]       # the incumbent itself
    tx[k, 5] = 10**6
    ty[k, 6] = -(10**6)
    t = [torch.from_numpy(a).to(device) for a in (tx, ty)]
    return t[0][0], t[1][0], t[0][1:].contiguous(), t[1][1:].contiguous()


@pytest.mark.gpu
@pytest.mark.parametrize("k,chunk,hw", [
    (1, 25, (37, 70)), (4, 25, (37, 70)), (6, 25, (37, 70)),
    (4, 7, (37, 70)), (6, 49, (37, 70)), (4, 25, (8, 10)),
    (6, 7, (8, 10))])
@pytest.mark.parametrize("planes", [False, True])
def test_kernel_e_matches_plain(cuda, k, chunk, hw, planes):
    """Kernel E's three modes on the card, each ``torch.equal`` to its
    plain composition there: the cost of K candidate fields
    (``patch_cost_tables``), their fold into the incumbent
    (``select_candidates``: strict '<', so the ties and the duplicate keep
    the earlier target) and a propagation round (``propagate_candidates``)
    at steps 1 and 8; fronto or plane tables, chunks of 25, 7 or 49 taps,
    and a frame smaller than the patch's reach."""
    h, w = hw
    (_, p1), (_, p2) = _packs(h, w, seed=k, device=cuda)
    tables = plane_offsets(CFG.cost) if planes else [CFG.cost.tap_offsets]
    tx, ty, txs, tys = _pm_targets(k, h, w, k + 10, cuda)
    cost = cuda_patchmatch.patch_cost_tables(p1, p2, tx, ty, CFG.cost,
                                             tables, 0, chunk)
    n = cuda_patchmatch.KERNEL.launches
    got = cuda_patchmatch.patch_cost_tables_auto(p1, p2, txs, tys, CFG.cost,
                                                 tables, 0, chunk)
    assert torch.equal(got, cuda_patchmatch.patch_cost_tables(
        p1, p2, txs, tys, CFG.cost, tables, 0, chunk))
    got = cuda_patchmatch.patch_cost_tables_auto(p1, p2, tx, ty, CFG.cost,
                                                 tables, 0, chunk)
    assert torch.equal(got, cost)
    got = cuda_patchmatch.select_candidates_auto(
        p1, p2, tx, ty, cost, txs, tys, CFG.cost, tables, chunk)
    want = pm.select_candidates(p1, p2, tx, ty, cost, txs, tys, CFG.cost,
                                tables, chunk)
    assert all(torch.equal(g, v) for g, v in zip(got, want))
    assert bool((got[0][2] == -1000).all())   # the ties kept
    for step in (1, 8):
        got = cuda_patchmatch.propagate_candidates_auto(
            p1, p2, want[0], want[1], want[2], step, CFG.cost, tables, chunk)
        ref = pm.propagate_candidates(p1, p2, want[0], want[1], want[2],
                                      step, CFG.cost, tables, chunk)
        assert all(torch.equal(g, v) for g, v in zip(got, ref))
    assert cuda_patchmatch.KERNEL.launches == n + 5


@pytest.mark.gpu
@pytest.mark.parametrize("halo", [2, 9, 12])
def test_kernel_e_honours_the_frame_1_halo(cuda, halo):
    """A tile of frame 1 with ``halo`` rows and columns of context (less
    than, equal to and more than the taps' reach of 9), as the gathered
    refine and line propagation pass it: identical to the plain cost."""
    (_, p1), (_, p2) = _packs(40, 56, seed=3, device=cuda)
    h, w = 40 - 2 * halo, 56 - 2 * halo
    tx, ty, txs, tys = _pm_targets(4, h, w, 7, cuda)
    for tables in ([CFG.cost.tap_offsets], plane_offsets(CFG.cost)):
        for x, y in ((tx, ty), (txs, tys)):
            got = cuda_patchmatch.patch_cost_tables_cuda(
                p1, p2, x, y, CFG.cost, tables, halo)
            want = cuda_patchmatch.patch_cost_tables(p1, p2, x, y, CFG.cost,
                                                     tables, halo)
            assert torch.equal(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("planes", [False, True])
def test_kernel_e_patchmatch_on_the_card_matches_the_cpu(cuda, planes):
    """A whole ``patchmatch`` (``patchmatch_planefitting``) at 120x160 on
    the card, one launch of kernel E for the init and one a round or
    search, identical to the same call on the CPU under the same key."""
    from eppm_tpu_torch.ops.prng import prng_key

    (_, c1), (_, c2) = _packs(120, 160, seed=9)
    run = pm.patchmatch_planefitting if planes else pm.patchmatch
    pcfg = CFG.patchmatch
    if planes:
        pcfg = dataclasses.replace(pcfg, num_iters=3)
    n = cuda_patchmatch.KERNEL.launches
    got = run(c1.to(cuda), c2.to(cuda),
              pm.ThreefrySampler(prng_key(1234, cuda)), pcfg, CFG.cost)
    assert cuda_patchmatch.KERNEL.launches - n == 1 + pcfg.num_iters * (
        len(pcfg.prop_steps) + 1)
    want = run(c1, c2, pm.ThreefrySampler(prng_key(1234)), pcfg, CFG.cost)
    for g, v in zip(got, want):
        assert torch.equal(g.cpu(), v)


@pytest.mark.gpu
@pytest.mark.parametrize("k,rule", EXACT_RULES)
@pytest.mark.parametrize("hw", [(135, 240), (120, 160)])
def test_kernel_f_matches_plain(cuda, hw, k, rule):
    """Kernel F on the card, one launch a call, ``torch.equal`` to its
    plain version on the card and on the CPU at the coarse levels of 1080p
    and 640x480, in each rule, on ``_exact_case``'s targets (at and past
    frame 2's clamped edges, far outside it, wrapping past the int32
    ends, tied with each other and with the incumbent)."""
    h, w = hw
    p1, p2, cur, cgx, cgy = _exact_case(k, h, w, h, w, seed=k + 11)
    if rule == "score":
        cgx, cgy, cur = cur[0][None], cur[1][None], None
    strict = rule != "equal"
    cpu = (p1, p2, cgx, cgy, cur)
    card = [t.to(cuda) for t in cpu[:4]] + [
        None if cur is None else tuple(t.to(cuda) for t in cur)]
    # the arbitration's instantiation launched first on the same frames:
    # the matcher's rules are unmoved by it
    p1c, p2c, cgxc, cgyc = card[:4]
    cuda_exact.arbitrate_holes_cuda(p1c, p2c, cgxc, cgyc, cgxc >= 0,
                                    (cgxc[0], cgyc[0]), (cgxc[0], cgyc[0]),
                                    EXACT_CFG, 0.6)
    n = cuda_exact.KERNEL.launches
    got = cuda_exact.exact_best_of_auto(*card, EXACT_CFG, strict)
    assert cuda_exact.KERNEL.launches == n + 1
    on_card = match.exact_best_of(*card, EXACT_CFG, strict)
    on_cpu = match.exact_best_of(*cpu, EXACT_CFG, strict)
    for g, c, v in zip(got, on_card, on_cpu):
        assert g.device == cuda
        assert torch.equal(g, c) and torch.equal(g.cpu(), v)


@pytest.mark.gpu
@pytest.mark.parametrize("case", ARB_CASES)
@pytest.mark.parametrize("hw", [(135, 240), (120, 160)])
def test_kernel_f_arbitration_matches_plain(cuda, hw, case):
    """Kernel F's arbitration rule on the card, one launch a call,
    ``torch.equal`` to ``arbitrate_holes`` on the card and on the CPU at
    the coarse levels of 1080p and 640x480, on ``_arbitration_case``'s
    fields (K = 5 and 4, candidates not found, targets outside frame 2,
    an all-hole field, a least cost at the threshold)."""
    h, w = hw
    args, at = _arbitration_case(case, h, w, seed=h + len(case))
    tx, ty, ftx, fty, cands, packs, cost_cfg, thresh, orig = args
    cgxs, cgys, masks = occlusion.arbitration_candidates(tx, cands, orig)
    cpu = (*packs, cgxs, cgys, masks, (tx, ty), (ftx, fty))
    card = [t.to(cuda) for t in cpu[:5]] + [
        tuple(t.to(cuda) for t in pair) for pair in cpu[5:]]
    n = cuda_exact.KERNEL.launches
    got = cuda_exact.arbitrate_holes_auto(*card, cost_cfg, thresh)
    assert cuda_exact.KERNEL.launches == n + 1
    on_card = occlusion.arbitrate_holes(*card, cost_cfg, thresh)
    on_cpu = occlusion.arbitrate_holes(*cpu, cost_cfg, thresh)
    for g, c, v in zip(got, on_card, on_cpu):
        assert g.device == cuda
        assert torch.equal(g, c) and torch.equal(g.cpu(), v)
    if at is not None:
        assert (int(got[0][at]), int(got[1][at])) == (int(ftx[at]),
                                                        int(fty[at]))


@pytest.mark.gpu
def test_kernel_f_occlusion_chain_on_the_card_matches_the_cpu(cuda):
    """The fill-first chain (``coarse_occlusion_reconstruct``) at a
    135x240 level on the card, kernel F launched once (the arbitration),
    gives the CPU's targets."""
    args, _ = _arbitration_case("K=5", 135, 240, seed=24)
    tx, ty, _, _, _, packs, cost_cfg, _, orig = args
    (img, _), _ = _packs(135, 240, seed=24)
    cpu = (tx, ty, img, packs, orig)
    card = [t.to(cuda) for t in cpu[:3]] + [
        tuple(t.to(cuda) for t in pair) for pair in cpu[3:]]
    n = cuda_exact.KERNEL.launches
    got = occlusion.coarse_occlusion_reconstruct(
        *card[:3], CFG.refine, packs=card[3], cost_cfg=cost_cfg,
        orig=card[4])
    assert cuda_exact.KERNEL.launches == n + 1
    want = occlusion.coarse_occlusion_reconstruct(
        *cpu[:3], CFG.refine, packs=cpu[3], cost_cfg=cost_cfg, orig=cpu[4])
    for g, v in zip(got, want):
        assert torch.equal(g.cpu(), v)


@pytest.mark.gpu
def test_kernel_f_match_coarse_bidi_on_the_card_matches_the_cpu(cuda):
    """``match_coarse_bidi`` at a 120x160 level on the card, kernel F
    launched 8 times (4 a direction), gives the CPU's targets and costs."""
    (i1, p1), (i2, p2) = _packs(120, 160, seed=6)
    n = cuda_exact.KERNEL.launches
    gpu = match.match_coarse_bidi(i1.to(cuda), i2.to(cuda), CFG.cost,
                                  CFG.match, p1.to(cuda), p2.to(cuda))
    assert cuda_exact.KERNEL.launches - n == 8
    cpu = match.match_coarse_bidi(i1, i2, CFG.cost, CFG.match, p1, p2)
    for c, g in zip(cpu, gpu):
        for a, b in zip(c, g):
            assert torch.equal(a, b.cpu())


@pytest.mark.gpu
@pytest.mark.parametrize("n1,n2,d,splits,tie", [
    (5, 1000, 275, None, (40, 900)),     # N1 below one 128-row block tile
    (300, 17, 275, None, (3, 16)),       # N2 below one 64-row tile
    (129, 1000, 275, 3, (380, 390)),     # a tie across two splits
    (200, 700, 275, 1, (70, 130)),       # a tie across two tiles
    (1, 33, 1, None, (0, 30)),           # D = 1: ties everywhere
    (130, 300, 768, None, (10, 290)),    # D = MAX_D: 24 feature chunks
    (1000, 1200, 275, None, (600, 1100)),  # N1 != N2, the planner's split
])
def test_kernel_d_matches_plain(cuda, n1, n2, d, splits, tie):
    """Descriptor-like rows (``texture_rows``: the exactness argument
    needs products whose lowest bit stays within float64's 53 bits of the
    largest partial sum).  D = 275 is not a multiple of the 32-feature
    chunk.  Frame-2 rows ``tie`` are equal and frame-1 row 0 is that row:
    the lower index wins across tiles and across splits."""
    d1 = texture_rows(n1, 1, d, cuda)
    d2 = texture_rows(n2, 2, d, cuda)
    lo, hi = tie
    d2[hi] = d2[lo]
    d1[0] = d2[lo]
    n = cuda_match.KERNEL.launches
    got = (cuda_match.global_argmax_auto(d1, d2) if splits is None
           else cuda_match.global_argmax_cuda(d1, d2, splits))
    assert cuda_match.KERNEL.launches == n + 1
    want = cuda_match.global_argmax(d1, d2, 16)
    assert got.dtype == torch.int32 and torch.equal(got, want)
    assert int(got[0]) == lo


@pytest.mark.gpu
def test_kernel_d_matches_plain_on_dark_frames(cuda):
    """Descriptors of frames with black regions (``dark_rows``), outside
    the condition under which the float64 sums are exact in any order:
    the indices are still the plain version's."""
    d1, d2 = dark_rows(cuda)
    n = cuda_match.KERNEL.launches
    got = cuda_match.global_argmax_auto(d1, d2)
    assert cuda_match.KERNEL.launches == n + 1
    assert torch.equal(got, cuda_match.global_argmax(d1, d2))


@pytest.mark.gpu
def test_kernel_d_library_geometry_is_the_planners(cuda):
    """The library reports the planner's tile, a residency of at least one
    block per SM, and the argmax kernel's registers (at most 128, its
    launch bound of 2 blocks per SM)."""
    geo = cuda_match.geometry(cuda)
    assert geo.tile == (cuda_match.BM, cuda_match.BN, cuda_match.BK)
    assert geo.blocks_per_sm >= 1 and 0 < geo.registers <= 128


@pytest.mark.gpu
@pytest.mark.parametrize("radius", [10, 6])
@pytest.mark.parametrize("h,w", [(60, 80), (37, 70), (7, 5)])
def test_kernel_b_matches_plain(cuda, radius, h, w):
    """Identical to the plain version: the paired kernel at the default
    radius 10 (2r + 1 taps, one partial sum, a row), the one-pass kernel
    at radius 6 (``--set refine.blf_sigma_spatial=3.0``); 37x70 is not a
    multiple of the paired kernel's 32 x 32 tile, 7x5 is smaller than the
    radius."""
    cfg = RefineConfig(blf_sigma_spatial=radius / 2)
    (img, _), _ = _packs(h, w, device=cuda)
    rng = np.random.default_rng(1)
    flow = torch.from_numpy(rng.normal(0, 3, (h, w, 2)).astype(
        np.float32)).to(cuda)
    flow[h // 6 : h // 3, w // 16 : w // 3 + 1] = UNKNOWN_FLOW
    flow[: h // 4, -(w // 4) :] = UNKNOWN_FLOW
    ran, other = ((cuda_smooth.PAIRED, cuda_smooth.KERNEL) if radius == 10
                  else (cuda_smooth.KERNEL, cuda_smooth.PAIRED))
    n, m = ran.launches, other.launches
    got = cuda_smooth.flow_smoothing_auto(flow, img, cfg)
    assert (ran.launches, other.launches) == (n + 1, m)
    assert torch.equal(got, cuda_smooth.flow_smoothing(flow, img, cfg))


@pytest.mark.gpu
@pytest.mark.parametrize("level", ["holes", "no hole", "all holes", "37x70",
                                   "7x5", "radius 7"])
@pytest.mark.parametrize("mode", ["polish", "jacobi", "full"])
@pytest.mark.parametrize("dilation", [1, 2])
def test_kernel_c_matches_plain(cuda, mode, dilation, level):
    """Identical to the plain version (``torch.equal``) in the polish and
    Jacobi modes (3 iterations, only the holes listed) and the full-image
    mode (2 iterations, every pixel listed): on a 40x56 level with holes,
    with no hole (an empty list under ``only_occlusion``), with every
    pixel a hole, at 37x70 and at 7x5 (smaller than the window), and at
    radius 7 (225 offsets, the kernel's largest window)."""
    h, w = {"37x70": (37, 70), "7x5": (7, 5)}.get(level, (40, 56))
    tx, ty, img = _wmf_inputs(h, w, device=cuda)
    if level == "no hole":
        ys, xs = grid(h, w, cuda)
        tx, ty = xs + 2, ys + 1
    elif level == "all holes":
        tx = torch.full_like(tx, INVALID_LOCATION)
        ty = torch.full_like(ty, INVALID_LOCATION)
    cfg = RefineConfig(wmf_radius=7) if level == "radius 7" else CFG.refine
    kw = dict(num_iter=2 if mode == "full" else 3,
              only_occlusion=mode != "full", dilation=dilation)
    if mode == "polish":
        kw["polish_init"] = fill_holes(tx, ty, img)
    n = cuda_wmf.KERNEL.launches
    got = cuda_wmf.weighted_median_filter_auto(tx, ty, img, cfg, **kw)
    assert cuda_wmf.KERNEL.launches == n + kw["num_iter"]
    want = cuda_wmf.weighted_median_filter(tx, ty, img, cfg, **kw)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.gpu
def test_slice_on_the_card_matches_the_cpu(cuda):
    rng = np.random.default_rng(2)
    img1 = torch.from_numpy((rng.random((96, 128, 3)) * 255).astype(np.uint8))
    img2 = torch.roll(img1, (2, -3), (0, 1))
    before = _counts(DEFAULT_PATH)
    gpu = pipeline.compute_flow(img1.to(cuda), img2.to(cuda)).cpu().numpy()
    assert all(a > b for a, b in zip(_counts(DEFAULT_PATH), before))
    cpu = pipeline.compute_flow(img1, img2).numpy()
    d = np.abs(gpu - cpu).max(axis=-1)
    assert (d < 1e-3).mean() >= 0.98 and d.mean() < 0.05


@pytest.mark.gpu
@pytest.mark.parametrize("engine", ["dense", "patchmatch"])
def test_sharded_on_the_card_matches_the_cpu(cuda, engine):
    """The multi-device path on a (1, 2, 2) mesh of the card repeated
    gives the CPU mesh's flow bit for bit (kernels A, B and C on the
    tiles and the replicated coarse level; the default key's draws)."""
    from eppm_tpu_torch.parallel import compute_flow_sharded, make_mesh

    cfg = dataclasses.replace(CFG, match_engine=engine)
    rng = np.random.default_rng(5)
    img1 = torch.from_numpy((rng.random((64, 96, 3)) * 255).astype(np.uint8))
    img2 = torch.roll(img1, (1, -2), (0, 1))
    got = compute_flow_sharded(img1[None], img2[None],
                               make_mesh(1, 2, 2, devices=[cuda] * 4), cfg)
    want = compute_flow_sharded(img1[None], img2[None],
                                make_mesh(1, 2, 2, devices=["cpu"] * 4), cfg)
    assert got.device == cuda
    assert torch.equal(got.cpu(), want)


@pytest.mark.gpu
def test_trunc_i32_on_the_card_matches_the_cpu(cuda):
    """The saturating float -> int32 truncation gives the same values on
    the card and the CPU (a plain cast does not: the card saturates, the
    CPU gives -2^31), and the warm-started match targets agree too."""
    from eppm_tpu_torch.ops._util import trunc_i32

    x = torch.tensor([1e10, -1e10, 3.7e9, -3.7e9, float("nan"), 0.5, -0.5,
                      -2.7, 2.7, float("inf"), -float("inf"), 2147483520.0,
                      2147483648.0, -2147483648.0])
    assert torch.equal(trunc_i32(x.to(cuda)).cpu(), trunc_i32(x))
    (i1, p1), (i2, p2) = _packs(48, 64, seed=5)
    init = torch.zeros((48, 64, 2))
    init[..., 0], init[..., 1] = 2.0, -1.0
    init[:6, :9] = UNKNOWN_FLOW
    init[12:14, 4:10, 0] = -3.7e9
    for skip in (True, False):
        mcfg = dataclasses.replace(CFG.match, warm_skip_global=skip)
        cpu = match.match_coarse_bidi(i1, i2, CFG.cost, mcfg, p1, p2,
                                      init_flow=init)
        gpu = match.match_coarse_bidi(i1.to(cuda), i2.to(cuda), CFG.cost,
                                      mcfg, p1.to(cuda), p2.to(cuda),
                                      init_flow=init.to(cuda))
        for c, g in zip(cpu, gpu):
            assert torch.equal(c[0], g[0].cpu()) and torch.equal(
                c[1], g[1].cpu())
