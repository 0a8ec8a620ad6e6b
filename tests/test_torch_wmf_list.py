"""Kernel C's order of work (``eppm_tpu_torch/csrc/wmf.cu``), written in
plain torch and held to the plain version ``weighted_median_filter`` bit
for bit on the CPU.

The kernel lists the pixels whose output can change (the holes under
``only_occlusion``, every pixel otherwise), gives each a group of lanes,
gathers the window's supports of nonzero weight and its valid candidates
in raster order, lets lane l sum the costs of candidates l, l + 32, ... in
partial sums of ``WMF_CHUNK`` supports, and reduces (cost, candidate) over
the lanes to the least cost and, among equal costs, the first candidate.
``kernel_order`` below does the same steps on tensors.  The inputs force
exact ties: windows of repeated displacements, equal colours (so weights
tie), candidates of different displacements at mirrored offsets (so costs
tie), and support weights that the final flush zeroes."""

import math

import numpy as np
import pytest
import torch

from eppm_tpu_torch.config import FLT_MAX, INVALID_LOCATION, RefineConfig
from eppm_tpu_torch.ops._util import FLT_MIN, exp_cephes, ftz, grid, inv32
from eppm_tpu_torch.ops.refine import (WMF_CHUNK, _wmf_tables, fill_holes,
                                       weighted_median_filter)

# The suite runs several test processes per host: one torch thread each
# keeps them from oversubscribing the cores.
torch.set_num_threads(1)

LANES = 32
INT_MAX = 2**31 - 1
CFG = RefineConfig()


def kernel_order(tx, ty, img, cfg=CFG, num_iter=1, only_occlusion=False,
                 polish_init=None, dilation=1, first=True, lanes=LANES):
    """``weighted_median_filter`` in kernel C's order; ``first=False``
    takes the last of equal least costs instead (the wrong rule).
    Returns (tx, ty, the pixels listed in each iteration)."""
    h, w = tx.shape
    offs, gws = _wmf_tables(cfg, dilation)
    n = len(offs)
    oyx = torch.tensor(offs, dtype=torch.int64)
    g = torch.from_numpy(gws)
    ys, xs = grid(h, w, tx.device)
    valid = (tx >= 0) & (ty >= 0)
    # the wrapper's planes
    if polish_init is not None:
        tx0 = torch.where(valid, tx, polish_init[0])
        ty0 = torch.where(valid, ty, polish_init[1])
        ox, oy = (tx0 - xs).to(torch.float32), (ty0 - ys).to(torch.float32)
    else:
        ox = torch.where(valid, (tx - xs).to(torch.float32), 0.0)
        oy = torch.where(valid, (ty - ys).to(torch.float32), 0.0)
    ox, oy, val = ox.reshape(-1), oy.reshape(-1), valid.to(torch.float32)
    val = val.reshape(-1)
    only = only_occlusion or polish_init is not None
    freeze = polish_init is not None
    inv = inv32(cfg.wmf_sigma_range**2)
    flat_img = img.reshape(-1, 3)
    listed_counts = []
    for _ in range(num_iter):
        # the list pass: a copy of every plane, the list
        lst = torch.nonzero(val == 0 if only
                            else torch.ones_like(val, dtype=torch.bool))[:, 0]
        listed_counts.append(len(lst))
        new = (ox.clone(), oy.clone(), val.clone())
        if len(lst):
            _median(lst, ox, oy, val, flat_img, new, h, w, oyx, g, n, inv,
                    freeze, first, lanes)
        ox, oy, val = new
    ox2, oy2 = ox.reshape(h, w), oy.reshape(h, w)
    if polish_init is not None:
        return ox2.to(torch.int32) + xs, oy2.to(torch.int32) + ys, \
            listed_counts
    v2 = val.reshape(h, w) > 0
    return (torch.where(v2, ox2.to(torch.int32) + xs, tx),
            torch.where(v2, oy2.to(torch.int32) + ys, ty), listed_counts)


def _median(lst, ox, oy, val, flat_img, new, h, w, oyx, g, n, inv, freeze,
            first, lanes):
    """The median kernel over the listed pixels ``lst``: writes ``new``."""
    py, px = lst // w, lst % w
    qy = py[:, None] + oyx[None, :, 0]
    qx = px[:, None] + oyx[None, :, 1]
    inside = (qy >= 0) & (qy < h) & (qx >= 0) & (qx < w)
    q = qy.clamp(0, h - 1) * w + qx.clamp(0, w - 1)
    sval = torch.where(inside, val[q], 0.0)
    v = sval > 0
    sx = torch.where(inside, ox[q], 0.0)
    sy = torch.where(inside, oy[q], 0.0)
    d = (flat_img[q] - flat_img[lst][:, None]).abs()
    dr = torch.maximum(torch.maximum(d[..., 0], d[..., 1]), d[..., 2])
    # an invalid support's weight is +0 without its exp
    wgt = torch.where(v, ftz(sval * g[None] * exp_cephes(-(dr * dr) * inv)),
                      0.0)
    nz = wgt > 0
    # every window entry's cost as a candidate: the supports of nonzero
    # weight in raster order, in partial sums of WMF_CHUNK
    cost = torch.zeros_like(sx)
    for c0 in range(0, n, WMF_CHUNK):
        part = torch.zeros_like(sx)
        for s in range(c0, min(c0 + WMF_CHUNK, n)):
            dev = torch.maximum((sx - sx[:, s : s + 1]).abs(),
                                (sy - sy[:, s : s + 1]).abs())
            part = torch.where(nz[:, s : s + 1],
                               part + wgt[:, s : s + 1] * dev, part)
        cost = cost + part
    # the valid candidates in raster order, compacted: position j -> entry
    order = torch.argsort((~v).to(torch.int8), dim=1, stable=True)
    comp = torch.where(v, cost, math.inf).gather(1, order)
    comp = torch.where(nz.any(1, keepdim=True), comp, math.inf)  # no weight
    rounds = -(-n // lanes)
    comp = torch.nn.functional.pad(comp, (0, rounds * lanes - n),
                                   value=math.inf).view(-1, rounds, lanes)
    # lane l: candidates l, l + lanes, ... in ascending order, strict <
    best = torch.full((len(lst), lanes), FLT_MAX, dtype=torch.float32)
    bj = torch.full((len(lst), lanes), INT_MAX, dtype=torch.int64)
    lane = torch.arange(lanes)
    for r in range(rounds):
        c, j = comp[:, r], r * lanes + lane
        better = c < best
        if not first:
            better = better | ((c == best) & (c < FLT_MAX))
        best = torch.where(better, c, best)
        bj = torch.where(better, j, bj)
    # the butterfly over the lanes: the least (cost, candidate)
    off = lanes // 2
    while off:
        ob, oj = best[:, lane ^ off], bj[:, lane ^ off]
        tie = (ob == best) & ((oj < bj) if first
                              else (oj > bj) & (oj != INT_MAX))
        take = (ob < best) | tie
        best, bj = torch.where(take, ob, best), torch.where(take, oj, bj)
        off //= 2
    b, j = best[:, 0], bj[:, 0].clamp(max=n - 1)
    entry = order.gather(1, j[:, None])
    cx, cy = sx.gather(1, entry)[:, 0], sy.gather(1, entry)[:, 0]
    ok = (b < FLT_MAX) & (cx + px.to(torch.float32) >= 0) & (
        cy + py.to(torch.float32) >= 0)
    new[0][lst] = torch.where(ok, cx, ox[lst])
    new[1][lst] = torch.where(ok, cy, oy[lst])
    if not freeze:
        new[2][lst] = torch.where(ok, 1.0, val[lst])


# --- inputs ---------------------------------------------------------------

# a colour step whose weight exp_cephes(-dr^2 / sig_r^2) is a normal float
# that g < 0.8 pushes below FLT_MIN, where the final flush zeroes it
FLUSH_STEP = 0.18655


def _repeats(rng, h, w):
    """Displacements constant on 3x3 blocks, from three values; colours
    from two levels and the flush step; 25% holes and a block."""
    ys, xs = np.mgrid[0:h, 0:w]
    vals = np.array([-1, 0, 2])
    bu = vals[rng.integers(0, 3, (h // 3 + 1, w // 3 + 1))]
    bv = vals[rng.integers(0, 3, (h // 3 + 1, w // 3 + 1))]
    tx = xs + bu[ys // 3, xs // 3]
    ty = ys + bv[ys // 3, xs // 3]
    holes = rng.random((h, w)) < 0.25
    holes[h // 3 : h // 2, w // 4 : w // 2] = True
    levels = np.where((xs // 5 + ys // 4) % 2 == 0, 0.4, 0.4 + FLUSH_STEP)
    img = np.repeat(levels[..., None], 3, -1)
    img[ys < h // 4] = 0.7
    return tx, ty, holes, img


def _lattice(rng, h, w):
    """Valid pixels only on a lattice of step 4, displacements in {-1, 0,
    1}, one colour: a hole between two lattice pixels at mirrored offsets
    weighs them alike, so different displacements tie."""
    ys, xs = np.mgrid[0:h, 0:w]
    tx = xs + rng.integers(-1, 2, (h, w))
    ty = ys + rng.integers(-1, 2, (h, w))
    holes = (ys % 4 != 1) | (xs % 4 != 2)
    img = np.full((h, w, 3), 0.5)
    return tx, ty, holes, img


def _flush(rng, h, w):
    """Smooth displacements with noise, 20% holes; the colour steps by
    FLUSH_STEP on a vertical line and a few pixels, so the far supports
    across it are flushed and the near ones tiny."""
    ys, xs = np.mgrid[0:h, 0:w]
    tx = xs + np.round(1 + np.sin(xs / 5.0)) + rng.integers(0, 2, (h, w))
    ty = ys - 1 + rng.integers(0, 2, (h, w))
    holes = rng.random((h, w)) < 0.2
    img = np.full((h, w, 3), 0.3)
    img[:, w // 2 :] += FLUSH_STEP
    img[rng.random((h, w)) < 0.05] += FLUSH_STEP
    return tx, ty, holes, img


INPUTS = {"repeats": _repeats, "lattice": _lattice, "flush": _flush}


def _make(kind, h=16, w=20, seed=0):
    rng = np.random.default_rng(seed)
    tx, ty, holes, img = INPUTS[kind](rng, h, w)
    tx = np.where(holes, INVALID_LOCATION, tx).astype(np.int32)
    ty = np.where(holes, INVALID_LOCATION, ty).astype(np.int32)
    return (torch.from_numpy(tx), torch.from_numpy(ty),
            torch.from_numpy(img.astype(np.float32)))


def _modes(tx, ty, img):
    return {
        "polish": dict(num_iter=1, only_occlusion=True,
                       polish_init=fill_holes(tx, ty, img)),
        "jacobi": dict(num_iter=3, only_occlusion=True),
        "full": dict(num_iter=2),
    }


# --- tests ----------------------------------------------------------------


@pytest.mark.parametrize("kind", list(INPUTS))
@pytest.mark.parametrize("mode", ["polish", "jacobi", "full"])
@pytest.mark.parametrize("dilation", [1, 2])
def test_kernel_order_equals_plain(kind, mode, dilation):
    """The kernel's order gives the plain version's targets, bit for bit,
    in every mode at dilation 1 and 2."""
    tx, ty, img = _make(kind)
    kw = dict(_modes(tx, ty, img)[mode], dilation=dilation)
    want = weighted_median_filter(tx, ty, img, CFG, **kw)
    got = kernel_order(tx, ty, img, CFG, **kw)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("mode", ["polish", "jacobi", "full"])
def test_the_list_is_the_pixels_that_can_change(mode):
    """The holes under ``only_occlusion`` (the polish keeps its holes
    listed, Jacobi iterations fill them), every pixel otherwise; a pixel
    left off the list keeps its input."""
    tx, ty, img = _make("repeats")
    kw = _modes(tx, ty, img)[mode]
    got = kernel_order(tx, ty, img, CFG, **kw)
    holes = int(((tx < 0) | (ty < 0)).sum())
    n = tx.numel()
    if mode == "full":
        assert got[2] == [n, n]
    else:
        assert got[2][0] == holes
        valid = (tx >= 0) & (ty >= 0)
        assert torch.equal(got[0][valid], tx[valid])
        assert torch.equal(got[1][valid], ty[valid])
    if mode == "jacobi":
        assert got[2][0] > got[2][1] >= got[2][2]


@pytest.mark.parametrize("holes", ["none", "all"])
@pytest.mark.parametrize("mode", ["jacobi", "full"])
def test_kernel_order_on_levels_without_holes_or_without_valid(holes, mode):
    """No hole: nothing is listed under ``only_occlusion`` and out equals
    in.  Every pixel a hole: no candidate anywhere, nothing changes."""
    tx, ty, img = _make("repeats")
    if holes == "none":
        ys, xs = grid(*tx.shape, tx.device)
        tx, ty = xs + 1, ys
    else:
        tx = torch.full_like(tx, INVALID_LOCATION)
        ty = torch.full_like(ty, INVALID_LOCATION)
    kw = _modes(tx, ty, img)[mode]
    want = weighted_median_filter(tx, ty, img, CFG, **kw)
    got = kernel_order(tx, ty, img, CFG, **kw)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    if holes == "none" and mode == "jacobi":
        assert got[2] == [0, 0, 0]
    if holes == "all":
        assert torch.equal(got[0], tx) and torch.equal(got[1], ty)


@pytest.mark.parametrize("lanes", [16, 8])
def test_kernel_order_at_fewer_lanes(lanes):
    """The same result with 16 or 8 lanes a pixel (the kernel's forms)."""
    tx, ty, img = _make("lattice", 13, 17, seed=3)
    kw = _modes(tx, ty, img)["jacobi"]
    want = weighted_median_filter(tx, ty, img, CFG, **kw)
    got = kernel_order(tx, ty, img, CFG, lanes=lanes, **kw)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_kernel_order_at_radius_7():
    """The largest window the kernel takes (225 offsets: 9 partial sums,
    7 rounds of 32 lanes and one more)."""
    cfg = RefineConfig(wmf_radius=7)
    assert len(_wmf_tables(cfg, 1)[0]) == 225
    tx, ty, img = _make("repeats", 20, 23, seed=1)
    kw = _modes(tx, ty, img)["polish"]
    want = weighted_median_filter(tx, ty, img, cfg, **kw)
    got = kernel_order(tx, ty, img, cfg, **kw)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_inputs_force_the_ties():
    """The lattice's ties decide targets: the last of equal least costs
    gives other targets than the first.  The flush step makes a normal
    exp weight that g pushes below FLT_MIN."""
    tx, ty, img = _make("lattice")
    kw = _modes(tx, ty, img)["jacobi"]
    want = weighted_median_filter(tx, ty, img, CFG, **kw)
    last = kernel_order(tx, ty, img, CFG, first=False, **kw)
    assert not (torch.equal(last[0], want[0]) and torch.equal(last[1],
                                                              want[1]))
    dr = torch.tensor(FLUSH_STEP, dtype=torch.float32)
    e = exp_cephes(-(dr * dr) * inv32(CFG.wmf_sigma_range**2))
    g = torch.from_numpy(_wmf_tables(CFG, 1)[1])
    assert float(e) >= FLT_MIN
    tiny = g * e
    assert bool(((tiny > 0) & (tiny < FLT_MIN)).any())
    assert bool((ftz(tiny) >= FLT_MIN).any())
