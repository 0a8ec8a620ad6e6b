"""Kernel B's paired form on the CPU: each range weight of the radius-10
flow smoothing computed once per unordered pixel pair, then summed in the
paired kernel's order (``csrc/smooth.cu::flow_smooth_pair_kernel``), gives
``flow_smoothing`` bit for bit.

The construction rests on two symmetries, held here bit for bit: the
spatial table is symmetric (tap k and tap n*n - 1 - k weigh the same) and
the range weight of p and q does not depend on their order.  A helper then
computes the fields W(x) = w(x, x + (dy, e)) of the negative offsets once,
with the plain version's operations, serves tap (dy, dx) of pixel p and
tap (-dy, -dx) of p + (dy, dx) from the same value, and reassembles each
pixel's sums as the kernel does: row -dy added at once for dy = r..1, row
+dy kept, then row 0, then rows +1..+r in order.  At r = 10 a partial sum
of ``SMOOTH_CHUNK`` = 21 taps is one row, which is what makes this order
the plain version's."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eppm_tpu.config import DEFAULT_CONFIG as JC
from eppm_tpu.ops import refine as jref

from eppm_tpu_torch.config import DEFAULT_CONFIG as TC
from eppm_tpu_torch.config import UNKNOWN_FLOW, UNKNOWN_FLOW_THRESH
from eppm_tpu_torch.config import RefineConfig
from eppm_tpu_torch.ops._util import FLT_MIN, exp_cephes, ftz, inv32, pad_edge
from eppm_tpu_torch.ops.refine import (SMOOTH_CHUNK, _pad_const,
                                       chunk_sum21, flow_smoothing,
                                       smoothing_weights)

# The suite runs several test processes per host: one torch thread each
# keeps them from oversubscribing the cores.
torch.set_num_threads(1)

CFG = TC.refine
R = CFG.blf_radius
INV = inv32(CFG.blf_sigma_range**2)


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous().view(torch.int32)


def _range_weight(a, b, gk: float):
    """The plain version's weight of a tap whose colour is ``a`` for a
    pixel whose colour is ``b`` (``ops/refine.py::flow_smoothing``),
    before the known mask."""
    d = (a - b).abs()
    dr = torch.maximum(torch.maximum(d[..., 0], d[..., 1]), d[..., 2])
    return ftz(exp_cephes(-(dr * dr) * INV) * gk)


def _row(weights, flows):
    """One chunk of the plain version: the known taps' weights in order,
    their weighted flows (+0 for the others) in ``chunk_sum21``'s order;
    returns the closed partials (flow (h, w, 2), weight (h, w))."""
    prods = []
    part_w = torch.zeros_like(weights[0])
    for wt, f in zip(weights, flows):
        known = (f[..., 0] <= UNKNOWN_FLOW_THRESH) & (
            f[..., 1] <= UNKNOWN_FLOW_THRESH)
        wk = wt * known.to(torch.float32)
        prods.append(torch.where(known[..., None], wk[..., None] * f, 0.0))
        part_w = part_w + wk
    return chunk_sum21(prods), part_w


def paired_smoothing(flow, img, cfg=CFG, tail_reversed=False):
    """``flow_smoothing`` at 2r + 1 == SMOOTH_CHUNK, each range weight of
    an unordered pair computed once, the sums in the paired kernel's
    order.  ``tail_reversed`` adds rows +1..+r in reverse (a wrong order,
    for the test that the order is seen)."""
    h, w = flow.shape[:2]
    r = cfg.blf_radius
    n = 2 * r + 1
    assert n == SMOOTH_CHUNK
    g = smoothing_weights(cfg)
    # fields over the frame padded by r, their partners inside 2r
    pimg = pad_edge(img, 2 * r, 2 * r)
    pflow = _pad_const(flow, r, UNKNOWN_FLOW)
    hp, wp = h + 2 * r, w + 2 * r

    def field(dy, e):
        """W(x) = w(x, x + (dy, e)) for x over the r-padded frame."""
        a = pimg[r + dy : r + dy + hp, r + e : r + e + wp]
        b = pimg[r : r + hp, r : r + wp]
        return _range_weight(a, b, float(g[(dy + r) * n + e + r]))

    def at(t, dy, dx):  # t (r-padded) at p + (dy, dx) for every pixel p
        return t[r + dy : r + dy + h, r + dx : r + dx + w]

    fsum = torch.zeros((h, w, 2), dtype=torch.float32)
    wsum = torch.zeros((h, w), dtype=torch.float32)
    kept = {}
    for m in range(r, 0, -1):
        fields = {e: field(-m, e) for e in range(-r, r + 1)}
        f, wt = _row([at(fields[e], 0, 0) for e in range(-r, r + 1)],
                     [at(pflow, -m, e) for e in range(-r, r + 1)])
        fsum, wsum = fsum + f, wsum + wt
        # tap dx of row +m is tap -dx of row -m of p + (m, dx)
        kept[m] = _row([at(fields[-dx], m, dx) for dx in range(-r, r + 1)],
                       [at(pflow, m, dx) for dx in range(-r, r + 1)])
    fields = {e: field(0, e) for e in range(-r, 0)}
    centre = _range_weight(img, img, float(g[r * n + r]))
    f, wt = _row([at(fields[dx], 0, 0) if dx < 0
                  else centre if dx == 0 else at(fields[-dx], 0, dx)
                  for dx in range(-r, r + 1)],
                 [at(pflow, 0, dx) for dx in range(-r, r + 1)])
    fsum, wsum = fsum + f, wsum + wt
    for m in (range(r, 0, -1) if tail_reversed else range(1, r + 1)):
        fsum, wsum = fsum + kept[m][0], wsum + kept[m][1]
    out = fsum / wsum.clamp_min(1e-30)[..., None]
    return torch.where((wsum > 0)[..., None], out, flow)


def _frames(h, w, seed, corner=0):
    """A blocky image with noise and runs of equal colours, and a flow
    with unknown holes (and an unknown top-left corner of ``corner`` px)."""
    rng = np.random.default_rng(seed)
    small = rng.random((h // 4 + 2, w // 4 + 2, 3)).astype(np.float32)
    img = np.kron(small, np.ones((4, 4, 1), np.float32))[:h, :w]
    noisy = rng.random((h, w)) < 0.7
    img[noisy] += rng.normal(0, 0.01, (int(noisy.sum()), 3)).astype(
        np.float32)
    img = np.clip(img, 0, 1).astype(np.float32)
    flow = rng.normal(0, 3, (h, w, 2)).astype(np.float32)
    flow[rng.random((h, w)) < 0.1] = UNKNOWN_FLOW
    flow[h // 3 : h // 2, w // 4 : w // 2] = UNKNOWN_FLOW
    flow[:corner, :corner] = UNKNOWN_FLOW
    return torch.from_numpy(flow), torch.from_numpy(img)


@pytest.mark.parametrize("r", range(16))
def test_spatial_weights_are_symmetric(r):
    cfg = RefineConfig(blf_sigma_spatial=max(r, 0.5) / 2)  # radius 2 sigma
    assert cfg.blf_radius == r
    g = smoothing_weights(cfg)
    assert g.shape == ((2 * r + 1) ** 2,)
    assert np.array_equal(g.view(np.int32), g[::-1].view(np.int32))


@pytest.mark.parametrize("kind", ["equal", "tiny", "flush_edge", "random"])
def test_range_weight_is_symmetric(kind):
    """w(p, q) at tap k is w(q, p) at tap n*n - 1 - k, bit for bit, for
    every tap of the default window."""
    rng = np.random.default_rng(7)
    m = 4096
    a = rng.random((m, 3)).astype(np.float32)
    if kind == "equal":
        b = a.copy()
        b[::2, rng.integers(0, 3)] += np.float32(0.01)
    elif kind == "tiny":  # differences near 2^-20
        b = a + (rng.normal(0, 1, (m, 3)) * 2.0**-20).astype(np.float32)
    elif kind == "flush_edge":  # dr across the exp's flush to zero
        dr = np.linspace(0.17, 0.20, m).astype(np.float32)
        sign = np.where(rng.random(m) < 0.5, -1, 1).astype(np.float32)
        b = a.copy()
        b[np.arange(m), rng.integers(0, 3, m)] += sign * dr
    else:
        b = rng.random((m, 3)).astype(np.float32)
    a, b = torch.from_numpy(a), torch.from_numpy(b.astype(np.float32))
    g = smoothing_weights(CFG)
    n = 2 * R + 1
    zeros = nonzero = 0
    for k in range(n * n):
        w_pq = _range_weight(b, a, float(g[k]))
        w_qp = _range_weight(a, b, float(g[n * n - 1 - k]))
        assert torch.equal(_bits(w_pq), _bits(w_qp)), k
        zeros += int((w_pq == 0).sum())
        nonzero += int((w_pq >= FLT_MIN).sum())
    if kind == "flush_edge":
        assert zeros > 0 and nonzero > 0
    elif kind != "random":
        assert zeros == 0


@pytest.mark.parametrize("h,w,corner", [(23, 29, 0), (7, 5, 0),
                                        (30, 36, 14)],
                         ids=["holes", "smaller_than_radius",
                              "unknown_corner"])
def test_paired_order_matches_flow_smoothing(h, w, corner):
    flow, img = _frames(h, w, 11, corner)
    want = flow_smoothing(flow, img, CFG)
    got = paired_smoothing(flow, img)
    assert torch.equal(_bits(got), _bits(want))
    if corner:  # windows with no known flow keep their value
        assert torch.equal(got[:3, :3], flow[:3, :3])


def test_paired_order_reversed_tail_is_seen():
    """Adding rows +1..+r in reverse changes the result at this size:
    the equality above holds the order, not only the weights."""
    flow, img = _frames(23, 29, 11)
    wrong = paired_smoothing(flow, img, tail_reversed=True)
    assert not torch.equal(wrong, flow_smoothing(flow, img, CFG))


def test_paired_order_matches_jax_oracle():
    flow, img = _frames(23, 29, 12, corner=12)
    want = np.asarray(jax.jit(lambda f, i: jref.flow_smoothing(
        f, i, JC.refine))(jnp.asarray(flow.numpy()),
                          jnp.asarray(img.numpy())))
    got = paired_smoothing(flow, img).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
