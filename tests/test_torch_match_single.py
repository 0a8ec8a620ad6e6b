"""The single-direction coarse matcher of the PyTorch port
(``match_coarse``) and its global match (``global_match``, whose plain
version ``global_argmax`` is kernel D's) against the JAX package on the
CPU, and against the port's own bidirectional matcher.

Contract as in tests/test_torch_match.py: the global match multiplies in
float64 here and in float32 there, so >= 99% of targets agree; the
matcher keeps >= 98% of pixels, and where it differs both choices have
the same quantized exact cost (a tie)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eppm_tpu.config import DEFAULT_CONFIG as JC
from eppm_tpu.ops import match as jmatch

from eppm_tpu_torch.config import DEFAULT_CONFIG as TC
from eppm_tpu_torch.ops import cuda_match
from eppm_tpu_torch.ops import match as tmatch
from test_torch_match import J, T, _exact_cost, _level_pair

# The suite runs several test processes per host: one torch thread each
# keeps them from oversubscribing the cores.
torch.set_num_threads(1)


@functools.lru_cache(maxsize=None)
def _coarse(h, w):
    """An (h, w) coarse-level pair whose frame 1 is frame 2 shifted by
    (-4, 3), and the port's ``match_coarse`` on it: computed once for
    the tests below that share it."""
    (i1, p1), (i2, p2) = _level_pair(np.random.default_rng(1234), h, w, -4, 3)
    fwd = tmatch.match_coarse(T(i1), T(i2), TC.cost, TC.match, T(p1), T(p2))
    return (i1, p1), (i2, p2), fwd


def test_global_match_matches_jax(rng):
    (_, p1), (_, p2) = _level_pair(rng, 30, 40, -3, 2)
    d1 = jmatch.patch_descriptors(J(p1), JC.match)
    d2 = jmatch.patch_descriptors(J(p2), JC.match)
    # block 512 < 1200 targets: the running maximum across blocks
    want = jax.jit(lambda a, b: jmatch.global_match_xla(a, b, 512))(d1, d2)
    t1 = tmatch.patch_descriptors(T(p1), TC.match)
    t2 = tmatch.patch_descriptors(T(p2), TC.match)
    got = tmatch.global_match(t1, t2, 512)
    for g, w in zip(got, want):
        assert g.dtype == torch.int32
        assert (g.numpy() == np.asarray(w)).mean() >= 0.99
    # the forward half of the bidirectional sweep, exactly
    bidi = tmatch.global_match_bidi(t1, t2, 512)
    for g, b in zip(got, bidi[:2]):
        np.testing.assert_array_equal(g.numpy(), b.numpy())


def test_global_argmax_takes_the_first_maximum():
    """Kernel D's plain version: frame-2 rows 3 and 9 (in different
    blocks) tie exactly for frame-1 row 0; row 0 must take 3.  D = 275 as
    at the defaults; N2 = 13 is not a multiple of the block."""
    rng = np.random.default_rng(5)
    d2 = rng.normal(0, 0.3, (13, 275)).astype(np.float32)
    d2[9] = d2[3]
    d1 = np.stack([d2[3], d2[7], rng.normal(0, 0.3, 275)]).astype(np.float32)
    a = torch.from_numpy(d1).to(torch.bfloat16)
    b = torch.from_numpy(d2).to(torch.bfloat16)
    for block in (4, 8, 2048):
        got = cuda_match.global_argmax_auto(a, b, block)
        assert got.dtype == torch.int32
        assert got[:2].tolist() == [3, 7]
        scores = torch.round((a.double() @ b.double().T
                              - 0.5 * (b.double() ** 2).sum(1)) * 4096.0)
        assert got[2] == int(torch.argmax(scores[2]))
    with pytest.raises(ValueError, match="CUDA"):
        cuda_match.global_argmax_cuda(a, b)
    with pytest.raises(ValueError, match="unsupported device"):
        meta = torch.empty((3, 275), dtype=torch.bfloat16, device="meta")
        cuda_match.global_argmax_auto(meta, meta)


def test_match_coarse_matches_jax():
    """48x64 coarse level: one mini-pyramid level below it."""
    h, w = 48, 64
    (i1, p1), (i2, p2), (gx, gy, gc) = _coarse(h, w)
    want = jax.jit(lambda a, b, c, d: jmatch.match_coarse(
        a, b, JC.cost, JC.match, 25, c, d))(J(i1), J(i2), J(p1), J(p2))
    gx, gy = gx.numpy(), gy.numpy()
    wx, wy = np.asarray(want[0]), np.asarray(want[1])
    differ = (gx != wx) | (gy != wy)
    assert differ.mean() <= 0.02, differ.mean()
    if differ.any():
        np.testing.assert_array_equal(_exact_cost(p1, p2, gx, gy)[differ],
                                      _exact_cost(p1, p2, wx, wy)[differ])
    # the known shift, away from the borders
    ys, xs = np.mgrid[0:h, 0:w]
    inner = (slice(8, -8), slice(8, -8))
    assert ((gx - xs)[inner] == -4).mean() >= 0.9
    assert ((gy - ys)[inner] == 3).mean() >= 0.9
    assert gc.dtype == torch.float32 and gc.shape == (h, w)


@pytest.mark.parametrize("h,w", [(48, 64), (24, 40)])
def test_match_coarse_equals_the_bidirectional_halves(h, w):
    """Frames of one size: each direction of ``match_coarse_bidi`` is a
    ``match_coarse`` call (with and without a mini level), and so it is
    warm-started, the backward direction from the negated init (the warm
    start is ported: it no longer raises)."""
    (i1, p1), (i2, p2), fwd = _coarse(h, w)
    a, b = (T(i1), T(p1)), (T(i2), T(p2))
    bidi = tmatch.match_coarse_bidi(a[0], b[0], TC.cost, TC.match, a[1], b[1])
    bwd = tmatch.match_coarse(b[0], a[0], TC.cost, TC.match, b[1], a[1])
    for one, half in zip((fwd, bwd), bidi):
        for x, y in zip(one, half):
            np.testing.assert_array_equal(x.numpy(), y.numpy())
    init = torch.zeros((h, w, 2))
    init[..., 0], init[..., 1] = 2.0, -1.0
    bidi = tmatch.match_coarse_bidi(a[0], b[0], TC.cost, TC.match, a[1], b[1],
                                    init_flow=init)
    fwd = tmatch.match_coarse(a[0], b[0], TC.cost, TC.match, a[1], b[1],
                              init_flow=init)
    bwd = tmatch.match_coarse(b[0], a[0], TC.cost, TC.match, b[1], a[1],
                              init_flow=-init)
    for one, half in zip((fwd, bwd), bidi):
        for x, y in zip(one, half):
            np.testing.assert_array_equal(x.numpy(), y.numpy())
