"""The gathered costs of the PyTorch port (``eppm_tpu_torch/ops/
cost.py``): the chunked ``patch_cost_offsets`` against the per-tap loop
it replaced (identical), and ``patch_cost``, ``patch_cost_candidates``
and ``patch_cost_scaled`` against ``eppm_tpu/ops/cost.py`` on the CPU.

Unquantized costs are held to 1e-6, as tests/test_torch_planes.py holds
the gathered plane cost: XLA's fusion may round one sum in a thousand an
ulp apart.  The scaled cost's frame-2 taps are identical."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eppm_tpu.config import DEFAULT_CONFIG as JC
from eppm_tpu.ops import cost as jcost

from eppm_tpu_torch.config import DEFAULT_CONFIG as TC
from eppm_tpu_torch.ops import cost as tcost
from eppm_tpu_torch.ops._util import pad_edge
from test_torch_cost import T, _pair, sequential_cost

# The suite runs several test processes per host: one torch thread each
# keeps them from oversubscribing the cores.
torch.set_num_threads(1)


def per_tap_offsets(pack1, pack2, tx, ty, cfg, offsets2):
    """The gathered cost one tap at a time through ``sequential_cost``:
    ``patch_cost_offsets`` as it was before its taps were chunked, ~230
    torch ops a tap."""
    H, W = tx.shape[-2:]
    H2, W2 = pack2.shape[0], pack2.shape[1]
    R = cfg.patch_radius
    pad1 = pad_edge(pack1, R, R)
    flat2 = pack2.reshape(H2 * W2, 4)

    def at2(dy, dx):
        cy = (ty + dy).clamp(0, H2 - 1)
        cx = (tx + dx).clamp(0, W2 - 1)
        return flat2[(cy * W2 + cx).long()]

    taps1 = list(cfg.tap_offsets)
    pairs = ((pad1[R + i1 : R + i1 + H, R + j1 : R + j1 + W], at2(i2, j2))
             for (i1, j1), (i2, j2) in zip(taps1, offsets2))
    gws = [tcost.tap_weight(i1, j1, cfg.sigma_spatial) for (i1, j1) in taps1]
    return sequential_cost(pairs, pack1[..., :3], at2(0, 0)[..., :3], gws,
                           cfg, tcost.TAP_CHUNK)


def _targets(rng, shape, h, w, reach=3):
    """Absolute targets near a (2, -1) shift, some leaving the frame."""
    ys, xs = np.mgrid[0:h, 0:w]
    tx = xs + 2 + rng.integers(-reach, reach + 1, shape)
    ty = ys - 1 + rng.integers(-reach, reach + 1, shape)
    return tx.astype(np.int32), ty.astype(np.int32)


@pytest.mark.parametrize("k", [None, 6])
@pytest.mark.parametrize("table", range(4))
def test_chunked_cost_equals_per_tap_loop(rng, k, table):
    """Fronto (table 0) and each plane table, one field and K = 6: the
    chunked evaluation computes the per-tap loop's bits."""
    p1, p2 = _pair(rng, 30, 44)
    shape = (30, 44) if k is None else (k, 30, 44)
    tx, ty = _targets(rng, shape, 30, 44, reach=6)
    offs = tcost.plane_offsets(TC.cost)[table]
    got = tcost.patch_cost_offsets(T(p1), T(p2), T(tx), T(ty), TC.cost, offs)
    want = per_tap_offsets(T(p1), T(p2), T(tx), T(ty), TC.cost, offs)
    assert tuple(got.shape) == shape
    assert torch.equal(got, want)


@pytest.mark.parametrize("grid", ["cost", "stride2"])
def test_patch_cost_matches_jax(rng, grid):
    """The fronto cost of one field (49 taps, or the reference's stride-2
    grid of 100 taps: four chunks, the last one of 25) and of 6
    candidate fields in one pass."""
    jc, tc = JC.cost, TC.cost
    if grid == "stride2":
        jc = dataclasses.replace(jc, patch_stride=2)
        tc = dataclasses.replace(tc, patch_stride=2)
    p1, p2 = _pair(rng, 28, 40)
    tx, ty = _targets(rng, (28, 40), 28, 40)
    want = np.asarray(jax.jit(lambda a, b, x, y: jcost.patch_cost(
        a, b, x, y, jc, 25))(*map(jnp.asarray, (p1, p2, tx, ty))))
    got = tcost.patch_cost(T(p1), T(p2), T(tx), T(ty), tc).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    txs, tys = _targets(rng, (6, 28, 40), 28, 40)
    want = np.asarray(jax.jit(lambda a, b, x, y: jcost.patch_cost_candidates(
        a, b, x, y, jc, 25))(*map(jnp.asarray, (p1, p2, txs, tys))))
    got = tcost.patch_cost_candidates(T(p1), T(p2), T(txs), T(tys),
                                      tc).numpy()
    assert got.shape == (6, 28, 40)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_patch_cost_scaled_matches_jax(rng):
    """The scaled AD cost: its frame-2 tap offsets floor(d * scale) are
    XLA's (scales as the JAX package's compiled program makes them), its
    value within 1e-6, one field and 4 candidate fields."""
    p1, p2 = _pair(rng, 28, 40)
    r = rng.integers(0, 9, (4, 28, 40)).astype(np.int32)
    scale = np.asarray(jax.jit(
        lambda r: (10.0 + (r - 4).astype(jnp.float32)) / 10.0)(r))
    taps = TC.cost.tap_offsets
    want = jax.jit(lambda s: [jnp.stack([
        jnp.floor(jnp.float32(d[axis]) * s).astype(jnp.int32) for d in taps])
        for axis in (0, 1)])(scale)
    got = tcost.scaled_tap_offsets(taps, T(scale))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    txs, tys = _targets(rng, (4, 28, 40), 28, 40)
    jfn = jax.jit(jax.vmap(lambda a, b, x, y, s: jcost.patch_cost_scaled(
        a, b, x, y, s, JC.cost, 25), in_axes=(None, None, 0, 0, 0)))
    want = np.asarray(jfn(*map(jnp.asarray, (p1, p2, txs, tys, scale))))
    got = tcost.patch_cost_scaled(T(p1), T(p2), T(txs), T(tys), T(scale),
                                  TC.cost).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    one = tcost.patch_cost_scaled(T(p1), T(p2), T(txs[0]), T(tys[0]),
                                  T(scale[0]), TC.cost).numpy()
    np.testing.assert_array_equal(one, got[0])
