"""``EPPMConfig.cost_tap_chunk`` in the PyTorch port: every cost sums its
taps in partial sums of the configured chunk, as ``eppm_tpu`` does, and
the chunk changes the bits (49 against 25 moves 0.4% of the pixels of a
96x160 flow in the JAX package).

Tolerances: the gathered cost within 1e-6 of JAX's (tests/
test_torch_pm_cost.py's rule) and identical to the per-tap sums in the
same chunks; the dense cost at most one 2^-17 step apart on fewer than 1%
of entries (tests/test_torch_cost.py's rule); the whole flow within 1e-3
of ``compute_flow_jit`` on every pixel."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eppm_tpu.config import DEFAULT_CONFIG as JC
from eppm_tpu.ops import cost as jcost
from eppm_tpu.ops import dense as jdense
from eppm_tpu.pipeline import compute_flow_jit

from eppm_tpu_torch.config import DEFAULT_CONFIG as TC
from eppm_tpu_torch.ops import cost as tcost
from eppm_tpu_torch.ops import cuda_cost
from eppm_tpu_torch.ops import dense as tdense
from eppm_tpu_torch.ops._util import pad_edge
from eppm_tpu_torch.pipeline import compute_flow
from test_torch_cost import T, _assert_costs_close, _pair, sequential_cost
from test_torch_pipeline import shifted_pair

# The suite runs several test processes per host: one torch thread each
# keeps them from oversubscribing the cores.
torch.set_num_threads(1)

CHUNK = 49


def _per_tap(pack1, pack2, tx, ty, cfg, chunk):
    """The fronto gathered cost one tap at a time through
    ``sequential_cost`` in partial sums of ``chunk``."""
    H, W = tx.shape
    H2, W2 = pack2.shape[0], pack2.shape[1]
    R = cfg.patch_radius
    pad1 = pad_edge(pack1, R, R)
    flat2 = pack2.reshape(H2 * W2, 4)

    def at2(dy, dx):
        cy = (ty + dy).clamp(0, H2 - 1)
        cx = (tx + dx).clamp(0, W2 - 1)
        return flat2[(cy * W2 + cx).long()]

    taps = list(cfg.tap_offsets)
    pairs = ((pad1[R + i : R + i + H, R + j : R + j + W], at2(i, j))
             for i, j in taps)
    gws = [tcost.tap_weight(i, j, cfg.sigma_spatial) for i, j in taps]
    return sequential_cost(pairs, pack1[..., :3], at2(0, 0)[..., :3], gws,
                           cfg, chunk)


def test_gathered_cost_chunk_matches_jax(rng):
    """``patch_cost`` at chunk 49 against JAX's, and identical to the
    per-tap sums in chunks of 49; the 25-tap chunk of the default gives
    other bits on some pixels."""
    p1, p2 = _pair(rng, 30, 44)
    ys, xs = np.mgrid[0:30, 0:44]
    tx = (xs + 2 + rng.integers(-3, 4, (30, 44))).astype(np.int32)
    ty = (ys - 1 + rng.integers(-3, 4, (30, 44))).astype(np.int32)
    want = np.asarray(jax.jit(lambda a, b, x, y: jcost.patch_cost(
        a, b, x, y, JC.cost, CHUNK))(*(jnp.asarray(v)
                                       for v in (p1, p2, tx, ty))))
    got = tcost.patch_cost(T(p1), T(p2), T(tx), T(ty), TC.cost,
                           tap_chunk=CHUNK)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    assert torch.equal(got, _per_tap(T(p1), T(p2), T(tx), T(ty), TC.cost,
                                     CHUNK))
    default = tcost.patch_cost(T(p1), T(p2), T(tx), T(ty), TC.cost)
    assert not torch.equal(got, default)


@pytest.mark.parametrize("cfg_name", ["cost", "pass2"])
def test_residual_costs_chunk_matches_jax(rng, cfg_name):
    """The dense cost (kernel A's plain version) at chunk 49 on the 49-tap
    grid (one chunk) and the 25-tap grid (the reference pads it to one
    chunk of 49 with zero-weight taps)."""
    jc, tc = ((JC.cost, TC.cost) if cfg_name == "cost"
              else (JC.pass2_cost, TC.pass2_cost))
    p1, p2 = _pair(rng, 30, 44)
    cands = jdense.center_out_offsets(1)
    want = np.asarray(jax.jit(lambda a, b: jdense.residual_costs(
        a, b, cands, jc, False, CHUNK))(jnp.asarray(p1), jnp.asarray(p2)))
    got = cuda_cost.residual_costs_auto(T(p1), T(p2), cands, tc,
                                        tap_chunk=CHUNK).numpy()
    _assert_costs_close(got, want)
    plain = tdense.residual_costs(T(p1), T(p2), cands, tc, False, CHUNK)
    np.testing.assert_array_equal(got, plain.numpy())


def test_flow_chunk_matches_jax_96x160():
    """The whole pipeline under ``cost_tap_chunk=49`` against
    ``compute_flow_jit`` under the same setting: every pixel within
    1e-3."""
    f1, f2 = shifted_pair(96, 160, 3, -2, seed=4)
    jcfg = dataclasses.replace(JC, cost_tap_chunk=CHUNK)
    tcfg = dataclasses.replace(TC, cost_tap_chunk=CHUNK)
    want = np.asarray(compute_flow_jit(jnp.asarray(f1), jnp.asarray(f2),
                                       None, jcfg))
    got = compute_flow(torch.from_numpy(f1), torch.from_numpy(f2),
                       tcfg).numpy()
    d = np.abs(got - want).max(axis=-1)
    assert (d < 1e-3).all(), f"{(d >= 1e-3).mean():.2%} of pixels differ"
