"""The plane-hypothesis path of the PyTorch port against the JAX package
on the CPU: the plane tap tables, the plane form of kernel A's plain
version (``residual_costs(use_planes=True)``), the dense refine pass with
planes, and the gathered plane-fitting re-search of
``refine_impl="gather"`` (``patch_cost_planefitting``,
``blf_refine_flow``).

The JAX package's plane kernel (``pallas_cost.py::residual_costs_pallas``)
has no interpret mode; its oracle, ``ops/dense.py::residual_costs``, is
what its own tests hold it to, and so do these.  The plane form's
quantized costs are identical to the jitted oracle's (kernel A's plain
version sums in XLA's CPU arithmetic, ``ops/cost.py::bilateral_cost``)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eppm_tpu.config import DEFAULT_CONFIG as JC
from eppm_tpu.ops import cost as jcost
from eppm_tpu.ops import dense as jdense
from eppm_tpu.ops import refine as jrefine

from eppm_tpu_torch.config import DEFAULT_CONFIG as TC
from eppm_tpu_torch.ops import cost as tcost
from eppm_tpu_torch.ops import cuda_cost
from eppm_tpu_torch.ops import dense as tdense
from eppm_tpu_torch.ops import refine as trefine
from test_torch_cost import T, _pair

# The suite runs several test processes per host: one torch thread each
# keeps them from oversubscribing the cores.
torch.set_num_threads(1)


def _grids(name):
    """(JAX, port) cost configs: pass 1's 49-tap grid, pass 2's 25-tap
    grid, and the reference's stride-2 100-tap grid."""
    return {
        "cost": (JC.cost, TC.cost),
        "pass2": (JC.pass2_cost, TC.pass2_cost),
        "stride2": (dataclasses.replace(JC.cost, patch_stride=2),
                    dataclasses.replace(TC.cost, patch_stride=2)),
    }[name]


@pytest.mark.parametrize("name,n_taps,reach", [
    ("cost", 49, 15), ("pass2", 25, 13), ("stride2", 100, 15)])
def test_plane_offsets_equal_jax(name, n_taps, reach):
    jc, tc = _grids(name)
    got = tcost.plane_offsets(tc)
    assert got == jcost.plane_offsets(jc)
    assert len(got) == 4 and all(len(t) == n_taps for t in got)
    assert got[0] == tuple(tc.tap_offsets)
    # the warped frame-2 taps reach past the patch radius
    assert max(abs(v) for t in got for o in t for v in o) == reach


@pytest.mark.parametrize("name", ["cost", "pass2"])
def test_residual_costs_planes_match_jax(rng, name):
    jc, tc = _grids(name)
    p1, p2 = _pair(rng, 30, 44)
    cands = jdense.center_out_offsets(1)

    def jax_costs(planes):
        return np.asarray(jax.jit(lambda a, b: jdense.residual_costs(
            a, b, cands, jc, planes, 25))(jnp.asarray(p1), jnp.asarray(p2)))

    want = jax_costs(True)
    got = tdense.residual_costs(T(p1), T(p2), cands, tc,
                                use_planes=True).numpy()
    assert got.shape == (9, 30, 44)
    np.testing.assert_array_equal(got, want)
    # the least over the tables, against the fronto-only cost: below it
    # somewhere, and above it exactly where eppm_tpu's is above its own
    # (XLA sums the fronto table's weights in sequence in the plane
    # program, in lanes in the fronto-only one, so the two can part in
    # the last step)
    fronto = tdense.residual_costs(T(p1), T(p2), cands, tc).numpy()
    np.testing.assert_array_equal(got > fronto, want > jax_costs(False))
    assert (got < fronto).any()
    auto = cuda_cost.residual_costs_auto(T(p1), T(p2), cands, tc,
                                         use_planes=True).numpy()
    np.testing.assert_array_equal(auto, got)


def test_dense_refine_flow_planes_matches_jax(rng):
    p1, p2 = _pair(rng, 32, 48)
    flow = rng.normal(0, 2, (32, 48, 2)).astype(np.float32)
    flow[3:6, 10:14] = 1e10
    want = np.asarray(jax.jit(lambda f, a, b: jdense.dense_refine_flow(
        f, a, b, JC.cost, 1, True, 25))(
        jnp.asarray(flow), jnp.asarray(p1), jnp.asarray(p2)))
    got = tdense.dense_refine_flow(T(flow), T(p1), T(p2), TC.cost,
                                   use_planes=True).numpy()
    assert (got == want).all(axis=-1).mean() >= 0.99


def test_patch_cost_planefitting_matches_jax(rng):
    p1, p2 = _pair(rng, 28, 40)
    ys, xs = np.mgrid[0:28, 0:40]
    tx = (xs - 2 + rng.integers(-3, 4, (28, 40))).astype(np.int32)
    ty = (ys + 1 + rng.integers(-3, 4, (28, 40))).astype(np.int32)
    want = np.asarray(jax.jit(lambda a, b, x, y: jcost.patch_cost_planefitting(
        a, b, x, y, JC.cost, 25))(*map(jnp.asarray, (p1, p2, tx, ty))))
    got = tcost.patch_cost_planefitting(T(p1), T(p2), T(tx), T(ty),
                                        TC.cost).numpy()
    # unquantized: XLA's fusion may round one sum in a thousand one ulp
    # apart
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    one = tcost.patch_cost_offsets(T(p1), T(p2), T(tx), T(ty), TC.cost,
                                   TC.cost.tap_offsets).numpy()
    assert (got <= one).all()


def test_blf_refine_flow_matches_jax(rng):
    p1, p2 = _pair(rng, 30, 42)
    flow = rng.normal(0, 2, (30, 42, 2)).astype(np.float32)
    flow[4:7, 8:12] = 1e10
    flow[0, :5] = (-3.0, -2.0)  # candidates leave the frame
    want = np.asarray(jax.jit(lambda f, a, b: jrefine.blf_refine_flow(
        f, a, b, JC.cost, 25))(
        jnp.asarray(flow), jnp.asarray(p1), jnp.asarray(p2)))
    got = trefine.blf_refine_flow(T(flow), T(p1), T(p2), TC.cost).numpy()
    assert (got == want).all(axis=-1).mean() >= 0.99
    np.testing.assert_array_equal(got[4:7, 8:12], 0.0)
