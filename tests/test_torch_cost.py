"""Kernel A's plain version (the residual patch cost), the exact-stage
cost and the dense refine pass of the PyTorch port against the JAX
package on the CPU.

Tolerance for the quantized costs (the repo's own rule for two
implementations of this cost, tests/test_cost.py): at most one 2^-17 step
apart, on fewer than 1% of the entries."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eppm_tpu.config import DEFAULT_CONFIG as JC
from eppm_tpu.ops import cost as jcost
from eppm_tpu.ops import dense as jdense
from eppm_tpu.ops.match import _make_mini_cost as j_mini_cost
from eppm_tpu.ops.pallas_cost import _residual_costs_sep

from eppm_tpu_torch.config import DEFAULT_CONFIG as TC
from eppm_tpu_torch.ops import cost as tcost
from eppm_tpu_torch.ops import cuda_cost
from eppm_tpu_torch.ops import dense as tdense
from eppm_tpu_torch.ops._util import exp_cephes, ftz
from eppm_tpu_torch.ops.census import census_transform
from eppm_tpu_torch.ops.match import _make_mini_cost as t_mini_cost

# The suite runs several test processes per host: one torch thread each
# keeps them from oversubscribing the cores.
torch.set_num_threads(1)

STEP = 2.0 ** -17


def T(a):
    return torch.from_numpy(np.array(a))


def _pair(rng, h, w):
    """Packs of a random frame and a noisy copy shifted by (1, -2)."""
    img1 = rng.random((h, w, 3)).astype(np.float32)
    img2 = np.roll(img1, (1, -2), (0, 1)) + rng.normal(0, 0.02, (h, w, 3))
    img2 = np.clip(img2, 0, 1).astype(np.float32)
    packs = []
    for img in (img1, img2):
        t = torch.from_numpy(img)
        packs.append(tcost.pack_frame(t, census_transform(t)).numpy())
    return packs


def sequential_cost(taps, center1, center2, gws, cfg, chunk):
    """sum(w * (c_ad + c_cen)) / max(sum(w), 1e-30) over the (p1, p2) tap
    pairs one tap at a time, in the gathered costs' arithmetic: every
    product rounded, each chunk's taps added in table order, the chunks'
    partial sums in chunk order (``ops/cost.py::_chunk_sums``)."""
    inv_lam_ad2, inv_lam_cen2, inv_sig_r2 = tcost.cost_constants(cfg)
    pairs = list(zip(taps, gws))
    cost_sum = weight_sum = 0.0
    for c0 in range(0, len(pairs), chunk):
        part_c = part_w = 0.0
        for (p1, p2), gw in pairs[c0 : c0 + chunk]:
            dr1 = tcost.maxabs3(center1, p1[..., :3])
            dr2 = tcost.maxabs3(center2, p2[..., :3])
            wgt = ftz(exp_cephes(-(dr1 * dr1 + dr2 * dr2) * inv_sig_r2) * gw)
            term = tcost.ad_census(p1, p2, inv_lam_ad2, inv_lam_cen2)
            part_c = part_c + wgt * term
            part_w = part_w + wgt
        cost_sum = cost_sum + part_c
        weight_sum = weight_sum + part_w
    return cost_sum / weight_sum.clamp_min(1e-30)


def _configs(name):
    return {
        "cost": (JC.cost, TC.cost),
        "pass2": (JC.pass2_cost, TC.pass2_cost),
        "mini": (j_mini_cost(JC.cost, JC.match),
                 t_mini_cost(TC.cost, TC.match)),
    }[name]


def _assert_costs_close(got, want):
    d = np.abs(got - want)
    assert d.max() <= STEP + 1e-9, d.max()
    assert (d > 0).mean() < 0.01, (d > 0).mean()


@pytest.mark.parametrize("radius,cfg_name,n_taps", [
    (0, "cost", 49),    # rescore: K = 1
    (1, "cost", 49),    # refine pass 1: K = 9
    (1, "pass2", 25),   # refine pass 2
    (3, "mini", 81),    # mini-level descent: K = 49
    (3, "cost", 49),    # coarse descent and polish
])
def test_residual_costs_match_jax(rng, radius, cfg_name, n_taps):
    jc, tc = _configs(cfg_name)
    assert len(tc.tap_offsets) == n_taps
    p1, p2 = _pair(rng, 30, 44)
    cands = jdense.center_out_offsets(radius)
    assert cands == tdense.center_out_offsets(radius)
    want = np.asarray(jax.jit(lambda a, b: jdense.residual_costs(
        a, b, cands, jc, False, 25))(jnp.asarray(p1), jnp.asarray(p2)))
    got = tdense.residual_costs(T(p1), T(p2), cands, tc).numpy()
    assert got.shape == (len(cands), 30, 44)
    _assert_costs_close(got, want)
    # the CPU dispatcher takes the plain version
    auto = cuda_cost.residual_costs_auto(T(p1), T(p2), cands, tc).numpy()
    np.testing.assert_array_equal(auto, got)


def test_residual_costs_match_pallas_kernel_interpret(rng):
    """Against the Pallas kernel itself, run in interpret mode."""
    p1, p2 = _pair(rng, 24, 40)
    cands = jdense.center_out_offsets(1)
    want = np.asarray(_residual_costs_sep(
        jnp.asarray(p1), jnp.asarray(p2), cands, JC.cost, interpret=True))
    got = tdense.residual_costs(T(p1), T(p2), cands, TC.cost).numpy()
    _assert_costs_close(got, want)


def test_residual_costs_multiwarp_match_jax(rng):
    """K = 5 separately warped frames, as propagate_dense scores them (the
    JAX package's oracle scores each at candidate (0, 0))."""
    p1, p2 = _pair(rng, 24, 36)
    stack = np.stack([np.roll(p2, (dy, dx), (0, 1))
                      for dy, dx in [(0, 0), (1, 0), (0, -1), (2, 1), (-1, 3)]])
    one = jax.jit(lambda a, b: jdense.residual_costs(
        a, b, [(0, 0)], JC.cost, False, 25)[0])
    want = np.stack([np.asarray(one(jnp.asarray(p1), jnp.asarray(s)))
                     for s in stack])
    got = tdense.residual_costs_multiwarp(T(p1), T(stack), TC.cost).numpy()
    _assert_costs_close(got, want)
    auto = cuda_cost.residual_costs_multiwarp_auto(T(p1), T(stack), TC.cost)
    np.testing.assert_array_equal(auto.numpy(), got)


def test_patch_cost_stack_matches_jax(rng):
    """The exact stage's gathered cost (bf16 stack, as the matcher uses)."""
    p1, p2 = _pair(rng, 20, 28)
    cfg_j = dataclasses.replace(JC.cost, patch_stride=JC.match.exact_tap_stride)
    cfg_t = dataclasses.replace(TC.cost, patch_stride=TC.match.exact_tap_stride)
    offs = cfg_j.tap_offsets
    tx = rng.integers(-2, 30, (3, 20, 28)).astype(np.int32)
    ty = rng.integers(-2, 22, (3, 20, 28)).astype(np.int32)
    want = np.asarray(jax.jit(lambda a, b, x, y: jcost.patch_cost_stack(
        a, jcost.make_patch_stack(b, offs, dtype=jnp.bfloat16), x, y, cfg_j,
        offs))(jnp.asarray(p1), jnp.asarray(p2), jnp.asarray(tx),
               jnp.asarray(ty)))
    got = tcost.patch_cost_stack(
        T(p1), tcost.make_patch_stack(T(p2), offs, dtype=torch.bfloat16),
        T(tx), T(ty), cfg_t, offs).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_warp_pack_and_median3_exact(rng):
    p1, p2 = _pair(rng, 18, 26)
    gx = rng.integers(-4, 5, (18, 26)).astype(np.int32)
    gy = rng.integers(-4, 5, (18, 26)).astype(np.int32)
    for dt_j, dt_t in [(None, None), (jnp.bfloat16, torch.bfloat16)]:
        want = np.asarray(jdense.warp_pack(jnp.asarray(p2), jnp.asarray(gx),
                                           jnp.asarray(gy), gather_dtype=dt_j))
        got = tdense.warp_pack(T(p2), T(gx), T(gy), dt_t).numpy()
        np.testing.assert_array_equal(got, want)
    f = rng.normal(0, 3, (18, 26, 2)).astype(np.float32)
    np.testing.assert_array_equal(
        tdense.median3_flow(T(f)).numpy(),
        np.asarray(jdense.median3_flow(jnp.asarray(f))))
    np.testing.assert_array_equal(
        tdense.median3(T(gx)).numpy(),
        np.asarray(jdense.median3(jnp.asarray(gx))))


@pytest.mark.parametrize("cfg_name", ["cost", "pass2"])
def test_dense_refine_flow_matches_jax(rng, cfg_name):
    jc, tc = _configs(cfg_name)
    p1, p2 = _pair(rng, 32, 48)
    flow = (rng.normal(0, 1.5, (32, 48, 2)) + [2.0, -1.0]).astype(np.float32)
    flow[3:6, 4:9] = 1e10  # unknown flow resets to 0
    want = np.asarray(jax.jit(lambda f, a, b: jdense.dense_refine_flow(
        f, a, b, jc, 1, False, 25))(jnp.asarray(flow), jnp.asarray(p1),
                                    jnp.asarray(p2)))
    got = tdense.dense_refine_flow(T(flow), T(p1), T(p2), tc).numpy()
    assert got.shape == want.shape
    assert (got == want).all(axis=-1).mean() >= 0.995
    np.testing.assert_array_equal(got[3:6, 4:9], 0.0)
