"""The refine chain of the PyTorch port against the JAX package on the
CPU: integer stages exactly, kernel B's plain version (flow smoothing) to
1e-5, kernel C's plain version (weighted median) to < 0.5% of pixels
choosing another target."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eppm_tpu.config import DEFAULT_CONFIG as JC
from eppm_tpu.config import INVALID_LOCATION, UNKNOWN_FLOW
from eppm_tpu.config import RefineConfig as JRefine
from eppm_tpu.ops import pallas_wmf as jwmf
from eppm_tpu.ops import refine as jref
from eppm_tpu.ops.pallas_smooth import flow_smoothing_pallas

from eppm_tpu_torch.config import DEFAULT_CONFIG as TC
from eppm_tpu_torch.config import RefineConfig as TRefine
from eppm_tpu_torch.ops import cuda_smooth, cuda_wmf, occlusion
from eppm_tpu_torch.ops import refine as tref
from eppm_tpu_torch.ops.census import census_transform
from eppm_tpu_torch.ops.cost import pack_frame

# The suite runs several test processes per host: one torch thread each
# keeps them from oversubscribing the cores.
torch.set_num_threads(1)


def T(a):
    return torch.from_numpy(np.array(a))


def J(a):
    return jnp.asarray(np.asarray(a))


def _eq(got, want):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def _img(rng, h, w):
    small = rng.random((h // 4 + 2, w // 4 + 2, 3)).astype(np.float32)
    big = np.kron(small, np.ones((4, 4, 1), np.float32))[:h, :w]
    return np.clip(big + rng.normal(0, 0.01, big.shape), 0, 1).astype(
        np.float32)


def _targets(rng, h, w, hole_frac=0.15, block=True):
    """Absolute int32 targets of a smooth flow plus noise, with holes."""
    ys, xs = np.mgrid[0:h, 0:w]
    u = np.round(2 + 2 * np.sin(xs / 7.0)) + rng.integers(-1, 2, (h, w))
    v = np.round(-1 + np.cos(ys / 5.0)) + rng.integers(-1, 2, (h, w))
    tx = (xs + u).astype(np.int32)
    ty = (ys + v).astype(np.int32)
    holes = rng.random((h, w)) < hole_frac
    if block:
        holes[h // 3 : h // 2, w // 4 : w // 2] = True
    tx[holes] = INVALID_LOCATION
    ty[holes] = INVALID_LOCATION
    return tx, ty


def test_lr_check_exact(rng):
    h, w = 20, 30
    tx1, ty1 = _targets(rng, h, w, 0.05, block=False)
    tx2, ty2 = _targets(rng, h, w, 0.05, block=False)
    tx2 = np.where(rng.random((h, w)) < 0.5, np.mgrid[0:h, 0:w][1], tx2)
    c1 = rng.random((h, w)).astype(np.float32)
    c2 = rng.random((h, w)).astype(np.float32)
    args = (tx1, ty1, c1, tx2, ty2, c2)
    for thresh in (0, 1):
        want = jax.jit(lambda *a: jref.lr_check(*a, thresh))(
            *[J(a) for a in args])
        got = tref.lr_check(*[T(a) for a in args], thresh)
        for g, wnt in zip(got, want):
            _eq(g, wnt)


@pytest.mark.parametrize("variant", ["default", "collapse_guard",
                                     "proportional"])
def test_outlier_removal_exact(rng, variant):
    h, w = 24, 32
    if variant == "collapse_guard":
        # nearly every survivor culled by the fixed threshold: the guard
        # falls back to the proportional one
        tx, ty = _targets(rng, h, w, 0.6, block=False)
        tx = np.where(tx >= 0, tx + rng.integers(-3, 4, (h, w)), tx)
    else:
        tx, ty = _targets(rng, h, w, 0.1)
    cost = rng.random((h, w)).astype(np.float32)
    jc = JC.refine
    tc = TC.refine
    if variant == "proportional":
        jc = JRefine(stat_proportional=True)
        tc = TRefine(stat_proportional=True)
    want = jax.jit(lambda a, b, c: jref.outlier_removal(a, b, c, jc))(
        J(tx), J(ty), J(cost))
    got = tref.outlier_removal(T(tx), T(ty), T(cost), tc)
    for g, wnt in zip(got, want):
        _eq(g, wnt)


@pytest.mark.parametrize("patch_radius,baseline", [(0, 0), (1, 6)])
def test_fill_holes_exact(rng, patch_radius, baseline):
    h, w = 26, 34
    tx, ty = _targets(rng, h, w, 0.2)
    img = _img(rng, h, w)
    want = jax.jit(lambda a, b, c: jref.fill_holes(
        a, b, c, patch_radius=patch_radius, linear_baseline=baseline,
        return_candidates=True))(J(tx), J(ty), J(img))
    got = tref.fill_holes(T(tx), T(ty), T(img), patch_radius=patch_radius,
                          linear_baseline=baseline, return_candidates=True)
    _eq(got[0], want[0])
    _eq(got[1], want[1])
    for (gf, gx, gy), (wf, wx, wy) in zip(got[2], want[2]):
        _eq(gf, wf)
        _eq(gx, wx)
        _eq(gy, wy)


def test_nnf_flow_conversions_exact(rng):
    h, w = 12, 17
    tx, ty = _targets(rng, h, w, 0.2, block=False)
    _eq(tref.nnf_to_flow(T(tx), T(ty)), jref.nnf_to_flow(J(tx), J(ty)))
    flow = rng.normal(0, 4, (h, w, 2)).astype(np.float32)
    flow[2, 3] = UNKNOWN_FLOW
    for g, wnt in zip(tref.flow_to_nnf(T(flow)), jref.flow_to_nnf(J(flow))):
        _eq(g, wnt)


def _flow_with_unknowns(rng, h, w):
    flow = rng.normal(0, 3, (h, w, 2)).astype(np.float32)
    flow[rng.random((h, w)) < 0.1] = UNKNOWN_FLOW
    flow[:6, :8] = UNKNOWN_FLOW  # a corner whose windows hold no known flow
    return flow


def test_flow_smoothing_matches_jax_oracle(rng):
    h, w = 40, 56
    flow = _flow_with_unknowns(rng, h, w)
    img = _img(rng, h, w)
    want = np.asarray(jax.jit(lambda f, i: jref.flow_smoothing(
        f, i, JC.refine))(J(flow), J(img)))
    got = tref.flow_smoothing(T(flow), T(img), TC.refine).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    auto = cuda_smooth.flow_smoothing_auto(T(flow), T(img), TC.refine)
    _eq(auto, got)


def test_flow_smoothing_matches_pallas_kernel_interpret(rng):
    h, w = 24, 40
    flow = _flow_with_unknowns(rng, h, w)
    img = _img(rng, h, w)
    want = np.asarray(flow_smoothing_pallas(J(flow), J(img), JC.refine,
                                            interpret=True))
    got = tref.flow_smoothing(T(flow), T(img), TC.refine).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("mode", ["polish", "jacobi", "full"])
@pytest.mark.parametrize("dilation", [1, 2])
def test_weighted_median_filter_matches_jax(rng, mode, dilation):
    """The modes of kernel C's plain version, 3 iterations: the polish,
    Jacobi over the holes, and the full image (``only_occlusion=False``,
    ``refine.wmf_coarse_full_iters``)."""
    h, w = 28, 36
    tx, ty = _targets(rng, h, w, 0.2)
    img = _img(rng, h, w)
    kw = dict(num_iter=3, only_occlusion=mode != "full", dilation=dilation)
    if mode == "polish":
        fill = jref.fill_holes(J(tx), J(ty), J(img))
        jkw = dict(kw, polish_init=fill)
        tkw = dict(kw, polish_init=(T(fill[0]), T(fill[1])))
    else:
        jkw = tkw = kw
    want = jax.jit(lambda a, b, c: jref.weighted_median_filter(
        a, b, c, JC.refine, **jkw))(J(tx), J(ty), J(img))
    got = tref.weighted_median_filter(T(tx), T(ty), T(img), TC.refine, **tkw)
    differ = ((got[0].numpy() != np.asarray(want[0]))
              | (got[1].numpy() != np.asarray(want[1])))
    assert differ.mean() < 0.005, differ.mean()
    auto = cuda_wmf.weighted_median_filter_auto(T(tx), T(ty), T(img),
                                                TC.refine, **tkw)
    _eq(auto[0], got[0])
    _eq(auto[1], got[1])


def test_coarse_occlusion_reconstruct_exact(rng):
    """The default fill-first chain with photometric arbitration."""
    h, w = 30, 40
    img1 = _img(rng, h, w)
    img2 = np.roll(img1, (1, -2), (0, 1))
    packs = []
    for img in (img1, img2):
        t = T(img)
        packs.append(pack_frame(t, census_transform(t)).numpy())
    ys, xs = np.mgrid[0:h, 0:w]
    otx = (xs - 2 + rng.integers(-1, 2, (h, w))).astype(np.int32)
    oty = (ys + 1 + rng.integers(-1, 2, (h, w))).astype(np.int32)
    holes = rng.random((h, w)) < 0.2
    holes[10:20, 5:15] = True
    tx = np.where(holes, INVALID_LOCATION, otx).astype(np.int32)
    ty = np.where(holes, INVALID_LOCATION, oty).astype(np.int32)
    want = jax.jit(lambda a, b, c, p1, p2, o1, o2:
                   jwmf.coarse_occlusion_reconstruct(
                       a, b, c, JC.refine, packs=(p1, p2), cost_cfg=JC.cost,
                       orig=(o1, o2)))(
        J(tx), J(ty), J(img1), J(packs[0]), J(packs[1]), J(otx), J(oty))
    got = occlusion.coarse_occlusion_reconstruct(
        T(tx), T(ty), T(img1), TC.refine, packs=(T(packs[0]), T(packs[1])),
        cost_cfg=TC.cost, orig=(T(otx), T(oty)))
    _eq(got[0], want[0])
    _eq(got[1], want[1])
    assert (got[0].numpy() > INVALID_LOCATION // 2).all()
