"""The subpixel stages of the PyTorch port against ``eppm_tpu``: the
B-spline sampler (max |diff| <= 1e-5), the 2x census (identical), the
quadratic-fit ``subpixel_refine`` and the parabola fit of
``dense_refine_flow`` (the repo's contract: >= 98% of pixels within 1e-3,
mean |diff| < 0.05), and the whole pipeline with ``dense_subpixel_fit``
(the same contract)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eppm_tpu.ops import dense as jdense
from eppm_tpu.ops import subpixel as jsub
from eppm_tpu.pipeline import compute_flow_jit

from eppm_tpu_torch import pipeline as tpipe
from eppm_tpu_torch.config import config_from_dict
from eppm_tpu_torch.ops import dense as tdense
from eppm_tpu_torch.ops import subpixel as tsub
from eppm_tpu_torch.ops.census import census_transform
from eppm_tpu_torch.ops.cost import pack_frame
from test_torch_pipeline import assert_contract, shifted_pair
from test_torch_warm import JCFG

torch.set_num_threads(1)

TCFG = config_from_dict(dataclasses.asdict(JCFG))


@pytest.mark.parametrize("a", [0.0, 0.25, 0.5, 0.9])
def test_bspline_weights_match_jax(a):
    assert tsub.bspline_weights(a) == jsub.bspline_weights(a)


@pytest.fixture(scope="module")
def image():
    return np.random.default_rng(10).random((40, 56, 3)).astype(np.float32)


@pytest.mark.parametrize("off", [(0.0, 0.0), (0.5, 0.0), (0.0, 0.5),
                                 (0.5, 0.5), (-1.5, 2.5)])
def test_bicubic_shift_matches_jax(image, off):
    want = np.asarray(jax.jit(lambda x: jsub.bicubic_shift(x, *off))(image))
    got = tsub.bicubic_shift(torch.from_numpy(image), *off).numpy()
    assert np.abs(got - want).max() <= 1e-5


def test_bicubic_resize2x_and_census_2x_match_jax(image):
    want = np.asarray(jax.jit(jsub.bicubic_resize2x)(image))
    got = tsub.bicubic_resize2x(torch.from_numpy(image)).numpy()
    assert got.shape == (80, 112, 3) and np.abs(got - want).max() <= 1e-5
    np.testing.assert_array_equal(
        tsub.census_2x(torch.from_numpy(image)).numpy(),
        np.asarray(jax.jit(jsub.census_2x)(image)))


def _integer_flow(h, w, dx, dy, seed):
    """The known shift with integer noise in [-1, 1] and an unknown
    block: what the last integer refine hands the subpixel stage."""
    rng = np.random.default_rng(seed)
    flow = np.zeros((h, w, 2), np.float32)
    flow[..., 0], flow[..., 1] = dx, dy
    flow += rng.integers(-1, 2, flow.shape).astype(np.float32)
    flow[3:6, 40:50] = 1e10
    return flow


def test_subpixel_refine_matches_jax():
    f1, f2 = shifted_pair(64, 96, 3, -2, seed=11)
    flow = _integer_flow(64, 96, 3, -2, seed=11)
    want = np.asarray(jax.jit(jsub.subpixel_refine)(flow, f1, f2))
    got = tsub.subpixel_refine(torch.from_numpy(flow), torch.from_numpy(f1),
                               torch.from_numpy(f2), TCFG.subpixel)
    assert (got.numpy() != flow).any(), "no pixel was refined"
    assert_contract(got.numpy(), want)


@pytest.mark.parametrize("min_curv", [0.0, 0.05])
def test_dense_refine_subpixel_fit_matches_jax(min_curv):
    f1, f2 = shifted_pair(64, 96, 3, -2, seed=12)
    packs = [pack_frame(torch.from_numpy(f), census_transform(
        torch.from_numpy(f))) for f in (f1, f2)]
    flow = _integer_flow(64, 96, 3, -2, seed=12)
    want = np.asarray(jax.jit(lambda f, a, b: jdense.dense_refine_flow(
        f, a, b, JCFG.pass2_cost, 1, False, 25, subpixel_fit=True,
        subpixel_min_curv=min_curv))(flow, *(p.numpy() for p in packs)))
    got = tdense.dense_refine_flow(torch.from_numpy(flow), *packs,
                                   TCFG.pass2_cost, 1, subpixel_fit=True,
                                   subpixel_min_curv=min_curv).numpy()
    assert (got != np.round(got)).any(), "no fractional offset"
    assert_contract(got, want)


def test_pipeline_dense_subpixel_fit_matches_jax():
    jc = dataclasses.replace(JCFG, dense_subpixel_fit=True)
    f1, f2 = shifted_pair(64, 96, 3, -2, seed=13)
    want = np.asarray(compute_flow_jit(jnp.asarray(f1), jnp.asarray(f2),
                                       None, jc))
    got = tpipe.compute_flow(torch.from_numpy(f1), torch.from_numpy(f2),
                             config_from_dict(dataclasses.asdict(jc)))
    assert_contract(got.numpy(), want)
