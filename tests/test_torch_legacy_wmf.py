"""The legacy WMF order, the fine-level WMF step and the warm start
without ``warm_skip_global`` of the PyTorch port against ``eppm_tpu``:
the occlusion chain's and the step's integer targets identical, and the
whole pipeline under ``refine.wmf_fill_first=False`` and warm-started
with ``match.warm_skip_global=False`` within the repo's contract (>= 98% of
pixels within 1e-3, mean |diff| < 0.05)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from eppm_tpu.ops import refine as jrefine
from eppm_tpu.ops.pallas_wmf import (coarse_occlusion_reconstruct as
                                     j_reconstruct,
                                     weighted_median_filter_auto as j_wmf)
from eppm_tpu.pipeline import compute_flow_jit

from eppm_tpu_torch import pipeline as tpipe
from eppm_tpu_torch.config import INVALID_LOCATION, config_from_dict
from eppm_tpu_torch.ops import refine as trefine
from eppm_tpu_torch.ops.cuda_wmf import weighted_median_filter_auto
from eppm_tpu_torch.ops.occlusion import coarse_occlusion_reconstruct
from test_torch_pipeline import assert_contract, shifted_pair
from test_torch_warm import JCFG, configs, stream_pairs

torch.set_num_threads(1)

LEGACY = dataclasses.replace(JCFG, refine=dataclasses.replace(
    JCFG.refine, wmf_fill_first=False))


def test_legacy_occlusion_order_matches_jax():
    """``wmf_coarse_iters`` occlusion-only Jacobi iterations, then the
    hole fill, on a coarse level with 20% holes and a block of them."""
    rng = np.random.default_rng(7)
    h, w = 40, 56
    ys, xs = np.mgrid[0:h, 0:w]
    tx = (xs + 3 + rng.integers(-1, 2, (h, w))).astype(np.int32)
    ty = (ys - 2 + rng.integers(-1, 2, (h, w))).astype(np.int32)
    holes = rng.random((h, w)) < 0.2
    holes[10:22, 15:30] = True
    tx[holes] = INVALID_LOCATION
    ty[holes] = INVALID_LOCATION
    img = shifted_pair(h, w, 0, 0, seed=7)[0]
    want = jax.jit(lambda a, b, c: j_reconstruct(a, b, c, LEGACY.refine))(
        tx, ty, img)
    tcfg = config_from_dict(dataclasses.asdict(LEGACY))
    got = coarse_occlusion_reconstruct(torch.from_numpy(tx),
                                       torch.from_numpy(ty),
                                       torch.from_numpy(img), tcfg.refine)
    for g, wnt in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(wnt))


def test_fine_level_wmf_step_matches_jax():
    """flow_to_nnf -> one full-image WMF iteration -> nnf_to_flow on a
    fractional flow with an unknown block, guided by a level image."""
    rng = np.random.default_rng(8)
    h, w = 48, 64
    flow = rng.normal(0, 3, (h, w, 2)).astype(np.float32)
    flow[5:9, 7:15] = 1e10
    img = shifted_pair(h, w, 0, 0, seed=8)[0]

    def jstep(f, i):
        a, b = jrefine.flow_to_nnf(f)
        a, b = j_wmf(a, b, i, JCFG.refine, num_iter=1, only_occlusion=False)
        return a, b, jrefine.nnf_to_flow(a, b)

    want = jax.jit(jstep)(flow, img)
    tcfg = config_from_dict(dataclasses.asdict(JCFG))
    a, b = trefine.flow_to_nnf(torch.from_numpy(flow))
    a, b = weighted_median_filter_auto(a, b, torch.from_numpy(img),
                                       tcfg.refine, num_iter=1,
                                       only_occlusion=False)
    for g, wnt in zip((a, b, trefine.nnf_to_flow(a, b)), want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(wnt))


def test_pipeline_legacy_wmf_order_matches_jax():
    f1, f2 = shifted_pair(64, 96, 3, -2, seed=9)
    want = np.asarray(compute_flow_jit(jnp.asarray(f1), jnp.asarray(f2),
                                       None, LEGACY))
    got = tpipe.compute_flow(torch.from_numpy(f1), torch.from_numpy(f2),
                             config_from_dict(dataclasses.asdict(LEGACY)))
    assert_contract(got.numpy(), want)


def test_pipeline_warm_start_without_skip_matches_jax():
    """The init merged as a proposal beside the global stages."""
    f2, f3, init = stream_pairs()
    jc, tc = configs(warm_skip_global=False)
    want = np.asarray(compute_flow_jit(jnp.asarray(f2), jnp.asarray(f3),
                                       None, jc, init_flow=jnp.asarray(init)))
    got = tpipe.compute_flow(torch.from_numpy(f2), torch.from_numpy(f3), tc,
                             init_flow=torch.from_numpy(init))
    assert_contract(got.numpy(), want)
