"""The temporal warm start of the PyTorch port against ``eppm_tpu``, part
2: the single-direction coarse matcher with ``init_flow`` (both
``warm_skip_global`` values; it runs kernel D on the card) and the whole
pipeline warm-started under ``warm_skip_global`` (the repo's contract: >=
98% of pixels within 1e-3, mean |diff| < 0.05).  Helpers and the rest:
tests/test_torch_warm.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import eppm_tpu.ops.match as jmatch
from eppm_tpu.pipeline import compute_flow_jit

from eppm_tpu_torch import pipeline as tpipe
from eppm_tpu_torch.ops import match as tmatch
from test_torch_pipeline import assert_contract
from test_torch_warm import (assert_direction_agrees, configs,  # noqa: F401
                             level, stream_pairs)

torch.set_num_threads(1)


@pytest.mark.parametrize("skip", [True, False])
def test_match_coarse_warm_start_matches_jax(level, skip):
    (a1, t1, p1), (a2, t2, p2), init = level
    jc, tc = configs(warm_skip_global=skip)
    want = jax.jit(lambda i1, i2, q1, q2, f: jmatch.match_coarse(
        i1, i2, jc.cost, jc.match, jc.cost_tap_chunk, q1, q2, init_flow=f))(
        a1, a2, p1.numpy(), p2.numpy(), init)
    got = tmatch.match_coarse(t1, t2, tc.cost, tc.match, p1, p2,
                              init_flow=torch.from_numpy(init))
    assert_direction_agrees(got, want, p1.numpy(), p2.numpy(), skip)


def test_pipeline_warm_start_matches_jax():
    f2, f3, init = stream_pairs()
    jc, tc = configs(warm_skip_global=True)
    want = np.asarray(compute_flow_jit(jnp.asarray(f2), jnp.asarray(f3),
                                       None, jc, init_flow=jnp.asarray(init)))
    got = tpipe.compute_flow(torch.from_numpy(f2), torch.from_numpy(f3), tc,
                             init_flow=torch.from_numpy(init))
    assert_contract(got.numpy(), want)
    inner = got.numpy()[16:-16, 16:-16]
    assert np.abs(inner - [3.0, -2.0]).max(axis=-1).mean() < 0.5
