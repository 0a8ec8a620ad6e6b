"""The whole default slice of the PyTorch port against
``eppm_tpu.pipeline.compute_flow_jit`` at 192x256: the coarse level is
48x64, with one mini-pyramid level below it, so the tiny-level global
match and the descent chain run.  Same contract and frames as
tests/test_torch_pipeline.py (kept apart so the two whole-pipeline
compiles of the JAX program land on different test workers)."""

import jax.numpy as jnp
import numpy as np
import torch

from eppm_tpu.pipeline import compute_flow_jit

from eppm_tpu_torch.ops.match import _mini_levels
from eppm_tpu_torch.config import DEFAULT_CONFIG
from eppm_tpu_torch.pipeline import compute_flow
from test_torch_pipeline import assert_contract, shifted_pair

# The suite runs several test processes per host: one torch thread each
# keeps them from oversubscribing the cores.
torch.set_num_threads(1)


def test_compute_flow_matches_jax_192x256():
    f1, f2 = shifted_pair(192, 256, 5, 3, seed=3)
    coarse = DEFAULT_CONFIG.pyramid.level_dims(192, 256)[-1]
    assert coarse == (48, 64)
    assert _mini_levels(*coarse, DEFAULT_CONFIG.match) == 1
    want = np.asarray(compute_flow_jit(jnp.asarray(f1), jnp.asarray(f2)))
    got = compute_flow(torch.from_numpy(f1), torch.from_numpy(f2)).numpy()
    assert_contract(got, want)
    inner = got[16:-16, 16:-16]
    assert np.abs(inner - [5.0, 3.0]).max(axis=-1).mean() < 0.5
