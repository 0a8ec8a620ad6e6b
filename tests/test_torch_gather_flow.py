"""The PyTorch port with the gathered plane-fitting re-search
(``refine_impl="gather"``, the bit-faithful reference refine) against
``eppm_tpu.pipeline.compute_flow_jit`` with the same setting at 96x160,
under the contract of tests/test_torch_pipeline.py (kept apart so that
the whole-pipeline JAX compiles land on different test workers)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import torch

from eppm_tpu.config import DEFAULT_CONFIG as JC
from eppm_tpu.pipeline import compute_flow_jit

from eppm_tpu_torch.config import config_from_dict
from eppm_tpu_torch.pipeline import compute_flow
from test_torch_pipeline import assert_contract, shifted_pair

# The suite runs several test processes per host: one torch thread each
# keeps them from oversubscribing the cores.
torch.set_num_threads(1)


def test_compute_flow_gather_refine_matches_jax_96x160():
    jcfg = dataclasses.replace(JC, refine_impl="gather")
    tcfg = config_from_dict(dataclasses.asdict(jcfg))
    f1, f2 = shifted_pair(96, 160, -2, 3, seed=5)
    want = np.asarray(compute_flow_jit(jnp.asarray(f1), jnp.asarray(f2),
                                       cfg=jcfg))
    got = compute_flow(torch.from_numpy(f1), torch.from_numpy(f2),
                       tcfg).numpy()
    assert_contract(got, want)
    inner = got[16:-16, 16:-16]
    assert np.abs(inner - [-2.0, 3.0]).max(axis=-1).mean() < 0.5
