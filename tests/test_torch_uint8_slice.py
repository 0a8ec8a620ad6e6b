"""The whole default slice of the PyTorch port on uint8 frames against
``eppm_tpu.pipeline.compute_flow_jit`` at 192x256 (coarse level 48x64,
one mini-pyramid level below it), under the contract of
tests/test_torch_pipeline.py; see tests/test_torch_uint8.py."""

import jax.numpy as jnp
import numpy as np
import torch

from eppm_tpu.pipeline import compute_flow_jit

from eppm_tpu_torch.pipeline import compute_flow
from test_torch_pipeline import assert_contract, shifted_pair

# The suite runs several test processes per host: one torch thread each
# keeps them from oversubscribing the cores.
torch.set_num_threads(1)


def test_compute_flow_uint8_matches_jax_192x256():
    f1, f2 = shifted_pair(192, 256, 5, 3, seed=3, uint8=True)
    want = np.asarray(compute_flow_jit(jnp.asarray(f1), jnp.asarray(f2)))
    got = compute_flow(torch.from_numpy(f1), torch.from_numpy(f2)).numpy()
    assert_contract(got, want)
