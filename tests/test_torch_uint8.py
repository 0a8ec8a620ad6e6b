"""The whole default slice of the PyTorch port on uint8 frames against
``eppm_tpu.pipeline.compute_flow_jit`` at 96x160, under the contract of
tests/test_torch_pipeline.py.  The JAX program reads the centre tap of
its first pre-smoothing pass from the raw uint8 frame with 1/255 folded
into the tap weight; the port reproduces that rounding
(``ops/resize.py::gaussian_filter(raw_u8=...)``).  Kept apart from the
other whole-pipeline comparisons so that their JAX compiles land on
different test workers."""

import jax.numpy as jnp
import numpy as np
import torch

from eppm_tpu.pipeline import compute_flow_jit

from eppm_tpu_torch.pipeline import compute_flow
from test_torch_pipeline import assert_contract, shifted_pair

# The suite runs several test processes per host: one torch thread each
# keeps them from oversubscribing the cores.
torch.set_num_threads(1)


def test_compute_flow_uint8_matches_jax_96x160():
    f1, f2 = shifted_pair(96, 160, 3, -2, seed=0, uint8=True)
    assert f1.dtype == np.uint8
    want = np.asarray(compute_flow_jit(jnp.asarray(f1), jnp.asarray(f2)))
    got = compute_flow(torch.from_numpy(f1), torch.from_numpy(f2)).numpy()
    assert_contract(got, want)
