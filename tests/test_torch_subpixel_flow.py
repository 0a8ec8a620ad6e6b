"""The whole pipeline with ``subpixel_refine=True`` (and, in
tests/test_torch_fine_wmf_flow.py, with ``fine_level_wmf=True``), port
against ``compute_flow_jit``, under the repo's contract: >= 98% of pixels
within 1e-3, mean |diff| < 0.05.

Both stages truncate the smoothed flow directly (``flow_to_nnf``; the
subpixel stage's integer target), and on a translation the smoothed flow
is the shift to within the last bit.  So they hold the contract only
because the smoothing sums each chunk of taps in XLA's order
(``ops/refine.py::chunk_sum21``): with the earlier even/odd partials,
88-90% and 38-44% of the pixels agreed."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import torch

from eppm_tpu.pipeline import compute_flow_jit

from eppm_tpu_torch import pipeline as tpipe
from eppm_tpu_torch.config import config_from_dict
from test_torch_pipeline import assert_contract, shifted_pair
from test_torch_warm import JCFG

torch.set_num_threads(1)


def check_option_against_jax(jc, **kw):
    """The pipeline under ``jc`` (and ``kw``) against ``compute_flow_jit``
    on a (3, -2) shift at 64x96; the shift recovered away from the
    borders."""
    f1, f2 = shifted_pair(64, 96, 3, -2, seed=14)
    want = np.asarray(compute_flow_jit(jnp.asarray(f1), jnp.asarray(f2),
                                       None, jc, **kw))
    got = tpipe.compute_flow(torch.from_numpy(f1), torch.from_numpy(f2),
                             config_from_dict(dataclasses.asdict(jc)),
                             **kw).numpy()
    assert_contract(got, want)
    inner = got[12:-12, 12:-12]
    assert np.hypot(inner[..., 0] - 3, inner[..., 1] + 2).mean() < 1.0


def test_pipeline_subpixel_refine_matches_jax():
    check_option_against_jax(dataclasses.replace(JCFG, subpixel_refine=True))
