"""The whole pipeline with ``fine_level_wmf=True``, port against
``compute_flow_jit`` under the repo's contract (>= 98% of pixels within
1e-3, mean |diff| < 0.05; why it rests on the smoothing's summation
order: tests/test_torch_subpixel_flow.py).  The step itself is identical
to the JAX package's (tests/test_torch_legacy_wmf.py)."""

import torch

from test_torch_subpixel_flow import check_option_against_jax
from test_torch_warm import JCFG

torch.set_num_threads(1)


def test_pipeline_fine_level_wmf_matches_jax():
    check_option_against_jax(JCFG, fine_level_wmf=True)
