"""EPPM optical flow on PyTorch and CUDA — the port of ``eppm_tpu``.

The default pipeline of the JAX package (``eppm_tpu.pipeline.compute_flow``
under ``DEFAULT_CONFIG``) on PyTorch: plain tensor code is PyTorch, and
each Pallas kernel on that path is a hand-written CUDA kernel for Hopper
(``sm_90a``), built from ``csrc/`` with nvcc at first use.  Imports torch
and numpy only — never jax or ``eppm_tpu``.

    from eppm_tpu_torch.pipeline import compute_flow
    flow = compute_flow(img1.cuda(), img2.cuda())   # (H, W, 3) -> (H, W, 2)
"""

from .config import (
    DEFAULT_CONFIG,
    INVALID_LOCATION,
    UNKNOWN_FLOW,
    UNKNOWN_FLOW_THRESH,
    CostConfig,
    EPPMConfig,
    MatchConfig,
    PatchMatchConfig,
    PLANES_CONFIG,
    PyramidConfig,
    RefineConfig,
    UPSTREAM_CONFIG,
    config_fingerprint,
    config_from_dict,
)

__version__ = "0.1.0"
