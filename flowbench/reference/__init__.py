"""The benchmark's plain reference: a frozen copy of the port's plain
path, in plain PyTorch, that the comparison deciding ``correct`` holds
the port to.

The modules are copies of ``eppm_tpu_torch``'s ``config.py`` and of the
ops its eager ``compute_flow`` runs (``_util``, ``census``, ``cost``,
``dense``, ``match``, ``occlusion``, ``patchmatch``, ``prng``,
``refine``, ``resize``, ``subpixel``), with the dispatch to the CUDA
kernels taken out: every call runs the kernel's plain version, on the
card as on the CPU.  ``pipeline.compute_flow`` strings them together in
the port's stage order.  Nothing here imports ``jax``, ``eppm_tpu`` or
``eppm_tpu_torch``, and nothing takes a table, a key or a flow the port
made: the harness hands both sides the same frames and configuration.
Being a copy, it does not follow later changes to the port: a change
that moves the port's flow off this path shows as a failed comparison.
"""

from .config import config_from_dict
from .pipeline import compute_flow

__all__ = ["compute_flow", "config_from_dict"]
