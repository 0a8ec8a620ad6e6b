"""The port's stage profilers, counterparts of the JAX package's (each
module keeps its counterpart's name).  Both read the tracer
(``utils/trace.py``): each stage is a span of a traced CUDA graph replay.

* ``profile_stages``: the time of each stage of ``compute_flow``
  (``profile_stages.py``);
* ``profile_match``: the sub-stages of the coarse matcher
  (``tools/profile_match.py``).

    python -m eppm_tpu_torch.bench.<name> [HxW] [--device cuda|cpu]
        [--seed N]

They run on the CUDA device and exit non-zero without one; ``--device
cpu`` runs the kernels' plain versions and prints the stages' names and
shapes but no time.  Their pairs are synthetic (``eppm_tpu_torch.
testing``), made from ``--seed``.  ``_timing.py`` holds what they share.
The port's end-to-end figures are the benchmark's (``flowbench``).
"""
