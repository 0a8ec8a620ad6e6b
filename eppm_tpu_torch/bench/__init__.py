"""The port's measurement programs, counterparts of the JAX package's
(each module keeps its counterpart's name):

* ``bench``: the headline line, streaming pairs a second at 640x480
  behind two quality gates, and the 1080p device time (``bench.py``);
* ``bench_table``: e2e and device ms at 640x480, 1242x375, 1080p and 4K,
  with each shape's CUDA graph (``tools/bench_table.py``);
* ``profile_stages``: the time of each stage of ``compute_flow``
  (``profile_stages.py``);
* ``profile_match``: the sub-stages of the coarse matcher
  (``tools/profile_match.py``);
* ``stream_bench``: ``--frames-dir`` throughput, cold against
  ``--temporal`` (``tools/stream_bench.py``).

    python -m eppm_tpu_torch.bench.<name> [--device cuda|cpu] [--seed N]

They run on the CUDA device and exit non-zero without one; ``--device
cpu`` runs the kernels' plain versions and prints the gates but no time
or rate.  Their pairs are synthetic (``eppm_tpu_torch.testing``), made
from ``--seed``.  ``_timing.py`` holds what they share.
"""
