"""The benchmark of ``eppm_tpu_torch``, the PyTorch and CUDA port of EPPM
optical flow (``python3 -m flowbench.run``; see README.md).  Imports
neither ``jax`` nor ``eppm_tpu``."""
