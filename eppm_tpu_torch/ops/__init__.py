"""Ops of the PyTorch port.  Plain PyTorch modules keep the JAX package's
names (``resize``, ``census``, ``cost``, ``dense``, ``refine``, ``match``);
``cuda_cost``, ``cuda_smooth`` and ``cuda_wmf`` wrap the hand-written
CUDA kernels A, B and C (sources in ``eppm_tpu_torch/csrc``); ``occlusion``
holds the coarse occlusion chain."""
