"""Kernel B — joint bilateral flow smoothing on CUDA (``csrc/smooth.cu``).

Replaces ``eppm_tpu/ops/pallas_smooth.py::_smooth_kernel``.  Bound on the
H100: the exp of each range weight (a float32 polynomial rounded through
float64, ``csrc/common.cuh``).  Two kernels compute the plain version's
operations in its order, so both agree with it bit for bit:

- ``PAIRED`` (``flow_smooth_pair_kernel``), where a partial sum of
  ``SMOOTH_CHUNK`` taps is one row of the window (2r + 1 == 21, the
  default radius 10): the range weight is symmetric bit for bit, so each
  unordered pixel pair's weight is computed once in a shared-memory tile
  and serves both pixels, ~299 exps a pixel instead of 441;
- ``KERNEL`` (``flow_smooth_kernel``), every other radius: one thread per
  pixel walking its window, one exp per tap.

The plain version is ``flow_smoothing`` (``ops/refine.py``);
``flow_smoothing_auto`` takes a kernel for CUDA tensors and the plain
version for CPU tensors, and raises otherwise.
"""

from __future__ import annotations

import ctypes

import torch

from ..config import RefineConfig
from ._build import CudaKernel
from ._util import check_tensor, inv32, require_cuda
from .refine import SMOOTH_CHUNK, flow_smoothing, smoothing_weights

__all__ = ["KERNEL", "PAIRED", "check_smooth_args", "flow_smoothing",
           "flow_smoothing_cuda", "flow_smoothing_auto"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGS = [_P, _P, _P, _P, _I, _I, _I, _I, ctypes.c_float, _P]
KERNEL = CudaKernel("eppm_flow_smoothing", _ARGS)
PAIRED = CudaKernel("eppm_flow_smoothing_paired", _ARGS)
MAX_RADIUS = 15


def check_smooth_args(flow, img, cfg: RefineConfig) -> None:
    """Raise unless kernel B takes these arguments: (H, W, 2) float32 flow
    read as float2, (H, W, 3) float32 image, a radius within its table."""
    h, w = flow.shape[0], flow.shape[1]
    check_tensor("flow", flow, torch.float32, (h, w, 2), 8)
    check_tensor("img", img, torch.float32, (h, w, 3))
    if not 0 <= cfg.blf_radius <= MAX_RADIUS:
        raise ValueError(f"kernel B takes radius 0..{MAX_RADIUS}, got "
                         f"{cfg.blf_radius}")


def flow_smoothing_cuda(
    flow: torch.Tensor, img: torch.Tensor, cfg: RefineConfig = RefineConfig()
) -> torch.Tensor:
    """Kernel B: same contract as ``flow_smoothing``.  The paired kernel
    where 2r + 1 == ``SMOOTH_CHUNK``, the one-pass kernel otherwise; a
    refused launch raises."""
    require_cuda(flow, img)
    check_smooth_args(flow, img, cfg)
    h, w, r = flow.shape[0], flow.shape[1], cfg.blf_radius
    kernel = PAIRED if 2 * r + 1 == SMOOTH_CHUNK else KERNEL
    g = smoothing_weights(cfg)
    out = torch.empty_like(flow)
    with torch.cuda.device(flow.device):
        kernel.launch(
            flow.data_ptr(), img.data_ptr(), out.data_ptr(), g.ctypes.data,
            r, SMOOTH_CHUNK, h, w, inv32(cfg.blf_sigma_range**2),
            torch.cuda.current_stream().cuda_stream,
        )
    return out


def flow_smoothing_auto(flow, img, cfg: RefineConfig = RefineConfig()):
    """Kernel B for CUDA tensors, the plain version for CPU tensors."""
    if flow.is_cuda:
        return flow_smoothing_cuda(flow, img, cfg)
    if flow.device.type == "cpu":
        return flow_smoothing(flow, img, cfg)
    raise ValueError(f"unsupported device {flow.device}")
