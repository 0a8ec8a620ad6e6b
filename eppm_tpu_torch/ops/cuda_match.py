"""Kernel D — the streaming global descriptor argmax on CUDA
(``csrc/match.cu``).

Replaces ``eppm_tpu/ops/pallas_match.py::_match_kernel`` (wrapper
``global_argmax_pallas``): for every frame-1 descriptor row, the index of
the first frame-2 row maximising round((a.b - |b|^2/2) * 4096), without
the score panel.  Bound on the H100: float64 multiply-adds (N1 * N2 * D;
4.6e12 at the 4K depth-3 proposal grid).  Simple design: one thread per
frame-1 row, frame-2 rows streamed through shared memory, products and
sums in float64 so the result is exact and equals the plain version's bit
for bit (see the note in ``csrc/match.cu``).

The plain version is ``global_argmax`` (``ops/match.py``).
``global_argmax_auto`` takes the kernel for CUDA tensors at every size
(the JAX package's 200,000-target gate was the TPU's) and the plain
version for CPU tensors, and raises for anything else.
"""

from __future__ import annotations

import ctypes

import torch

from ._build import CudaKernel
from ._util import check_tensor, require_cuda
from .match import global_argmax

__all__ = ["KERNEL", "check_argmax_args", "global_argmax",
           "global_argmax_cuda", "global_argmax_auto"]

_P = ctypes.c_void_p
_I = ctypes.c_int
KERNEL = CudaKernel("eppm_global_argmax", [_P, _P, _P, _P, _I, _I, _I, _P])
MAX_D = 768


def check_argmax_args(d1: torch.Tensor, d2: torch.Tensor) -> None:
    """Raise unless kernel D takes these arguments: contiguous (N1, D) and
    (N2, D) bfloat16 rows, 1 <= D <= MAX_D, row counts within int32."""
    if d1.dim() != 2 or d2.dim() != 2:
        raise ValueError("descriptors must be (N, D) rows")
    n1, d = d1.shape
    n2 = d2.shape[0]
    check_tensor("d1", d1, torch.bfloat16, (n1, d), 2)
    check_tensor("d2", d2, torch.bfloat16, (n2, d), 2)
    if not 1 <= d <= MAX_D:
        raise ValueError(f"kernel D takes 1..{MAX_D} features, got {d}")
    if not (1 <= n1 < 2**31 and 1 <= n2 < 2**31):
        raise ValueError(f"kernel D takes 1..2^31-1 rows, got {n1}, {n2}")


def global_argmax_cuda(d1: torch.Tensor, d2: torch.Tensor) -> torch.Tensor:
    """Kernel D: same contract as ``global_argmax``."""
    require_cuda(d1, d2)
    check_argmax_args(d1, d2)
    n1, d = d1.shape
    n2 = d2.shape[0]
    half_norms = torch.empty((n2,), dtype=torch.float64, device=d1.device)
    out = torch.empty((n1,), dtype=torch.int32, device=d1.device)
    with torch.cuda.device(d1.device):
        KERNEL.launch(
            d1.data_ptr(), d2.data_ptr(), half_norms.data_ptr(),
            out.data_ptr(), n1, n2, d,
            torch.cuda.current_stream().cuda_stream,
        )
    return out


def global_argmax_auto(d1: torch.Tensor, d2: torch.Tensor,
                       block: int = 2048) -> torch.Tensor:
    """Kernel D for CUDA tensors, the plain version (frame-2 blocks of
    ``block``) for CPU tensors."""
    if d1.is_cuda:
        return global_argmax_cuda(d1, d2)
    if d1.device.type == "cpu":
        return global_argmax(d1, d2, block)
    raise ValueError(f"unsupported device {d1.device}")
