"""Kernel A — the residual patch cost on CUDA (``csrc/cost.cu``).

Replaces ``eppm_tpu/ops/pallas_cost.py::_cost_kernel_sep`` (K candidate
offsets against one warped frame) and ``_cost_kernel`` in multiwarp mode
(candidate (0, 0) against K warped frames): both are one candidate table
``(cy, cx, frame)`` for the CUDA kernel.  Its plane mode replaces
``_cost_kernel`` with plane tables (``residual_costs_pallas(use_planes=
True)``): the least cost over the 4 plane-hypothesis frame-2 tap tables,
which travel in ``__constant__`` memory.  Bound on the H100: arithmetic
(three exps and ~30 other operations per candidate, pixel and tap; the
two float4 reads per tap hit L1/L2) — see the note in ``csrc/cost.cu``.
Simple design: one thread per (candidate, pixel), any tap table and any
candidate offset (no slab limit on |c|), tables passed by value.  The
kernel computes the plain version's operations in the plain version's
order, so the two agree bit for bit (``csrc/common.cuh``).

The plain versions are ``residual_costs`` (``use_planes`` False or True)
and ``residual_costs_multiwarp`` (``ops/dense.py``).  The ``*_auto``
dispatchers take the kernel for CUDA tensors and the plain version for
CPU tensors, and raise for anything else; nothing falls back.
"""

from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import numpy as np
import torch

from ..config import CostConfig
from ._build import CudaKernel
from ._util import check_tensor, require_cuda
from .cost import TAP_CHUNK, cost_constants, tap_weight
from .dense import cost_tables, residual_costs, residual_costs_multiwarp

__all__ = [
    "check_cost_args",
    "SINGLE",
    "MULTIWARP",
    "PLANES",
    "residual_costs",
    "residual_costs_multiwarp",
    "residual_costs_cuda",
    "residual_costs_planes_cuda",
    "residual_costs_multiwarp_cuda",
    "residual_costs_auto",
    "residual_costs_multiwarp_auto",
]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float

_ARGTYPES = [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _F, _F, _P]
# One kernel, two wrappers, each with its own launch count; the plane
# mode is the same kernel's other instance, with its own entry and count.
SINGLE = CudaKernel("eppm_residual_costs", _ARGTYPES)
MULTIWARP = CudaKernel("eppm_residual_costs", _ARGTYPES)
PLANES = CudaKernel("eppm_residual_costs_planes", _ARGTYPES[:-1] + [_P, _I, _P])

MAX_TAPS = 256
MAX_CANDS = 128
MAX_TABLES = 4


def check_cost_args(pack1, frames, n_frames: int, cands, cfg,
                    tables=None) -> None:
    """Raise unless kernel A takes these arguments: (H, W, 4) float32
    packs and frames read as float4, candidate and tap tables within the
    kernel's parameter tables, offsets within int16.  ``tables`` are the
    frame-2 tap tables of the plane mode (default: the frame-1 grid)."""
    h, w = pack1.shape[0], pack1.shape[1]
    check_tensor("pack1", pack1, torch.float32, (h, w, 4), 16)
    lead = (h, w) if frames.dim() == 3 else (n_frames, h, w)
    check_tensor("frames", frames, torch.float32, lead + (4,), 16)
    taps = list(cfg.tap_offsets)
    if not 1 <= len(cands) <= MAX_CANDS:
        raise ValueError(f"kernel A takes 1..{MAX_CANDS} candidates, "
                         f"got {len(cands)}")
    if not 1 <= len(taps) <= MAX_TAPS:
        raise ValueError(f"kernel A takes 1..{MAX_TAPS} taps, got {len(taps)}")
    tables = tables or [taps]
    if len(tables) > MAX_TABLES or any(len(t) != len(taps) for t in tables):
        raise ValueError(f"kernel A takes 1..{MAX_TABLES} frame-2 tap "
                         f"tables of {len(taps)} taps each")
    reach = max(abs(v) for c in cands for v in c[:2]) + max(
        abs(v) for tbl in tables for t in tbl for v in t)
    if reach >= 2**15:
        raise ValueError("kernel A takes offsets below 2^15")


def _launch(kernel, pack1, frames, cands, cfg: CostConfig,
            *tables) -> torch.Tensor:
    h, w = pack1.shape[0], pack1.shape[1]
    taps = list(cfg.tap_offsets)
    cand_arr = np.ascontiguousarray(cands, dtype=np.int32)
    tap_arr = np.ascontiguousarray(taps, dtype=np.int32)
    gws = np.asarray(
        [tap_weight(dy, dx, cfg.sigma_spatial) for (dy, dx) in taps],
        dtype=np.float32,
    )
    # plane mode: (n_tables, T, 2) int32 frame-2 tap tables
    extra = ()
    if tables:
        tab_arr = np.ascontiguousarray(tables, dtype=np.int32)
        extra = (tab_arr.ctypes.data, len(tables))
    out = torch.empty((len(cands), h, w), dtype=torch.float32,
                      device=pack1.device)
    with torch.cuda.device(pack1.device):
        stream = torch.cuda.current_stream().cuda_stream
        kernel.launch(
            pack1.data_ptr(), frames.data_ptr(), out.data_ptr(),
            cand_arr.ctypes.data, tap_arr.ctypes.data, gws.ctypes.data,
            len(cands), len(taps), TAP_CHUNK, h, w, *cost_constants(cfg),
            *extra, stream,
        )
    return out


def residual_costs_cuda(
    pack1: torch.Tensor,
    warped2: torch.Tensor,
    cand_offsets: Sequence[Tuple[int, int]],
    cfg: CostConfig,
) -> torch.Tensor:
    """Kernel A, single-frame mode: same contract as ``residual_costs``."""
    require_cuda(pack1, warped2)
    cands = [(cy, cx, 0) for (cy, cx) in cand_offsets]
    check_cost_args(pack1, warped2, 1, cands, cfg)
    return _launch(SINGLE, pack1, warped2, cands, cfg)


def residual_costs_planes_cuda(
    pack1: torch.Tensor,
    warped2: torch.Tensor,
    cand_offsets: Sequence[Tuple[int, int]],
    cfg: CostConfig,
) -> torch.Tensor:
    """Kernel A, plane mode: same contract as ``residual_costs(...,
    use_planes=True)``."""
    require_cuda(pack1, warped2)
    cands = [(cy, cx, 0) for (cy, cx) in cand_offsets]
    tables = cost_tables(cfg, True)
    check_cost_args(pack1, warped2, 1, cands, cfg, tables)
    return _launch(PLANES, pack1, warped2, cands, cfg, *tables)


def residual_costs_multiwarp_cuda(
    pack1: torch.Tensor, warped_stack: torch.Tensor, cfg: CostConfig
) -> torch.Tensor:
    """Kernel A, multiwarp mode: same contract as
    ``residual_costs_multiwarp``."""
    require_cuda(pack1, warped_stack)
    if warped_stack.dim() != 4:
        raise ValueError("warped_stack must be (K, H, W, 4)")
    k = warped_stack.shape[0]
    cands = [(0, 0, i) for i in range(k)]
    check_cost_args(pack1, warped_stack, k, cands, cfg)
    return _launch(MULTIWARP, pack1, warped_stack, cands, cfg)


def residual_costs_auto(pack1, warped2, cand_offsets, cfg: CostConfig,
                        use_planes: bool = False):
    """Kernel A (plane mode with ``use_planes``) for CUDA tensors, the
    plain version for CPU tensors."""
    if pack1.is_cuda:
        kernel = residual_costs_planes_cuda if use_planes else residual_costs_cuda
        return kernel(pack1, warped2, cand_offsets, cfg)
    if pack1.device.type == "cpu":
        return residual_costs(pack1, warped2, cand_offsets, cfg, use_planes)
    raise ValueError(f"unsupported device {pack1.device}")


def residual_costs_multiwarp_auto(pack1, warped_stack, cfg: CostConfig):
    """Kernel A (multiwarp) for CUDA tensors, the plain version for CPU
    tensors."""
    if pack1.is_cuda:
        return residual_costs_multiwarp_cuda(pack1, warped_stack, cfg)
    if pack1.device.type == "cpu":
        return residual_costs_multiwarp(pack1, warped_stack, cfg)
    raise ValueError(f"unsupported device {pack1.device}")
