"""Kernel A — the residual patch cost on CUDA (``csrc/cost.cu``).

Replaces ``eppm_tpu/ops/pallas_cost.py::_cost_kernel_sep`` (K candidate
offsets against one warped frame) and ``_cost_kernel`` in multiwarp mode
(candidate (0, 0) against K warped frames): both are one candidate table
``(cy, cx, frame)`` for the CUDA kernel.  Its plane mode replaces
``_cost_kernel`` with plane tables (``residual_costs_pallas(use_planes=
True)``): the least cost over the 4 plane-hypothesis frame-2 tap tables.
Bound on the H100: the float64 conversions of its exps — see the note in
``csrc/cost.cu``.  Two passes per call: the AD + census term once per
shifted pixel (``cost_terms_cuda``, plain version ``ops/dense.py::
cost_terms``), then the weighted sums, which look the term up through the
map-index table of ``cost_plan``.  The kernel computes the plain
version's operations on the same operands in the same order, so the two
agree bit for bit (``csrc/common.cuh``).

The plain versions are ``residual_costs`` (``use_planes`` False or True)
and ``residual_costs_multiwarp`` (``ops/dense.py``).  The ``*_auto``
dispatchers take the kernel for CUDA tensors and the plain version for
CPU tensors, and raise for anything else; nothing falls back.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Sequence, Tuple

import numpy as np
import torch

from ..config import CostConfig
from ._build import CudaKernel
from ._util import check_tensor, require_cuda
from .cost import TAP_CHUNK, cost_constants, tap_weight
from .dense import (_reach, cost_tables, cost_terms, residual_costs,
                    residual_costs_multiwarp)

__all__ = [
    "check_cost_args",
    "CostPlan",
    "cost_plan",
    "SINGLE",
    "MULTIWARP",
    "PLANES",
    "TERMS",
    "cost_terms",
    "cost_terms_cuda",
    "cost_sums_cuda",
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

# The weighted sums: one entry, a launch count per mode (one launch per
# wrapper call); the terms pass has its own entry and count.
_MAIN_ARGS = [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
              _F, _P]
SINGLE = CudaKernel("eppm_residual_costs", _MAIN_ARGS)
MULTIWARP = CudaKernel("eppm_residual_costs", _MAIN_ARGS)
PLANES = CudaKernel("eppm_residual_costs", _MAIN_ARGS)
TERMS = CudaKernel("eppm_cost_terms",
                   [_P, _P, _P, _P, _I, _I, _I, _I, _F, _F, _P])

MAX_TAPS = 256
MAX_CANDS = 128
MAX_TABLES = 4
MAX_MAPS = 65535


class CostPlan(NamedTuple):
    """The tables of one kernel-A call: ``taps2`` (B, T, 2) the frame-2
    taps of each table, ``map_of`` (K, B, T) the map each (candidate,
    table, tap) reads its term from, ``maps`` (M, 3) each map's (frame,
    sy, sx).  All int32."""

    taps2: np.ndarray
    map_of: np.ndarray
    maps: np.ndarray


def cost_plan(cands, taps, tables) -> CostPlan:
    """The shift set of candidates ``cands`` (K rows (cy, cx, frame)),
    frame-1 taps ``taps`` (T rows (dy, dx)) and frame-2 tap tables
    ``tables`` (B tables of T (ey, ex)): tap t of table b for candidate k
    reads its AD + census term from map (frame_k, c_k + e_b(t) - d_t)
    (``cost_terms``).  The maps are the distinct such triples, sorted."""
    c = np.asarray(cands, np.int64).reshape(-1, 3)
    d = np.asarray(taps, np.int64).reshape(-1, 2)
    e = np.asarray(tables, np.int64).reshape(len(tables), -1, 2)
    s = c[:, None, None, :2] + e[None] - d[None, None]           # (K, B, T, 2)
    f = np.broadcast_to(c[:, None, None, 2:], s.shape[:3] + (1,))
    keys = np.concatenate([f, s], axis=-1).reshape(-1, 3)
    maps, map_of = np.unique(keys, axis=0, return_inverse=True)
    return CostPlan(e.astype(np.int32),
                    map_of.reshape(s.shape[:3]).astype(np.int32),
                    maps.astype(np.int32))


def _rows(rows) -> tuple:
    return tuple(map(tuple, rows))


class _CallTables(NamedTuple):
    plan: CostPlan
    cands: np.ndarray     # (K, 3) int32, host
    taps: np.ndarray      # (T, 2) int32, host
    gws: np.ndarray       # (T,) float32 spatial weights, host
    maps: torch.Tensor    # plan.maps, on the device
    sums: torch.Tensor    # plan.taps2 then plan.map_of, on the device


@functools.lru_cache(maxsize=None)
def _call_tables(cands: tuple, taps: tuple, tables: tuple, sigma: float,
                 device: torch.device) -> _CallTables:
    """The tables of a kernel-A call, on the host and on the device, made
    once per distinct set (the port calls kernel A with a handful) and
    never freed: the device copies stay in place for every launch that
    reads them, on any stream, and a call copies nothing to the card."""
    plan = cost_plan(cands, taps, tables)
    gws = np.asarray([tap_weight(dy, dx, sigma) for (dy, dx) in taps],
                     dtype=np.float32)

    def on_device(*arrays):
        host = np.concatenate([a.ravel() for a in arrays])
        return torch.from_numpy(host).to(device)

    return _CallTables(plan, np.asarray(cands, np.int32),
                       np.asarray(taps, np.int32), gws, on_device(plan.maps),
                       on_device(plan.taps2, plan.map_of))


def _tables_of(pack1, cands, cfg: CostConfig, tables) -> _CallTables:
    return _call_tables(_rows(cands), _rows(cfg.tap_offsets),
                        tuple(_rows(t) for t in tables),
                        float(cfg.sigma_spatial), pack1.device)


def _check_packs(pack1, frames, n_frames: int) -> None:
    h, w = pack1.shape[0], pack1.shape[1]
    check_tensor("pack1", pack1, torch.float32, (h, w, 4), 16)
    lead = (h, w) if frames.dim() == 3 else (n_frames, h, w)
    check_tensor("frames", frames, torch.float32, lead + (4,), 16)


def check_cost_args(pack1, frames, n_frames: int, cands, cfg,
                    tables=None) -> None:
    """Raise unless kernel A takes these arguments: (H, W, 4) float32
    packs and frames read as float4, candidate and tap tables within the
    kernel's parameter tables, offsets within int16.  ``tables`` are the
    frame-2 tap tables of the plane mode (default: the frame-1 grid)."""
    _check_packs(pack1, frames, n_frames)
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


def _checked_tables(pack1, frames, cands, cfg: CostConfig,
                    tables) -> _CallTables:
    """The call's tables, once the packs lie on the card in the layout the
    kernel reads and every map's frame is one of ``frames``."""
    require_cuda(pack1, frames)
    n_frames = 1 if frames.dim() == 3 else frames.shape[0]
    _check_packs(pack1, frames, n_frames)
    ct = _tables_of(pack1, cands, cfg, tables)
    maps = ct.plan.maps
    if not 1 <= len(maps) <= MAX_MAPS or not (
            (maps[:, 0] >= 0) & (maps[:, 0] < n_frames)).all():
        raise ValueError(f"kernel A takes 1..{MAX_MAPS} maps of frames "
                         f"0..{n_frames - 1}")
    return ct


def cost_terms_cuda(pack1: torch.Tensor, frames: torch.Tensor, cands,
                    cfg: CostConfig, tables) -> torch.Tensor:
    """Kernel A's terms pass: the terms of the maps of ``cost_plan(cands,
    cfg.tap_offsets, tables)``, as ``cost_terms`` computes them with
    R = the taps' reach -> (M, H+2R, W+2R).  ``cands`` are (cy, cx,
    frame) rows, ``frames`` (H, W, 4) or (F, H, W, 4)."""
    ct = _checked_tables(pack1, frames, cands, cfg, tables)
    maps = ct.plan.maps
    h, w = pack1.shape[0], pack1.shape[1]
    reach = _reach(cfg.tap_offsets)
    inv_lam_ad2, inv_lam_cen2, _ = cost_constants(cfg)
    terms = torch.empty((len(maps), h + 2 * reach, w + 2 * reach),
                        dtype=torch.float32, device=pack1.device)
    with torch.cuda.device(pack1.device):
        TERMS.launch(pack1.data_ptr(), frames.data_ptr(), ct.maps.data_ptr(),
                     terms.data_ptr(), len(maps), h, w, reach, inv_lam_ad2,
                     inv_lam_cen2, torch.cuda.current_stream().cuda_stream)
    return terms


def cost_sums_cuda(kernel: CudaKernel, pack1, frames, terms, cands,
                   cfg: CostConfig, tables, tap_chunk: int = TAP_CHUNK
                   ) -> torch.Tensor:
    """Kernel A's second pass, counted on ``kernel``: the weighted sums
    over the terms of ``cost_terms_cuda`` (same arguments), in partial
    sums of ``tap_chunk`` taps -> (K, H, W), the least over the
    tables."""
    ct = _checked_tables(pack1, frames, cands, cfg, tables)
    require_cuda(pack1, terms)
    h, w = pack1.shape[0], pack1.shape[1]
    reach = _reach(cfg.tap_offsets)
    check_tensor("terms", terms, torch.float32,
                 (len(ct.plan.maps), h + 2 * reach, w + 2 * reach))
    out = torch.empty((len(cands), h, w), dtype=torch.float32,
                      device=pack1.device)
    with torch.cuda.device(pack1.device):
        kernel.launch(
            pack1.data_ptr(), frames.data_ptr(), terms.data_ptr(),
            ct.sums.data_ptr(), out.data_ptr(), ct.cands.ctypes.data,
            ct.taps.ctypes.data, ct.gws.ctypes.data, len(cands), len(ct.taps),
            len(ct.plan.taps2), tap_chunk, reach, h, w,
            cost_constants(cfg)[2], torch.cuda.current_stream().cuda_stream,
        )
    return out


def _launch(kernel, pack1, frames, cands, cfg: CostConfig, tables,
            tap_chunk: int) -> torch.Tensor:
    if tap_chunk < 1:
        raise ValueError(f"kernel A takes a tap chunk >= 1, got {tap_chunk}")
    terms = cost_terms_cuda(pack1, frames, cands, cfg, tables)
    return cost_sums_cuda(kernel, pack1, frames, terms, cands, cfg, tables,
                          tap_chunk)


def residual_costs_cuda(
    pack1: torch.Tensor,
    warped2: torch.Tensor,
    cand_offsets: Sequence[Tuple[int, int]],
    cfg: CostConfig,
    tap_chunk: int = TAP_CHUNK,
) -> torch.Tensor:
    """Kernel A, single-frame mode: same contract as ``residual_costs``."""
    require_cuda(pack1, warped2)
    cands = [(cy, cx, 0) for (cy, cx) in cand_offsets]
    check_cost_args(pack1, warped2, 1, cands, cfg)
    return _launch(SINGLE, pack1, warped2, cands, cfg, cost_tables(cfg, False),
                   tap_chunk)


def residual_costs_planes_cuda(
    pack1: torch.Tensor,
    warped2: torch.Tensor,
    cand_offsets: Sequence[Tuple[int, int]],
    cfg: CostConfig,
    tap_chunk: int = TAP_CHUNK,
) -> torch.Tensor:
    """Kernel A, plane mode: same contract as ``residual_costs(...,
    use_planes=True)``."""
    require_cuda(pack1, warped2)
    cands = [(cy, cx, 0) for (cy, cx) in cand_offsets]
    tables = cost_tables(cfg, True)
    check_cost_args(pack1, warped2, 1, cands, cfg, tables)
    return _launch(PLANES, pack1, warped2, cands, cfg, tables, tap_chunk)


def residual_costs_multiwarp_cuda(
    pack1: torch.Tensor, warped_stack: torch.Tensor, cfg: CostConfig,
    tap_chunk: int = TAP_CHUNK,
) -> torch.Tensor:
    """Kernel A, multiwarp mode: same contract as
    ``residual_costs_multiwarp``."""
    require_cuda(pack1, warped_stack)
    if warped_stack.dim() != 4:
        raise ValueError("warped_stack must be (K, H, W, 4)")
    k = warped_stack.shape[0]
    cands = [(0, 0, i) for i in range(k)]
    check_cost_args(pack1, warped_stack, k, cands, cfg)
    return _launch(MULTIWARP, pack1, warped_stack, cands, cfg,
                   cost_tables(cfg, False), tap_chunk)


def residual_costs_auto(pack1, warped2, cand_offsets, cfg: CostConfig,
                        use_planes: bool = False,
                        tap_chunk: int = TAP_CHUNK):
    """Kernel A (plane mode with ``use_planes``) for CUDA tensors, the
    plain version for CPU tensors; taps sum in partial sums of
    ``tap_chunk``."""
    if pack1.is_cuda:
        kernel = residual_costs_planes_cuda if use_planes else residual_costs_cuda
        return kernel(pack1, warped2, cand_offsets, cfg, tap_chunk)
    if pack1.device.type == "cpu":
        return residual_costs(pack1, warped2, cand_offsets, cfg, use_planes,
                              tap_chunk)
    raise ValueError(f"unsupported device {pack1.device}")


def residual_costs_multiwarp_auto(pack1, warped_stack, cfg: CostConfig,
                                  tap_chunk: int = TAP_CHUNK):
    """Kernel A (multiwarp) for CUDA tensors, the plain version for CPU
    tensors."""
    if pack1.is_cuda:
        return residual_costs_multiwarp_cuda(pack1, warped_stack, cfg,
                                             tap_chunk)
    if pack1.device.type == "cpu":
        return residual_costs_multiwarp(pack1, warped_stack, cfg, tap_chunk)
    raise ValueError(f"unsupported device {pack1.device}")
