"""Kernel E — PatchMatch's gathered cost and its candidate fold on CUDA
(``csrc/patchmatch.cu``).

It replaces no Pallas kernel: the JAX package computes the gathered cost
in XLA.  Bound on the H100: the float64 conversions of its two exps a
tap (see the note in ``csrc/patchmatch.cu``).  One launch computes the
gathered AD + census cost of K candidate fields over one to four
frame-2 tap tables (the least over them) and, in the fold modes, folds
the candidates into the incumbent on a strictly lower cost.  The kernel
computes the plain versions' operations on the same operands in the same
order, so the two agree bit for bit (``csrc/common.cuh``):

- cost only: ``patch_cost_tables`` (``ops/cost.py``), the least
  ``patch_cost_offsets`` over the tables;
- fold: ``select_candidates`` (``ops/patchmatch.py``), that cost folded
  by ``_select_best``;
- propagation: ``propagate_candidates``, the fold of the 4 neighbours'
  targets of ``_neighbour_targets``, which the kernel computes itself.

The ``*_auto`` dispatchers take the kernel for CUDA tensors and the plain
version for CPU tensors, and raise for anything else; nothing falls back.
``KERNEL.launches`` counts every launch, in every mode.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import CostConfig
from ._build import CudaKernel
from ._util import check_tensor, require_cuda
from .cost import (TAP_CHUNK, census_lut, cost_constants, patch_cost_tables,
                   tap_weight)
from .dense import _reach
from .patchmatch import propagate_candidates, select_candidates

__all__ = [
    "KERNEL",
    "MAX_TAPS",
    "MAX_TABLES",
    "MAX_CANDS",
    "MAX_REACH",
    "check_patchmatch_args",
    "patch_cost_tables",
    "patch_cost_tables_cuda",
    "patch_cost_tables_auto",
    "select_candidates",
    "select_candidates_cuda",
    "select_candidates_auto",
    "propagate_candidates",
    "propagate_candidates_cuda",
    "propagate_candidates_auto",
]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
KERNEL = CudaKernel("eppm_patchmatch_costs",
                    [_P] * 13 + [_I] * 13 + [_F, _F, _P])

MAX_TAPS = 256
MAX_TABLES = 4
MAX_CANDS = 32
MAX_REACH = 32
# the propagation mode's candidates: the 4 axial neighbours
PROP_CANDS = 4

Tables = Sequence[Sequence[Tuple[int, int]]]


def _rows(rows) -> tuple:
    return tuple(tuple(int(v) for v in r) for r in rows)


@functools.lru_cache(maxsize=None)
def _device_tables(taps: tuple, tables: tuple, sigma: float,
                   device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    """(offsets, spatial weights) on the device: int32 (T, 2) frame-1
    taps then (B, T, 2) frame-2 tables, and float32 (T,).  Made once per
    distinct set and never freed (a CUDA graph holds their addresses), so
    a call copies nothing to the card."""
    offs = np.asarray((taps,) + tables, dtype=np.int32).ravel()
    gws = np.asarray([tap_weight(dy, dx, sigma) for dy, dx in taps],
                     dtype=np.float32)
    return (torch.from_numpy(offs).to(device),
            torch.from_numpy(gws).to(device))


def check_patchmatch_args(pack1, pack2, txs, tys, cfg: CostConfig,
                          tables: Tables, pack1_halo: int = 0,
                          tap_chunk: int = TAP_CHUNK,
                          state: Optional[Tuple[torch.Tensor, ...]] = None
                          ) -> None:
    """Raise unless kernel E takes these arguments: (H1, W1, 4) and (H2,
    W2, 4) float32 packs read as float4, frame 1 holding the targets'
    field with ``pack1_halo`` rows and columns on each side; candidate
    targets ``txs``, ``tys`` int32 (H, W) or (K, H, W) (in propagation
    mode the incumbent's); the incumbent ``state`` (tx, ty, cost) int32,
    int32, float32 (H, W); 1..``MAX_TABLES`` frame-2 tables of as many
    taps as ``cfg.tap_offsets``, at most ``MAX_TAPS``, the frame-1 taps
    within ``MAX_REACH``; a tap chunk of at least 1."""
    if txs.dim() not in (2, 3):
        raise ValueError(f"kernel E takes (H, W) or (K, H, W) targets, got "
                         f"shape {tuple(txs.shape)}")
    k = 1 if txs.dim() == 2 else txs.shape[0]
    h, w = txs.shape[-2:]
    if not 1 <= k <= MAX_CANDS:
        raise ValueError(f"kernel E takes 1..{MAX_CANDS} candidates, got {k}")
    check_tensor("txs", txs, torch.int32, tuple(txs.shape))
    check_tensor("tys", tys, torch.int32, tuple(txs.shape))
    if pack1_halo < 0:
        raise ValueError(f"pack1_halo must be >= 0, got {pack1_halo}")
    h1, w1 = pack1.shape[0], pack1.shape[1]
    check_tensor("pack1", pack1, torch.float32, (h1, w1, 4), 16)
    check_tensor("pack2", pack2, torch.float32,
                 (pack2.shape[0], pack2.shape[1], 4), 16)
    if h1 < h + 2 * pack1_halo or w1 < w + 2 * pack1_halo:
        raise ValueError(f"pack1 of shape {(h1, w1)} does not hold a {h}x{w} "
                         f"field with a halo of {pack1_halo}")
    if state is not None:
        for name, t, dtype in zip(("tx", "ty", "cost"), state,
                                  (torch.int32, torch.int32, torch.float32)):
            check_tensor(name, t, dtype, (h, w))
    taps = list(cfg.tap_offsets)
    if not 1 <= len(taps) <= MAX_TAPS:
        raise ValueError(f"kernel E takes 1..{MAX_TAPS} taps, got "
                         f"{len(taps)}")
    if not 1 <= len(tables) <= MAX_TABLES or any(
            len(t) != len(taps) for t in tables):
        raise ValueError(f"kernel E takes 1..{MAX_TABLES} frame-2 tap "
                         f"tables of {len(taps)} taps each")
    if _reach(taps) > MAX_REACH:
        raise ValueError(f"kernel E takes frame-1 taps within {MAX_REACH} "
                         f"px, got {_reach(taps)}")
    if tap_chunk < 1:
        raise ValueError(f"kernel E takes a tap chunk >= 1, got {tap_chunk}")


def _launch(pack1, pack2, txs, tys, state, outs, k: int, step: int,
            cfg: CostConfig, tables: Tables, pack1_halo: int,
            tap_chunk: int) -> None:
    """One launch of kernel E on checked arguments; ``txs``/``tys`` None
    in propagation mode, ``state`` None for cost only."""
    taps = _rows(cfg.tap_offsets)
    offs, gws = _device_tables(taps, tuple(_rows(t) for t in tables),
                               float(cfg.sigma_spatial), pack1.device)
    inv_lam_ad2, inv_lam_cen2, inv_sig_r2 = cost_constants(cfg)
    lut = census_lut(inv_lam_cen2, pack1.device)
    h, w = outs[-1].shape[-2:]

    def ptr(t):
        return None if t is None else t.data_ptr()

    tx0, ty0, cost0 = state if state is not None else (None, None, None)
    out_tx, out_ty = (outs[0], outs[1]) if len(outs) == 3 else (None, None)
    with torch.cuda.device(pack1.device):
        KERNEL.launch(
            ptr(pack1), ptr(pack2), ptr(txs), ptr(tys), ptr(tx0), ptr(ty0),
            ptr(cost0), ptr(out_tx), ptr(out_ty), ptr(outs[-1]), ptr(offs),
            ptr(gws), ptr(lut), pack1.shape[0], pack1.shape[1], pack1_halo,
            pack2.shape[0], pack2.shape[1], h, w, k, step, len(taps),
            len(tables), tap_chunk, _reach(taps), inv_sig_r2, inv_lam_ad2,
            torch.cuda.current_stream().cuda_stream)


def patch_cost_tables_cuda(pack1, pack2, tx, ty, cfg: CostConfig,
                           tables: Tables, pack1_halo: int = 0,
                           tap_chunk: int = TAP_CHUNK) -> torch.Tensor:
    """Kernel E, cost only: same contract as ``patch_cost_tables``."""
    require_cuda(pack1, pack2, tx, ty)
    check_patchmatch_args(pack1, pack2, tx, ty, cfg, tables, pack1_halo,
                          tap_chunk)
    out = torch.empty(tx.shape, dtype=torch.float32, device=tx.device)
    k = 1 if tx.dim() == 2 else tx.shape[0]
    _launch(pack1, pack2, tx, ty, None, (out,), k, 0, cfg, tables,
            pack1_halo, tap_chunk)
    return out


def _fold(pack1, pack2, tx, ty, cost, txs, tys, k: int, step: int,
          cfg: CostConfig, tables: Tables, tap_chunk: int):
    outs = (torch.empty_like(tx), torch.empty_like(ty),
            torch.empty_like(cost))
    _launch(pack1, pack2, txs, tys, (tx, ty, cost), outs, k, step, cfg,
            tables, 0, tap_chunk)
    return outs


def select_candidates_cuda(pack1, pack2, tx, ty, cost, txs, tys,
                           cfg: CostConfig, tables: Tables,
                           tap_chunk: int = TAP_CHUNK):
    """Kernel E, fold: same contract as ``select_candidates``; the new
    (tx, ty, cost) in fresh buffers."""
    require_cuda(pack1, pack2, tx, ty, cost, txs, tys)
    if txs.dim() != 3:
        raise ValueError("kernel E folds (K, H, W) candidate fields")
    check_patchmatch_args(pack1, pack2, txs, tys, cfg, tables, 0, tap_chunk,
                          (tx, ty, cost))
    return _fold(pack1, pack2, tx, ty, cost, txs, tys, txs.shape[0], 0, cfg,
                 tables, tap_chunk)


def propagate_candidates_cuda(pack1, pack2, tx, ty, cost, step: int,
                              cfg: CostConfig, tables: Tables,
                              tap_chunk: int = TAP_CHUNK):
    """Kernel E, propagation: same contract as ``propagate_candidates``;
    the neighbours' targets are computed in the kernel."""
    require_cuda(pack1, pack2, tx, ty, cost)
    if step < 1:
        raise ValueError(f"kernel E propagates at a step >= 1, got {step}")
    check_patchmatch_args(pack1, pack2, tx, ty, cfg, tables, 0, tap_chunk,
                          (tx, ty, cost))
    return _fold(pack1, pack2, tx, ty, cost, None, None, PROP_CANDS, step,
                 cfg, tables, tap_chunk)


def _unsupported(t: torch.Tensor):
    return ValueError(f"unsupported device {t.device}")


def patch_cost_tables_auto(pack1, pack2, tx, ty, cfg: CostConfig,
                           tables: Tables, pack1_halo: int = 0,
                           tap_chunk: int = TAP_CHUNK) -> torch.Tensor:
    """Kernel E (cost only) for CUDA tensors, ``patch_cost_tables`` for
    CPU tensors."""
    if pack1.is_cuda:
        return patch_cost_tables_cuda(pack1, pack2, tx, ty, cfg, tables,
                                      pack1_halo, tap_chunk)
    if pack1.device.type == "cpu":
        return patch_cost_tables(pack1, pack2, tx, ty, cfg, tables,
                                 pack1_halo, tap_chunk)
    raise _unsupported(pack1)


def select_candidates_auto(pack1, pack2, tx, ty, cost, txs, tys,
                           cfg: CostConfig, tables: Tables,
                           tap_chunk: int = TAP_CHUNK):
    """Kernel E (fold) for CUDA tensors, ``select_candidates`` for CPU
    tensors."""
    if pack1.is_cuda:
        return select_candidates_cuda(pack1, pack2, tx, ty, cost, txs, tys,
                                      cfg, tables, tap_chunk)
    if pack1.device.type == "cpu":
        return select_candidates(pack1, pack2, tx, ty, cost, txs, tys, cfg,
                                 tables, tap_chunk)
    raise _unsupported(pack1)


def propagate_candidates_auto(pack1, pack2, tx, ty, cost, step: int,
                              cfg: CostConfig, tables: Tables,
                              tap_chunk: int = TAP_CHUNK):
    """Kernel E (propagation) for CUDA tensors, ``propagate_candidates``
    for CPU tensors."""
    if pack1.is_cuda:
        return propagate_candidates_cuda(pack1, pack2, tx, ty, cost, step,
                                         cfg, tables, tap_chunk)
    if pack1.device.type == "cpu":
        return propagate_candidates(pack1, pack2, tx, ty, cost, step, cfg,
                                    tables, tap_chunk)
    raise _unsupported(pack1)
