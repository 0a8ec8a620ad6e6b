"""Kernel F — the dense coarse matcher's exact stage, and the coarse
occlusion chain's photometric arbitration, on CUDA (``csrc/exact.cu``).

It replaces no Pallas kernel: the JAX package computes this stage in XLA
(``eppm_tpu/ops/match.py::_polish_direction``).  Bound on the H100: the
float32 <-> float64 conversions of its two exps a tap (see the note in
``csrc/exact.cu``).  One launch takes K candidate offset fields, scores
each with the exact cost (the bilateral AD + census cost over the
bfloat16 tap stack, one running sum in tap order, quantized to the 2^-17
grid, targets outside frame 2 masked) and accepts the first least of them
against the incumbent, on a strictly lower cost or at equality; or it
scores one field alone, unmasked.  The kernel computes the plain
version's operations, ``ops/match.py::exact_best_of``, on the same
operands in the same order, so the two agree bit for bit
(``csrc/common.cuh``).

The arbitration rule (``arbitrate_holes_cuda``, one launch a fill-first
pair) scores K candidate fields the same way, but on frame 2 in float32,
unquantized and each masked by its own flag too, and writes the first
least candidate's target where the pixel is a hole and the cost is below
the threshold, else the fill's: ``ops/occlusion.py::arbitrate_holes``,
bit for bit.

``exact_best_of_auto`` and ``arbitrate_holes_auto`` take the kernel for
CUDA tensors and the plain version for CPU tensors, and raise for
anything else; nothing falls back.  ``KERNEL.launches`` counts every
launch of either.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from ..config import CostConfig
from ._build import CudaKernel
from ._util import check_tensor, require_cuda
from .cost import census_lut, cost_constants
from .cuda_patchmatch import _device_tables, _rows
from .dense import _reach
from .match import exact_best_of
from .occlusion import arbitrate_holes

__all__ = [
    "KERNEL",
    "MAX_TAPS",
    "MAX_CANDS",
    "MAX_REACH",
    "check_exact_args",
    "check_arbitrate_args",
    "exact_best_of",
    "exact_best_of_cuda",
    "exact_best_of_auto",
    "arbitrate_holes",
    "arbitrate_holes_cuda",
    "arbitrate_holes_auto",
]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
KERNEL = CudaKernel("eppm_exact_best_of",
                    [_P] * 16 + [_I] * 8 + [_F, _F, _F, _P])

MAX_TAPS = 256
MAX_CANDS = 32
MAX_REACH = 32
# the kernel's rules (csrc/exact.cu): scoring, strict, at equality, and the
# occlusion arbitration
SCORE, STRICT, AT_EQUALITY, ARBITRATE = 0, 1, 2, 3

State = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]
Targets = Tuple[torch.Tensor, torch.Tensor]


def _check_fields(pack1, pack2, cgxs, cgys, cfg: CostConfig) -> None:
    """What every rule takes: (H, W, 4) and (H2, W2, 4) float32 packs read
    as float4; candidate offsets ``cgxs``, ``cgys`` int32 (K, H, W),
    1..``MAX_CANDS`` of them; 1..``MAX_TAPS`` taps within ``MAX_REACH``."""
    if cgxs.dim() != 3:
        raise ValueError(f"kernel F takes (K, H, W) candidate offsets, got "
                         f"shape {tuple(cgxs.shape)}")
    k, h, w = cgxs.shape
    if not 1 <= k <= MAX_CANDS:
        raise ValueError(f"kernel F takes 1..{MAX_CANDS} candidates, got {k}")
    check_tensor("cgxs", cgxs, torch.int32, (k, h, w))
    check_tensor("cgys", cgys, torch.int32, (k, h, w))
    check_tensor("pack1", pack1, torch.float32, (h, w, 4), 16)
    check_tensor("pack2", pack2, torch.float32,
                 (pack2.shape[0], pack2.shape[1], 4), 16)
    taps = list(cfg.tap_offsets)
    if not 1 <= len(taps) <= MAX_TAPS:
        raise ValueError(f"kernel F takes 1..{MAX_TAPS} taps, got "
                         f"{len(taps)}")
    if _reach(taps) > MAX_REACH:
        raise ValueError(f"kernel F takes taps within {MAX_REACH} px, got "
                         f"{_reach(taps)}")


def check_exact_args(pack1, pack2, cgxs, cgys, cur: Optional[State],
                     cfg: CostConfig) -> None:
    """Raise unless kernel F takes these arguments: the packs, offsets and
    taps of ``_check_fields``, one field when scoring (``cur`` None); the
    incumbent ``cur`` (gx, gy, cost) int32, int32, float32 (H, W)."""
    _check_fields(pack1, pack2, cgxs, cgys, cfg)
    k, h, w = cgxs.shape
    if cur is None and k != 1:
        raise ValueError(f"kernel F scores one field at a time (1 "
                         f"candidate), got {k}")
    if cur is not None:
        for name, t, dtype in zip(("gx", "gy", "cost"), cur,
                                  (torch.int32, torch.int32, torch.float32)):
            check_tensor(name, t, dtype, (h, w))


def check_arbitrate_args(pack1, pack2, cgxs, cgys, masks, cur: Targets,
                         fill: Targets, cfg: CostConfig) -> None:
    """Raise unless kernel F's arbitration takes these arguments: the
    packs, offsets and taps of ``_check_fields``; the candidates' flags
    ``masks`` bool (K, H, W); the LR-checked targets ``cur`` and the
    fill's ``fill``, int32 (H, W) each."""
    _check_fields(pack1, pack2, cgxs, cgys, cfg)
    k, h, w = cgxs.shape
    check_tensor("masks", masks, torch.bool, (k, h, w), 1)
    for name, t in zip(("tx", "ty", "ftx", "fty"), (*cur, *fill)):
        check_tensor(name, t, torch.int32, (h, w))


def _ptr(t):
    return None if t is None else t.data_ptr()


def _launch(pack1, pack2, cgxs, cgys, state, outs, cost, cfg: CostConfig,
            rule: int, arb=(None, None, None), thresh: float = 0.0) -> None:
    """One launch of kernel F under ``rule`` on ``pack1``'s device and
    current stream."""
    k, h, w = cgxs.shape
    taps = _rows(cfg.tap_offsets)
    offs, gws = _device_tables(taps, (), float(cfg.sigma_spatial),
                               pack1.device)
    inv_lam_ad2, inv_lam_cen2, inv_sig_r2 = cost_constants(cfg)
    lut = census_lut(inv_lam_cen2, pack1.device)
    with torch.cuda.device(pack1.device):
        KERNEL.launch(
            _ptr(pack1), _ptr(pack2), _ptr(cgxs), _ptr(cgys),
            *map(_ptr, state), *map(_ptr, outs), _ptr(cost), _ptr(offs),
            _ptr(gws), _ptr(lut), *map(_ptr, arb), h, w, pack2.shape[0],
            pack2.shape[1], k, len(taps), _reach(taps), rule, inv_sig_r2,
            inv_lam_ad2, thresh, torch.cuda.current_stream().cuda_stream)


def exact_best_of_cuda(pack1, pack2, cgxs, cgys, cur: Optional[State],
                       cfg: CostConfig, strict: bool = True) -> State:
    """Kernel F: same contract as ``exact_best_of``; the new (gx, gy,
    cost) in fresh buffers (scoring: the field's own offsets and a fresh
    cost)."""
    require_cuda(pack1, pack2, cgxs, cgys, *(cur or ()))
    check_exact_args(pack1, pack2, cgxs, cgys, cur, cfg)
    h, w = cgxs.shape[1:]
    cost = torch.empty((h, w), dtype=torch.float32, device=pack1.device)
    if cur is None:
        rule, state, outs = SCORE, (None, None, None), (None, None)
    else:
        rule = STRICT if strict else AT_EQUALITY
        state = cur
        outs = (torch.empty_like(cur[0]), torch.empty_like(cur[1]))
    _launch(pack1, pack2, cgxs, cgys, state, outs, cost, cfg, rule)
    if cur is None:
        return cgxs[0], cgys[0], cost
    return outs[0], outs[1], cost


def exact_best_of_auto(pack1, pack2, cgxs, cgys, cur: Optional[State],
                       cfg: CostConfig, strict: bool = True) -> State:
    """Kernel F for CUDA tensors, ``exact_best_of`` for CPU tensors."""
    if pack1.is_cuda:
        return exact_best_of_cuda(pack1, pack2, cgxs, cgys, cur, cfg, strict)
    if pack1.device.type == "cpu":
        return exact_best_of(pack1, pack2, cgxs, cgys, cur, cfg, strict)
    raise ValueError(f"unsupported device {pack1.device}")


def arbitrate_holes_cuda(pack1, pack2, cgxs, cgys, masks, cur: Targets,
                         fill: Targets, cfg: CostConfig,
                         thresh: float) -> Targets:
    """Kernel F's arbitration rule: same contract as ``arbitrate_holes``;
    the arbitrated (tx, ty) in fresh buffers."""
    require_cuda(pack1, pack2, cgxs, cgys, masks, *cur, *fill)
    check_arbitrate_args(pack1, pack2, cgxs, cgys, masks, cur, fill, cfg)
    outs = (torch.empty_like(fill[0]), torch.empty_like(fill[1]))
    # torch compares a float32 cost with a Python float in float32: the
    # argument's conversion to C float rounds the same way
    _launch(pack1, pack2, cgxs, cgys, (*fill, None), outs, None, cfg,
            ARBITRATE, (masks, *cur), float(thresh))
    return outs


def arbitrate_holes_auto(pack1, pack2, cgxs, cgys, masks, cur: Targets,
                         fill: Targets, cfg: CostConfig,
                         thresh: float) -> Targets:
    """Kernel F's arbitration for CUDA tensors, ``arbitrate_holes`` for
    CPU tensors."""
    if pack1.is_cuda:
        return arbitrate_holes_cuda(pack1, pack2, cgxs, cgys, masks, cur,
                                    fill, cfg, thresh)
    if pack1.device.type == "cpu":
        return arbitrate_holes(pack1, pack2, cgxs, cgys, masks, cur, fill,
                               cfg, thresh)
    raise ValueError(f"unsupported device {pack1.device}")
