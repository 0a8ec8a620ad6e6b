"""Kernel D — the exact global descriptor argmax on CUDA
(``csrc/match.cu``).

Replaces ``eppm_tpu/ops/pallas_match.py::_match_kernel`` (wrapper
``global_argmax_pallas``): for every frame-1 descriptor row, the index of
the first frame-2 row maximising round((a.b - |b|^2/2) * 4096), without
the score panel.  Bound on the H100: float64 tensor-core arithmetic,
2 N1 N2 D operations (9.24e12 at the 4K depth-3 proposal grid, 138 ms at
67 TFLOP/s).  The kernel multiplies on the float64 tensor cores (DMMA) in
128 x 64 register-blocked tiles with the argmax fused into the epilogue,
fed by a cp.async pipeline from copies of the rows padded to a multiple
of 32 features (scratch allocated here); bf16 products summed in float64
are exact, so its indices equal the plain version's bit for bit (see the
note in ``csrc/match.cu``).

When N1 has too few 128-row tiles to fill the card, ``plan_global_argmax``
splits frame 2's 64-row tiles across blocks; each split leaves its
(score, index) per row in a scratch and a merge kernel keeps the largest
score, the lowest index on ties (``merge_split_argmax`` is its plain
version).  The planner's tile and blocks per SM come from the library
(``geometry``): a tile that differs from ``BM``, ``BN``, ``BK`` raises.

The plain version is ``global_argmax`` (``ops/match.py``).
``global_argmax_auto`` takes the kernel for CUDA tensors at every size
(the JAX package's 200,000-target gate was the TPU's) and the plain
version for CPU tensors, and raises for anything else.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Dict, Optional, Tuple

import torch

from ._build import CudaKernel
from ._util import check_tensor, require_cuda
from .match import global_argmax

__all__ = ["KERNEL", "BM", "BN", "BK", "ArgmaxPlan", "plan_global_argmax",
           "Geometry", "check_geometry", "geometry", "merge_split_argmax",
           "check_argmax_args", "global_argmax", "global_argmax_cuda",
           "global_argmax_auto"]

_P = ctypes.c_void_p
_I = ctypes.c_int
KERNEL = CudaKernel("eppm_global_argmax",
                    [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P])
GEOMETRY = CudaKernel("eppm_global_argmax_geometry",
                      [ctypes.POINTER(ctypes.c_int)])
MAX_D = 768
BM = 128  # frame-1 rows per block (csrc/match.cu ARGMAX_BM)
BN = 64   # frame-2 rows per tile (ARGMAX_BN)
BK = 32   # features per chunk (ARGMAX_BK): the padded copies' multiple
# The planner's blocks per SM where no card is asked: the kernel's launch
# bounds ask for 2 (at most 128 registers a thread, 60 KB of shared memory
# a block), and the H100 holds 2.
BLOCKS_PER_SM = 2


@dataclasses.dataclass(frozen=True)
class ArgmaxPlan:
    """Frame 2's ``ceil(N2 / BN)`` tiles in ``splits`` ranges of
    ``tiles_per_split`` tiles, none empty."""

    splits: int
    tiles_per_split: int


def plan_global_argmax(n1: int, n2: int, sms: int = 132,
                       splits: Optional[int] = None,
                       blocks_per_sm: int = BLOCKS_PER_SM) -> ArgmaxPlan:
    """Split frame 2 so that the grid of ceil(n1 / BM) x splits blocks
    fills the card's ``sms`` SMs in whole waves: of the split counts that
    fill 1..8 waves of ``blocks_per_sm * sms`` resident blocks, the one
    whose last wave is fullest, the fewest splits on ties (one split when
    the rows alone fill the waves).  ``splits`` forces a count instead.
    Either is cut to the tile count and evened out, so no range is
    empty."""
    row_tiles = -(-n1 // BM)
    col_tiles = -(-n2 // BN)

    def even(s: int) -> ArgmaxPlan:
        tps = -(-col_tiles // max(1, min(s, col_tiles)))
        return ArgmaxPlan(-(-col_tiles // tps), tps)

    if splits is not None:
        return even(splits)
    slots = blocks_per_sm * sms

    def fill(plan: ArgmaxPlan) -> float:
        blocks = row_tiles * plan.splits
        return blocks / (-(-blocks // slots) * slots)

    plans = {even(waves * slots // row_tiles) for waves in range(1, 9)}
    return max(sorted(plans, key=lambda p: p.splits), key=fill)


@dataclasses.dataclass(frozen=True)
class Geometry:
    """What the library says of its argmax kernel on one device: the tile
    (BM, BN, BK), the blocks resident on one SM, and its registers and
    local memory (spills) a thread."""

    tile: Tuple[int, int, int]
    blocks_per_sm: int
    registers: int
    local_bytes: int


def check_geometry(geo: Geometry) -> Geometry:
    """Raise unless the library's tile is the planner's and a block fits
    on an SM."""
    if geo.tile != (BM, BN, BK):
        raise RuntimeError(f"kernel D's library tile {geo.tile} is not the "
                           f"planner's {(BM, BN, BK)}")
    if geo.blocks_per_sm < 1:
        raise RuntimeError("kernel D's block does not fit on an SM")
    return geo


_GEOMETRIES: Dict[int, Geometry] = {}


def geometry(device: torch.device) -> Geometry:
    """The library's ``Geometry`` on a CUDA device, read once per device
    and checked (``check_geometry``)."""
    index = torch.device(device).index
    if index is None:
        index = torch.cuda.current_device()
    if index not in _GEOMETRIES:
        geo = (ctypes.c_int * 6)()
        with torch.cuda.device(index):
            GEOMETRY.call(geo)
        _GEOMETRIES[index] = check_geometry(
            Geometry(tuple(geo[:3]), geo[3], geo[4], geo[5]))
    return _GEOMETRIES[index]


def merge_split_argmax(scores: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """(splits, N1) float64 scores and int32 indices, each split's first
    maximum -> (N1,) int32: the largest score, the lowest index on ties.
    The plain version of the kernel's merge."""
    top = scores.max(dim=0).values
    return torch.where(scores == top, idx, torch.iinfo(torch.int32).max
                       ).min(dim=0).values.to(torch.int32)


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


def _launch_args(d1: torch.Tensor, d2: torch.Tensor,
                 splits: Optional[int] = None):
    """(out, the entry point's arguments but the stream): the (N1,) int32
    output and the scratch the kernel needs, allocated here — the copies
    padded to a multiple of BK features, the half norms and, with more
    than one split, the partial (score, index) per split and row."""
    n1, d = d1.shape
    n2 = d2.shape[0]
    dev = d1.device
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    plan = plan_global_argmax(n1, n2, sms, splits,
                              geometry(dev).blocks_per_sm)
    dp = -(-d // BK) * BK
    pads = [torch.empty((n, dp), dtype=torch.bfloat16, device=dev)
            for n in (n1, n2)]
    half_norms = torch.empty((n2,), dtype=torch.float64, device=dev)
    out = torch.empty((n1,), dtype=torch.int32, device=dev)
    parts = [None, None]
    if plan.splits > 1:
        parts = [torch.empty((plan.splits, n1), dtype=dt, device=dev)
                 for dt in (torch.float64, torch.int32)]
    ptrs = [t.data_ptr() if t is not None else None
            for t in (d1, d2, *pads, half_norms, *parts, out)]
    return out, ptrs + [n1, n2, d, plan.splits, plan.tiles_per_split]


def global_argmax_cuda(d1: torch.Tensor, d2: torch.Tensor,
                       splits: Optional[int] = None) -> torch.Tensor:
    """Kernel D: same contract as ``global_argmax``.  ``splits`` forces
    the number of frame-2 ranges (default: ``plan_global_argmax``)."""
    require_cuda(d1, d2)
    check_argmax_args(d1, d2)
    out, args = _launch_args(d1, d2, splits)
    with torch.cuda.device(d1.device):
        KERNEL.launch(*args, torch.cuda.current_stream().cuda_stream)
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
