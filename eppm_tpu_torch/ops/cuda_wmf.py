"""Kernel C — the weighted median displacement filter on CUDA
(``csrc/wmf.cu``).

Replaces both Pallas forms of ``eppm_tpu/ops/pallas_wmf.py``:
``_wmf_kernel`` (whole level in VMEM) and ``_wmf_tile_kernel`` (halo
tiles).  The H100 needs neither form: one launch of the entry point is one
Jacobi iteration over the whole level, reading one set of planes and
writing another, and this wrapper ping-pongs the two sets for
``num_iter`` launches.  Bound on the H100: arithmetic, the (valid
candidate, support) pairs of the pixels whose output can change.  Each
iteration zeroes a device counter, lists those pixels on the device (the
holes under ``only_occlusion``, every pixel otherwise; nothing is read
back to the host) and gives each listed pixel a warp: the lanes gather the
window into shared memory and sum the costs of candidates l, l + 32, ...
in the plain version's partial sums, so the two agree bit for bit
(``csrc/common.cuh``).  The list and the counter are allocated once per
call.

The plain version is ``weighted_median_filter`` (``ops/refine.py``);
``weighted_median_filter_auto`` takes the kernel for CUDA tensors and the
plain version for CPU tensors, and raises otherwise.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import numpy as np
import torch

from ..config import RefineConfig
from ._build import CudaKernel
from ._util import check_tensor, grid, inv32, require_cuda
from .refine import WMF_CHUNK, _wmf_tables, weighted_median_filter

__all__ = ["KERNEL", "check_wmf_args", "weighted_median_filter",
           "weighted_median_filter_cuda", "weighted_median_filter_auto"]

_P = ctypes.c_void_p
_I = ctypes.c_int
KERNEL = CudaKernel(
    "eppm_wmf_iteration",
    [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
     ctypes.c_float, _I, _I, _P],
)
MAX_WINDOW = 225


@functools.lru_cache(maxsize=64)
def _tables(radius: int, sigma_spatial: float, dilation: int):
    """The window of kernel C, made once: its offsets as contiguous int32
    (n, 2) rows (oy, ox) and their float32 spatial weights; raises unless
    the kernel's table holds it."""
    offs, gws = _wmf_tables(RefineConfig(wmf_radius=radius,
                                         wmf_sigma_spatial=sigma_spatial),
                            dilation)
    if len(offs) > MAX_WINDOW or max(abs(v) for o in offs for v in o) >= 2**15:
        raise ValueError(f"kernel C takes at most {MAX_WINDOW} offsets "
                         "below 2^15")
    return np.ascontiguousarray(offs, dtype=np.int32), gws


def check_wmf_args(tx, ty, img, cfg: RefineConfig, polish_init=None,
                   dilation: int = 1) -> None:
    """Raise unless kernel C takes these arguments: int32 (H, W) target
    fields (and fills), a contiguous float32 (H, W, 3) image, a window
    within its table."""
    h, w = tx.shape
    fills = () if polish_init is None else tuple(polish_init)
    for name, t in (("tx", tx), ("ty", ty)) + tuple(zip(("ftx", "fty"), fills)):
        if t.dtype != torch.int32 or tuple(t.shape) != (h, w):
            raise ValueError(f"{name} must be int32 of shape {(h, w)}")
    check_tensor("img", img, torch.float32, (h, w, 3))
    _tables(cfg.wmf_radius, cfg.wmf_sigma_spatial, dilation)


def weighted_median_filter_cuda(
    tx: torch.Tensor,
    ty: torch.Tensor,
    img: torch.Tensor,
    cfg: RefineConfig = RefineConfig(),
    num_iter: int = 1,
    only_occlusion: bool = False,
    polish_init: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    dilation: int = 1,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel C: same contract as ``weighted_median_filter``."""
    fills = () if polish_init is None else tuple(polish_init)
    require_cuda(tx, ty, img, *fills)
    check_wmf_args(tx, ty, img, cfg, polish_init, dilation)
    h, w = tx.shape
    offs, gws = _tables(cfg.wmf_radius, cfg.wmf_sigma_spatial, dilation)

    ys, xs = grid(h, w, tx.device)
    valid = (tx >= 0) & (ty >= 0)
    if polish_init is not None:
        tx = torch.where(valid, tx, fills[0])
        ty = torch.where(valid, ty, fills[1])
        ox = (tx - xs).to(torch.float32)
        oy = (ty - ys).to(torch.float32)
    else:
        ox = torch.where(valid, (tx - xs).to(torch.float32), 0.0)
        oy = torch.where(valid, (ty - ys).to(torch.float32), 0.0)
    cur = (ox.contiguous(), oy.contiguous(), valid.to(torch.float32))
    nxt = tuple(torch.empty_like(a) for a in cur)
    # the pixels that can change, listed on the device each iteration
    listed = torch.empty(h * w, dtype=torch.int32, device=tx.device)
    count = torch.empty(1, dtype=torch.int32, device=tx.device)
    only_occ = int(only_occlusion or polish_init is not None)
    freeze = int(polish_init is not None)
    with torch.cuda.device(tx.device):
        stream = torch.cuda.current_stream().cuda_stream
        for _ in range(num_iter):
            KERNEL.launch(
                cur[0].data_ptr(), cur[1].data_ptr(), cur[2].data_ptr(),
                img.data_ptr(), nxt[0].data_ptr(), nxt[1].data_ptr(),
                nxt[2].data_ptr(), listed.data_ptr(), count.data_ptr(),
                offs.ctypes.data, gws.ctypes.data,
                len(offs), WMF_CHUNK, h, w, inv32(cfg.wmf_sigma_range**2),
                only_occ, freeze,
                stream,
            )
            cur, nxt = nxt, cur
    ox2, oy2, v2 = cur
    if polish_init is not None:
        # every pixel carries a value: valid ones untouched, holes
        # polished or keeping their fill
        return ox2.to(torch.int32) + xs, oy2.to(torch.int32) + ys
    v2 = v2 > 0
    return (torch.where(v2, ox2.to(torch.int32) + xs, tx),
            torch.where(v2, oy2.to(torch.int32) + ys, ty))


def weighted_median_filter_auto(
    tx, ty, img, cfg: RefineConfig = RefineConfig(), num_iter: int = 1,
    only_occlusion: bool = False, polish_init=None, dilation: int = 1,
):
    """Kernel C for CUDA tensors, the plain version for CPU tensors."""
    if tx.is_cuda:
        return weighted_median_filter_cuda(
            tx, ty, img, cfg, num_iter, only_occlusion, polish_init, dilation
        )
    if tx.device.type == "cpu":
        return weighted_median_filter(
            tx, ty, img, cfg, num_iter, only_occlusion, polish_init, dilation
        )
    raise ValueError(f"unsupported device {tx.device}")
