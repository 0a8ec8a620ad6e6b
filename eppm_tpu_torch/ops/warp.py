"""Image warping by a flow field (counterpart of ``eppm_tpu/ops/warp.py``).

Spec: ``bao_cuda_warping_by_flow`` (basic/bao_basic_cuda.cuh:667-740): a
2x2 bilinear sample at (x + u, y + v), the integer part by C truncation,
the fractional part clamped to [0, 1], taps clamped to the image; pixels
of unknown flow (> 1e9) read their own position.  A utility (visualisation,
photometric error), not on the flow path.
"""

from __future__ import annotations

import torch

from ..config import UNKNOWN_FLOW_THRESH
from ._util import grid, trunc_i32

__all__ = ["warp_image_by_flow"]


def warp_image_by_flow(img: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """warped(p) = img(p + flow(p)) with bilinear sampling; (H, W[, C])."""
    h, w = img.shape[0], img.shape[1]
    squeeze = img.dim() == 2
    if squeeze:
        img = img[..., None]
    ys, xs = (t.to(torch.float32) for t in grid(h, w, flow.device))
    u, v = flow[..., 0], flow[..., 1]
    unknown = (u > UNKNOWN_FLOW_THRESH) | (v > UNKNOWN_FLOW_THRESH)
    x = xs + torch.where(unknown, 0.0, u)
    y = ys + torch.where(unknown, 0.0, v)
    x0, y0 = x.trunc(), y.trunc()
    fx = (x - x0).clamp(0.0, 1.0)[..., None]
    fy = (y - y0).clamp(0.0, 1.0)[..., None]
    ix, iy = trunc_i32(x0), trunc_i32(y0)
    flat = img.reshape(h * w, img.shape[2])

    def tap(dy, dx):
        cy = (iy + dy).clamp(0, h - 1)
        cx = (ix + dx).clamp(0, w - 1)
        return flat[(cy * w + cx).long()]

    out = (tap(0, 0) * (1.0 - fy) * (1.0 - fx)
           + tap(0, 1) * (1.0 - fy) * fx
           + tap(1, 0) * fy * (1.0 - fx)
           + tap(1, 1) * fy * fx)
    return out[..., 0] if squeeze else out
