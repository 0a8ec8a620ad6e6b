"""3x3 census transform (counterpart of ``eppm_tpu/ops/census.py``).

Spec: ``d_census_transform3x3`` (bao_pmflow_census_kernel.cu:39-112).  Bit
k of a pixel's 8-bit signature is set when the k-th neighbor's luminance
(0.3R + 0.6G + 0.1B) is strictly greater than the center's; borders clamp.
"""

from __future__ import annotations

import torch

from ._util import f32, fma32, pad_edge

# (dx, dy) per bit, reference order (census_kernel.cu:53-60).
NEIGHBOR_OFFSETS = (
    (-1, -1), (0, -1), (1, -1),
    (-1, 0), (1, 0),
    (-1, 1), (0, 1), (1, 1),
)

__all__ = ["census_transform", "luminance", "NEIGHBOR_OFFSETS"]


def luminance(img: torch.Tensor) -> torch.Tensor:
    """Census-comparison luminance: 0.3R + 0.6G + 0.1B (census_kernel.cu:41),
    rounded as the JAX package's jitted programs compute it: XLA's CPU
    backend fuses ``(0.3R + 0.6G) + 0.1B`` into fma(B, 0.1, fma(R, 0.3,
    0.6G)).  On texture whose neighbours' luminances tie up to the last
    bit (the eval set's oriented stripes), the unfused sum flips census
    bits and, through them, matches."""
    return fma32(img[..., 2], f32(0.1),
                 fma32(img[..., 0], f32(0.3), img[..., 1] * f32(0.6)))


def census_transform(img: torch.Tensor) -> torch.Tensor:
    """Census signature of an (H, W, 3) image -> (H, W) int32 in [0, 255]."""
    lum = luminance(img)
    h, w = lum.shape
    padded = pad_edge(lum, 1, 1)
    out = torch.zeros((h, w), dtype=torch.int32, device=img.device)
    for bit, (dx, dy) in enumerate(NEIGHBOR_OFFSETS):
        neigh = padded[1 + dy : 1 + dy + h, 1 + dx : 1 + dx + w]
        out = out | ((neigh > lum).to(torch.int32) << bit)
    return out
