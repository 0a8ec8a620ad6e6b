"""Data made from a seed for the port's checks: ``chip_smoke.py`` on the
card and the tests on the CPU build it here, so the two hold the same
inputs."""

from __future__ import annotations

import numpy as np
import torch

from .config import DEFAULT_CONFIG
from .ops import match

__all__ = ["dark_rows"]


def dark_rows(device="cpu"):
    """(N, D) bf16 descriptor rows of two frames with black regions, as the
    matcher takes them: ``patch_descriptors`` at stride 2 of the finest
    packed level of ``prepare_pyramids``, 48 x 64 = 3072 rows each.

    Smoothing leaves features near 2^-20 at the edges of the black regions:
    a product of two has its lowest bit near 2^-56, some 59 bits below
    partial sums of up to 2^3.  That is outside the condition of
    ``tests/test_torch_argmax_plan.py::texture_rows``, so the float64 sums
    may round and their order could matter."""
    from . import pipeline

    h, w = 96, 128
    rng = np.random.default_rng(5)
    coarse = torch.from_numpy(rng.uniform(0, 255, (1, 3, h // 8 + 2,
                                                   w // 8 + 2)))
    img = torch.nn.functional.interpolate(
        coarse, size=(h, w), mode="bilinear", align_corners=False
    )[0].permute(1, 2, 0).clamp(0, 255).round().to(torch.uint8)
    img[:, : w // 3] = 0
    img[h // 2 :, w // 2 : w // 2 + 20] = 0
    rows = []
    for frame in (img, torch.roll(img, (3, -5), (0, 1))):
        pack = pipeline.prepare_pyramids(frame.to(device), DEFAULT_CONFIG)[1][0]
        desc = match.patch_descriptors(pack, DEFAULT_CONFIG.match, stride=2)
        rows.append(desc.reshape(-1, desc.shape[-1]).contiguous())
    return rows
