"""Data made from a seed for the port's checks and measurements:
``chip_smoke.py`` and the measurement programs (``eppm_tpu_torch/bench``)
on the card and the tests on the CPU build it here, so all of them hold
the same inputs.  Every pair is synthetic: a smooth seeded texture and a
known integer translation of it."""

from __future__ import annotations

import numpy as np
import torch

from .config import DEFAULT_CONFIG
from .ops import match

__all__ = ["texture", "shifted_pair", "dark_rows"]


def texture(h: int, w: int, seed: int) -> np.ndarray:
    """Smooth float32 RGB texture in [0, 1]: seeded noise on a grid 8x
    coarser, upsampled bicubically."""
    rng = np.random.default_rng(seed)
    small = torch.from_numpy(
        rng.random((3, h // 8 + 3, w // 8 + 3)).astype(np.float32))
    big = torch.nn.functional.interpolate(
        small[None], size=(8 * (h // 8 + 3), 8 * (w // 8 + 3)),
        mode="bicubic", align_corners=False)[0]
    return big.clamp(0, 1)[:, :h, :w].permute(1, 2, 0).numpy()


def shifted_pair(h: int, w: int, dx: int, dy: int, seed: int,
                 dark: bool = False):
    """uint8 (frame1, frame2) with frame1(p) = frame2(p + (dx, dy)): the
    true flow from frame 1 to frame 2 is (dx, dy) wherever p + (dx, dy)
    lies in the frame.  ``dark``: the scene's left third and a band in
    its lower half are black."""
    m = max(abs(dx), abs(dy)) + 8
    big = (texture(h + 2 * m, w + 2 * m, seed) * 255).astype(np.uint8)
    if dark:
        bh, bw = big.shape[0], big.shape[1]
        big[:, : bw // 3] = 0
        big[bh // 2 :, bw // 2 : bw // 2 + 20] = 0
    f2 = big[m : m + h, m : m + w]
    f1 = big[m + dy : m + dy + h, m + dx : m + dx + w]
    return np.ascontiguousarray(f1), np.ascontiguousarray(f2)


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
