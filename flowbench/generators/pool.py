"""``pool``: independent pairs, shuffled from the seed, that the client
cycles through; no warm start.

Parameters: ``height``, ``width``; ``scenes``, a list of scene kinds
(``scenes/<kind>.py``), each with a ``count`` and its own ranges; the
pool holds ``sum(count)`` pairs.  ``check_pairs``: how many pool
entries the reference recomputes (default 1)."""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np

from ..generator import device_generator, scene, to_u8


@dataclasses.dataclass
class Pool:
    """Independent pairs of uint8 host frames, cycled by the client."""

    pairs: List[Tuple[np.ndarray, np.ndarray]]
    check_pairs: int
    warm = False

    def pair(self, i: int) -> Tuple[int, np.ndarray, np.ndarray]:
        """(pool index, frame 1, frame 2) of the client's ``i``-th pair."""
        k = i % len(self.pairs)
        return (k,) + self.pairs[k]


def make(spec, seed, device, seconds) -> Pool:
    h, w = spec["height"], spec["width"]
    g = device_generator(seed, device)
    rng = np.random.default_rng(int(seed))
    kinds = [s for s in spec["scenes"] for _ in range(int(s["count"]))]
    order = rng.permutation(len(kinds))
    pairs = []
    for i in order:
        s = kinds[i]
        img1, img2 = scene(s["kind"])(g, rng, s, h, w, device)
        pairs.append((to_u8(img1).cpu().numpy(), to_u8(img2).cpu().numpy()))
    return Pool(pairs, int(spec.get("check_pairs", 1)))
