"""``video``: one continuous video; each pair is warm-started from the
flow of the pair before it.

Parameters: ``height``, ``width``; a background canvas panning ``pan``
(dx, dy) px a frame; textured ``boxes``, each with a ``velocity`` (dx,
dy) px a frame and a ``size`` (height, width as shares of the frame),
bouncing off the frame's edges.  The video holds ``frames_per_second``
x the run's seconds + 2 frames, and a client that reaches its end plays
it backwards.  ``check_chain``: how many pairs from the first the
reference follows on its own flows (default 2); ``check_pairs``: how
many later pairs it recomputes one step each (default 1)."""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import numpy as np

from ..generator import device_generator, textured, to_u8


@dataclasses.dataclass
class Video:
    """One video's uint8 host frames, (N, H, W, 3); pair ``i`` is frames
    f(i), f(i + 1), where f plays the video forwards, then backwards."""

    frames: np.ndarray
    check_pairs: int
    check_chain: int
    warm = True

    def index(self, i: int) -> int:
        n = self.frames.shape[0]
        period = 2 * (n - 1)
        j = i % period
        return j if j < n else period - j

    def pair(self, i: int) -> Tuple[int, np.ndarray, np.ndarray]:
        return i, self.frames[self.index(i)], self.frames[self.index(i + 1)]


def _bounce(p0: int, v: int, k: int, span: int) -> int:
    """Position at frame ``k`` of a point starting at ``p0`` in [0, span]
    and moving ``v`` a frame, reflected at both ends."""
    if span <= 0:
        return 0
    q = (p0 + v * k) % (2 * span)
    return q if q <= span else 2 * span - q


def make(spec, seed, device, seconds) -> Video:
    h, w = spec["height"], spec["width"]
    n = int(math.ceil(spec["frames_per_second"] * seconds)) + 2
    g = device_generator(seed, device)
    rng = np.random.default_rng(int(seed))
    px, py = (int(v) for v in spec["pan"])
    ch, cw = h + abs(py) * (n - 1), w + abs(px) * (n - 1)
    canvas = textured(g, ch, cw, device)
    # frame k shows the canvas from (oy - k py, ox - k px): content moves
    # by +pan a frame
    oy, ox = max(0, py) * (n - 1), max(0, px) * (n - 1)
    boxes = []
    for b in spec["boxes"]:
        bh, bw = int(b["size"][0] * h), int(b["size"][1] * w)
        boxes.append((textured(g, bh, bw, device),
                      int(rng.integers(0, h - bh + 1)),
                      int(rng.integers(0, w - bw + 1)),
                      int(b["velocity"][0]), int(b["velocity"][1])))
    frames = np.empty((n, h, w, 3), np.uint8)
    for k in range(n):
        y, x = oy - k * py, ox - k * px
        img = canvas[y:y + h, x:x + w].clone()
        for patch, y0, x0, vx, vy in boxes:
            bh, bw = patch.shape[:2]
            by = _bounce(y0, vy, k, h - bh)
            bx = _bounce(x0, vx, k, w - bw)
            img[by:by + bh, bx:bx + bw] = patch
        frames[k] = to_u8(img).cpu().numpy()
    return Video(frames, int(spec.get("check_pairs", 1)),
                 int(spec.get("check_chain", 2)))
