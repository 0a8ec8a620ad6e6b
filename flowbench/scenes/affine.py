"""``affine``: u0, v0 drawn in the ``offset`` range and the four
gradients in the ``slope`` range (px over the frame's width or height);
frame 1 the inverse warp of a fresh texture."""

import torch

from ..generator import grid, uniform, warped_pair


def render(g, rng, spec, h, w, device):
    u0, v0 = (uniform(rng, spec["offset"]) for _ in range(2))
    ux, uy, vx, vy = (uniform(rng, spec["slope"]) for _ in range(4))
    ys, xs = grid(h, w, device)
    flow = torch.stack([u0 + ux * xs / w + uy * ys / h,
                        v0 + vx * xs / w + vy * ys / h], -1)
    return warped_pair(g, flow, h, w, device)
