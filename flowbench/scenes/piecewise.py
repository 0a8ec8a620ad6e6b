"""``piecewise``: ``regions`` Voronoi cells, each with a constant flow
drawn in the ``uv`` range; frame 1 the inverse warp of a fresh
texture."""

import torch

from ..generator import grid, uniform, warped_pair


def render(g, rng, spec, h, w, device):
    k = int(spec["regions"])
    cy = torch.tensor(rng.uniform(0, h, k), dtype=torch.float32, device=device)
    cx = torch.tensor(rng.uniform(0, w, k), dtype=torch.float32, device=device)
    uv = torch.tensor([[uniform(rng, spec["uv"]) for _ in range(2)]
                       for _ in range(k)], dtype=torch.float32, device=device)
    ys, xs = grid(h, w, device)
    d = (ys[None] - cy[:, None, None]) ** 2 + (xs[None] - cx[:, None, None]) ** 2
    return warped_pair(g, uv[d.argmin(0)], h, w, device)
