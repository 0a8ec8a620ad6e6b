"""``translation``: a constant flow, ``u`` and ``v`` drawn in their
ranges; frame 1 the inverse warp of a fresh texture."""

import torch

from ..generator import uniform, warped_pair


def render(g, rng, spec, h, w, device):
    flow = torch.empty((h, w, 2), device=device)
    flow[..., 0], flow[..., 1] = uniform(rng, spec["u"]), uniform(rng, spec["v"])
    return warped_pair(g, flow, h, w, device)
