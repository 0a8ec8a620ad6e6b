"""``rotation``: a rotation about the centre by an angle drawn in the
``degrees`` range; frame 1 the inverse warp of a fresh texture."""

import math

import torch

from ..generator import grid, uniform, warped_pair


def similarity(h, w, device, degrees: float, zoom: float) -> torch.Tensor:
    """The flow of a rotation by ``degrees`` and a scaling by ``zoom``
    about the frame's centre."""
    ys, xs = grid(h, w, device)
    cy, cx = h / 2.0, w / 2.0
    th = math.radians(degrees)
    c, s = zoom * math.cos(th), zoom * math.sin(th)
    return torch.stack([(xs - cx) * (c - 1) - (ys - cy) * s,
                        (xs - cx) * s + (ys - cy) * (c - 1)], -1)


def render(g, rng, spec, h, w, device):
    flow = similarity(h, w, device, uniform(rng, spec["degrees"]), 1.0)
    return warped_pair(g, flow, h, w, device)
