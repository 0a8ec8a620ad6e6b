"""``zoom``: a scaling about the centre by a factor drawn in the ``zoom``
range; frame 1 the inverse warp of a fresh texture."""

from ..generator import uniform, warped_pair
from .rotation import similarity


def render(g, rng, spec, h, w, device):
    flow = similarity(h, w, device, 0.0, uniform(rng, spec["zoom"]))
    return warped_pair(g, flow, h, w, device)
