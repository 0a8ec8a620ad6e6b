"""``layered`` (``evalset.layered_scene``): a background moving by one
flow in +-``bg_max`` px, and ``boxes`` textured foreground boxes moving
by one integer offset, of a length drawn in the ``fg`` range and a
uniform direction, each occluding background in frame 2."""

import math

import torch

from ..generator import textured, uniform, warp


def render(g, rng, spec, h, w, device):
    bg = float(spec["bg_max"])
    bg_uv = (uniform(rng, (-bg, bg)), uniform(rng, (-bg, bg)))
    mag = uniform(rng, spec["fg"])
    ang = uniform(rng, (0.0, 2 * math.pi))
    dx, dy = int(round(mag * math.cos(ang))), int(round(mag * math.sin(ang)))
    img2 = textured(g, h, w, device)
    flow = torch.empty((h, w, 2), device=device)
    flow[..., 0], flow[..., 1] = bg_uv
    img1 = warp(img2, flow)
    img2 = img2.clone()
    for _ in range(int(spec["boxes"])):
        bh = int(rng.uniform(0.15, 0.35) * h)
        bw = int(rng.uniform(0.1, 0.25) * w)
        patch = textured(g, bh, bw, device)
        y0 = int(rng.integers(max(0, -dy), h - bh - max(0, dy)))
        x0 = int(rng.integers(max(0, -dx), w - bw - max(0, dx)))
        img1[y0:y0 + bh, x0:x0 + bw] = patch
        img2[y0 + dy:y0 + dy + bh, x0 + dx:x0 + dx + bw] = patch
    return img1, img2
