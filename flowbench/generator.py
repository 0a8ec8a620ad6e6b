"""Traffic: frame pairs and videos made on the device from ``--seed``, as
a traffic file (``traffic/<name>.json``) describes them.

A traffic file is JSON whose ``"generator"`` names a module of
``generators/`` (``pool``, ``video``) that makes the traffic; a pool's
scenes name modules of ``scenes/`` (``translation``, ``affine``,
``rotation``, ``zoom``, ``piecewise``, ``layered``) that render one
pair each.  Both are found by name (``kind``, ``scene``), so a new kind
of traffic or scene is a new file; each module's docstring gives the
parameters it reads.

A generator module exposes ``make(spec, seed, device, seconds)``, which
returns the traffic: an object with ``pair(i)`` (the client's ``i``-th
pair as (key, frame 1, frame 2), uint8 host arrays (H, W, 3)), ``warm``
(whether pair i + 1 is warm-started from pair i's flow) and
``check_pairs`` (and, where warm, ``check_chain``), which ``check.py``
reads.  A scene module exposes ``render(g, rng, spec, h, w, device)``,
which returns the pair's two frames as float32 (H, W, 3) in [0, 1].

The scenes are the eval set's (``eppm_tpu_torch/evalset.py``, itself a
copy of the JAX tools' generators), rewritten in torch to run on the
card: a multi-octave texture (``textured``), its inverse warp along a
motion field (``warp``), and layered scenes.  Textures come from a
``torch.Generator`` on the device seeded with ``--seed``; the few scalars
of each scene (motions, box sizes and places) from a numpy generator on
the same seed.  The same seed gives the same frames on the same kind of
device, and every seed gives the same number of pairs of each kind, in
another order, with other motions.
"""

from __future__ import annotations

import importlib
from typing import Tuple

import numpy as np
import torch

from .spec import HERE, NotFound

__all__ = ["make", "kind", "scene", "device_generator", "textured", "warp",
           "warped_pair", "to_u8", "grid", "uniform"]


def _module(folder: str, name, what: str, entry: str):
    path = HERE / folder / f"{name}.py"
    if not isinstance(name, str) or not path.is_file():
        known = sorted(p.stem for p in (HERE / folder).glob("*.py")
                       if not p.stem.startswith("_"))
        raise NotFound(f"no {what} {name!r} (flowbench/{folder}/"
                       f"{name}.py); known: {known}")
    return getattr(importlib.import_module(f"flowbench.{folder}.{name}"),
                   entry)


def kind(name: str):
    """``generators/<name>.py``'s ``make``."""
    return _module("generators", name, "traffic generator", "make")


def scene(name: str):
    """``scenes/<name>.py``'s ``render``."""
    return _module("scenes", name, "scene kind", "render")


def resolve(spec: dict) -> None:
    """Refuse a traffic file whose generator or scene kinds are not
    there (``NotFound``), before anything is made."""
    kind(spec.get("generator"))
    for s in spec.get("scenes", []):
        scene(s.get("kind"))


def make(spec: dict, seed: int, device: torch.device, seconds: float):
    """The traffic of ``spec`` (a parsed traffic file) from ``seed``, on
    ``device``, for a window of ``seconds``."""
    resolve(spec)
    with torch.no_grad():
        return kind(spec["generator"])(spec, seed, device, seconds)


def device_generator(seed: int, device: torch.device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (2**63))
    return g


def textured(g: torch.Generator, h: int, w: int,
             device: torch.device) -> torch.Tensor:
    """Multi-octave RGB texture in [0, 1], (H, W, 3) float32: coarse
    structure, mid and fine detail (``evalset.textured``)."""
    img = torch.zeros((h, w, 3), dtype=torch.float32, device=device)
    for scale, amp in ((16, 0.6), (4, 0.3), (1, 0.1)):
        sh, sw = h // scale + 2, w // scale + 2
        small = torch.rand((sh, sw, 3), generator=g, device=device)
        ys = torch.linspace(0, sh - 1.001, h, device=device)
        xs = torch.linspace(0, sw - 1.001, w, device=device)
        y0, x0 = ys.floor().long(), xs.floor().long()
        ay = (ys - y0)[:, None, None]
        ax = (xs - x0)[None, :, None]
        y0, x0 = y0[:, None], x0[None, :]
        img += amp * (small[y0, x0] * (1 - ay) * (1 - ax)
                      + small[y0, x0 + 1] * (1 - ay) * ax
                      + small[y0 + 1, x0] * ay * (1 - ax)
                      + small[y0 + 1, x0 + 1] * ay * ax)
    return img.clamp_(0, 1)


def warp(img: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """Bilinear inverse warp, out(p) = img(p + flow(p)), edge-clamped
    (``evalset.warp``)."""
    h, w = img.shape[:2]
    ys = torch.arange(h, device=img.device, dtype=torch.float32)[:, None]
    xs = torch.arange(w, device=img.device, dtype=torch.float32)[None, :]
    fx = (xs + flow[..., 0]).clamp(0, w - 1)
    fy = (ys + flow[..., 1]).clamp(0, h - 1)
    x0, y0 = fx.floor().long(), fy.floor().long()
    x1, y1 = (x0 + 1).clamp(max=w - 1), (y0 + 1).clamp(max=h - 1)
    ax, ay = (fx - x0)[..., None], (fy - y0)[..., None]
    return (img[y0, x0] * (1 - ax) * (1 - ay) + img[y0, x1] * ax * (1 - ay)
            + img[y1, x0] * (1 - ax) * ay + img[y1, x1] * ax * ay)


def warped_pair(g: torch.Generator, flow: torch.Tensor, h: int, w: int,
                device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    """The eval set's sequences: frame 2 a fresh texture, frame 1 its
    inverse warp along ``flow``."""
    img2 = textured(g, h, w, device)
    return warp(img2, flow), img2


def to_u8(img: torch.Tensor) -> torch.Tensor:
    """Frames as served: uint8, round half up."""
    return (img.clamp(0, 1) * 255 + 0.5).to(torch.uint8)


def grid(h, w, device):
    """Pixel rows and columns, (H, W) float32 each."""
    ys = torch.arange(h, device=device, dtype=torch.float32)[:, None]
    xs = torch.arange(w, device=device, dtype=torch.float32)[None, :]
    return ys.expand(h, w), xs.expand(h, w)


def uniform(rng: np.random.Generator, lo_hi) -> float:
    """One draw in [low, high] (a range of a traffic file)."""
    lo, hi = lo_hi
    return float(rng.uniform(lo, hi))
