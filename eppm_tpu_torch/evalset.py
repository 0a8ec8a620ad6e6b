"""The local evaluation set: synthetic sequences with exact ground truth
(counterpart of ``tools/make_eval_set.py`` and ``tools/make_holdout_set.py``,
whose generators are copied here: the port imports nothing of the JAX
package or its tools).  The same seeds and the same order of draws give
the same files, byte for byte:

  middlebury_synth/  8 sequences, 480x640 (translations, affine, rotation,
                     zoom, shear, piecewise-discontinuous motion)
  sintel_stress/     4 sequences, 436x1024 (displacements of 60-120 px,
                     layered occlusion)
  kitti_fixtures/    4 sequences, 375x1242, ground truth as KITTI 16-bit
                     PNG flow
  holdout/           6 sequences on a fresh seed: flat-colour Voronoi
                     cells, oriented stripes, a sinusoidal field and disk
                     occluders (reported, never tuned on)

The first three groups draw from one generator (seed 20260817) in that
order, the holdout group from its own (seed 20260821).  Each sequence
directory holds frame10.ppm, frame11.ppm and flow10.flo (flow10.png for
KITTI); frame10 = warp(frame11, gt), so the flow maps a frame-10 pixel p
to p + gt(p) in frame 11.

Left out: the ``real_texture`` group of ``tools/make_eval_set.py``, which
is built from the Grove pair (frame10.ppm, frame11.ppm of the reference
implementation); those frames are not in the repository, and the group
waits until they are.

  python -m eppm_tpu_torch.evalset --root evalset
"""

from __future__ import annotations

import argparse
import os
from typing import Dict, List

import numpy as np

from .io import write_flo, write_kitti_flow, write_ppm

__all__ = ["GROUPS", "SEED", "HOLDOUT_SEED", "textured", "warp",
           "const_flow", "affine_flow", "rotation_flow", "piecewise_flow",
           "layered_flow", "layered_scene", "cartoon", "stripes", "sine_flow",
           "disk_layered_scene", "save_pair", "save_seq", "build", "main"]

SEED = 20260817
HOLDOUT_SEED = 20260821

# Each group and the --eval-dir pattern of its sequence directories.
GROUPS: Dict[str, str] = {
    "middlebury_synth": "frame10.ppm,frame11.ppm,flow10.flo",
    "sintel_stress": "frame10.ppm,frame11.ppm,flow10.flo",
    "kitti_fixtures": "frame10.ppm,frame11.ppm,flow10.png",
    "holdout": "frame10.ppm,frame11.ppm,flow10.flo",
}


def textured(rng, h, w):
    """Multi-octave RGB texture: coarse structure + mid + fine detail."""
    img = np.zeros((h, w, 3), np.float64)
    for scale, amp in ((16, 0.6), (4, 0.3), (1, 0.1)):
        small = rng.random((h // scale + 2, w // scale + 2, 3))
        ys = np.linspace(0, small.shape[0] - 1.001, h)
        xs = np.linspace(0, small.shape[1] - 1.001, w)
        y0 = np.floor(ys).astype(int)[:, None]
        x0 = np.floor(xs).astype(int)[None, :]
        ay = (ys[:, None] - y0)[..., None]
        ax = (xs[None, :] - x0)[..., None]
        img += amp * (
            small[y0, x0] * (1 - ay) * (1 - ax)
            + small[y0, x0 + 1] * (1 - ay) * ax
            + small[y0 + 1, x0] * ay * (1 - ax)
            + small[y0 + 1, x0 + 1] * ay * ax
        )
    return np.clip(img, 0, 1).astype(np.float32)


def warp(img, flow):
    """Bilinear inverse warp: out(p) = img(p + flow(p)), edge-clamped."""
    h, w = img.shape[:2]
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float64)
    fx = np.clip(xs + flow[..., 0], 0, w - 1)
    fy = np.clip(ys + flow[..., 1], 0, h - 1)
    x0 = np.floor(fx).astype(int)
    y0 = np.floor(fy).astype(int)
    x1 = np.minimum(x0 + 1, w - 1)
    y1 = np.minimum(y0 + 1, h - 1)
    ax = (fx - x0)[..., None]
    ay = (fy - y0)[..., None]
    return (
        img[y0, x0] * (1 - ax) * (1 - ay)
        + img[y0, x1] * ax * (1 - ay)
        + img[y1, x0] * (1 - ax) * ay
        + img[y1, x1] * ax * ay
    ).astype(np.float32)


def const_flow(h, w, u, v):
    gt = np.empty((h, w, 2), np.float32)
    gt[..., 0], gt[..., 1] = u, v
    return gt


def affine_flow(h, w, u0, v0, ux, uy, vx, vy):
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float32)
    return np.stack(
        [u0 + ux * xs / w + uy * ys / h, v0 + vx * xs / w + vy * ys / h], -1
    ).astype(np.float32)


def rotation_flow(h, w, deg, zoom=1.0):
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float32)
    cy, cx = h / 2.0, w / 2.0
    th = np.deg2rad(deg)
    c, s = zoom * np.cos(th), zoom * np.sin(th)
    return np.stack(
        [(xs - cx) * (c - 1) - (ys - cy) * s, (xs - cx) * s + (ys - cy) * (c - 1)],
        -1,
    ).astype(np.float32)


def piecewise_flow(h, w, flows, rng):
    """Voronoi-style piecewise-constant field: motion discontinuities."""
    k = len(flows)
    cy = rng.uniform(0, h, k)
    cx = rng.uniform(0, w, k)
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float32)
    d = (ys[None] - cy[:, None, None]) ** 2 + (xs[None] - cx[:, None, None]) ** 2
    lbl = np.argmin(d, 0)
    gt = np.zeros((h, w, 2), np.float32)
    for i, (u, v) in enumerate(flows):
        gt[lbl == i] = (u, v)
    return gt


def layered_flow(h, w, bg, fg, rng, n_boxes=3):
    """Background motion with foreground boxes moving differently."""
    gt = const_flow(h, w, *bg)
    for _ in range(n_boxes):
        bh = int(rng.uniform(0.15, 0.35) * h)
        bw = int(rng.uniform(0.1, 0.25) * w)
        y0 = rng.integers(0, h - bh)
        x0 = rng.integers(0, w - bw)
        gt[y0 : y0 + bh, x0 : x0 + bw] = fg
    return gt


def layered_scene(rng, h, w, bg_uv, fg_uv, n_boxes=3):
    """A two-layer scene: independently textured foreground boxes
    (integer motion) over a warped background, with real occlusion.  Each
    box's texture is its own, so its match is unique; its frame-2
    position occludes background."""
    bg2 = textured(rng, h, w)
    bg_flow = const_flow(h, w, *bg_uv)
    img2 = bg2.copy()
    img1 = warp(bg2, bg_flow)
    gt = bg_flow.copy()
    dx, dy = int(fg_uv[0]), int(fg_uv[1])
    for _ in range(n_boxes):
        bh = int(rng.uniform(0.15, 0.35) * h)
        bw = int(rng.uniform(0.1, 0.25) * w)
        patch = textured(rng, bh, bw)
        y0 = int(rng.integers(max(0, -dy), h - bh - max(0, dy)))
        x0 = int(rng.integers(max(0, -dx), w - bw - max(0, dx)))
        img1[y0 : y0 + bh, x0 : x0 + bw] = patch
        img2[y0 + dy : y0 + dy + bh, x0 + dx : x0 + dx + bw] = patch
        gt[y0 : y0 + bh, x0 : x0 + bw] = (dx, dy)
    return img1.astype(np.float32), img2.astype(np.float32), gt


def cartoon(rng, h, w, cells=60):
    """Flat-colour Voronoi cells: piecewise-constant colour, step edges."""
    cy = rng.uniform(0, h, cells)
    cx = rng.uniform(0, w, cells)
    colors = rng.random((cells, 3))
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float32)
    d = (ys[None] - cy[:, None, None]) ** 2 + (
        xs[None] - cx[:, None, None]
    ) ** 2
    lbl = np.argmin(d, 0)
    return colors[lbl].astype(np.float32)


def stripes(rng, h, w):
    """Anisotropic oriented stripes at three scales + phase noise."""
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float64)
    img = np.zeros((h, w, 3))
    for (fy, fx), amp in (((0.9, 0.45), 0.4), ((0.2, 0.8), 0.35),
                          ((0.05, 0.12), 0.25)):
        th = rng.uniform(0, 2 * np.pi, 3)
        period = rng.uniform(9, 26)
        phase = 2 * np.pi * (fy * ys + fx * xs) / period
        for c in range(3):
            img[..., c] += amp * 0.5 * (1 + np.sin(phase + th[c]))
    return np.clip(img, 0, 1).astype(np.float32)


def sine_flow(h, w, au, av, period_frac=0.45):
    """Smooth sinusoidal field: continuously varying, not affine."""
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float32)
    ky = 2 * np.pi / (h * period_frac)
    kx = 2 * np.pi / (w * period_frac)
    u = au * np.sin(kx * xs) * np.cos(0.5 * ky * ys)
    v = av * np.cos(kx * xs * 0.7) * np.sin(ky * ys)
    return np.stack([u, v], -1).astype(np.float32)


def disk_layered_scene(rng, h, w, bg_uv, fg_uv, tex_fn, n_disks=3):
    """Two-layer occlusion with disk foregrounds: independently textured
    disks at integer motion over a warped background."""
    bg2 = tex_fn(rng, h, w)
    bg_flow = const_flow(h, w, *bg_uv)
    img2 = bg2.copy()
    img1 = warp(bg2, bg_flow)
    gt = bg_flow.copy()
    dx, dy = int(fg_uv[0]), int(fg_uv[1])
    ys, xs = np.mgrid[0:h, 0:w]
    for _ in range(n_disks):
        r = int(rng.uniform(0.08, 0.16) * min(h, w))
        y0 = int(rng.integers(r + max(0, -dy), h - r - max(0, dy)))
        x0 = int(rng.integers(r + max(0, -dx), w - r - max(0, dx)))
        patch = tex_fn(rng, h, w)
        m1 = (ys - y0) ** 2 + (xs - x0) ** 2 <= r * r
        m2 = (ys - y0 - dy) ** 2 + (xs - x0 - dx) ** 2 <= r * r
        img1[m1] = patch[m1]
        img2[m2] = np.roll(patch, (dy, dx), axis=(0, 1))[m2]
        gt[m1] = (dx, dy)
    return img1.astype(np.float32), img2.astype(np.float32), gt


def _write_case(d, img1, img2, gt, kitti):
    os.makedirs(d, exist_ok=True)
    write_ppm(os.path.join(d, "frame10.ppm"),
              (img1 * 255 + 0.5).astype(np.uint8))
    write_ppm(os.path.join(d, "frame11.ppm"),
              (img2 * 255 + 0.5).astype(np.uint8))
    if kitti:
        write_kitti_flow(os.path.join(d, "flow10.png"), gt)
    else:
        write_flo(os.path.join(d, "flow10.flo"), gt)
    print(f"  {os.path.basename(d)}: {gt.shape[0]}x{gt.shape[1]}  "
          f"|gt| max {np.abs(gt).max():.1f}")
    return d


def save_pair(root, name, img1, img2, gt, kitti=False):
    """Write the frames (float RGB in [0, 1], rounded to uint8) and the
    ground truth of one sequence to ``root``/``name``; returns the
    directory."""
    return _write_case(os.path.join(root, name), img1, img2, gt, kitti)


def save_seq(root, name, gt, rng, kitti=False):
    """A sequence of ``gt``'s motion on a fresh texture: frame 11 is the
    texture, frame 10 its inverse warp along ``gt``."""
    h, w = gt.shape[:2]
    img2 = textured(rng, h, w)
    return _write_case(os.path.join(root, name), warp(img2, gt), img2, gt,
                       kitti)


def _middlebury(root, rng):
    mb = os.path.join(root, "middlebury_synth")
    h, w = 480, 640
    print("middlebury_synth (480x640):")
    save_seq(mb, "trans_small", const_flow(h, w, 3.2, 1.7), rng)
    save_seq(mb, "trans_mid", const_flow(h, w, 12.4, -7.8), rng)
    save_seq(mb, "trans_large", const_flow(h, w, 42.0, 13.0), rng)
    save_seq(mb, "affine", affine_flow(h, w, 4, -2, 6, -3, 0, 4), rng)
    save_seq(mb, "rotation", rotation_flow(h, w, 1.2), rng)
    save_seq(mb, "zoom", rotation_flow(h, w, 0.0, zoom=1.04), rng)
    save_seq(mb, "shear", affine_flow(h, w, 1, 1, 0, 9, 7, 0), rng)
    save_seq(
        mb, "piecewise",
        piecewise_flow(h, w, [(6, 2), (-9, 4), (2, -11), (15, 8)], rng), rng,
    )


def _sintel(root, rng):
    st = os.path.join(root, "sintel_stress")
    h, w = 436, 1024
    print("sintel_stress (436x1024):")
    save_seq(st, "large_disp_80", const_flow(h, w, 80.0, 24.0), rng)
    save_seq(st, "large_disp_120", const_flow(h, w, -120.0, 15.0), rng)
    img1, img2, gt = layered_scene(rng, h, w, (9.0, 3.0), (-70.0, 20.0))
    save_pair(st, "layered", img1, img2, gt)
    save_seq(st, "zoom_rot", rotation_flow(h, w, 2.5, zoom=1.06), rng)


def _kitti(root, rng):
    kt = os.path.join(root, "kitti_fixtures")
    h, w = 375, 1242
    print("kitti_fixtures (375x1242, PNG16 ground truth):")
    save_seq(kt, "forward_35", affine_flow(h, w, 35, 2, -10, 3, 0, 1),
             rng, kitti=True)
    save_seq(kt, "forward_60", affine_flow(h, w, 60, 1, -22, 4, 0, 2),
             rng, kitti=True)
    save_seq(kt, "yaw", affine_flow(h, w, -28, 3, 14, -2, 1, 1),
             rng, kitti=True)
    img1, img2, gt = layered_scene(rng, h, w, (18.0, 1.0), (-45.0, 3.0))
    save_pair(kt, "layered_traffic", img1, img2, gt, kitti=True)


def _holdout(root, rng):
    ho = os.path.join(root, "holdout")
    print("holdout (fresh seed + unseen content; never used for tuning):")
    h, w = 480, 640
    img2 = cartoon(rng, h, w)
    gt = const_flow(h, w, 17.3, -6.1)
    save_pair(ho, "cartoon_trans", warp(img2, gt), img2, gt)
    img2 = cartoon(rng, h, w)
    gt = rotation_flow(h, w, 1.8, zoom=1.05)
    save_pair(ho, "cartoon_rot_zoom", warp(img2, gt), img2, gt)

    h, w = 436, 1024
    img2 = stripes(rng, h, w)
    gt = const_flow(h, w, -95.0, 18.0)
    save_pair(ho, "stripes_large_disp", warp(img2, gt), img2, gt)
    img2 = stripes(rng, h, w)
    gt = sine_flow(h, w, 6.0, 4.5)
    save_pair(ho, "sine_warp", warp(img2, gt), img2, gt)

    h, w = 480, 640
    img1, img2, gt = disk_layered_scene(
        rng, h, w, (11.0, -4.0), (-38.0, 14.0), cartoon
    )
    save_pair(ho, "disk_layered", img1, img2, gt)
    img1, img2, gt = disk_layered_scene(
        rng, h, w, (7.0, 2.0), (26.0, -19.0), stripes
    )
    save_pair(ho, "disk_layered_stripes", img1, img2, gt)


def build(root: str = "evalset") -> List[str]:
    """Write the four groups under ``root``; returns their directories.
    The first three draw from one generator, in this order."""
    rng = np.random.default_rng(SEED)
    for fn in (_middlebury, _sintel, _kitti):
        fn(root, rng)
    _holdout(root, np.random.default_rng(HOLDOUT_SEED))
    print("done ->", root)
    return [os.path.join(root, g) for g in GROUPS]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m eppm_tpu_torch.evalset",
                                description=__doc__.split("\n\n")[0])
    p.add_argument("--root", default="evalset")
    args = p.parse_args(argv)
    build(args.root)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
