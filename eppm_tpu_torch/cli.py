"""Command line for one frame pair, a stream of frames or a directory of
sequences with ground truth (counterpart of ``eppm_tpu/cli.py``):

  python -m eppm_tpu_torch.cli f1.ppm f2.ppm -o flow.flo [--viz flow.png]
                                [--gt gt.flo|gt.png [--border N]] [--time]
                                [--set k=v] [--device cuda|cpu] [--json]
  python -m eppm_tpu_torch.cli --frames-dir DIR --out-dir OUT [--temporal]
                                [--exact-readback] [--set k=v] [--device ...]
  python -m eppm_tpu_torch.cli --eval-dir DIR [--pattern F1,F2,GT]
                                [--border N] [--set k=v] [--json]
  python -m eppm_tpu_torch.cli a.ppm b.ppm --set match_engine=patchmatch
  python -m eppm_tpu_torch.cli a.ppm b.ppm --mesh 1,2,2 [--device cpu]

Frames are PPM/PGM/PNM or PNG.  The stream computes the flow of every
consecutive pair of DIR's frames (sorted by name) and writes OUT/<first
frame's name>.flo for each; ``--temporal`` warm-starts each pair from the
previous pair's flow, which stays on the device.  ``--gt`` scores the flow
against a Middlebury .flo or a KITTI 16-bit PNG (its invalid pixels
skipped): EPE, AAE in degrees and the share of pixels off by more than 3
px; ``--eval-dir`` does so for every sequence directory of DIR holding
the files of ``--pattern``.  The flow runs on the CUDA device by default
and raises where there is none; ``--device cpu`` runs the plain PyTorch
versions of the kernels.  ``--set`` takes dotted config paths, e.g.
``--set refine.blf_sigma_spatial=3.0``, and ``--set preset=fast`` the
overrides of a preset (``PRESETS``), ahead of the others.  ``--mesh
B,Y,X`` runs each pair through the multi-device path
(``parallel.compute_flow_sharded``) on a (B, Y, X) mesh of the CUDA
devices 0..n-1 (it raises where there are fewer), or with ``--device
cpu`` of the CPU named n times; one pair at a time, so B is 1.  The
single-pair and stream reports are one JSON line; the ``--eval-dir``
report is indented unless ``--json``.
"""

from __future__ import annotations

import argparse
import ast
import dataclasses
import json
import os
import queue
import threading
import time
from typing import Any, List, Optional

import numpy as np
import torch

from .config import DEFAULT_CONFIG, UNKNOWN_FLOW, EPPMConfig
from .io import (IMAGE_EXTS, read_flo, read_image, read_image_batch,
                 read_kitti_flow, write_flo, write_png, write_ppm)
from .metrics import bad_pixel_rate, flow_error
from .ops.color import flow_to_color
from .parallel import compute_flow_sharded, make_mesh
from .pipeline import compute_flow
from .utils.timing import DeviceTimer

__all__ = ["main", "apply_overrides", "PRESETS"]

# Named presets (``eppm_tpu/cli.py::PRESETS``): ``--set preset=NAME``
# expands to these overrides ahead of every other override.  "fast": the
# plus-shaped candidate set, a sparser pass-1 grid (radius 8, stride 4)
# and the radius-6 final smoothing.
PRESETS = {
    "fast": [
        "dense_cand_shape=plus",
        "cost.patch_stride=4",
        "cost.patch_radius=8",
        "refine.blf_sigma_spatial=3.0",
    ],
}


def apply_overrides(cfg: EPPMConfig, overrides: List[str]) -> EPPMConfig:
    """Apply "dotted.path=value" overrides to the (frozen) config tree;
    values parse as Python literals, else as strings.  ``preset=NAME``
    expands to the preset's overrides, which go first wherever it stands,
    so an explicit override always wins over a preset's."""
    presets: List[str] = []
    user: List[str] = []
    for ov in overrides:
        if ov.startswith("preset="):
            name = ov.split("=", 1)[1]
            if name not in PRESETS:
                raise SystemExit(f"unknown preset {name!r} (have: "
                                 f"{sorted(PRESETS)})")
            presets.extend(PRESETS[name])
        else:
            user.append(ov)
    for ov in presets + user:
        if "=" not in ov:
            raise SystemExit(f"--set expects key=value, got {ov!r}")
        path, raw = ov.split("=", 1)
        try:
            value: Any = ast.literal_eval(raw)
        except (ValueError, SyntaxError):
            value = raw

        def rebuild(node, keys):
            if keys[0] not in {f.name for f in dataclasses.fields(node)}:
                raise SystemExit(f"unknown config field {path!r}")
            if len(keys) == 1:
                return dataclasses.replace(node, **{keys[0]: value})
            child = rebuild(getattr(node, keys[0]), keys[1:])
            return dataclasses.replace(node, **{keys[0]: child})

        cfg = rebuild(cfg, path.split("."))
    return cfg


def _load(path: str, device: torch.device) -> torch.Tensor:
    img = read_image(path)
    if img.dtype != np.uint8:
        raise SystemExit(f"{path}: expected an 8-bit image")
    return torch.from_numpy(img).to(device)


def _evaluate(flow: np.ndarray, gt_path: str, border: int) -> dict:
    """EPE, AAE (degrees) and the share of pixels off by more than 3 px
    against the ground truth at ``gt_path``: a .flo, or a KITTI 16-bit
    PNG whose invalid pixels become ``UNKNOWN_FLOW`` so that the metrics
    skip them; all three over the pixels ``border`` px inside the
    frame."""
    if gt_path.lower().endswith(".png"):
        gt, valid = read_kitti_flow(gt_path)
        gt = np.where(valid[..., None], gt, np.float32(UNKNOWN_FLOW))
    else:
        gt = read_flo(gt_path)
    epe, aae = flow_error(flow, gt, border=border)
    if border > 0:
        flow = flow[border:-border, border:-border]
        gt = gt[border:-border, border:-border]
    return {"epe": epe, "aae_deg": aae,
            "bad3": bad_pixel_rate(flow, gt, thresh=3.0)}


def flow_fn(cfg: EPPMConfig, mesh=None):
    """``fn(img1, img2, init_flow=None)``: the flow of one pair on the
    frames' device, or, with a ``mesh``, through the multi-device path
    (the flow on the mesh's first device)."""
    if mesh is None:
        return lambda a, b, init=None: compute_flow(a, b, cfg,
                                                    init_flow=init)

    def sharded(a, b, init=None):
        return compute_flow_sharded(
            a[None], b[None], mesh, cfg,
            init_flows=None if init is None else init[None])[0]

    return sharded


def mesh_of(spec: str, device: torch.device):
    """The mesh of ``--mesh B,Y,X`` on ``device``'s kind: the CUDA devices
    0..n-1, or the CPU n times."""
    try:
        b, y, x = (int(v) for v in spec.split(","))
    except ValueError:
        raise SystemExit(f"--mesh expects B,Y,X, got {spec!r}")
    if b != 1:
        raise SystemExit(f"--mesh {spec}: the command line runs one pair at "
                         "a time, so B must be 1")
    devices = None if device.type == "cuda" else [device] * (b * y * x)
    try:
        return make_mesh(b, y, x, devices=devices)
    except ValueError as e:
        raise SystemExit(f"--mesh {spec}: {e}")


def evaluate_dir(eval_dir: str, pattern: str, cfg: EPPMConfig,
                 device: torch.device, border: int = 0, mesh=None,
                 names: Optional[List[str]] = None,
                 timed: bool = False) -> dict:
    """The flow of each sequence directory of ``eval_dir`` (sorted; only
    ``names`` where given) that holds the two frames of ``pattern``
    ("F1,F2,GT"), scored against its ground truth where it has one
    ({"epe": None} where not) -> {"sequences": {name: report}, "mean_epe":
    the mean of the EPEs}; with ``timed`` each report also holds the
    pair's "ms" by ``DeviceTimer`` (frames on the device to flow
    computed); on ``mesh`` through the multi-device path."""
    run = flow_fn(cfg, mesh)
    f1n, f2n, gtn = pattern.split(",")
    results = {}
    for name in sorted(os.listdir(eval_dir)):
        if names is not None and name not in names:
            continue
        d = os.path.join(eval_dir, name)
        f1, f2, gt = (os.path.join(d, n) for n in (f1n, f2n, gtn))
        if not (os.path.isfile(f1) and os.path.isfile(f2)):
            continue
        img1, img2 = _load(f1, device), _load(f2, device)
        timer = DeviceTimer(device).start()
        flow = run(img1, img2)
        ms = timer.stop() * 1e3
        flow = flow.cpu().numpy()
        results[name] = (_evaluate(flow, gt, border) if os.path.isfile(gt)
                         else {"epe": None})
        if timed:
            results[name]["ms"] = ms
    epes = [r["epe"] for r in results.values() if r["epe"] is not None]
    return {"sequences": results,
            "mean_epe": float(np.mean(epes)) if epes else None,
            **_device_report(device)}


def _device_report(device: torch.device) -> dict:
    report = {"device": str(device)}
    if device.type == "cuda":
        report["device_name"] = torch.cuda.get_device_name(device)
    return report


# Frames decoded per batch, and flows in flight between the pipeline and
# the thread that reads them back and writes them.
STREAM_CHUNK = 32
STREAM_WINDOW = 4


def q16(flow: torch.Tensor) -> torch.Tensor:
    """1/64-px int16 fixed point of a flow, on its device: half the bytes
    of float32 to read back, error at most 1/128 px; unknown flow
    saturates at 32767."""
    return torch.round(flow * 64.0).clamp(-32768.0, 32767.0).to(torch.int16)


def stream(frames_dir: str, out_dir: Optional[str], cfg: EPPMConfig,
           device: torch.device, temporal: bool = False,
           exact: bool = False, mesh=None) -> dict:
    """The flow of every consecutive pair of the frames in ``frames_dir``
    (sorted by name), written as ``out_dir``/<first frame>.flo.  Frames
    decode in chunks of ``STREAM_CHUNK``; at most ``STREAM_WINDOW`` flows
    wait for a drain thread, which reads each back (1/64-px int16 unless
    ``exact``) and writes it.  ``temporal`` hands each pair's flow, still
    on the device, to the next pair as ``init_flow``.  Returns the report:
    frames, pairs, pairs a second (after a warm-up on the first pair,
    which builds the kernels) and the device.  On ``mesh`` each pair
    runs through the multi-device path."""
    names = sorted(f for f in os.listdir(frames_dir)
                   if f.lower().endswith(IMAGE_EXTS))
    if len(names) < 2:
        raise SystemExit(f"{frames_dir}: need >= 2 frames "
                         f"({'/'.join(IMAGE_EXTS)})")
    paths = [os.path.join(frames_dir, f) for f in names]
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)

    run = flow_fn(cfg, mesh)
    first = [torch.from_numpy(f).to(device) for f in read_image_batch(paths[:2])]
    warm = run(*first)
    if temporal:
        warm = run(*first, warm)
    warm.cpu()

    fetch: "queue.Queue" = queue.Queue(maxsize=STREAM_WINDOW)
    errors: List[BaseException] = []

    def drain():
        while True:
            item = fetch.get()
            if item is None:
                return
            name, fl = item
            try:
                out = fl.cpu().numpy()
                if not exact:
                    out = out.astype(np.float32) * np.float32(1.0 / 64.0)
                if out_dir:
                    write_flo(os.path.join(
                        out_dir, os.path.splitext(name)[0] + ".flo"), out)
            except Exception as e:  # raised in the caller after the join
                errors.append(e)

    drainer = threading.Thread(target=drain, daemon=True)
    drainer.start()
    prev = prev_flow = None
    t0 = time.perf_counter()
    try:
        for start in range(0, len(paths), STREAM_CHUNK):
            frames = read_image_batch(paths[start : start + STREAM_CHUNK])
            for k in range(frames.shape[0]):
                cur = torch.from_numpy(frames[k]).to(device)
                if prev is not None:
                    fl = run(prev, cur, prev_flow)
                    if temporal:
                        prev_flow = fl
                    fetch.put((names[start + k - 1], fl if exact else q16(fl)))
                prev = cur
    finally:
        fetch.put(None)
        drainer.join()
    if errors:
        raise errors[0]
    n_pairs = len(paths) - 1
    return {"frames": len(names), "pairs": n_pairs,
            "fps": n_pairs / (time.perf_counter() - t0), "out_dir": out_dir,
            **_device_report(device)}


def write_viz(path: str, flow: torch.Tensor) -> None:
    """The Middlebury colour coding of ``flow`` as .png, else as .ppm."""
    rgb = flow_to_color(flow).cpu().numpy()
    (write_png if path.lower().endswith(".png") else write_ppm)(path, rgb)


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m eppm_tpu_torch.cli",
        description="EPPM optical flow for a frame pair or a stream of "
                    "frames (PyTorch/CUDA).",
    )
    p.add_argument("frame1", nargs="?", help="first frame (PPM/PGM/PNG)")
    p.add_argument("frame2", nargs="?", help="second frame")
    p.add_argument("-o", "--out", help="write the flow as .flo")
    p.add_argument("--viz", help="write the colour-coded flow as .ppm or .png")
    p.add_argument("--set", action="append", default=[], metavar="K=V",
                   help="override a config field (dotted path), repeatable")
    p.add_argument("--time", action="store_true",
                   help="report the wall time of the flow computation")
    p.add_argument("--frames-dir", metavar="DIR",
                   help="stream mode: the flow of every consecutive frame "
                        "pair in DIR (sorted)")
    p.add_argument("--out-dir", metavar="DIR",
                   help="stream mode: directory for the .flo outputs")
    p.add_argument("--temporal", action="store_true",
                   help="stream mode: warm-start each pair's coarse match "
                        "from the previous pair's flow")
    p.add_argument("--exact-readback", action="store_true",
                   help="stream mode: read the flow back as float32 instead "
                        "of 1/64-px int16 (error <= 1/128 px)")
    p.add_argument("--gt", help="ground truth to score the flow against: "
                                 ".flo, or a KITTI 16-bit flow PNG")
    p.add_argument("--border", type=int, default=0,
                   help="border pixels to leave out of the scores")
    p.add_argument("--eval-dir", metavar="DIR",
                   help="score every sequence directory under DIR")
    p.add_argument("--pattern", default="frame10.ppm,frame11.ppm,flow10.flo",
                   metavar="F1,F2,GT",
                   help="file names inside each sequence dir for --eval-dir")
    p.add_argument("--json", action="store_true",
                   help="one JSON line for the --eval-dir report too")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="device to run on (default cuda; raises without one)")
    p.add_argument("--mesh", metavar="B,Y,X",
                   help="run through the multi-device path on a (batch, y, "
                        "x) mesh of the device's kind")
    args = p.parse_args(argv)

    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --device cpu to run on the CPU")
    device = torch.device(args.device)
    cfg = apply_overrides(DEFAULT_CONFIG, args.set)
    mesh = mesh_of(args.mesh, device) if args.mesh else None
    if args.frames_dir:
        print(json.dumps(stream(args.frames_dir, args.out_dir, cfg, device,
                                args.temporal, args.exact_readback, mesh)))
        return 0
    if args.eval_dir:
        print(json.dumps(evaluate_dir(args.eval_dir, args.pattern, cfg,
                                      device, args.border, mesh),
                         indent=None if args.json else 2))
        return 0
    if not (args.frame1 and args.frame2):
        p.error("frame1 and frame2 are required (or --frames-dir, "
                "--eval-dir)")
    img1 = _load(args.frame1, device)
    img2 = _load(args.frame2, device)
    if img1.shape != img2.shape:
        raise SystemExit(f"frame shapes differ: {tuple(img1.shape)} vs "
                         f"{tuple(img2.shape)}")

    t0 = time.perf_counter()
    flow = flow_fn(cfg, mesh)(img1, img2)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    seconds = time.perf_counter() - t0
    if args.viz:
        write_viz(args.viz, flow)
    flow = flow.cpu().numpy()
    if args.out:
        write_flo(args.out, flow)
    report = {"shape": list(flow.shape), **_device_report(device)}
    if args.time:
        report["seconds"] = seconds
    if args.gt:
        report.update(_evaluate(flow, args.gt, args.border))
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
