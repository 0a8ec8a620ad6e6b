"""Command line for one frame pair (the single-pair subset of
``eppm_tpu/cli.py``):

  python -m eppm_tpu_torch.cli f1.ppm f2.ppm -o flow.flo [--set k=v]
                                [--time] [--device cuda|cpu]

The flow runs on the CUDA device by default and raises where there is
none; ``--device cpu`` runs the plain PyTorch versions of the kernels.
``--set`` takes dotted config paths, e.g. ``--set refine.blf_sigma_spatial=3.0``.
"""

from __future__ import annotations

import argparse
import ast
import dataclasses
import json
import time
from typing import Any, List, Optional

import numpy as np
import torch

from .config import DEFAULT_CONFIG, EPPMConfig
from .io import read_ppm, write_flo
from .pipeline import compute_flow

__all__ = ["main", "apply_overrides"]


def apply_overrides(cfg: EPPMConfig, overrides: List[str]) -> EPPMConfig:
    """Apply "dotted.path=value" overrides to the (frozen) config tree;
    values parse as Python literals, else as strings."""
    for ov in overrides:
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
    img = read_ppm(path)
    if img.ndim != 3 or img.dtype != np.uint8:
        raise SystemExit(f"{path}: expected an 8-bit RGB image (P3/P6)")
    return torch.from_numpy(img).to(device)


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m eppm_tpu_torch.cli",
        description="EPPM optical flow for one frame pair (PyTorch/CUDA).",
    )
    p.add_argument("frame1", help="first frame (PPM)")
    p.add_argument("frame2", help="second frame (PPM)")
    p.add_argument("-o", "--out", help="write the flow as .flo")
    p.add_argument("--set", action="append", default=[], metavar="K=V",
                   help="override a config field (dotted path), repeatable")
    p.add_argument("--time", action="store_true",
                   help="report the wall time of the flow computation")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="device to run on (default cuda; raises without one)")
    args = p.parse_args(argv)

    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --device cpu to run on the CPU")
    device = torch.device(args.device)
    cfg = apply_overrides(DEFAULT_CONFIG, args.set)
    img1 = _load(args.frame1, device)
    img2 = _load(args.frame2, device)
    if img1.shape != img2.shape:
        raise SystemExit(f"frame shapes differ: {tuple(img1.shape)} vs "
                         f"{tuple(img2.shape)}")

    t0 = time.perf_counter()
    flow = compute_flow(img1, img2, cfg)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    seconds = time.perf_counter() - t0
    flow = flow.cpu().numpy()
    if args.out:
        write_flo(args.out, flow)
    report = {"shape": list(flow.shape), "device": str(device)}
    if device.type == "cuda":
        report["device_name"] = torch.cuda.get_device_name(device)
    if args.time:
        report["seconds"] = seconds
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
