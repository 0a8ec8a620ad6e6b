"""Headline benchmark of the port (counterpart of the JAX package's
``bench.py``): pairs a second of the whole pipeline on a synthetic
640x480 pair, behind two quality gates, and the device time of a 1080p
pair.

    python -m eppm_tpu_torch.bench.bench [--size HxW] [--pairs N]
                                         [--batches N] [--seed N]

Prints one JSON line:

  {"metric": "synthetic_640x480_fps", "value": N, "unit": "frames/sec",
   "vs_baseline": N, ...}

* Throughput: ``--batches`` batches (5) of ``--pairs`` pairs (8), each
  batch run back to back through ``compute_flow_jit`` (one CUDA graph of
  the pair, replayed) and each flow read back to the host; the value is
  the median over the batches of pairs a second, with the least, the
  most and the count beside it.
* Gates: the flow is finite and its warp error is under 0.5x the
  zero-flow one; the interior EPE (16 px in) of the (7, -4) pair is
  under 1.0.  A gate that fails prints ``value: 0`` and an ``error`` and
  exits 1.
* 1080p: ``hd1080p_device_ms``, the median of 10 replays' device time
  (CUDA events; the least beside it), and ``hd1080p_fps`` from it.

The pairs are ``testing.shifted_pair``: (3, -2) at ``--size`` (480x640),
(7, -4) for the EPE gate, (5, 3) at 1080p, seeded from ``--seed``.
``vs_baseline`` is the value over 4.0 fps, the CVPR-2014 paper's
GPU-class figure for its method at this size.  With ``--device cpu``
the line holds the gates and no time or rate, and the 1080p pair is
left out.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from typing import List, Optional

from ..graphs import GRAPHS
from ..pipeline import compute_flow_jit
from ..testing import shifted_pair
from . import _timing as T

BASELINE_FPS = 4.0
HD_REPLAYS = 10


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(prog="python -m eppm_tpu_torch.bench.bench",
                                description=__doc__.split("\n\n")[0])
    T.add_common(p)
    p.add_argument("--size", default="480x640", help="HxW of the pairs")
    p.add_argument("--pairs", type=int, default=8, help="pairs a batch")
    p.add_argument("--batches", type=int, default=5)
    args = p.parse_args(argv)
    device = T.device_of(args.device)
    card = device.type == "cuda"
    h, w = T.parse_size(args.size)
    GRAPHS.clear()

    f1, f2 = shifted_pair(h, w, 3, -2, args.seed)
    img1, img2 = T.frames((f1, f2), device)
    if card:  # builds the kernels, captures the graph
        compute_flow_jit(img1, img2).cpu()

    fps = []
    with T.window("bench throughput"):
        for _ in range(args.batches):
            t0 = time.perf_counter()
            flows = [compute_flow_jit(img1, img2) for _ in range(args.pairs)]
            outs = [f.cpu().numpy() for f in flows]
            fps.append(args.pairs / (time.perf_counter() - t0))
    flow = outs[0]
    finite, we, we0, warp_ok = T.warp_gate(f1, f2, flow)

    s1, s2 = shifted_pair(h, w, 7, -4, args.seed + 1)
    fsyn = compute_flow_jit(*T.frames((s1, s2), device)).cpu().numpy()
    epe = T.interior_epe(fsyn, 7, -4)

    line = {"metric": f"synthetic_{w}x{h}_fps", "unit": "frames/sec"}
    gates = {"finite": finite, "warp_error": we, "zero_flow_warp_error": we0,
             "warp_ratio": we / we0, "synthetic_epe": epe}
    about = {"device": T.card_label(device), "pairs": "synthetic "
             f"(testing.shifted_pair, seed {args.seed})"}
    if not (warp_ok and epe < 1.0):
        if card:
            line.update(value=0.0, vs_baseline=0.0)
        line.update(gates, error=f"quality gate failed: warp {we:.4f} vs "
                    f"zero-flow {we0:.4f}, synthetic EPE {epe:.3f}", **about)
        print(json.dumps(line))
        return 1
    if card:
        value = statistics.median(fps)
        line.update(value=value, vs_baseline=value / BASELINE_FPS,
                    fps_min=min(fps), fps_max=max(fps), batches=len(fps),
                    pairs_per_batch=args.pairs)
        line.update(hd1080p(device, args.seed + 2))
    line.update(gates, **about)
    print(json.dumps(line))
    return 0


def hd1080p(device, seed: int) -> dict:
    """The device time of a replayed 1080p pair: median and least of
    ``HD_REPLAYS`` replays after the capture."""
    img1, img2 = T.frames(shifted_pair(1080, 1920, 5, 3, seed), device)
    compute_flow_jit(img1, img2).cpu()
    with T.window("bench 1080p"):
        ms = T.event_ms(lambda: compute_flow_jit(img1, img2), HD_REPLAYS)
    med = statistics.median(ms)
    return {"hd1080p_device_ms": med, "hd1080p_device_ms_min": min(ms),
            "hd1080p_replays": len(ms), "hd1080p_fps": 1e3 / med}


if __name__ == "__main__":
    sys.exit(main())
