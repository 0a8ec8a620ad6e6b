"""Multi-resolution table of the port (counterpart of the JAX package's
``tools/bench_table.py``): end-to-end and device ms of a pair at 640x480,
1242x375 (KITTI), 1080p and 4K, through ``compute_flow_jit``.

    python -m eppm_tpu_torch.bench.bench_table [--shape HxW ...]
        [--set k=v] [--out FILE] [--seed N]

For each shape (``--shape``, repeatable, replaces the four): the first
call captures the pair's CUDA graph, then
* ``e2e_ms``: host clock around a call and the flow's read back to the
  host; ``device_ms``: CUDA events around a replayed call; medians of 5
  calls each (3 at 4K), with the least; ``fps_e2e`` from ``e2e_ms``;
* ``graph``: the capture's warm-up, capture and instantiation seconds,
  ``pair_bytes`` (device memory the capture allocated above what was
  allocated before it) and ``max_allocated`` (``graphs.FlowGraph``), and
  ``pool_reserved_bytes``: how much ``torch.cuda.memory_reserved`` grew
  over the capture, the cache emptied before and after, i.e. what the
  cached graph holds;
* the gate: finite flow with a warp error under 0.5x the zero-flow one.

The pairs are synthetic (``testing.shifted_pair``: (3, -2) at 640x480,
(5, 3) at the others, seeded from ``--seed``).  ``--set`` overrides the
config as the command line does (``--set match_engine=patchmatch`` for
the PatchMatch table).  The table prints as one JSON line; ``--out``
also writes it to a new file (an existing file is refused).  With
``--device cpu`` each shape holds the gate and no time.  Exits 1 if a
gate fails.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time
from typing import List, Optional

import torch

from ..cli import apply_overrides
from ..config import DEFAULT_CONFIG
from ..graphs import GRAPHS, graph_key
from ..pipeline import compute_flow_jit
from ..testing import shifted_pair
from . import _timing as T

SHAPES = ((480, 640), (375, 1242), (1080, 1920), (2160, 3840))
NAMES = {(480, 640): "synthetic_640x480", (375, 1242): "kitti_1242x375",
         (1080, 1920): "hd_1080p", (2160, 3840): "uhd_4k"}


def reps_for(h: int, w: int) -> int:
    return 3 if h * w >= 2160 * 3840 else 5


def time_shape(h: int, w: int, cfg, device, seed: int) -> dict:
    """One shape's row (see the module's docstring)."""
    dx, dy = (3, -2) if (h, w) == (480, 640) else (5, 3)
    f1, f2 = shifted_pair(h, w, dx, dy, seed)
    img1, img2 = T.frames((f1, f2), device)
    row = {"shape": [h, w], "shift": [dx, dy]}
    if device.type != "cuda":
        flow = compute_flow_jit(img1, img2, cfg=cfg).numpy()
    else:
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(device)
        flow = compute_flow_jit(img1, img2, cfg=cfg).cpu().numpy()
        torch.cuda.empty_cache()
        entry = GRAPHS.entries[graph_key(img1, img2, cfg, False, None, None)]
        row["graph"] = {
            "warmup_s": entry.warmup_s, "capture_s": entry.capture_s,
            "instantiate_s": entry.instantiate_s,
            "pair_bytes": entry.pair_bytes,
            "max_allocated": entry.max_allocated,
            "pool_reserved_bytes":
                torch.cuda.memory_reserved(device) - reserved}
        n = reps_for(h, w)
        e2e = []
        with T.window(f"bench_table {h}x{w}"):
            for _ in range(n):
                t0 = time.perf_counter()
                compute_flow_jit(img1, img2, cfg=cfg).cpu()
                e2e.append((time.perf_counter() - t0) * 1e3)
            dev = T.event_ms(lambda: compute_flow_jit(img1, img2, cfg=cfg), n)
        row.update(e2e_ms=statistics.median(e2e), e2e_ms_min=min(e2e),
                   device_ms=statistics.median(dev), device_ms_min=min(dev),
                   fps_e2e=1e3 / statistics.median(e2e), n=n)
    finite, we, we0, ok = T.warp_gate(f1, f2, flow)
    row.update(finite=finite, warp_ratio=we / we0, gate=ok)
    return row


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m eppm_tpu_torch.bench.bench_table",
        description=__doc__.split("\n\n")[0])
    T.add_common(p, sets=True)
    p.add_argument("--shape", action="append", default=[], metavar="HxW",
                   help="a shape to time, repeatable (default: the four)")
    p.add_argument("--out", help="also write the table to this new file")
    args = p.parse_args(argv)
    if args.out and os.path.exists(args.out):
        raise SystemExit(f"--out {args.out}: the file exists; the table is "
                         "written only to a new file")
    device = T.device_of(args.device)
    cfg = apply_overrides(DEFAULT_CONFIG, args.sets)
    shapes = [T.parse_size(s) for s in args.shape] or SHAPES
    GRAPHS.clear()
    captures, evictions = GRAPHS.captures, GRAPHS.evictions

    table = {}
    for h, w in shapes:
        row = time_shape(h, w, cfg, device, args.seed)
        table[NAMES.get((h, w), f"synthetic_{w}x{h}")] = row
    out = {"table": table, "device": T.card_label(device),
           "pairs": f"synthetic (testing.shifted_pair, seed {args.seed})",
           "overrides": list(args.sets),
           "graphs": {"captures": GRAPHS.captures - captures,
                      "evictions": GRAPHS.evictions - evictions}}
    print(json.dumps(out))
    if args.out:
        with open(args.out, "x") as f:
            json.dump(out, f, indent=2)
    return 0 if all(r["gate"] for r in table.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
