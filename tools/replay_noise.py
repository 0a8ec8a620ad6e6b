#!/usr/bin/env python3
"""Replay-time noise of the port's CUDA graphs on the card.

    python3 tools/replay_noise.py --out DIR [--replays 120] [--rounds 100]

1. A synthetic 640x480 pair through ``compute_flow_jit``: captured, then
   replayed ``--replays`` times back to back, each replay's device ms by
   CUDA events, while ``nvidia-smi`` samples the SM and memory clocks,
   the power, the temperature and the clock-event reasons every 100 ms
   (DIR/smi.csv; the replays with their start times in DIR/replays.txt).
2. Parts of the coarse match (``ops/match.py::match_coarse_bidi`` at the
   pair's 120x160 coarse level) each as a graph of its own, replayed in
   turn for ``--rounds`` rounds: the whole match, its global float64
   sweep (``global_match_bidi``), 10 float64 GEMMs of the sweep's block
   shape, the exact cost at K=1 (``patch_cost_stack``), and a chain of
   20,000 tiny kernels (an add on 256 floats): each round's ms.
3. One replay of the pair under ``torch.profiler``: the sum of its
   device events against the replay's own time.

Each section prints its medians and extremes and each replay's ms, with
the card's name and power limit.  Imports torch and the port only.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import statistics
import subprocess
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from eppm_tpu_torch.bench import _timing as T  # noqa: E402
from eppm_tpu_torch.config import DEFAULT_CONFIG as cfg  # noqa: E402
from eppm_tpu_torch.eval_report import card_label  # noqa: E402
from eppm_tpu_torch.graphs import GRAPHS, capture  # noqa: E402
from eppm_tpu_torch.ops._util import grid  # noqa: E402
from eppm_tpu_torch.ops.cost import (make_patch_stack,  # noqa: E402
                                     patch_cost_stack)
from eppm_tpu_torch.ops.match import (global_match_bidi,  # noqa: E402
                                      match_coarse_bidi, patch_descriptors)
from eppm_tpu_torch.pipeline import (compute_flow_jit,  # noqa: E402
                                     prepare_pyramids)
from eppm_tpu_torch.testing import shifted_pair  # noqa: E402

SMI_FIELDS = ("timestamp,clocks.sm,clocks.mem,power.draw,temperature.gpu,"
              "clocks_event_reasons.active")


def line(label: str, ms) -> None:
    print(f"{label}: median {statistics.median(ms):.3f} ms, least "
          f"{min(ms):.3f}, most {max(ms):.3f}, n {len(ms)}")
    print("  " + " ".join(f"{m:.2f}" for m in ms), flush=True)


def pair_replays(img1, img2, n: int, out: str) -> None:
    """Section 1."""
    compute_flow_jit(img1, img2).cpu()
    ms, starts = [], []
    with open(os.path.join(out, "smi.csv"), "w") as log:
        smi = subprocess.Popen(
            ["nvidia-smi", f"--query-gpu={SMI_FIELDS}",
             "--format=csv,noheader", "-lms", "100"], stdout=log,
            stderr=subprocess.STDOUT)
        t0 = time.time()
        try:
            for _ in range(n):
                starts.append(time.time() - t0)
                ms += T.event_ms(lambda: compute_flow_jit(img1, img2), 1)
        finally:
            smi.terminate()
            smi.wait()
    with open(os.path.join(out, "replays.txt"), "w") as f:
        stamp = time.strftime("%Y/%m/%d %H:%M:%S", time.localtime(t0))
        f.write(f"start {stamp}\n")
        for s, m in zip(starts, ms):
            f.write(f"{s:.3f} {m:.3f}\n")
    line("640x480 pair, replays back to back", ms)


def match_parts(img1, img2, rounds: int) -> None:
    """Section 2."""
    levels1, packs1 = prepare_pyramids(img1, cfg)
    levels2, packs2 = prepare_pyramids(img2, cfg)
    l1, l2, p1, p2 = levels1[-1], levels2[-1], packs1[-1], packs2[-1]
    h, w = p1.shape[:2]
    exact = dataclasses.replace(cfg.cost,
                                patch_stride=cfg.match.exact_tap_stride)
    stack2 = make_patch_stack(p2, exact.tap_offsets, dtype=torch.bfloat16)
    ys, xs = grid(h, w, p1.device)
    a64 = torch.randn(h * w, 275, dtype=torch.float64, device=p1.device)
    b64 = torch.randn(cfg.match.global_block, 275, dtype=torch.float64,
                      device=p1.device)

    def tiny(x):
        for _ in range(20000):
            x = x + 1.0
        return x

    parts = {
        "match_coarse_bidi": (lambda a, b, q1, q2: match_coarse_bidi(
            a, b, cfg.cost, cfg.match, q1, q2, tap_chunk=cfg.cost_tap_chunk),
            dict(a=l1, b=l2, q1=p1, q2=p2)),
        "global_match_bidi (the float64 sweep)": (
            lambda d1, d2: global_match_bidi(d1, d2, cfg.match.global_block),
            dict(d1=patch_descriptors(p1, cfg.match),
                 d2=patch_descriptors(p2, cfg.match))),
        "10 float64 GEMMs": (lambda a, b: [a @ b.T for _ in range(10)],
                             dict(a=a64, b=b64)),
        "patch_cost_stack K=1": (lambda q1, st, tx, ty: patch_cost_stack(
            q1, st, tx[None], ty[None], exact, exact.tap_offsets),
            dict(q1=p1, st=stack2, tx=xs.contiguous(), ty=ys.contiguous())),
        "20,000 tiny kernels": (tiny, dict(
            x=torch.zeros(256, device=p1.device))),
    }
    graphs = {k: capture(("replay_noise", k), fn, inputs)
              for k, (fn, inputs) in parts.items()}
    ms = {k: [] for k in graphs}
    for _ in range(rounds):
        for k, g in graphs.items():
            ms[k] += T.event_ms(g.run, 1)
    for k, v in ms.items():
        line(f"{k}, in turn with the others", v)


def profiled_replay(img1, img2) -> None:
    """Section 3."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        ms = T.event_ms(lambda: compute_flow_jit(img1, img2), 1)[0]
    busy = sum(e.self_device_time_total for e in prof.key_averages()
               if e.self_device_time_total > 0) / 1e3
    events = sum(e.count for e in prof.key_averages()
                 if e.self_device_time_total > 0)
    print(f"one profiled replay: {ms:.3f} ms, device events {events}, their "
          f"sum {busy:.3f} ms ({busy / ms:.1%})", flush=True)


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--out", required=True, help="directory for smi.csv and "
                   "replays.txt")
    p.add_argument("--replays", type=int, default=120)
    p.add_argument("--rounds", type=int, default=100)
    args = p.parse_args()
    device = T.device_of("cuda")
    os.makedirs(args.out, exist_ok=True)
    print(card_label(device), flush=True)
    GRAPHS.clear()
    img1, img2 = T.frames(shifted_pair(480, 640, 3, -2, 0), device)
    pair_replays(img1, img2, args.replays, args.out)
    match_parts(img1, img2, args.rounds)
    profiled_replay(img1, img2)
    return 0


if __name__ == "__main__":
    sys.exit(main())
