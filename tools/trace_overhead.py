"""The cost of the port's tracer on the card: pairs alternating the
untraced and the traced graph of one shape, in one process.

    python3 tools/trace_overhead.py [--pairs 50] [--sizes 480x640,1080x1920]

For each size both graphs are captured first (``compute_flow_jit`` with
tracing off, then on).  Then ``--pairs`` rounds, each running the two in
turn (untraced first in even rounds, traced first in odd ones; the card's
replay state lasts seconds, so neighbours share it): the whole entry
(``compute_flow_jit``: copies in, replay, clone out, and with tracing on
its host spans) timed on the host clock to a synchronisation, and the
replay alone (``FlowGraph.run``) between CUDA events.  One JSON line a
size: the median of the per-round differences (traced minus untraced) of
both, each side's median, the mark nodes of the traced graph (its nodes
less the untraced one's) and whether the flows are equal; the card's name
and power limit first.  Runs on the card only (no jax).
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from eppm_tpu_torch.graphs import GRAPHS, graph_key  # noqa: E402
from eppm_tpu_torch.config import DEFAULT_CONFIG  # noqa: E402
from eppm_tpu_torch.pipeline import compute_flow_jit  # noqa: E402
from eppm_tpu_torch.testing import shifted_pair  # noqa: E402
from eppm_tpu_torch.utils import trace  # noqa: E402


def entry_ms(a, b, traced: bool) -> float:
    (trace.enable if traced else trace.disable)()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    compute_flow_jit(a, b)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def replay_ms(entry) -> float:
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    entry.run()
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


def measure(h: int, w: int, pairs: int) -> dict:
    GRAPHS.clear()
    dev = torch.device("cuda", 0)
    a, b = (torch.from_numpy(f).to(dev) for f in shifted_pair(h, w, 5, 3, 0))
    trace.disable()
    plain = compute_flow_jit(a, b)
    off = GRAPHS.entries[graph_key(a, b, DEFAULT_CONFIG, False, None, None)]
    trace.enable()
    flow = compute_flow_jit(a, b)
    on = GRAPHS.entries[graph_key(a, b, DEFAULT_CONFIG, False, None, None)]
    sides = {"untraced": ([], []), "traced": ([], [])}
    for r in range(pairs):
        order = ("untraced", "traced") if r % 2 == 0 else ("traced",
                                                             "untraced")
        for side in order:
            e, g = sides[side]
            e.append(entry_ms(a, b, side == "traced"))
            trace.enable() if side == "traced" else trace.disable()
            g.append(replay_ms(on if side == "traced" else off))
        trace.enable()
        trace.collect()   # keeps the ring's rows from piling up unread
    trace.disable()
    nodes_off = sum(off.nodes()["total"].values())
    nodes_on = on.nodes()["total"]
    out = {"size": f"{h}x{w}", "pairs": pairs,
           "flows_equal": bool(torch.equal(plain, flow)),
           "mark_nodes": nodes_on["mark"],
           "other_nodes_equal": sum(nodes_on.values()) - nodes_on["mark"]
           == nodes_off}
    for i, what in enumerate(("entry_ms", "replay_ms")):
        un, tr = sides["untraced"][i], sides["traced"][i]
        out[what] = {"untraced": statistics.median(un),
                     "traced": statistics.median(tr),
                     "median_diff": statistics.median(
                         t - u for t, u in zip(tr, un))}
    GRAPHS.clear()
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--pairs", type=int, default=50)
    p.add_argument("--sizes", default="480x640,1080x1920")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: the tracer's cost is the card's")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(json.dumps({"card": smi.stdout.strip()}), flush=True)
    for size in args.sizes.split(","):
        h, w = (int(v) for v in size.split("x"))
        print(json.dumps(measure(h, w, args.pairs)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
