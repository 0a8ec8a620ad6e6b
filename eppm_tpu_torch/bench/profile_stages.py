"""The time of each stage of the port's pipeline (counterpart of the JAX
package's ``profile_stages.py``).

    python -m eppm_tpu_torch.bench.profile_stages [HxW] [--set k=v]
        [--seed N]

On the card the real pair is timed, not a copy of its stages: the
untraced pair's graph is captured and replayed through
``compute_flow_jit`` and its nodes counted (``FlowGraph.nodes``); then,
with tracing on (``utils/trace.py``), the traced pair's graph is
captured, replayed once, then replayed 5 times, each replay between two
CUDA events (``_timing.traced_replays``), and the stages are the spans
that ``compute_flow``'s marks stamp inside each replay.  One JSON line a
stage (median, least, most ms, its share of the ``graph`` span, its
nodes by type), a ``graph`` line (the span beside the events), then a
summary line: the untraced graph's nodes, the share of the ``graph``
span that its stages leave uncovered (its self time; the stages tile it
where that is within ``TILE_TOLERANCE``), the ``graph`` span over the
events, and whether the traced flow equals the untraced one.  It exits 1
unless the stages tile, the span is within ``EVENT_TOLERANCE`` of the
events and the flows are equal.  The pair is ``testing.shifted_pair(h,
w, 5, 3)``, 1080x1920 by default.  With ``--device cpu`` the stages are
marked on the host clock: the lines hold their names and no time, and
the summary whether the traced flow equals the untraced one.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
from typing import Dict, List, Optional

import torch

from ..cli import apply_overrides
from ..config import DEFAULT_CONFIG
from ..graphs import GRAPHS, graph_key
from ..pipeline import compute_flow_jit
from ..testing import shifted_pair
from ..utils import trace
from . import _timing as T

# replays of the traced pair timed
REPS = 5
# the stages may leave at most this share of the graph span uncovered
TILE_TOLERANCE = 0.01
# the graph span may differ from the events around its replay by this share
EVENT_TOLERANCE = 0.05


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m eppm_tpu_torch.bench.profile_stages",
        description=__doc__.split("\n\n")[0])
    p.add_argument("size", nargs="?", default="1080x1920", help="HxW")
    T.add_common(p, sets=True)
    args = p.parse_args(argv)
    device = T.device_of(args.device)
    cfg = apply_overrides(DEFAULT_CONFIG, args.sets)
    h, w = T.parse_size(args.size)
    GRAPHS.clear()
    img1, img2 = T.frames(shifted_pair(h, w, 5, 3, args.seed), device)
    out = {"program": "profile_stages", "shape": [h, w],
           "device": T.card_label(device),
           "pairs": f"synthetic (testing.shifted_pair, seed {args.seed})",
           "overrides": list(args.sets)}

    plain = compute_flow_jit(img1, img2, cfg=cfg)
    if device.type == "cuda":
        untraced = GRAPHS.entries[graph_key(img1, img2, cfg, False, None,
                                            None)]
        out["untraced_nodes"] = untraced.nodes()["total"]
    trace.enable()
    try:
        traced = compute_flow_jit(img1, img2, cfg=cfg)
        if device.type == "cuda":
            entry = GRAPHS.entries[graph_key(img1, img2, cfg, False, None,
                                             None)]
            nodes = entry.nodes()
            ms, graphs_, tr = T.traced_replays(entry, REPS)
        else:
            tr = trace.collect()
    finally:
        trace.disable()
    same = bool(torch.equal(traced, plain))
    out["identical_to_untraced"] = same
    if device.type != "cuda":
        for s in tr.spans:
            if not s.host:
                print(json.dumps({"stage": s.name}))
        print(json.dumps(out))
        return 0 if same else 1

    kids = {g.id: sorted(tr.children(g), key=lambda s: s.start_ns)
            for g in graphs_}
    names = [s.name for s in kids[graphs_[0].id]]
    by_name: Dict[str, List[float]] = {n: [] for n in names}
    for g in graphs_:
        for s in kids[g.id]:
            by_name[s.name].append(s.ms)
    graph_ms = [g.ms for g in graphs_]
    stage_nodes = {}
    for name, counts in nodes["stages"] or ():
        stage_nodes.setdefault(name, dict.fromkeys(counts, 0))
        for k, v in counts.items():
            stage_nodes[name][k] += v
    for name in names:
        line = {"stage": name, **T.summary(by_name[name]),
                "share": statistics.median(by_name[name])
                / statistics.median(graph_ms)}
        if name in stage_nodes:
            line["nodes"] = stage_nodes[name]
        print(json.dumps(line), flush=True)
    print(json.dumps({"stage": "graph", **T.summary(graph_ms),
                      "events": T.summary(ms)}))
    # the graph span's self time: what its stages leave uncovered
    uncovered = max(tr.self_ns(g) / g.ns for g in graphs_)
    ratio = statistics.median(g / e for g, e in zip(graph_ms, ms))
    out.update(stages=len(names), traced_nodes=nodes["total"],
               sum_ms=sum(statistics.median(v) for v in by_name.values()),
               graph_ms=statistics.median(graph_ms),
               events_ms=statistics.median(ms), uncovered=uncovered,
               graph_over_events=ratio, drift_ns=tr.drift_ns)
    errors = []
    if not same:
        errors.append("the traced flow differs from the untraced one")
    if uncovered > TILE_TOLERANCE:
        errors.append(f"the stages leave {uncovered:.3%} of the graph span "
                      "uncovered")
    if abs(ratio - 1.0) > EVENT_TOLERANCE:
        errors.append(f"the graph span is {ratio:.3f} of the events around "
                      "its replay")
    if errors:
        out["error"] = "; ".join(errors)
    print(json.dumps(out))
    return 1 if errors else 0


if __name__ == "__main__":
    sys.exit(main())
