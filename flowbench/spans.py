"""The span stretch of a traced run: ``SPAN_PAIRS`` pairs through the
client with the port's tracer on (``eppm_tpu_torch/utils/trace.py``), for
the span metrics' readers (``metrics/*_span_ms.py``, ``device_idle_pct``,
``graph_nodes_per_pair``).

A reader's ``read(run)`` gets only the ``trace.Run``; the stretch needs
the cell's traffic, the port's entry point and the window's flows, which
``run.run_cell`` holds as locals while it calls the readers.  So the
first reader of a traced run finds ``run_cell``'s frame on the stack,
runs the stretch there and leaves its result on the run (``run.spans``);
the others read that.  The stretch runs after everything the existing
readers read (the window, the profiled stretch, the stages, the
reference), so it changes none of their numbers.  It runs only on the
card, and only where the port has the tracer: elsewhere ``run.spans`` is
None and every span metric reports nothing.

The stretch, with the port's graphs freed by the reference check:

1. tracing off, one pair (in a video a cold pair, then a warm one from
   its flow) captures the graph the window replayed; its nodes are
   counted (``FlowGraph.nodes``): ``nodes_untraced``;
2. tracing on (``trace.enable()``), one warm-up pair captures the traced
   graph, outside the stretch;
3. ``SPAN_PAIRS`` pairs, each a pair id of the tracer and the client's
   three spans ``flowbench.upload``, ``flowbench.flow`` and
   ``flowbench.readback`` (in a video each warm from the pair before);
4. ``trace.collect()``.  In a pool, a stretch pair whose flow is not the
   window's flow for the same traffic key, bit for bit, sets ``equal``
   false and the readers report nothing.
"""

from __future__ import annotations

import dataclasses
import json
import statistics
import sys
from pathlib import Path
from typing import Callable, Dict, List, Optional

__all__ = ["SPAN_PAIRS", "Stretch", "of", "stage_ms", "idle_pct",
           "REFINE", "SMOOTH", "CLEANUP", "CLIENT"]

SPAN_PAIRS = 8
CLIENT = ("flowbench.upload", "flowbench.flow", "flowbench.readback")
CLEANUP = ("lr_check", "outliers", "occlusion")


def REFINE(name: str) -> bool:
    """The fine levels' stages: upsample, refine passes or the gathered
    refine, and the subpixel stage."""
    if name == "subpixel":
        return True
    lvl, _, stage = name.partition(".")
    return (lvl.startswith("L") and (stage == "upsample"
                                     or stage.startswith("pass")
                                     or stage == "gather_refine"))


def SMOOTH(name: str) -> bool:
    return name == "final_smooth" or (name.startswith("L")
                                      and name.endswith(".smooth"))


@dataclasses.dataclass
class Stretch:
    """A stretch's collected trace (``trace.Trace``), the pair ids of its
    ``SPAN_PAIRS`` pairs, the nodes of the window's untraced graph and of
    the traced one (``FlowGraph.nodes()``), and whether every pool pair's
    flow equals the window's for its key."""

    trace: object
    pairs: List[int]
    nodes_untraced: Optional[dict] = None
    nodes_traced: Optional[dict] = None
    equal: bool = True


RUN_PY = Path(__file__).resolve().parent / "run.py"


def _harness():
    """The frame of ``run.py``'s ``run_cell`` on the stack (its module
    may run as ``__main__``), or None."""
    f = sys._getframe(1)
    while f is not None:
        if (f.f_code.co_name == "run_cell"
                and Path(f.f_code.co_filename).resolve() == RUN_PY):
            return f
        f = f.f_back
    return None


def of(run) -> Optional[Stretch]:
    """The run's stretch: run at the first call from inside a traced
    ``run_cell``, then kept on ``run.spans``; None where it cannot run."""
    if not hasattr(run, "spans"):
        f = _harness()
        run.spans = None
        if f is not None:
            h = f.f_locals
            # the traffic's next pairs after the window and the profile
            run.spans = stretch(h["traffic"], h["flow_fn"], h["device"],
                                h["video"], h["flows"], h["keys"],
                                start=h["i"] + f.f_globals["PROFILE_PAIRS"])
    return run.spans


def _log(*parts) -> None:
    print(*parts, file=sys.stderr, flush=True)


def stretch(traffic, flow_fn: Callable, device, video: bool, flows, keys,
            start: int) -> Optional[Stretch]:
    """Steps 1-4 of the module's docstring, from traffic pair ``start``;
    None off the card or where the port has no tracer."""
    if device.type != "cuda":
        return None
    try:
        from eppm_tpu_torch.graphs import GRAPHS, FlowGraph
        from eppm_tpu_torch.utils import trace
    except ImportError:
        return None
    if not hasattr(FlowGraph, "nodes"):
        return None
    import torch

    def pair(j, prev, pid=None):
        key, f1, f2 = traffic.pair(j)
        with trace.span("flowbench.upload", pair=pid):
            a = torch.from_numpy(f1).to(device)
            b = torch.from_numpy(f2).to(device)
        with trace.span("flowbench.flow", pair=pid):
            flow = flow_fn(a, b, prev if video else None)
        with trace.span("flowbench.readback", pair=pid):
            host = flow.cpu().numpy()
        return key, host, flow

    j = start
    prev = None
    if video:
        prev = pair(j, None)[2]
        j += 1
    prev = pair(j, prev)[2]
    j += 1
    untraced = list(GRAPHS.entries.values())[-1].nodes()
    trace.enable()
    try:
        prev = pair(j, prev)[2]
        j += 1
        traced = list(GRAPHS.entries.values())[-1].nodes()
        trace.collect()
        pids, served = [], []
        for _ in range(SPAN_PAIRS):
            pid = trace.new_pair()
            key, host, prev = pair(j, prev, pid)
            pids.append(pid)
            served.append((key, host))
            j += 1
        tr = trace.collect()
    finally:
        trace.disable()
    equal = True
    if not video:
        window = dict(zip(keys, flows))
        for key, host in served:
            if key in window and not (window[key] == host).all():
                equal = False
    out = Stretch(tr, pids, untraced, traced, equal)
    _log(json.dumps(summary(out)))
    if not equal:
        _log("flowbench: a stretch pair's flow is not the window's flow for "
             "its key; the span metrics report nothing")
    return out


def _pair_spans(s: Stretch, pid: int):
    return [x for x in s.trace.spans if x.pair == pid]


def stage_ms(s: Optional[Stretch], pick: Callable[[str], bool]
             ) -> Optional[float]:
    """The median over the stretch's pairs of the ms of the pair's own
    device stage spans whose name ``pick`` accepts (summed); None where
    the stretch is missing or unequal, or a pair has none."""
    if s is None or not s.equal:
        return None
    per = []
    for pid in s.pairs:
        ms = [x.ms for x in _pair_spans(s, pid)
              if not x.host and x.name != "graph" and pick(x.name)]
        if not ms:
            return None
        per.append(sum(ms))
    return statistics.median(per)


def _window(s: Stretch):
    client = [x for x in s.trace.spans if x.name in CLIENT
              and x.pair in s.pairs]
    if not client:
        return None
    return (min(x.start_ns for x in client), max(x.end_ns for x in client))


def idle_pct(s: Optional[Stretch]) -> Optional[float]:
    """100 x (1 - the pairs' ``graph`` spans over the stretch, from its
    first client span's start to its last one's end).  The client's upload
    and read back count as idle: the card runs no graph of the pipeline
    then."""
    if s is None or not s.equal:
        return None
    w = _window(s)
    graphs = [x for x in s.trace.spans if x.name == "graph"
              and x.pair in s.pairs]
    if w is None or len(graphs) != len(s.pairs):
        return None
    busy = sum(x.ns for x in graphs)
    return 100.0 * (1.0 - busy / (w[1] - w[0]))


def summary(s: Stretch) -> Dict[str, object]:
    """The stretch's line on standard error: each stage's span (median
    ms), the host spans' (median ms), nodes by stage of the traced graph,
    the launch -> graph delay, the idle gaps put down to the innermost
    host span at their middle."""
    from eppm_tpu_torch.utils.trace import idle_gaps

    names: List[str] = []
    for x in s.trace.spans:
        if (x.pair in s.pairs and not x.host and x.name != "graph"
                and x.name not in names):
            names.append(x.name)
    stages = {n: stage_ms(s, lambda m, n=n: m == n) for n in names}
    host: Dict[str, List[float]] = {}
    for x in s.trace.spans:
        if x.host and x.pair in s.pairs:
            host.setdefault(x.name, []).append(x.ms)
    delays = []
    for pid in s.pairs:
        sp = _pair_spans(s, pid)
        launch = [x for x in sp if x.name == "entry.launch"]
        graph = [x for x in sp if x.name == "graph"]
        if launch and graph:
            delays.append((graph[0].start_ns - launch[0].start_ns) / 1e6)
    w = _window(s)
    graphs = [x for x in s.trace.spans if x.name == "graph"
              and x.pair in s.pairs]
    gaps = idle_gaps(s.trace.spans, graphs, w) if w else []
    by_stage = None
    if s.nodes_traced and s.nodes_traced.get("stages"):
        by_stage = {}
        for name, counts in s.nodes_traced["stages"]:
            acc = by_stage.setdefault(name, {})
            for k, v in counts.items():
                acc[k] = acc.get(k, 0) + v
    return {"span_stretch": {
        "pairs": len(s.pairs), "equal_to_window": s.equal,
        "stages_ms": stages,
        "launch_to_graph_ms": statistics.median(delays) if delays else None,
        "host_spans_ms": {k: statistics.median(v) for k, v in host.items()},
        "nodes_untraced": s.nodes_untraced and s.nodes_untraced["total"],
        "nodes_traced": s.nodes_traced and s.nodes_traced["total"],
        "nodes_by_stage": by_stage,
        "idle_pct": idle_pct(s),
        "idle_gaps_ms": [(label, (g1 - g0) / 1e6)
                         for label, g0, g1 in gaps[:10]],
        "lost": s.trace.lost, "drift_ns": s.trace.drift_ns,
        "anchor_error_ns": s.trace.anchor_error_ns}}
