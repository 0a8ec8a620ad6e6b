"""What a run records for the metrics' readers, and the reduction of a
traced run's profile to the device's busy time, its busiest operations
and its longest idle gaps.

The metrics' readers (``metrics/<name>.py``) take a ``Run``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

__all__ = ["Profile", "Run", "reduce_profile", "kineto_events", "SPANS"]

# the host spans the client opens around each step of a pair
SPANS = ("flowbench.upload", "flowbench.flow", "flowbench.readback")
# activity types of the trace that are work on the device (a span's
# annotation on the device's timeline is not)
DEVICE_KINDS = ("kernel", "memcpy", "memset")
TOP = 10


@dataclasses.dataclass
class Profile:
    """A profiled stretch: seconds the device was busy (the union of its
    kernels, copies and sets) over the stretch's seconds (the client's
    spans from first start to last end), the device operations that
    took most time, and the longest idle gaps, each named by the host
    span and the innermost host operation running at its middle."""

    busy_s: float
    window_s: float
    device_ops: List[Tuple[str, float]]
    idle_gaps: List[Tuple[str, float]]


@dataclasses.dataclass
class Run:
    """What a run measured, for the metrics' readers.  Every run: the
    window's pairs (host ms each, from handing over the frames to the flow
    on the host), its seconds (from its start to its last pair's end), the
    set-up's seconds, and the cell's configuration (as run) and frame
    size.  A traced run adds the device ms of each pair's replay (CUDA
    events around the entry point's call), the stages' device ms
    (``stages.py``) and the profile of a steady stretch of pairs."""

    pair_ms: List[float]
    window_s: float
    setup_s: float
    config: dict
    height: int
    width: int
    replay_ms: Optional[List[float]] = None
    stages: Optional[Dict[str, List[float]]] = None
    profile: Optional[Profile] = None


def _union(intervals: Sequence[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out: List[Tuple[int, int]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1] = (out[-1][0], e)
        else:
            out.append((s, e))
    return out


def _work(kind: str, name: str, on_device: bool) -> bool:
    if not on_device or name in SPANS:
        return False
    kind = kind.lower()
    return not kind or (any(k in kind for k in DEVICE_KINDS)
                        and "annotation" not in kind)


def reduce_profile(events) -> Profile:
    """``events``: (kind, name, start_ns, end_ns, on_device) of a trace,
    kind being the activity type; the stretch is the client's spans."""
    spans = [(s, e, n) for k, n, s, e, dev in events
             if not dev and n in SPANS]
    if not spans:
        raise RuntimeError("the profiled stretch holds none of the "
                           f"client's spans {SPANS}")
    w0 = min(s for s, _, _ in spans)
    w1 = max(e for _, e, _ in spans)
    device = [(max(s, w0), min(e, w1), n) for k, n, s, e, dev in events
              if _work(k, n, dev) and e > w0 and s < w1]
    busy = _union([(s, e) for s, e, _ in device])
    busy_ns = sum(e - s for s, e in busy)
    by_name: Dict[str, int] = {}
    for s, e, n in device:
        by_name[n] = by_name.get(n, 0) + (e - s)
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
    gaps = []
    edge = w0
    for s, e in busy + [(w1, w1)]:
        if s > edge:
            gaps.append((edge, s))
        edge = max(edge, e)
    gaps.sort(key=lambda g: g[0] - g[1])
    host = [(s, e, n) for k, n, s, e, dev in events if not dev]
    named = []
    for g0, g1 in gaps[:TOP]:
        mid = (g0 + g1) // 2
        around = [(e - s, n) for s, e, n in host if s <= mid <= e]
        span = next((n for _, n in sorted(around, reverse=True)
                     if n in SPANS), "between pairs")
        inner = min(around)[1] if around else "no host op"
        label = span if inner == span else f"{span} > {inner}"
        named.append((label, (g1 - g0) * 1e-9))
    return Profile(busy_ns * 1e-9, (w1 - w0) * 1e-9,
                   [(n, t * 1e-9) for n, t in ops], named)


def kineto_events(prof) -> List[tuple]:
    """(kind, name, start_ns, end_ns, on_device) of every event of a
    finished ``torch.profiler.profile``."""
    out = []
    for ev in prof.profiler.kineto_results.events():
        kind = getattr(ev, "activity_type", "")
        kind = str(kind() if callable(kind) else kind)
        dev = "CUDA" in str(ev.device_type())
        start = ev.start_ns()
        out.append((kind, ev.name(), start, start + ev.duration_ns(), dev))
    return out
