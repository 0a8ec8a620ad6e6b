"""The port's tracer: host spans, and device marks that a CUDA graph
captures, so that every replay stamps its stages on the card.

Off by default; ``enable()`` and ``disable()`` switch it for the process.
Switched off, ``span`` and ``mark`` return at once.

* ``span(name, pair=None)``: a host span (``time.perf_counter_ns``)
  around a block.  It records its name, start, end, its parent (the
  innermost span open on the thread) and its pair: the sequence id that
  every span of one frame pair shares (``pair``, else the parent's, else
  a new one; ``new_pair()`` makes one).  While a ``torch.profiler``
  session is active it also opens a ``record_function`` range of its
  name, so the profiler's trace shows it beside the device's operations.
* ``mark(name)``: inside a ``stages`` or ``graph`` scope, the start of the
  stage ``name``; a stage ends at the next mark of its depth or at its
  scope's end.  ``submark(name)`` starts a stage one depth below the
  open one (``ops/occlusion.py``'s legacy order marks its two steps so),
  which ends at the next submark or with its parent.
  ``pipeline.compute_flow`` opens ``stages`` and marks each stage;
  ``graphs.capture`` opens ``graph`` around the captured call, so a
  replay holds a ``graph`` span with the stages inside it.  On the CPU a
  mark reads the host clock.  On the card it is one kernel
  (``ops/cuda_trace.py``) that writes the card's clock into a ring in
  device memory: a capture records it as a node, and each replay stamps it
  into a row of its own.  Nothing is read back until ``collect()``: the
  tracer adds no synchronisation to a replay.
* ``collect()``: the spans recorded since the last collect, host and
  device on the host clock, as a ``Trace``.  A device stamp is put on the
  host clock by an anchor: one mark run eagerly between two
  synchronisations of the card, ``perf_counter_ns`` read on each side,
  taken on ``enable()`` (or at a device's first eager mark) and again on
  each ``collect()``; between the two the offset is interpolated, and
  their difference is reported as drift.

Readers: ``flowbench/spans.py`` (the benchmark's span metrics),
``bench/profile_stages.py`` and ``bench/profile_match.py`` (stage times of
a traced replay), ``cli --trace FILE`` (a Chrome trace, ``chrome``).
"""

from __future__ import annotations

import dataclasses
import itertools
import json
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from ..ops import cuda_trace

__all__ = ["Span", "Trace", "Captured", "Tracer", "TRACER", "enable",
           "disable", "enabled", "span", "new_pair", "mark", "submark",
           "stages", "graph", "replayed", "collect", "idle_gaps", "chrome",
           "write_chrome"]


@dataclasses.dataclass(frozen=True)
class Span:
    """A span on the host clock (ns of ``perf_counter_ns``).  ``lane`` is
    ``host:<thread>`` for a host span, ``device:<device>`` for a stage of a
    device sequence, ``marks:<thread>`` for a stage marked on the CPU."""

    id: int
    name: str
    start_ns: int
    end_ns: int
    parent: Optional[int]
    pair: Optional[int]
    lane: str

    @property
    def ns(self) -> int:
        return self.end_ns - self.start_ns

    @property
    def ms(self) -> float:
        return self.ns / 1e6

    @property
    def host(self) -> bool:
        return self.lane.startswith("host:")


def _covered(intervals: Sequence[Tuple[int, int]], lo: int, hi: int) -> int:
    """ns of [lo, hi] that the union of ``intervals`` covers."""
    total, edge = 0, lo
    for s, e in sorted(intervals):
        s, e = max(s, edge), min(e, hi)
        if e > s:
            total += e - s
            edge = e
    return total


@dataclasses.dataclass
class Trace:
    """What ``collect()`` returns: the spans; per device, the anchor's
    drift (ns the host-minus-card offset moved between the two anchors)
    and its uncertainty (half the time between the host's two reads);
    the device sequences lost (their ring row reused before the collect)
    and the marks dropped (past a row's slots)."""

    spans: List[Span]
    drift_ns: Dict[str, int] = dataclasses.field(default_factory=dict)
    anchor_error_ns: Dict[str, int] = dataclasses.field(default_factory=dict)
    lost: int = 0
    dropped: int = 0

    def named(self, name: str) -> List[Span]:
        return [s for s in self.spans if s.name == name]

    def children(self, span: Span) -> List[Span]:
        return [s for s in self.spans if s.parent == span.id]

    def self_ns(self, span: Span) -> int:
        """The span's ns less the part of it that its children cover."""
        kids = [(c.start_ns, c.end_ns) for c in self.children(span)]
        return span.ns - _covered(kids, span.start_ns, span.end_ns)


@dataclasses.dataclass(frozen=True)
class Captured:
    """The marks a capture recorded, in order: (name, depth) each, None
    for the end of a depth's last stage; a replay stamps them all."""

    device: torch.device
    marks: Tuple[Tuple[Optional[str], int], ...]

    def open_after(self) -> List[str]:
        """The innermost stage open after each mark ("outside" where
        none is)."""
        out, open_ = [], []
        for name, depth in self.marks:
            while open_ and open_[-1][0] >= depth:
                open_.pop()
            if name is not None:
                open_.append((depth, name))
            out.append(open_[-1][1] if open_ else "outside")
        return out


def _device(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


class _Seq:
    """A sequence of marks being recorded on one thread."""

    def __init__(self, device, capturing, parent, pair, lane):
        self.device = device          # None: the host clock
        self.capturing = capturing
        self.parent, self.pair, self.lane = parent, pair, lane
        self.marks: List[Tuple[Optional[str], int]] = []
        self.times: List[int] = []    # host clock marks
        self.depth = 0
        self.dropped = 0


@dataclasses.dataclass
class _Finished:
    marks: Tuple[Tuple[Optional[str], int], ...]
    parent: Optional[int]
    pair: Optional[int]
    lane: str
    times: Optional[List[int]] = None          # host clock
    device: Optional[torch.device] = None      # else: row k of its ring
    k: int = 0


def _snapshot(device):
    """An anchor of ``device``, then its ring: ((host ns, card ns,
    uncertainty ns), ring, rows' sequence numbers, count)."""
    torch.cuda.synchronize(device)
    h0 = time.perf_counter_ns()
    cuda_trace.anchor(device)
    torch.cuda.synchronize(device)
    h1 = time.perf_counter_ns()
    ring, seq, count, stamp = cuda_trace.read(device)
    return ((h0 + h1) // 2, int(stamp), (h1 - h0) // 2), ring, seq, count


class _SpanCtx:
    __slots__ = ("t", "name", "pair", "id", "parent", "start", "rf")

    def __init__(self, tracer: "Tracer", name: str, pair: Optional[int]):
        self.t, self.name, self.pair = tracer, name, pair

    def __enter__(self):
        t = self.t
        stack = t._stack()
        top = stack[-1] if stack else None
        self.parent = top.id if top else None
        if self.pair is None:
            self.pair = top.pair if top else next(t._pairs)
        self.id = next(t._ids)
        self.rf = None
        if torch._C._autograd._profiler_enabled():
            self.rf = torch.profiler.record_function(self.name)
            self.rf.__enter__()
        stack.append(self)
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        end = time.perf_counter_ns()
        t = self.t
        t._stack().pop()
        if self.rf is not None:
            self.rf.__exit__(*exc)
        s = Span(self.id, self.name, self.start, end, self.parent, self.pair,
                 f"host:{threading.current_thread().name}")
        with t._lock:
            t._spans.append(s)
        return False


class _Scope:
    """A ``stages`` or ``graph`` scope: opens a sequence of marks on the
    thread where none is open (and ends it with its last mark), else nests
    one depth down in the open one."""

    def __init__(self, tracer: "Tracer", device, name: Optional[str]):
        self.t, self.device, self.name = tracer, device, name
        self.captured: Optional[Captured] = None

    def __enter__(self):
        t = self.t
        seq = getattr(t._local, "seq", None)
        self.own = seq is None
        if self.own:
            seq = t._open(self.device)
        self.seq, self.depth = seq, seq.depth
        if self.name is not None:
            t._record(seq, self.name, self.depth)
            seq.depth = self.depth + 1
        return self

    def __exit__(self, exc_type, *exc):
        t, seq = self.t, self.seq
        seq.depth = self.depth
        if self.own:
            t._local.seq = None
        if exc_type is not None:
            return False
        t._record(seq, None, self.depth, last=self.own)
        if self.own:
            self.captured = t._close(seq)
        return False


class _Null:
    """What a switched-off tracer's scopes and spans return."""

    captured = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL = _Null()


class Tracer:
    """The spans and marks of one process (``TRACER``); see the module's
    docstring."""

    def __init__(self):
        self.on = False
        self._lock = threading.Lock()
        self._ids = itertools.count(1)
        self._pairs = itertools.count(1)
        self._local = threading.local()
        self._spans: List[Span] = []
        self._finished: List[_Finished] = []
        self._dropped = 0
        # per device: [sequences registered since its reset, last anchor]
        self._devices: Dict[torch.device, list] = {}
        self._geometry: Optional[Tuple[int, int]] = None

    # -- switch
    def enable(self) -> None:
        """Switch tracing on; on a card, take an anchor of the current
        device (the first time, after zeroing its count of sequences)."""
        if self.on:
            return
        self.on = True
        if torch.cuda.is_available():
            dev = torch.device("cuda", torch.cuda.current_device())
            if dev in self._devices:
                self._devices[dev][1] = _snapshot(dev)[0]
            else:
                self._init_device(dev)

    def disable(self) -> None:
        self.on = False

    # -- recording
    def _stack(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def span(self, name: str, pair: Optional[int] = None):
        if not self.on:
            return _NULL
        return _SpanCtx(self, name, pair)

    def new_pair(self) -> int:
        return next(self._pairs)

    def mark(self, name: Optional[str]) -> None:
        """The start of stage ``name`` in the open scope (None: the end of
        its open stage)."""
        if not self.on:
            return
        seq = getattr(self._local, "seq", None)
        if seq is not None:
            self._record(seq, name, seq.depth)

    def submark(self, name: str) -> None:
        """The start of stage ``name`` inside the stage ``mark`` opened
        last: one depth below it, so it ends at the next submark or with
        its parent, at the next mark."""
        if not self.on:
            return
        seq = getattr(self._local, "seq", None)
        if seq is not None:
            self._record(seq, name, seq.depth + 1)

    def stages(self, device):
        """The scope of ``compute_flow``'s stage marks on ``device``."""
        if not self.on:
            return _NULL
        return _Scope(self, _device(device), None)

    def graph(self, device):
        """The scope of a captured call: a ``graph`` span around it."""
        if not self.on:
            return _NULL
        return _Scope(self, _device(device), "graph")

    def _init_device(self, device: torch.device) -> None:
        cuda_trace.reset(device)
        self._devices[device] = [0, _snapshot(device)[0]]

    def _slots(self) -> int:
        if self._geometry is None:
            self._geometry = cuda_trace.geometry()
        return self._geometry[1]

    def _open(self, device: torch.device) -> _Seq:
        stack = self._stack()
        top = stack[-1] if stack else None
        lane = threading.current_thread().name
        if device.type == "cpu":
            seq = _Seq(None, False, top and top.id,
                       top.pair if top else next(self._pairs),
                       f"marks:{lane}")
        else:
            capturing = torch.cuda.is_current_stream_capturing()
            if device not in self._devices:
                if capturing:
                    raise RuntimeError(
                        f"the tracer has no anchor on {device}: enable() it "
                        "with the device current, or run a pair eagerly on "
                        "it first")
                self._init_device(device)
            seq = _Seq(device, capturing, top and top.id,
                       top.pair if top else next(self._pairs),
                       f"device:{device}")
        self._local.seq = seq
        return seq

    def _record(self, seq: _Seq, name: Optional[str], depth: int,
                last: bool = False) -> None:
        if seq.device is None:
            seq.marks.append((name, depth))
            seq.times.append(time.perf_counter_ns())
            return
        if len(seq.marks) >= self._slots() - 1 and not last:
            seq.dropped += 1
            return
        cuda_trace.mark(seq.device, len(seq.marks), last)
        seq.marks.append((name, depth))

    def _close(self, seq: _Seq) -> Optional[Captured]:
        marks = tuple(seq.marks)
        if seq.capturing:
            return Captured(seq.device, marks)
        done = _Finished(marks, seq.parent, seq.pair, seq.lane)
        if seq.device is None:
            done.times = seq.times
        else:
            done.device = seq.device
            done.k = self._next_k(seq.device)
        with self._lock:
            self._finished.append(done)
            self._dropped += seq.dropped
        return None

    def _next_k(self, device: torch.device) -> int:
        log = self._devices[device]
        k = log[0]
        log[0] += 1
        return k

    def replayed(self, captured: Captured) -> None:
        """A replay of a graph whose capture recorded ``captured`` was
        launched: its marks stamp the ring's next row of the device (on or
        off, so the rows keep their count)."""
        stack = self._stack()
        top = stack[-1] if stack else None
        done = _Finished(captured.marks, top and top.id,
                         top.pair if top else next(self._pairs),
                         f"device:{captured.device}",
                         device=captured.device,
                         k=self._next_k(captured.device))
        with self._lock:
            self._finished.append(done)

    # -- collecting
    def collect(self) -> Trace:
        """Every span recorded since the last collect, on the host clock
        (blocks: synchronises each card that marked and reads its ring)."""
        with self._lock:
            spans, finished = self._spans, self._finished
            dropped = self._dropped
            self._spans, self._finished, self._dropped = [], [], 0
        out = list(spans)
        trace = Trace(out, dropped=dropped)
        reads = {}
        for device, log in self._devices.items():
            a1, ring, seqno, count = _snapshot(device)
            a0 = log[1]
            log[1] = a1
            trace.drift_ns[str(device)] = (a1[0] - a1[1]) - (a0[0] - a0[1])
            trace.anchor_error_ns[str(device)] = max(a0[2], a1[2])
            reads[device] = (ring, seqno, count, a0, a1)
        for f in finished:
            if f.device is None:
                times = f.times
            else:
                ring, seqno, count, a0, a1 = reads[f.device]
                rows = ring.shape[0]
                row = f.k % rows
                if (f.k >= count or count - f.k > rows
                        or int(seqno[row]) != f.k):
                    trace.lost += 1
                    continue
                times = [_to_host(int(d), a0, a1)
                         for d in ring[row, :len(f.marks)]]
            out.extend(mark_spans(f.marks, times, f.parent, f.pair, f.lane,
                                  self._ids))
        return trace


def _to_host(stamp: int, a0, a1) -> int:
    """A card stamp on the host clock: the host-minus-card offset of the
    anchors a0 and a1 ((host ns, card ns, error)), interpolated."""
    off0, off1 = a0[0] - a0[1], a1[0] - a1[1]
    if a1[1] == a0[1]:
        return stamp + off1
    f = (stamp - a0[1]) / (a1[1] - a0[1])
    return stamp + round(off0 + f * (off1 - off0))


def mark_spans(marks, times, parent, pair, lane, ids) -> List[Span]:
    """The spans of a sequence of marks ((name, depth) each, None ending
    the stages of its depth) at ``times``: a stage runs from its mark to
    the next mark at its depth or above; its parent is the stage open one
    depth up, or ``parent``."""
    out: List[Span] = []
    open_: List[list] = []   # [depth, name, start, id, parent]
    for (name, depth), t in zip(marks, times):
        while open_ and open_[-1][0] >= depth:
            d, n, s, i, p = open_.pop()
            out.append(Span(i, n, s, t, p, pair, lane))
        if name is not None:
            up = open_[-1][3] if open_ else parent
            open_.append([depth, name, t, next(ids), up])
    end = times[-1] if times else 0
    while open_:
        d, n, s, i, p = open_.pop()
        out.append(Span(i, n, s, end, p, pair, lane))
    return out


def idle_gaps(spans: Sequence[Span], busy: Sequence[Span],
              window: Tuple[int, int]) -> List[Tuple[str, int, int]]:
    """The stretches of ``window`` that no ``busy`` span covers, longest
    first: (label, start ns, end ns), the label being the innermost host
    span open at the gap's middle, or "outside every span"."""
    w0, w1 = window
    gaps, edge = [], w0
    for s, e in sorted((b.start_ns, b.end_ns) for b in busy):
        if s > edge:
            gaps.append((edge, min(s, w1)))
        edge = max(edge, e)
        if edge >= w1:
            break
    if edge < w1:
        gaps.append((edge, w1))
    host = [s for s in spans if s.host]
    out = []
    for g0, g1 in gaps:
        if g1 <= g0:
            continue
        mid = (g0 + g1) // 2
        around = [s for s in host if s.start_ns <= mid <= s.end_ns]
        label = (min(around, key=lambda s: s.ns).name if around
                 else "outside every span")
        out.append((label, g0, g1))
    out.sort(key=lambda g: g[1] - g[2])
    return out


def chrome(trace: Trace) -> dict:
    """``trace`` as a Chrome trace (Perfetto opens it): one process for
    the host, a thread a host thread; one for the device, a lane a device
    (stages marked on the CPU in a lane of their own); µs from the first
    span."""
    spans = sorted(trace.spans, key=lambda s: s.start_ns)
    t0 = spans[0].start_ns if spans else 0
    lanes: Dict[str, Tuple[int, int]] = {}
    events = []
    for s in spans:
        if s.lane not in lanes:
            pid = 1 if s.host else 2
            tid = len(lanes) + 1
            lanes[s.lane] = (pid, tid)
            events.append({"ph": "M", "name": "thread_name", "pid": pid,
                           "tid": tid, "args": {"name": s.lane}})
        pid, tid = lanes[s.lane]
        events.append({"ph": "X", "name": s.name, "pid": pid, "tid": tid,
                       "ts": (s.start_ns - t0) / 1e3, "dur": s.ns / 1e3,
                       "args": {"id": s.id, "parent": s.parent,
                                "pair": s.pair}})
    for pid, name in ((1, "host"), (2, "device")):
        events.append({"ph": "M", "name": "process_name", "pid": pid,
                       "args": {"name": name}})
    return {"traceEvents": events, "displayTimeUnit": "ms",
            "otherData": {"drift_ns": trace.drift_ns,
                          "anchor_error_ns": trace.anchor_error_ns,
                          "lost": trace.lost, "dropped": trace.dropped}}


def write_chrome(path: str, trace: Trace) -> None:
    with open(path, "w") as f:
        json.dump(chrome(trace), f)


TRACER = Tracer()
enable = TRACER.enable
disable = TRACER.disable
span = TRACER.span
new_pair = TRACER.new_pair
mark = TRACER.mark
submark = TRACER.submark
stages = TRACER.stages
graph = TRACER.graph
replayed = TRACER.replayed
collect = TRACER.collect


def enabled() -> bool:
    return TRACER.on
