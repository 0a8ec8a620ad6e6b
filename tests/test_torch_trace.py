"""The port's tracer (``eppm_tpu_torch/utils/trace.py``) on the CPU:

* switched off it records nothing, and the graph key tells a traced graph
  from an untraced one;
* switched on, ``compute_flow`` on a 64x96 pair marks, on both engines,
  the stages ``flowbench/stages.py`` names for the same config, in its
  order, and gives the flow of the untraced pipeline bit for bit;
* spans have parents and pair ids; self time is a span less its
  children; marks nest by depth;
* the device path through a stubbed card (``ops/cuda_trace.py``'s calls
  replaced by a ring kept in numpy): a capture's marks are counted once
  at the capture and taken back, each replay adds them and registers one
  sequence (``graphs.take_back_launches``' rule), rows reused by the ring
  are reported lost, the anchor puts card stamps on the host clock, and
  no replay synchronises the card or reads it back;
* the idle gaps' attribution, the Chrome trace, and ``cli --trace``.

On the card (``gpu``, skipped without one): the traced and untraced
graphs give the same flow, mark nodes appear only in the traced graph,
the stage spans tile the ``graph`` span, and that span is within 5% of
CUDA events around the same replay (``python3 -m pytest -q -p
no:cacheprovider --noconftest -m gpu tests/test_torch_trace.py``).
"""

import dataclasses
import functools
import json

import numpy as np
import pytest
import torch

from eppm_tpu_torch import cli, graphs
from eppm_tpu_torch import pipeline as tpipe
from eppm_tpu_torch.config import DEFAULT_CONFIG
from eppm_tpu_torch.ops import cuda_trace
from eppm_tpu_torch.testing import shifted_pair
from eppm_tpu_torch.utils import trace
from flowbench.stages import stages as bench_stages

# The suite runs several test processes per host: one torch thread each
# keeps them from oversubscribing the cores.
torch.set_num_threads(1)

CPU = torch.device("cpu")
PAIR = shifted_pair(64, 96, 5, 3, seed=0)


def frames(pair=PAIR):
    return [torch.from_numpy(f) for f in pair]


def cfg_of(engine):
    return dataclasses.replace(DEFAULT_CONFIG, match_engine=engine)


@pytest.fixture(autouse=True)
def tracer_off():
    """Every test starts and ends with a new tracer, off and empty."""
    trace.TRACER.__init__()
    yield
    trace.TRACER.__init__()


@functools.lru_cache(maxsize=None)
def traced(engine):
    """(flow, trace, client pair id) of ``compute_flow_jit`` on the CPU
    with tracing on, inside a client span."""
    trace.enable()
    try:
        pid = trace.new_pair()
        with trace.span("client", pair=pid):
            flow = tpipe.compute_flow_jit(*frames(), cfg=cfg_of(engine))
        return flow, trace.collect(), pid
    finally:
        trace.disable()


@functools.lru_cache(maxsize=None)
def bench_chain(engine):
    """(flow, stage names) of ``flowbench/stages.py`` on the same pair,
    tracing off."""
    names = []

    def run(name, fn, *args):
        names.append(name)
        return fn(*args)

    flow = bench_stages(*frames(), cfg_of(engine), run)
    return flow, names


def test_switched_off_records_nothing_and_the_key_tells_tracing_apart():
    assert trace.span("x").__enter__() is trace.span("y").__enter__()
    trace.mark("x")
    with trace.stages(CPU) as s:
        trace.mark("y")
    assert s.captured is None
    flow = tpipe.compute_flow_jit(*frames(), cfg=cfg_of("dense"))
    assert trace.collect().spans == []
    assert torch.equal(flow, traced("dense")[0])   # on equals off
    a, b = frames()
    off = graphs.graph_key(a, b, DEFAULT_CONFIG, False, None, None)
    trace.enable()
    on = graphs.graph_key(a, b, DEFAULT_CONFIG, False, None, None)
    assert off[:-1] == on[:-1] and off != on


@pytest.mark.parametrize("engine", ["dense", "patchmatch"])
def test_marks_are_the_benchmark_stages_and_keep_the_flow(engine):
    """The program's marks name ``flowbench/stages.py``'s stages, in its
    order (the benchmark's copy follows the program), and the traced flow
    is the untraced stage chain's, bit for bit."""
    flow, tr, _ = traced(engine)
    marked = [s.name for s in sorted(tr.spans, key=lambda s: s.start_ns)
              if not s.host]
    want_flow, names = bench_chain(engine)
    assert marked == names
    assert names[:6] == ["prepare", "match", "lr_check", "outliers",
                         "occlusion", "L1.upsample"]
    assert names[-1] == "final_smooth" and len(names) == 14
    assert torch.equal(flow, want_flow)


def test_spans_have_parents_pairs_and_self_time():
    _, tr, pid = traced("dense")
    (client,) = tr.named("client")
    (entry,) = tr.named("entry")
    stages = [s for s in tr.spans if not s.host]
    assert entry.parent == client.id
    assert all(s.parent == entry.id and s.pair == pid for s in stages)
    assert {s.pair for s in tr.spans} == {pid}
    assert len({s.id for s in tr.spans}) == len(tr.spans)
    # the stages tile the entry: its self time is the rest
    covered = sum(s.ns for s in stages)
    assert tr.self_ns(entry) == entry.ns - covered >= 0
    assert tr.self_ns(client) == client.ns - entry.ns
    assert all(tr.self_ns(s) == s.ns for s in stages)


def test_marks_nest_by_depth():
    ids = iter(range(100, 200))
    marks = [("graph", 0), ("a", 1), ("b", 1), (None, 1), (None, 0)]
    spans = trace.mark_spans(marks, [0, 1, 4, 9, 10], 7, 3, "device:x", ids)
    by = {s.name: s for s in spans}
    assert (by["graph"].start_ns, by["graph"].end_ns) == (0, 10)
    assert (by["a"].start_ns, by["a"].end_ns) == (1, 4)
    assert (by["b"].start_ns, by["b"].end_ns) == (4, 9)
    assert by["graph"].parent == 7
    assert by["a"].parent == by["b"].parent == by["graph"].id
    assert all(s.pair == 3 and s.lane == "device:x" for s in spans)
    # a sequence cut short is closed at its last stamp
    (only,) = trace.mark_spans([("a", 0)], [5], None, 1, "x", ids)
    assert (only.start_ns, only.end_ns) == (5, 5)


def test_anchor_puts_card_stamps_on_the_host_clock():
    a0 = (1_000_000, 50_000, 3)      # host ns, card ns, error
    a1 = (2_000_100, 1_050_000, 4)   # the offset grew by 100 ns
    assert trace._to_host(50_000, a0, a1) == 1_000_000
    assert trace._to_host(1_050_000, a0, a1) == 2_000_100
    assert trace._to_host(550_000, a0, a1) == 1_500_050
    same = (10, 10, 0)
    assert trace._to_host(7, same, same) == 7


class FakeCard:
    """``ops/cuda_trace.py``'s calls on a stub card: the ring, the rows'
    sequence numbers and the count in numpy, a clock that ticks 10 ns a
    mark, and a capture that records marks instead of running them.  A
    mark counts a launch of ``cuda_trace.MARK`` as ``CudaKernel.launch``
    does, under capture too."""

    def __init__(self, rows, slots=32):
        self.ring = np.zeros((rows, slots), np.uint64)
        self.seq = np.zeros(rows, np.uint64)
        self.count = self.clock = self.stamp = 0
        self.capturing = False
        self.recorded = []
        self.reads = self.syncs = 0

    def install(self, monkeypatch):
        monkeypatch.setattr(cuda_trace, "geometry",
                            lambda: self.ring.shape)
        monkeypatch.setattr(cuda_trace, "reset", self.reset)
        monkeypatch.setattr(cuda_trace, "mark", self.mark)
        monkeypatch.setattr(cuda_trace, "anchor", self.anchor)
        monkeypatch.setattr(cuda_trace, "read", self.read)
        monkeypatch.setattr(torch.cuda, "synchronize", self.sync)
        monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                            lambda: self.capturing)
        monkeypatch.setattr(trace.TRACER, "_geometry", None)

    def sync(self, device=None):
        self.syncs += 1

    def reset(self, device):
        self.count = 0

    def mark(self, device, slot, last):
        cuda_trace.MARK.launches += 1
        if self.capturing:
            self.recorded.append((slot, last))
        else:
            self.run(slot, last)

    def run(self, slot, last):
        self.clock += 10
        row = self.count % len(self.ring)
        self.ring[row, slot] = self.clock
        if last:
            self.seq[row] = self.count
            self.count += 1

    def anchor(self, device):
        self.clock += 1
        self.stamp = self.clock

    def read(self, device):
        self.reads += 1
        return self.ring.copy(), self.seq.copy(), self.count, self.stamp


class FakeGraph:
    """A captured graph on the stub card: a replay runs the marks its
    capture recorded (the pipeline's own work is left out)."""

    def __init__(self, card, marks):
        self.card, self.marks = card, marks

    def replay(self):
        for slot, last in self.marks:
            self.card.run(slot, last)


DEV = torch.device("meta")


def staged(x):
    """A pipeline in little: two marked stages."""
    with trace.stages(DEV):
        trace.mark("first")
        y = x * 2
        trace.mark("second")
        return y + 1


def traced_stub_capture(card):
    """``test_torch_graph_ready.stub_capture``'s pattern with the tracer:
    an eager warm-up call, then the call under a stub capture inside the
    tracer's ``graph`` scope, its launches taken back."""
    def make(key, fn, inputs):
        static = {n: t.clone() for n, t in inputs.items()}
        fn(**static)
        before = graphs.launch_counts()
        card.capturing, card.recorded = True, []
        with trace.graph(DEV) as scope:
            output = fn(**static)
        card.capturing = False
        launches = graphs.take_back_launches(before)
        return graphs.FlowGraph(key, FakeGraph(card, card.recorded), static,
                                output, launches, captured=scope.captured)
    return make


def test_replays_register_their_marks_and_never_sync(monkeypatch):
    card = FakeCard(rows=4)
    card.install(monkeypatch)
    trace.enable()
    cache = graphs.GraphCache(make=traced_stub_capture(card))
    x = {"x": torch.arange(3.0)}
    m0 = cuda_trace.MARK.launches
    cache.run("k", staged, x)    # warm-up (3 marks ran) and capture
    (entry,) = cache.entries.values()
    assert entry.captured.marks == (("graph", 0), ("first", 1),
                                    ("second", 1), (None, 1), (None, 0))
    # what FlowGraph.nodes() names the nodes after each mark by
    assert entry.captured.open_after() == ["graph", "first", "second",
                                           "graph", "outside"]
    # the capture's 5 marks were taken back; its one replay added them
    assert entry.launches == {cuda_trace.MARK: 5}
    assert cuda_trace.MARK.launches - m0 == 3 + 5
    syncs, reads = card.syncs, card.reads
    for _ in range(2):
        cache.run("k", staged, x)
    assert (card.syncs, card.reads) == (syncs, reads)  # none in a replay
    assert cuda_trace.MARK.launches - m0 == 3 + 3 * 5
    tr = trace.collect()
    assert tr.lost == 0
    graphs_ = tr.named("graph")
    assert len(graphs_) == 3
    for g in graphs_:
        kids = sorted(tr.children(g), key=lambda s: s.start_ns)
        assert [k.name for k in kids] == ["first", "second"]
        assert kids[0].start_ns > g.start_ns
        assert kids[1].end_ns < g.end_ns
        (launch,) = [s for s in tr.spans if s.id == g.parent]
        assert launch.name == "entry.launch" and g.pair == launch.pair
    # the warm-up's eager sequence: its stages, no graph around them
    eager = [s for s in tr.spans if s.lane == "device:meta"
             and s.parent is not None and s.name == "first"
             and s.parent not in {g.id for g in graphs_}]
    assert len(eager) == 1
    names = {s.name for s in tr.spans if s.host}
    assert names == {"entry", "entry.copy_in", "entry.launch",
                     "entry.clone_out"}


def test_a_reused_ring_row_is_reported_lost(monkeypatch):
    card = FakeCard(rows=4)
    card.install(monkeypatch)
    trace.enable()
    cache = graphs.GraphCache(make=traced_stub_capture(card))
    x = {"x": torch.arange(3.0)}
    for _ in range(6):            # sequences 0 (warm-up) and 1..6
        cache.run("k", staged, x)
    tr = trace.collect()
    assert tr.lost == 3 and len(tr.named("graph")) == 4
    assert set(tr.drift_ns) == {"meta"}


def test_idle_gaps_are_put_down_to_the_innermost_host_span():
    S = trace.Span

    def host(i, name, s, e):
        return S(i, name, s, e, None, 1, "host:main")

    spans = [host(1, "flowbench.flow", 0, 100), host(2, "entry.launch", 5, 20),
             host(3, "flowbench.readback", 100, 130)]
    busy = [S(4, "graph", 30, 90, 2, 1, "device:cuda:0")]
    # longest first; each named by the innermost span at its middle
    gaps = trace.idle_gaps(spans, busy, (0, 150))
    assert gaps == [("flowbench.readback", 90, 150), ("entry.launch", 0, 30)]
    gaps = trace.idle_gaps(spans, busy, (0, 108))
    assert gaps == [("entry.launch", 0, 30), ("flowbench.flow", 90, 108)]
    gaps = trace.idle_gaps(spans, busy, (0, 250))
    assert gaps[0] == ("outside every span", 90, 250)


def test_chrome_trace_holds_every_span_on_its_lane():
    tr = traced("dense")[1]
    doc = json.loads(json.dumps(trace.chrome(tr)))
    xs = [e for e in doc["traceEvents"] if e["ph"] == "X"]
    assert sorted(e["name"] for e in xs) == sorted(s.name for s in tr.spans)
    lanes = {e["args"]["name"]: e["pid"] for e in doc["traceEvents"]
             if e["name"] == "thread_name"}
    assert lanes == {"host:MainThread": 1, "marks:MainThread": 2}
    assert min(e["ts"] for e in xs) == 0
    assert all(e["dur"] >= 0 and e["args"]["pair"] is not None for e in xs)


def test_cli_trace_writes_the_stream_spans(tmp_path, capsys):
    from eppm_tpu_torch.io import write_ppm

    small = shifted_pair(32, 48, 2, 1, seed=3)
    frames_dir = tmp_path / "frames"
    frames_dir.mkdir()
    for k, f in enumerate(small):
        write_ppm(str(frames_dir / f"f{k}.ppm"), f)
    out = tmp_path / "trace.json"
    assert cli.main(["--frames-dir", str(frames_dir), "--out-dir",
                     str(tmp_path / "out"), "--device", "cpu",
                     "--trace", str(out)]) == 0
    assert json.loads(capsys.readouterr().out)["pairs"] == 1
    events = json.loads(out.read_text())["traceEvents"]
    xs = [e for e in events if e["ph"] == "X"]
    names = {e["name"] for e in xs}
    assert {"stream.decode", "stream.upload", "stream.flow",
            "stream.enqueue", "stream.readback", "stream.write", "entry",
            "prepare", "final_smooth"} <= names
    lane = {e["tid"]: e["args"]["name"] for e in events
            if e["name"] == "thread_name"}
    by = {e["name"]: e for e in xs}
    assert lane[by["stream.readback"]["tid"]] != lane[by["stream.flow"]["tid"]]
    assert by["stream.readback"]["args"]["pair"] == \
        by["stream.flow"]["args"]["pair"]
    assert not trace.enabled()


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the marks are kernels of the "
                    "card (chip_smoke.py phase 8 runs the same gate)")
    return torch.device("cuda", 0)


@pytest.mark.gpu
def test_traced_replay_on_the_card(cuda):
    """The traced and untraced graphs give the same flow; mark nodes are
    in the traced graph only; the stage spans tile the ``graph`` span,
    which is within 5% of CUDA events around the same replay."""
    from eppm_tpu_torch.bench import _timing

    graphs.GRAPHS.clear()
    a, b = (torch.from_numpy(f).to(cuda)
            for f in shifted_pair(480, 640, 3, -2, seed=8))
    plain = tpipe.compute_flow_jit(a, b)
    off = graphs.GRAPHS.entries[graphs.graph_key(a, b, DEFAULT_CONFIG,
                                                 False, None, None)]
    trace.enable()
    flow = tpipe.compute_flow_jit(a, b)
    on = graphs.GRAPHS.entries[graphs.graph_key(a, b, DEFAULT_CONFIG,
                                                False, None, None)]
    ms, spans, tr = _timing.traced_replays(on, 5)
    trace.disable()
    assert torch.equal(flow, plain)
    n_off, n_on = off.nodes(), on.nodes()
    assert n_off["total"]["mark"] == 0
    assert n_on["total"]["mark"] == len(on.captured.marks)
    rest = {k: v for k, v in n_on["total"].items() if k != "mark"}
    assert rest == {k: v for k, v in n_off["total"].items() if k != "mark"}
    assert n_on["stages"] is not None
    for g, e in zip(spans, ms):
        kids = sorted(tr.children(g), key=lambda s: s.start_ns)
        assert all(a.end_ns == b.start_ns for a, b in zip(kids, kids[1:]))
        assert tr.self_ns(g) <= 0.01 * g.ns
        assert abs(g.ms / e - 1.0) <= 0.05
    graphs.GRAPHS.clear()
