"""The span metrics' readers (``metrics/*_span_ms.py``,
``device_idle_pct``, ``graph_nodes_per_pair``) on a synthetic run whose
span stretch (``spans.py``) is made here, including every case where
they report nothing."""

import pytest

from eppm_tpu_torch.utils.trace import Span, Trace
from flowbench import spans, spec
from flowbench.trace import Run

NAMES = ["prepare_span_ms", "match_span_ms", "cleanup_span_ms",
         "refine_span_ms", "smooth_span_ms", "device_idle_pct",
         "graph_nodes_per_pair"]
STAGES = [("prepare", 20), ("match", 120), ("lr_check", 1), ("outliers", 3),
          ("occlusion", 30), ("L1.upsample", 1), ("L1.pass1", 4),
          ("L1.pass2", 3), ("L1.smooth", 2), ("L0.upsample", 1),
          ("L0.pass1", 11), ("L0.pass2", 8), ("L0.smooth", 4),
          ("subpixel", 2), ("final_smooth", 4)]
MS = 1_000_000


def pair_spans(pid, t0, ids, scale=1):
    """One pair's client, entry and device spans from ``t0`` ns: 10 ms of
    upload, the graph (the stages, ``scale`` times as long), 5 ms of read
    back."""
    out = []

    def add(name, s, e, parent, lane):
        i = next(ids)
        out.append(Span(i, name, s, e, parent, pid, lane))
        return i

    up = t0 + 10 * MS
    flow = add("flowbench.flow", up, 0, None, "host:main")
    add("flowbench.upload", t0, up, None, "host:main")
    launch = add("entry.launch", up + MS, up + 2 * MS, flow, "host:main")
    g0 = up + 3 * MS
    t = g0
    gid = next(ids)
    for name, ms in STAGES:
        add(name, t, t + ms * scale * MS, gid, "device:cuda:0")
        t += ms * scale * MS
    out.append(Span(gid, "graph", g0, t, launch, pid, "device:cuda:0"))
    out[0] = Span(flow, "flowbench.flow", up, t, None, pid, "host:main")
    add("flowbench.readback", t, t + 5 * MS, None, "host:main")
    return out, t + 5 * MS


def stretch(scales=(1,) * 8, equal=True):
    ids = iter(range(1, 10_000))
    out, t, pids = [], 0, []
    for k, scale in enumerate(scales):
        sp, t = pair_spans(k + 1, t, ids, scale)
        out += sp
        pids.append(k + 1)
    nodes = {"total": {"kernel": 900, "memcpy": 40, "memset": 10,
                       "other": 0, "mark": 0}, "stages": None}
    return spans.Stretch(Trace(out), pids, nodes, None, equal)


def run_with(s):
    run = Run([200.0], 1.0, 10.0, {}, 1080, 1920)
    run.spans = s
    return run


def read(name, run):
    return spec.reader(name)(run)


def test_readers_read_the_stretch():
    run = run_with(stretch(scales=(1, 1, 1, 2, 2, 1, 1, 1)))
    got = {n: read(n, run) for n in NAMES}
    assert got["prepare_span_ms"] == pytest.approx(20)
    assert got["match_span_ms"] == pytest.approx(120)
    assert got["cleanup_span_ms"] == pytest.approx(34)
    assert got["refine_span_ms"] == pytest.approx(1 + 4 + 3 + 1 + 11 + 8 + 2)
    assert got["smooth_span_ms"] == pytest.approx(10)
    assert got["graph_nodes_per_pair"] == 950
    # a pair: 10 ms of upload, 3 to the graph, the graph, 5 of read back
    g = sum(ms for _, ms in STAGES)
    graph = 6 * g + 2 * 2 * g
    total = graph + 8 * 18
    assert got["device_idle_pct"] == pytest.approx(100 * (1 - graph / total))


@pytest.mark.parametrize("case", ["missing", "none", "unequal", "no_graph"])
def test_readers_report_nothing_without_a_stretch(case):
    if case == "missing":
        run = Run([200.0], 1.0, 10.0, {}, 1080, 1920)   # not in run_cell
    elif case == "none":
        run = run_with(None)
    elif case == "unequal":
        run = run_with(stretch(equal=False))
    else:
        s = stretch()
        s.trace.spans[:] = [x for x in s.trace.spans
                            if x.pair != 1 or x.lane.startswith("host")]
        run = run_with(s)
    got = {n: read(n, run) for n in NAMES}
    if case == "no_graph":   # a pair without device spans: no stage, no idle
        assert got["graph_nodes_per_pair"] == 950
        del got["graph_nodes_per_pair"]
    assert all(v is None for v in got.values()), got
    if case == "missing":
        assert run.spans is None


def test_stage_groups():
    assert [n for n, _ in STAGES if spans.REFINE(n)] == [
        "L1.upsample", "L1.pass1", "L1.pass2", "L0.upsample", "L0.pass1",
        "L0.pass2", "subpixel"]
    assert spans.REFINE("L2.gather_refine") and not spans.REFINE("L2.wmf")
    assert [n for n, _ in STAGES if spans.SMOOTH(n)] == [
        "L1.smooth", "L0.smooth", "final_smooth"]


def test_summary_line():
    line = spans.summary(stretch())["span_stretch"]
    assert line["stages_ms"]["match"] == pytest.approx(120)
    assert line["launch_to_graph_ms"] == pytest.approx(2)
    assert line["host_spans_ms"]["flowbench.upload"] == pytest.approx(10)
    assert line["idle_gaps_ms"][0][0] == "flowbench.upload"
    assert line["nodes_untraced"]["kernel"] == 900


def test_the_stretch_finds_run_cell_as_main(monkeypatch):
    """``spans.of`` finds ``run.py``'s ``run_cell`` on the stack also when
    the module runs as ``__main__`` (``python3 -m flowbench.run``), and
    hands the stretch its locals."""
    got = {}

    def fake(traffic, flow_fn, device, video, flows, keys, start):
        got.update(traffic=traffic, start=start, video=video)
        return stretch()

    monkeypatch.setattr(spans, "stretch", fake)
    src = ("PROFILE_PAIRS = 3\n"
           "def run_cell(run, read):\n"
           "    traffic, flow_fn, device, video = 'T', None, None, False\n"
           "    flows, keys, i = [], [], 40\n"
           "    return read(run)\n")
    ns = {"__name__": "__main__"}
    exec(compile(src, str(spans.RUN_PY), "exec"), ns)
    run = Run([200.0], 1.0, 10.0, {}, 1080, 1920)
    assert ns["run_cell"](run, spec.reader("match_span_ms")) == \
        pytest.approx(120)
    assert got == {"traffic": "T", "start": 43, "video": False}
    # elsewhere in a file of another name: not the harness
    other = {"__name__": "flowbench.run"}
    exec(compile(src, "elsewhere.py", "exec"), other)
    run = Run([200.0], 1.0, 10.0, {}, 1080, 1920)
    assert other["run_cell"](run, spec.reader("match_span_ms")) is None
