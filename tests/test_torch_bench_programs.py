"""The port's measurement programs (``eppm_tpu_torch/bench``) on the CPU:
each exits non-zero without a card unless ``--device cpu`` is given; with
it ``bench``, ``bench_table`` and ``stream_bench`` run the plain versions
at 64x96 and print JSON lines that parse, with their gates met and no
time or rate; ``bench_table --out`` writes no file that exists; a timed
window fails on a CUDA graph captured or evicted inside it."""

import importlib
import json
import os
import re

import pytest
import torch

from eppm_tpu_torch import graphs
from eppm_tpu_torch.bench import _timing

# The suite runs several test processes per host: one torch thread each
# keeps them from oversubscribing the cores.
torch.set_num_threads(1)

PROGRAMS = ["bench", "bench_table", "profile_stages", "profile_match",
            "stream_bench"]
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# keys that would carry a time or a rate
TIMED = re.compile(r"fps|_ms|seconds|_s$|speedup|vs_baseline")


def program(name):
    return importlib.import_module(f"eppm_tpu_torch.bench.{name}")


def run(name, argv, capsys):
    """(exit code, the JSON lines printed)."""
    rc = program(name).main(argv)
    return rc, [json.loads(line)
                for line in capsys.readouterr().out.splitlines()]


def assert_untimed(obj):
    """No key of a CPU run's output names a time or a rate, and a
    "value" is an EPE in px."""
    if isinstance(obj, dict):
        for key, v in obj.items():
            assert not TIMED.search(key), f"{key!r} in a CPU run's output"
            if key == "value":
                assert obj.get("unit") == "px", obj
            assert_untimed(v)
    elif isinstance(obj, list):
        for v in obj:
            assert_untimed(v)


@pytest.mark.parametrize("name", PROGRAMS)
def test_no_card_exits_nonzero(name, monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as e:
        program(name).main([])
    assert e.value.code not in (0, None)
    assert "no CUDA device" in str(e.value.code)
    assert capsys.readouterr().out == ""


def test_bench_on_the_cpu(capsys):
    rc, lines = run("bench", ["--device", "cpu", "--size", "64x96",
                              "--pairs", "1", "--batches", "1"], capsys)
    assert rc == 0 and len(lines) == 1
    (line,) = lines
    assert line["metric"] == "synthetic_96x64_fps" and line["device"] == "cpu"
    assert line["finite"] and line["warp_ratio"] < _timing.WARP_GATE
    assert line["synthetic_epe"] < 1.0 and "error" not in line
    assert_untimed(line)


def test_bench_table_on_the_cpu(capsys):
    rc, lines = run("bench_table", ["--device", "cpu", "--shape", "64x96"],
                    capsys)
    assert rc == 0 and len(lines) == 1
    (out,) = lines
    (row,) = out["table"].values()
    assert row["shape"] == [64, 96] and row["gate"] and row["finite"]
    assert out["device"] == "cpu" and "graph" not in row
    assert_untimed(out)


def test_bench_table_out_refuses_an_existing_file(capsys):
    path = os.path.join(ROOT, "BENCH_TABLE.json")
    with open(path, "rb") as f:
        before = f.read()
    with pytest.raises(SystemExit) as e:
        program("bench_table").main(["--device", "cpu", "--shape", "64x96",
                                     "--out", path])
    assert "exists" in str(e.value.code)
    with open(path, "rb") as f:
        assert f.read() == before
    assert capsys.readouterr().out == ""


def test_stream_bench_on_the_cpu(capsys):
    rc, lines = run("stream_bench", ["--device", "cpu", "--size", "64x96",
                                     "--frames", "4"], capsys)
    assert rc == 0
    cold, warm, epe = lines
    assert cold["metric"] == "stream_64x96_cold_fps" and cold["pairs"] == 3
    assert warm["metric"] == "stream_64x96_temporal_fps"
    assert epe["metric"] == "stream_64x96_temporal_epe"
    assert epe["value"] < 1.0 and epe["device"] == "cpu"
    assert_untimed(lines)


def test_window_fails_on_a_capture_or_an_eviction(monkeypatch):
    cache = graphs.GraphCache()
    monkeypatch.setattr(graphs, "GRAPHS", cache)
    with pytest.raises(RuntimeError, match="evicted"):
        with _timing.window("w", captures=False):
            cache.evictions += 1
    with pytest.raises(RuntimeError, match="captured"):
        with _timing.window("w"):
            cache.captures += 1
    with _timing.window("w", captures=False):
        cache.captures += 1
