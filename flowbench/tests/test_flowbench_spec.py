"""The harness finds cells, configurations, traffic, limits and metrics
by name, refuses a name it cannot find, and BENCHMARK.json keeps to the
form the benchmark's contract sets."""

import json
import re

import pytest

from flowbench import generator, spec
from flowbench import run as runmod

BENCH = json.loads((spec.ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_unknown_names_refused():
    with pytest.raises(spec.NotFound, match="no workload"):
        spec.load("no-such-cell")
    with pytest.raises(spec.NotFound, match="eppm_default"):
        spec.config("no_such_config")
    with pytest.raises(spec.NotFound, match="traffic"):
        spec.traffic("no-such-traffic")
    with pytest.raises(spec.NotFound, match="limit"):
        spec.limits("no-such-cell")
    with pytest.raises(spec.NotFound, match="pairs_per_s"):
        spec.reader("no_such_metric")


def test_main_refuses_unknown_workload(capsys):
    assert runmod.main(["--workload", "nope", "--seed", "1",
                        "--seconds", "1", "--trace", "0"]) == 2
    assert capsys.readouterr().out == ""


def test_main_needs_a_card(capsys, monkeypatch):
    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    assert runmod.main(["--workload", "default-1080p-cold", "--seed", "1",
                        "--seconds", "1", "--trace", "0"]) == 2
    assert capsys.readouterr().out == ""


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_resolves(cell):
    c = spec.load(cell)
    assert spec.config(c.config)["config"]
    generator.resolve(spec.traffic(c.traffic))
    assert set(spec.limits(cell)) >= {"differ_pct", "mean_abs_px"}
    names = {m.name for m in c.end_to_end}
    assert {"setup_s", "pairs_per_s", "pair_ms_p90"} <= names
    assert c.per_layer
    for m in c.end_to_end + c.per_layer:
        assert callable(spec.reader(m.name))


def test_benchmark_json_form():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51
    assert all(not p.startswith("/") and ".." not in p for p in BENCH["paths"])
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in BENCH[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert 1 <= len(c["source"]) <= 200 and 1 <= len(c["why"]) <= 200
        assert c["file"].startswith("flowbench/")
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
        assert NAME.match(w["traffic"])
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and "\n" not in m["layer"]
    assert len(json.dumps(BENCH)) < 64 * 1024
