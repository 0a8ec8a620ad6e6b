"""The port's evaluation entry point against the JAX package's tools on
the CPU: the eval set (``eppm_tpu_torch.evalset``) byte for byte against
``tools/make_eval_set.py`` and ``tools/make_holdout_set.py``, the dossier
(``eppm_tpu_torch.eval_report``) against ``python -m eppm_tpu.cli
--eval-dir`` on a small set, and the timers' device default."""

import filecmp
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from eppm_tpu import cli as jcli

from eppm_tpu_torch import eval_report, evalset
from eppm_tpu_torch.utils import timing

# The suite runs several test processes per host: one torch thread each
# keeps them from oversubscribing the cores.
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def both_sets(tmp_path_factory):
    """The whole set built by the port and by the JAX package's tools."""
    root = tmp_path_factory.mktemp("evalsets")
    port, tools = str(root / "port"), str(root / "tools")
    written = evalset.build(port)
    # make_eval_set.py writes its three groups, then stops at the Grove
    # pair, which the repository does not hold.
    out = subprocess.run([sys.executable, "tools/make_eval_set.py", "--root",
                          tools], cwd=REPO, capture_output=True, text=True,
                         timeout=300)
    if out.returncode != 0:
        assert "frame10.ppm" in out.stderr, out.stderr[-2000:]
    subprocess.run([sys.executable, "tools/make_holdout_set.py", "--root",
                    tools], cwd=REPO, check=True, capture_output=True,
                   timeout=300)
    return port, tools, written


@pytest.mark.parametrize("group", list(evalset.GROUPS))
def test_evalset_byte_identical_to_tools(both_sets, group):
    port, tools, written = both_sets
    assert os.path.join(port, group) in written
    a, b = os.path.join(port, group), os.path.join(tools, group)
    cases = sorted(os.listdir(b))
    assert sorted(os.listdir(a)) == cases
    assert len(cases) == {"middlebury_synth": 8, "sintel_stress": 4,
                          "kitti_fixtures": 4, "holdout": 6}[group]
    for case in cases:
        names = sorted(os.listdir(os.path.join(b, case)))
        assert sorted(os.listdir(os.path.join(a, case))) == names
        match, mismatch, errors = filecmp.cmpfiles(
            os.path.join(a, case), os.path.join(b, case), names,
            shallow=False)
        assert not mismatch and not errors, (case, mismatch, errors)


def test_evalset_entry_point(tmp_path):
    """``python -m eppm_tpu_torch.evalset --root DIR`` writes the four
    groups, each with the files of its --eval-dir pattern."""
    root = tmp_path / "set"
    subprocess.run([sys.executable, "-m", "eppm_tpu_torch.evalset",
                    "--root", str(root)], cwd=REPO, check=True,
                   capture_output=True, timeout=300)
    assert sorted(os.listdir(root)) == sorted(evalset.GROUPS)
    for group, pattern in evalset.GROUPS.items():
        for case in os.listdir(root / group):
            assert sorted(os.listdir(root / group / case)) == sorted(
                pattern.split(","))


def _small_set(root):
    """Two 64x96 cases in the set's layout: a translation (.flo) and an
    affine motion (KITTI PNG16), made with the set's own generators."""
    rng = np.random.default_rng(20260817)
    h, w = 64, 96
    evalset.save_seq(os.path.join(root, "middlebury_synth"), "trans",
                     evalset.const_flow(h, w, 3.2, -1.7), rng)
    evalset.save_seq(os.path.join(root, "kitti_fixtures"), "affine",
                     evalset.affine_flow(h, w, 4, 1, -2, 1, 0, 1), rng,
                     kitti=True)
    return {"middlebury_synth/trans": "frame10.ppm,frame11.ppm,flow10.flo",
            "kitti_fixtures/affine": "frame10.ppm,frame11.ppm,flow10.png"}


def test_eval_report_matches_jax_cli(tmp_path, capsys):
    """On the CPU the dossier scores each case as ``eppm_tpu.cli
    --eval-dir`` does (EPE, AAE, bad3 to 1e-6, border 12), holds it to a
    reference of those scores with no miss, prints the EVAL.md table with
    each group's mean and ends in one JSON line; a reference off by more
    than the tolerance is a miss, and the exit code says so."""
    root = str(tmp_path / "set")
    cases = _small_set(root)
    jax_scores = {}
    for case, pattern in cases.items():
        group, name = case.split("/")
        assert jcli.main(["--eval-dir", os.path.join(root, group),
                          "--pattern", pattern, "--border", "12",
                          "--json"]) == 0
        rep = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        jax_scores[case] = rep["sequences"][name]
    ref_path = str(tmp_path / "ref.json")
    with open(ref_path, "w") as f:
        json.dump({"engines": {"dense": {c: {"jax": s} for c, s in
                                         jax_scores.items()}}}, f)

    argv = ["--root", root, "--engines", "dense", "--device", "cpu",
            "--reference", ref_path]
    assert eval_report.main(argv) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    rep = json.loads(lines[-1])
    assert rep["device"] == "cpu" and rep["border"] == 12
    assert rep["misses"] == []
    for case in cases:
        group, name = case.split("/")
        got = rep["groups"][f"{group}/dense"]["sequences"][name]
        for k in ("epe", "aae_deg", "bad3"):
            assert abs(got[k] - jax_scores[case][k]) <= 1e-6, (case, k)
        assert got["epe_jax"] == jax_scores[case]["epe"]
        assert got["ms"] > 0
    table = "\n".join(lines[:-1])
    assert lines[0] == "device: cpu"
    assert "## middlebury_synth" in table and "## kitti_fixtures" in table
    assert "| sequence | dense EPE | AAE | bad3 | ms | dEPE |" in table
    assert table.count("| **mean** |") == 2
    assert "MISS" not in table

    # Off by more than 0.01 outside the holdout group: a miss.
    jax_scores["middlebury_synth/trans"]["epe"] += 0.5
    with open(ref_path, "w") as f:
        json.dump({"engines": {"dense": {c: {"jax": s} for c, s in
                                         jax_scores.items()}}}, f)
    assert eval_report.main(argv + ["--cases",
                                    "middlebury_synth/trans"]) == 1
    lines = capsys.readouterr().out.strip().splitlines()
    assert json.loads(lines[-1])["misses"] == [
        "dense:middlebury_synth/trans"]
    assert any("MISS" in ln for ln in lines[:-1])

    # In the holdout group the same difference is marked, not judged.
    holdout = str(tmp_path / "set" / "holdout")
    os.rename(os.path.join(root, "middlebury_synth"), holdout)
    scores = {"holdout/trans": jax_scores["middlebury_synth/trans"]}
    with open(ref_path, "w") as f:
        json.dump({"engines": {"dense": {c: {"jax": s} for c, s in
                                         scores.items()}}}, f)
    assert eval_report.main(argv + ["--cases", "holdout/trans"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    rep = json.loads(lines[-1])
    assert rep["misses"] == []
    assert rep["groups"]["holdout/dense"]["sequences"]["trans"]["off"]
    assert any(" off |" in ln for ln in lines[:-1])


def test_eval_report_refuses_without_card(tmp_path):
    """The dossier runs on the card unless the caller asks for the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    with pytest.raises(SystemExit, match="no CUDA device"):
        eval_report.main(["--root", str(tmp_path)])
    with pytest.raises(ValueError, match="group/name"):
        eval_report.run(str(tmp_path), ["dense"], torch.device("cpu"),
                        cases=["trans"])


def test_timers_default_to_the_card():
    """``DeviceTimer()`` and ``time_stage`` without a device take the CUDA
    device and raise where there is none; ``device="cpu"`` times the
    host."""
    x = torch.ones(32, 32)
    if torch.cuda.is_available():
        assert timing.DeviceTimer().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            timing.DeviceTimer()
        with pytest.raises(RuntimeError, match="device='cpu'"):
            timing.time_stage(lambda a: a @ a, x, n=1, verbose=False)
    t = timing.DeviceTimer("cpu").start()
    x @ x
    assert t.stop() >= 0 and t.device.type == "cpu"
    assert timing.time_stage(lambda a: a @ a, x, n=2, verbose=False,
                             device="cpu") >= 0
