"""The PyTorch port's evaluation half and utilities against ``eppm_tpu``
on the CPU: KITTI 16-bit PNG flow I/O, ``bad_pixel_rate``, the command
line's ``--gt`` scores, presets and ``--eval-dir``, the flow guard
(``utils/guard.py``) and the timers (``utils/timing.py``)."""

import json

import numpy as np
import pytest
import torch

from eppm_tpu import cli as jcli
from eppm_tpu import metrics as jmetrics
from eppm_tpu.config import DEFAULT_CONFIG as JD
from eppm_tpu.io import kitti as jkitti
from eppm_tpu.utils import guard as jguard

from eppm_tpu_torch import cli, io, metrics
from eppm_tpu_torch.config import DEFAULT_CONFIG as TD
from eppm_tpu_torch.config import UNKNOWN_FLOW
from eppm_tpu_torch.utils import guard, timing, trace
from test_torch_pipeline import shifted_pair

# The suite runs several test processes per host: one torch thread each
# keeps them from oversubscribing the cores.
torch.set_num_threads(1)


def _flows(rng, h=20, w=30):
    """A flow, a ground truth near it with unknown and zero pixels, and
    a KITTI validity mask."""
    gt = rng.normal(0, 4, (h, w, 2)).astype(np.float32)
    flow = gt + rng.normal(0, 2, (h, w, 2)).astype(np.float32)
    gt[:3, :5] = UNKNOWN_FLOW
    gt[5, 5:9] = 0.0
    valid = rng.random((h, w)) > 0.2
    return flow, gt, valid


def test_kitti_flow_io_matches_jax(tmp_path, rng):
    flow, _, valid = _flows(rng)
    flow[0, 0] = (600.0, -600.0)  # beyond 16 bits: clipped
    ours, theirs = str(tmp_path / "a.png"), str(tmp_path / "b.png")
    io.write_kitti_flow(ours, flow, valid)
    jkitti.write_kitti_flow(theirs, flow, valid)
    with open(ours, "rb") as a, open(theirs, "rb") as b:
        assert a.read() == b.read()
    got, want = io.read_kitti_flow(ours), jkitti.read_kitti_flow(theirs)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(io.read_png16(ours),
                                  jkitti.read_png16(theirs))
    io.write_kitti_flow(ours, flow)  # valid everywhere by default
    assert io.read_kitti_flow(ours)[1].all()
    with pytest.raises(ValueError):
        io.write_png16(ours, np.zeros((4, 4), np.uint16))


def test_bad_pixel_rate_matches_jax(rng):
    flow, gt, _ = _flows(rng)
    for thresh in (1.0, 3.0):
        assert metrics.bad_pixel_rate(flow, gt, thresh) == \
            jmetrics.bad_pixel_rate(flow, gt, thresh)
    rate, emap = metrics.bad_pixel_rate(flow, gt, return_error_map=True)
    jrate, jmap = jmetrics.bad_pixel_rate(flow, gt, return_error_map=True)
    assert rate == jrate
    np.testing.assert_array_equal(emap, jmap)
    assert metrics.bad_pixel_rate(flow, np.full_like(gt, UNKNOWN_FLOW)) == 0


@pytest.mark.parametrize("kind", ["flo", "png"])
@pytest.mark.parametrize("border", [0, 3])
def test_evaluate_matches_jax(tmp_path, rng, kind, border):
    flow, gt, valid = _flows(rng)
    path = str(tmp_path / f"gt.{kind}")
    if kind == "flo":
        io.write_flo(path, gt)
    else:
        io.write_kitti_flow(path, np.where(gt > 1e9, 0, gt), valid)
    got = cli._evaluate(flow, path, border)
    assert got == jcli._evaluate(flow, path, border)
    assert set(got) == {"epe", "aae_deg", "bad3"}


def test_presets_match_jax():
    """``preset=fast`` sets what the JAX CLI's preset sets, ahead of an
    explicit override wherever it stands."""
    ov = ["refine.blf_sigma_spatial=2.0", "preset=fast", "match_engine=x"]
    got, want = cli.apply_overrides(TD, ov), jcli.apply_overrides(JD, ov)
    assert cli.PRESETS == jcli.PRESETS
    for path in ("dense_cand_shape", "cost.patch_stride", "cost.patch_radius",
                 "refine.blf_sigma_spatial", "match_engine"):
        g, w = got, want
        for k in path.split("."):
            g, w = getattr(g, k), getattr(w, k)
        assert g == w, path
    assert got.refine.blf_sigma_spatial == 2.0
    assert got.cost.tap_offsets == want.cost.tap_offsets
    with pytest.raises(SystemExit, match="preset"):
        cli.apply_overrides(TD, ["preset=slow"])


def _sequence(root, name, f1, f2, gt_name=None, gt=None, valid=None):
    d = root / name
    d.mkdir()
    for fn, f in (("frame10.ppm", f1), ("frame11.ppm", f2)):
        io.write_ppm(str(d / fn), np.round(f * 255).astype(np.uint8))
    if gt_name and gt_name.endswith(".png"):
        io.write_kitti_flow(str(d / gt_name), gt, valid)
    elif gt_name:
        io.write_flo(str(d / gt_name), gt)
    return d


def test_cli_gt_and_eval_dir(tmp_path, capsys):
    """``--gt`` adds the scores to the one-pair report; ``--eval-dir``
    gives one report per sequence directory with the frames (with a .flo
    ground truth, a KITTI PNG one under its pattern, none), and the mean
    of the EPEs it has."""
    h, w = 48, 64
    f1, f2 = shifted_pair(h, w, 2, -1, seed=11)
    gt = np.zeros((h, w, 2), np.float32)
    gt[...] = (2.0, -1.0)
    valid = np.ones((h, w), bool)
    valid[:4] = False
    a = _sequence(tmp_path, "a", f1, f2, "flow10.flo", gt)
    _sequence(tmp_path, "b", f1, f2, "flow10.png", gt, valid)
    _sequence(tmp_path, "c", f1, f2)
    (tmp_path / "not_a_sequence").mkdir()
    args = ["--device", "cpu", "--border", "8"]
    assert cli.main([str(a / "frame10.ppm"), str(a / "frame11.ppm"),
                     "--gt", str(a / "flow10.flo"), *args]) == 0
    one = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert one["shape"] == [h, w, 2] and one["device"] == "cpu"
    assert one["epe"] < 0.5 and one["bad3"] == 0.0
    assert cli.main(["--eval-dir", str(tmp_path), *args, "--json"]) == 0
    rep = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(rep["sequences"]) == {"a", "b", "c"}
    assert rep["sequences"]["a"]["epe"] == one["epe"]
    assert rep["sequences"]["b"] == rep["sequences"]["c"] == {"epe": None}
    assert rep["mean_epe"] == one["epe"]
    assert cli.main(["--eval-dir", str(tmp_path), *args, "--pattern",
                     "frame10.ppm,frame11.ppm,flow10.png"]) == 0
    rep = json.loads(capsys.readouterr().out)
    b = rep["sequences"]["b"]
    assert set(b) == {"epe", "aae_deg", "bad3"} and b["epe"] < 0.5
    assert rep["sequences"]["a"] == {"epe": None}
    assert rep["mean_epe"] == b["epe"]


def test_flow_sanity_matches_jax(rng):
    h, w = 24, 32
    f1, f2 = shifted_pair(h, w, 2, -1, seed=12)
    flow = np.zeros((h, w, 2), np.float32)
    flow[...] = (2.0, -1.0)
    flow += rng.normal(0, 0.3, flow.shape).astype(np.float32)
    flow[0, :4] = UNKNOWN_FLOW
    flow[1, 0, 1] = UNKNOWN_FLOW  # one component unknown
    cases = [(flow, None, None), (flow, f1, f2),
             (flow, *(np.round(f * 255).astype(np.uint8) for f in (f1, f2)))]
    bad = flow.copy()
    bad[2, 3, 0] = np.nan
    bad[3, 3] = np.inf
    cases.append((bad, f1, f2))
    cases.append((np.full((h, w, 2), UNKNOWN_FLOW, np.float32), None, None))
    for f, a, b in cases:
        want = jguard.flow_sanity(f, a, b)
        got = guard.flow_sanity(*(None if x is None else torch.from_numpy(x)
                                  for x in (f, a, b)))
        assert (got.finite_frac, got.unknown_frac, got.max_mag) == (
            want.finite_frac, want.unknown_frac, want.max_mag)
        if want.warp_ratio is None:
            assert got.warp_ratio is None
        else:
            assert got.warp_ratio == pytest.approx(want.warp_ratio,
                                                   rel=1e-12)
        assert str(got) == str(want)
    t = torch.from_numpy
    rep = guard.check_flow(t(flow), t(f1), t(f2), max_warp_ratio=0.6)
    assert rep.warp_ratio < 0.6
    with pytest.raises(guard.FlowGuardError, match="non-finite"):
        guard.check_flow(t(bad))
    with pytest.raises(guard.FlowGuardError, match="magnitude"):
        guard.check_flow(t(flow), max_mag=1.0)
    with pytest.raises(guard.FlowGuardError, match="unknown"):
        guard.check_flow(t(cases[-1][0]))
    with pytest.raises(guard.FlowGuardError, match="warp ratio"):
        guard.check_flow(t(np.zeros_like(flow)), t(f1), t(f2),
                         max_warp_ratio=0.6)


def test_timing_utils(capsys):
    assert timing.Timer().start().stop() >= 0
    with pytest.raises(RuntimeError):
        timing.Timer().stop()
    t = timing.DeviceTimer("cpu").start()
    x = torch.ones(64, 64) @ torch.ones(64, 64)
    assert t.stop() > 0 and t.time_display("mm") > 0
    assert "[mm]" in capsys.readouterr().out
    assert timing.time_stage(lambda a: a @ a, x, n=3, verbose=False,
                             device="cpu") > 0
    # under an active profiler a span of the tracer is a range of its name
    trace.enable()
    try:
        with torch.profiler.profile() as prof:
            with trace.span("tracer.mm"):
                x @ x
    finally:
        trace.disable()
        trace.collect()
    assert any(e.key == "tracer.mm" for e in prof.key_averages())
