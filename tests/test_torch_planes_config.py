"""The plane deployment, ``PLANES_CONFIG`` (the reference's 4 plane
hypotheses on the port's grids and dense engine: both refine passes over
kernel A's plane mode, 4 frame-2 tap tables each), on the CPU:

* the benchmark's configuration file holds it field for field, the
  command line's ``--set`` keys make it, it departs from
  ``DEFAULT_CONFIG`` in the two plane keys only, and the file lists its
  departures from the reference binary among the tree's fields;
* ``compute_flow`` under it equals the benchmark's plain reference
  (``flowbench/reference``) bit for bit at 64x96, two fine levels, and
  marks each plane pass as ``DEFAULT_CONFIG`` marks its passes
  (``tests/test_torch_planes_flow.py`` holds it to ``eppm_tpu``);
* the benchmark's count of the plane mode's work and the reader of its
  roofline give the hand-computed values on a made-up span stretch, and
  nothing without their spans or on a fronto-parallel run."""

import dataclasses
import functools
import json

import pytest
import torch

from eppm_tpu.config import EPPMConfig as JaxConfig
from eppm_tpu.config import config_fingerprint as jax_fingerprint

from eppm_tpu_torch.cli import apply_overrides
from eppm_tpu_torch.config import (DEFAULT_CONFIG, PLANES_CONFIG,
                                   _from_dict, config_fingerprint)
from eppm_tpu_torch.ops.cuda_cost import cost_plan, cost_tables
from eppm_tpu_torch.ops.dense import center_out_offsets
from eppm_tpu_torch.pipeline import compute_flow
from eppm_tpu_torch.utils import trace
from flowbench import plane_work, reference, spec
from flowbench.metrics import plane_refine_roofline_pct, refine_roofline_pct
from test_torch_pipeline import shifted_pair
from test_torch_upstream_config import flat, run_of, stage_names, stretch

# The suite runs several test processes per host: one torch thread each
# keeps them from oversubscribing the cores.
torch.set_num_threads(1)

# the command line's form of the deployment
PLANES_SETS = ["dense_pass1_planes=True", "dense_pass2_planes=True"]


def test_config_file_cli_and_keys():
    conf = spec.config("eppm_planes")
    want = json.loads(json.dumps(dataclasses.asdict(PLANES_CONFIG)))
    assert conf["config"] == want
    assert conf["reduced"] == []
    assert set(conf["differs_from_default"]) == {"dense_pass1_planes",
                                                 "dense_pass2_planes"}
    # its departures from the reference binary are fields of the tree,
    # the grids and the engines among them
    binary = set(conf["differs_from_reference_binary"])
    assert binary <= set(flat(PLANES_CONFIG))
    assert {"match_engine", "refine_impl", "cost.patch_stride",
            "dense_refine_passes"} <= binary
    assert apply_overrides(DEFAULT_CONFIG, PLANES_SETS) == PLANES_CONFIG
    a, b = flat(DEFAULT_CONFIG), flat(PLANES_CONFIG)
    assert {k for k in a if a[k] != b[k]} == {
        s.split("=")[0] for s in PLANES_SETS}
    # no field added: the JAX package's tree of the same values hashes alike
    jcfg = _from_dict(JaxConfig, dataclasses.asdict(PLANES_CONFIG))
    assert jax_fingerprint(jcfg) == config_fingerprint(PLANES_CONFIG)


@functools.lru_cache(maxsize=None)
def traced(cfg, h, w):
    """(flow, trace) of ``compute_flow`` under ``cfg`` on an h x w pair,
    tracing on."""
    f1, f2 = (torch.from_numpy(f) for f in shifted_pair(h, w, 3, -2, seed=2))
    trace.TRACER.__init__()
    trace.enable()
    try:
        flow = compute_flow(f1, f2, cfg)
        return flow, trace.collect()
    finally:
        trace.disable()
        trace.TRACER.__init__()


def test_equals_the_plain_reference_64x96():
    assert len(PLANES_CONFIG.pyramid.level_dims(64, 96)) - 1 == 2
    got, _ = traced(PLANES_CONFIG, 64, 96)
    f1, f2 = (torch.from_numpy(f) for f in shifted_pair(64, 96, 3, -2,
                                                        seed=2))
    rcfg = reference.config_from_dict(dataclasses.asdict(PLANES_CONFIG))
    assert torch.equal(got, reference.compute_flow(f1, f2, rcfg))
    # the plane tables reach the flow: it is not the fronto-parallel one
    assert not torch.equal(got, compute_flow(f1, f2, DEFAULT_CONFIG))


def test_plane_passes_are_marked_as_the_default_passes():
    _, planes = traced(PLANES_CONFIG, 64, 96)
    _, default = traced(DEFAULT_CONFIG, 64, 96)
    names = stage_names(planes, top_only=False)
    assert names == stage_names(default, top_only=False)
    assert [n for n in names if ".pass" in n] == [
        "L1.pass1", "L1.pass2", "L0.pass1", "L0.pass2"]


@pytest.mark.parametrize("which", ["pass1", "pass2"])
def test_plane_pass_work_by_hand(which):
    cost = PLANES_CONFIG.cost if which == "pass1" else PLANES_CONFIG.pass2_cost
    rcfg = reference.config_from_dict(dataclasses.asdict(PLANES_CONFIG))
    rcost = rcfg.cost if which == "pass1" else rcfg.pass2_cost
    h, w = 480, 640
    taps, reach = (49, 9) if which == "pass1" else (25, 8)
    cands = center_out_offsets(1)
    # the maps, by the port's own plan of the call
    maps = len(cost_plan([(cy, cx, 0) for cy, cx in cands],
                         cost.tap_offsets, cost_tables(cost, True)).maps)
    assert plane_work.n_maps(cands, cost.tap_offsets,
                             cost_tables(cost, True)) == maps
    ops = (maps * (h + 2 * reach) * (w + 2 * reach) * 66 + h * w * taps * 5
           + 9 * 4 * h * w * taps * 41 + 9 * h * w * 3)
    nbytes = 2 * h * w * 16 + 9 * h * w * 4
    assert plane_work.plane_pass_work(h, w, rcost, 1, "square") == (
        float(ops), float(nbytes))


PLANE_SPANS = [("match", 5.0), ("L1.pass1", 1.5), ("L1.pass2", 1.0),
               ("L1.smooth", 0.5), ("L0.upsample", 0.25), ("L0.pass1", 6.0),
               ("L0.pass2", 4.0), ("L0.smooth", 1.0)]


def test_reader_gives_the_hand_values():
    run = run_of(PLANES_CONFIG, stretch(PLANE_SPANS))
    c = json.loads(json.dumps(dataclasses.asdict(PLANES_CONFIG)))
    works = plane_work.plane_refine_work(c, 480, 640)
    assert len(works) == 2
    # both passes bound by their operations over 67 TFLOP/s; the median
    # pair (p = 2) of the summed level-0 passes, 2 x (6 + 4) ms
    least_ms = sum(ops for ops, _ in works) / 67e12 * 1e3
    assert all(ops / 67e12 > nbytes / 3.35e12 for ops, nbytes in works)
    pct = plane_refine_roofline_pct.read(run)
    assert abs(pct - 100 * least_ms / 20.0) < 1e-9
    assert 0 < pct < 100
    # the fronto reader reads nothing for plane passes, stages or not
    run.stages = {"L0.pass1": [6.0], "L0.pass2": [4.0]}
    assert refine_roofline_pct.read(run) is None


@pytest.mark.parametrize("case", ["fronto", "pass1_only", "no_pass2_span",
                                  "off_card", "unequal", "gathered"])
def test_reader_gives_nothing(case):
    cfg, s = PLANES_CONFIG, stretch(PLANE_SPANS)
    if case == "fronto":
        cfg = DEFAULT_CONFIG
    elif case == "pass1_only":
        cfg = dataclasses.replace(PLANES_CONFIG, dense_pass2_planes=False)
    elif case == "no_pass2_span":
        s = stretch([x for x in PLANE_SPANS if x[0] != "L0.pass2"])
    elif case == "off_card":
        s = None
    elif case == "unequal":
        s.equal = False
    else:
        cfg = dataclasses.replace(PLANES_CONFIG, refine_impl="gather")
    assert plane_refine_roofline_pct.read(run_of(cfg, s)) is None
