"""The two cells of the plane deployment and of MPI-Sintel's frame size:
runs of the harness on the CPU at a small size of their traffic come out
correct, and in ``planes-1080p-cold`` with the port's entry point run
under a planted fault, or as the control, come out not correct:

* ``dense_pass2_planes`` off: pass 2 scores the fronto-parallel grid;
* ``dense_pass1_planes`` off: pass 1 scores the fronto-parallel grid;
* ``--control``: the bfloat16 fine-level warp.

On the card (``gpu``, skipped without one): a short traced run of each
cell, at a small size, reports every per-layer metric the cell lists,
its shares of a roofline within 0-100%."""

import dataclasses
import json

import pytest
import torch

from eppm_tpu_torch.config import config_from_dict
from eppm_tpu_torch.pipeline import compute_flow_jit
from flowbench import run, spec

from ._small import POOL

CPU = torch.device("cpu")
PLANES = "planes-1080p-cold"
SINTEL = "patchmatch-sintel-cold"
# each cell's traffic made small: the 1080p layered scenes at 64x96, and
# MPI-Sintel's wide frame (1024x436) at 128x56, motions scaled to the size
TRAFFIC = {
    PLANES: dict(POOL, check_pairs=2),
    SINTEL: dict(POOL, height=56, width=128, check_pairs=2, scenes=[
        {"kind": "layered", "count": 2, "bg_max": 4, "fg": [7, 15],
         "boxes": 3}]),
}


def go(name, wrap=None, control=False, seconds=0.5):
    cell = spec.load(name)
    line = run.run_cell(cell, 2**31 + 13, seconds, False, CPU,
                        control=control, traffic_spec=TRAFFIC[name],
                        wrap=wrap)
    json.dumps(line)
    return line


def faulty(**change):
    """A wrap that runs the port's entry point under the plane cell's
    configuration with ``change`` applied."""
    cfg = config_from_dict(spec.config(spec.load(PLANES).config)["config"])
    cfg = dataclasses.replace(cfg, **change)

    def wrap(_fn):
        def flow(a, b, init):
            return compute_flow_jit(a, b, cfg=cfg, init_flow=init)
        return flow
    return wrap


def test_cells_run_their_configs_and_traffic():
    planes = spec.load(PLANES)
    conf = spec.config(planes.config)["config"]
    assert conf["dense_pass1_planes"] and conf["dense_pass2_planes"]
    assert planes.traffic == spec.load("default-1080p-cold").traffic
    sintel = spec.load(SINTEL)
    assert spec.config(sintel.config)["config"]["match_engine"] == "patchmatch"
    t = spec.traffic(sintel.traffic)
    assert (t["height"], t["width"]) == (436, 1024)
    assert t["scenes"] == [{"kind": "layered", "count": 16, "bg_max": 30,
                            "fg": [60, 120], "boxes": 3}]
    assert "plane_refine_roofline_pct" in {m.name for m in planes.per_layer}
    assert "plane_refine_roofline_pct" not in {m.name
                                               for m in sintel.per_layer}


@pytest.mark.parametrize("name", [PLANES, SINTEL])
def test_sound_run_is_correct(name):
    line = go(name)
    assert line["correct"] is True and line["failed"] == 0
    assert line["checks"]["differ_pct"]["value"] == 0.0
    assert line["checks"]["mean_abs_px"]["value"] == 0.0
    assert {"pairs_per_s", "pair_ms_p90", "setup_s"} <= set(line["metrics"])


@pytest.mark.parametrize("fault", ["pass2_fronto", "pass1_fronto", "control"])
def test_planted_fault_fails(fault):
    if fault == "control":
        line = go(PLANES, control=True)
    else:
        key = "dense_pass2_planes" if fault == "pass2_fronto" else (
            "dense_pass1_planes")
        line = go(PLANES, wrap=faulty(**{key: False}))
    assert line["correct"] is False
    assert line["failed"] > 0
    assert line["checks"]["differ_pct"]["value"] > 0.0


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.gpu
@pytest.mark.parametrize("name", [PLANES, SINTEL])
def test_traced_run_on_card(card, name):
    cell = spec.load(name)
    line = run.run_cell(cell, 2**31 + 17, 1.0, True, card,
                        traffic_spec=TRAFFIC[name])
    assert line["correct"] is True
    m = line["metrics"]
    assert set(m) == {x.name for x in cell.per_layer}
    for name_, v in m.items():
        if name_.endswith("_roofline_pct"):
            assert 0 < v["value"] <= 100
