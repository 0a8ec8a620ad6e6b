"""The check's power in ``upstream-640x480-cold``, where ``--control`` is
inert (the gathered refine never reads ``dense_warp_bf16``): runs of the
harness on the CPU at 64x96 with the cell's configuration come out
correct, and with the port's entry point run under a planted fault, the
PatchMatch cell's tuning of one key, come out not correct:

* ``cost.patch_stride`` 3: the 49-tap grid with its centre tap;
* ``refine_impl="dense"``: the warp and dense search over kernel A in
  place of the gathered plane-fitting re-search.

On the card (``gpu``, skipped without one): a short traced run of
``upstream-640x480-cold`` and of ``default-4k-cold``, at a small size,
reports every per-layer metric the cell lists, its shares of a roofline
within 0-100%."""

import dataclasses
import json

import pytest
import torch

from eppm_tpu_torch.config import config_from_dict
from eppm_tpu_torch.pipeline import compute_flow_jit
from flowbench import run, spec

from ._small import POOL, small

CPU = torch.device("cpu")
CELL = "upstream-640x480-cold"
# the cell's traffic made small: two kinds of its motions at 64x96
TRAFFIC = dict(POOL, scenes=[
    {"kind": "translation", "count": 1, "u": [-5, 5], "v": [-3, 3]},
    {"kind": "layered", "count": 1, "bg_max": 4, "fg": [5, 9], "boxes": 2}],
    check_pairs=2)


def go(wrap=None, seconds=0.5):
    cell = spec.load(CELL)
    line = run.run_cell(cell, 2**31 + 9, seconds, False, CPU,
                        traffic_spec=TRAFFIC, wrap=wrap)
    json.dumps(line)
    return line


def faulty(**change):
    """A wrap that runs the port's entry point under the cell's
    configuration with ``change`` applied (``cost`` keys nested)."""
    cfg = config_from_dict(spec.config(spec.load(CELL).config)["config"])
    if "patch_stride" in change:
        cfg = dataclasses.replace(cfg, cost=dataclasses.replace(
            cfg.cost, patch_stride=change.pop("patch_stride")))
    cfg = dataclasses.replace(cfg, **change)

    def wrap(_fn):
        def flow(a, b, init):
            return compute_flow_jit(a, b, cfg=cfg, init_flow=init)
        return flow
    return wrap


def test_upstream_cell_runs_the_upstream_config():
    conf = spec.config(spec.load(CELL).config)["config"]
    assert conf["match_engine"] == "patchmatch"
    assert conf["refine_impl"] == "gather"
    assert conf["cost"]["patch_stride"] == 2
    assert conf["refine"]["wmf_fill_first"] is False
    assert conf["refine"]["wmf_coarse_iters"] == 20


def test_sound_run_is_correct():
    line = go()
    assert line["correct"] is True and line["failed"] == 0
    assert line["checks"]["differ_pct"]["value"] == 0.0
    assert line["checks"]["mean_abs_px"]["value"] == 0.0
    assert {"pairs_per_s", "pair_ms_p90", "setup_s"} <= set(line["metrics"])


@pytest.mark.parametrize("change", [{"patch_stride": 3},
                                    {"refine_impl": "dense"}],
                         ids=["patch_stride_3", "refine_dense"])
def test_planted_fault_fails(change):
    line = go(wrap=faulty(**change))
    assert line["correct"] is False
    assert line["failed"] > 0
    assert line["checks"]["differ_pct"]["value"] > 0.0


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.gpu
@pytest.mark.parametrize("name", [CELL, "default-4k-cold"])
def test_traced_run_on_card(card, name):
    cell = spec.load(name)
    traffic = TRAFFIC if name == CELL else small(cell)
    line = run.run_cell(cell, 2**31 + 11, 1.0, True, card,
                        traffic_spec=traffic)
    assert line["correct"] is True
    m = line["metrics"]
    assert set(m) == {x.name for x in cell.per_layer}
    for name_, v in m.items():
        if name_.endswith("_roofline_pct"):
            assert 0 < v["value"] <= 100
