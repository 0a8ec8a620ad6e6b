"""On the card: a short traced run of each cell at a small size, through
the window, the profiler, the stages and the reference; skips without a
CUDA device (the fixture decides)."""

import pytest
import torch

from flowbench import run, spec

from ._small import small


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["default-1080p-cold",
                                  "patchmatch-640x480-cold",
                                  "default-1080p-temporal"])
def test_traced_run_on_card(card, name):
    cell = spec.load(name)
    line = run.run_cell(cell, 2**31 + 9, 1.0, True, card,
                        traffic_spec=small(cell))
    assert line["correct"] is True
    m = line["metrics"]
    assert set(m) == {x.name for x in cell.per_layer}
    assert 0 < m["refine_roofline_pct"]["value"] <= 100
    assert m["match_stage_ms"]["value"] > 0
    d = line["device"]
    assert 0 < d["busy_s"] <= d["window_s"]
    assert line["breakdown"]["device_ops"]
