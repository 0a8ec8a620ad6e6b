"""The comparison has been shown to fail: runs of the harness on the CPU
at a small size, the card's look skipped, with the timed path broken
underneath, come out not correct; a sound run comes out correct.

* the control: the port with its bfloat16 fine-level warp on;
* an answer altered where it is produced: one pixel's flow moved 1 px;
* a step that returns its state unchanged: each warm pair of a video
  returns its ``init_flow``.

The cells have no batch and one chip, so half a batch and the exchange
between chips are faults they cannot have."""

import json

import pytest
import torch

from flowbench import run, spec

from ._small import small

CPU = torch.device("cpu")
CELLS = ["default-1080p-cold", "patchmatch-640x480-cold",
         "default-1080p-temporal"]


def go(name, seconds=0.5, **kw):
    cell = spec.load(name)
    line = run.run_cell(cell, 2**31 + 5, seconds, False, CPU,
                        traffic_spec=small(cell), **kw)
    json.dumps(line)
    return line


def altered(fn):
    def flow(a, b, init):
        f = fn(a, b, init).clone()
        f[f.shape[0] // 2, f.shape[1] // 2, 0] += 1.0
        return f
    return flow


def unchanged(fn):
    def flow(a, b, init):
        return fn(a, b, init) if init is None else init.clone()
    return flow


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(name):
    line = go(name)
    assert line["correct"] is True
    assert list(line)[-1] == "checks"
    assert line["checks"]["differ_pct"]["value"] == 0.0
    assert {"pairs_per_s", "pair_ms_p90", "setup_s"} <= set(line["metrics"])


@pytest.mark.parametrize("name", CELLS)
def test_control_fails(name):
    line = go(name, control=True)
    assert line["correct"] is False
    assert line["failed"] > 0


@pytest.mark.parametrize("name", ["default-1080p-cold",
                                  "default-1080p-temporal"])
def test_altered_answer_fails(name):
    assert go(name, wrap=altered)["correct"] is False


def test_unchanged_state_fails():
    # a window long enough for warm pairs on the CPU
    line = go("default-1080p-temporal", seconds=10.0, wrap=unchanged)
    assert line["attempted"] >= 2
    assert line["correct"] is False
