"""The stage chains of the port's measurement programs on the CPU at 64x96:
``bench/profile_stages.py::stages`` is ``pipeline.compute_flow`` stage by
stage, bit for bit, on both engines, also through the stage timer's card
path (its capture and replays stubbed), and it holds the repo's contract
against ``eppm_tpu.pipeline.compute_flow_jit``;
``bench/profile_match.py::match_stages`` runs each of its rows and gives
the shapes the rows name."""

import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eppm_tpu.pipeline import compute_flow_jit

from eppm_tpu_torch import graphs
from eppm_tpu_torch.bench import _timing, profile_match, profile_stages
from eppm_tpu_torch.config import DEFAULT_CONFIG
from eppm_tpu_torch.pipeline import compute_flow
from eppm_tpu_torch.testing import shifted_pair
from test_torch_pipeline import assert_contract

# The suite runs several test processes per host: one torch thread each
# keeps them from oversubscribing the cores.
torch.set_num_threads(1)

CPU = torch.device("cpu")
H, W = 64, 96
PAIR = shifted_pair(H, W, 5, 3, seed=0)


@functools.lru_cache(maxsize=None)
def chain(engine: str):
    """The stage chain's flow and rows on the CPU under ``engine``."""
    cfg = dataclasses.replace(DEFAULT_CONFIG, match_engine=engine)
    timer = _timing.StageTimer(CPU)
    img1, img2 = _timing.frames(PAIR, CPU)
    return profile_stages.stages(img1, img2, cfg, timer), timer.rows


@pytest.mark.parametrize("engine", ["dense", "patchmatch"])
def test_stage_chain_is_compute_flow(engine):
    flow, rows = chain(engine)
    cfg = dataclasses.replace(DEFAULT_CONFIG, match_engine=engine)
    img1, img2 = _timing.frames(PAIR, CPU)
    assert torch.equal(flow, compute_flow(img1, img2, cfg))
    names = [r.name for r in rows]
    coarse = {"dense": "match_coarse_bidi (16x24)",
              "patchmatch": "patchmatch x2 (16x24)"}[engine]
    assert names[:6] == ["prepare_pyramids x2", coarse, "lr_check",
                         "outlier_removal",
                         "coarse_occlusion_reconstruct + nnf_to_flow",
                         "upsample -> L1 (32x48)"]
    assert names[-1] == "flow_smoothing final L0"
    assert len(names) == 14  # 5 coarse rows, 4 at each of 2 levels, final
    assert all(r.ms is None and "median_ms" not in r.line() for r in rows)


def test_stage_chain_holds_the_contract_against_jax():
    flow, _ = chain("dense")
    want = np.asarray(compute_flow_jit(*(jnp.asarray(f) for f in PAIR)))
    assert_contract(flow.numpy(), want)


class _StubGraph:
    """What ``StageTimer`` reads of a captured graph: the eager call's
    output, and a replay that does nothing."""

    def __init__(self, key, fn, inputs):
        assert all(isinstance(t, torch.Tensor) for t in inputs.values())
        self.output = fn(**{k: t.clone() for k, t in inputs.items()})
        self.replays = 0

    def run(self):
        self.replays += 1


def test_stage_timer_card_path_passes_the_stages_their_arguments(
        monkeypatch):
    """The card path hands a stage its tensors, nested in lists and tuples,
    as named static inputs and rebuilds its arguments from them: through
    it the chain still gives ``compute_flow``'s flow, and each row holds
    its replays' times."""
    monkeypatch.setattr(graphs, "capture", _StubGraph)
    monkeypatch.setattr(_timing, "event_ms", lambda fn, reps: [
        fn() or 1.0 for _ in range(reps)])
    timer = _timing.StageTimer(torch.device("cuda"), reps=3)
    img1, img2 = _timing.frames(PAIR, CPU)
    flow = profile_stages.stages(img1, img2, DEFAULT_CONFIG, timer)
    assert torch.equal(flow, chain("dense")[0])
    assert [r.name for r in timer.rows] == [r.name for r in chain("dense")[1]]
    assert all(r.ms == [1.0] * 3 for r in timer.rows)
    line = timer.rows[0].line()
    assert line["median_ms"] == 1.0 and line["n"] == 3


@pytest.mark.parametrize("threshold, stride", [(30000, 1), (100, 2)])
def test_match_rows_give_the_shapes_they_name(threshold, stride):
    """Every row of ``profile_match`` on the CPU.  At 64x96 the coarse
    level is 16x24; ``min_level_dim=8`` gives it one mini level (8x12),
    so the tiny rows run, and the stride-2 proposals run where the
    coarse level has more pixels than ``global_stride_threshold``."""
    cfg = dataclasses.replace(DEFAULT_CONFIG, match=dataclasses.replace(
        DEFAULT_CONFIG.match, min_level_dim=8,
        global_stride_threshold=threshold))
    timer = _timing.StageTimer(CPU)
    profile_match.match_stages(*_timing.frames(PAIR, CPU), cfg, timer)
    rows = {r.name: r.shapes for r in timer.rows}
    ch, cw, s = 16, 24, stride
    assert list(rows) == [
        "match_coarse_bidi (whole, both directions, 16x24)",
        "mini_pyramid x2", "tiny descriptors x2 (8x12)",
        "tiny global_match", "tiny descend_level r=3", "descend L0 (16x24)",
        f"coarse descriptors x2 (stride {s})", "coarse global_match",
        "coarse rescore (one field)", "propagate_dense (16, 8, 4, 2, 1, 1)",
        "final descend r=3", "exact: make_patch_stack",
        "exact: patch_cost_stack K=1", "exact: patch_cost_stack K=8 (ring)"]
    assert rows["match_coarse_bidi (whole, both directions, 16x24)"] == (
        ([ch, cw],) * 3,) * 2
    assert rows["mini_pyramid x2"] == ([[ch, cw, 4], [8, 12, 4]],) * 2
    assert [d[:2] for d in rows["tiny descriptors x2 (8x12)"]] == [[8, 12]] * 2
    assert rows["tiny global_match"] == ([8, 12],) * 2
    assert rows["tiny descend_level r=3"] == ([8, 12, 2], [8, 12])
    assert rows["descend L0 (16x24)"] == ([ch, cw, 2], [ch, cw])
    desc = rows[f"coarse descriptors x2 (stride {s})"]
    assert [d[:2] for d in desc] == [[ch // s, cw // s]] * 2
    assert rows["coarse global_match"] == ([ch // s, cw // s],) * 2
    assert rows["coarse rescore (one field)"] == [ch, cw]
    assert rows["propagate_dense (16, 8, 4, 2, 1, 1)"] == ([ch, cw, 2],
                                                           [ch, cw])
    assert rows["final descend r=3"] == ([ch, cw, 2], [ch, cw])
    assert rows["exact: make_patch_stack"][:2] == [ch, cw]
    assert rows["exact: patch_cost_stack K=1"] == [1, ch, cw]
    assert rows["exact: patch_cost_stack K=8 (ring)"] == [8, ch, cw]
