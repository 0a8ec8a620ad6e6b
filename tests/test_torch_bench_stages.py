"""The coarse matcher's rows of the port's measurement programs on the
CPU at 64x96: ``bench/profile_match.py::match_stages`` runs each of its
rows and gives the shapes the rows name.  (``profile_stages`` times the
real pair's stages through the tracer; ``tests/test_torch_trace.py``.)"""

import dataclasses

import pytest
import torch

from eppm_tpu_torch.bench import _timing, profile_match
from eppm_tpu_torch.config import DEFAULT_CONFIG
from eppm_tpu_torch.testing import shifted_pair

# The suite runs several test processes per host: one torch thread each
# keeps them from oversubscribing the cores.
torch.set_num_threads(1)

CPU = torch.device("cpu")
H, W = 64, 96
PAIR = shifted_pair(H, W, 5, 3, seed=0)


@pytest.mark.parametrize("threshold, stride", [(30000, 1), (100, 2)])
def test_match_rows_give_the_shapes_they_name(threshold, stride):
    """Every row of ``profile_match`` on the CPU.  At 64x96 the coarse
    level is 16x24; ``min_level_dim=8`` gives it one mini level (8x12),
    so the tiny rows run, and the stride-2 proposals run where the
    coarse level has more pixels than ``global_stride_threshold``."""
    cfg = dataclasses.replace(DEFAULT_CONFIG, match=dataclasses.replace(
        DEFAULT_CONFIG.match, min_level_dim=8,
        global_stride_threshold=threshold))
    timer = _timing.Rows()
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
