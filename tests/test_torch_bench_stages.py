"""The coarse matcher's rows of the port's stage profilers on the CPU at
64x96: ``bench/profile_match.py::match_stages`` runs each of its rows and
gives the shapes the rows name, and its exact rows are the exact stage's
own calls of ``exact_best_of``, those ``ops/match.py::_polish_direction``
makes.  (``profile_stages`` times the real pair's stages through the
tracer; ``tests/test_torch_trace.py``.)"""

import dataclasses
import functools

import pytest
import torch

from eppm_tpu_torch.bench import _timing, profile_match
from eppm_tpu_torch.config import DEFAULT_CONFIG
from eppm_tpu_torch.ops import cuda_exact
from eppm_tpu_torch.ops._util import grid
from eppm_tpu_torch.ops.match import _polish_direction, exact_best_of
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
        "final descend r=3", "exact_best_of K=1 (incumbent, unmasked)",
        "exact_best_of K=8 (ring, strict)", "exact_best_of K=4 (step 2, strict)",
        "exact_best_of K=1 (median, at equality)"]
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
    for name in list(rows)[-4:]:
        assert rows[name] == ([ch, cw],) * 3, name


@functools.lru_cache(maxsize=None)
def _calls():
    """{row name: (its arguments, its outputs)} of ``match_stages`` at
    64x96 under ``DEFAULT_CONFIG``."""
    calls = {}

    def run(name, fn, *args):
        out = fn(*args)
        calls[name] = (args, out)
        return out

    profile_match.match_stages(*_timing.frames(PAIR, CPU), DEFAULT_CONFIG,
                               run)
    return calls


EXACT_ROWS = [  # name, K, rule (None: scored, unmasked; else strict)
    ("exact_best_of K=1 (incumbent, unmasked)", 1, None),
    ("exact_best_of K=8 (ring, strict)", 8, True),
    ("exact_best_of K=4 (step 2, strict)", 4, True),
    ("exact_best_of K=1 (median, at equality)", 1, False),
]


PROPAGATE = f"propagate_dense {DEFAULT_CONFIG.match.prop_steps}"


@functools.lru_cache(maxsize=None)
def _stage():
    """``_polish_direction`` itself on the inputs of ``profile_match``'s
    ``propagate_dense`` row: ([(fields x, fields y, incumbent, rule) of
    each of its calls of ``exact_best_of_auto``], what it returns)."""
    cfg = DEFAULT_CONFIG
    (p1, p2, flow, cost), _ = _calls()[PROPAGATE]
    seen, real = [], cuda_exact.exact_best_of_auto

    def spy(a, b, cgxs, cgys, cur, ecfg, strict=True):
        seen.append((cgxs, cgys, cur, strict))
        return real(a, b, cgxs, cgys, cur, ecfg, strict)

    cuda_exact.exact_best_of_auto = spy
    try:
        out = _polish_direction(p1, p2, flow, cost, cfg.match, cfg.cost,
                                cfg.cost_tap_chunk)
    finally:
        cuda_exact.exact_best_of_auto = real
    return seen, out


def _same(a, b):
    if a is None or b is None:
        return a is b
    return all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("i", range(len(EXACT_ROWS)),
                         ids=[r[0].split(" (")[1][:-1] for r in EXACT_ROWS])
def test_exact_rows_are_the_exact_stage(i):
    """Each exact row of ``profile_match`` is the exact stage's call of
    the same place in ``_polish_direction``, run on the inputs of the
    profiler's ``propagate_dense`` row: the same candidate fields and
    rule, the row before it as its incumbent, and outputs ``torch.equal``
    to ``exact_best_of`` on those fields, incumbent and rule at the exact
    stage's tap stride; the last row's state is what the stage returns."""
    calls = _calls()
    seen, (tx, ty, tcost) = _stage()
    name, k, strict = EXACT_ROWS[i]
    (p1, p2, cgxs, cgys, cur), out = calls[name]
    prev = calls[EXACT_ROWS[i - 1][0]][1] if i else None
    rule = True if strict is None else strict
    assert len(seen) == len(EXACT_ROWS) and cgxs.shape == (k, 16, 24)
    # on this pair propagation keeps every offset, so the final descent
    # is held to start from the propagated flow itself
    assert calls["final descend r=3"][0][2] is calls[PROPAGATE][1][0]
    assert cur is prev and _same(cur, seen[i][2])
    assert torch.equal(cgxs, seen[i][0]) and torch.equal(cgys, seen[i][1])
    assert seen[i][3] == rule
    ecfg = dataclasses.replace(
        DEFAULT_CONFIG.cost, patch_stride=DEFAULT_CONFIG.match.exact_tap_stride)
    assert _same(out, exact_best_of(p1, p2, cgxs, cgys, cur, ecfg, rule))
    if i == len(EXACT_ROWS) - 1:
        ys, xs = grid(16, 24, CPU)
        assert _same((xs + out[0], ys + out[1], out[2]), (tx, ty, tcost))
