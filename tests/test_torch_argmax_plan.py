"""Kernel D's split of frame 2 across blocks, on the CPU: the planner
(``plan_global_argmax``) and the plain version of the merge
(``merge_split_argmax``).  The kernel itself runs in
tests/test_torch_kernels.py (marker ``gpu``) and in chip_smoke.py."""

import dataclasses

import numpy as np
import pytest
import torch

from eppm_tpu_torch.config import DEFAULT_CONFIG as CFG
from eppm_tpu_torch.ops import cuda_match, match
from eppm_tpu_torch.ops.census import census_transform
from eppm_tpu_torch.ops.cost import pack_frame
from eppm_tpu_torch.testing import dark_rows

# The suite runs several test processes per host: one torch thread each
# keeps them from oversubscribing the cores.
torch.set_num_threads(1)


def _ranges(plan, n2: int):
    """The frame-2 rows [lo, hi) of each split."""
    step = plan.tiles_per_split * cuda_match.BN
    return [(lo, min(lo + step, n2)) for lo in range(0, n2, step)]


def _covers(plan, n2: int) -> bool:
    """Every split non-empty, the last one ending at or after the last
    target: the ranges partition [0, n2)."""
    span = plan.tiles_per_split * cuda_match.BN
    return plan.splits >= 1 and (plan.splits - 1) * span < n2 <= plan.splits * span


def test_plan_covers_every_target_count():
    """N2 from 1 to 129,600 (N1 = N2, as the matcher calls it), and N2 at
    a stride against a single frame-1 row and the 1080p proposal grid."""
    for n2 in range(1, 129_601):
        assert _covers(cuda_match.plan_global_argmax(n2, n2), n2), n2
    for n1 in (1, 8160):
        for n2 in range(1, 129_601, 97):
            plan = cuda_match.plan_global_argmax(n1, n2)
            assert _covers(plan, n2), (n1, n2)
            ranges = _ranges(plan, n2)
            assert len(ranges) == plan.splits and ranges[0][0] == 0
            assert ranges[-1][1] == n2
            assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))


@pytest.mark.parametrize("n,splits,tiles", [
    (129_600, 1, 2025),  # 1013 row tiles fill the 264 slots alone
    (8160, 4, 32),       # 64 row tiles x 4 splits: 256 of 264 slots
    (1200, 19, 1),       # the 640x480 tiny level: one tile per split
    (100, 2, 1),
])
def test_plan_fills_the_card(n, splits, tiles):
    plan = cuda_match.plan_global_argmax(n, n, sms=132)
    assert (plan.splits, plan.tiles_per_split) == (splits, tiles)


def test_plan_takes_a_forced_split_count_cut_to_the_tiles():
    assert cuda_match.plan_global_argmax(8160, 1000, splits=3) == \
        cuda_match.ArgmaxPlan(3, 6)   # 16 tiles: 6 + 6 + 4
    assert cuda_match.plan_global_argmax(5, 100, splits=9).splits == 2
    assert cuda_match.plan_global_argmax(5, 100, splits=1).splits == 1


def test_plan_follows_the_blocks_per_sm():
    """The wrapper plans with the library's residency: one block per SM
    halves the slots, and the split count with them."""
    plan = cuda_match.plan_global_argmax(8160, 8160, sms=132, blocks_per_sm=1)
    assert (plan.splits, plan.tiles_per_split) == (2, 64)


def test_geometry_check_refuses_another_tile():
    """A library whose tile is not the planner's, or whose block fits on no
    SM, raises instead of filling the card wrongly."""
    ok = cuda_match.Geometry((cuda_match.BM, cuda_match.BN, cuda_match.BK),
                             2, 124, 0)
    assert cuda_match.check_geometry(ok) is ok
    for bad in ((64, 64, 32), (128, 32, 32), (128, 64, 16)):
        with pytest.raises(RuntimeError, match="tile"):
            cuda_match.check_geometry(dataclasses.replace(ok, tile=bad))
    with pytest.raises(RuntimeError, match="fit"):
        cuda_match.check_geometry(dataclasses.replace(ok, blocks_per_sm=0))


def texture_rows(n: int, seed: int, d: int = 275,
                 device="cpu") -> torch.Tensor:
    """(n, d) bf16 descriptor rows: ``patch_descriptors`` of a smooth
    seeded texture in [0.1, 0.9], its 275 features repeated or cut to d.

    Kernel D and its plain version agree bit for bit only because their
    float64 sums are exact in any order: every product's lowest bit must
    lie within float64's 53 bits of the largest partial sum.  Here every
    value is at least 0.1 x the smallest tap weight (> 2^-9, so its lowest
    bit is >= 2^-16 and a product's >= 2^-32) and every partial sum is
    below 2^10 for d <= 768: 42 bits."""
    side = int(np.ceil(np.sqrt(n)))
    rng = np.random.default_rng(seed)
    coarse = torch.from_numpy(
        rng.uniform(0.1, 0.9, (1, 3, side // 4 + 2, side // 4 + 2))
        .astype(np.float32))
    img = torch.nn.functional.interpolate(
        coarse, size=(side, side), mode="bilinear", align_corners=False
    )[0].permute(1, 2, 0).contiguous()
    desc = match.patch_descriptors(pack_frame(img, census_transform(img)),
                                   CFG.match)
    rows = desc.reshape(side * side, -1)[:n]
    rows = rows.repeat(1, -(-d // rows.shape[1]))[:, :d]
    return rows.contiguous().to(device)


def test_dark_rows_lie_outside_the_exact_condition():
    """The ``gpu`` case on ``dark_rows`` holds kernel D to its plain
    version on data the exactness argument does not cover."""
    for rows in dark_rows():
        mags = rows.double().abs()
        assert float(mags[mags > 0].min()) < 2.0**-15
        assert rows.shape == (48 * 64, 275)


def _scores(d1: torch.Tensor, d2: torch.Tensor, idx: torch.Tensor):
    """rint((a.b - |b|^2/2) * 4096) of each frame-1 row at its target."""
    a, b = d1.double(), d2.double()[idx.long()]
    return torch.round(((a * b).sum(1) - 0.5 * (b * b).sum(1)) * 4096.0)


@pytest.mark.parametrize("splits", [2, 3, 11])
def test_split_argmax_merges_to_the_unsplit_result(splits):
    """Each split's first maximum, merged, is the first maximum of one
    sweep.  Frame-2 rows on either side of the first split boundary are
    equal, and frame-1 row 0 is that row: the lower index wins."""
    d1 = texture_rows(60, seed=1)
    d2 = texture_rows(700, seed=2)
    plan = cuda_match.plan_global_argmax(60, 700, splits=splits)
    ranges = _ranges(plan, 700)
    assert len(ranges) == splits
    lo, hi = ranges[0][1] - 2, ranges[1][0] + 5
    d2[hi] = d2[lo]
    d1[0] = d2[lo]
    scores, idx = [], []
    for a, b in ranges:
        i = match.global_argmax(d1, d2[a:b], 64) + a
        scores.append(_scores(d1, d2, i))
        idx.append(i)
    got = cuda_match.merge_split_argmax(torch.stack(scores), torch.stack(idx))
    want = match.global_argmax(d1, d2)
    assert got.dtype == torch.int32 and torch.equal(got, want)
    assert int(got[0]) == lo and int(idx[1][0]) == hi


def test_merge_orders_by_score_then_index():
    scores = torch.tensor([[5.0, 2.0, -1.0], [5.0, 3.0, -1.0],
                           [4.0, 3.0, -1.0]], dtype=torch.float64)
    idx = torch.tensor([[9, 1, 30], [4, 40, 20], [2, 12, 10]],
                       dtype=torch.int32)
    got = cuda_match.merge_split_argmax(scores, idx)
    assert got.dtype == torch.int32 and got.tolist() == [4, 12, 10]
