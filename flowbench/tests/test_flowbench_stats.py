"""The benchmark's arithmetic against values worked by hand."""

import math
import statistics

import pytest

from flowbench import stats
from flowbench.trace import reduce_profile


def test_rate():
    assert stats.rate(45, 9.0) == 5.0
    with pytest.raises(ValueError):
        stats.rate(1, 0.0)


@pytest.mark.parametrize("values,q,want", [
    ([1, 2, 3, 4, 5, 6, 7, 8, 9, 10], 90, 9.1),   # rank 8.1 of 0..9
    ([10, 20], 90, 19.0),
    ([5], 90, 5.0),
    ([3, 1, 2], 50, 2.0),
    (list(range(101)), 90, 90.0),
])
def test_percentile(values, q, want):
    assert stats.percentile(values, q) == pytest.approx(want)


def test_spread_is_statistics_quartiles():
    v = [100.0, 101.0, 99.0, 103.0, 100.5, 98.0]
    q1, med, q3 = statistics.quantiles(v, n=4)
    assert stats.spread(v) == pytest.approx((q3 - q1) / med)
    # by hand: sorted 98, 99, 100, 100.5, 101, 103; exclusive quartiles
    # at ranks 1.75 and 5.25: 98.75 and 101.5; median 100.25
    assert stats.spread(v) == pytest.approx((101.5 - 98.75) / 100.25)


def test_refine_cost_work_by_hand():
    # 1080x1920, 49 taps (radius 9, stride 3), K = 9 (square, radius 1)
    ops, nbytes = stats.refine_cost_work(1080, 1920, 9, 3, 1, "square")
    hw = 1080 * 1920
    want = 9 * hw * 49 * 41 + hw * 49 * 5 + 9 * 1098 * 1938 * 66
    assert ops == want
    assert nbytes == 2 * hw * 16 + 9 * hw * 4
    # the plus shape at radius 1 holds 5 candidates, radius 8 stride 4 25 taps
    ops5, _ = stats.refine_cost_work(10, 20, 8, 4, 1, "plus")
    assert ops5 == 5 * 200 * 25 * 41 + 200 * 25 * 5 + 5 * 26 * 36 * 66


def test_roofline_pct_by_hand():
    # 67e9 operations take 1 ms at 67 TFLOP/s; 3.35e9 bytes 1 ms at 3.35 TB/s
    assert stats.bound_ms(67e9, 1.0) == (pytest.approx(1.0), "operations")
    assert stats.bound_ms(1.0, 6.7e9) == (pytest.approx(2.0), "bytes")
    assert stats.roofline_pct([(67e9, 0.0), (0.0, 3.35e9)], 20.0) == \
        pytest.approx(10.0)
    assert stats.roofline_pct([(67e9, 0.0)], 0.0) is None


def test_reduce_profile_by_hand():
    # the client's spans cover 0..1000 ns; kernels at 100-300 and 250-400,
    # a copy at 600-700; the host is in the readback from 500 to 1000
    ev = [
        ("user_annotation", "flowbench.upload", 0, 100, False),
        ("user_annotation", "flowbench.flow", 100, 500, False),
        ("user_annotation", "flowbench.readback", 500, 1000, False),
        ("cpu_op", "aten::copy_", 550, 990, False),
        ("kernel", "k1", 100, 300, True),
        ("kernel", "k2", 250, 400, True),
        ("gpu_memcpy", "Memcpy DtoH", 600, 700, True),
        ("gpu_user_annotation", "flowbench.flow", 100, 500, True),
    ]
    p = reduce_profile(ev)
    assert p.window_s == pytest.approx(1000e-9)
    assert p.busy_s == pytest.approx(400e-9)
    assert p.device_ops[0] == ("k1", pytest.approx(200e-9))
    # gaps: 700-1000 (300), 0-100 (100), 400-600 (200)
    assert [round(t * 1e9) for _, t in p.idle_gaps] == [300, 200, 100]
    assert p.idle_gaps[0][0] == "flowbench.readback > aten::copy_"
    assert p.idle_gaps[2][0] == "flowbench.upload"
