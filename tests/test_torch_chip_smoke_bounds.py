"""``chip_smoke.py``'s bound of kernel E on the CPU: it is the benchmark's
yardstick (``flowbench.gather_work.TAP_OPS`` operations a candidate,
pixel, tap and table, over ``flowbench.stats.bound_ms``'s peaks) and
gives the bounds that PERF.md's kernel table records for kernel E
(NVIDIA H100 80GB HBM3, 700 W)."""

import pytest

import chip_smoke


@pytest.mark.parametrize("k, h, w, taps, tables, mode, ms, by", [
    (4, 120, 160, 49, 1, "propagate", 0.0046, "operations"),
    (4, 240, 320, 49, 1, "propagate", 0.0184, "operations"),
    (1, 480, 640, 100, 4, "cost", 0.1504, "operations"),
    # too few taps to be bound by its operations: 1080 x 1920 pixels x
    # (two packs 2 x 16 B, one target 8 B, the incumbent in and the state
    # out 24 B) = 132,710,400 B at 3.35 TB/s
    (1, 1080, 1920, 9, 1, "fold", 0.0396, "bytes"),
])
def test_kernel_e_bound_is_the_benchmarks(k, h, w, taps, tables, mode, ms,
                                          by):
    bms, bby = chip_smoke.kernel_e_bound(k, h, w, taps, tables, mode)
    assert (round(bms, 4), bby) == (ms, by)
