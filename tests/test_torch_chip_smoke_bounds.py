"""``chip_smoke.py``'s bounds of kernels E and A on the CPU: they are the
benchmark's yardstick (kernel E: ``flowbench.gather_work.TAP_OPS``
operations a candidate, pixel, tap and table; kernel A:
``flowbench.plane_work.kernel_a_work``, which is
``flowbench.stats.refine_cost_work`` in the fronto mode; both over
``flowbench.stats.bound_ms``'s peaks) and give the bounds that PERF.md's
kernel table records (NVIDIA H100 80GB HBM3, 700 W)."""

import dataclasses

import pytest

import chip_smoke
from eppm_tpu_torch.config import DEFAULT_CONFIG as CFG
from eppm_tpu_torch.ops.cuda_cost import cost_tables
from eppm_tpu_torch.ops.dense import center_out_offsets
from flowbench import plane_work, reference
from flowbench.stats import bound_ms, refine_cost_work


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


@pytest.mark.parametrize("h, w, which, planes, ms", [
    (1080, 1920, "cost", False, 0.586),
    (1080, 1920, "pass2_cost", False, 0.308),
    (480, 640, "cost", False, 0.087),
    (1080, 1920, "cost", True, 2.456),
    (1080, 1920, "pass2_cost", True, 1.322),
    (480, 640, "cost", True, 0.365),
])
def test_kernel_a_bound_is_the_benchmarks(h, w, which, planes, ms):
    """A pass of 9 candidates (the 3x3 square), as the kernel table's
    rows 1 and 5 launch it: the fronto mode's bound is the fronto
    roofline's (``refine_cost_work``), the plane mode's the plane
    roofline's (``plane_pass_work``), both bound by their operations."""
    cost = getattr(CFG, which)
    cands = [(cy, cx, 0) for cy, cx in center_out_offsets(1)]
    bms, by = chip_smoke.kernel_a_bound(h, w, cands, list(cost.tap_offsets),
                                        cost_tables(cost, planes))
    rcost = getattr(reference.config_from_dict(dataclasses.asdict(CFG)),
                    which)
    if planes:
        want = plane_work.plane_pass_work(h, w, rcost, 1, "square")
    else:
        want = refine_cost_work(h, w, cost.patch_radius, cost.patch_stride,
                                1, "square")
    assert (bms, by) == bound_ms(*want)
    assert (round(bms, 3), by) == (ms, "operations")
