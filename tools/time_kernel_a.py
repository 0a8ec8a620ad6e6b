#!/usr/bin/env python3
"""Kernel A of the PyTorch/CUDA port against its plain version, timed at
the shapes of ``chip_smoke.py`` phase 3, for the ``eppm_tpu_torch`` of
one checkout.  Needs a CUDA device.

    python3 tools/time_kernel_a.py [CHECKOUT]

CHECKOUT (default: this one) is the root of the checkout whose package is
timed, e.g. a parent commit unpacked with ``git archive`` into a
gitignored directory; the inputs and the timer are this checkout's
``chip_smoke.py``.  To compare two versions, time both in one machine
session: parent, change, change, parent.  One line per shape: whether the
kernel equals its plain version, and its time in ms (CUDA events, after a
warm-up), with its two passes apart where the package has them.
"""

import sys
from pathlib import Path

here = Path(__file__).resolve().parent.parent
tree = Path(sys.argv[1]).resolve() if len(sys.argv) > 1 else here
sys.path[:0] = [str(tree), str(here)]

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
import eppm_tpu_torch  # noqa: E402
from eppm_tpu_torch.config import DEFAULT_CONFIG as cfg  # noqa: E402
from eppm_tpu_torch.ops import cuda_cost  # noqa: E402
from eppm_tpu_torch.ops.dense import center_out_offsets, warp_pack  # noqa: E402
from eppm_tpu_torch.ops.match import _make_mini_cost  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print("time_kernel_a: no CUDA device", file=sys.stderr)
        return 1
    print("package", Path(eppm_tpu_torch.__file__).parent, flush=True)
    dev = torch.device("cuda", 0)
    mini = _make_mini_cost(cfg.cost, cfg.match)
    cases = [  # (h, w, candidates, cost config, plane mode)
        (60, 80, center_out_offsets(3), mini, False),
        (120, 160, center_out_offsets(3), cfg.cost, False),
        (480, 640, center_out_offsets(1), cfg.cost, False),
        (1080, 1920, center_out_offsets(1), cfg.pass2_cost, False),
        (1080, 1920, center_out_offsets(1), cfg.cost, False),
        (1080, 1920, center_out_offsets(1), cfg.pass2_cost, True),
        (1080, 1920, center_out_offsets(1), cfg.cost, True),
    ]
    for h, w, cands, ccfg, planes in cases:
        (_, p1), (_, p2) = cs._packs(h, w, 3, -2, cs.SEED, dev)
        g = torch.full((h, w), 2, dtype=torch.int32, device=dev)
        warped = warp_pack(p2, g + 1, -g)
        kernel = (cuda_cost.residual_costs_planes_cuda if planes
                  else cuda_cost.residual_costs_cuda)
        got = kernel(p1, warped, cands, ccfg)
        ref = cuda_cost.residual_costs(p1, warped, cands, ccfg, planes)
        reps = 20 if h * w < 300_000 else 5
        ms = cs.cuda_ms(lambda: kernel(p1, warped, cands, ccfg), reps)
        passes = ""
        if hasattr(cuda_cost, "cost_sums_cuda"):
            rows = [(cy, cx, 0) for cy, cx in cands]
            tables = cuda_cost.cost_tables(ccfg, planes)
            terms = cuda_cost.cost_terms_cuda(p1, warped, rows, ccfg, tables)
            tms = cs.cuda_ms(lambda: cuda_cost.cost_terms_cuda(
                p1, warped, rows, ccfg, tables), reps)
            sms = cs.cuda_ms(lambda: cuda_cost.cost_sums_cuda(
                cuda_cost.SINGLE, p1, warped, terms, rows, ccfg, tables), reps)
            passes = f" terms {tms:.3f} sums {sms:.3f}"
        print(f"{'planes' if planes else 'fronto'} {h}x{w} K={len(cands)} "
              f"taps={len(ccfg.tap_offsets)}: equal {torch.equal(got, ref)} "
              f"maxdiff {float((got - ref).abs().max()):.3g} kernel "
              f"{ms:.3f} ms{passes}", flush=True)
    for h, w in [(120, 160), (135, 240)]:
        (_, p1), (_, p2) = cs._packs(h, w, 3, -2, cs.SEED + 1, dev)
        stack = torch.stack([torch.roll(p2, s, 1) for s in range(5)])
        stack = stack.contiguous()
        got = cuda_cost.residual_costs_multiwarp_cuda(p1, stack, cfg.cost)
        ref = cuda_cost.residual_costs_multiwarp(p1, stack, cfg.cost)
        ms = cs.cuda_ms(lambda: cuda_cost.residual_costs_multiwarp_cuda(
            p1, stack, cfg.cost), 20)
        print(f"multiwarp {h}x{w}: equal {torch.equal(got, ref)} kernel "
              f"{ms:.3f} ms", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
