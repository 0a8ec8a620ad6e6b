#!/usr/bin/env python3
"""Kernel A of the PyTorch/CUDA port against its plain version, timed at
the shapes of ``chip_smoke.py`` phase 3, for the ``eppm_tpu_torch`` of
one checkout.  Needs a CUDA device.

    python3 tools/time_kernel_a.py [CHECKOUT] [--groups 3x3,9x2]

CHECKOUT (default: this one) is the root of the checkout whose package is
timed, e.g. a parent commit unpacked with ``git archive`` into a
gitignored directory; the inputs and the timer are this checkout's
``chip_smoke.py``.  To compare two versions, time both in one machine
session: parent, change, change, parent.  One line per shape: whether the
kernel equals its plain version, and its time in ms (CUDA events, after a
warm-up), with its two passes apart where the package has them.

``--groups`` (this checkout only) also builds the sums pass of
``csrc/cost.cu`` with every form of its sums at each GROUPxBLOCKS
(candidates a thread, and the blocks an SM its launch bound asks for)
into a library of its own (the package's flags), prints each form's
registers, local memory (spills) and blocks per SM, and times each
through the package's wrapper at every shape, with its equality to the
plain version, in the order given and back.
"""

import argparse
import ctypes
import subprocess
import sys
from pathlib import Path

here = Path(__file__).resolve().parent.parent
args = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
args.add_argument("checkout", nargs="?", default=str(here))
args.add_argument("--groups", default="")
opts = args.parse_args()
tree = Path(opts.checkout).resolve()
sys.path[:0] = [str(tree), str(here)]

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
import eppm_tpu_torch  # noqa: E402
from eppm_tpu_torch.config import DEFAULT_CONFIG as cfg  # noqa: E402
from eppm_tpu_torch.ops import _build, cuda_cost  # noqa: E402
from eppm_tpu_torch.ops.dense import center_out_offsets, warp_pack  # noqa: E402
from eppm_tpu_torch.ops.match import _make_mini_cost  # noqa: E402

# every form of the sums at one (GROUP, MIN_BLOCKS), and each form's
# registers, local memory and blocks per SM
GROUP_ENTRY = """
extern "C" int g{g}x{b}(
    const void* pack1, const void* frames, const void* terms,
    const void* plan, void* out, const int* cands, const int* taps,
    const float* gws, int K, int T, int n_tables, int chunk, int R, int H,
    int W, float inv_sig_r2, void* stream) {{
    return residual_costs<{g}, {g}, {g}, {b}>(
        pack1, frames, terms, plan, out, cands, taps, gws, K, T, n_tables,
        chunk, R, H, W, inv_sig_r2, stream);
}}
extern "C" int info_g{g}x{b}(int* out) {{
    int rc = info(residual_cost_kernel<true, false, {g}, {b}>, out);
    if (rc == 0) rc = info(residual_cost_kernel<false, true, {g}, {b}>, out + 3);
    if (rc == 0) rc = info(residual_cost_kernel<false, false, {g}, {b}>, out + 6);
    return rc;
}}
"""
GROUP_INFO = """
template <class F> static int info(F k, int* out) {
    cudaFuncAttributes a;
    cudaError_t e = cudaFuncGetAttributes(&a, k);
    if (e == cudaSuccess)
        e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &out[2], k, BLOCK_X * BLOCK_Y, 0);
    out[0] = a.numRegs;
    out[1] = (int)a.localSizeBytes;
    return (int)e;
}
"""
FORMS = ("windows", "both sums in lanes", "weights in sequence")


def parse_groups(text):
    """'3x3,9x2' -> [(3, 3), (9, 2)]."""
    return [tuple(int(v) for v in g.split("x")) for g in text.split(",")]


def build_groups(groups):
    """The sums pass at each (GROUP, MIN_BLOCKS) of ``groups``, from this
    checkout's source: the loaded library."""
    out = _build.BUILD_DIR / "groups"
    out.mkdir(parents=True, exist_ok=True)
    src = out / "groups.cu"
    cost = here / "eppm_tpu_torch" / "csrc" / "cost.cu"
    src.write_text(f'#include "{cost}"\n' + GROUP_INFO + "".join(
        GROUP_ENTRY.format(g=g, b=b) for g, b in groups))
    lib = out / "groups.so"
    run = subprocess.run(
        [_build.nvcc_path(), *_build.COMPILE_FLAGS, "-shared", "-o",
         str(lib), str(src)], capture_output=True, text=True)
    if run.returncode:
        print(run.stdout + run.stderr, flush=True)
        raise SystemExit("the group library did not build")
    return ctypes.CDLL(str(lib))


def time_cases(tag, cases, dev):
    """Each shape through the package's wrapper: equality with the plain
    version, the call's ms and, where the package has them, its passes."""
    for h, w, cands, ccfg, planes, chunk in cases:
        (_, p1), (_, p2) = cs._packs(h, w, 3, -2, cs.SEED, dev)
        g = torch.full((h, w), 2, dtype=torch.int32, device=dev)
        warped = warp_pack(p2, g + 1, -g)
        kernel = (cuda_cost.residual_costs_planes_cuda if planes
                  else cuda_cost.residual_costs_cuda)
        got = kernel(p1, warped, cands, ccfg, chunk)
        ref = cuda_cost.residual_costs(p1, warped, cands, ccfg, planes, chunk)
        reps = 20 if h * w < 300_000 else 5
        ms = cs.cuda_ms(lambda: kernel(p1, warped, cands, ccfg, chunk), reps)
        passes = ""
        if hasattr(cuda_cost, "cost_sums_cuda"):
            rows = [(cy, cx, 0) for cy, cx in cands]
            tables = cuda_cost.cost_tables(ccfg, planes)
            terms = cuda_cost.cost_terms_cuda(p1, warped, rows, ccfg, tables)
            tms = cs.cuda_ms(lambda: cuda_cost.cost_terms_cuda(
                p1, warped, rows, ccfg, tables), reps)
            sms = cs.cuda_ms(lambda: cuda_cost.cost_sums_cuda(
                cuda_cost.SINGLE, p1, warped, terms, rows, ccfg, tables,
                chunk), reps)
            passes = f" terms {tms:.3f} sums {sms:.3f}"
        print(f"{tag}{'planes' if planes else 'fronto'} {h}x{w} "
              f"K={len(cands)} taps={len(ccfg.tap_offsets)} chunk={chunk}: "
              f"equal {torch.equal(got, ref)} maxdiff "
              f"{float((got - ref).abs().max()):.3g} kernel {ms:.3f} ms"
              f"{passes}", flush=True)
    for h, w in [(120, 160), (135, 240)]:
        (_, p1), (_, p2) = cs._packs(h, w, 3, -2, cs.SEED + 1, dev)
        stack = torch.stack([torch.roll(p2, s, 1) for s in range(5)])
        stack = stack.contiguous()
        got = cuda_cost.residual_costs_multiwarp_cuda(p1, stack, cfg.cost)
        ref = cuda_cost.residual_costs_multiwarp(p1, stack, cfg.cost)
        ms = cs.cuda_ms(lambda: cuda_cost.residual_costs_multiwarp_cuda(
            p1, stack, cfg.cost), 20)
        print(f"{tag}multiwarp {h}x{w}: equal {torch.equal(got, ref)} "
              f"kernel {ms:.3f} ms", flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("time_kernel_a: no CUDA device", file=sys.stderr)
        return 1
    print("package", Path(eppm_tpu_torch.__file__).parent, flush=True)
    dev = torch.device("cuda", 0)
    mini = _make_mini_cost(cfg.cost, cfg.match)
    r1, r3 = center_out_offsets(1), center_out_offsets(3)
    cases = [  # (h, w, candidates, cost config, plane mode, tap chunk)
        (60, 80, r3, mini, False, 25),
        (120, 160, r3, cfg.cost, False, 25),
        (480, 640, r1, cfg.cost, False, 25),
        (1080, 1920, r1, cfg.pass2_cost, False, 25),
        (1080, 1920, r1, cfg.cost, False, 25),
        (1080, 1920, r1, cfg.pass2_cost, True, 25),
        (1080, 1920, r1, cfg.cost, True, 25),
        (60, 80, r3, mini, False, 49),
        (1080, 1920, r1, cfg.pass2_cost, False, 49),
        (1080, 1920, r1, cfg.cost, False, 49),
    ]
    time_cases("", cases, dev)
    if not opts.groups:
        return 0
    if tree != here:
        raise SystemExit("--groups times this checkout's package only")
    groups = parse_groups(opts.groups)
    lib = build_groups(groups)
    for g, b in groups:
        name = f"g{g}x{b}"
        getattr(lib, name).argtypes = cuda_cost.SINGLE.argtypes
        getattr(lib, name).restype = ctypes.c_int
        info = (ctypes.c_int * 9)()
        rc = getattr(lib, "info_" + name)(info)
        print(f"group {g}x{b}: " + "; ".join(
            f"{form} {info[3 * i]} registers, {info[3 * i + 1]} B local "
            f"memory, {info[3 * i + 2]} blocks per SM"
            for i, form in enumerate(FORMS))
            + (f" (CUDA error {rc})" if rc else ""), flush=True)
    kernels = (cuda_cost.SINGLE, cuda_cost.MULTIWARP, cuda_cost.PLANES)
    for k in kernels:
        k._entry()
    entries = [k._fn for k in kernels]
    try:
        for g, b in groups + groups[::-1]:
            for k in kernels:
                k._fn = getattr(lib, f"g{g}x{b}")
            time_cases(f"group {g}x{b} ", cases, dev)
    finally:
        for k, fn in zip(kernels, entries):
            k._fn = fn
    return 0


if __name__ == "__main__":
    sys.exit(main())
