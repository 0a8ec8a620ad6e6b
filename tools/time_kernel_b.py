#!/usr/bin/env python3
"""Kernel B of the PyTorch/CUDA port against its plain version, timed at
the shapes of ``chip_smoke.py`` phase 3, for the ``eppm_tpu_torch`` of
one checkout.  Needs a CUDA device.

    python3 tools/time_kernel_b.py [CHECKOUT] [--tiles 32x32x1,32x32x2]

CHECKOUT (default: this one) is the root of the checkout whose package is
timed, e.g. a parent commit unpacked with ``git archive`` into a
gitignored directory; the inputs and the timer are this checkout's
``chip_smoke.py``.  To compare two versions, time both in one machine
session: parent, change, change, parent.  One line per shape and radius:
which kernel launched (by the package's launch counts), whether it equals
its plain version, and its time in ms (CUDA events, after a warm-up).

``--tiles`` also builds the paired kernel of this checkout's
``csrc/smooth.cu`` at each tile form THxTWxPPT (a TH x TW tile, PPT
pixels a thread) into a library of its own (``nvcc -Xptxas -v``, the
package's flags), prints its registers, local memory (spills), shared
memory and blocks per SM, and times each form at the radius-10 shapes,
with its equality to the plain version, in the order given and back.
"""

import argparse
import ctypes
import dataclasses
import subprocess
import sys
from pathlib import Path

here = Path(__file__).resolve().parent.parent
args = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
args.add_argument("checkout", nargs="?", default=str(here))
args.add_argument("--tiles", default="")
opts = args.parse_args()
tree = Path(opts.checkout).resolve()

import torch  # noqa: E402

# this checkout's chip_smoke (it imports the package only when called),
# then the package of CHECKOUT
sys.path.insert(0, str(here))
import chip_smoke as cs  # noqa: E402

sys.path.insert(0, str(tree))
import eppm_tpu_torch  # noqa: E402
from eppm_tpu_torch.config import DEFAULT_CONFIG as cfg  # noqa: E402
from eppm_tpu_torch.ops import _build, cuda_smooth  # noqa: E402
from eppm_tpu_torch.ops._util import inv32  # noqa: E402
from eppm_tpu_torch.ops.refine import SMOOTH_CHUNK, smoothing_weights  # noqa: E402,E501

TILE_ENTRY = """
extern "C" int t{n}(const void* f, const void* i, void* o, const float* g,
                    int H, int W, float inv, void* s) {{
    return launch_pair<{th}, {tw}, {ppt}>(f, i, o, g, H, W, inv,
                                          (cudaStream_t)s);
}}
extern "C" int info_t{n}(int* out) {{
    using T = PairTile<{th}, {tw}, {ppt}>;
    auto k = &flow_smooth_pair_kernel<{th}, {tw}, {ppt}>;
    cudaFuncAttributes a;
    cudaError_t e = cudaFuncSetAttribute(
        k, cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
    if (e == cudaSuccess) e = cudaFuncGetAttributes(&a, k);
    if (e == cudaSuccess)
        e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &out[3], k, T::THREADS, T::SMEM);
    if (e == cudaSuccess) {{
        out[0] = a.numRegs;
        out[1] = (int)a.localSizeBytes;
        out[2] = T::SMEM;
    }}
    return (int)e;
}}
"""


def build_tiles(tiles):
    """The paired kernel at each (TH, TW, PPT) of ``tiles``, from this
    checkout's source: the loaded library."""
    out = _build.BUILD_DIR / "tiles"
    out.mkdir(parents=True, exist_ok=True)
    src = out / "tiles.cu"
    smooth = here / "eppm_tpu_torch" / "csrc" / "smooth.cu"
    src.write_text(f'#include "{smooth}"\n' + "".join(
        TILE_ENTRY.format(n=f"{th}x{tw}x{ppt}", th=th, tw=tw, ppt=ppt)
        for th, tw, ppt in tiles))
    lib = out / "tiles.so"
    run = subprocess.run(
        [_build.nvcc_path(), *_build.COMPILE_FLAGS, "-Xptxas", "-v",
         "-shared", "-o", str(lib), str(src)],
        capture_output=True, text=True)
    for line in run.stdout.splitlines() + run.stderr.splitlines():
        if "error" in line or ("flow_smooth_pair" in line) or (
                "registers" in line or "spill" in line):
            print("nvcc:", line.strip(), flush=True)
    if run.returncode:
        raise SystemExit("the tile library did not build")
    return ctypes.CDLL(str(lib))


def main() -> int:
    if not torch.cuda.is_available():
        print("time_kernel_b: no CUDA device", file=sys.stderr)
        return 1
    print("package", Path(eppm_tpu_torch.__file__).parent, flush=True)
    dev = torch.device("cuda", 0)
    counts = {name: getattr(cuda_smooth, name)
              for name in ("PAIRED", "KERNEL") if hasattr(cuda_smooth, name)}
    for h, w, r in cs.SMOOTH_CASES:
        rcfg = dataclasses.replace(cfg.refine, blf_sigma_spatial=r / 2)
        flow, img = cs.smooth_inputs(h, w, dev)
        before = {name: c.launches for name, c in counts.items()}
        got = cuda_smooth.flow_smoothing_cuda(flow, img, rcfg)
        ran = [name for name, c in counts.items()
               if c.launches > before[name]]
        ref = cuda_smooth.flow_smoothing(flow, img, rcfg)
        ms = cs.cuda_ms(lambda: cuda_smooth.flow_smoothing_cuda(
            flow, img, rcfg), 10)
        print(f"smooth {h}x{w} r={r} ({'/'.join(ran)}): equal "
              f"{torch.equal(got, ref)} maxdiff "
              f"{float((got - ref).abs().max()):.3g} kernel {ms:.3f} ms",
              flush=True)
    if not opts.tiles:
        return 0
    tiles = [tuple(int(v) for v in t.split("x"))
             for t in opts.tiles.split(",")]
    lib = build_tiles(tiles)
    P, I = ctypes.c_void_p, ctypes.c_int
    for th, tw, ppt in tiles:
        n = f"{th}x{tw}x{ppt}"
        getattr(lib, "t" + n).argtypes = [P, P, P, P, I, I, ctypes.c_float, P]
        info = (ctypes.c_int * 4)()
        rc = getattr(lib, "info_t" + n)(info)
        print(f"tile {n}: {info[0]} registers, {info[1]} B local memory, "
              f"{info[2]} B shared memory, {info[3]} blocks per SM"
              + (f" (CUDA error {rc})" if rc else ""), flush=True)
    g = smoothing_weights(cfg.refine)
    inv = inv32(cfg.refine.blf_sigma_range**2)
    for h, w, r in cs.SMOOTH_CASES:
        if 2 * r + 1 != SMOOTH_CHUNK:
            continue
        flow, img = cs.smooth_inputs(h, w, dev)
        ref = cuda_smooth.flow_smoothing(flow, img, cfg.refine)
        for th, tw, ppt in tiles + tiles[::-1]:
            n = f"{th}x{tw}x{ppt}"
            out = torch.empty_like(flow)

            def call():
                rc = getattr(lib, "t" + n)(
                    flow.data_ptr(), img.data_ptr(), out.data_ptr(),
                    g.ctypes.data, h, w, inv,
                    torch.cuda.current_stream().cuda_stream)
                if rc:
                    raise SystemExit(f"tile {n}: CUDA error {rc}")

            ms = cs.cuda_ms(call, 10)
            print(f"tile {n} smooth {h}x{w} r={r}: equal "
                  f"{torch.equal(out, ref)} kernel {ms:.3f} ms", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
