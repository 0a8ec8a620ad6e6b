#!/usr/bin/env python3
"""Kernel C of the PyTorch/CUDA port against its plain version, timed at
the shapes and modes of ``chip_smoke.py`` phase 3, for the
``eppm_tpu_torch`` of one checkout.  Needs a CUDA device.

    python3 tools/time_kernel_c.py [CHECKOUT] [--forms 32,16,8]

CHECKOUT (default: this one) is the root of the checkout whose package is
timed, e.g. a parent commit unpacked with ``git archive`` into a
gitignored directory; the inputs and the timer are this checkout's
``chip_smoke.py``.  To compare two versions, time both on one card, in
turns: parent, change, change, parent.  One line per shape and mode:
the pixels listed (those whose output can change, an iteration), whether
the kernel equals its plain version, the kernel's device time in ms (the
wrapper call less the same call at ``num_iter=0``, both timed on the
device with the host's launch overhead held out:
``chip_smoke.wmf_kernel_ms``) and the call's time by CUDA events around
it, which counts the host's overhead where the host is the slower.

``--forms`` (this checkout only) also builds the median kernel of
``csrc/wmf.cu`` at each form LANES (lanes a pixel: 32, 16 or 8) into a
library of its own (``nvcc -Xptxas -v``, the package's flags), prints its registers, local memory
(spills), shared memory and blocks per SM at the default window, and
times each form through the package's wrapper at every shape and mode,
with its equality to the plain version, in the order given and back.
"""

import argparse
import ctypes
import subprocess
import sys
from pathlib import Path

here = Path(__file__).resolve().parent.parent
args = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
args.add_argument("checkout", nargs="?", default=str(here))
args.add_argument("--forms", default="")
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
from eppm_tpu_torch.ops import _build, cuda_wmf  # noqa: E402

FORM_ENTRY = """
extern "C" int f{n}(const void* a, const void* b, const void* c,
                    const void* d, void* e, void* f, void* g, void* list,
                    void* count, const int* offs, const float* gw, int n,
                    int chunk, int H, int W, float inv, int only, int freeze,
                    void* s) {{
    WmfTable tab;
    const int rc = wmf_table(tab, offs, gw, n, chunk, H, W);
    if (rc != 0) return rc;
    return wmf_iteration<{lanes}>(
        (const float*)a, (const float*)b, (const float*)c, (const float*)d,
        (float*)e, (float*)f, (float*)g, (int*)list, (int*)count, tab, H, W,
        inv, only, freeze, (cudaStream_t)s);
}}
extern "C" int info_f{n}(int n, int chunk, int* out) {{
    auto k = &wmf_median_kernel<{lanes}>;
    const size_t smem = wmf_smem_bytes<{lanes}>(n, (n + chunk - 1) / chunk);
    cudaFuncAttributes a;
    cudaError_t e = cudaFuncSetAttribute(
        k, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e == cudaSuccess) e = cudaFuncGetAttributes(&a, k);
    if (e == cudaSuccess)
        e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &out[3], k, WMF_THREADS, smem);
    if (e == cudaSuccess) {{
        out[0] = a.numRegs;
        out[1] = (int)a.localSizeBytes;
        out[2] = (int)smem;
    }}
    return (int)e;
}}
"""


def parse_forms(text):
    """'32,16' -> [32, 16]."""
    forms = [int(f) for f in text.split(",")]
    for lanes in forms:
        if lanes not in (8, 16, 32):
            raise SystemExit(f"form {lanes}: LANES is 32, 16 or 8")
    return forms


def build_forms(forms):
    """The median kernel at each LANES of ``forms``, from this checkout's
    source: the loaded library."""
    out = _build.BUILD_DIR / "forms"
    out.mkdir(parents=True, exist_ok=True)
    src = out / "forms.cu"
    wmf = here / "eppm_tpu_torch" / "csrc" / "wmf.cu"
    src.write_text(f'#include "{wmf}"\n' + "".join(
        FORM_ENTRY.format(n=lanes, lanes=lanes) for lanes in forms))
    lib = out / "forms.so"
    run = subprocess.run(
        [_build.nvcc_path(), *_build.COMPILE_FLAGS, "-Xptxas", "-v",
         "-shared", "-o", str(lib), str(src)],
        capture_output=True, text=True)
    for line in run.stdout.splitlines() + run.stderr.splitlines():
        if "error" in line or "wmf_median_kernel" in line or (
                "registers" in line or "spill" in line):
            print("nvcc:", line.strip(), flush=True)
    if run.returncode:
        raise SystemExit("the form library did not build")
    return ctypes.CDLL(str(lib))


def time_cases(tag, inputs, listed):
    """Each shape and mode through the package's wrapper: listed pixels,
    equality with the plain version, kernel ms."""
    for (h, w), (tx, ty, img, fill) in inputs.items():
        for label, kw in cs.wmf_modes(fill):
            got = cuda_wmf.weighted_median_filter_cuda(tx, ty, img,
                                                       cfg.refine, **kw)
            ref = cuda_wmf.weighted_median_filter(tx, ty, img, cfg.refine,
                                                  **kw)
            equal = torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
            call_ms = cs.cuda_ms(lambda: cuda_wmf.weighted_median_filter_cuda(
                tx, ty, img, cfg.refine, **kw), 20)
            ms, whole, planes = cs.wmf_kernel_ms(
                lambda it: cuda_wmf.weighted_median_filter_cuda(
                    tx, ty, img, cfg.refine,
                    **(kw if it is None else dict(kw, num_iter=it))))
            print(f"{tag}wmf {label} {h}x{w}: listed "
                  f"{'/'.join(map(str, listed[h, w, label]))} of {h * w}  "
                  f"equal {equal}  kernel {ms:.4f} ms (device: the call "
                  f"{whole:.4f} less its planes {planes:.4f})  the call by "
                  f"events {call_ms:.3f} ms", flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("time_kernel_c: no CUDA device", file=sys.stderr)
        return 1
    print("package", Path(eppm_tpu_torch.__file__).parent, flush=True)
    dev = torch.device("cuda", 0)
    inputs = {(h, w): cs.wmf_inputs(h, w, dev) for h, w in cs.WMF_SHAPES}
    listed = {(h, w, label): cs.wmf_work(tx, ty, img, cfg.refine, kw).listed
              for (h, w), (tx, ty, img, fill) in inputs.items()
              for label, kw in cs.wmf_modes(fill)}
    time_cases("", inputs, listed)
    if not opts.forms:
        return 0
    if tree != here:
        raise SystemExit("--forms times this checkout's package only")
    forms = parse_forms(opts.forms)
    lib = build_forms(forms)
    I = ctypes.c_int
    n = (2 * cfg.refine.wmf_radius + 1) ** 2
    for lanes in forms:
        name = str(lanes)
        getattr(lib, "f" + name).argtypes = cuda_wmf.KERNEL.argtypes
        getattr(lib, "f" + name).restype = I
        info = (I * 4)()
        rc = getattr(lib, "info_f" + name)(n, cuda_wmf.WMF_CHUNK, info)
        print(f"form {name}: {info[0]} registers, {info[1]} B local memory,"
              f" {info[2]} B shared memory at {n} offsets, {info[3]} blocks "
              f"of 256 threads per SM" + (f" (CUDA error {rc})" if rc else ""),
              flush=True)
    _build.build_library()  # the package's error strings
    entry = cuda_wmf.KERNEL._fn
    try:
        for lanes in forms + forms[::-1]:
            cuda_wmf.KERNEL._fn = getattr(lib, f"f{lanes}")
            time_cases(f"form {lanes} ", inputs, listed)
    finally:
        cuda_wmf.KERNEL._fn = entry
    return 0


if __name__ == "__main__":
    sys.exit(main())
