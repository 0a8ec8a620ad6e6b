#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``eppm_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each of which must pass (any failure exits non-zero and the
final line is not printed):

1. versions: torch, CUDA, nvcc, and the card's name and power limit;
2. build: the CUDA kernels, from ``eppm_tpu_torch/csrc`` (one nvcc per
   source, all started together);
3. kernels against their plain PyTorch versions, on the card, at the
   shapes the main paths give them: kernel A identical (max |diff| 0,
   no value differs) in its fronto, multiwarp and plane modes, and its
   terms pass identical to ``cost_terms``, and in its fronto mode at
   ``cost_tap_chunk=49`` (1080p, 49 taps in one partial sum), and in each
   other form of XLA's sums that a site of the pipeline takes (one
   candidate; windows of 32 taps at chunk 49 in every mode, the mini
   levels' 81 taps in two chunks); kernel B
   identical, the
   paired kernel at the default radius 10 and the one-pass kernel at
   radius 6 (the launch counts say which ran); kernel C identical
   targets in its polish, Jacobi and full-image modes, with the share of
   pixels it lists, and in its full-image mode at the fine levels of
   1080p (540x960, 1080x1920: ``fine_level_wmf``); the global argmax identical indices (kernel D at N1
   = N2 = 1200, 8160 and 129,600); kernel E (PatchMatch's gathered cost
   and fold, ``csrc/patchmatch.cu``) identical to its plain composition in
   its propagation mode (K = 4) and fold mode (the random search's K = 6)
   at the coarse levels of 640x480 and 1280x960 (120x160, 240x320), and
   in its cost-only mode at 120x160 (its time device time: the wrapper's
   host work outlasts the launch); kernel F (the dense matcher's exact
   stage, ``csrc/exact.cu``) identical to ``match.exact_best_of`` at the
   1080p coarse level (135x240) in each of its calls: the incumbent's
   score (K = 1), the 8-ring, a step-2 propagation round (K = 4) and the
   median round at equality (K = 1), and its occlusion arbitration
   rule identical to ``occlusion.arbitrate_holes`` at the coarse levels
   of 1080p and 640x480 (135x240, 120x160; K = 5, 49 taps), its bound the
   float64 conversions of its exps as well as its operations; with each
   one's time beside the plain
   version's (CUDA events, after a warm-up; kernel A's two passes also
   apart; kernel C's wrapper call is host-bound, so its time is device
   time, the call less the same call at ``num_iter=0``), its bound (the larger of its operations, counted from its
   source over the work these inputs need, over the card's peak and its
   bytes over the memory rate) and, for kernel D, the float64 matrix
   products alone as the library yardstick;
4. end to end, one path after another, each with every launch count set
   to 0 just before it and read just after, and each of its kernels
   launched at least once (``EPPMFlow`` and the command line go through
   ``compute_flow_jit``: a pair's first call captures its CUDA graph, the
   timed calls replay it, and each replay adds the launches its capture
   recorded), and the share of holes in each of kernel C's
   polish calls (then, outside the counted run, one 1080p pair of the
   default path under ``torch.profiler``: each hand kernel's device time
   and launches per pair, kernel C's two kernels summed):
   - ``EPPMFlow`` under ``DEFAULT_CONFIG``, and with the reference's
     plane-hypothesis re-search in both dense passes
     (``dense_pass1_planes``, ``dense_pass2_planes``), on synthetic pairs
     with a known integer translation: (3, -2), (37, 21) and (-70, 44)
     at 640x480, (5, 3) at 1920x1080 (the temporal path below runs
     (-70, 44) at 1920x1080);
   - ``EPPMFlow`` with the gathered plane-fitting refine
     (``refine_impl="gather"``), and with the smoothing radius 6
     (``refine.blf_sigma_spatial=3.0``), at 640x480;
   each with finite flow, warp error below 0.6x the zero-flow baseline,
   the interior EPE against the known shift, and the smoothing kernel
   launched once per fine level and once at the end (3 per 640x480
   pair, 4 per 1080p pair: the paired kernel, or at radius 6 the
   one-pass kernel);
   - ``match_coarse`` (single direction) on the coarse level of a
     3840x2160 pair under ``pyramid.auto_depth_dim=0`` (540x960, global
     proposals on a stride-2 grid of 129,600 targets): the known shift
     recovered in the interior;
   - the temporal warm start: 1080p streams of 5 frames of a constant
     motion, (5, 3) and (-70, 44) a frame, through ``EPPMFlow`` cold pair
     after pair, then warm-started (``compute_flow(init_flow=...)``, the
     previous pair's flow): ms per pair of both, and each warm pair's
     interior EPE < 1 with no global stage run;
   - the stream command line (``cli.main(["--frames-dir", ...,
     "--out-dir", ...])``) on 5 PPM frames: cold at 640x480 and 1080p,
     and with ``--temporal`` at 640x480; a .flo per pair with the motion,
     the fps line logged;
   - the legacy WMF order (``refine.wmf_fill_first=False``: kernel C
     ``wmf_coarse_iters`` times a pair) and the fine-level WMF
     (``fine_level_wmf=True``: kernel C once more a fine level), at
     640x480 and 1080p;
   - ``subpixel_refine`` and ``dense_subpixel_fit`` on half-pixel shifts
     at 640x480 and 1080p, the interior EPE beside the integer default's;
   - the PatchMatch engine (``match_engine="patchmatch"``) through
     ``EPPMFlow`` on its default key: (3, -2) and (37, 21) at
     640x480, (5, 3) at 1080p, kernel E launched 102 times a pair (an
     init and 10 x 5 rounds, both directions; 0 times on the default
     path) and kernel F once, its occlusion arbitration (9 times a pair
     on every dense path: 8 in the exact stage),
     each pair's flow held by ``utils.guard.
     check_flow`` (finite, warp error below 0.6x the zero-flow one), its
     interior EPE, its time by ``utils.timing.DeviceTimer``, a second run
     identical to the first, and its device events under
     ``torch.profiler``, the pair's (at 1080p also the PatchMatch
     stage's alone, drawing from the key and from a ``torch.Generator``:
     the device events the key's draws add); the dense matcher's kernels
     (the multiwarp form of kernel A, kernel D) launched no time;
   - the command line on that engine: ``--gt`` with a KITTI 16-bit PNG
     ground truth, and ``--eval-dir`` over two 640x480 sequences (the
     scores of each);
   - the multi-device path (``parallel.compute_flow_sharded``, on a
     mesh of one card a CUDA graph per mesh and shape: the warm-up call
     captures, the timed call replays) on meshes of this card repeated:
     a 1080p pair on a (1, 1, 2) and on a (1, 2, 2) mesh (padded to
     1088x1920), each within the contract of single-device ``EPPMFlow``
     and of each other, ms per pair beside the single device's, kernels
     A and B launched once per tile where one device launches them once;
     a (2, 1, 1) batch of two 640x480 pairs; ``cli --mesh 1,1,1``, and a
     mesh of more cards than there are refused;
5. agreement: the port on the card against the port on the CPU (plain
   versions) at 192x256, under ``DEFAULT_CONFIG`` and with both plane
   flags, and under ``DEFAULT_CONFIG`` on a pair with black regions,
   warm-started from an init holding unknown flow and values beyond
   +-2^31 (with and without the global stages), in the legacy WMF
   order, with the fine-level WMF and with each subpixel stage: at
   least 98% of pixels within 1e-3 and mean |diff| < 0.05;
   ``match_coarse`` at 60x80 returns the same targets on both, so does
   ``match_coarse_bidi`` warm-started from such an init, and so does
   ``global_match_bidi`` on the descriptors of frames with black regions
   (``eppm_tpu_torch/testing.py::dark_rows``), where the float64 sums
   are not exact in every order; on the PatchMatch path under the
   default key (JAX's threefry draws, integer ops on both devices): the
   flow at 192x256 identical, and ``patchmatch``, ``patchmatch_scaled``,
   ``patchmatch_planefitting`` (4 iterations each) and
   ``line_propagate`` at 48x64 with identical targets;
6. the evaluation dossier on the card: the local eval set
   (``eppm_tpu_torch.evalset``: 480x640, 436x1024 and 375x1242 cases,
   KITTI PNG16 ground truth, the holdout group) built into a temporary
   directory and scored by ``eppm_tpu_torch.eval_report`` on both
   engines, over every case ``eppm_tpu_torch/evalset_reference.json``
   holds for each (the JAX package's scores, made on the CPU by
   ``tools/torch_eval_parity.py``): each case's EPE within 0.01 of the
   JAX package's outside the holdout group (there logged, not judged),
   beside the share of pixels whose CPU flow agrees with the JAX
   package's within 1e-3 (the reference's), its ms by ``DeviceTimer``,
   the engine's kernels launched (the counts
   zeroed before it), and the launches per pair at each group's shape
   (a replay's);
7. graph against eager: ``compute_flow_jit`` (one CUDA graph per shape
   and configuration, ``eppm_tpu_torch/graphs.py``), its cache emptied
   first, against the eager ``compute_flow`` on the card: under
   ``DEFAULT_CONFIG`` at 640x480, 1080p and 2160x3840, both plane flags,
   ``refine_impl="gather"``, ``refine.blf_sigma_spatial=3.0``,
   ``refine.wmf_fill_first=False``, ``fine_level_wmf=True``,
   ``subpixel_refine``, ``dense_subpixel_fit``, the temporal warm pair,
   and PatchMatch on its default key and on a given key: the graph's
   capture and first replay, an eager call under
   ``torch.cuda.set_sync_debug_mode("error")`` (no op synchronises with
   the host), a second replay, each replay ``torch.equal`` to the eager
   flow, with the warm-up, capture and
   instantiation seconds and the device memory allocated at most; then
   the median wall of 10 replays against the median of 5 eager calls at
   640x480 and 1080p, default and PatchMatch (one more replay each: kernel
   F launched 9 times on the dense engine, once on PatchMatch, the fill-
   first chain's arbitration), and one replay of each at
   1080p under ``torch.profiler`` (device events, device busy as a share
   of the replayed wall, each hand kernel's events against the launches
   the replay added); then ``compute_flow_sharded`` (one CUDA graph per
   mesh and shape on meshes of this card repeated) against its eager
   body, ``compute_flow_sharded_eager``: 1080p on (1, 1, 2) and on (1, 2,
   2) padded to 1088x1920, a (2, 1, 1) batch of two 640x480 pairs, a warm
   640x480 (1, 1, 2) pair and PatchMatch on its default keys, each as
   above (the eager body under the sync debug mode, both replays
   identical to it, its launches a replay's, kernel B once a tile a
   level), and at 1080p on (1, 1, 2) the walls of 10 replays against 5
   eager calls and a replay under the profiler;
8. the stage profilers (``eppm_tpu_torch/bench``), each ``main(argv)``
   in this process on the card at 1080x1920: ``profile_stages`` and
   ``profile_match``; each exits 0 and prints JSON lines that parse
   (logged here); the stage spans of a traced replay of the pair tile
   its ``graph`` span (within 1%), that span is within 5% of CUDA events
   around the same replay, the traced flow is identical to the untraced
   one and the untraced graph holds no mark node; ``profile_match``'s
   exact rows are kernel F's calls, ``exact_best_of`` at K = 1, 8, 4
   and 1;
9. the upstream deployment (``UPSTREAM_CONFIG``, linchaobao/EPPM's
   binary's settings): kernel E identical to its plain version in its
   cost-only mode over the 4 plane tables of 100 taps at K = 1 (the
   gathered refine's launches) at 480x640 and 240x320, and in its
   propagation and fold modes at 100 taps at 120x160, each with its
   device ms and its share of the bound; kernel C's 20 occlusion-only
   iterations at 120x160 identical to the plain version, 20 launches;
   one 640x480 pair eager (under the sync debug mode) and replayed
   through ``compute_flow_jit``, identical, with kernel E launched 120
   times a pair (102 in the search, 9 a fine level in the refine),
   kernel C 20, kernel B 3 and kernel F none, eager and in a replay; and
   a traced replay, identical, whose ``occlusion`` stage holds
   ``occlusion.wmf`` and ``occlusion.fill``.  Alone: ``python3 -c "import torch, chip_smoke
   as c; c.phase_build(); c.phase_upstream(torch.device('cuda', 0))"``.

Each phase logs its seconds.  The line before the last is one JSON object
with a row per kernel; the last line is ``{"ok": true, "device": {...}}``.
The synthetic pairs are smooth textures made from a seed with numpy; the
stream's frames are written to a temporary directory and read back.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time

import numpy as np
import torch

from eppm_tpu_torch.testing import shifted_pair, texture
from flowbench.gather_work import TAP_OPS
from flowbench.plane_work import kernel_a_work
from flowbench.stats import (COST_DR1_OPS, COST_SUM_OPS, COST_TERM_OPS, PEAKS,
                             bound_ms)

SEED = 0


def log(*args):
    print(*args, flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SystemExit(f"FAIL: {what}")


def cuda_ms(fn, reps: int, warm: bool = True) -> float:
    """Mean device time of fn() in ms over ``reps`` runs, after a warm-up
    run unless ``warm`` is False (the caller has just run fn's work)."""
    if warm:
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, reps: int) -> float:
    """Mean device time of fn() in ms over ``reps`` runs, after a warm-up
    run, without the host's launch overhead: a spin kernel holds the
    stream while the host enqueues the runs, and the events time what the
    device then does.  The spin doubles until it outlasts the enqueue, up
    to 16x; raises if even that spin does not (fn syncs, or fills the
    launch queue)."""
    fn()
    spin = 10**8  # cycles: ~50 ms at the H100's clock
    while spin <= 16 * 10**8:
        torch.cuda.synchronize()
        held, start, end = (torch.cuda.Event(enable_timing=True)
                            for _ in range(3))
        held.record()
        torch.cuda._sleep(spin)
        start.record()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        enqueue_ms = (time.perf_counter() - t0) * 1e3
        end.record()
        torch.cuda.synchronize()
        if enqueue_ms < held.elapsed_time(start):
            return start.elapsed_time(end) / reps
        spin *= 2
    raise RuntimeError(f"device_ms: the host's enqueue of {reps} runs "
                       f"outlasted a spin of {spin // 2} cycles")


def wmf_kernel_ms(call, reps: int = 20):
    """Kernel C's device time in ms, (kernel, whole call, planes alone):
    the wrapper ``call(num_iter)`` less the same call at num_iter=0, which
    makes the input planes and the targets and launches nothing."""
    whole = device_ms(lambda: call(None), reps)
    planes = device_ms(lambda: call(0), reps)
    return whole - planes, whole, planes


# The card's peaks (flowbench.stats.PEAKS: float32 outside the tensor
# cores, device memory) and kernel A's and E's operation counts are the
# benchmark's, so that a kernel's bound here and its roofline there are
# one yardstick.  Other rates go through bound_ms's peaks: float64 on the
# tensor cores, one H100 SXM at 700 W (NVIDIA's data sheet, dense).
F64_TENSOR_FLOPS = 67e12
# float32 operations per unit of work, counted from the kernels' sources
# as flowbench.stats counts kernel A's: an FMA counts 2; any other
# arithmetic, min, max or compare 1; abs, negation, conversions and
# integer index arithmetic 0.  exp_cephes (csrc/common.cuh) is 27 of
# them.  Against the float32 peak, which counts an FMA as 2, this makes
# the operation bound optimistic: a lower bound.  COST_TAP_OPS is all of
# kernel A's per (candidate, pixel, tap, table), as a one-pass kernel
# computes them: the earlier yardstick, logged beside the bound.
COST_TAP_OPS = COST_TERM_OPS + COST_DR1_OPS + COST_SUM_OPS  # 112
# Kernel B (csrc/smooth.cu): the range weight once per unordered in-image
# pair that a known tap reads (dr 5, square and scale 2, exp 27, spatial
# scale 1, flush 1), the sums per (pixel, in-image known tap) (known test
# 2, two weighted sums 4, weight sum 1).  SMOOTH_ONE_PASS_OPS is both per
# (pixel, known tap), as the one-pass kernel computes them: the earlier
# yardstick, logged beside the bound.
SMOOTH_PAIR_OPS = 36
SMOOTH_TAP_OPS = 7
SMOOTH_ONE_PASS_OPS = SMOOTH_PAIR_OPS + SMOOTH_TAP_OPS  # 43
# Kernel C (csrc/wmf.cu), at each pixel whose output can change: the weight
# per in-image valid support, the cost term per (valid candidate, support of
# nonzero weight); the kernel skips the rest, which change no bit.  The
# earlier yardstick, every support at every pixel, is logged beside it.
WMF_SUPPORT_OPS = 38
WMF_PAIR_OPS = 5
# Kernel F (csrc/exact.cu), per (candidate, pixel, tap): two exps 54, three
# maxabs3 15, the range weight's square, fused sum 2, scale, spatial scale
# and flush 6, ad's square and scale 2, 1 - exp 1, the term's sum 1, the
# running cost's fma 2 and the weight's sum 1.  What bounds it is not these
# but its float32 <-> float64 conversions: 19 an exp_cephes (csrc/
# common.cuh: 9 fma32, each converting its float32 operands and rounding
# back, constants converted at compile time and repeated operands once),
# 3 in the range weight's fma32 and 4 in the running cost's.  An SM
# converts 16 a clock (the CUDA C++ Programming Guide's throughput table,
# compute capability 9.0): 132 SMs at the H100 SXM's 1.98 GHz boost clock.
EXACT_TAP_OPS = 82
EXACT_TAP_CONVERSIONS = 2 * 19 + 3 + 4
CONVERSIONS_PER_S = 132 * 16 * 1.98e9


def kernel_e_bound(k: int, h: int, w: int, taps: int, tables: int,
                   mode: str):
    """(bound_ms, bound_by) of one launch of kernel E in ``mode`` (cost,
    fold or propagate) over ``k`` candidate fields at ``h`` x ``w``, each
    scored over ``tables`` tables of ``taps`` taps: ``TAP_OPS`` a
    (candidate, pixel, tap, table); both packs read as float4, the
    candidates' targets in, and the costs (cost-only) or the incumbent in
    and the folded state out."""
    nbytes = h * w * (2 * 16 + k * 8 + (24 if mode != "cost" else k * 4))
    return bound_ms(k * h * w * taps * tables * TAP_OPS, nbytes)


def window_count(mask: torch.Tensor, offsets) -> torch.Tensor:
    """Per pixel, how many of the (dy, dx) ``offsets`` land on a True of
    the (H, W) ``mask`` inside the image: int64 (H, W)."""
    h, w = mask.shape
    r = max(max(abs(dy), abs(dx)) for dy, dx in offsets)
    m = torch.nn.functional.pad(mask.to(torch.int64), (r, r, r, r))
    out = torch.zeros((h, w), dtype=torch.int64, device=mask.device)
    for dy, dx in offsets:
        out += m[r + dy : r + dy + h, r + dx : r + dx + w]
    return out


def pair_count(known: torch.Tensor, r: int) -> int:
    """Unordered pairs {p, q} of in-image pixels within the (2r+1)^2
    window whose range weight some known tap reads (q known, for p's tap,
    or p known, for q's); {p, p} counts where p is known."""
    h, w = known.shape
    n = int(known.sum())
    for dy in range(0, min(r, h - 1) + 1):
        for dx in range(-r, r + 1):
            if (dy == 0 and dx <= 0) or abs(dx) >= w:
                continue
            a = known[: h - dy, max(0, -dx) : w - max(0, dx)]
            b = known[dy:, max(0, dx) : w + min(0, dx)]
            n += int((a | b).sum())
    return n


def kernel_a_bound(h: int, w: int, cands, taps, tables, n_frames: int = 1):
    """(bound_ms, bound_by) of one launch of kernel A at ``h`` x ``w``:
    the benchmark's count (``flowbench.plane_work.kernel_a_work``: the
    terms over each map's padded frame, the frame-1 range distances, the
    weighted sums a table and the least over the tables; the packs read
    once and a float32 cost a candidate written)."""
    return bound_ms(*kernel_a_work(h, w, cands, taps, tables, n_frames))


def phase_versions() -> str:
    log("== phase 1: versions")
    log(f"python {sys.version.split()[0]}  torch {torch.__version__}  "
        f"cuda {torch.version.cuda}")
    from eppm_tpu_torch.ops._build import nvcc_path

    nvcc = subprocess.run([nvcc_path(), "--version"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()
    log(f"nvcc: {nvcc[-1]}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(f"gpu: {smi}")
    # the port takes no float32 matrix product (the global match is
    # exact in float64); TF32 stays off all the same
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return smi


def phase_build() -> None:
    log("== phase 2: build")
    from eppm_tpu_torch.ops import _build

    t0 = time.perf_counter()
    _build.build_library()
    seconds = time.perf_counter() - t0
    built = _build.build_seconds()
    log(f"kernel library {_build.library_path().name}: "
        + (f"built in {built:.1f} s" if built is not None
           else "already built")
        + f", loaded in {seconds:.1f} s")


def _packs(h, w, dx, dy, seed, dev):
    from eppm_tpu_torch.ops.census import census_transform
    from eppm_tpu_torch.ops.cost import pack_frame

    f1, f2 = shifted_pair(h, w, dx, dy, seed)
    out = []
    for f in (f1, f2):
        img = torch.from_numpy(f).to(dev).to(torch.float32) / 255.0
        out.append((img, pack_frame(img, census_transform(img))))
    return out


# kernel B's shapes (h, w, radius): the default path's 640x480 and 1080p
# level 0, and radius 6 (refine.blf_sigma_spatial=3.0)
SMOOTH_CASES = [(480, 640, 10), (1080, 1920, 10), (480, 640, 6)]


def smooth_inputs(h, w, dev):
    """Kernel B's inputs: flow uniform in [-3, 3) with an unknown block,
    and a textured image."""
    from eppm_tpu_torch.config import UNKNOWN_FLOW

    (img, _), _ = _packs(h, w, 3, -2, SEED + 2, dev)
    rng = np.random.default_rng(SEED + 2)
    flow = torch.from_numpy(
        (rng.random((h, w, 2)) * 6 - 3).astype(np.float32)).to(dev)
    flow[h // 4 : h // 2, w // 4 : w // 3] = UNKNOWN_FLOW
    return flow, img


# kernel C's shapes: the coarse levels of 640x480 (whole-level Pallas form)
# and of 1080p (tiled Pallas form); with fine_level_wmf, the full image at
# the fine levels of 1080p up to level 0
WMF_SHAPES = [(120, 160), (135, 240)]
WMF_FINE_SHAPES = [(540, 960), (1080, 1920)]


def wmf_inputs(h, w, dev):
    """Kernel C's inputs: the targets of a (3, -2) shift with noise in
    [-2, 2], ~15% holes and a block of holes, a textured image, and the
    holes' fill (``fill_holes``)."""
    from eppm_tpu_torch.config import INVALID_LOCATION
    from eppm_tpu_torch.ops._util import grid
    from eppm_tpu_torch.ops.refine import fill_holes

    (img, _), _ = _packs(h, w, 3, -2, SEED + 3, dev)
    ys, xs = grid(h, w, dev)
    rng = np.random.default_rng(SEED + 3)
    off = torch.from_numpy(rng.integers(-2, 3, (2, h, w)).astype(
        np.int32)).to(dev)
    tx, ty = xs + 3 + off[0], ys - 2 + off[1]
    holes = torch.from_numpy(rng.random((h, w)) < 0.15).to(dev)
    holes[h // 3 : h // 2, w // 3 : w // 2] = True
    tx = torch.where(holes, INVALID_LOCATION, tx)
    ty = torch.where(holes, INVALID_LOCATION, ty)
    return tx, ty, img, fill_holes(tx, ty, img)


def wmf_modes(fill):
    """(label, keyword arguments) of kernel C's modes: the polish, three
    Jacobi iterations at dilation 2, one full-image iteration."""
    return [
        ("polish d=1", dict(only_occlusion=True, polish_init=fill)),
        ("jacobi x3 d=2", dict(num_iter=3, only_occlusion=True, dilation=2)),
        ("full d=1", dict(num_iter=1)),
    ]


@dataclasses.dataclass
class WmfWork:
    listed: list              # pixels listed, an iteration
    share: float              # their share of pixels x iterations
    ops: float                # the bound's operations
    ops_all_supports: float   # ... with every support of a listed pixel
    ops_every_pixel: float    # ... at every pixel, every support
    tx: torch.Tensor          # the plain version, one iteration at a time
    ty: torch.Tensor


def wmf_work(tx, ty, img, rcfg, kw) -> WmfWork:
    """The work of kernel C's call ``kw`` on these inputs, iteration by
    iteration (the plain version, one iteration at a time): the pixels
    that can change (the holes under ``only_occlusion``, all otherwise);
    for each, WMF_SUPPORT_OPS per in-image valid support (the weight) and
    WMF_PAIR_OPS per (valid candidate, support of nonzero weight)."""
    from eppm_tpu_torch.ops import cuda_wmf
    from eppm_tpu_torch.ops._util import exp_cephes, ftz, inv32, pad_edge
    from eppm_tpu_torch.ops.refine import _wmf_tables

    dilation = kw.get("dilation", 1)
    offs, gws = _wmf_tables(rcfg, dilation)
    polish = kw.get("polish_init") is not None
    only = polish or kw.get("only_occlusion", False)
    h, w = tx.shape
    r = max(max(abs(dy), abs(dx)) for dy, dx in offs)
    pimg = pad_edge(img, r, r)
    inside = window_count(torch.ones_like(tx, dtype=torch.bool), offs)
    valid0 = (tx >= 0) & (ty >= 0)
    itx, ity = tx, ty
    listed, ops, ops_all, ops_every = [], 0.0, 0.0, 0.0
    for _ in range(kw.get("num_iter", 1)):
        valid = valid0 if polish else (itx >= 0) & (ity >= 0)
        mask = ~valid if only else torch.ones_like(valid)
        pv = torch.nn.functional.pad(valid.to(torch.float32),
                                     (r, r, r, r))
        nonzero = torch.zeros((h, w), dtype=torch.int64, device=tx.device)
        for (dy, dx), g in zip(offs, gws):
            d = (pimg[r + dy : r + dy + h, r + dx : r + dx + w] - img).abs()
            dr = d.amax(-1)
            wgt = ftz(pv[r + dy : r + dy + h, r + dx : r + dx + w] * float(g)
                      * exp_cephes(-(dr * dr) * inv32(rcfg.wmf_sigma_range**2)))
            nonzero += (wgt > 0).to(torch.int64)
        # the valid in-image supports are the candidates
        cands = window_count(valid, offs)
        listed.append(int(mask.sum()))
        ops += float(((cands * WMF_SUPPORT_OPS
                       + cands * nonzero * WMF_PAIR_OPS) * mask).sum())
        ops_all += float(((inside * WMF_SUPPORT_OPS
                           + cands * len(offs) * WMF_PAIR_OPS) * mask).sum())
        ops_every += float((inside * WMF_SUPPORT_OPS
                            + cands * len(offs) * WMF_PAIR_OPS).sum())
        if not polish:
            itx, ity = cuda_wmf.weighted_median_filter(
                itx, ity, img, rcfg, num_iter=1, only_occlusion=only,
                dilation=dilation)
    if polish:
        itx, ity = cuda_wmf.weighted_median_filter(tx, ty, img, rcfg, **kw)
    return WmfWork(listed, sum(listed) / (len(listed) * h * w), ops, ops_all,
                   ops_every, itx, ity)


def phase_kernels(dev) -> dict:
    """Each kernel against its plain version at main-path shapes."""
    log("== phase 3: kernels against their plain versions")
    from eppm_tpu_torch.config import DEFAULT_CONFIG as cfg
    from eppm_tpu_torch.ops import cuda_cost, cuda_match, cuda_smooth
    from eppm_tpu_torch.ops import cuda_wmf
    from eppm_tpu_torch.ops._util import grid
    from eppm_tpu_torch.ops.dense import center_out_offsets, warp_pack
    from eppm_tpu_torch.ops.match import _make_mini_cost, patch_descriptors

    rows = {}

    def record(name, err, ms, plain_ms, bound_ms, bound_by,
               library_ms=None):
        """Keep the largest error and the last shape's times."""
        row = rows.setdefault(name, {"max_abs_err": 0.0})
        row["max_abs_err"] = max(row["max_abs_err"], err)
        row.update(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                   bound_by=bound_by, library_ms=library_ms)

    def kernel_a(name, label, counter, call, plain, p1, frames, cands,
                 ccfg, tables, reps):
        """Kernel A at one shape: the wrapper identical to its plain
        version and its terms pass identical to ``cost_terms``; the times
        of the wrapper, of each pass alone and of the plain versions; the
        bounds of the whole cost and of the terms pass.  Returns the
        terms pass's (max |diff|, ms, plain ms, bound ms, bound by)."""
        got = call()
        ref = plain()
        err = float((got - ref).abs().max())
        differ = float((got != ref).float().mean())
        pms = cuda_ms(plain, max(1, reps // 5), warm=False)
        taps = list(ccfg.tap_offsets)
        reach = max(max(abs(a), abs(b)) for a, b in taps)
        plan = cuda_cost.cost_plan(cands, taps, tables)

        def terms_pass():
            return cuda_cost.cost_terms_cuda(p1, frames, cands, ccfg, tables)

        terms = terms_pass()
        tref = cuda_cost.cost_terms(p1, frames, plan.maps, reach, ccfg)
        terr = float((terms - tref).abs().max())
        tdiffer = float((terms != tref).float().mean())
        tpms = cuda_ms(lambda: cuda_cost.cost_terms(
            p1, frames, plan.maps, reach, ccfg), 1, warm=False)
        del tref
        ms = cuda_ms(call, reps)
        tms = cuda_ms(terms_pass, reps)
        sums_ms = cuda_ms(lambda: cuda_cost.cost_sums_cuda(
            counter, p1, frames, terms, cands, ccfg, tables), reps)
        h, w = p1.shape[0], p1.shape[1]
        hp, wp = h + 2 * reach, w + 2 * reach
        n_maps = len(plan.maps)
        # packs and frames read as float4, a float32 cost per candidate;
        # the terms pass writes a float32 map per shift
        n_frames = 1 if frames.dim() == 3 else frames.shape[0]
        frame_bytes = h * w * 16 * (1 + n_frames)
        sums = len(cands) * h * w * len(taps) * len(tables)
        bms, by = kernel_a_bound(h, w, cands, taps, tables, n_frames)
        one_pass_ms = bound_ms(sums * COST_TAP_OPS, 0)[0]
        tbms, tby = bound_ms(n_maps * hp * wp * COST_TERM_OPS,
                             frame_bytes + n_maps * hp * wp * 4)
        log(f"{label}: max|diff| {err:.3g} ({differ:.2%} differ)  kernel "
            f"{ms:.3f} ms (terms pass {tms:.3f} ms over {n_maps} maps + sums "
            f"{sums_ms:.3f} ms = {tms + sums_ms:.3f} ms)  plain {pms:.3f} ms"
            f"  bound {bms:.3f} ms ({by}; {one_pass_ms:.3f} ms at the "
            f"one-pass count of {COST_TAP_OPS} a tap); terms max|diff| "
            f"{terr:.3g} "
            f"({tdiffer:.2%} differ), plain {tpms:.3f} ms, bound "
            f"{tbms:.3f} ms ({tby})")
        check(err == 0 and differ == 0,
              f"kernel A {label}: max|diff| {err}, {differ:.2%} differ")
        check(terr == 0 and tdiffer == 0, f"kernel A's terms pass {label}: "
              f"max|diff| {terr}, {tdiffer:.2%} differ")
        record(name, err, ms, pms, bms, by)
        return terr, tms, tpms, tbms, tby

    def record_terms_error(terr):
        row = rows.setdefault("cost_terms", {"max_abs_err": 0.0})
        row["max_abs_err"] = max(row["max_abs_err"], terr)

    mini = _make_mini_cost(cfg.cost, cfg.match)
    # (h, w, candidates, cost config, plane mode) of the main paths: the
    # plane mode takes 4 frame-2 tap tables of 49 (pass 1) or 25 taps
    cases = [
        (60, 80, center_out_offsets(3), mini, False),
        (120, 160, center_out_offsets(3), cfg.cost, False),
        (480, 640, center_out_offsets(1), cfg.cost, False),
        (480, 640, center_out_offsets(1), cfg.pass2_cost, False),
        (1080, 1920, center_out_offsets(1), cfg.pass2_cost, False),
        (1080, 1920, center_out_offsets(1), cfg.cost, False),
        (480, 640, center_out_offsets(1), cfg.cost, True),
        (480, 640, center_out_offsets(1), cfg.pass2_cost, True),
        (1080, 1920, center_out_offsets(1), cfg.pass2_cost, True),
        (1080, 1920, center_out_offsets(1), cfg.cost, True),
    ]
    for h, w, offsets, ccfg, planes in cases:
        (_, p1), (_, p2) = _packs(h, w, 3, -2, SEED, dev)
        g = torch.full((h, w), 2, dtype=torch.int32, device=dev)
        warped = warp_pack(p2, g + 1, -g)
        kernel = (cuda_cost.residual_costs_planes_cuda if planes
                  else cuda_cost.residual_costs_cuda)
        label = (f"{'planes' if planes else 'cost  '} {h}x{w} "
                 f"K={len(offsets)} taps={len(ccfg.tap_offsets)}"
                 f"{' x 4 tables' if planes else ''}")
        terms_row = kernel_a(
            "residual_costs_planes" if planes else "residual_costs", label,
            cuda_cost.PLANES if planes else cuda_cost.SINGLE,
            lambda: kernel(p1, warped, offsets, ccfg),
            lambda: cuda_cost.residual_costs(p1, warped, offsets, ccfg,
                                             planes),
            p1, warped, [(cy, cx, 0) for cy, cx in offsets], ccfg,
            cuda_cost.cost_tables(ccfg, planes),
            20 if h * w < 300_000 else 5)
        # the terms pass's row keeps the fronto shapes' times, the last
        # of which is the default path's largest (1080p, 49 taps)
        if planes:
            record_terms_error(terms_row[0])
        else:
            record("cost_terms", *terms_row)

    # cost_tap_chunk=49: the pass-1 grid's 49 taps in one partial sum
    # (the default sums them in chunks of 25); the row keeps the default
    # chunk's times, this case adds its error
    h, w, chunk = 1080, 1920, 49
    (_, p1), (_, p2) = _packs(h, w, 3, -2, SEED, dev)
    g = torch.full((h, w), 2, dtype=torch.int32, device=dev)
    warped = warp_pack(p2, g + 1, -g)
    offsets = center_out_offsets(1)
    got = cuda_cost.residual_costs_cuda(p1, warped, offsets, cfg.cost, chunk)
    ref = cuda_cost.residual_costs(p1, warped, offsets, cfg.cost, False,
                                   chunk)
    moved = float((got != cuda_cost.residual_costs_cuda(
        p1, warped, offsets, cfg.cost)).float().mean())
    err = float((got - ref).abs().max())
    differ = float((got != ref).float().mean())
    ms = cuda_ms(lambda: cuda_cost.residual_costs_cuda(
        p1, warped, offsets, cfg.cost, chunk), 5)
    log(f"cost   {h}x{w} K={len(offsets)} taps=49 chunk={chunk}: max|diff| "
        f"{err:.3g} ({differ:.2%} differ)  kernel {ms:.3f} ms; {moved:.2%} of "
        f"the costs differ from the default chunk of 25's")
    check(err == 0 and differ == 0, f"kernel A at chunk {chunk}: max|diff| "
          f"{err}, {differ:.2%} differ")
    rows["residual_costs"]["max_abs_err"] = max(
        rows["residual_costs"]["max_abs_err"], err)
    del p1, p2, warped, got, ref

    # every form of XLA's sums that the sites of the pipeline take
    # (ops/cost.py::bilateral_cost): rescore's one candidate, and at chunk
    # 49 the windows of 32 taps with one chunk and with more, padded, in
    # each mode; identical, untimed
    forms = [  # (h, w, candidates, cost config, mode, chunk)
        (120, 160, [(0, 0)], cfg.cost, "fronto", 25),
        (120, 160, [(0, 0)], cfg.cost, "fronto", 49),
        (60, 80, center_out_offsets(3), mini, "fronto", 49),
        (480, 640, center_out_offsets(1), cfg.pass2_cost, "fronto", 49),
        (480, 640, center_out_offsets(1), cfg.cost, "planes", 49),
        (480, 640, center_out_offsets(1), cfg.pass2_cost, "planes", 49),
        (120, 160, None, cfg.cost, "multiwarp", 49),
    ]
    for h, w, offsets, ccfg, mode, chunk in forms:
        (_, p1), (_, p2) = _packs(h, w, 3, -2, SEED + 2, dev)
        g = torch.full((h, w), 2, dtype=torch.int32, device=dev)
        if mode == "multiwarp":
            stack = torch.stack([warp_pack(p2, g + s, -g + s)
                                 for s in range(-2, 3)]).contiguous()
            got = cuda_cost.residual_costs_multiwarp_cuda(p1, stack, ccfg,
                                                          chunk)
            ref = cuda_cost.residual_costs_multiwarp(p1, stack, ccfg, chunk)
            name, k = "residual_costs_multiwarp", 5
        else:
            warped = warp_pack(p2, g + 1, -g)
            kernel = (cuda_cost.residual_costs_planes_cuda
                      if mode == "planes" else cuda_cost.residual_costs_cuda)
            got = kernel(p1, warped, offsets, ccfg, chunk)
            ref = cuda_cost.residual_costs(p1, warped, offsets, ccfg,
                                           mode == "planes", chunk)
            name = ("residual_costs_planes" if mode == "planes"
                    else "residual_costs")
            k = len(offsets)
        err = float((got - ref).abs().max())
        differ = float((got != ref).float().mean())
        log(f"{mode} {h}x{w} K={k} taps={len(ccfg.tap_offsets)} chunk="
            f"{chunk}: max|diff| {err:.3g} ({differ:.2%} differ)")
        check(err == 0 and differ == 0, f"kernel A {mode} {h}x{w} K={k} "
              f"chunk {chunk}: max|diff| {err}, {differ:.2%} differ")
        row = rows.setdefault(name, {"max_abs_err": 0.0})
        row["max_abs_err"] = max(row["max_abs_err"], err)

    # the tiny level of a 640x480 match (30x40 descriptors), and the coarse
    # levels of 1080p (auto depth) and of 4K at depth 3 with the global
    # proposals on the stride-2 grid: 68x120 and 270x480 descriptors
    block = cfg.match.global_block
    geo = cuda_match.geometry(dev)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    log(f"argmax kernel: tile {'x'.join(map(str, geo.tile))}, "
        f"{geo.blocks_per_sm} blocks per SM of {sms}, {geo.registers} "
        f"registers and {geo.local_bytes} B of local memory (spills) a thread")
    for h, w, stride in [(30, 40, 1), (135, 240, 2), (540, 960, 2)]:
        (_, p1), (_, p2) = _packs(h, w, 3, -2, SEED + 4, dev)
        d1, d2 = (patch_descriptors(p, cfg.match, stride=stride)
                  for p in (p1, p2))
        d = d1.shape[-1]
        a, b = d1.reshape(-1, d).contiguous(), d2.reshape(-1, d).contiguous()
        n1, n2 = a.shape[0], b.shape[0]
        k = cuda_match.global_argmax_cuda(a, b)
        ref = cuda_match.global_argmax(a, b, block)
        err = float((k - ref).abs().max())
        big = n1 > 50_000
        ms = cuda_ms(lambda: cuda_match.global_argmax_cuda(a, b),
                     3 if big else 20)
        pms = cuda_ms(lambda: cuda_match.global_argmax(a, b, block),
                      1 if big else 3, warm=False)
        # the yardstick: the plain sweep's float64 products alone, the
        # same frame-2 blocks into one preallocated panel, no argmax
        a64, b64 = a.double(), b.double()
        panel = torch.empty(n1 * min(block, n2), dtype=torch.float64,
                            device=dev)

        def products():
            for j0 in range(0, n2, block):
                nb = min(block, n2 - j0)
                torch.mm(a64, b64[j0 : j0 + nb].T,
                         out=panel[: n1 * nb].view(n1, nb))

        lms = cuda_ms(products, 1 if big else 10)
        del a64, b64, panel
        bms, by = bound_ms(2.0 * n1 * n2 * d, (n1 + n2) * d * 2 + n1 * 4,
                           dict(PEAKS, f32_flops=F64_TENSOR_FLOPS))
        plan = cuda_match.plan_global_argmax(n1, n2, sms,
                                             blocks_per_sm=geo.blocks_per_sm)
        tflops = 2.0 * n1 * n2 * d / (ms * 1e-3) / 1e12
        log(f"argmax {d1.shape[0]}x{d1.shape[1]} descriptors "
            f"(N1=N2={n1}, D={d}, {plan.splits} splits): "
            f"{'identical' if err == 0 else 'DIFFER'} indices  kernel "
            f"{ms:.3f} ms ({tflops:.2f} float64 TFLOP/s, {bms / ms:.1%} of "
            f"the bound)  plain {pms:.3f} ms  float64 products alone "
            f"{lms:.3f} ms  bound {bms:.3f} ms ({by})")
        check(err == 0, f"kernel D indices differ (max |diff| {err})")
        record("global_argmax", err, ms, pms, bms, by, lms)

    for h, w in [(120, 160), (135, 240)]:
        (_, p1), (_, p2) = _packs(h, w, 3, -2, SEED + 1, dev)
        ys, xs = grid(h, w, dev)
        gys = torch.stack([torch.full((h, w), s, dtype=torch.int32,
                                      device=dev) for s in (-3, -2, -1, 0, 1)])
        gxs = torch.stack([torch.full((h, w), s, dtype=torch.int32,
                                      device=dev) for s in (1, 2, 3, 4, 5)])
        cy = (ys[None] + gys).clamp(0, h - 1)
        cx = (xs[None] + gxs).clamp(0, w - 1)
        stack = p2.reshape(h * w, 4)[(cy * w + cx).reshape(-1).long()]
        stack = stack.reshape(5, h, w, 4)
        terms_row = kernel_a(
            "residual_costs_multiwarp", f"cost multiwarp {h}x{w} K=5",
            cuda_cost.MULTIWARP,
            lambda: cuda_cost.residual_costs_multiwarp_cuda(p1, stack,
                                                            cfg.cost),
            lambda: cuda_cost.residual_costs_multiwarp(p1, stack, cfg.cost),
            p1, stack, [(0, 0, i) for i in range(5)], cfg.cost,
            cuda_cost.cost_tables(cfg.cost, False), 20)
        record_terms_error(terms_row[0])

    # kernel E at the coarse levels of 1280x960 and 640x480, the latter
    # last: the row keeps the times of its propagation round (K = 4), the
    # PatchMatch cell's most frequent launch
    for h, w, mode in [(240, 320, "fold"), (240, 320, "propagate"),
                       (120, 160, "cost"), (120, 160, "fold"),
                       (120, 160, "propagate")]:
        kernel_e(rows, dev, h, w, mode)

    # kernel F's occlusion arbitration at the coarse levels of 640x480,
    # 1080p and 4K; then each call of the exact stage at 1080p's and 4K's;
    # the row keeps the 8-ring's times, its largest call
    for h, w in [(120, 160), (135, 240)]:
        kernel_f_arbitrate(rows, dev, h, w)
    for call in ("score", "median", "propagate", "ring"):
        kernel_f(rows, dev, 135, 240, call)

    # kernel B: the paired kernel at the default radius 10, the one-pass
    # kernel at radius 6 (refine.blf_sigma_spatial=3.0); the counts say
    # which one each call launched
    smooth_kernels = {"flow_smoothing_paired": cuda_smooth.PAIRED,
                      "flow_smoothing": cuda_smooth.KERNEL}
    for h, w, r in SMOOTH_CASES:
        rcfg = dataclasses.replace(cfg.refine, blf_sigma_spatial=r / 2)
        flow, img = smooth_inputs(h, w, dev)
        before = {n: c.launches for n, c in smooth_kernels.items()}
        k = cuda_smooth.flow_smoothing_cuda(flow, img, rcfg)
        ran = [n for n, c in smooth_kernels.items()
               if c.launches > before[n]]
        check(len(ran) == 1, f"kernel B at r={r}: launched {ran}")
        ref = cuda_smooth.flow_smoothing(flow, img, rcfg)
        err = float((k - ref).abs().max())
        differ = float((k != ref).float().mean())
        ms = cuda_ms(lambda: cuda_smooth.flow_smoothing_cuda(
            flow, img, rcfg), 10)
        pms = cuda_ms(lambda: cuda_smooth.flow_smoothing(
            flow, img, rcfg), 2)
        known = (flow[..., 0] <= 1e9) & (flow[..., 1] <= 1e9)
        taps = float(window_count(known, [(dy, dx)
                                          for dy in range(-r, r + 1)
                                          for dx in range(-r, r + 1)]).sum())
        pairs = pair_count(known, r)
        # flow and output float2, the image 3 floats
        bms, by = bound_ms(pairs * SMOOTH_PAIR_OPS + taps * SMOOTH_TAP_OPS,
                           h * w * (8 + 12 + 8))
        one_pass_ms = bound_ms(taps * SMOOTH_ONE_PASS_OPS, 0)[0]
        log(f"smooth {h}x{w} r={r} ({ran[0]}): max|diff| {err:.3g} "
            f"({differ:.2%} differ)  kernel {ms:.3f} ms  plain {pms:.3f} ms"
            f"  bound {bms:.3f} ms ({by}; {pairs} pairs, {taps:.0f} known "
            f"taps; {one_pass_ms:.3f} ms at the one-pass count of "
            f"{SMOOTH_ONE_PASS_OPS} a tap)")
        check(err == 0 and differ == 0, f"kernel B r={r} {h}x{w}: max|diff| "
              f"{err}, {differ:.2%} differ")
        record(ran[0], err, ms, pms, bms, by)

    def kernel_c(h, w, tx, ty, img, label, kw):
        """Kernel C at one shape and mode: identical to its plain version;
        its device time, the call's events time, the plain version's time
        and the bound at the pixels it lists.  Returns max |diff|."""
        k = cuda_wmf.weighted_median_filter_cuda(tx, ty, img, cfg.refine,
                                                 **kw)
        ref = cuda_wmf.weighted_median_filter(tx, ty, img, cfg.refine, **kw)
        same = torch.equal(k[0], ref[0]) and torch.equal(k[1], ref[1])
        err = float(torch.maximum((k[0] - ref[0]).abs(),
                                  (k[1] - ref[1]).abs()).max())
        call_ms = cuda_ms(lambda: cuda_wmf.weighted_median_filter_cuda(
            tx, ty, img, cfg.refine, **kw), 10)
        ms, whole_ms, planes_ms = wmf_kernel_ms(
            lambda it: cuda_wmf.weighted_median_filter_cuda(
                tx, ty, img, cfg.refine,
                **(kw if it is None else dict(kw, num_iter=it))))
        pms = cuda_ms(lambda: cuda_wmf.weighted_median_filter(
            tx, ty, img, cfg.refine, **kw), 2)
        work = wmf_work(tx, ty, img, cfg.refine, kw)
        check(torch.equal(work.tx, ref[0]) and torch.equal(work.ty, ref[1]),
              "kernel C: the iterations one at a time differ")
        # three float planes in and out, the image 3 floats
        nbytes = h * w * (12 + 12 + 12)
        bms, by = bound_ms(work.ops, nbytes)
        all_ms = bound_ms(work.ops_all_supports, nbytes)[0]
        every_ms = bound_ms(work.ops_every_pixel, nbytes)[0]
        log(f"wmf {label} {h}x{w}: {'identical' if same else 'DIFFER'} "
            f"(max |diff| {err:.0f} px)  listed {work.share:.2%} of the "
            f"pixels ({', '.join(map(str, work.listed))} an iteration)  "
            f"kernel {ms:.4f} ms (device: the call {whole_ms:.4f} less its"
            f" planes {planes_ms:.4f}; the call by events {call_ms:.3f}"
            f" ms)  plain {pms:.3f} ms  bound {bms:.5f} ms "
            f"({by}, {bms / ms:.1%} of it reached; every support of the "
            f"listed pixels: {all_ms:.5f} ms; at every pixel: "
            f"{every_ms:.5f} ms)")
        check(same and err == 0, f"kernel C {label} {h}x{w}: max |diff| "
              f"{err}, targets {'equal' if same else 'differ'}")
        if label.startswith("polish"):
            record("weighted_median_filter", err, ms, pms, bms, by)
            # its ms is on another basis than the other rows': the
            # call's events time, host-bound, goes beside it
            rows["weighted_median_filter"].update(
                call_ms=call_ms, ms_basis="device time of the wrapper "
                "call less the same call at num_iter=0")
        else:
            row = rows["weighted_median_filter"]
            row["max_abs_err"] = max(row["max_abs_err"], err)

    # kernel C: the polish, Jacobi and full-image modes at the coarse
    # levels, then the full image at the fine levels (fine_level_wmf)
    for h, w in WMF_SHAPES:
        tx, ty, img, fill = wmf_inputs(h, w, dev)
        for label, kw in wmf_modes(fill):
            kernel_c(h, w, tx, ty, img, label, kw)
    for h, w in WMF_FINE_SHAPES:
        tx, ty, img, _ = wmf_inputs(h, w, dev)
        kernel_c(h, w, tx, ty, img, "full d=1, fine level", dict(num_iter=1))
    torch.cuda.synchronize()
    return rows


def kernel_e(rows: dict, dev, h: int, w: int, mode: str, cfg=None,
             planes: bool = False, k: int = 4) -> None:
    """Kernel E at one level (a synthetic pair shifted by (3, -2)) and
    mode against its plain composition on the card: identical (the
    costs, or the folded targets and costs), its time, the plain
    version's and the bound.  The incumbent is the shift give or take 2
    px; the fold's 6 candidates are drawn within 30 px of it, as the
    random search's first guesses, the cost-only mode takes ``k``.
    ``cfg`` (``DEFAULT_CONFIG`` by default) gives the taps and the tap
    chunk; ``planes`` takes its 4 plane tables for the one frame-2
    table (the plane-fitting refine's cost)."""
    from eppm_tpu_torch.config import DEFAULT_CONFIG
    from eppm_tpu_torch.ops import cuda_patchmatch as E
    from eppm_tpu_torch.ops import patchmatch as pm
    from eppm_tpu_torch.ops._util import grid
    from eppm_tpu_torch.ops.cost import plane_offsets

    cfg = cfg or DEFAULT_CONFIG
    chunk = cfg.cost_tap_chunk

    (_, p1), (_, p2) = _packs(h, w, 3, -2, SEED + 5, dev)
    gen = torch.Generator(dev).manual_seed(SEED + 5)
    ys, xs = grid(h, w, dev)

    def near(x, r, n, size):
        noise = torch.randint(-r, r + 1, (n, h, w), generator=gen,
                              device=dev, dtype=torch.int32)
        return (x + noise).clamp(0, size).to(torch.int32).contiguous()

    tx, ty = near(xs + 3, 2, 1, w)[0], near(ys - 2, 2, 1, h)[0]
    tables = (plane_offsets(cfg.cost) if planes
              else [cfg.cost.tap_offsets])
    cost = E.patch_cost_tables(p1, p2, tx, ty, cfg.cost, tables,
                               tap_chunk=chunk)
    if mode == "fold":
        k = len(cfg.patchmatch.search_mags())
    elif mode == "propagate":
        k = 4
    txs, tys = near(tx, 30, k, w), near(ty, 30, k, h)
    call, plain = {
        "cost": (lambda: (E.patch_cost_tables_cuda(
                     p1, p2, txs, tys, cfg.cost, tables, tap_chunk=chunk),),
                 lambda: (E.patch_cost_tables(p1, p2, txs, tys, cfg.cost,
                                              tables, tap_chunk=chunk),)),
        "fold": (lambda: E.select_candidates_cuda(
                     p1, p2, tx, ty, cost, txs, tys, cfg.cost, tables,
                     chunk),
                 lambda: pm.select_candidates(p1, p2, tx, ty, cost, txs,
                                              tys, cfg.cost, tables, chunk)),
        "propagate": (lambda: E.propagate_candidates_cuda(
                          p1, p2, tx, ty, cost, 4, cfg.cost, tables, chunk),
                      lambda: pm.propagate_candidates(
                          p1, p2, tx, ty, cost, 4, cfg.cost, tables, chunk)),
    }[mode]
    got, ref = call(), plain()
    same = all(torch.equal(a, b) for a, b in zip(got, ref))
    err = float((got[-1] - ref[-1]).abs().max())
    moved = (float((got[0] != tx).float().mean()) if mode != "cost"
             else 0.0)
    # the wrapper's host work (checks, tables, outputs) outlasts the
    # launch at these sizes: the kernel's time is device time
    ms = device_ms(call, 50)
    call_ms = cuda_ms(call, 50)
    pms = cuda_ms(plain, 5)
    taps = len(cfg.cost.tap_offsets)
    bms, by = kernel_e_bound(k, h, w, taps, len(tables), mode)
    log(f"patchmatch {mode} {h}x{w} K={k} taps={taps} "
        f"tables={len(tables)} chunk={chunk}: "
        f"{'identical' if same else 'DIFFER'} (max |diff| {err:.3g}; "
        f"{moved:.2%} of the targets replaced)  kernel {ms:.4f} ms (device; "
        f"the call by events {call_ms:.4f} ms)  plain {pms:.3f} ms  bound "
        f"{bms:.4f} ms ({by}, {bms / ms:.1%} of it reached)")
    check(same, f"kernel E {mode} {h}x{w} taps={taps} tables={len(tables)}: "
          "differs from its plain version")
    row = rows.setdefault("patchmatch_costs", {"max_abs_err": 0.0})
    row["max_abs_err"] = max(row["max_abs_err"], err)
    row.update(ms=ms, plain_ms=pms, bound_ms=bms, bound_by=by,
               library_ms=None, call_ms=call_ms,
               ms_basis="device time (a spin kernel holds the stream while "
               "the host enqueues)")


def kernel_f(rows: dict, dev, h: int, w: int, call: str) -> None:
    """Kernel F at one level (a synthetic pair shifted by (3, -2)) in one
    call of the exact stage against its plain version on the card
    (``match.exact_best_of``): identical, its device time and the call's
    events time, the plain version's time and two bounds, the float32
    operations over the float32 peak and the float64 conversions over
    the card's conversion rate.  The incumbent is the shift give or take
    1 px; ``call`` is the incumbent's score (K = 1, unmasked), the
    8-ring, a step-2 propagation round (K = 4) or the median round (K =
    1, accepted at equality), as ``_polish_direction`` makes them."""
    from eppm_tpu_torch.config import DEFAULT_CONFIG as cfg
    from eppm_tpu_torch.ops import cuda_exact as F
    from eppm_tpu_torch.ops._util import shift2d
    from eppm_tpu_torch.ops.dense import center_out_offsets, median3
    from eppm_tpu_torch.ops.match import exact_best_of

    (_, p1), (_, p2) = _packs(h, w, 3, -2, SEED + 6, dev)
    gen = torch.Generator(dev).manual_seed(SEED + 6)

    def near(v):
        return (v + torch.randint(-1, 2, (h, w), generator=gen, device=dev,
                                  dtype=torch.int32)).contiguous()

    gx = near(torch.full((h, w), 3, dtype=torch.int32, device=dev))
    gy = near(torch.full((h, w), -2, dtype=torch.int32, device=dev))
    ecfg = dataclasses.replace(cfg.cost,
                               patch_stride=cfg.match.exact_tap_stride)
    cur = exact_best_of(p1, p2, gx[None], gy[None], None, ecfg)
    strict = call != "median"
    if call == "score":
        cgx, cgy, cur = gx[None], gy[None], None
    elif call == "ring":
        ring = [c for c in center_out_offsets(cfg.match.exact_polish_radius)
                if c != (0, 0)]
        cgy = torch.stack([gy + m for m, _ in ring])
        cgx = torch.stack([gx + n for _, n in ring])
    elif call == "propagate":
        step = cfg.match.exact_prop_steps[0]
        shifts = ((0, -step), (0, step), (-step, 0), (step, 0))
        cgy = torch.stack([shift2d(gy, a, b) for a, b in shifts])
        cgx = torch.stack([shift2d(gx, a, b) for a, b in shifts])
    else:
        cgx, cgy = median3(gx)[None], median3(gy)[None]
    k = cgx.shape[0]

    def kernel():
        return F.exact_best_of_cuda(p1, p2, cgx, cgy, cur, ecfg, strict)

    def plain():
        return exact_best_of(p1, p2, cgx, cgy, cur, ecfg, strict)

    got, ref = kernel(), plain()
    same = all(torch.equal(a, b) for a, b in zip(got, ref))
    err = float((got[2] - ref[2]).abs().max())
    moved = 0.0 if cur is None else float((got[0] != cur[0]).float().mean())
    # the wrapper's host work outlasts the launch at this size: the
    # kernel's time is device time
    ms = device_ms(kernel, 50)
    call_ms = cuda_ms(kernel, 50)
    pms = cuda_ms(plain, 3)
    taps = k * h * w * len(ecfg.tap_offsets)
    # packs read as float4, the offsets and the incumbent in, the state out
    nbytes = h * w * (2 * 16 + k * 8 + (24 if cur is not None else 4))
    ops_ms, _ = bound_ms(taps * EXACT_TAP_OPS, nbytes)
    bms, by = bound_ms(taps * EXACT_TAP_CONVERSIONS, nbytes,
                       dict(PEAKS, f32_flops=CONVERSIONS_PER_S))
    by = "float64 conversions" if by == "operations" else by
    log(f"exact {call} {h}x{w} K={k} taps={len(ecfg.tap_offsets)}: "
        f"{'identical' if same else 'DIFFER'} (max |diff| {err:.3g}; "
        f"{moved:.2%} of the offsets replaced)  kernel {ms:.4f} ms (device;"
        f" the call by events {call_ms:.4f} ms)  plain {pms:.3f} ms  bound "
        f"{bms:.4f} ms ({by}, {bms / ms:.1%} of it reached; float32 "
        f"operations {ops_ms:.4f} ms, {ops_ms / ms:.1%})")
    check(same, f"kernel F {call} {h}x{w}: differs from its plain version")
    row = rows.setdefault("exact_best_of", {"max_abs_err": 0.0})
    row["max_abs_err"] = max(row["max_abs_err"], err)
    row.update(ms=ms, plain_ms=pms, bound_ms=bms, bound_by=by,
               library_ms=None, call_ms=call_ms, ops_bound_ms=ops_ms,
               ms_basis="device time (a spin kernel holds the stream while "
               "the host enqueues)")


def kernel_f_arbitrate(rows: dict, dev, h: int, w: int) -> None:
    """Kernel F's occlusion arbitration at one level (a synthetic pair
    shifted by (3, -2)) against its plain version on the card
    (``occlusion.arbitrate_holes``): the candidates as the fill-first
    chain makes them (``fill_holes``' 4 directions and the pre-LR match,
    K = 5, at the default 49 taps and threshold) over a fifth of the
    pixels made holes and a block; identical, its device time and the
    call's events time, the plain version's time and the two bounds of
    ``kernel_f``.  The times go to the exact row's ``arbitrate`` entry,
    keyed by the shape."""
    from eppm_tpu_torch.config import DEFAULT_CONFIG as cfg
    from eppm_tpu_torch.config import INVALID_LOCATION
    from eppm_tpu_torch.ops import cuda_exact as F
    from eppm_tpu_torch.ops._util import grid
    from eppm_tpu_torch.ops.occlusion import (arbitrate_holes,
                                              arbitration_candidates)
    from eppm_tpu_torch.ops.refine import fill_holes

    (img, p1), (_, p2) = _packs(h, w, 3, -2, SEED + 8, dev)
    gen = torch.Generator(dev).manual_seed(SEED + 8)
    ys, xs = grid(h, w, dev)
    otx = (xs + 3 + torch.randint(-1, 2, (h, w), generator=gen, device=dev,
                                  dtype=torch.int32)).contiguous()
    oty = (ys - 2 + torch.randint(-1, 2, (h, w), generator=gen, device=dev,
                                  dtype=torch.int32)).contiguous()
    holes = torch.rand((h, w), generator=gen, device=dev) < 0.2
    holes[h // 3 : h // 2, w // 4 : w // 2] = True
    tx = torch.where(holes, INVALID_LOCATION, otx)
    ty = torch.where(holes, INVALID_LOCATION, oty)
    ftx, fty, cands = fill_holes(tx, ty, img, return_candidates=True)
    cgxs, cgys, masks = arbitration_candidates(tx, cands, (otx, oty))
    thresh = cfg.refine.fill_photometric_thresh
    args = (p1, p2, cgxs, cgys, masks, (tx, ty), (ftx, fty), cfg.cost,
            thresh)

    def kernel():
        return F.arbitrate_holes_cuda(*args)

    def plain():
        return arbitrate_holes(*args)

    got, ref = kernel(), plain()
    same = all(torch.equal(a, b) for a, b in zip(got, ref))
    took = float(((got[0] != ftx) | (got[1] != fty)).float().mean())
    share = float(holes.float().mean())
    ms = device_ms(kernel, 50)
    call_ms = cuda_ms(kernel, 50)
    pms = cuda_ms(plain, 3)
    k = cgxs.shape[0]
    taps = k * h * w * len(cfg.cost.tap_offsets)
    # packs read as float4; offsets, flags, targets and fill in; targets out
    nbytes = h * w * (2 * 16 + k * 9 + 24)
    ops_ms, _ = bound_ms(taps * EXACT_TAP_OPS, nbytes)
    bms, by = bound_ms(taps * EXACT_TAP_CONVERSIONS, nbytes,
                       dict(PEAKS, f32_flops=CONVERSIONS_PER_S))
    by = "float64 conversions" if by == "operations" else by
    log(f"exact arbitrate {h}x{w} K={k} taps={len(cfg.cost.tap_offsets)}: "
        f"{'identical' if same else 'DIFFER'} ({share:.2%} holes, "
        f"{took:.2%} of the targets arbitrated off the fill)  kernel "
        f"{ms:.4f} ms (device; the call by events {call_ms:.4f} ms)  plain "
        f"{pms:.3f} ms  bound {bms:.4f} ms ({by}, {bms / ms:.1%} of it "
        f"reached; float32 operations {ops_ms:.4f} ms, {ops_ms / ms:.1%})")
    check(same, f"kernel F arbitrate {h}x{w}: differs from its plain version")
    row = rows.setdefault("exact_best_of", {"max_abs_err": 0.0})
    row.setdefault("arbitrate", {})[f"{h}x{w}"] = dict(
        ms=ms, call_ms=call_ms, plain_ms=pms, bound_ms=bms, bound_by=by,
        ops_bound_ms=ops_ms)


def interior(h: int, w: int, dx: int, dy: int, margin: int) -> np.ndarray:
    """Pixels whose target under the shift (dx, dy) lies in the frame,
    ``margin`` px away from every border."""
    ys, xs = np.mgrid[0:h, 0:w]
    return ((xs + dx >= margin) & (xs + dx < w - margin)
            & (ys + dy >= margin) & (ys + dy < h - margin)
            & (xs >= margin) & (xs < w - margin)
            & (ys >= margin) & (ys < h - margin))


def interior_epe(flow: np.ndarray, dx: int, dy: int, margin: int) -> float:
    """Mean endpoint error against the known shift over the interior."""
    inside = interior(flow.shape[0], flow.shape[1], dx, dy, margin)
    err = np.hypot(flow[..., 0] - dx, flow[..., 1] - dy)
    return float(err[inside].mean())


def counters() -> dict:
    """Each kernel's launch counter, by the name of its row."""
    from eppm_tpu_torch.ops import cuda_cost, cuda_exact, cuda_match
    from eppm_tpu_torch.ops import cuda_patchmatch, cuda_smooth, cuda_wmf

    return {
        "cost_terms": cuda_cost.TERMS,
        "residual_costs": cuda_cost.SINGLE,
        "residual_costs_multiwarp": cuda_cost.MULTIWARP,
        "flow_smoothing": cuda_smooth.KERNEL,
        "flow_smoothing_paired": cuda_smooth.PAIRED,
        "weighted_median_filter": cuda_wmf.KERNEL,
        "residual_costs_planes": cuda_cost.PLANES,
        "global_argmax": cuda_match.KERNEL,
        "patchmatch_costs": cuda_patchmatch.KERNEL,
        "exact_best_of": cuda_exact.KERNEL,
    }


def drive(path: str, kernels, run) -> dict:
    """Run one path with every launch count set to 0 just before it and
    read just after; fail unless each of its ``kernels`` was launched."""
    cs = counters()
    for c in cs.values():
        c.launches = 0
    run()
    torch.cuda.synchronize()
    launches = {name: c.launches for name, c in cs.items()}
    log(f"launches on the {path} path: {launches}")
    for name in kernels:
        check(launches[name] > 0,
              f"kernel {name} was not launched on the {path} path")
    return launches


def flow_case(model, dev, h, w, dx, dy, seed, expect=None,
              pair=None) -> float:
    """One synthetic pair through ``model`` (a warm-up run, then a timed
    one), gated on the warp error and on ``expect``, launches per pair of
    some kernels by their rows' names.  ``pair``: the frames, else a
    ``shifted_pair``.  Returns the interior EPE."""
    from eppm_tpu_torch.metrics import warp_error

    f1, f2 = pair if pair is not None else shifted_pair(h, w, dx, dy, seed)
    img1 = torch.from_numpy(f1).to(dev)
    img2 = torch.from_numpy(f2).to(dev)
    model(img1, img2)  # first run: allocator and library warm-up
    torch.cuda.synchronize()
    before = {name: c.launches for name, c in counters().items()}
    t0 = time.perf_counter()
    flow = model(img1, img2)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    per_pair = {name: c.launches - before[name]
                for name, c in counters().items() if c.launches > before[name]}
    check(tuple(flow.shape) == (h, w, 2), f"flow shape {flow.shape}")
    flow = flow.cpu().numpy()
    check(bool(np.isfinite(flow).all()), "non-finite flow")
    a = f1.astype(np.float64) / 255.0
    b = f2.astype(np.float64) / 255.0
    we = warp_error(a, b, flow)
    we0 = warp_error(a, b, np.zeros_like(flow))
    epe = interior_epe(flow, dx, dy, 16)
    log(f"e2e {w}x{h} shift ({dx},{dy}) [synthetic]: {ms:.1f} ms  "
        f"warp error {we:.4f} vs zero-flow {we0:.4f} "
        f"(ratio {we / we0:.3f})  interior EPE {epe:.4f}  launches per pair "
        f"{per_pair}")
    check(we < 0.6 * we0, f"warp error {we:.4f} >= 0.6 x {we0:.4f}")
    for name, n in (expect or {}).items():
        check(per_pair.get(name, 0) == n, f"{name}: {per_pair.get(name, 0)} "
              f"launches per {w}x{h} pair, expected {n}")
    return epe


# the default path's hand kernels: a row label, the kernels' CUDA names it
# sums, and the launch counts (rows of ``counters``) that launch each of
# them once a launch
PROFILED = {
    "cost_terms_kernel": (("cost_terms_kernel",), ("cost_terms",)),
    "residual_cost_kernel": (("residual_cost_kernel",),
                             ("residual_costs", "residual_costs_multiwarp")),
    "flow_smooth_kernel": (("flow_smooth_kernel",), ("flow_smoothing",)),
    "flow_smooth_pair_kernel": (("flow_smooth_pair_kernel",),
                                ("flow_smoothing_paired",)),
    "kernel C (wmf_list_kernel + wmf_median_kernel)": (
        ("wmf_list_kernel", "wmf_median_kernel"), ("weighted_median_filter",)),
    "patchmatch_kernel": (("patchmatch_kernel",), ("patchmatch_costs",)),
    "exact_kernel": (("exact_kernel",), ("exact_best_of",)),
}


def profile_pair(model, dev, h, w, dx, dy, seed) -> None:
    """One more synthetic pair through ``model`` (after a warm-up run)
    under ``torch.profiler``, device activity only: each hand kernel's
    device time and launches beside the device time and count of all the
    pair's device work, and the wall under the profiler.  The profiler
    can drop events (a second profiling session in one process lost
    some on the H100), so the log says whether each kernel's events
    match its launch counts."""
    from torch.profiler import ProfilerActivity, profile

    f1, f2 = shifted_pair(h, w, dx, dy, seed)
    img1, img2 = (torch.from_numpy(f).to(dev) for f in (f1, f2))
    model(img1, img2)
    torch.cuda.synchronize()
    before = {name: c.launches for name, c in counters().items()}
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        model(img1, img2)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    launched = {name: c.launches - before[name]
                for name, c in counters().items()}
    total_us, count, per = 0.0, 0, {name: [0.0, 0] for name in PROFILED}
    for e in prof.key_averages():
        if e.self_device_time_total <= 0:
            continue
        total_us += e.self_device_time_total
        count += e.count
        for name, (kernels, _) in PROFILED.items():
            if any(k in e.key for k in kernels):
                per[name][0] += e.self_device_time_total
                per[name][1] += e.count
    complete = all(
        per[name][1] == len(kernels) * sum(launched[r] for r in rows)
        for name, (kernels, rows) in PROFILED.items())
    log(f"profile {w}x{h} shift ({dx},{dy}) [synthetic]: wall {wall:.1f} ms "
        f"under the profiler, {count} device events, device busy "
        f"{total_us / 1e3:.3f} ms; "
        + ", ".join(f"{name} {us / 1e3:.3f} ms ({n})"
                    for name, (us, n) in per.items())
        + ("; every hand kernel's events match its launches" if complete
           else "; INCOMPLETE: events and launches differ"))


def polish_holes(out: list, run) -> None:
    """Run ``run`` and append to ``out`` (h, w, share) for each polish
    call of kernel C in it: the share of the level's pixels that are
    holes, which are the pixels kernel C lists.  The shares are read
    after ``run``, so the run is not synchronised for them."""
    from eppm_tpu_torch.ops import occlusion

    real = occlusion.weighted_median_filter_auto
    shares = []

    def spy(tx, ty, *args, **kwargs):
        if kwargs.get("polish_init") is not None:
            shares.append((*tx.shape, ((tx < 0) | (ty < 0)).float().mean()))
        return real(tx, ty, *args, **kwargs)

    occlusion.weighted_median_filter_auto = spy
    try:
        run()
    finally:
        occlusion.weighted_median_filter_auto = real
    out.extend((h, w, float(share)) for h, w, share in shares)


PLANES_CFG = dict(dense_pass1_planes=True, dense_pass2_planes=True)


def match_coarse_depth3(dev, h=2160, w=3840, dx=-96, dy=64) -> None:
    """``match_coarse`` on the coarse level of a ``w``x``h`` pair at depth
    3 (a 3840x2160 pair by default): the known shift, a multiple of 4, is
    recovered in the interior."""
    from eppm_tpu_torch.config import DEFAULT_CONFIG as base
    from eppm_tpu_torch.ops.match import match_coarse
    from eppm_tpu_torch.pipeline import prepare_pyramids

    cfg = dataclasses.replace(base, pyramid=dataclasses.replace(
        base.pyramid, auto_depth_dim=0))
    f1, f2 = shifted_pair(h, w, dx, dy, SEED + 14)
    lv1, pk1 = prepare_pyramids(torch.from_numpy(f1).to(dev), cfg)
    lv2, pk2 = prepare_pyramids(torch.from_numpy(f2).to(dev), cfg)
    ch, cw = lv1[-1].shape[0], lv1[-1].shape[1]
    check((ch, cw) == (h // 4, w // 4), f"coarse level {ch}x{cw}")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tx, ty, cost = match_coarse(lv1[-1], lv2[-1], cfg.cost, cfg.match,
                                pk1[-1], pk2[-1])
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    check(tuple(tx.shape) == (ch, cw) and tuple(ty.shape) == (ch, cw),
          f"target shape {tuple(tx.shape)}")
    check(bool(torch.isfinite(cost).all()), "non-finite match cost")
    flow = torch.stack([tx, ty], -1).cpu().numpy().astype(np.float32)
    ys, xs = np.mgrid[0:ch, 0:cw]
    flow -= np.stack([xs, ys], -1)
    sx, sy = dx // 4, dy // 4
    epe = interior_epe(flow, sx, sy, 16)
    hit = float((flow == (sx, sy)).all(-1)[interior(ch, cw, sx, sy, 16)]
                .mean())
    log(f"match_coarse {w}x{h} depth 3: coarse {cw}x{ch}, shift ({sx},{sy}): "
        f"{ms:.1f} ms  {hit:.2%} of interior targets exact, "
        f"interior EPE {epe:.4f}")
    check(hit >= 0.9, f"match_coarse recovered the shift on only {hit:.2%}")


def sequence(h: int, w: int, dx: int, dy: int, n: int, seed: int):
    """``n`` uint8 frames of a constant motion: frame k(p) = frame k+1(p +
    (dx, dy)), cut from one seeded texture."""
    c = n // 2
    m = (c + 1) * max(abs(dx), abs(dy)) + 8
    big = (texture(h + 2 * m, w + 2 * m, seed) * 255).astype(np.uint8)
    return [np.ascontiguousarray(big[m + (c - k) * dy : m + (c - k) * dy + h,
                                     m + (c - k) * dx : m + (c - k) * dx + w])
            for k in range(n)]


def half_pixel_pair(h: int, w: int, sx2: int, sy2: int, seed: int):
    """uint8 (frame1, frame2) with a shift of (sx2 / 2, sy2 / 2): a texture
    at twice the resolution shifted by (sx2, sy2) px, then averaged 2x2."""
    m = max(abs(sx2), abs(sy2)) + 16
    big = texture(2 * h + 2 * m, 2 * w + 2 * m, seed)

    def pool(a):
        return (a.reshape(h, 2, w, 2, 3).mean(axis=(1, 3)) * 255).round() \
            .astype(np.uint8)

    f2 = pool(big[m : m + 2 * h, m : m + 2 * w])
    f1 = pool(big[m + sy2 : m + sy2 + 2 * h, m + sx2 : m + sx2 + 2 * w])
    return f1, f2


def global_stage_calls(out: list, run) -> None:
    """Run ``run`` and append to ``out`` each call of the bidirectional
    global descriptor match in it (the stage a warm start skips)."""
    from eppm_tpu_torch.ops import match

    real = match.global_match_bidi

    def spy(*args, **kwargs):
        out.append(args[0].shape[:2])
        return real(*args, **kwargs)

    match.global_match_bidi = spy
    try:
        run()
    finally:
        match.global_match_bidi = real


def temporal_case(dev, h, w, dx, dy, seed, n=5) -> None:
    """A constant-motion sequence of ``n`` frames through ``EPPMFlow``,
    cold pair after pair, then warm-started: pair 1 cold, each later pair
    from the previous pair's flow (``compute_flow(init_flow=...)``).  Logs
    ms, interior EPE and launches per pair; gates each pair's warp error,
    and each warm pair on interior EPE < 1 with no global stage run."""
    from eppm_tpu_torch.metrics import warp_error
    from eppm_tpu_torch.pipeline import EPPMFlow

    frames = sequence(h, w, dx, dy, n, seed)
    imgs = [torch.from_numpy(f).to(dev) for f in frames]
    model = EPPMFlow()
    model(imgs[0], imgs[1])  # allocator and library warm-up
    torch.cuda.synchronize()
    for mode in ("cold", "warm"):
        prev, rows = None, []
        for k in range(n - 1):
            calls = []
            before = {name: c.launches for name, c in counters().items()}
            t0 = time.perf_counter()
            model.set_data(imgs[k], imgs[k + 1])
            global_stage_calls(calls, lambda: rows.append(
                model.compute_flow(init_flow=prev)))
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            launches = {name: c.launches - before[name]
                        for name, c in counters().items()
                        if c.launches > before[name]}
            flow = rows[-1]
            if mode == "warm":
                prev = flow
            f = flow.cpu().numpy()
            check(bool(np.isfinite(f).all()), "non-finite flow")
            a = frames[k].astype(np.float64) / 255.0
            b = frames[k + 1].astype(np.float64) / 255.0
            we, we0 = warp_error(a, b, f), warp_error(a, b, np.zeros_like(f))
            epe = interior_epe(f, dx, dy, 16)
            warm = mode == "warm" and k > 0
            log(f"temporal {w}x{h} shift ({dx},{dy}) [synthetic] {mode} "
                f"pair {k + 1}{' (warm-started)' if warm else ''}: {ms:.1f} "
                f"ms  warp error ratio {we / we0:.3f}  interior EPE "
                f"{epe:.4f}  global stage calls {len(calls)}  launches "
                f"{launches}")
            check(we < 0.6 * we0, f"warp error {we:.4f} >= 0.6 x {we0:.4f}")
            if warm:
                check(epe < 1.0, f"warm pair {k + 1}: interior EPE {epe}")
                check(not calls, f"warm pair {k + 1} ran the global stage")


def stream_case(dev, h=480, w=640, dx=3, dy=-2, seed=SEED + 30,
                n=5, temporal=True) -> None:
    """``python -m eppm_tpu_torch.cli --frames-dir D --out-dir O``, with
    ``--temporal`` where ``temporal``, in process, on ``n`` PPM frames of
    a constant motion in a temporary directory: one .flo per pair, named
    by its first frame, each with the motion (interior EPE < 1); the fps
    line logged."""
    import contextlib
    import io as _io
    import os
    import tempfile

    from eppm_tpu_torch import cli
    from eppm_tpu_torch.io import read_flo, write_ppm

    with tempfile.TemporaryDirectory() as tmp:
        frames = os.path.join(tmp, "frames")
        out = os.path.join(tmp, "flow")
        os.mkdir(frames)
        for k, f in enumerate(sequence(h, w, dx, dy, n, seed)):
            write_ppm(os.path.join(frames, f"frame{k:03d}.ppm"), f)
        buf = _io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = cli.main(["--frames-dir", frames, "--out-dir", out]
                          + ["--temporal"] * temporal)
        report = json.loads(buf.getvalue().strip().splitlines()[-1])
        names = sorted(os.listdir(out))
        epes = [interior_epe(read_flo(os.path.join(out, name)), dx, dy, 16)
                for name in names]
    log(f"stream CLI {w}x{h} shift ({dx},{dy}) [synthetic], {n} frames, "
        f"{'--temporal' if temporal else 'cold'}: {report}; .flo {names}; "
        "interior EPE "
        + ", ".join(f"{e:.4f}" for e in epes))
    check(rc == 0 and report["pairs"] == n - 1, f"stream report {report}")
    check(names == [f"frame{k:03d}.flo" for k in range(n - 1)],
          f"stream outputs {names}")
    check(all(e < 1.0 for e in epes), f"stream interior EPE {epes}")


PM_CFG = dict(match_engine="patchmatch")
# the dense matcher's kernels: the PatchMatch engine bypasses them (kernel
# F it launches once a pair, in the occlusion arbitration alone)
DENSE_MATCHER = ["residual_costs_multiwarp", "global_argmax"]


def pm_case(model, dev, h, w, dx, dy, seed) -> None:
    """One synthetic pair through the PatchMatch ``model`` on its default
    key: a warm-up run, a run timed by ``DeviceTimer`` that must
    be identical to it, ``check_flow`` (finite, at most 1% unknown, warp
    error < 0.6x the zero-flow one), the interior EPE and launches per
    pair; then the device events under ``torch.profiler`` of the pair
    (``profile_pair``) and, at 1080p, of the PatchMatch stage alone."""
    from eppm_tpu_torch.utils import DeviceTimer, check_flow

    f1, f2 = shifted_pair(h, w, dx, dy, seed)
    img1, img2 = (torch.from_numpy(f).to(dev) for f in (f1, f2))
    first = model(img1, img2)
    torch.cuda.synchronize()
    before = {name: c.launches for name, c in counters().items()}
    timer = DeviceTimer(dev).start()
    flow = model(img1, img2)
    ms = timer.stop() * 1e3
    per_pair = {name: c.launches - before[name]
                for name, c in counters().items() if c.launches > before[name]}
    check(tuple(flow.shape) == (h, w, 2), f"flow shape {flow.shape}")
    rep = check_flow(flow, img1, img2, max_unknown_frac=0.01,
                     max_warp_ratio=0.6)
    same = bool(torch.equal(first, flow))
    epe = interior_epe(flow.cpu().numpy(), dx, dy, 16)
    log(f"patchmatch {w}x{h} shift ({dx},{dy}) [synthetic]: {ms:.1f} ms "
        f"(DeviceTimer)  check_flow: {rep}  interior EPE {epe:.4f}  two "
        f"runs of the default key {'identical' if same else 'DIFFER'}"
        f"  launches per pair {per_pair}")
    check(same, "two runs of the default key differ")
    check(per_pair.get("flow_smoothing_paired", 0) == (3 if h == 480 else 4),
          f"smoothing launches per pair {per_pair}")
    pcfg = model.cfg.patchmatch
    check(per_pair.get("patchmatch_costs", 0) == 2 * (1 + pcfg.num_iters * (
        len(pcfg.prop_steps) + 1)), f"kernel E launches per pair {per_pair}")
    check(per_pair.get("exact_best_of", 0) == 1,
          f"kernel F launches per pair {per_pair}: the arbitration alone")
    profile_pair(model, dev, h, w, dx, dy, seed)
    if h == 1080:
        profile_pm_stage(model.cfg, dev, h, w, dx, dy, seed)


def profile_pm_stage(cfg, dev, h, w, dx, dy, seed) -> None:
    """The PatchMatch stage alone: both searches (forward, then backward)
    on the coarse level of a synthetic pair, after a warm-up, drawing
    from the default key's halves (JAX's threefry draws, ``ops/prng.py``)
    and then from one ``torch.Generator`` seeded with ``cfg.seed`` (the
    default before the key): each one's time by ``DeviceTimer``, then
    under ``torch.profiler`` its device events, device busy and the
    device kernels that take the most time.  The difference of the event
    counts is what the key's draws add."""
    from torch.profiler import ProfilerActivity, profile

    from eppm_tpu_torch.ops.patchmatch import ThreefrySampler, patchmatch
    from eppm_tpu_torch.ops.prng import prng_key, split
    from eppm_tpu_torch.pipeline import prepare_pyramids
    from eppm_tpu_torch.utils import DeviceTimer

    f1, f2 = shifted_pair(h, w, dx, dy, seed)
    p1, p2 = (prepare_pyramids(torch.from_numpy(f).to(dev), cfg)[1][-1]
              for f in (f1, f2))

    def key_samplers():
        return [ThreefrySampler(k) for k in split(prng_key(cfg.seed, dev))]

    def generator_samplers():
        return [torch.Generator(dev).manual_seed(cfg.seed)] * 2

    events = {}
    for name, samplers in (("the default key", key_samplers),
                           ("a torch.Generator", generator_samplers)):
        def run():
            fwd, bwd = samplers()
            patchmatch(p1, p2, fwd, cfg.patchmatch, cfg.cost)
            patchmatch(p2, p1, bwd, cfg.patchmatch, cfg.cost)

        run()
        timer = DeviceTimer(dev).start()
        run()
        ms = timer.stop() * 1e3
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            run()
            torch.cuda.synchronize()
        busy = [e for e in prof.key_averages()
                if e.self_device_time_total > 0]
        total_us = sum(e.self_device_time_total for e in busy)
        top = sorted(busy, key=lambda e: -e.self_device_time_total)[:4]
        events[name] = sum(e.count for e in busy)
        log(f"patchmatch stage {w}x{h} (coarse {p1.shape[1]}x{p1.shape[0]}, "
            f"both directions, drawing from {name}) [synthetic]: {ms:.1f} ms "
            f"(DeviceTimer), {events[name]} device events, device busy "
            f"{total_us / 1e3:.3f} ms; most device time: "
            + "; ".join(f"{e.key[:70]} {e.self_device_time_total / 1e3:.3f} "
                        f"ms ({e.count})" for e in top))
    log(f"the key's threefry draws: {events['the default key']} device "
        f"events a pair's PatchMatch stage against "
        f"{events['a torch.Generator']} with a torch.Generator "
        f"({events['the default key'] - events['a torch.Generator']:+d})")


def pm_cli_case(dev, h=480, w=640, seed=SEED + 50) -> None:
    """``python -m eppm_tpu_torch.cli --set match_engine=patchmatch``, in
    process: one pair with ``--gt`` a KITTI 16-bit PNG (the pixels whose
    target leaves the frame invalid), then ``--eval-dir`` over two
    sequences (shifts (3, -2) and (-6, 4)) with their .flo ground
    truths; each EPE below 1."""
    import contextlib
    import io as _io
    import os
    import tempfile

    from eppm_tpu_torch import cli
    from eppm_tpu_torch.io import write_flo, write_kitti_flow, write_ppm

    def run(args):
        buf = _io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = cli.main([*args, "--set", "match_engine=patchmatch",
                           "--device", dev.type, "--json"])
        check(rc == 0, f"cli {args}: rc {rc}")
        return json.loads(buf.getvalue().strip().splitlines()[-1])

    with tempfile.TemporaryDirectory() as tmp:
        for k, (dx, dy) in enumerate([(3, -2), (-6, 4)]):
            d = os.path.join(tmp, f"seq{k}")
            os.mkdir(d)
            f1, f2 = shifted_pair(h, w, dx, dy, seed + k)
            write_ppm(os.path.join(d, "frame10.ppm"), f1)
            write_ppm(os.path.join(d, "frame11.ppm"), f2)
            gt = np.zeros((h, w, 2), np.float32)
            gt[...] = (dx, dy)
            write_flo(os.path.join(d, "flow10.flo"), gt)
            write_kitti_flow(os.path.join(d, "flow10.png"), gt,
                             interior(h, w, dx, dy, 0))
        d = os.path.join(tmp, "seq0")
        one = run([os.path.join(d, "frame10.ppm"),
                   os.path.join(d, "frame11.ppm"), "--gt",
                   os.path.join(d, "flow10.png"), "--time"])
        log(f"cli --gt (KITTI PNG16) {w}x{h} [synthetic]: {one}")
        check(one["epe"] < 1.0, f"cli --gt EPE {one['epe']}")
        rep = run(["--eval-dir", tmp, "--border", "16"])
        log(f"cli --eval-dir, 2 sequences {w}x{h} [synthetic]: {rep}")
        check(sorted(rep["sequences"]) == ["seq0", "seq1"],
              f"eval-dir sequences {sorted(rep['sequences'])}")
        check(all(r["epe"] < 1.0 for r in rep["sequences"].values()),
              "eval-dir EPE")


def timed_pair(fn):
    """A warm-up run of ``fn``, then a timed one: (its output, wall ms,
    launches of that run by the names of ``counters``' rows)."""
    fn()
    torch.cuda.synchronize()
    before = {name: c.launches for name, c in counters().items()}
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    per = {name: c.launches - before[name] for name, c in counters().items()}
    return out, ms, per


def agreement(a: torch.Tensor, b: torch.Tensor):
    """(share of pixels within 1e-3, mean |diff|) of two flows."""
    d = (a.float() - b.float()).abs().max(-1).values
    return float((d < 1e-3).float().mean()), float(d.mean())


def sharded_cases(dev) -> dict:
    """The multi-device path (``parallel.compute_flow_sharded``) on meshes
    of this card repeated, under ``DEFAULT_CONFIG``, one path at a time:
    a 1080p pair on a (1, 1, 2) mesh and on a (1, 2, 2) mesh (which pads
    it to 1088x1920), each against single-device ``EPPMFlow`` on the
    frames it computes (padded the same way, the flow cropped) under the
    contract, with ms per pair beside EPPMFlow's, and launches per pair:
    kernels A and B once per tile where EPPMFlow launches them once (the
    coarse level, with kernel C and A's multiwarp form, runs once per
    distinct device: once); the two meshes' flows against each other,
    and the padded EPPMFlow's against the unpadded one, logged; a
    (2, 1, 1) batch of two 640x480 pairs; ``cli --mesh 1,1,1`` on the
    card, and a mesh that needs more cards than there are refused.  On
    these meshes of one card ``compute_flow_sharded`` replays a CUDA
    graph per mesh and shape: each path's warm-up call captures it, the
    timed call replays it (phase 7 holds the replays to the eager
    body)."""
    import contextlib
    import io as _io
    import math
    import os
    import tempfile

    from eppm_tpu_torch import cli
    from eppm_tpu_torch.config import DEFAULT_CONFIG as cfg
    from eppm_tpu_torch.io import read_flo, write_ppm
    from eppm_tpu_torch.parallel import (compute_flow_sharded, make_mesh,
                                         pad_to_tileable)
    from eppm_tpu_torch.pipeline import EPPMFlow

    name = torch.cuda.get_device_name(dev)
    model = EPPMFlow(cfg)
    default = ["cost_terms", "residual_costs", "residual_costs_multiwarp",
               "flow_smoothing_paired", "weighted_median_filter",
               "exact_best_of"]
    launches = {}
    h, w, dx, dy = 1080, 1920, 5, 3
    f1, f2 = shifted_pair(h, w, dx, dy, SEED + 60)
    img1, img2 = (torch.from_numpy(f).to(dev) for f in (f1, f2))
    single = {}   # the padded shape -> EPPMFlow's (flow cropped, ms, launches)

    def one_device(ph, pw):
        """EPPMFlow on the frames edge-padded to ph x pw, as the sharded
        path pads them, the flow cropped back."""
        if (ph, pw) not in single:
            iy = torch.arange(ph, device=dev).clamp(max=h - 1)
            ix = torch.arange(pw, device=dev).clamp(max=w - 1)
            p1, p2 = (f[iy][:, ix] for f in (img1, img2))
            flow, ms, per = timed_pair(lambda: model(p1, p2))
            single[(ph, pw)] = (flow[:h, :w], ms, per)
        return single[(ph, pw)]

    flows = {}
    fine_passes = 2 * (len(cfg.pyramid.level_dims(h, w)) - 1)
    for shape in ((1, 1, 2), (1, 2, 2)):
        mesh = make_mesh(*shape, devices=[dev] * math.prod(shape))
        tiles = shape[1] * shape[2]
        ph, pw = pad_to_tileable(h, w, cfg, shape[1], shape[2])
        ref, ref_ms, ref_per = one_device(ph, pw)
        path = f"sharded {shape}"
        out = {}
        launches[path] = drive(path, default, lambda: out.update(zip(
            ("flow", "ms", "per"), timed_pair(lambda: compute_flow_sharded(
                img1[None], img2[None], mesh, cfg)[0]))))
        flow, per = out["flow"], out["per"]
        check(tuple(flow.shape) == (h, w, 2), f"{path}: shape {flow.shape}")
        check(bool(torch.isfinite(flow).all()), f"{path}: non-finite flow")
        agree, mean = agreement(flow, ref)
        epe = interior_epe(flow.cpu().numpy(), dx, dy, 16)
        log(f"{path} {w}x{h} (computed at {pw}x{ph}) shift ({dx},{dy}) "
            f"[synthetic]: {out['ms']:.1f} ms a pair against {ref_ms:.1f} ms "
            f"for EPPMFlow on one device ({name}); {agree:.4%} of pixels "
            f"within 1e-3 of EPPMFlow's at {pw}x{ph}, mean |diff| "
            f"{mean:.3g}; interior EPE {epe:.4f}; launches per pair {per} "
            f"(EPPMFlow: {ref_per})")
        check(agree >= 0.98 and mean < 0.05,
              f"{path}: {agree:.2%} agree with EPPMFlow, mean {mean}")
        # the fine levels' launches once a tile, the coarse level's once
        extra = fine_passes * (tiles - 1)
        want = {"flow_smoothing_paired":
                ref_per["flow_smoothing_paired"] * tiles,
                "residual_costs": ref_per["residual_costs"] + extra,
                "cost_terms": ref_per["cost_terms"] + extra,
                "residual_costs_multiwarp": ref_per["residual_costs_multiwarp"],
                "weighted_median_filter": ref_per["weighted_median_filter"],
                "exact_best_of": ref_per["exact_best_of"]}
        for row, n in want.items():
            check(per[row] == n, f"{path}: {row} {per[row]} launches a pair, "
                  f"expected {n}")
        flows[shape] = flow
    padded = [k for k in single if k != (h, w)]
    for k in padded:
        agree, mean = agreement(single[k][0], single[(h, w)][0])
        log(f"EPPMFlow at {k[1]}x{k[0]} (edge-padded, cropped) against "
            f"{w}x{h}: {agree:.4%} of pixels within 1e-3, mean |diff| "
            f"{mean:.3g}")
    # the (1, 2, 2) mesh computes the padded frames: their agreement is
    # the padding's, logged beside EPPMFlow's own above
    agree, mean = agreement(flows[(1, 1, 2)], flows[(1, 2, 2)])
    log(f"sharded (1, 1, 2) against (1, 2, 2) (padded): {agree:.4%} of "
        f"pixels within 1e-3, mean |diff| {mean:.3g}")
    del flows, single

    # a batch of two 640x480 pairs, one a device of a (2, 1, 1) mesh
    h, w = 480, 640
    pairs = [shifted_pair(h, w, 3, -2, SEED + 61), shifted_pair(
        h, w, -6, 4, SEED + 62)]
    imgs1, imgs2 = (torch.from_numpy(np.stack([p[k] for p in pairs])).to(dev)
                    for k in (0, 1))
    mesh = make_mesh(2, 1, 1, devices=[dev] * 2)
    out = {}
    launches["sharded (2, 1, 1)"] = drive(
        "sharded (2, 1, 1)", default, lambda: out.update(zip(
            ("flow", "ms", "per"), timed_pair(lambda: compute_flow_sharded(
                imgs1, imgs2, mesh, cfg)))))
    for b in range(2):
        agree, mean = agreement(out["flow"][b], model(imgs1[b], imgs2[b]))
        log(f"sharded (2, 1, 1) pair {b} {w}x{h} [synthetic]: {agree:.4%} of "
            f"pixels within 1e-3 of EPPMFlow, mean |diff| {mean:.3g}")
        check(agree >= 0.98 and mean < 0.05, f"batch pair {b} disagrees")
    log(f"sharded (2, 1, 1), two {w}x{h} pairs: {out['ms']:.1f} ms the batch "
        f"({name}); launches {out['per']}")
    check(out["per"]["flow_smoothing_paired"] == 6,
          f"batch smoothing launches {out['per']}")

    # the command line on the card: --mesh 1,1,1, and a mesh of more cards
    # than there are refused
    with tempfile.TemporaryDirectory() as tmp:
        a, b = (os.path.join(tmp, n) for n in ("a.ppm", "b.ppm"))
        write_ppm(a, pairs[0][0])
        write_ppm(b, pairs[0][1])
        flo = os.path.join(tmp, "flow.flo")
        buf = _io.StringIO()

        def run_cli():
            with contextlib.redirect_stdout(buf):
                check(cli.main([a, b, "-o", flo, "--mesh", "1,1,1",
                                "--time"]) == 0, "cli --mesh 1,1,1")

        launches["sharded CLI"] = drive("sharded CLI", default, run_cli)
        rep = json.loads(buf.getvalue().strip().splitlines()[-1])
        epe = interior_epe(read_flo(flo), 3, -2, 16)
        log(f"cli --mesh 1,1,1 {w}x{h} [synthetic]: {rep}, interior EPE "
            f"{epe:.4f}")
        check(rep["device"] == "cuda" and epe < 1.0, f"cli --mesh: {rep}")
        n = torch.cuda.device_count()
        try:
            cli.main([a, b, "--mesh", f"1,1,{n + 1}"])
            refused = None
        except SystemExit as e:
            refused = str(e)
        log(f"cli --mesh 1,1,{n + 1} with {n} card(s): {refused}")
        check(refused is not None and f"need {n + 1} devices, have {n}"
              in refused, f"--mesh 1,1,{n + 1} was not refused: {refused}")
    return launches


def phase_end_to_end(dev) -> dict:
    log("== phase 4: end to end (synthetic pairs), one path at a time")
    from eppm_tpu_torch.config import DEFAULT_CONFIG as cfg
    from eppm_tpu_torch.graphs import GRAPHS
    from eppm_tpu_torch.pipeline import EPPMFlow, compute_flow_jit

    cases = [  # (h, w, dx, dy, seed): small and large translations; the
        # large 1080p one (-70, 44) runs on the temporal path's cold pairs
        (480, 640, 3, -2, SEED + 10),
        (480, 640, 37, 21, SEED + 11),
        (1080, 1920, 5, 3, SEED + 12),
        (480, 640, -70, 44, SEED + 13),
    ]
    default = ["cost_terms", "residual_costs", "residual_costs_multiwarp",
               "flow_smoothing_paired", "weighted_median_filter",
               "exact_best_of"]
    # radius 6 (the CLI's example): the one-pass smoothing kernel
    radius6 = dataclasses.replace(cfg, refine=dataclasses.replace(
        cfg.refine, blf_sigma_spatial=3.0))
    paths = [  # (path, config, cases, kernels it must launch)
        ("default", cfg, cases, default),
        ("planes", dataclasses.replace(cfg, **PLANES_CFG), cases,
         default + ["residual_costs_planes"]),
        ("gather", dataclasses.replace(cfg, refine_impl="gather"),
         cases[:2], default),
        ("radius 6", radius6, cases[:2],
         [k if k != "flow_smoothing_paired" else "flow_smoothing"
          for k in default]),
    ]
    launches = {}
    for path, pcfg, pcases, kernels in paths:
        log(f"-- {path}: EPPMFlow")
        model = EPPMFlow(pcfg)
        # one smoothing per fine level and one at the end: 3 per 640x480
        # pair (3 levels), 4 per 1080p pair (4 levels); kernel F 4 times a
        # direction and once in the occlusion arbitration
        smooth = ("flow_smoothing" if path == "radius 6"
                  else "flow_smoothing_paired")
        holes = []
        launches[path] = drive(path, kernels, lambda: polish_holes(
            holes, lambda: [
                flow_case(model, dev, *case,
                          expect={smooth: 3 if case[0] == 480 else 4,
                                  "exact_best_of": 9})
                for case in pcases]))
        log(f"kernel C's polish calls on the {path} path: "
            + ", ".join(f"{h}x{w} {share:.2%}" for h, w, share in holes)
            + " of the pixels listed (the holes)")
        if path == "default":
            profile_pair(model, dev, *cases[2])
    log("-- match_coarse at 4K, depth 3")
    launches["match_coarse"] = drive(
        "match_coarse", ["cost_terms", "residual_costs",
                         "residual_costs_multiwarp", "global_argmax"],
        lambda: match_coarse_depth3(dev))

    log("-- temporal: a 1080p stream, cold, then warm-started")
    launches["temporal"] = drive("temporal", default, lambda: [
        temporal_case(dev, 1080, 1920, dx, dy, SEED + 31 + i)
        for i, (dx, dy) in enumerate([(5, 3), (-70, 44)])])
    log("-- stream CLI: --frames-dir --out-dir, cold and --temporal")
    launches["stream CLI"] = drive("stream CLI", default, lambda: [
        stream_case(dev, temporal=False),
        stream_case(dev, 1080, 1920, 5, 3, SEED + 33, temporal=False),
        stream_case(dev)])

    small, large = cases[0], cases[2]
    legacy = dataclasses.replace(cfg, refine=dataclasses.replace(
        cfg.refine, wmf_fill_first=False))
    log("-- legacy WMF: refine.wmf_fill_first=False")
    model = EPPMFlow(legacy)
    # one kernel C launch per Jacobi iteration at the coarse level
    launches["legacy WMF"] = drive("legacy WMF", default, lambda: [
        flow_case(model, dev, *case, expect={
            "weighted_median_filter": cfg.refine.wmf_coarse_iters,
            "flow_smoothing_paired": 3 if case[0] == 480 else 4})
        for case in (small, large)])
    log("-- fine-level WMF: fine_level_wmf=True")

    def fine(img1, img2):
        return compute_flow_jit(img1, img2, cfg=cfg, fine_level_wmf=True)

    # kernel C: the coarse polish, then one iteration a fine level (2 at
    # 640x480, 3 at 1080p)
    launches["fine-level WMF"] = drive("fine-level WMF", default, lambda: [
        flow_case(fine, dev, *case, expect={
            "weighted_median_filter": 3 if case[0] == 480 else 4,
            "flow_smoothing_paired": 3 if case[0] == 480 else 4})
        for case in (small, large)])

    # half-pixel shifts: the integer default's EPE beside each subpixel
    # stage's
    halves = [(480, 640, 7, -3, SEED + 40), (1080, 1920, 11, 5, SEED + 41)]
    pairs = {case: half_pixel_pair(*case) for case in halves}
    default_model = EPPMFlow(cfg)
    base = {}
    log("-- subpixel: the integer default on half-pixel pairs")
    for case in halves:
        h, w, sx2, sy2, seed = case
        base[case] = flow_case(default_model, dev, h, w, sx2 / 2, sy2 / 2,
                               seed, pair=pairs[case])
    for name, change in (("subpixel_refine", dict(subpixel_refine=True)),
                         ("dense_subpixel_fit",
                          dict(dense_subpixel_fit=True))):
        log(f"-- subpixel: {name}=True")
        model = EPPMFlow(dataclasses.replace(cfg, **change))
        epes = {}
        launches[name] = drive(name, default, lambda: [
            epes.__setitem__(case, flow_case(
                model, dev, case[0], case[1], case[2] / 2, case[3] / 2,
                case[4], pair=pairs[case],
                expect={"flow_smoothing_paired":
                        3 if case[0] == 480 else 4}))
            for case in halves])
        for case in halves:
            log(f"{name} {case[1]}x{case[0]} shift ({case[2] / 2},"
                f"{case[3] / 2}): interior EPE {epes[case]:.4f} against the "
                f"integer default's {base[case]:.4f}")

    log("-- patchmatch: match_engine='patchmatch', the default key")
    check(launches["default"]["patchmatch_costs"] == 0,
          "kernel E launched on the default path")
    pm_kernels = ["cost_terms", "residual_costs", "flow_smoothing_paired",
                  "weighted_median_filter", "patchmatch_costs",
                  "exact_best_of"]
    model = EPPMFlow(dataclasses.replace(cfg, **PM_CFG))
    for path, run in (
            ("patchmatch", lambda: [pm_case(model, dev, *case)
                                    for case in cases[:3]]),
            ("patchmatch CLI", lambda: pm_cli_case(dev))):
        launches[path] = drive(path, pm_kernels, run)
        for name in DENSE_MATCHER:
            check(launches[path][name] == 0,
                  f"{name} launched on the {path} path")
    log("-- sharded: compute_flow_sharded on meshes of this card")
    launches.update(sharded_cases(dev))
    log(f"CUDA graphs of phase 4: {GRAPHS.captures} captured, "
        f"{GRAPHS.evictions} evicted (at most {GRAPHS.capacity} kept)")
    return launches


def phase_agreement(dev) -> None:
    log("== phase 5: the port on the card against the port on the CPU")
    from eppm_tpu_torch.config import DEFAULT_CONFIG as cfg
    from eppm_tpu_torch.config import UNKNOWN_FLOW
    from eppm_tpu_torch.ops.match import (global_match_bidi, match_coarse,
                                          match_coarse_bidi)
    from eppm_tpu_torch.pipeline import compute_flow
    from eppm_tpu_torch.testing import dark_rows

    h, w = 192, 256
    for name, pcfg, dark in [
            ("default", cfg, False),
            ("planes", dataclasses.replace(cfg, **PLANES_CFG), False),
            ("default, black regions", cfg, True)]:
        f1, f2 = shifted_pair(h, w, 3, -2, SEED + 20, dark)
        gpu = compute_flow(torch.from_numpy(f1).to(dev),
                           torch.from_numpy(f2).to(dev), pcfg).cpu().numpy()
        cpu = compute_flow(torch.from_numpy(f1), torch.from_numpy(f2),
                           pcfg).numpy()
        d = np.abs(gpu - cpu).max(axis=-1)
        agree = float((d < 1e-3).mean())
        log(f"{h}x{w} {name}: {agree:.4%} of pixels agree within 1e-3, "
            f"mean |diff| {float(d.mean()):.3g}, max {float(d.max()):.3g}")
        check(agree >= 0.98, f"{name}: only {agree:.2%} of pixels agree")
        check(float(d.mean()) < 0.05, f"{name}: mean |diff| {float(d.mean())}")

    # the paths this slice added: the warm start from an init holding
    # unknown flow and values beyond +-2^31 (with and without skipping the
    # global stages), the legacy WMF order, the fine-level WMF and both
    # subpixel stages
    f1, f2 = shifted_pair(h, w, 3, -2, SEED + 22)
    init = compute_flow(torch.from_numpy(f1), torch.from_numpy(f2), cfg)
    init[:12, :20] = UNKNOWN_FLOW
    init[40:44, 30:60, 0] = -3.7e9
    init[90, 100:140, 1] = 3.7e9
    no_skip = dataclasses.replace(cfg, match=dataclasses.replace(
        cfg.match, warm_skip_global=False))
    legacy = dataclasses.replace(cfg, refine=dataclasses.replace(
        cfg.refine, wmf_fill_first=False))
    for name, pcfg, kw in [
            ("warm start", cfg, dict(init_flow=init)),
            ("warm start, global stages kept", no_skip,
             dict(init_flow=init)),
            ("legacy WMF", legacy, {}),
            ("fine-level WMF", cfg, dict(fine_level_wmf=True)),
            ("subpixel_refine", dataclasses.replace(cfg, subpixel_refine=True),
             {}),
            ("dense_subpixel_fit",
             dataclasses.replace(cfg, dense_subpixel_fit=True), {})]:
        gkw = {k: (v.to(dev) if torch.is_tensor(v) else v)
               for k, v in kw.items()}
        gpu = compute_flow(torch.from_numpy(f1).to(dev),
                           torch.from_numpy(f2).to(dev), pcfg,
                           **gkw).cpu().numpy()
        cpu = compute_flow(torch.from_numpy(f1), torch.from_numpy(f2), pcfg,
                           **kw).numpy()
        d = np.abs(gpu - cpu).max(axis=-1)
        agree = float((d < 1e-3).mean())
        log(f"{h}x{w} {name}: {agree:.4%} of pixels agree within 1e-3, "
            f"mean |diff| {float(d.mean()):.3g}, max {float(d.max()):.3g}")
        check(agree >= 0.98, f"{name}: only {agree:.2%} of pixels agree")
        check(float(d.mean()) < 0.05, f"{name}: mean |diff| {float(d.mean())}")

    (i1, p1), (i2, p2) = _packs(60, 80, -5, 3, SEED + 21, dev)
    warm = torch.zeros((60, 80, 2))
    warm[..., 0], warm[..., 1] = -4.0, 2.0
    warm[:6, :9] = UNKNOWN_FLOW
    warm[20:22, 10:30, 0] = -3.7e9
    for skip in (True, False):
        mcfg = dataclasses.replace(cfg.match, warm_skip_global=skip)
        gpu = match_coarse_bidi(i1, i2, cfg.cost, mcfg, p1, p2,
                                init_flow=warm.to(dev))
        cpu = match_coarse_bidi(i1.cpu(), i2.cpu(), cfg.cost, mcfg, p1.cpu(),
                                p2.cpu(), init_flow=warm)
        same = [bool(torch.equal(g.cpu(), c))
                for gd, cd in zip(gpu, cpu) for g, c in zip(gd[:2], cd[:2])]
        log(f"match_coarse_bidi 60x80, warm start (warm_skip_global={skip}):"
            f" targets {'identical' if all(same) else 'DIFFER'} on the card "
            "and the CPU")
        check(all(same), "warm-started match targets differ between card "
              "and CPU")

    gpu = match_coarse(i1, i2, cfg.cost, cfg.match, p1, p2)
    cpu = match_coarse(i1.cpu(), i2.cpu(), cfg.cost, cfg.match, p1.cpu(),
                       p2.cpu())
    same = [bool(torch.equal(g.cpu(), c)) for g, c in zip(gpu[:2], cpu[:2])]
    log(f"match_coarse 60x80: targets {'identical' if all(same) else 'DIFFER'}"
        f" on the card and the CPU")
    check(all(same), "match_coarse targets differ between card and CPU")

    # the bidirectional global match sums float64 products with cuBLAS on
    # the card and the CPU's BLAS here; on frames with black regions some
    # products lie below the sums' last bit (ops/match.py::_score_sweep)
    d1, d2 = (r.reshape(48, 64, -1) for r in dark_rows())
    cpu = global_match_bidi(d1, d2)
    gpu = global_match_bidi(d1.to(dev), d2.to(dev))
    share = [float((g.cpu() == c).float().mean()) for g, c in zip(gpu, cpu)]
    log(f"global_match_bidi on dark_rows (48x64, D={d1.shape[-1]}): "
        f"{', '.join(f'{v:.4%}' for v in share)} of the (t1y, t1x, t2y, "
        f"t2x) targets identical on the card and the CPU")
    check(all(v == 1.0 for v in share),
          "global_match_bidi targets differ between card and CPU on dark_rows")
    pm_agreement(dev)


def pm_agreement(dev) -> None:
    """The PatchMatch path on the card against the CPU under the default
    key (``prng_key(cfg.seed)``: JAX's threefry draws, made by integer
    ops, so both devices draw the same): the flow at 192x256 identical;
    the engine's four searches at 48x64 (4 iterations each, drawing from
    the key) with identical targets."""
    from eppm_tpu_torch.config import DEFAULT_CONFIG as base
    from eppm_tpu_torch.ops import patchmatch as pm
    from eppm_tpu_torch.ops.cost import patch_cost
    from eppm_tpu_torch.ops.prng import prng_key
    from eppm_tpu_torch.pipeline import compute_flow

    cfg = dataclasses.replace(base, **PM_CFG)
    h, w = 192, 256
    f1, f2 = shifted_pair(h, w, 3, -2, SEED + 23)
    gpu = compute_flow(torch.from_numpy(f1).to(dev),
                       torch.from_numpy(f2).to(dev), cfg).cpu()
    cpu = compute_flow(torch.from_numpy(f1), torch.from_numpy(f2), cfg)
    agree, mean = agreement(gpu, cpu)
    same = bool(torch.equal(gpu, cpu))
    log(f"{h}x{w} patchmatch, the default key: flow "
        f"{'identical' if same else 'DIFFERS'} on the card and the CPU "
        f"({agree:.4%} of pixels within 1e-3, mean |diff| {mean:.3g})")
    check(same, "patchmatch: the default key's flow differs between card "
          "and CPU")

    (_, p1), (_, p2) = _packs(48, 64, -3, 2, SEED + 24, dev)
    tx, ty = pm.random_init(prng_key(base.seed), 48, 64)
    c0 = patch_cost(p1.cpu(), p2.cpu(), tx, ty, cfg.cost)
    pcfg = dataclasses.replace(cfg.patchmatch, num_iters=4)
    runs = {
        "patchmatch": lambda a, b, s: pm.patchmatch(a, b, s, pcfg, cfg.cost),
        "patchmatch_scaled": lambda a, b, s: pm.patchmatch_scaled(
            a, b, s, pcfg, cfg.cost),
        "patchmatch_planefitting": lambda a, b, s: pm.patchmatch_planefitting(
            a, b, s, pcfg, cfg.cost),
        "line_propagate": lambda a, b, s: pm.line_propagate(
            a, b, tx.to(a.device), ty.to(a.device), c0.to(a.device),
            cfg.cost),
    }
    for name, run in runs.items():
        t0 = time.perf_counter()
        g = run(p1, p2, prng_key(base.seed, dev))
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        c = run(p1.cpu(), p2.cpu(), prng_key(base.seed))
        t2 = time.perf_counter()
        same = [bool(torch.equal(a.cpu(), b)) for a, b in zip(g, c)]
        log(f"{name} 48x64: outputs {same} identical on the card and the CPU "
            f"(card {(t1 - t0) * 1e3:.1f} ms, CPU {(t2 - t1) * 1e3:.1f} ms)")
        check(same[0] and same[1], f"{name} targets differ between card and "
              "CPU")


# the kernels each engine launches on every pair of the eval set: the
# dense engine kernel A in both forms, B and C; PatchMatch A (no multiwarp
# form), B, C and E
DOSSIER_KERNELS = {
    "dense": ["cost_terms", "residual_costs", "residual_costs_multiwarp",
              "flow_smoothing_paired", "weighted_median_filter",
              "exact_best_of"],
    "patchmatch": ["cost_terms", "residual_costs", "flow_smoothing_paired",
                   "weighted_median_filter", "patchmatch_costs",
                   "exact_best_of"],
}


def phase_dossier(dev) -> None:
    """The evaluation dossier on the card (``eppm_tpu_torch.eval_report``)
    against the JAX package's scores (``evalset_reference.json``, made on
    the CPU by ``tools/torch_eval_parity.py``): the set built into a
    temporary directory, then for each engine every case the reference
    holds for it.  Per group first one case alone, untimed (the kernels'
    first calls at that shape), its launches per pair logged; then the
    engine's cases with the launch counts zeroed just before and read
    just after, each of the engine's kernels launched.  Each case: EPE,
    its difference from JAX's and its ms (``DeviceTimer``); outside the
    holdout group |EPE - EPE_jax| <= ``eval_report.TOLERANCE``."""
    import contextlib
    import io as _io
    import os
    import tempfile

    from eppm_tpu_torch import eval_report, evalset

    log("== phase 6: the evaluation dossier on the card against eppm_tpu")
    ref = eval_report.load_reference()
    with tempfile.TemporaryDirectory() as root:
        with contextlib.redirect_stdout(_io.StringIO()):
            evalset.build(root)
        for engine in eval_report.ENGINES:
            cases = sorted(ref.get(engine, {}))
            check(bool(cases), f"the reference holds no case of {engine}")
            for group in evalset.GROUPS:
                first = [c for c in cases if c.startswith(group + "/")][:1]
                if not first:
                    continue
                eval_report.run(root, [engine], dev, first)
                # the first call captured the shape's graph: count a replay
                before = {n: c.launches for n, c in counters().items()}
                eval_report.run(root, [engine], dev, first)
                per = {n: c.launches - before[n] for n, c in
                       counters().items() if c.launches > before[n]}
                log(f"dossier {engine} {group}: launches per pair {per}")
            out = {}
            drive(f"dossier {engine}", DOSSIER_KERNELS[engine],
                  lambda: out.update(eval_report.run(
                      root, [engine], dev, cases, reference=ref)))
            for key, rep in out["groups"].items():
                group = key.split("/")[0]
                for name, r in rep["sequences"].items():
                    check(r["epe"] is not None and np.isfinite(r["epe"]),
                          f"{engine} {group}/{name}: EPE {r['epe']}")
                    timing = "" if group == "holdout" else \
                        f"  {r['ms']:.1f} ms (DeviceTimer)"
                    within = ref[engine][f"{group}/{name}"]["within_1e3"]
                    log(f"dossier {engine} {group}/{name}: EPE "
                        f"{r['epe']:.5f}  jax {r['epe_jax']:.5f}  delta "
                        f"{r['delta']:+.6f}  CPU agreement {within:.3%}"
                        f"{timing}")
            done = sorted(f"{k.split('/')[0]}/{n}"
                          for k, rep in out["groups"].items()
                          for n in rep["sequences"])
            check(done == cases, f"{engine}: scored {done}, expected {cases}")
            check(not out["misses"],
                  f"EPE more than {eval_report.TOLERANCE} from eppm_tpu's: "
                  f"{out['misses']}")


def graph_label(key) -> str:
    """A graph key of ``graphs.graph_key`` or of ``parallel.sharded.
    sharded_graph_key`` in a few words."""
    if key[0] == "compute_flow_sharded":
        _, mesh, _, (shape, dtype), _, gcfg, init, given, traced = key
        return (f"sharded {mesh} mesh, {shape[0]} x {shape[2]}x{shape[1]} "
                f"{str(dtype).replace('torch.', '')} {gcfg.match_engine}"
                f"{' init_flows' if init else ''}{' keys' if given else ''}"
                f"{' traced' if traced else ''}")
    _, (shape, dtype), _, gcfg, fine, init, given, traced = key
    return (f"{shape[1]}x{shape[0]} {str(dtype).replace('torch.', '')} "
            f"{gcfg.match_engine}{' fine_level_wmf' if fine else ''}"
            f"{' init_flow' if init else ''}{' key' if given else ''}"
            f"{' traced' if traced else ''}")


def log_capture(entry) -> None:
    log(f"graph {graph_label(entry.key)}: warm-up {entry.warmup_s:.3f} s, "
        f"capture {entry.capture_s:.3f} s, instantiation "
        f"{entry.instantiate_s:.3f} s; device memory allocated at most "
        f"{entry.max_allocated / 2**30:.3f} GiB ({entry.pair_bytes / 2**30:.3f}"
        f" GiB above what was allocated before); launches a replay "
        f"{ {k.symbol: n for k, n in entry.launches.items()} }")


def phase_graphs(dev) -> None:
    """``compute_flow_jit`` (one CUDA graph per shape and configuration,
    ``eppm_tpu_torch/graphs.py``) against the eager ``compute_flow``, the
    cache emptied first: for each configuration the graph's capture (its
    warm-up call makes the tables) and first replay, an eager call under
    ``torch.cuda.set_sync_debug_mode("error")`` (any op that synchronises
    with the card raises), and a second replay, both replays
    ``torch.equal`` to the eager flow; the capture's seconds and device
    memory logged.
    Then the walls: the median of 10 replays against the median of 5
    eager calls (host clock, ending in a synchronize) at 640x480 and
    1080p, default and PatchMatch, the replays identical to the eager
    flow; and one replay at 1080p of each under ``torch.profiler``: its
    device events, device busy as a share of the replayed wall, and each
    hand kernel's events against the launches the replay added."""
    import statistics

    from eppm_tpu_torch.config import DEFAULT_CONFIG as cfg
    from eppm_tpu_torch.graphs import GRAPHS, graph_key
    from eppm_tpu_torch.ops.prng import prng_key
    from eppm_tpu_torch.pipeline import compute_flow, compute_flow_jit

    log("== phase 7: graph against eager (compute_flow_jit)")
    GRAPHS.clear()
    torch.cuda.empty_cache()
    rcfg = cfg.refine

    def pair(h, w, dx, dy, seed):
        return [torch.from_numpy(f).to(dev)
                for f in shifted_pair(h, w, dx, dy, seed)]

    small = pair(480, 640, 3, -2, SEED + 70)
    large = pair(1080, 1920, 5, 3, SEED + 71)
    halves = [torch.from_numpy(f).to(dev)
              for f in half_pixel_pair(480, 640, 7, -3, SEED + 72)]
    warm = compute_flow(*small)
    pm = dataclasses.replace(cfg, match_engine="patchmatch")
    cases = [  # (label, frames, kwargs of compute_flow_jit); the last
        # ones' graphs stay cached for the walls below
        ("both plane flags", small,
         dict(cfg=dataclasses.replace(cfg, **PLANES_CFG))),
        ("refine_impl=gather", small,
         dict(cfg=dataclasses.replace(cfg, refine_impl="gather"))),
        ("refine.blf_sigma_spatial=3.0", small, dict(cfg=dataclasses.replace(
            cfg, refine=dataclasses.replace(rcfg, blf_sigma_spatial=3.0)))),
        ("refine.wmf_fill_first=False", small, dict(cfg=dataclasses.replace(
            cfg, refine=dataclasses.replace(rcfg, wmf_fill_first=False)))),
        ("fine_level_wmf=True", small, dict(cfg=cfg, fine_level_wmf=True)),
        ("subpixel_refine", halves,
         dict(cfg=dataclasses.replace(cfg, subpixel_refine=True))),
        ("dense_subpixel_fit", halves,
         dict(cfg=dataclasses.replace(cfg, dense_subpixel_fit=True))),
        ("temporal warm pair", small, dict(cfg=cfg, init_flow=warm)),
        ("patchmatch, a given key", small,
         dict(cfg=pm, key=prng_key(cfg.seed + 1, dev))),
        ("patchmatch, its default key", small, dict(cfg=pm)),
        ("default 4K", pair(2160, 3840, 5, 3, SEED + 75), dict(cfg=cfg)),
        ("default 640x480", small, dict(cfg=cfg)),
        ("default 1080p", large, dict(cfg=cfg)),
    ]
    for label, (img1, img2), kw in cases:
        # the capture's warm-up call makes the tables, so that the eager
        # call after it copies nothing from the host
        first = compute_flow_jit(img1, img2, **kw)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            want = compute_flow(img1, img2, kw["cfg"],
                                kw.get("fine_level_wmf", False),
                                kw.get("init_flow"), key=kw.get("key"))
        finally:
            torch.cuda.set_sync_debug_mode(0)
        again = compute_flow_jit(img1, img2, **kw)
        torch.cuda.synchronize()
        same = bool(torch.equal(first, want)) and bool(torch.equal(again, want))
        log(f"{label}: the eager pair ran no synchronising op; replays "
            f"{'identical to' if same else 'DIFFER from'} the eager flow")
        check(same, f"{label}: the replayed flow differs from the eager one")
        log_capture(GRAPHS.entries[graph_key(
            img1, img2, kw["cfg"], kw.get("fine_level_wmf", False),
            kw.get("init_flow"), kw.get("key"))])

    name = torch.cuda.get_device_name(dev)
    jit_1080p_ms = None
    for label, (img1, img2), pcfg in (
            ("default 640x480", small, cfg), ("default 1080p", large, cfg),
            ("patchmatch 640x480", small, pm),
            ("patchmatch 1080p", large, pm)):
        want = compute_flow(img1, img2, pcfg)
        got = compute_flow_jit(img1, img2, cfg=pcfg)
        torch.cuda.synchronize()
        check(bool(torch.equal(got, want)),
              f"{label}: the replayed flow differs from the eager one")
        eager = [wall_ms(lambda: compute_flow(img1, img2, pcfg))
                 for _ in range(5)]
        replay = [wall_ms(lambda: compute_flow_jit(img1, img2, cfg=pcfg))
                  for _ in range(10)]
        e_ms, r_ms = statistics.median(eager), statistics.median(replay)
        # kernel F a replay: the exact stage's 8 and the arbitration's 1
        # on the dense engine, the arbitration alone on PatchMatch
        exact = counters()["exact_best_of"]
        before = exact.launches
        compute_flow_jit(img1, img2, cfg=pcfg)
        n_exact = exact.launches - before
        log(f"wall {label} [synthetic] ({name}): replay median {r_ms:.3f} ms "
            f"(10: {min(replay):.3f}-{max(replay):.3f}) against eager median "
            f"{e_ms:.3f} ms (5: {min(eager):.3f}-{max(eager):.3f}), "
            f"{e_ms / r_ms:.2f}x; replays identical to the eager flow; "
            f"kernel F {n_exact} launches a replay")
        check(n_exact == (9 if pcfg is cfg else 1),
              f"{label}: kernel F {n_exact} launches a replay")
        if img1.shape[0] != 1080:
            continue
        entry = GRAPHS.entries[graph_key(img1, img2, pcfg, False, None, None)]
        log_capture(entry)
        profile_replay(label, lambda: compute_flow_jit(img1, img2, cfg=pcfg),
                       r_ms)
        if label == "default 1080p":
            jit_1080p_ms = r_ms
    sharded_graphs(dev, large, small, warm, jit_1080p_ms)
    log(f"CUDA graphs: {GRAPHS.captures} captured in this process, "
        f"{GRAPHS.evictions} evicted (at most {GRAPHS.capacity} kept)")


def wall_ms(fn) -> float:
    """``fn()``'s wall on the host clock, ending in a synchronize."""
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def profile_replay(label: str, run, r_ms: float) -> None:
    """One call of ``run`` (a replay) under ``torch.profiler``, device
    activity only: its device events, device busy as a share of ``r_ms``
    (the unprofiled replay median), and each hand kernel's events against
    the launches the replay added."""
    from torch.profiler import ProfilerActivity, profile

    before = {n: c.launches for n, c in counters().items()}
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        wall = wall_ms(run)
    launched = {n: c.launches - before[n] for n, c in counters().items()}
    total_us, count = 0.0, 0
    per = {n: [0.0, 0] for n in PROFILED}
    for e in prof.key_averages():
        if e.self_device_time_total <= 0:
            continue
        total_us += e.self_device_time_total
        count += e.count
        for n, (kernels, _) in PROFILED.items():
            if any(k in e.key for k in kernels):
                per[n][0] += e.self_device_time_total
                per[n][1] += e.count
    complete = all(
        per[n][1] == len(kernels) * sum(launched[r] for r in rows)
        for n, (kernels, rows) in PROFILED.items())
    log(f"profile of a replay, {label} [synthetic]: wall {wall:.1f} ms "
        f"under the profiler, {count} device events, device busy "
        f"{total_us / 1e3:.3f} ms, {total_us / 1e3 / r_ms:.1%} of the "
        f"unprofiled replay median; "
        + ", ".join(f"{n} {us / 1e3:.3f} ms ({k})"
                    for n, (us, k) in per.items())
        + ("; every hand kernel's events match its launches" if complete
           else "; INCOMPLETE: events and launches differ")
        + f"; launches the replay added {launched}")


def sharded_graphs(dev, large, small, warm, jit_1080p_ms) -> None:
    """``compute_flow_sharded`` on meshes of this card repeated (one CUDA
    graph per mesh and shape) against its eager body,
    ``compute_flow_sharded_eager``: 1080p on (1, 1, 2) and on (1, 2, 2)
    (padded to 1088x1920), a (2, 1, 1) batch of two 640x480 pairs, a warm
    640x480 (1, 1, 2) pair (``init_flows``) and PatchMatch on its default
    keys.  For each, the capture and first replay, the eager body under
    ``torch.cuda.set_sync_debug_mode("error")``, a second replay, both
    replays ``torch.equal`` to the eager flow, the launches a replay adds
    equal to the eager call's (kernel B once a tile a level), and the
    capture's seconds and memory.  Then at 1080p on (1, 1, 2) the median
    wall of 10 replays against 5 eager calls, beside the replayed
    ``EPPMFlow`` pair's (``jit_1080p_ms``), and one replay under the
    profiler."""
    import math
    import statistics

    from eppm_tpu_torch.config import DEFAULT_CONFIG as cfg
    from eppm_tpu_torch.graphs import GRAPHS
    from eppm_tpu_torch.parallel import (compute_flow_sharded,
                                         compute_flow_sharded_eager,
                                         make_mesh, pad_to_tileable)

    pm = dataclasses.replace(cfg, match_engine="patchmatch")
    pair2 = [torch.from_numpy(np.stack([f, g])).to(dev) for f, g in zip(
        shifted_pair(480, 640, 3, -2, SEED + 73),
        shifted_pair(480, 640, -6, 4, SEED + 74))]

    def mesh(*shape):
        return make_mesh(*shape, devices=[dev] * math.prod(shape))

    def one(p):   # a batch of one pair
        return [f[None] for f in p]

    cases = [  # (label, frames, mesh shape, kwargs)
        ("1080p (1, 1, 2)", one(large), (1, 1, 2), dict(cfg=cfg)),
        ("1080p (1, 2, 2), padded", one(large), (1, 2, 2), dict(cfg=cfg)),
        ("(2, 1, 1), two 640x480 pairs", pair2, (2, 1, 1), dict(cfg=cfg)),
        ("640x480 (1, 1, 2), warm", one(small), (1, 1, 2),
         dict(cfg=cfg, init_flows=warm[None])),
        ("640x480 (1, 1, 2), patchmatch on its default keys", one(small),
         (1, 1, 2), dict(cfg=pm)),
    ]
    for label, (imgs1, imgs2), shape, kw in cases:
        m = mesh(*shape)
        first = compute_flow_sharded(imgs1, imgs2, m, **kw)
        torch.cuda.synchronize()
        entry = next(reversed(GRAPHS.entries.values()))
        check(entry.key[0] == "compute_flow_sharded",
              f"{label}: no graph of the sharded body")
        before = {n: c.launches for n, c in counters().items()}
        torch.cuda.set_sync_debug_mode("error")
        try:
            want = compute_flow_sharded_eager(imgs1, imgs2, m, **kw)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        eager = {n: c.launches - before[n] for n, c in counters().items()}
        before = {n: c.launches for n, c in counters().items()}
        again = compute_flow_sharded(imgs1, imgs2, m, **kw)
        torch.cuda.synchronize()
        replay = {n: c.launches - before[n] for n, c in counters().items()}
        same = bool(torch.equal(first, want)) and bool(torch.equal(again, want))
        log(f"sharded {label}: the eager body ran no synchronising op; "
            f"replays {'identical to' if same else 'DIFFER from'} the eager "
            f"flow; launches a replay {replay}")
        check(same, f"sharded {label}: the replayed flow differs from the "
              f"eager one")
        check(replay == eager, f"sharded {label}: a replay launched "
              f"{replay}, the eager body {eager}")
        h, w = imgs1.shape[1:3]
        ph, pw = pad_to_tileable(h, w, kw["cfg"], shape[1], shape[2])
        levels = len(kw["cfg"].pyramid.level_dims(ph, pw))
        smooth = shape[0] * shape[1] * shape[2] * levels
        check(replay["flow_smoothing_paired"] == smooth,
              f"sharded {label}: kernel B {replay['flow_smoothing_paired']} "
              f"launches a replay, expected {smooth} (once a tile a level)")
        check(replay["residual_costs"] > 0 and replay["cost_terms"] > 0,
              f"sharded {label}: kernel A not launched by a replay")
        log_capture(entry)

    name = torch.cuda.get_device_name(dev)
    label, (imgs1, imgs2), shape, kw = cases[0]
    m = mesh(*shape)
    eager = [wall_ms(lambda: compute_flow_sharded_eager(imgs1, imgs2, m,
                                                        **kw))
             for _ in range(5)]
    replay = [wall_ms(lambda: compute_flow_sharded(imgs1, imgs2, m, **kw))
              for _ in range(10)]
    e_ms, r_ms = statistics.median(eager), statistics.median(replay)
    log(f"wall sharded {label} [synthetic] ({name}): replay median "
        f"{r_ms:.3f} ms (10: {min(replay):.3f}-{max(replay):.3f}) against "
        f"eager median {e_ms:.3f} ms (5: {min(eager):.3f}-{max(eager):.3f}), "
        f"{e_ms / r_ms:.2f}x; {r_ms / jit_1080p_ms:.2f}x the replayed "
        f"EPPMFlow pair's {jit_1080p_ms:.3f} ms")
    profile_replay(f"sharded {label}", lambda: compute_flow_sharded(
        imgs1, imgs2, m, **kw), r_ms)


def phase_upstream(dev) -> None:
    """The upstream deployment (``UPSTREAM_CONFIG``, phase 9 of the
    docstring): kernel E at its shapes, kernel C's 20 iterations, and one
    pair eager, replayed and traced."""
    from eppm_tpu_torch.config import UPSTREAM_CONFIG as ucfg
    from eppm_tpu_torch.graphs import GRAPHS, graph_key
    from eppm_tpu_torch.ops import cuda_patchmatch, cuda_wmf
    from eppm_tpu_torch.ops.refine import weighted_median_filter
    from eppm_tpu_torch.pipeline import compute_flow, compute_flow_jit
    from eppm_tpu_torch.utils import trace

    log("== phase 9: the upstream deployment (UPSTREAM_CONFIG)")
    rows: dict = {}
    # the gathered refine's launches at the fine levels of 640x480: K = 1
    # candidate over the 4 plane tables of 100 taps
    for h, w in ((480, 640), (240, 320)):
        kernel_e(rows, dev, h, w, "cost", cfg=ucfg, planes=True, k=1)
    # the search's rounds at the coarse level, 100 taps, one table
    for mode in ("propagate", "fold"):
        kernel_e(rows, dev, 120, 160, mode, cfg=ucfg)

    rcfg = ucfg.refine
    tx, ty, img, _ = wmf_inputs(120, 160, dev)
    n = rcfg.wmf_coarse_iters
    before = cuda_wmf.KERNEL.launches
    got = cuda_wmf.weighted_median_filter_cuda(tx, ty, img, rcfg, n,
                                               only_occlusion=True)
    torch.cuda.synchronize()
    launched = cuda_wmf.KERNEL.launches - before
    want = weighted_median_filter(tx, ty, img, rcfg, n, only_occlusion=True)
    same = all(torch.equal(a, b) for a, b in zip(got, want))
    # a call enqueues 20 launches and their host work: few calls a timing
    k_ms, call_ms, planes_ms = wmf_kernel_ms(
        lambda it: cuda_wmf.weighted_median_filter_cuda(
            tx, ty, img, rcfg, n if it is None else it, only_occlusion=True),
        reps=3)
    log(f"wmf 120x160 occlusion-only x{n}: "
        f"{'identical' if same else 'DIFFER'}, {launched} launches; kernel "
        f"{k_ms:.4f} ms device (the call {call_ms:.4f}, its planes "
        f"{planes_ms:.4f})")
    check(same, f"kernel C x{n} at 120x160: differs from its plain version")
    check(launched == n, f"kernel C: {launched} launches for {n} iterations")

    # one pair: eager under the sync debug mode, then the graph
    img1, img2 = [torch.from_numpy(f).to(dev)
                  for f in shifted_pair(480, 640, 3, -2, SEED + 90)]
    GRAPHS.clear()
    compute_flow(img1, img2, ucfg)   # the tables, outside the count
    torch.cuda.synchronize()
    cs = counters()
    for c in cs.values():
        c.launches = 0
    torch.cuda.set_sync_debug_mode("error")
    try:
        eager = compute_flow(img1, img2, ucfg)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    per_pair = {name: c.launches for name, c in cs.items() if c.launches}
    first = compute_flow_jit(img1, img2, cfg=ucfg)
    torch.cuda.synchronize()
    mid = {name: c.launches for name, c in cs.items()}
    again = compute_flow_jit(img1, img2, cfg=ucfg)
    torch.cuda.synchronize()
    per_replay = {name: c.launches - mid[name] for name, c in cs.items()
                  if c.launches > mid[name]}
    same = bool(torch.equal(first, eager)) and bool(torch.equal(again, eager))
    flow = eager.cpu().numpy()
    epe = interior_epe(flow, 3, -2, 16)
    log(f"upstream 640x480 shift (3,-2): eager pair ran no synchronising "
        f"op; replays {'identical to' if same else 'DIFFER from'} it; "
        f"interior EPE {epe:.4f}; launches eager {per_pair}, a replay "
        f"{per_replay}")
    check(same, "upstream: the replayed flow differs from the eager one")
    check(bool(np.isfinite(flow).all()), "upstream: non-finite flow")
    # 2 x (1 init + 10 x (4 propagation rounds + 1 search)) in the
    # search, 2 fine levels x 9 candidates in the refine
    for counts in (per_pair, per_replay):
        check(counts.get("patchmatch_costs", 0) == 120,
              f"upstream: kernel E {counts.get('patchmatch_costs', 0)} "
              "launches a pair, expected 120")
        check(counts.get("weighted_median_filter", 0) == n,
              f"upstream: kernel C {counts.get('weighted_median_filter', 0)}"
              f" launches a pair, expected {n}")
        check(counts.get("flow_smoothing_paired", 0) == 3,
              "upstream: kernel B not 3 launches a pair")
        check(counts.get("exact_best_of", 0) == 0,
              "upstream: kernel F launched")
    log_capture(GRAPHS.entries[graph_key(img1, img2, ucfg, False, None,
                                         None)])

    # the tracer: the legacy order's marks inside the occlusion stage
    trace.enable()
    try:
        compute_flow_jit(img1, img2, cfg=ucfg)   # captures, replays
        trace.collect()
        traced = compute_flow_jit(img1, img2, cfg=ucfg)
        tr = trace.collect()
    finally:
        trace.disable()
    # a stage opens before the stages inside it (ids count up as marks
    # open), and may share its start stamp with the first of them
    stages = sorted((x for x in tr.spans if not x.host and x.name != "graph"),
                    key=lambda x: (x.start_ns, x.id))
    by = {x.name: x for x in stages}
    names = [x.name for x in stages]
    log("upstream traced replay: "
        + ", ".join(f"{x.name} {x.ms:.3f}" for x in stages) + " ms")
    check(bool(torch.equal(traced, eager)),
          "upstream: the traced replay's flow differs from the eager one")
    check(names[names.index("occlusion"):][:3]
          == ["occlusion", "occlusion.wmf", "occlusion.fill"]
          and by["occlusion.wmf"].parent == by["occlusion"].id
          and by["occlusion.fill"].parent == by["occlusion"].id,
          f"upstream: the occlusion marks are {names}")
    GRAPHS.clear()


def run_program(name: str, argv) -> list:
    """``eppm_tpu_torch.bench.<name>.main(argv)`` in this process, its
    standard output captured: each line logged and parsed as JSON; fails
    unless it exits 0."""
    import contextlib
    import importlib
    import io

    main = importlib.import_module(f"eppm_tpu_torch.bench.{name}").main
    buf = io.StringIO()
    t = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = main(list(argv))
    lines = buf.getvalue().splitlines()
    for line in lines:
        log(f"{name}: {line}")
    log(f"{name} {' '.join(argv)}: exit {rc}, "
        f"{time.perf_counter() - t:.1f} s")
    check(rc == 0, f"{name} {' '.join(argv)} exited {rc}")
    try:
        return [json.loads(line) for line in lines]
    except json.JSONDecodeError as e:
        raise SystemExit(f"FAIL: {name} printed a line that is not JSON: {e}")


def phase_programs(dev) -> None:
    """The stage profilers on the card (phase 8 of the docstring)."""
    log("== phase 8: the stage profilers (eppm_tpu_torch/bench)")
    torch.cuda.empty_cache()
    out = run_program("profile_stages", ["1080x1920"])
    summary = out[-1]
    check(summary["identical_to_untraced"] and summary["uncovered"] <= 0.01
          and abs(summary["graph_over_events"] - 1.0) <= 0.05
          and summary["untraced_nodes"]["mark"] == 0,
          f"profile_stages: {summary}")

    out = run_program("profile_match", ["1080x1920"])
    exact = [r["stage"].split(" (")[0] for r in out[:-1]
             if r["stage"].startswith("exact")]
    check(out[-1]["rows"] == len(out) - 1 and out[-1]["rows"] >= 15,
          f"profile_match: {out[-1]}")
    check(exact == [f"exact_best_of K={k}" for k in (1, 8, 4, 1)],
          f"profile_match's exact rows: {exact}")
    torch.cuda.empty_cache()


SOURCES = {  # name: (source, the TPU kernel it replaces, the path it runs on)
    "cost_terms": ("eppm_tpu_torch/csrc/cost.cu",
                   "eppm_tpu/ops/pallas_cost.py:173 (the AD + census terms; "
                   "also of :60)", "default"),
    "residual_costs": ("eppm_tpu_torch/csrc/cost.cu",
                       "eppm_tpu/ops/pallas_cost.py:173", "default"),
    "residual_costs_multiwarp": ("eppm_tpu_torch/csrc/cost.cu",
                                 "eppm_tpu/ops/pallas_cost.py:60", "default"),
    "flow_smoothing_paired": ("eppm_tpu_torch/csrc/smooth.cu",
                              "eppm_tpu/ops/pallas_smooth.py:38 (radius 10)",
                              "default"),
    "flow_smoothing": ("eppm_tpu_torch/csrc/smooth.cu",
                       "eppm_tpu/ops/pallas_smooth.py:38 (other radii)",
                       "radius 6"),
    "weighted_median_filter": ("eppm_tpu_torch/csrc/wmf.cu",
                               "eppm_tpu/ops/pallas_wmf.py:52 and :316 "
                               "(_wmf_kernel, _wmf_tile_kernel)", "default"),
    "residual_costs_planes": ("eppm_tpu_torch/csrc/cost.cu",
                              "eppm_tpu/ops/pallas_cost.py:60 "
                              "(plane tables, wrapper :389)", "planes"),
    "global_argmax": ("eppm_tpu_torch/csrc/match.cu",
                      "eppm_tpu/ops/pallas_match.py:40", "match_coarse"),
    "patchmatch_costs": ("eppm_tpu_torch/csrc/patchmatch.cu",
                         "none: the JAX package computes this cost in XLA "
                         "(eppm_tpu/ops/cost.py::_patch_cost_offsets)",
                         "patchmatch"),
    "exact_best_of": ("eppm_tpu_torch/csrc/exact.cu",
                      "none: the JAX package computes this stage in XLA "
                      "(eppm_tpu/ops/match.py::_polish_direction)",
                      "default"),
}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    t0 = time.perf_counter()
    dev = torch.device("cuda", 0)

    def timed(phase, *args):
        t = time.perf_counter()
        out = phase(*args)
        log(f"{phase.__name__}: {time.perf_counter() - t:.1f} s")
        return out

    smi = timed(phase_versions)
    timed(phase_build)
    rows = timed(phase_kernels, dev)
    launches = timed(phase_end_to_end, dev)
    timed(phase_agreement, dev)
    timed(phase_dossier, dev)
    timed(phase_graphs, dev)
    timed(phase_programs, dev)
    timed(phase_upstream, dev)
    kernels = []
    for name, (source, replaces, path) in SOURCES.items():
        r = rows[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[path][name],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            **{k: r[k] for k in ("call_ms", "ops_bound_ms", "ms_basis",
                                 "arbitrate") if k in r},
        })
    log(f"chip_smoke: {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(smi)  # name, power limit: as nvidia-smi prints them
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
