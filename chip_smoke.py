#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``eppm_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each of which must pass (any failure exits non-zero and the
final line is not printed):

1. versions: torch, CUDA, nvcc, and the card's name and power limit;
2. build: the three CUDA kernels, from ``eppm_tpu_torch/csrc``;
3. kernels against their plain PyTorch versions, on the card, at the
   shapes the main path gives them (tolerances of ``tools/tpu_check.py``:
   cost max |diff| <= 1e-4, smoothing <= 1e-3, WMF < 0.5% of pixels
   choosing another target), with each one's time beside the plain
   version's (CUDA events, after a warm-up);
4. end to end: ``EPPMFlow`` under ``DEFAULT_CONFIG`` at 640x480 and
   1920x1080 on synthetic pairs with a known integer translation (a small
   and a large one at each size): finite flow, warp error below 0.6x the
   zero-flow baseline, interior EPE against the known shift, and every
   kernel's launch count over these runs > 0;
5. agreement: the port on the card against the port on the CPU (plain
   versions) at 192x256, at least 98% of pixels within 1e-3 and mean
   |diff| < 0.05.

The line before the last is one JSON object with a row per kernel; the
last line is ``{"ok": true, "device": {...}}``.  The synthetic pairs are
smooth textures made from a seed with numpy; no frame file is read.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

SEED = 0


def log(*args):
    print(*args, flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SystemExit(f"FAIL: {what}")


def texture(h: int, w: int, seed: int) -> np.ndarray:
    """Smooth float32 RGB texture in [0, 1]: seeded noise on a grid 8x
    coarser, upsampled bicubically."""
    rng = np.random.default_rng(seed)
    small = torch.from_numpy(
        rng.random((3, h // 8 + 3, w // 8 + 3)).astype(np.float32))
    big = torch.nn.functional.interpolate(
        small[None], size=(8 * (h // 8 + 3), 8 * (w // 8 + 3)),
        mode="bicubic", align_corners=False)[0]
    return big.clamp(0, 1)[:, :h, :w].permute(1, 2, 0).numpy()


def shifted_pair(h: int, w: int, dx: int, dy: int, seed: int):
    """uint8 (frame1, frame2) with frame1(p) = frame2(p + (dx, dy)): the
    true flow from frame 1 to frame 2 is (dx, dy) wherever p + (dx, dy)
    lies in the frame."""
    m = max(abs(dx), abs(dy)) + 8
    big = (texture(h + 2 * m, w + 2 * m, seed) * 255).astype(np.uint8)
    f2 = big[m : m + h, m : m + w]
    f1 = big[m + dy : m + dy + h, m + dx : m + dx + w]
    return np.ascontiguousarray(f1), np.ascontiguousarray(f2)


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of fn() in ms over ``reps`` runs after a warm-up."""
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


def phase_kernels(dev) -> dict:
    """Each kernel against its plain version at main-path shapes."""
    log("== phase 3: kernels against their plain versions")
    from eppm_tpu_torch.config import DEFAULT_CONFIG as cfg
    from eppm_tpu_torch.config import INVALID_LOCATION, UNKNOWN_FLOW
    from eppm_tpu_torch.ops import cuda_cost, cuda_smooth, cuda_wmf
    from eppm_tpu_torch.ops._util import grid
    from eppm_tpu_torch.ops.dense import center_out_offsets, warp_pack
    from eppm_tpu_torch.ops.match import _make_mini_cost
    from eppm_tpu_torch.ops.refine import fill_holes

    rows = {}

    def record(name, err, ms, plain_ms):
        row = rows.setdefault(name, {"max_abs_err": 0.0})
        row["max_abs_err"] = max(row["max_abs_err"], err)
        row["ms"], row["plain_ms"] = ms, plain_ms

    mini = _make_mini_cost(cfg.cost, cfg.match)
    cases = [  # (h, w, candidates, cost config) of the main path
        (60, 80, center_out_offsets(3), mini),
        (120, 160, center_out_offsets(3), cfg.cost),
        (480, 640, center_out_offsets(1), cfg.cost),
        (480, 640, center_out_offsets(1), cfg.pass2_cost),
        (1080, 1920, center_out_offsets(1), cfg.pass2_cost),
        (1080, 1920, center_out_offsets(1), cfg.cost),
    ]
    for h, w, cands, ccfg in cases:
        (_, p1), (_, p2) = _packs(h, w, 3, -2, SEED, dev)
        g = torch.full((h, w), 2, dtype=torch.int32, device=dev)
        warped = warp_pack(p2, g + 1, -g)
        k = cuda_cost.residual_costs_cuda(p1, warped, cands, ccfg)
        ref = cuda_cost.residual_costs(p1, warped, cands, ccfg)
        err = float((k - ref).abs().max())
        differ = float((k != ref).float().mean())
        reps = 20 if h * w < 300_000 else 5
        ms = cuda_ms(lambda: cuda_cost.residual_costs_cuda(
            p1, warped, cands, ccfg), reps)
        pms = cuda_ms(lambda: cuda_cost.residual_costs(
            p1, warped, cands, ccfg), max(1, reps // 5))
        log(f"cost   {h}x{w} K={len(cands)} taps={len(ccfg.tap_offsets)}: "
            f"max|diff| {err:.3g} ({differ:.2%} differ)  kernel {ms:.3f} ms  "
            f"plain {pms:.3f} ms")
        check(err <= 1e-4, f"kernel A cost diff {err} > 1e-4")
        record("residual_costs", err, ms, pms)

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
        k = cuda_cost.residual_costs_multiwarp_cuda(p1, stack, cfg.cost)
        ref = cuda_cost.residual_costs_multiwarp(p1, stack, cfg.cost)
        err = float((k - ref).abs().max())
        ms = cuda_ms(lambda: cuda_cost.residual_costs_multiwarp_cuda(
            p1, stack, cfg.cost), 20)
        pms = cuda_ms(lambda: cuda_cost.residual_costs_multiwarp(
            p1, stack, cfg.cost), 4)
        log(f"cost multiwarp {h}x{w} K=5: max|diff| {err:.3g}  "
            f"kernel {ms:.3f} ms  plain {pms:.3f} ms")
        check(err <= 1e-4, f"kernel A multiwarp diff {err} > 1e-4")
        record("residual_costs_multiwarp", err, ms, pms)

    for h, w in [(480, 640), (1080, 1920)]:
        (img, _), _ = _packs(h, w, 3, -2, SEED + 2, dev)
        rng = np.random.default_rng(SEED + 2)
        flow = torch.from_numpy(
            (rng.random((h, w, 2)) * 6 - 3).astype(np.float32)).to(dev)
        flow[h // 4 : h // 2, w // 4 : w // 3] = UNKNOWN_FLOW
        k = cuda_smooth.flow_smoothing_cuda(flow, img, cfg.refine)
        ref = cuda_smooth.flow_smoothing(flow, img, cfg.refine)
        err = float((k - ref).abs().max())
        ms = cuda_ms(lambda: cuda_smooth.flow_smoothing_cuda(
            flow, img, cfg.refine), 10)
        pms = cuda_ms(lambda: cuda_smooth.flow_smoothing(
            flow, img, cfg.refine), 2)
        log(f"smooth {h}x{w}: max|diff| {err:.3g}  kernel {ms:.3f} ms  "
            f"plain {pms:.3f} ms")
        check(err <= 1e-3, f"kernel B smoothing diff {err} > 1e-3")
        record("flow_smoothing", err, ms, pms)

    for h, w in [(120, 160), (135, 240)]:
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
        fill = fill_holes(tx, ty, img)
        modes = [  # (label, kwargs): the polish mode and Jacobi iterations
            ("polish d=1", dict(only_occlusion=True, polish_init=fill)),
            ("jacobi x3 d=2", dict(num_iter=3, only_occlusion=True,
                                   dilation=2)),
        ]
        for label, kw in modes:
            k = cuda_wmf.weighted_median_filter_cuda(tx, ty, img, cfg.refine,
                                                     **kw)
            ref = cuda_wmf.weighted_median_filter(tx, ty, img, cfg.refine,
                                                  **kw)
            diff = torch.maximum((k[0] - ref[0]).abs(), (k[1] - ref[1]).abs())
            err = float(diff.max())
            mismatch = float((diff > 0).float().mean())
            ms = cuda_ms(lambda: cuda_wmf.weighted_median_filter_cuda(
                tx, ty, img, cfg.refine, **kw), 10)
            pms = cuda_ms(lambda: cuda_wmf.weighted_median_filter(
                tx, ty, img, cfg.refine, **kw), 2)
            log(f"wmf {label} {h}x{w}: {mismatch:.3%} of pixels differ "
                f"(max {err:.0f} px)  kernel {ms:.3f} ms  plain {pms:.3f} ms")
            check(mismatch < 0.005, f"kernel C mismatch {mismatch:.3%}")
            if label.startswith("polish"):
                record("weighted_median_filter", err, ms, pms)
            else:
                rows["weighted_median_filter"]["max_abs_err"] = max(
                    rows["weighted_median_filter"]["max_abs_err"], err)
    torch.cuda.synchronize()
    return rows


def interior_epe(flow: np.ndarray, dx: int, dy: int, margin: int) -> float:
    """Mean endpoint error against the known shift over pixels whose
    target lies in the frame, ``margin`` px away from every border."""
    h, w = flow.shape[:2]
    ys, xs = np.mgrid[0:h, 0:w]
    inside = ((xs + dx >= margin) & (xs + dx < w - margin)
              & (ys + dy >= margin) & (ys + dy < h - margin)
              & (xs >= margin) & (xs < w - margin)
              & (ys >= margin) & (ys < h - margin))
    err = np.hypot(flow[..., 0] - dx, flow[..., 1] - dy)
    return float(err[inside].mean())


def phase_end_to_end(dev) -> dict:
    log("== phase 4: end to end (EPPMFlow, DEFAULT_CONFIG, synthetic pairs)")
    from eppm_tpu_torch.metrics import warp_error
    from eppm_tpu_torch.ops import cuda_cost, cuda_smooth, cuda_wmf
    from eppm_tpu_torch.pipeline import EPPMFlow

    counters = {
        "residual_costs": cuda_cost.SINGLE,
        "residual_costs_multiwarp": cuda_cost.MULTIWARP,
        "flow_smoothing": cuda_smooth.KERNEL,
        "weighted_median_filter": cuda_wmf.KERNEL,
    }
    cases = [  # (h, w, dx, dy, seed): a small and a large translation
        (480, 640, 3, -2, SEED + 10),
        (480, 640, 37, 21, SEED + 11),
        (1080, 1920, 5, 3, SEED + 12),
        (1080, 1920, -70, 44, SEED + 13),
    ]
    model = EPPMFlow()
    for c in counters.values():
        c.launches = 0
    for h, w, dx, dy, seed in cases:
        f1, f2 = shifted_pair(h, w, dx, dy, seed)
        img1 = torch.from_numpy(f1).to(dev)
        img2 = torch.from_numpy(f2).to(dev)
        model(img1, img2)  # first run: allocator and library warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        flow = model(img1, img2)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
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
            f"(ratio {we / we0:.3f})  interior EPE {epe:.4f}")
        check(we < 0.6 * we0, f"warp error {we:.4f} >= 0.6 x {we0:.4f}")
    launches = {name: c.launches for name, c in counters.items()}
    log(f"launches over the end-to-end runs: {launches}")
    for name, n in launches.items():
        check(n > 0, f"kernel {name} was not launched on the main path")
    return launches


def phase_agreement(dev) -> None:
    log("== phase 5: the port on the card against the port on the CPU")
    from eppm_tpu_torch.pipeline import compute_flow

    h, w = 192, 256
    f1, f2 = shifted_pair(h, w, 3, -2, SEED + 20)
    gpu = compute_flow(torch.from_numpy(f1).to(dev),
                       torch.from_numpy(f2).to(dev)).cpu().numpy()
    cpu = compute_flow(torch.from_numpy(f1), torch.from_numpy(f2)).numpy()
    d = np.abs(gpu - cpu).max(axis=-1)
    agree = float((d < 1e-3).mean())
    log(f"192x256: {agree:.4%} of pixels agree within 1e-3, "
        f"mean |diff| {float(d.mean()):.3g}, max {float(d.max()):.3g}")
    check(agree >= 0.98, f"only {agree:.2%} of pixels agree")
    check(float(d.mean()) < 0.05, f"mean |diff| {float(d.mean())}")


SOURCES = {
    "residual_costs": ("eppm_tpu_torch/csrc/cost.cu",
                       "eppm_tpu/ops/pallas_cost.py:173"),
    "residual_costs_multiwarp": ("eppm_tpu_torch/csrc/cost.cu",
                                 "eppm_tpu/ops/pallas_cost.py:60"),
    "flow_smoothing": ("eppm_tpu_torch/csrc/smooth.cu",
                       "eppm_tpu/ops/pallas_smooth.py:38"),
    "weighted_median_filter": ("eppm_tpu_torch/csrc/wmf.cu",
                               "eppm_tpu/ops/pallas_wmf.py:52"),
}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    import eppm_tpu_torch  # noqa: F401  (fails outside a checkout)

    dev = torch.device("cuda", 0)
    smi = phase_versions()
    phase_build()
    rows = phase_kernels(dev)
    launches = phase_end_to_end(dev)
    phase_agreement(dev)
    kernels = []
    for name, (source, replaces) in SOURCES.items():
        r = rows[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"],
        })
    print(json.dumps({"kernels": kernels}))
    print(smi)  # name, power limit: as nvidia-smi prints them
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
