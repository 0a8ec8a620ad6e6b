"""The time of each stage of the port's pipeline (counterpart of the JAX
package's ``profile_stages.py``).

    python -m eppm_tpu_torch.bench.profile_stages [HxW] [--set k=v]
        [--seed N]

``stages`` runs the stages ``pipeline.compute_flow`` runs under the
config, in its order, each through a stage runner: prepare_pyramids of
both frames; the coarse match (``match_coarse_bidi``, or under
``match_engine=patchmatch`` both PatchMatch directions drawing from the
default key, made outside the stage as ``compute_flow_jit`` makes it);
``lr_check``, ``outlier_removal``, ``coarse_occlusion_reconstruct``;
then at each finer level the upsample, refine pass 1, the median and
pass 2 (or the gathered refine), the smoothing; then the optional
subpixel stage and the final smoothing.  On the CPU its flow is
``compute_flow``'s, bit for bit.

On the card each stage is a CUDA graph timed over 5 replays
(``_timing.StageTimer``), and right after it 2 replays of the whole
pair (``compute_flow_jit``, captured first); one JSON line a stage
(median, least, most ms, outputs' shapes, the pair's median beside it
and the stage's share of it), a ``FULL compute_flow_jit`` line (all the
pair's replays), then a summary line: the sum of the stages' medians
beside FULL's, and the sum of the shares.  It exits 1 unless the shares
sum to within 10% of 1 and the stages' flow equals the replayed pair's.
Each share is taken against the pair timed within a second of it: the
card's speed can change by ~15% for seconds at a time (the same graph
replayed in 166.7 and in 191.5 ms), which would otherwise count as a
missing or a doubled stage.  The pair is ``testing.shifted_pair(h, w,
5, 3)``, 1080x1920 by default.  With ``--device cpu`` the lines hold the
stages' shapes and no time, and the summary whether the flow equals
``compute_flow``'s.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
from typing import Callable, List, Optional

import torch

from ..cli import apply_overrides
from ..config import DEFAULT_CONFIG, EPPMConfig
from ..graphs import GRAPHS
from ..ops.cuda_smooth import flow_smoothing_auto
from ..ops.dense import dense_refine_flow, median3_flow
from ..ops.match import match_coarse_bidi
from ..ops.occlusion import coarse_occlusion_reconstruct
from ..ops.patchmatch import ThreefrySampler, patchmatch
from ..ops.prng import prng_key, split
from ..ops.refine import (blf_refine_flow, lr_check, nnf_to_flow,
                          outlier_removal)
from ..ops.resize import bilinear_resize
from ..ops.subpixel import subpixel_refine
from ..pipeline import compute_flow, compute_flow_jit, prepare_pyramids
from ..testing import shifted_pair
from . import _timing as T

# the stages' shares of the replayed pair may sum to 1 +- this at most
SUM_TOLERANCE = 0.10
# replays of the whole pair timed after each stage's
FULL_REPS = 2


def stages(img1: torch.Tensor, img2: torch.Tensor, cfg: EPPMConfig,
           run: Callable) -> torch.Tensor:
    """``compute_flow(img1, img2, cfg)`` stage by stage, each stage as
    ``run(name, fn, *args)``, which returns ``fn(*args)``."""
    chunk = cfg.cost_tap_chunk
    (levels1, packs1), (levels2, packs2) = run(
        "prepare_pyramids x2",
        lambda a, b: (prepare_pyramids(a, cfg), prepare_pyramids(b, cfg)),
        img1, img2)
    top = len(packs1) - 1
    ch, cw = packs1[top].shape[:2]
    if cfg.match_engine == "dense":
        fwd, bwd = run(
            f"match_coarse_bidi ({ch}x{cw})",
            lambda l1, l2, p1, p2: match_coarse_bidi(
                l1, l2, cfg.cost, cfg.match, p1, p2, tap_chunk=chunk),
            levels1[top], levels2[top], packs1[top], packs2[top])
    else:
        def both(p1, p2, key):
            s1, s2 = (ThreefrySampler(k) for k in split(key))
            return (patchmatch(p1, p2, s1, cfg.patchmatch, cfg.cost, chunk),
                    patchmatch(p2, p1, s2, cfg.patchmatch, cfg.cost, chunk))

        fwd, bwd = run(f"patchmatch x2 ({ch}x{cw})", both, packs1[top],
                       packs2[top], prng_key(cfg.seed, img1.device))
    otx, oty = fwd[0], fwd[1]  # pre-LR matches: arbitration candidates
    tx1, ty1, c1, *_ = run(
        "lr_check", lambda *a: lr_check(*a, cfg.lr_thresh), *fwd, *bwd)
    tx1, ty1, c1 = run("outlier_removal",
                       lambda *a: outlier_removal(*a, cfg.refine),
                       tx1, ty1, c1)
    flow = run(
        "coarse_occlusion_reconstruct + nnf_to_flow",
        lambda tx, ty, img, p1, p2, ox, oy: nnf_to_flow(
            *coarse_occlusion_reconstruct(
                tx, ty, img, cfg.refine, packs=(p1, p2), cost_cfg=cfg.cost,
                orig=(ox, oy))),
        tx1, ty1, levels1[top], packs1[top], packs2[top], otx, oty)

    ratio_up = 1.0 / cfg.pyramid.ratio
    for lvl in range(top - 1, -1, -1):
        oh, ow = packs1[lvl].shape[0], packs1[lvl].shape[1]
        at = f"L{lvl} ({oh}x{ow})"
        flow = run(f"upsample -> {at}", lambda f: bilinear_resize(
            f, oh, ow, ratio_up) * ratio_up, flow)
        p1, p2 = packs1[lvl], packs2[lvl]
        if cfg.refine_impl == "dense":
            n = cfg.dense_refine_passes
            fit = cfg.dense_subpixel_fit and lvl == 0
            flow = run(f"dense_refine {at} pass 1", lambda f, a, b: (
                dense_refine_flow(
                    f, a, b, cfg.cost, cfg.dense_search_radius,
                    cfg.dense_cand_shape, cfg.warp_dtype,
                    cfg.dense_pass1_planes, subpixel_fit=fit and n == 1,
                    subpixel_min_curv=cfg.dense_subpixel_min_curv,
                    tap_chunk=chunk)), flow, p1, p2)
            for i in range(n - 1):
                flow = run(f"dense_refine {at} pass {i + 2} (+median)",
                           lambda f, a, b: dense_refine_flow(
                               median3_flow(f), a, b, cfg.pass2_cost,
                               cfg.dense_search_radius, cfg.pass2_cand_shape,
                               cfg.warp_dtype, cfg.dense_pass2_planes,
                               subpixel_fit=fit and i == n - 2,
                               subpixel_min_curv=cfg.dense_subpixel_min_curv,
                               tap_chunk=chunk), flow, p1, p2)
        else:
            flow = run(f"blf_refine_flow {at}", lambda f, a, b:
                       blf_refine_flow(f, a, b, cfg.cost, chunk), flow, p1, p2)
        flow = run(f"flow_smoothing {at}", lambda f, img:
                   flow_smoothing_auto(f, img, cfg.refine), flow, levels1[lvl])
    if cfg.subpixel_refine:
        flow = run("subpixel_refine", lambda f, a, b: subpixel_refine(
            f, a, b, cfg.subpixel), flow, levels1[0], levels2[0])
    return run("flow_smoothing final L0", lambda f, img: flow_smoothing_auto(
        f, img, cfg.refine), flow, levels1[0])


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m eppm_tpu_torch.bench.profile_stages",
        description=__doc__.split("\n\n")[0])
    p.add_argument("size", nargs="?", default="1080x1920", help="HxW")
    T.add_common(p, sets=True)
    args = p.parse_args(argv)
    device = T.device_of(args.device)
    cfg = apply_overrides(DEFAULT_CONFIG, args.sets)
    h, w = T.parse_size(args.size)
    GRAPHS.clear()
    img1, img2 = T.frames(shifted_pair(h, w, 5, 3, args.seed), device)

    timer = T.StageTimer(device)
    out = {"program": "profile_stages", "shape": [h, w],
           "device": T.card_label(device),
           "pairs": f"synthetic (testing.shifted_pair, seed {args.seed})",
           "overrides": list(args.sets)}
    if device.type != "cuda":
        flow = stages(img1, img2, cfg, timer)
        for row in timer.rows:
            print(json.dumps(row.line()))
        same = bool(torch.equal(flow, compute_flow(img1, img2, cfg)))
        out.update(stages=len(timer.rows), identical_to_compute_flow=same)
        print(json.dumps(out))
        return 0 if same else 1

    full = compute_flow_jit(img1, img2, cfg=cfg)  # the pair's graph
    full_ms: List[List[float]] = []

    def run(name, fn, *args):
        result = timer(name, fn, *args)
        with T.window("profile_stages FULL"):
            full_ms.append(T.event_ms(
                lambda: compute_flow_jit(img1, img2, cfg=cfg), FULL_REPS))
        return result

    flow = stages(img1, img2, cfg, run)
    shares = []
    for row, f in zip(timer.rows, full_ms):
        shares.append(statistics.median(row.ms) / statistics.median(f))
        print(json.dumps({**row.line(), "full_median_ms": statistics.median(
            f), "share": shares[-1]}), flush=True)
    every = [m for f in full_ms for m in f]
    print(json.dumps({"stage": "FULL compute_flow_jit", **T.summary(every)}))
    same = bool(torch.equal(flow, full))
    out.update(stages=len(timer.rows),
               sum_ms=sum(statistics.median(r.ms) for r in timer.rows),
               full_ms=statistics.median(every), sum_over_full=sum(shares),
               identical_to_full=same)
    ok = same and abs(sum(shares) - 1.0) <= SUM_TOLERANCE
    if not ok:
        out["error"] = ("the stages' flow differs from the replayed pair's"
                        if not same else
                        f"the stages' shares of the pair sum to "
                        f"{sum(shares):.3f}, not within {SUM_TOLERANCE:.0%} "
                        "of 1")
    print(json.dumps(out))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
