"""The sub-stages of the port's coarse matcher (counterpart of the JAX
package's ``tools/profile_match.py``).

    python -m eppm_tpu_torch.bench.profile_match [HxW] [--seed N]

``match_stages`` times, on the coarse level of ``prepare_pyramids``, the
default path's coarse match whole (``match_coarse_bidi``), then the JAX
tool's rows on the port's functions of the same names (``ops/match.py``,
``ops/cost.py``, ``ops/dense.py``), one direction: the mini-pyramids of
both frames; the tiny level's descriptors and ``global_match`` (kernel
D) and its descent; each ``descend_level`` down the mini-pyramid; the
coarse descriptors at the config's stride and their ``global_match``
(kernel D); ``rescore`` of one field; ``propagate_dense`` (kernel A's
multiwarp form); the final descent; and the exact stage's
``make_patch_stack``, ``patch_cost_stack`` at K=1 and on the polish
ring.  The tiny rows exist where the coarse level has mini levels below
it.  The pair is ``testing.shifted_pair(h, w, 5, 3)``, 1080x1920 by
default.

On the card each row is a CUDA graph timed over 5 replays
(``_timing.StageTimer``), one JSON line a row (median, least, most ms,
outputs' shapes), then a summary line; with ``--device cpu`` the rows
hold the shapes and no time.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from typing import Callable, List, Optional

import torch

from ..config import DEFAULT_CONFIG, EPPMConfig
from ..graphs import GRAPHS
from ..ops._util import grid
from ..ops.cost import make_patch_stack, patch_cost_stack
from ..ops.dense import center_out_offsets
from ..ops.match import (_as_flow, _int_flow, _make_mini_cost, _mini_levels,
                         _mini_pyramid, descend_level, global_match,
                         match_coarse_bidi, patch_descriptors,
                         propagate_dense, rescore)
from ..ops.resize import bilinear_resize
from ..pipeline import prepare_pyramids
from ..testing import shifted_pair
from . import _timing as T


def match_stages(img1: torch.Tensor, img2: torch.Tensor, cfg: EPPMConfig,
                 run: Callable) -> None:
    """The coarse matcher's rows (see the module's docstring), each as
    ``run(name, fn, *args)``, which returns ``fn(*args)``; what flows
    from row to row between them is computed outside the rows."""
    mcfg, chunk = cfg.match, cfg.cost_tap_chunk
    levels1, packs1 = prepare_pyramids(img1, cfg)
    levels2, packs2 = prepare_pyramids(img2, cfg)
    l1, l2, p1, p2 = levels1[-1], levels2[-1], packs1[-1], packs2[-1]
    ch, cw = p1.shape[:2]
    run(f"match_coarse_bidi (whole, both directions, {ch}x{cw})",
        lambda a, b, q1, q2: match_coarse_bidi(a, b, cfg.cost, mcfg, q1, q2,
                                               tap_chunk=chunk),
        l1, l2, p1, p2)

    n = _mini_levels(ch, cw, mcfg)
    mini1, mini2 = run("mini_pyramid x2", lambda a, b, q1, q2: (
        _mini_pyramid(a, n, pack0=q1), _mini_pyramid(b, n, pack0=q2)),
        l1, l2, p1, p2)
    mini_cost = _make_mini_cost(cfg.cost, mcfg)
    if n > 0:
        tiny1, tiny2 = mini1[-1], mini2[-1]
        th, tw = tiny1.shape[:2]
        d1, d2 = run(f"tiny descriptors x2 ({th}x{tw})", lambda a, b: (
            patch_descriptors(a, mcfg), patch_descriptors(b, mcfg)),
            tiny1, tiny2)
        t_y, t_x = run("tiny global_match", lambda a, b: global_match(
            a, b, mcfg.global_block), d1, d2)
        ys, xs = grid(th, tw, t_y.device)
        flow, _ = run(f"tiny descend_level r={mcfg.descent_radius}",
                      lambda a, b, f: descend_level(
                          a, b, f, mcfg.descent_radius, mini_cost, chunk),
                      tiny1, tiny2, _as_flow(t_x - xs, t_y - ys))
        for lvl in range(n - 1, -1, -1):
            oh, ow = mini1[lvl].shape[:2]
            cc = cfg.cost if lvl == 0 else mini_cost
            flow = bilinear_resize(flow, oh, ow, 2.0) * 2.0
            flow, _ = run(f"descend L{lvl} ({oh}x{ow})",
                          lambda a, b, f: descend_level(
                              a, b, f, mcfg.descent_radius, cc, chunk),
                          mini1[lvl], mini2[lvl], flow)
    else:
        flow = torch.zeros((ch, cw, 2), dtype=torch.float32, device=p1.device)

    s = 2 if ch * cw > mcfg.global_stride_threshold else 1
    dc1, dc2 = run(f"coarse descriptors x2 (stride {s})", lambda a, b: (
        patch_descriptors(a, mcfg, stride=s),
        patch_descriptors(b, mcfg, stride=s)), p1, p2)
    run("coarse global_match", lambda a, b: global_match(
        a, b, mcfg.global_block), dc1, dc2)
    zero = torch.zeros((ch, cw), dtype=torch.int32, device=p1.device)
    run("coarse rescore (one field)", lambda a, b, gy, gx: rescore(
        a, b, gy, gx, cfg.cost, chunk), p1, p2, zero, zero)
    gy, gx = _int_flow(flow)
    cost0 = rescore(p1, p2, gy, gx, cfg.cost, chunk)
    run(f"propagate_dense {mcfg.prop_steps}",
        lambda a, b, f, c: propagate_dense(a, b, f, c, mcfg.prop_steps,
                                           cfg.cost, chunk),
        p1, p2, flow, cost0)
    run(f"final descend r={mcfg.final_radius}", lambda a, b, f: descend_level(
        a, b, f, mcfg.final_radius, cfg.cost, chunk), p1, p2, flow)

    exact_cfg = dataclasses.replace(cfg.cost,
                                    patch_stride=mcfg.exact_tap_stride)
    offs2 = exact_cfg.tap_offsets
    stack2 = run("exact: make_patch_stack", lambda b: make_patch_stack(
        b, offs2, dtype=torch.bfloat16), p2)
    ys, xs = grid(ch, cw, p1.device)
    tx, ty = (xs + gx)[None], (ys + gy)[None]
    run("exact: patch_cost_stack K=1", lambda a, st, x, y: patch_cost_stack(
        a, st, x, y, exact_cfg, offs2), p1, stack2, tx, ty)
    k = sum(1 for o in center_out_offsets(mcfg.exact_polish_radius)
            if o != (0, 0))
    run(f"exact: patch_cost_stack K={k} (ring)",
        lambda a, st, x, y: patch_cost_stack(a, st, x, y, exact_cfg, offs2),
        p1, stack2, tx.expand(k, ch, cw).contiguous(),
        ty.expand(k, ch, cw).contiguous())


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m eppm_tpu_torch.bench.profile_match",
        description=__doc__.split("\n\n")[0])
    p.add_argument("size", nargs="?", default="1080x1920", help="HxW")
    T.add_common(p)
    args = p.parse_args(argv)
    device = T.device_of(args.device)
    h, w = T.parse_size(args.size)
    cfg = DEFAULT_CONFIG
    GRAPHS.clear()
    img1, img2 = T.frames(shifted_pair(h, w, 5, 3, args.seed), device)

    timer = T.StageTimer(device)
    match_stages(img1, img2, cfg, timer)
    for row in timer.rows:
        print(json.dumps(row.line()), flush=True)
    top = cfg.pyramid.level_dims(h, w)[-1]
    print(json.dumps({"program": "profile_match", "shape": [h, w],
                      "coarse": list(top), "rows": len(timer.rows),
                      "device": T.card_label(device), "pairs":
                      f"synthetic (testing.shifted_pair, seed {args.seed})"}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
