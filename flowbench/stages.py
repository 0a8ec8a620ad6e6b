"""The port's pipeline stage by stage, each stage timed from outside as a
CUDA graph of its own: the spans of the traced run.

``stages`` runs what ``eppm_tpu_torch.pipeline.compute_flow`` runs under
the cell's configuration, in its order, each stage through
``run(name, fn, *args)`` (a copy of ``eppm_tpu_torch/bench/
profile_stages.py::stages``, with the warm start of the temporal cell
added).  The names are the readers' keys:

  ``prepare`` (both frames), ``match`` (the coarse match: the dense
  engine's ``match_coarse_bidi``, warm-started from the resized init
  flow where one is given, or both PatchMatch searches on the default
  key's halves), ``lr_check``, ``outliers``, ``occlusion`` (the
  occlusion chain and the NNF's flow), then at each finer level ``l``:
  ``L<l>.upsample``, ``L<l>.pass1``, ``L<l>.pass2`` (the median and the
  second pass; ``pass<n>`` for further ones) or ``L<l>.gather_refine``,
  ``L<l>.smooth``; then ``subpixel`` where configured and
  ``final_smooth``.

``GraphTimer`` (the arithmetic of ``bench/_timing.py::StageTimer``):
static copies of a stage's tensor arguments, an eager warm-up call on a
side stream, the capture of the same call into a graph of its own, one
replay to warm, then ``reps`` replays each between two CUDA events; the
outputs are cloned and the graph dropped.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

import torch

__all__ = ["stages", "GraphTimer"]


def stages(img1, img2, cfg, run: Callable,
           init_flow: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``compute_flow(img1, img2, cfg, init_flow=init_flow)`` of the port,
    stage by stage; returns the flow."""
    from eppm_tpu_torch.ops.cuda_smooth import flow_smoothing_auto
    from eppm_tpu_torch.ops.dense import dense_refine_flow, median3_flow
    from eppm_tpu_torch.ops.match import match_coarse_bidi
    from eppm_tpu_torch.ops.occlusion import coarse_occlusion_reconstruct
    from eppm_tpu_torch.ops.patchmatch import ThreefrySampler, patchmatch
    from eppm_tpu_torch.ops.prng import prng_key, split
    from eppm_tpu_torch.ops.refine import (blf_refine_flow, lr_check,
                                           nnf_to_flow, outlier_removal)
    from eppm_tpu_torch.ops.resize import bilinear_resize
    from eppm_tpu_torch.ops.subpixel import subpixel_refine
    from eppm_tpu_torch.pipeline import _coarse_init, prepare_pyramids

    chunk = cfg.cost_tap_chunk
    (levels1, packs1), (levels2, packs2) = run(
        "prepare",
        lambda a, b: (prepare_pyramids(a, cfg), prepare_pyramids(b, cfg)),
        img1, img2)
    top = len(packs1) - 1
    ch, cw = packs1[top].shape[:2]
    if cfg.match_engine == "dense":
        def dense(l1, l2, p1, p2, init):
            ci = None if init is None else _coarse_init(
                init.to(torch.float32), ch, cw)
            return match_coarse_bidi(l1, l2, cfg.cost, cfg.match, p1, p2,
                                     init_flow=ci, tap_chunk=chunk)

        fwd, bwd = run("match", dense, levels1[top], levels2[top],
                       packs1[top], packs2[top], init_flow)
    else:
        def both(p1, p2, key):
            s1, s2 = (ThreefrySampler(k) for k in split(key))
            return (patchmatch(p1, p2, s1, cfg.patchmatch, cfg.cost, chunk),
                    patchmatch(p2, p1, s2, cfg.patchmatch, cfg.cost, chunk))

        fwd, bwd = run("match", both, packs1[top], packs2[top],
                       prng_key(cfg.seed, img1.device))
    otx, oty = fwd[0], fwd[1]
    tx1, ty1, c1, *_ = run(
        "lr_check", lambda *a: lr_check(*a, cfg.lr_thresh), *fwd, *bwd)
    tx1, ty1, c1 = run("outliers",
                       lambda *a: outlier_removal(*a, cfg.refine),
                       tx1, ty1, c1)
    flow = run(
        "occlusion",
        lambda tx, ty, img, p1, p2, ox, oy: nnf_to_flow(
            *coarse_occlusion_reconstruct(
                tx, ty, img, cfg.refine, packs=(p1, p2), cost_cfg=cfg.cost,
                orig=(ox, oy))),
        tx1, ty1, levels1[top], packs1[top], packs2[top], otx, oty)

    ratio_up = 1.0 / cfg.pyramid.ratio
    for lvl in range(top - 1, -1, -1):
        oh, ow = packs1[lvl].shape[0], packs1[lvl].shape[1]
        at = f"L{lvl}"
        flow = run(f"{at}.upsample", lambda f: bilinear_resize(
            f, oh, ow, ratio_up) * ratio_up, flow)
        p1, p2 = packs1[lvl], packs2[lvl]
        if cfg.refine_impl == "dense":
            n = cfg.dense_refine_passes
            fit = cfg.dense_subpixel_fit and lvl == 0
            flow = run(f"{at}.pass1", lambda f, a, b: dense_refine_flow(
                f, a, b, cfg.cost, cfg.dense_search_radius,
                cfg.dense_cand_shape, cfg.warp_dtype, cfg.dense_pass1_planes,
                subpixel_fit=fit and n == 1,
                subpixel_min_curv=cfg.dense_subpixel_min_curv,
                tap_chunk=chunk), flow, p1, p2)
            for i in range(n - 1):
                flow = run(f"{at}.pass{i + 2}",
                           lambda f, a, b: dense_refine_flow(
                               median3_flow(f), a, b, cfg.pass2_cost,
                               cfg.dense_search_radius, cfg.pass2_cand_shape,
                               cfg.warp_dtype, cfg.dense_pass2_planes,
                               subpixel_fit=fit and i == n - 2,
                               subpixel_min_curv=cfg.dense_subpixel_min_curv,
                               tap_chunk=chunk), flow, p1, p2)
        else:
            flow = run(f"{at}.gather_refine", lambda f, a, b:
                       blf_refine_flow(f, a, b, cfg.cost, chunk), flow, p1, p2)
        flow = run(f"{at}.smooth", lambda f, img:
                   flow_smoothing_auto(f, img, cfg.refine), flow, levels1[lvl])
    if cfg.subpixel_refine:
        flow = run("subpixel", lambda f, a, b: subpixel_refine(
            f, a, b, cfg.subpixel), flow, levels1[0], levels2[0])
    return run("final_smooth", lambda f, img: flow_smoothing_auto(
        f, img, cfg.refine), flow, levels1[0])


class _Slot:
    def __init__(self, i: int):
        self.name = f"t{i}"


def _tree_map(fn, x, leaf=torch.Tensor):
    if isinstance(x, leaf):
        return fn(x)
    if isinstance(x, (list, tuple)):
        return type(x)(_tree_map(fn, v, leaf) for v in x)
    return x


class GraphTimer:
    """``timer(name, fn, *args)`` returns ``fn(*args)``; on the card it
    records the device ms of ``reps`` replays of the call's CUDA graph
    under ``ms[name]``."""

    def __init__(self, device: torch.device, reps: int = 5):
        self.device = device
        self.reps = reps
        self.ms: Dict[str, List[float]] = {}

    def __call__(self, name: str, fn: Callable, *args):
        tensors: Dict[str, torch.Tensor] = {}

        def slot(t):
            s = _Slot(len(tensors))
            tensors[s.name] = t.clone()
            return s

        spec = _tree_map(slot, args)

        def call():
            return fn(*_tree_map(lambda s: tensors[s.name], spec, _Slot))

        stream = torch.cuda.Stream(self.device)
        stream.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(stream):
            call()  # makes the kernels' tables and cuBLAS's workspace
        torch.cuda.synchronize(self.device)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=stream):
            out = call()
        torch.cuda.current_stream(self.device).wait_stream(stream)
        graph.replay()
        marks = [(torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
                 for _ in range(self.reps)]
        for start, end in marks:
            start.record()
            graph.replay()
            end.record()
        torch.cuda.synchronize(self.device)
        self.ms[name] = [s.elapsed_time(e) for s, e in marks]
        out = _tree_map(torch.clone, out)
        del graph, tensors
        return out
