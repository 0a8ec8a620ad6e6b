"""The plain pipeline the benchmark judges the port by: the port's eager
``compute_flow`` as its plain path runs it, on any device, with every
hand-written kernel replaced by its plain PyTorch version (kernel A by
``dense.residual_costs`` / ``residual_costs_multiwarp``, B by
``refine.flow_smoothing``, C by ``refine.weighted_median_filter``, D by
``match.global_argmax``) and the PatchMatch engine drawing JAX's
threefry draws from ``prng.py``.

Stage order: prepare (pre-smooth, Gaussian pyramid, census, pack) ->
the coarse bidirectional match (dense engine, warm-started from
``init_flow`` when given; or two PatchMatch searches on the halves of
the key) -> left-right check -> outlier removal -> occlusion
reconstruction -> at each finer level: upsample, dense refine pass 1,
3x3 median, dense refine pass 2 (or the gathered refine), smoothing
(and, with ``fine_level_wmf``, one full-image weighted median) -> the
optional subpixel stage -> the final smoothing.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch

from ._util import f32, inv32
from .census import census_transform
from .config import EPPMConfig
from .cost import pack_frame
from .dense import dense_refine_flow, median3_flow
from .match import match_coarse_bidi
from .occlusion import coarse_occlusion_reconstruct
from .patchmatch import ThreefrySampler, patchmatch
from .prng import prng_key, split
from .refine import (blf_refine_flow, flow_smoothing, flow_to_nnf, lr_check,
                     nnf_to_flow, outlier_removal, weighted_median_filter)
from .resize import bilinear_resize, gaussian_filter, gaussian_pyramid
from .subpixel import subpixel_refine

__all__ = ["prepare_pyramids", "compute_flow"]


def _normalize(img: torch.Tensor) -> torch.Tensor:
    """uint8 [0,255] or float [0,1] -> float32 [0,1]."""
    if img.dtype == torch.uint8:
        return img.to(torch.float32) * inv32(255.0)
    return img.to(torch.float32)


def prepare_pyramids(
    img: torch.Tensor, cfg: EPPMConfig
) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
    """Pre-smooth, Gaussian pyramid, census transform and pack of each
    level -> (image levels, packs)."""
    raw_u8 = img if img.dtype == torch.uint8 else None
    img = _normalize(img)
    dims = cfg.pyramid.level_dims(img.shape[0], img.shape[1])
    smoothed = gaussian_filter(
        img, cfg.pyramid.presmooth_sigma, cfg.pyramid.presmooth_radius,
        raw_u8=raw_u8,
    )
    levels = gaussian_pyramid(smoothed, dims, cfg.pyramid.ratio)
    packs = [pack_frame(lv, census_transform(lv)) for lv in levels]
    return levels, packs


def _coarse_init(init_flow: torch.Tensor, ch: int, cw: int) -> torch.Tensor:
    """A full-resolution warm-start flow resized to the coarse level, its
    values scaled by r = ch / h rounded to float32."""
    r = ch / init_flow.shape[0]
    return bilinear_resize(init_flow, ch, cw, r, fused=True) * f32(r)


def _coarse_flow(levels1, packs1, levels2, packs2, cfg: EPPMConfig,
                 init_flow: Optional[torch.Tensor],
                 key: Optional[torch.Tensor]) -> torch.Tensor:
    top = len(packs1) - 1
    chunk = cfg.cost_tap_chunk
    if cfg.match_engine == "dense":
        ci = None
        if init_flow is not None:
            ci = _coarse_init(init_flow.to(torch.float32),
                              packs1[top].shape[0], packs1[top].shape[1])
        (tx1, ty1, c1), (tx2, ty2, c2) = match_coarse_bidi(
            levels1[top], levels2[top], cfg.cost, cfg.match,
            packs1[top], packs2[top], init_flow=ci, tap_chunk=chunk,
        )
    else:
        if key is None:
            key = prng_key(cfg.seed, packs1[top].device)
        fwd, bwd = (ThreefrySampler(k) for k in split(key))
        tx1, ty1, c1 = patchmatch(packs1[top], packs2[top], fwd,
                                  cfg.patchmatch, cfg.cost, chunk)
        tx2, ty2, c2 = patchmatch(packs2[top], packs1[top], bwd,
                                  cfg.patchmatch, cfg.cost, chunk)
    otx, oty = tx1, ty1
    tx1, ty1, c1, tx2, ty2, c2 = lr_check(
        tx1, ty1, c1, tx2, ty2, c2, cfg.lr_thresh
    )
    tx1, ty1, c1 = outlier_removal(tx1, ty1, c1, cfg.refine)
    tx1, ty1 = coarse_occlusion_reconstruct(
        tx1, ty1, levels1[top], cfg.refine,
        packs=(packs1[top], packs2[top]), cost_cfg=cfg.cost,
        orig=(otx, oty),
    )
    return nnf_to_flow(tx1, ty1)


@torch.no_grad()
def compute_flow(img1: torch.Tensor, img2: torch.Tensor, cfg: EPPMConfig,
                 init_flow: Optional[torch.Tensor] = None,
                 key: Optional[torch.Tensor] = None,
                 fine_level_wmf: bool = False) -> torch.Tensor:
    """Dense flow frame1 -> frame2 of an (H, W, 3) pair (uint8 or float
    in [0, 1]) on the frames' device -> (H, W, 2) float32.  ``init_flow``
    warm-starts the dense coarse match; the PatchMatch engine draws from
    ``key``, by default ``prng_key(cfg.seed)``."""
    chunk = cfg.cost_tap_chunk
    levels1, packs1 = prepare_pyramids(img1, cfg)
    levels2, packs2 = prepare_pyramids(img2, cfg)
    top = len(packs1) - 1
    flow = _coarse_flow(levels1, packs1, levels2, packs2, cfg, init_flow, key)

    ratio_up = 1.0 / cfg.pyramid.ratio
    for lvl in range(top - 1, -1, -1):
        oh, ow = packs1[lvl].shape[0], packs1[lvl].shape[1]
        flow = bilinear_resize(flow, oh, ow, ratio_up) * ratio_up
        if cfg.refine_impl == "dense":
            n = cfg.dense_refine_passes
            fit = cfg.dense_subpixel_fit and lvl == 0
            flow = dense_refine_flow(
                flow, packs1[lvl], packs2[lvl], cfg.cost,
                cfg.dense_search_radius, cfg.dense_cand_shape,
                cfg.warp_dtype, cfg.dense_pass1_planes,
                subpixel_fit=fit and n == 1,
                subpixel_min_curv=cfg.dense_subpixel_min_curv,
                tap_chunk=chunk,
            )
            for i in range(n - 1):
                flow = dense_refine_flow(
                    median3_flow(flow), packs1[lvl], packs2[lvl],
                    cfg.pass2_cost, cfg.dense_search_radius,
                    cfg.pass2_cand_shape, cfg.warp_dtype,
                    cfg.dense_pass2_planes,
                    subpixel_fit=fit and i == n - 2,
                    subpixel_min_curv=cfg.dense_subpixel_min_curv,
                    tap_chunk=chunk,
                )
        else:
            flow = blf_refine_flow(flow, packs1[lvl], packs2[lvl], cfg.cost,
                                   chunk)
        flow = flow_smoothing(flow, levels1[lvl], cfg.refine)
        if fine_level_wmf:
            ftx, fty = flow_to_nnf(flow)
            ftx, fty = weighted_median_filter(
                ftx, fty, levels1[lvl], cfg.refine, num_iter=1,
                only_occlusion=False,
            )
            flow = nnf_to_flow(ftx, fty)
    if cfg.subpixel_refine:
        flow = subpixel_refine(flow, levels1[0], levels2[0], cfg.subpixel)
    return flow_smoothing(flow, levels1[0], cfg.refine)
