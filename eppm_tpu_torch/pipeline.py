"""The EPPM optical-flow pipeline on PyTorch (counterpart of
``eppm_tpu/pipeline.py``).

Stage order (reference ``compute_flow``,
bao_flow_patchmatch_multiscale_cuda.cpp:217-315):

  prepare: Gaussian pre-smooth -> Gaussian pyramid (auto-depth) -> census
    transform and pack per level
  coarsest level: bidirectional dense matching (warm-started from
    ``init_flow`` when given), or with ``match_engine="patchmatch"`` two
    independent PatchMatch searches, forward and backward, drawing from
    the two halves of a split key (JAX's threefry draws) -> left-right
    check -> outlier removal -> occlusion reconstruction (fill-first, or
    the legacy WMF-then-fill order) -> flow
  each finer level: bilinear upsample x2 -> dense refine pass 1 (kernel A;
    its plane mode with ``dense_pass1_planes``) -> 3x3 median -> dense
    refine pass 2 (kernel A; plane mode with ``dense_pass2_planes``; at
    level 0 the last pass may add the parabola fit,
    ``dense_subpixel_fit``), or, with ``refine_impl="gather"``, the
    gathered plane-fitting re-search (plain torch) -> flow smoothing
    (kernel B) -> with ``fine_level_wmf``, one full-image weighted median
    iteration on the flow's targets (kernel C)
  level 0: the optional quadratic subpixel stage (``subpixel_refine``,
    plain torch), then one more flow smoothing

``compute_flow`` runs eagerly on the device of the input tensors: CUDA
tensors launch the hand-written kernels, CPU tensors take their plain
versions.  ``compute_flow_jit``, the JAX package's entry point and its
arguments, replays one CUDA graph per shape and configuration of the same
call on CUDA frames (``graphs.py``) and runs ``compute_flow`` on CPU
frames; ``EPPMFlow`` and the command line go through it.  The JAX
package's staged programs (``STAGED_PIPELINE_THRESHOLD``) work around a
TPU fault and have no counterpart here.
"""

from __future__ import annotations

from typing import List, Optional, Tuple, Union

import torch
from torch import nn

from .config import DEFAULT_CONFIG, EPPMConfig
from .graphs import GRAPHS, graph_key
from .ops._util import f32, inv32
from .ops.census import census_transform
from .ops.cost import pack_frame
from .ops.cuda_smooth import flow_smoothing_auto
from .ops.cuda_wmf import weighted_median_filter_auto
from .ops.dense import dense_refine_flow, median3_flow
from .ops.match import match_coarse_bidi
from .ops.occlusion import coarse_occlusion_reconstruct
from .ops.patchmatch import ThreefrySampler, TorchSampler, patchmatch
from .ops.prng import prng_key, split
from .ops.refine import (blf_refine_flow, flow_to_nnf, lr_check, nnf_to_flow,
                          outlier_removal)
from .ops.resize import bilinear_resize, gaussian_filter, gaussian_pyramid
from .ops.subpixel import subpixel_refine
from .utils import trace

__all__ = ["prepare_pyramids", "compute_flow", "compute_flow_jit",
           "EPPMFlow"]


def _normalize(img: torch.Tensor) -> torch.Tensor:
    """uint8 [0,255] or float [0,1] -> float32 [0,1]."""
    if img.dtype == torch.uint8:
        return img.to(torch.float32) * inv32(255.0)
    return img.to(torch.float32)


def prepare_pyramids(
    img: torch.Tensor, cfg: EPPMConfig
) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
    """Pre-smooth, build the Gaussian pyramid, census-transform and pack
    each level (refine_kernel.cu:1059-1071) -> (image levels, packs)."""
    raw_u8 = img if img.dtype == torch.uint8 else None
    img = _normalize(img)
    h, w = img.shape[0], img.shape[1]
    dims = cfg.pyramid.level_dims(h, w)
    smoothed = gaussian_filter(
        img, cfg.pyramid.presmooth_sigma, cfg.pyramid.presmooth_radius,
        raw_u8=raw_u8,
    )
    levels = gaussian_pyramid(smoothed, dims, cfg.pyramid.ratio)
    packs = [pack_frame(lv, census_transform(lv)) for lv in levels]
    return levels, packs


def _coarse_init(init_flow: torch.Tensor, ch: int, cw: int) -> torch.Tensor:
    """Resize a full-resolution temporal init flow to the coarse level;
    the values scale with the resolution ratio r = ch / h.  The resize's
    indices take r as a double, as the JAX package's numpy does; its
    ``* r`` multiplies by r rounded to float32, as XLA applies the weakly
    typed constant (on every device alike: the product of two float32
    values rounds the same from any wider precision), and its
    multiply-adds are fused as XLA fuses this program."""
    r = ch / init_flow.shape[0]
    return bilinear_resize(init_flow, ch, cw, r, fused=True) * f32(r)


def coarse_flow(levels1, packs1, levels2, packs2, cfg: EPPMConfig,
                init_flow: Optional[torch.Tensor] = None,
                key: Optional[torch.Tensor] = None,
                samplers=None) -> torch.Tensor:
    """The coarsest level of ``compute_flow``: the bidirectional match
    (the dense matcher, or the PatchMatch engine drawing from ``samplers``
    or, by default, from the halves of ``key`` or of ``prng_key(cfg.
    seed)``), the left-right check, outlier removal and the occlusion
    chain -> the coarse flow (H_top, W_top, 2)."""
    top = len(packs1) - 1
    chunk = cfg.cost_tap_chunk
    trace.mark("match")
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
        if samplers is None:
            if key is None:
                key = prng_key(cfg.seed, packs1[top].device)
            samplers = tuple(ThreefrySampler(k) for k in split(key))
        tx1, ty1, c1 = patchmatch(packs1[top], packs2[top], samplers[0],
                                  cfg.patchmatch, cfg.cost, chunk)
        tx2, ty2, c2 = patchmatch(packs2[top], packs1[top], samplers[1],
                                  cfg.patchmatch, cfg.cost, chunk)
    otx, oty = tx1, ty1  # pre-LR matches: arbitration candidates
    trace.mark("lr_check")
    tx1, ty1, c1, tx2, ty2, c2 = lr_check(
        tx1, ty1, c1, tx2, ty2, c2, cfg.lr_thresh
    )
    trace.mark("outliers")
    tx1, ty1, c1 = outlier_removal(tx1, ty1, c1, cfg.refine)
    trace.mark("occlusion")
    tx1, ty1 = coarse_occlusion_reconstruct(
        tx1, ty1, levels1[top], cfg.refine,
        packs=(packs1[top], packs2[top]), cost_cfg=cfg.cost,
        orig=(otx, oty),
    )
    return nnf_to_flow(tx1, ty1)


def compute_flow(
    img1: torch.Tensor,
    img2: torch.Tensor,
    cfg: EPPMConfig = DEFAULT_CONFIG,
    fine_level_wmf: bool = False,
    init_flow: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
    samplers=None,
    key: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Dense flow frame1 -> frame2 for an (H, W, 3) pair (uint8 or float
    in [0, 1]) -> (H, W, 2) float32.  It runs on the frames' device: CUDA
    frames launch the kernels, CPU frames take their plain versions
    (``EPPMFlow`` moves the frames to its device, the card by default).

    ``init_flow`` (H, W, 2), on the frames' device, is a temporal warm
    start (the previous pair's flow when streaming video) for the dense
    coarse matcher: forward as given, backward negated (``MatchConfig.
    warm_skip_global``); the PatchMatch engine ignores it, as the JAX
    package does.  ``fine_level_wmf`` adds one full-image weighted median
    iteration after each fine level's smoothing.

    The PatchMatch engine (``cfg.match_engine="patchmatch"``) draws as
    the JAX package does from ``key`` (a key of ``ops/prng.py``; default
    ``prng_key(cfg.seed)`` on the frames' device), split into the forward
    and the backward search's keys (``ThreefrySampler``): the same draws
    as ``eppm_tpu`` for the same key, on the card and on the CPU alike.
    In its place, ``generator`` (a ``torch.Generator``, one stream for
    both searches, the forward first) or ``samplers`` (a (forward,
    backward) pair of samplers, ``ops/patchmatch.py``) may be given, one
    of the three at most.  The dense engine draws nothing.  Every cost
    sums its taps in partial sums of ``cfg.cost_tap_chunk``.

    With tracing on (``utils/trace.py``) each stage begins with a mark of
    its name, and the last ends with the scope: ``prepare``, ``match``,
    ``lr_check``, ``outliers``, ``occlusion``, then at each finer level l
    ``L<l>.upsample``, ``L<l>.pass<n>`` (or ``L<l>.gather_refine``),
    ``L<l>.smooth`` and, with ``fine_level_wmf``, ``L<l>.wmf``; then
    ``subpixel`` where configured and ``final_smooth``."""
    if img1.device != img2.device:
        raise ValueError(f"frames on {img1.device} and {img2.device}")
    if init_flow is not None and init_flow.device != img1.device:
        raise ValueError(f"init_flow on {init_flow.device}, frames on "
                         f"{img1.device}")
    if sum(x is not None for x in (key, generator, samplers)) > 1:
        raise ValueError("pass one of key, generator and samplers")
    if generator is not None:
        samplers = (TorchSampler(generator),) * 2
    with trace.stages(img1.device):
        return _stages(img1, img2, cfg, fine_level_wmf, init_flow, samplers,
                       key)


def _stages(img1, img2, cfg, fine_level_wmf, init_flow, samplers, key
            ) -> torch.Tensor:
    """``compute_flow``'s stages, each marked (see there)."""
    chunk = cfg.cost_tap_chunk
    trace.mark("prepare")
    levels1, packs1 = prepare_pyramids(img1, cfg)
    levels2, packs2 = prepare_pyramids(img2, cfg)
    top = len(packs1) - 1
    flow = coarse_flow(levels1, packs1, levels2, packs2, cfg, init_flow,
                       key, samplers)

    ratio_up = 1.0 / cfg.pyramid.ratio
    for lvl in range(top - 1, -1, -1):
        oh, ow = packs1[lvl].shape[0], packs1[lvl].shape[1]
        trace.mark(f"L{lvl}.upsample")
        flow = bilinear_resize(flow, oh, ow, ratio_up) * ratio_up
        if cfg.refine_impl == "dense":
            # the parabola fit only on the last refine pass of level 0
            n = cfg.dense_refine_passes
            fit = cfg.dense_subpixel_fit and lvl == 0
            trace.mark(f"L{lvl}.pass1")
            flow = dense_refine_flow(
                flow, packs1[lvl], packs2[lvl], cfg.cost,
                cfg.dense_search_radius, cfg.dense_cand_shape,
                cfg.warp_dtype, cfg.dense_pass1_planes,
                subpixel_fit=fit and n == 1,
                subpixel_min_curv=cfg.dense_subpixel_min_curv,
                tap_chunk=chunk,
            )
            for i in range(n - 1):
                trace.mark(f"L{lvl}.pass{i + 2}")
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
            trace.mark(f"L{lvl}.gather_refine")
            flow = blf_refine_flow(flow, packs1[lvl], packs2[lvl], cfg.cost,
                                   chunk)
        trace.mark(f"L{lvl}.smooth")
        flow = flow_smoothing_auto(flow, levels1[lvl], cfg.refine)
        if fine_level_wmf:
            trace.mark(f"L{lvl}.wmf")
            ftx, fty = flow_to_nnf(flow)
            ftx, fty = weighted_median_filter_auto(
                ftx, fty, levels1[lvl], cfg.refine, num_iter=1,
                only_occlusion=False,
            )
            flow = nnf_to_flow(ftx, fty)
    if cfg.subpixel_refine:
        trace.mark("subpixel")
        flow = subpixel_refine(flow, levels1[0], levels2[0], cfg.subpixel)
    trace.mark("final_smooth")
    return flow_smoothing_auto(flow, levels1[0], cfg.refine)


def compute_flow_jit(
    img1: torch.Tensor,
    img2: torch.Tensor,
    key: Optional[torch.Tensor] = None,
    cfg: EPPMConfig = DEFAULT_CONFIG,
    fine_level_wmf: bool = False,
    init_flow: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """``compute_flow`` as the JAX package's entry point runs it (its
    name and argument order): on CUDA frames one CUDA graph of the whole
    pair, captured the first time its shapes, dtypes, ``cfg``,
    ``fine_level_wmf`` and given arguments are seen, replayed after that
    (``graphs.GRAPHS``); the flow is the eager call's, bit for bit, and a
    fresh tensor.  A failed capture raises; nothing falls back.  On CPU
    frames it runs ``compute_flow``.  Under the PatchMatch engine the
    default key ``prng_key(cfg.seed)`` is made outside the graph and
    copied into it like a given ``key``.  The port-only ``generator`` and
    ``samplers`` stay on ``compute_flow``."""
    if img1.device.type != "cuda":
        with trace.span("entry"):
            return compute_flow(img1, img2, cfg, fine_level_wmf, init_flow,
                                key=key)
    for name, t in (("img2", img2), ("init_flow", init_flow), ("key", key)):
        if t is not None and t.device != img1.device:
            raise ValueError(f"{name} on {t.device}, frames on {img1.device}")
    gkey = graph_key(img1, img2, cfg, fine_level_wmf, init_flow, key)
    if key is None and cfg.match_engine == "patchmatch":
        key = prng_key(cfg.seed, img1.device)

    def run(img1, img2, init_flow, key):
        return compute_flow(img1, img2, cfg, fine_level_wmf, init_flow,
                            key=key)

    return GRAPHS.run(gkey, run, {"img1": img1, "img2": img2,
                                  "init_flow": init_flow, "key": key})


class EPPMFlow(nn.Module):
    """Object API mirroring the reference orchestrator
    (bao_flow_patchmatch_multiscale_cuda.h:33-44): ``init(h, w)``,
    ``set_data(img1, img2)``, ``compute_flow()``; ``forward(img1, img2)``
    runs the pipeline directly.  Its state is the config (the system has
    no learned weights), its device and the frames of ``set_data``.

    It runs on ``device``, the CUDA device by default: ``set_data`` and
    ``forward`` move the frames there, and the flow comes back there.
    Without a CUDA device the default raises; ``device="cpu"`` runs the
    kernels' plain versions.  Under the PatchMatch engine each call draws
    from the ``key``, ``generator`` or ``samplers`` it is given, else
    from ``prng_key(cfg.seed)``.

    For streaming frame pairs at a fixed resolution: each call goes
    through ``compute_flow_jit``, which on the card replays one CUDA
    graph per shape and configuration, as the JAX package's ``EPPMFlow``
    goes through its jit cache.  A call given a ``generator`` or
    ``samplers`` (port-only draws) runs the eager ``compute_flow``."""

    def __init__(self, cfg: EPPMConfig = DEFAULT_CONFIG,
                 device: Union[str, torch.device] = "cuda"):
        super().__init__()
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("EPPMFlow runs on the CUDA device and there is "
                               "none: pass device='cpu' for the CPU")
        self.cfg = cfg
        self._shape: Optional[Tuple[int, int]] = None
        self._img1: Optional[torch.Tensor] = None
        self._img2: Optional[torch.Tensor] = None

    def init(self, h: int, w: int) -> "EPPMFlow":
        self._shape = (h, w)
        return self

    def set_data(self, img1: torch.Tensor, img2: torch.Tensor) -> "EPPMFlow":
        if self._shape is None:
            self._shape = (img1.shape[0], img1.shape[1])
        if (tuple(img1.shape[:2]) != self._shape
                or tuple(img2.shape[:2]) != self._shape):
            raise ValueError(
                f"frame shape {tuple(img1.shape[:2])}/{tuple(img2.shape[:2])}"
                f" != init shape {self._shape}"
            )
        self._img1, self._img2 = img1.to(self.device), img2.to(self.device)
        return self

    def compute_flow(self, fine_level_wmf: bool = False,
                     init_flow: Optional[torch.Tensor] = None,
                     generator: Optional[torch.Generator] = None,
                     samplers=None,
                     key: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The flow of the ``set_data`` pair through ``compute_flow_jit``;
        ``init_flow`` (moved to the model's device) warm-starts the dense
        coarse match, ``key`` feeds the PatchMatch engine.  Given a
        ``generator`` or ``samplers`` instead, the eager
        ``compute_flow``."""
        if self._img1 is None:
            raise RuntimeError("set_data() must be called before compute_flow()")
        if init_flow is not None:
            init_flow = init_flow.to(self.device)
        if key is not None:
            key = key.to(self.device)
        if generator is not None or samplers is not None:
            return compute_flow(self._img1, self._img2, self.cfg,
                                fine_level_wmf, init_flow, generator,
                                samplers, key)
        return compute_flow_jit(self._img1, self._img2, key, self.cfg,
                                fine_level_wmf, init_flow)

    def forward(self, img1: torch.Tensor, img2: torch.Tensor,
                generator: Optional[torch.Generator] = None,
                key: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The flow of a pair through ``compute_flow_jit`` (the eager
        ``compute_flow`` given a ``generator``)."""
        img1, img2 = img1.to(self.device), img2.to(self.device)
        if key is not None:
            key = key.to(self.device)
        if generator is not None:
            return compute_flow(img1, img2, self.cfg, generator=generator,
                                key=key)
        return compute_flow_jit(img1, img2, key, self.cfg)
