"""Multi-device EPPM: frame pairs over a batch axis, and each frame's fine
levels in tiles over (y, x) (counterpart of ``eppm_tpu/parallel/
sharded.py``).

One controller, as ``shard_map`` is
-----------------------------------
The JAX package runs one program over a ``("batch", "y", "x")`` mesh of
devices.  The port runs one process too: the mesh is a (batch, y, x)
array of ``torch.device``s, each tile of state lives on its own device,
and each stage runs on every tile before the next stage starts (a halo
needs its neighbours' state of the same stage).  CUDA launches return at
once, so the devices of a mesh work at the same time while the one host
thread enqueues.  A mesh may name one device more than once: a single
card then runs the whole tiled path, as the JAX tests run it on host
devices they fake.  (A ``torch.distributed`` process group would not:
NCCL refuses two ranks on one GPU, and gloo does not send CUDA tensors.)

Per pair, the work splits by level, as in the JAX package:

- the coarsest level (the match, the left-right check, outlier removal,
  the occlusion chain) runs replicated, once on each distinct device of
  the pair's (y, x) group, with the same draws (bit-identical coarse
  flows on every device);
- the fine levels run in tiles over (y, x): per level the upsampling of
  the previous flow (a 1-pixel flow halo), the dense refine passes on
  each tile with a halo ``G`` (or the gathered refine with the frame-1
  tile's patch radius) and the smoothing with the radius-``blf_radius``
  flow halo filled with ``UNKNOWN_FLOW`` at the global border.  Image
  pyramids stay whole on every device: frame-2 reads at the targets are
  unbounded, and the flow halos are the only traffic between devices.

Every level's dims must divide by (ny, nx) and halve exactly from the
next level up (``check_tileable``); ``compute_flow_sharded`` pads other
shapes (``pad_to_tileable``) and crops the flow back.  Like the JAX
package's sharded program, this path has no ``fine_level_wmf`` and no
``subpixel_refine`` stage.

One program per batch, as the JAX package's jit
-----------------------------------------------
``compute_flow_sharded`` splits as the JAX entry does: a front (the
batch checked, the frames padded, the default keys made on the device,
the flow cropped at the end) and a body, the loop over the pairs
(``_sharded_body``, the counterpart of ``_compute_flow_sharded_jit``).
On a mesh whose devices are all one CUDA card the body is one CUDA graph
per mesh, batch, padded shape, dtype, ``cfg`` and given arguments
(``sharded_graph_key``), captured once and replayed (``graphs.py``).  A
mesh over several cards runs the body eagerly: a CUDA graph records the
work of one device, and the exchanges between cards would need a graph
per card, which no host with one card can check.  A CPU mesh runs it
eagerly too, as ``compute_flow_jit`` runs CPU frames.
"""

from __future__ import annotations

import functools
import logging
from typing import List, NamedTuple, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..config import DEFAULT_CONFIG, UNKNOWN_FLOW, EPPMConfig
from ..graphs import GRAPHS, tensor_meta
from ..utils import trace
from ..ops._util import _clamped
from ..ops.cost import plane_offsets
from ..ops.cuda_smooth import flow_smoothing_auto
from ..ops.dense import dense_refine_flow, median3_flow
from ..ops.patchmatch import ThreefrySampler
from ..ops.prng import fold_in, prng_key, split
from ..ops.refine import blf_refine_flow
from ..ops.resize import bilinear_resize
from ..pipeline import coarse_flow, prepare_pyramids
from .halo import halo_exchange_2d

__all__ = ["Mesh", "make_mesh", "check_tileable", "pad_to_tileable",
           "compute_flow_sharded", "compute_flow_sharded_eager", "one_card",
           "sharded_graph_key"]

log = logging.getLogger(__name__)

Grid = List[List[torch.Tensor]]


class Mesh(NamedTuple):
    """A ("batch", "y", "x") mesh: ``devices`` is a (batch, y, x) object
    array of ``torch.device``s, which may repeat."""

    devices: np.ndarray


def make_mesh(batch: int = 1, y: int = 1, x: int = 1,
              devices: Optional[Sequence[Union[str, torch.device]]] = None
              ) -> Mesh:
    """A (batch, y, x) mesh over the first batch * y * x of ``devices``
    (default: the CUDA devices 0..n-1); raises ValueError when there are
    too few.  A list may name one device more than once."""
    if devices is None:
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    n = batch * y * x
    if len(devices) < n:
        raise ValueError(f"need {n} devices, have {len(devices)}")
    grid = np.empty(n, dtype=object)
    grid[:] = [torch.device(d) for d in devices[:n]]
    return Mesh(grid.reshape(batch, y, x))


def check_tileable(h: int, w: int, cfg: EPPMConfig, ny: int, nx: int) -> None:
    """Raise ValueError unless every pyramid level of an (h, w) frame
    divides by (ny, nx) and halves exactly from the level below it."""
    dims = cfg.pyramid.level_dims(h, w)
    for i, (lh, lw) in enumerate(dims):
        if lh % ny or lw % nx:
            raise ValueError(
                f"level {i} dims {lh}x{lw} not divisible by mesh ({ny},{nx})"
            )
        if i + 1 < len(dims):
            nh, nw = dims[i + 1]
            if lh != 2 * nh or lw != 2 * nw:
                raise ValueError(
                    f"levels must halve exactly for aligned tiles; got "
                    f"{lh}x{lw} -> {nh}x{nw} (pad inputs to a multiple of "
                    f"{2 ** (len(dims) - 1)})"
                )


def pad_to_tileable(h: int, w: int, cfg: EPPMConfig, ny: int, nx: int
                    ) -> Tuple[int, int]:
    """The smallest (H, W) >= (h, w) that ``check_tileable`` accepts: a
    multiple of ``2^(depth-1) * n`` per axis halves exactly at every
    level and stays divisible by the mesh.  Iterates, because padding can
    deepen the automatic pyramid depth (``PyramidConfig.depth``)."""
    ph, pw = h, w
    for _ in range(4):
        d = cfg.pyramid.depth(ph, pw)
        qy = ny * 2 ** (d - 1)
        qx = nx * 2 ** (d - 1)
        nph, npw = (-(-h // qy)) * qy, (-(-w // qx)) * qx
        if (nph, npw) == (ph, pw) and cfg.pyramid.depth(nph, npw) == d:
            break
        ph, pw = nph, npw
    return ph, pw


def _slice_tile_haloed(full: torch.Tensor, y0: int, x0: int, th: int,
                       tw: int, halo: int) -> torch.Tensor:
    """The (th, tw) tile at (y0, x0) of a whole (H, W, ...) array with a
    ``halo`` ring, clamped at the global edges (an edge-padded slice)."""
    h, w = full.shape[0], full.shape[1]
    iy = _clamped(h, y0 - halo, y0 + th + halo, full.device)
    ix = _clamped(w, x0 - halo, x0 + tw + halo, full.device)
    return full.index_select(0, iy).index_select(1, ix)


def _crop(t: torch.Tensor, m: int) -> torch.Tensor:
    return t[m:-m, m:-m] if m else t


def _dense_reach(cfg: EPPMConfig) -> int:
    """The halo G of a tile's dense refine: the candidates' radius plus
    the widest plane-hypothesis tap (the taps of a candidate on the
    warped frame reach that far), at least the patch radius, rounded up
    to 8."""
    tmax = max(max(abs(i), abs(j))
               for tbl in plane_offsets(cfg.cost) for (i, j) in tbl)
    reach = max(cfg.dense_search_radius + tmax, cfg.cost.patch_radius)
    return -(-reach // 8) * 8


class _Replica(NamedTuple):
    """What one device of a pair's group holds whole: frame 1's image
    levels and packs, frame 2's packs and the coarse flow."""

    levels1: List[torch.Tensor]
    packs1: List[torch.Tensor]
    packs2: List[torch.Tensor]
    coarse: torch.Tensor


def _pair_flow_tiled(img1: torch.Tensor, img2: torch.Tensor,
                     key: torch.Tensor, cfg: EPPMConfig, devs: np.ndarray,
                     init_flow: Optional[torch.Tensor] = None) -> Grid:
    """One pair's flow over a (y, x) grid of devices ``devs``: the
    replicated coarse level, then the fine levels in tiles -> the grid of
    (th, tw, 2) flow tiles, tile (iy, ix) on ``devs[iy, ix]``.

    ``init_flow`` (H, W, 2) warm-starts the dense coarse match as on one
    device; the PatchMatch engine ignores it and draws from the halves of
    ``key``."""
    ny, nx = devs.shape
    replicas = {}
    for dev in dict.fromkeys(devs.ravel()):   # each distinct device once
        levels1, packs1 = prepare_pyramids(img1.to(dev), cfg)
        levels2, packs2 = prepare_pyramids(img2.to(dev), cfg)
        init = None if init_flow is None else init_flow.to(dev)
        samplers = tuple(ThreefrySampler(k) for k in split(key.to(dev)))
        replicas[dev] = _Replica(levels1, packs1, packs2, coarse_flow(
            levels1, packs1, levels2, packs2, cfg, init, samplers=samplers))
    rep = [[replicas[devs[iy, ix]] for ix in range(nx)] for iy in range(ny)]
    top = len(rep[0][0].packs1) - 1
    chunk = cfg.cost_tap_chunk
    rb = cfg.refine.blf_radius

    def each(fn) -> Grid:
        """fn(iy, ix, r, (y0, x0, th, tw)) on every tile at level ``lvl``
        (read when called), one stage for all tiles before the next."""
        h, w = rep[0][0].packs1[lvl].shape[:2]
        th, tw = h // ny, w // nx
        return [[fn(iy, ix, rep[iy][ix], (iy * th, ix * tw, th, tw))
                 for ix in range(nx)] for iy in range(ny)]

    def smooth(flow_tiles: Grid) -> Grid:
        """Kernel B on every tile with a ``blf_radius`` ring: the flow's
        unknown beyond the global border, the image's clamped."""
        fh = halo_exchange_2d(flow_tiles, rb, UNKNOWN_FLOW)
        return each(lambda iy, ix, r, t: _crop(flow_smoothing_auto(
            fh[iy][ix], _slice_tile_haloed(r.levels1[lvl], *t, rb),
            cfg.refine), rb))

    lvl = top
    if top == 0:
        # a one-level pyramid: only the final smoothing runs in tiles
        tiles = each(lambda iy, ix, r, t: r.coarse[
            t[0]:t[0] + t[2], t[1]:t[1] + t[3]])
        return smooth(tiles)

    # the coarse flow is whole on every device: each tile slices its own
    # with a 1-pixel ring (the resize clamps at the global border)
    prev = each(lambda iy, ix, r, t: _slice_tile_haloed(r.coarse, *t, 1))
    G = _dense_reach(cfg)
    R = cfg.cost.patch_radius
    ratio_up = 1.0 / cfg.pyramid.ratio
    for lvl in range(top - 1, -1, -1):
        if lvl < top - 1:
            prev = halo_exchange_2d(tiles, 1, "edge")
        tiles = each(lambda iy, ix, r, t: bilinear_resize(
            prev[iy][ix], t[2], t[3], ratio_up, shift=1) * ratio_up)
        if cfg.refine_impl == "dense":
            def refine(flow_tiles: Grid, med: bool, sub: bool) -> Grid:
                """One dense pass on every tile extended by G (and one more
                ring for pass 2's median): each pass exchanges the flow
                halo anew, and the warp reads the whole frame 2 at global
                coordinates, so the cropped interior is the whole frame's
                result."""
                fh = halo_exchange_2d(flow_tiles, G + 1, "edge")

                def one(iy, ix, r, t):
                    f = median3_flow(fh[iy][ix]) if med else fh[iy][ix]
                    ext = dense_refine_flow(
                        _crop(f, 1), _slice_tile_haloed(r.packs1[lvl], *t, G),
                        r.packs2[lvl], cfg.pass2_cost if med else cfg.cost,
                        cfg.dense_search_radius,
                        cfg.pass2_cand_shape if med else cfg.dense_cand_shape,
                        cfg.warp_dtype,
                        cfg.dense_pass2_planes if med
                        else cfg.dense_pass1_planes,
                        subpixel_fit=sub,
                        subpixel_min_curv=cfg.dense_subpixel_min_curv,
                        tap_chunk=chunk, origin=(t[0] - G, t[1] - G))
                    return _crop(ext, G)

                return each(one)

            # the parabola fit only on the last pass of level 0
            n = cfg.dense_refine_passes
            fit = cfg.dense_subpixel_fit and lvl == 0
            tiles = refine(tiles, med=False, sub=fit and n == 1)
            for i in range(n - 1):
                tiles = refine(tiles, med=True, sub=fit and i == n - 2)
        else:
            tiles = each(lambda iy, ix, r, t: blf_refine_flow(
                tiles[iy][ix], _slice_tile_haloed(r.packs1[lvl], *t, R),
                r.packs2[lvl], cfg.cost, chunk, origin=t[:2], pack1_halo=R))
        tiles = smooth(tiles)
    return smooth(tiles)


def _assemble(tiles: Grid, device: torch.device) -> torch.Tensor:
    return torch.cat([torch.cat([t.to(device) for t in row], 1)
                      for row in tiles], 0)


def _sharded_body(imgs1: torch.Tensor, imgs2: torch.Tensor,
                  keys: torch.Tensor, init_flows: Optional[torch.Tensor],
                  cfg: EPPMConfig, mesh: Mesh) -> torch.Tensor:
    """The program of a batch on tileable frames (the counterpart of
    ``_compute_flow_sharded_jit`` / ``_init_jit``): pair b on batch group
    b // (B / batch) -> (B, H, W, 2) on the mesh's first device."""
    per_group = imgs1.shape[0] // mesh.devices.shape[0]
    out_dev = mesh.devices[0, 0, 0]
    flows = []
    for b in range(imgs1.shape[0]):
        tiles = _pair_flow_tiled(
            imgs1[b], imgs2[b], keys[b], cfg, mesh.devices[b // per_group],
            None if init_flows is None else init_flows[b])
        flows.append(_assemble(tiles, out_dev))
    return torch.stack(flows)


def _card(d: torch.device) -> torch.device:
    if d.type == "cuda" and d.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return d


def one_card(mesh: Mesh) -> Optional[torch.device]:
    """The CUDA device that every device of ``mesh`` names, or None: a
    mesh with a CPU device, or over more than one card."""
    devs = set(mesh.devices.ravel())
    if any(d.type != "cuda" for d in devs):
        return None
    cards = {_card(d) for d in devs}
    return cards.pop() if len(cards) == 1 else None


def sharded_graph_key(imgs1: torch.Tensor, imgs2: torch.Tensor,
                      init_flows: Optional[torch.Tensor], keys_given: bool,
                      cfg: EPPMConfig, mesh: Mesh) -> tuple:
    """What a graph of the sharded body is specialised to: what the JAX
    package's jit keys on (the mesh's shape and devices, the batch and
    the padded frames' shape and dtype, ``cfg``, whether ``init_flows``
    is given), whether ``keys`` were given and whether tracing is on (a
    traced graph holds marks)."""
    return ("compute_flow_sharded", mesh.devices.shape,
            tuple(mesh.devices.ravel()), tensor_meta(imgs1),
            tensor_meta(imgs2), cfg, tensor_meta(init_flows), keys_given,
            trace.enabled())


_EAGER_MESHES = set()   # meshes of several cards, logged once each


def _sharded(imgs1, imgs2, mesh, cfg, keys, pad_to_fit, init_flows,
             graphed: bool) -> torch.Tensor:
    """``compute_flow_sharded``: the front (the batch checked, the frames
    padded, the default keys made on the device), the body by replay of
    its graph where ``graphed`` and the mesh is one card, else eagerly,
    and the flow cropped back."""
    B, h, w = imgs1.shape[0], imgs1.shape[1], imgs1.shape[2]
    nb, ny, nx = mesh.devices.shape
    if B % nb:
        raise ValueError(f"batch {B} not divisible by mesh batch {nb}")
    card = one_card(mesh)
    if card is not None:
        # the graph's static inputs live on the card
        imgs1, imgs2 = imgs1.to(card), imgs2.to(card)
        keys = None if keys is None else keys.to(card)
        init_flows = None if init_flows is None else init_flows.to(card)
    try:
        check_tileable(h, w, cfg, ny, nx)
    except ValueError:
        if not pad_to_fit:
            raise
        ph, pw = pad_to_tileable(h, w, cfg, ny, nx)

        def pad(t):
            iy = _clamped(h, 0, ph, t.device)
            ix = _clamped(w, 0, pw, t.device)
            return t.index_select(1, iy).index_select(2, ix)

        imgs1, imgs2 = pad(imgs1), pad(imgs2)
        if init_flows is not None:
            init_flows = pad(init_flows)
    keys_given = keys is not None
    if keys is None:
        out_dev = mesh.devices[0, 0, 0]
        keys = fold_in(prng_key(cfg.seed, out_dev),
                       torch.arange(B, device=out_dev))
    if graphed and card is not None:
        out = GRAPHS.run(
            sharded_graph_key(imgs1, imgs2, init_flows, keys_given, cfg,
                              mesh),
            functools.partial(_sharded_body, cfg=cfg, mesh=mesh),
            {"imgs1": imgs1, "imgs2": imgs2, "keys": keys,
             "init_flows": init_flows})
    else:
        devs = tuple(mesh.devices.ravel())
        if (graphed and all(d.type == "cuda" for d in devs)
                and devs not in _EAGER_MESHES):
            _EAGER_MESHES.add(devs)
            log.warning("mesh %s spans %d cards: its batches run eagerly "
                        "(one CUDA graph holds the work of one card)",
                        mesh.devices.shape, len(set(map(_card, devs))))
        out = _sharded_body(imgs1, imgs2, keys, init_flows, cfg, mesh)
    return out[:, :h, :w].contiguous()


def compute_flow_sharded(
    imgs1: torch.Tensor,
    imgs2: torch.Tensor,
    mesh: Mesh,
    cfg: EPPMConfig = DEFAULT_CONFIG,
    keys: Optional[torch.Tensor] = None,
    pad_to_fit: bool = True,
    init_flows: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Dense flow of a batch of pairs over ``mesh``: imgs1, imgs2 (B, H,
    W, 3), uint8 or float in [0, 1], on any device, with B divisible by
    the mesh's batch axis; pair b runs on batch group b // (B / batch).
    Returns (B, H, W, 2) float32 on the mesh's first device.

    ``keys`` (B, 2): each pair's PatchMatch key (``ops/prng.py``),
    default ``fold_in(prng_key(cfg.seed), b)`` as the JAX package makes
    them.  ``init_flows`` (B, H, W, 2): a temporal warm start per pair,
    as ``compute_flow(init_flow=...)``.

    A shape that ``check_tileable`` refuses is edge-padded at the bottom
    and right to ``pad_to_tileable`` and the flow cropped back (pixels
    within a patch radius of those borders then see replicated edge
    texture); ``pad_to_fit=False`` raises instead.

    As the JAX package jits its sharded program, a mesh whose devices
    are all one CUDA card runs the batch as one CUDA graph (the
    arguments moved to the card first), captured the first time its
    mesh (shape and devices), batch, padded frames' shape and dtype,
    ``cfg`` and given ``init_flows`` and ``keys`` are seen, and replayed
    after that (``graphs.GRAPHS``, shared with ``compute_flow_jit``):
    the flow is ``compute_flow_sharded_eager``'s, bit for bit.  A failed
    capture raises; nothing falls back.  A mesh of CPU devices, or over
    more than one card (logged once a mesh), runs eagerly."""
    return _sharded(imgs1, imgs2, mesh, cfg, keys, pad_to_fit, init_flows,
                    graphed=True)


def compute_flow_sharded_eager(
    imgs1: torch.Tensor,
    imgs2: torch.Tensor,
    mesh: Mesh,
    cfg: EPPMConfig = DEFAULT_CONFIG,
    keys: Optional[torch.Tensor] = None,
    pad_to_fit: bool = True,
    init_flows: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """``compute_flow_sharded`` run eagerly on every mesh, one op at a
    time: what its graphs are held to."""
    return _sharded(imgs1, imgs2, mesh, cfg, keys, pad_to_fit, init_flows,
                    graphed=False)
