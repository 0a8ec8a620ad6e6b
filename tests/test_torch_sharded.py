"""The port's multi-device path (``eppm_tpu_torch/parallel/sharded.py``)
on a CPU mesh: the tiling rules and the tile ops against the JAX
package's and the whole frame's, ``compute_flow_sharded`` against
``eppm_tpu.parallel.compute_flow_sharded`` on a (1, 2, 2) mesh, and the
flow's independence of the mesh's shape.

Tolerances: the tiling rules and the tile ops exactly; the flow the
repo's cross-program contract against JAX (tests/test_sharded.py:145:
>= 98% of pixels within 1e-3, mean |delta| < 0.05); across mesh shapes
the port is bit for bit itself, as tests/test_sharded.py:153 asks of
JAX."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eppm_tpu.config import EPPMConfig as JEPPM
from eppm_tpu.config import PatchMatchConfig as JPM
from eppm_tpu.config import PyramidConfig as JPyr
from eppm_tpu.config import RefineConfig as JRef
from eppm_tpu.parallel import compute_flow_sharded as j_sharded
from eppm_tpu.parallel import make_mesh as j_mesh
from eppm_tpu.parallel.sharded import check_tileable as j_check
from eppm_tpu.parallel.sharded import pad_to_tileable as j_pad

from eppm_tpu_torch.config import DEFAULT_CONFIG as TC
from eppm_tpu_torch.config import EPPMConfig as TEPPM
from eppm_tpu_torch.config import PatchMatchConfig as TPM
from eppm_tpu_torch.config import PyramidConfig as TPyr
from eppm_tpu_torch.config import RefineConfig as TRef
from eppm_tpu_torch.ops.census import census_transform
from eppm_tpu_torch.ops.cost import pack_frame
from eppm_tpu_torch.ops.dense import dense_refine_flow, warp_pack
from eppm_tpu_torch.ops.refine import blf_refine_flow
from eppm_tpu_torch.parallel import (check_tileable, compute_flow_sharded,
                                     halo_exchange_2d, make_mesh,
                                     pad_to_tileable)
from eppm_tpu_torch.parallel.sharded import _dense_reach, _slice_tile_haloed
from test_torch_pipeline import assert_contract, shifted_pair

# The suite runs several test processes per host: one torch thread each
# keeps them from oversubscribing the cores.
torch.set_num_threads(1)


def configs(depth=2, **change):
    """tests/test_sharded.py's trimmed configuration, in both packages."""
    def make(eppm, pyramid, pm, refine):
        return eppm(pyramid=pyramid(max_depth=depth),
                    patchmatch=pm(num_iters=3, prop_steps=(4, 2, 1)),
                    refine=refine(wmf_coarse_iters=3), **change)

    return make(JEPPM, JPyr, JPM, JRef), make(TEPPM, TPyr, TPM, TRef)


def cpu_mesh(b, y, x):
    return make_mesh(b, y, x, devices=["cpu"] * (b * y * x))


@pytest.mark.parametrize("ny,nx", [(1, 2), (2, 1), (2, 2), (1, 4), (3, 2)])
def test_tiling_rules_match_jax(ny, nx):
    """``check_tileable`` accepts and refuses what the JAX package's
    does, and ``pad_to_tileable`` pads to the same shape, over a grid of
    shapes (KITTI's 1242x375 and 1080p among them) and depths."""
    for depth in (1, 2, 3, 0):   # 0: the automatic depth
        jc, tc = configs(depth)
        for h, w in [(64, 96), (60, 96), (62, 94), (375, 1242),
                     (1080, 1920), (480, 640), (97, 33)]:
            try:
                j_check(h, w, jc, ny, nx)
                want = None
            except ValueError as e:
                want = str(e)
            try:
                check_tileable(h, w, tc, ny, nx)
                got = None
            except ValueError as e:
                got = str(e)
            assert got == want, (h, w, depth)
            assert pad_to_tileable(h, w, tc, ny, nx) == j_pad(h, w, jc, ny,
                                                              nx)
            check_tileable(*pad_to_tileable(h, w, tc, ny, nx), tc, ny, nx)


def _packs(h, w):
    f1, f2 = shifted_pair(h, w, 3, -2, seed=5)
    return [pack_frame(torch.from_numpy(f), census_transform(
        torch.from_numpy(f))) for f in (f1, f2)]


def _smooth_flow(h, w):
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float32)
    return torch.from_numpy(np.stack(
        [2.0 + 0.02 * xs + 0.5 * np.sin(ys / 9.0),
         -3.0 + 0.015 * ys + 0.5 * np.cos(xs / 11.0)], -1).astype(np.float32))


@pytest.mark.parametrize("op", ["warp_pack", "dense_refine_flow",
                                "dense_refine_flow_planes",
                                "blf_refine_flow"])
def test_tile_ops_with_origin_equal_whole_frame(op):
    """Each tile op on a tile with its halo (the flow's halo from the halo
    exchange, frame 1's a clamped slice, frame 2 whole): the cropped
    interior equals the whole frame's call, for every tile of a (2, 2)
    split."""
    h, w = 48, 64
    p1, p2 = _packs(h, w)
    flow = _smooth_flow(h, w)
    th, tw = h // 2, w // 2
    tiles = [[flow[iy * th:(iy + 1) * th, ix * tw:(ix + 1) * tw]
              for ix in range(2)] for iy in range(2)]
    cfg = TC
    planes = op == "dense_refine_flow_planes"
    if op == "warp_pack":
        g = torch.trunc(flow).to(torch.int32)
        full = warp_pack(p2, g[..., 0], g[..., 1])
        halo = 5
    elif op.startswith("dense"):
        full = dense_refine_flow(flow, p1, p2, cfg.cost, 1, "square", None,
                                 planes)
        halo = _dense_reach(cfg)
    else:
        full = blf_refine_flow(flow, p1, p2, cfg.cost)
        halo = 0
    fh = halo_exchange_2d(tiles, halo, "edge")
    for iy in range(2):
        for ix in range(2):
            y0, x0 = iy * th, ix * tw
            origin = (y0 - halo, x0 - halo)
            if op == "warp_pack":
                g = torch.trunc(fh[iy][ix]).to(torch.int32)
                out = warp_pack(p2, g[..., 0], g[..., 1], origin=origin)
            elif op.startswith("dense"):
                p1h = _slice_tile_haloed(p1, y0, x0, th, tw, halo)
                out = dense_refine_flow(fh[iy][ix], p1h, p2, cfg.cost, 1,
                                        "square", None, planes,
                                        origin=origin)
            else:
                R = cfg.cost.patch_radius
                p1h = _slice_tile_haloed(p1, y0, x0, th, tw, R)
                out = blf_refine_flow(fh[iy][ix], p1h, p2, cfg.cost,
                                      origin=origin, pack1_halo=R)
            if halo:
                out = out[halo:-halo, halo:-halo]
            assert torch.equal(out, full[y0:y0 + th, x0:x0 + tw])


def test_sharded_matches_jax_sharded():
    """The port's (1, 2, 2) flow against the JAX package's on the same
    mesh at 64x96, depth 2, the dense engine."""
    jc, tc = configs()
    f1, f2 = shifted_pair(64, 96, 3, -2, seed=4)
    want = np.asarray(j_sharded(jnp.asarray(f1)[None], jnp.asarray(f2)[None],
                                j_mesh(1, 2, 2), jc))[0]
    got = compute_flow_sharded(torch.from_numpy(f1)[None],
                               torch.from_numpy(f2)[None], cpu_mesh(1, 2, 2),
                               tc)
    assert got.dtype == torch.float32 and tuple(got.shape) == (1, 64, 96, 2)
    assert_contract(got[0].numpy(), want)


@pytest.mark.parametrize("engine", ["dense", "patchmatch"])
def test_sharded_mesh_shape_invariance(engine):
    """(1, 2), (2, 1) and (2, 2) tilings give the same flow bit for bit:
    a halo fault on one axis shows here even where each shape alone meets
    the contract."""
    _, tc = configs(match_engine=engine)
    f1, f2 = (torch.from_numpy(f)[None]
              for f in shifted_pair(64, 96, 3, -2, seed=4))
    outs = [compute_flow_sharded(f1, f2, cpu_mesh(1, ny, nx), tc)
            for ny, nx in [(1, 2), (2, 1), (2, 2)]]
    assert torch.equal(outs[0], outs[1])
    assert torch.equal(outs[0], outs[2])
    assert bool(torch.isfinite(outs[0]).all())
