"""The port's halo exchange (``eppm_tpu_torch/parallel/halo.py``) over the
tiles of a CPU mesh, against slicing a globally padded array — the
counterpart of tests/test_sharded.py's halo tests, which run
``eppm_tpu``'s exchange under ``shard_map``.  Tolerance: none, every tile
with its halo is identical to the padded slice."""

import numpy as np
import pytest
import torch

from eppm_tpu_torch.config import UNKNOWN_FLOW
from eppm_tpu_torch.parallel import (halo_exchange_1d, halo_exchange_2d,
                                     make_mesh)


def tiles_of(full: np.ndarray, ny: int, nx: int):
    th, tw = full.shape[0] // ny, full.shape[1] // nx
    return [[torch.from_numpy(full[iy * th:(iy + 1) * th,
                                   ix * tw:(ix + 1) * tw].copy())
              for ix in range(nx)] for iy in range(ny)]


def padded(full: np.ndarray, halo: int, boundary):
    pad = ((halo, halo), (halo, halo)) + ((0, 0),) * (full.ndim - 2)
    if boundary == "edge":
        return np.pad(full, pad, mode="edge")
    return np.pad(full, pad, constant_values=boundary)


@pytest.mark.parametrize("boundary", ["edge", -1.0, UNKNOWN_FLOW])
@pytest.mark.parametrize("ny,nx,halo", [
    (1, 2, 3), (2, 1, 3), (2, 2, 3),
    (2, 2, 10),   # multi-hop: the halo is wider than the 8 x 12 tiles
    (4, 2, 9),    # two hops along y, one along x
])
def test_halo_exchange_matches_pad(ny, nx, halo, boundary):
    rng = np.random.default_rng(0)
    full = rng.random((max(16, 8 * ny), 24, 2)).astype(np.float32)
    th, tw = full.shape[0] // ny, full.shape[1] // nx
    got = halo_exchange_2d(tiles_of(full, ny, nx), halo, boundary)
    want = padded(full, halo, boundary)
    for iy in range(ny):
        for ix in range(nx):
            np.testing.assert_array_equal(
                got[iy][ix].numpy(),
                want[iy * th:iy * th + th + 2 * halo,
                     ix * tw:ix * tw + tw + 2 * halo])


def test_halo_exchange_constant_boundary():
    """The JAX package's case: a (2, 1) mesh with a constant ring, the
    bottom halo of the top tile from the next tile along y."""
    full = np.arange(8.0 * 4, dtype=np.float32).reshape(8, 4)
    top = halo_exchange_2d(tiles_of(full, 2, 1), 2, boundary=-1.0)[0][0]
    top = top.numpy()
    assert (top[:2] == -1.0).all()
    assert (top[:, :2] == -1.0).all()
    np.testing.assert_array_equal(top[6:8, 2:6], full[4:6])


def test_halo_exchange_1d_moves_strips_to_each_tile_device():
    """Each extended tile lies on its own tile's device, and a zero halo
    returns the tiles as they are."""
    tiles = [torch.arange(12.0).reshape(4, 3) + 100 * i for i in range(3)]
    out = halo_exchange_1d(tiles, 2, dim=0)
    assert [tuple(t.shape) for t in out] == [(8, 3)] * 3
    np.testing.assert_array_equal(out[1][:2].numpy(), tiles[0][2:].numpy())
    np.testing.assert_array_equal(out[1][-2:].numpy(), tiles[2][:2].numpy())
    assert all(t.device == torch.device("cpu") for t in out)
    assert halo_exchange_1d(tiles, 0, dim=1) == tiles


def test_make_mesh():
    """A (batch, y, x) mesh of the devices given, which may repeat; too
    few devices raise as the JAX package's make_mesh does."""
    mesh = make_mesh(2, 1, 2, devices=["cpu"] * 4)
    assert mesh.devices.shape == (2, 1, 2)
    assert all(d == torch.device("cpu") for d in mesh.devices.ravel())
    with pytest.raises(ValueError, match="need 4 devices, have 3"):
        make_mesh(1, 2, 2, devices=["cpu"] * 3)
    if not torch.cuda.is_available():
        with pytest.raises(ValueError, match="need 1 devices, have 0"):
            make_mesh()
