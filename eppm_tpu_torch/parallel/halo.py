"""Halo exchange between the tiles of a device mesh (counterpart of
``eppm_tpu/parallel/halo.py``).

The JAX package runs one program over the mesh under ``shard_map`` and
moves each tile's ring with ``ppermute``.  The port is one controller
too: a tile is a tensor on its mesh device, the tiles along a mesh axis
are a list in mesh order, and the exchange copies the strips a tile
needs from its neighbours' devices with ``.to(device)`` — never the whole
array.  At the mesh's outer border the ring is the global edge row or
column replicated (``"edge"``: the clamp-to-edge addressing of the
single-device pipeline) or a constant (``UNKNOWN_FLOW`` for a flow, whose
out-of-image taps the smoothing skips).

A halo wider than the tile (small pyramid levels on large meshes) takes
the tiles at distances 1..K and stitches them before slicing the ring.
"""

from __future__ import annotations

from typing import List, Sequence, Union

import torch

__all__ = ["halo_exchange_1d", "halo_exchange_2d"]

Boundary = Union[str, float]


def _exchange(tiles: Sequence[torch.Tensor], i: int, halo: int, dim: int,
              boundary: Boundary) -> torch.Tensor:
    """Tile ``i`` of ``tiles`` extended by ``halo`` along ``dim``, on its
    own device."""
    n = len(tiles)
    tile = tiles[i]
    dev = tile.device
    size = tile.shape[dim]
    k_hops = -(-halo // size)

    def fill(like: torch.Tensor) -> torch.Tensor:
        # placeholder for a neighbour beyond the mesh border; the
        # boundary fill below overwrites it
        return torch.zeros_like(like, device=dev)

    if k_hops == 1 and halo < size:
        # the common case: only the halo strips move, traffic in
        # proportion to the tile's boundary, not its area
        lo_strip = lambda t: t.narrow(dim, size - halo, halo)  # to next
        hi_strip = lambda t: t.narrow(dim, 0, halo)            # to prev
        prev_part = (lo_strip(tiles[i - 1]).to(dev) if i > 0
                     else fill(lo_strip(tile)))
        next_part = (hi_strip(tiles[i + 1]).to(dev) if i + 1 < n
                     else fill(hi_strip(tile)))
        ext = torch.cat([prev_part, tile, next_part], dim)
    else:
        parts = [tiles[i - k].to(dev) if i - k >= 0 else fill(tile)
                 for k in range(k_hops, 0, -1)]
        parts.append(tile)
        parts += [tiles[i + k].to(dev) if i + k < n else fill(tile)
                  for k in range(1, k_hops + 1)]
        ext = torch.cat(parts, dim).narrow(dim, k_hops * size - halo,
                                           size + 2 * halo)

    # positions beyond the global array: the first ``below`` and the last
    # ``above`` of the ring
    below = max(0, halo - i * size)
    above = max(0, (i + 1) * size + halo - n * size)
    if not (below or above):
        return ext
    length = size + 2 * halo
    mid = ext.narrow(dim, below, length - below - above)

    def ring(count: int, edge_pos: int) -> torch.Tensor:
        if boundary == "edge":
            row = ext.narrow(dim, edge_pos, 1)
        else:
            row = torch.full_like(ext.narrow(dim, 0, 1), float(boundary))
        shape = list(ext.shape)
        shape[dim] = count
        return row.expand(shape)

    pieces = []
    if below:
        # the global first row sits at ring position halo - i * size
        pieces.append(ring(below, halo - i * size))
    pieces.append(mid)
    if above:
        # the global last row at (n - i) * size - 1 + halo
        pieces.append(ring(above, (n - i) * size - 1 + halo))
    return torch.cat(pieces, dim)


def halo_exchange_1d(tiles: Sequence[torch.Tensor], halo: int, dim: int,
                     boundary: Boundary = "edge") -> List[torch.Tensor]:
    """Pad each of ``tiles`` (the tiles along one mesh axis, in order,
    each on its own device, all of one extent along ``dim``) with
    ``halo`` rows or columns along ``dim``, filled from its neighbours
    (multi-hop where ``halo`` exceeds the tile) and at the global border
    by ``boundary``: ``"edge"`` replicates the global edge, a float fills
    a constant."""
    if halo <= 0:
        return list(tiles)
    return [_exchange(tiles, i, halo, dim, boundary)
            for i in range(len(tiles))]


def halo_exchange_2d(tiles: Sequence[Sequence[torch.Tensor]], halo: int,
                     boundary: Boundary = "edge"
                     ) -> List[List[torch.Tensor]]:
    """Exchange a ``halo``-wide ring in both spatial dims (0 and 1) of a
    (y, x) grid of tiles, ``tiles[iy][ix]``.  y goes first, then x over
    the extended rows, so the corners come from the diagonal neighbours
    (their y halos ride along)."""
    ny, nx = len(tiles), len(tiles[0])
    cols = [halo_exchange_1d([tiles[iy][ix] for iy in range(ny)], halo, 0,
                             boundary) for ix in range(nx)]
    return [halo_exchange_1d([cols[ix][iy] for ix in range(nx)], halo, 1,
                             boundary) for iy in range(ny)]
