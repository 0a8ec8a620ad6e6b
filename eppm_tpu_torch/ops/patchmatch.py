"""PatchMatch nearest-neighbour-field search on PyTorch (counterpart of
``eppm_tpu/ops/patchmatch.py``).

Spec: ``baoCudaPatchMatch`` (bao_pmflow_kernel.cu:1760-1826): a random
NNF (:73-109), its cost (:636-645), then ``num_iters`` rounds of
propagation and random search (:1519-1586).  As in the JAX package, the
reference's sequential segment sweeps (:979-1181) are Jacobi jump-flood
rounds: every pixel tries the offsets of its 4 axial neighbours at each
step of ``prop_steps`` (the reference ships such a variant, :800-857).
A candidate replaces the incumbent only on a strictly lower raw float32
cost; ties keep the incumbent.  The NNF is absolute int32 targets.

The costs are the gathered costs of ``ops/cost.py``: the JAX package
reaches no Pallas kernel on this loop.  On the card each cost and fold is
one launch of kernel E (``ops/cuda_patchmatch.py``): the init's cost,
each propagation round (its neighbours' targets computed in the kernel)
and each random search's guesses; ``select_candidates`` and
``propagate_candidates`` are its plain versions.

Randomness goes through a sampler.  ``ThreefrySampler`` makes the JAX
package's draws from a key (``ops/prng.py``: JAX's threefry key
arithmetic, bit for bit), in the JAX package's key structure: the key
splits into the init and loop keys, the init fields draw from
``split(init_key, n)``, iteration i's guesses from ``split(fold_in(
loop_key, i), n)``.  ``TorchSampler`` draws from an explicit
``torch.Generator`` instead (its streams are torch's, not the JAX
package's).  A sampler has two methods, each returning one int32 field
per (low, high) bound, uniform in [low, high) pixel by pixel (a bound is
an int or an int32 field):

- ``init(shape, bounds, device)``: the random NNF (and scales);
- ``search(it, shape, bounds, device)``: iteration ``it``'s guesses, in
  the order (x, y) per magnitude, or (x, y, scale) for the scaled
  variant.

The loops have fixed trip counts and read nothing back to the host.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple, Union

import torch

from ..config import CostConfig, PatchMatchConfig
from . import prng
from ._util import inv32, pad_edge, shift2d
from .cost import (TAP_CHUNK, patch_cost, patch_cost_scaled,
                   patch_cost_tables, plane_offsets)

__all__ = [
    "ThreefrySampler",
    "TorchSampler",
    "random_init",
    "random_init_scaled",
    "select_candidates",
    "propagate_candidates",
    "propagate_round",
    "line_propagate",
    "random_search",
    "patchmatch",
    "patchmatch_scaled",
    "patchmatch_planefitting",
]

Bound = Union[int, torch.Tensor]


class ThreefrySampler:
    """The JAX package's draws from ``key`` (a (2,) int64 key of
    ``ops/prng.py``, e.g. ``prng_key(seed)``), on the key's device.  All
    fields of one ``init`` or ``search`` call come from one vectorised
    threefry pass: their keys stacked against the counters, so a call
    costs the same few hundred elementwise launches for any number of
    fields.  The iterations' keys, ``split(fold_in(loop_key, i), n)``,
    are made for a block of iterations at once and kept."""

    def __init__(self, key: torch.Tensor):
        self.init_key, self.loop_key = prng.split(key).unbind(0)
        self._iter_keys = {}   # n -> (iterations, n, 2)

    @staticmethod
    def _draw(keys, shape, bounds: Sequence[Tuple[Bound, Bound]], device
              ) -> List[torch.Tensor]:
        keys = keys.to(device)

        def field(v):
            if torch.is_tensor(v):
                return v.to(device=device, dtype=torch.int64)
            return torch.full(tuple(shape), int(v), dtype=torch.int64,
                              device=device)

        def stack(vals):
            return torch.stack([field(v).expand(tuple(shape)) for v in vals])

        lo = stack([b[0] for b in bounds])
        hi = stack([b[1] for b in bounds])
        return list(prng.randint(keys, shape, lo, hi).unbind(0))

    def init(self, shape, bounds, device) -> List[torch.Tensor]:
        return self._draw(prng.split(self.init_key, len(bounds)), shape,
                          bounds, device)

    def search(self, it: int, shape, bounds, device) -> List[torch.Tensor]:
        n = len(bounds)
        keys = self._iter_keys.get(n)
        if keys is None or it >= keys.shape[0]:
            count = max(16, it + 1, 0 if keys is None else 2 * keys.shape[0])
            its = torch.arange(count, device=self.loop_key.device)
            keys = prng.split(prng.fold_in(self.loop_key, its), n)
            self._iter_keys[n] = keys
        return self._draw(keys[it], shape, bounds, device)


class TorchSampler:
    """Draws from an explicit ``torch.Generator``, in call order.

    Each field is 62 random bits a pixel, drawn on the generator's device
    and moved to ``device``, taken modulo the span: exact integers in
    [low, high), never ``high`` (``floor(rand * span)`` in float32 can
    round up to it).  The bias of the modulo is below 2^-50.  A generator
    on the CPU serves a run on the card with the CPU's stream, so the
    card and the CPU can be given the same draws."""

    def __init__(self, generator: torch.Generator):
        self.generator = generator

    def _draw(self, shape, bounds: Sequence[Tuple[Bound, Bound]], device
              ) -> List[torch.Tensor]:
        out = []
        for lo, hi in bounds:
            bits = torch.randint(0, 2**62, tuple(shape), dtype=torch.int64,
                                 generator=self.generator,
                                 device=self.generator.device).to(device)
            out.append((lo + bits % (hi - lo)).to(torch.int32))
        return out

    def init(self, shape, bounds, device) -> List[torch.Tensor]:
        return self._draw(shape, bounds, device)

    def search(self, it: int, shape, bounds, device) -> List[torch.Tensor]:
        return self._draw(shape, bounds, device)


def as_sampler(rng):
    """A sampler from a ``torch.Generator`` or a key; a sampler passes
    through."""
    if isinstance(rng, torch.Generator):
        return TorchSampler(rng)
    return ThreefrySampler(rng) if torch.is_tensor(rng) else rng


def random_init(sampler, h: int, w: int, device=None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Uniform random absolute targets: x in [0, w], y in [0, h]
    inclusive (d_gen_rand_field draws rand % (w+1), bao_pmflow_kernel.cu:
    97-98; the one-past-the-end target reads clamped pixels and the
    left-right check culls it)."""
    tx, ty = as_sampler(sampler).init((h, w), [(0, w + 1), (0, h + 1)],
                                      device)
    return tx, ty


def _scales(r: torch.Tensor, scale_min: int) -> torch.Tensor:
    """(10 + r - scale_min) / 10 as the JAX package's compiled program
    computes it: XLA turns the division by 10 into a multiplication by
    its float32 reciprocal (one value in 9 lands an ulp off the
    quotient)."""
    return (10.0 + (r - scale_min).to(torch.float32)) * inv32(10.0)


def random_init_scaled(sampler, h: int, w: int, device=None,
                       scale_range: int = 9, scale_min: int = 4
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """A random NNF plus a per-pixel patch scale (d_gen_rand_field_scaled,
    bao_pmflow_kernel.cu:112-151): scale = (10 + r - min) / 10 with r in
    [0, range), 0.6..1.4 for the defaults."""
    tx, ty, r = as_sampler(sampler).init(
        (h, w), [(0, w + 1), (0, h + 1), (0, scale_range)], device)
    return tx, ty, _scales(r, scale_min)


def _select_best(state, cands):
    """Fold candidate fields (each (K, H, W)) into the state (the
    targets, any carried fields, then the cost last), candidate by
    candidate: strict '<' as the reference's acceptance test
    (bao_pmflow_kernel.cu:1067, :1574), so ties keep the incumbent."""
    state = list(state)
    costs = cands[-1]
    for k in range(costs.shape[0]):
        better = costs[k] < state[-1]
        state = [torch.where(better, c[k], s) for s, c in zip(state, cands)]
    return tuple(state)


def _neighbour_targets(tx, ty, step: int):
    """The offsets of the 4 axial neighbours at distance ``step`` carried
    to each pixel (their targets less the step), clamped to the image
    (bao_pmflow_kernel.cu:1060-1076) -> (4, H, W) x2, and the (dy, dx)
    of each neighbour."""
    h, w = tx.shape
    dirs = ((0, -step), (0, step), (-step, 0), (step, 0))
    txs = torch.stack([(shift2d(tx, dy, dx) - dx).clamp(0, w - 1)
                       for dy, dx in dirs])
    tys = torch.stack([(shift2d(ty, dy, dx) - dy).clamp(0, h - 1)
                       for dy, dx in dirs])
    return txs, tys, dirs


def select_candidates(pack1, pack2, tx, ty, cost, txs, tys,
                      cost_cfg: CostConfig, tables, tap_chunk: int = TAP_CHUNK):
    """The gathered cost of the candidate fields (txs, tys) (K, H, W)
    (the least over the frame-2 tap ``tables``), folded into the state
    (tx, ty, cost) by ``_select_best``: the plain version of kernel E's
    fold (``ops/cuda_patchmatch.py``)."""
    costs = patch_cost_tables(pack1, pack2, txs, tys, cost_cfg, tables,
                              tap_chunk=tap_chunk)
    return _select_best((tx, ty, cost), (txs, tys, costs))


def propagate_candidates(pack1, pack2, tx, ty, cost, step: int,
                         cost_cfg: CostConfig, tables,
                         tap_chunk: int = TAP_CHUNK):
    """One Jacobi jump-flood round at distance ``step`` over the gathered
    cost of the tap ``tables``: the plain version of kernel E's
    propagation mode."""
    txs, tys, _ = _neighbour_targets(tx, ty, step)
    return select_candidates(pack1, pack2, tx, ty, cost, txs, tys, cost_cfg,
                             tables, tap_chunk)


def propagate_round(pack1, pack2, tx, ty, cost, step: int,
                    cost_cfg: CostConfig, tap_chunk: int = TAP_CHUNK):
    """One Jacobi jump-flood round at distance ``step``: each pixel tries
    the offsets of its 4 axial neighbours at that distance (kernel E on
    the card)."""
    from .cuda_patchmatch import propagate_candidates_auto
    return propagate_candidates_auto(pack1, pack2, tx, ty, cost, step,
                                     cost_cfg, [cost_cfg.tap_offsets],
                                     tap_chunk)


def _guess_bounds(tx, ty, mags, w: int, h: int):
    """Per magnitude, the (x, y) windows [max(t - mag, 0), min(t + mag +
    1, dim + 1)) around the incumbent (bao_pmflow_kernel.cu:1560-1564)."""
    out = []
    for mag in mags:
        out.append(((tx - mag).clamp_min(0), (tx + mag + 1).clamp_max(w + 1)))
        out.append(((ty - mag).clamp_min(0), (ty + mag + 1).clamp_max(h + 1)))
    return out


def _guesses(sampler, it: int, tx, ty, mags):
    """Iteration ``it``'s random guesses around the incumbent -> (K, H, W)
    x2."""
    h, w = tx.shape
    g = sampler.search(it, (h, w), _guess_bounds(tx, ty, mags, w, h),
                       tx.device)
    return torch.stack(g[0::2]), torch.stack(g[1::2])


def random_search(sampler, it: int, pack1, pack2, tx, ty, cost,
                  pm_cfg: PatchMatchConfig, cost_cfg: CostConfig,
                  tap_chunk: int = TAP_CHUNK):
    """Shrinking-window random search of iteration ``it``
    (bao_pmflow_kernel.cu:1519-1586): every guess is drawn around the
    incumbent (the reference draws all guesses before evaluating any),
    uniform in [max(t - mag, 0), min(t + mag + 1, dim + 1)) per axis,
    mag halving from ``search_range`` (``search_mags``)."""
    from .cuda_patchmatch import select_candidates_auto
    txs, tys = _guesses(as_sampler(sampler), it, tx, ty,
                        pm_cfg.search_mags())
    return select_candidates_auto(pack1, pack2, tx, ty, cost, txs, tys,
                                  cost_cfg, [cost_cfg.tap_offsets], tap_chunk)


def _patchmatch(pack1, pack2, sampler, pm_cfg: PatchMatchConfig,
                cost_cfg: CostConfig, tables, tap_chunk: int):
    """Random init, then ``num_iters`` x (a propagation round a step,
    then a random search), over the gathered cost of the frame-2 tap
    ``tables`` (the least over them): kernel E on the card, one launch
    for the init and one a round or search."""
    from . import cuda_patchmatch as kernel_e
    h, w = pack1.shape[0], pack1.shape[1]
    sampler = as_sampler(sampler)
    tx, ty = random_init(sampler, h, w, pack1.device)
    cost = kernel_e.patch_cost_tables_auto(pack1, pack2, tx, ty, cost_cfg,
                                           tables, tap_chunk=tap_chunk)
    mags = pm_cfg.search_mags()
    for i in range(pm_cfg.num_iters):
        for step in pm_cfg.prop_steps:
            tx, ty, cost = kernel_e.propagate_candidates_auto(
                pack1, pack2, tx, ty, cost, step, cost_cfg, tables,
                tap_chunk)
        txs, tys = _guesses(sampler, i, tx, ty, mags)
        tx, ty, cost = kernel_e.select_candidates_auto(
            pack1, pack2, tx, ty, cost, txs, tys, cost_cfg, tables,
            tap_chunk)
    return tx, ty, cost


def patchmatch(pack1, pack2, sampler, pm_cfg: PatchMatchConfig =
               PatchMatchConfig(), cost_cfg: CostConfig = CostConfig(),
               tap_chunk: int = TAP_CHUNK):
    """Full PatchMatch (bao_pmflow_kernel.cu:1760-1826) of pack1 into
    pack2 ((H, W, 4) packs on one device), drawing from ``sampler`` (a
    sampler, a key of ``ops/prng.py`` or a ``torch.Generator``) -> (tx,
    ty) absolute int32 targets and their float32 cost; the costs sum
    their taps in chunks of ``tap_chunk`` (``EPPMConfig.
    cost_tap_chunk``)."""
    return _patchmatch(pack1, pack2, sampler, pm_cfg, cost_cfg,
                       [cost_cfg.tap_offsets], tap_chunk)


def line_propagate(pack1, pack2, tx, ty, cost, cost_cfg: CostConfig,
                   tap_chunk: int = TAP_CHUNK):
    """Sequential scanline propagation (d_row_propagate /
    d_column_propagate and reverses, bao_pmflow_kernel.cu:862-974): four
    sweeps (row forward, column forward, row reverse, column reverse),
    each carrying the previous line's updated offset one step.  One
    column or row a step, so slow on any device by design; the
    production propagation is ``propagate_round``."""
    h, w = tx.shape
    R = cost_cfg.patch_radius
    pad1 = pad_edge(pack1, R, R)

    def sweep(tx, ty, cost, axis: int, reverse: bool):
        step = -1 if reverse else 1
        n = w if axis == 1 else h
        order = range(n - 1, -1, -1) if reverse else range(n)
        # lines as rows of (n, length) fields: columns for axis 1; rows
        # and tiles contiguous, as kernel E reads them on the card
        lines = [f.t() if axis == 1 else f for f in (tx, ty, cost)]
        out = [f.clone(memory_format=torch.contiguous_format)
               for f in lines]
        prev_tx, prev_ty = out[0][order[0]], out[1][order[0]]
        for i in order[1:]:
            if axis == 1:
                cand_tx, cand_ty = (prev_tx + step).clamp(0, w - 1), prev_ty
                tile = pad1[:, i : i + 1 + 2 * R].contiguous()
                c = patch_cost(tile, pack2, cand_tx[:, None],
                               cand_ty[:, None], cost_cfg, pack1_halo=R,
                               tap_chunk=tap_chunk)[:, 0]
            else:
                cand_tx, cand_ty = prev_tx, (prev_ty + step).clamp(0, h - 1)
                tile = pad1[i : i + 1 + 2 * R]
                c = patch_cost(tile, pack2, cand_tx[None], cand_ty[None],
                               cost_cfg, pack1_halo=R,
                               tap_chunk=tap_chunk)[0]
            better = c < out[2][i]
            out[0][i] = torch.where(better, cand_tx, out[0][i])
            out[1][i] = torch.where(better, cand_ty, out[1][i])
            out[2][i] = torch.where(better, c, out[2][i])
            prev_tx, prev_ty = out[0][i], out[1][i]
        return tuple(f.t() if axis == 1 else f for f in out)

    state = (tx, ty, cost)
    for axis, reverse in ((1, False), (0, False), (1, True), (0, True)):
        state = sweep(*state, axis, reverse)
    return state


def patchmatch_scaled(pack1, pack2, sampler, pm_cfg: PatchMatchConfig =
                      PatchMatchConfig(), cost_cfg: CostConfig = CostConfig(),
                      tap_chunk: int = TAP_CHUNK):
    """Scale-adaptive PatchMatch (baoCudaPatchMatch_Scaled,
    bao_pmflow_kernel.cu:1828-1896): the NNF carries a per-pixel patch
    scale; propagation passes the neighbour's scale with its offset,
    random search draws a fresh scale per guess -> (tx, ty, scale,
    cost)."""
    h, w = pack1.shape[0], pack1.shape[1]
    sampler = as_sampler(sampler)
    tx, ty, sc = random_init_scaled(sampler, h, w, pack1.device)
    cost = patch_cost_scaled(pack1, pack2, tx, ty, sc, cost_cfg, tap_chunk)
    mags = pm_cfg.search_mags()
    for i in range(pm_cfg.num_iters):
        for step in pm_cfg.prop_steps:
            txs, tys, dirs = _neighbour_targets(tx, ty, step)
            scs = torch.stack([shift2d(sc, dy, dx) for dy, dx in dirs])
            costs = patch_cost_scaled(pack1, pack2, txs, tys, scs, cost_cfg,
                                      tap_chunk)
            tx, ty, sc, cost = _select_best((tx, ty, sc, cost),
                                            (txs, tys, scs, costs))
        bounds = []
        xy = _guess_bounds(tx, ty, mags, w, h)
        for k in range(len(mags)):
            bounds += [xy[2 * k], xy[2 * k + 1], (0, 9)]
        g = sampler.search(i, (h, w), bounds, tx.device)
        txs, tys = torch.stack(g[0::3]), torch.stack(g[1::3])
        scs = _scales(torch.stack(g[2::3]), 4)
        costs = patch_cost_scaled(pack1, pack2, txs, tys, scs, cost_cfg,
                                  tap_chunk)
        tx, ty, sc, cost = _select_best((tx, ty, sc, cost),
                                        (txs, tys, scs, costs))
    return tx, ty, sc, cost


def patchmatch_planefitting(pack1, pack2, sampler, pm_cfg: PatchMatchConfig
                            = PatchMatchConfig(),
                            cost_cfg: CostConfig = CostConfig(),
                            tap_chunk: int = TAP_CHUNK):
    """PatchMatch over the plane-fitting cost, the least over 4 affine
    hypotheses (baoCudaPatchMatch_PlaneFitting, bao_pmflow_kernel.cu:
    1899-1963) -> (tx, ty, cost)."""
    return _patchmatch(pack1, pack2, sampler, pm_cfg, cost_cfg,
                       plane_offsets(cost_cfg), tap_chunk)
