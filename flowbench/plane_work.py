"""The work of kernel A's plane mode (``dense_pass1_planes``,
``dense_pass2_planes``: ``eppm_tpu_torch/ops/dense.py::dense_refine_flow``
over ``ops/cuda_cost.py::residual_costs_planes_cuda``,
``eppm_tpu_torch/csrc/cost.cu``), counted from the configuration and the
frame size, for ``plane_refine_roofline_pct``; and, by ``kernel_a_work``,
the count of every launch of kernel A that ``chip_smoke.py`` bounds, so
that its kernel table and the benchmark read one yardstick.

A plane pass scores its K candidates over the 4 frame-2 tap tables of
the plane hypotheses (``reference/cost.py::plane_offsets``) of T taps
each and keeps the least.  Operations, float32, with ``stats.py``'s
counts per unit (an FMA 2, any other arithmetic, min, max or compare 1;
abs, negation, conversions and index arithmetic 0; an exp 27):

* per (map, padded pixel), the AD + census term (``COST_TERM_OPS``): a
  map is one distinct shift c + e_b(t) - d_t over the candidates c, the
  tables b and the taps t (``ops/cuda_cost.py::cost_plan``), and the
  terms pass covers the frame padded by the frame-1 taps' reach;
* per (pixel, tap), the frame-1 range distance (``COST_DR1_OPS``);
* per (candidate, table, pixel, tap), the weighted sums
  (``COST_SUM_OPS``);
* per (candidate, pixel), the least over the tables: one ``fminf`` a
  table past the first.

Bytes, each input read once and each output written once: the packs
(float4, 16 B a pixel) and a float32 cost per (candidate, pixel).  The
terms' maps are the kernel's own scratch, not the work's: the roofline
is of the least time for the pass's cost, a lower bound.
"""

from __future__ import annotations

from typing import List, Tuple

from .reference.config import config_from_dict
from .reference.cost import plane_offsets
from .reference.dense import center_out_offsets
from .stats import COST_DR1_OPS, COST_SUM_OPS, COST_TERM_OPS

__all__ = ["MIN_OPS", "n_maps", "kernel_a_work", "plane_pass_work",
           "plane_refine_work"]

# the least over the tables: one fminf a table past the first
MIN_OPS = 1


def n_maps(cands, taps, tables) -> int:
    """The distinct maps (frame, c + e_b(t) - d_t) that the terms pass
    computes, over candidates ``cands`` ((cy, cx) of frame 0, or (cy, cx,
    frame)), frame-1 taps ``taps`` and frame-2 tap tables ``tables``."""
    return len({(tuple(c[2:]), c[0] + ey - dy, c[1] + ex - dx)
                for c in cands for table in tables
                for (dy, dx), (ey, ex) in zip(taps, table)})


def kernel_a_work(h: int, w: int, cands, taps, tables,
                  n_frames: int = 1) -> Tuple[float, float]:
    """(operations, bytes) of one launch of kernel A at h x w over the
    candidates ``cands`` ((cy, cx) or (cy, cx, frame)), frame-1 taps
    ``taps`` and frame-2 tap tables ``tables`` (one in the fronto and
    multiwarp modes, 4 in the plane mode), reading ``n_frames`` frame-2
    packs.  With one table it is ``stats.refine_cost_work``'s count of a
    fronto pass."""
    k, t, b = len(cands), len(taps), len(tables)
    reach = max(max(abs(dy), abs(dx)) for dy, dx in taps)
    padded = (h + 2 * reach) * (w + 2 * reach)
    ops = (n_maps(cands, taps, tables) * padded * COST_TERM_OPS
           + h * w * t * COST_DR1_OPS
           + k * b * h * w * t * COST_SUM_OPS
           + k * h * w * (b - 1) * MIN_OPS)
    nbytes = (1 + n_frames) * h * w * 16 + k * h * w * 4
    return float(ops), float(nbytes)


def plane_pass_work(h: int, w: int, cost, search_radius: int,
                    cand_shape: str) -> Tuple[float, float]:
    """(operations, bytes) of one plane-mode pass's cost at an h x w
    level under the cost configuration ``cost`` (a reference
    ``CostConfig``), its candidates the ``cand_shape`` ball of
    ``search_radius``."""
    return kernel_a_work(h, w, center_out_offsets(search_radius, cand_shape),
                         list(cost.tap_offsets), plane_offsets(cost))


def plane_refine_work(config: dict, h: int, w: int
                      ) -> List[Tuple[float, float]]:
    """(operations, bytes) of each of level 0's refine passes of an
    ``h`` x ``w`` pair under ``config`` (an ``EPPMConfig`` as a dict),
    each pass taking the plane tables; empty unless every pass does."""
    cfg = config_from_dict(config)
    n = cfg.dense_refine_passes
    if (cfg.refine_impl != "dense" or not cfg.dense_pass1_planes
            or (n > 1 and not cfg.dense_pass2_planes)):
        return []
    radius = cfg.dense_search_radius
    return ([plane_pass_work(h, w, cfg.cost, radius, cfg.dense_cand_shape)]
            + [plane_pass_work(h, w, cfg.pass2_cost, radius,
                               cfg.pass2_cand_shape)] * (n - 1))
