"""The work of the gathered plane-fitting refine (``refine_impl=
"gather"``: ``eppm_tpu_torch/ops/refine.py::blf_refine_flow`` over
kernel E, ``eppm_tpu_torch/csrc/patchmatch.cu``), counted from the
configuration and the frame size, for ``gather_refine_roofline_pct``.

At each fine level the refine makes 9 launches of kernel E's cost-only
mode, one a candidate of the 3x3 re-search, each K = 1 candidate field
over the 4 plane tables (``reference/cost.py::plane_offsets``) of T taps.
Operations, float32, counted from ``csrc/patchmatch.cu``'s
``patchmatch_kernel`` as ``chip_smoke.py``'s ``PM_TAP_OPS`` counts them
(an FMA 2, any other arithmetic, min, max or compare 1; abs, negation,
conversions and index arithmetic 0; an exp, ``exp_cephes``, 27):

* per (candidate, table, pixel, tap), the inner loop: ``dr1``, ``dr2``
  and ``ad``, three ``maxabs3`` of 5; the range weight's two squares,
  sum, scale, the exp, the spatial scale and the flush, 6 + 27; ``ad``'s
  square and scale 2, its exp 27 and ``1 -`` 1; the term's sum and
  product 2; the chunk's two partial sums 2: ``TAP_OPS`` = 82;
* per (candidate, table, pixel, chunk): the chunk added to the two
  sums, 2;
* per (candidate, table, pixel): the division and ``fmaxf`` 2, and past
  the first table the ``fminf`` 1.

Bytes, each input read once and each output written once: both packs
(float4, 16 B a pixel), the candidate's targets (two int32) and its cost
(float32) a pixel, in each launch.  The folds between launches
(``torch.where`` in ``blf_refine_flow``) are not counted: the roofline is
of kernel E's work alone, over the whole span, a lower bound.
"""

from __future__ import annotations

from typing import List, Tuple

from .reference.config import config_from_dict
from .reference.cost import plane_offsets

__all__ = ["TAP_OPS", "CHUNK_OPS", "TABLE_OPS", "CANDIDATES",
           "gather_refine_work"]

TAP_OPS = 82
CHUNK_OPS = 2
TABLE_OPS = 2
# the 3x3 re-search around trunc(flow), one launch each
CANDIDATES = 9


def gather_refine_work(config: dict, h: int, w: int
                       ) -> List[Tuple[float, float]]:
    """(operations, bytes) of each of the gathered refine's launches of
    kernel E, at every fine level of an ``h`` x ``w`` pair under
    ``config`` (an ``EPPMConfig`` as a dict)."""
    cfg = config_from_dict(config)
    taps = len(cfg.cost.tap_offsets)
    tables = len(plane_offsets(cfg.cost))
    chunk = max(1, cfg.cost_tap_chunk)
    chunks = -(-taps // chunk)
    per_pixel = (tables * (taps * TAP_OPS + chunks * CHUNK_OPS + TABLE_OPS)
                 + tables - 1)
    works = []
    for lh, lw in cfg.pyramid.level_dims(h, w)[:-1]:
        n = lh * lw
        works += [(float(per_pixel * n), float(n * (2 * 16 + 8 + 4)))
                  ] * CANDIDATES
    return works
