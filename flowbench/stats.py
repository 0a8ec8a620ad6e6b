"""The benchmark's arithmetic: rates, percentiles, spreads, and the
roofline of the fine levels' cost (a copy of ``chip_smoke.py``'s
operation counts for kernel A's work, against the H100's published
peaks)."""

from __future__ import annotations

import math
import statistics
from typing import Dict, Optional, Sequence, Tuple

__all__ = ["rate", "percentile", "spread", "PEAKS", "refine_cost_work",
           "roofline_pct", "bound_ms"]


def rate(count: int, seconds: float) -> float:
    """``count`` pieces of work over ``seconds``: all the work over all
    the time."""
    if seconds <= 0:
        raise ValueError(f"a rate over {seconds} s")
    return count / seconds


def percentile(values: Sequence[float], q: float) -> float:
    """The ``q``-th percentile (0-100) of ``values``, linear between the
    closest ranks (numpy's default, ``method="linear"``)."""
    xs = sorted(values)
    if not xs:
        raise ValueError("percentile of no values")
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def spread(values: Sequence[float]) -> float:
    """The distance between the first and the third quartile as a share
    of the median (``statistics.quantiles(values, n=4)``, the method the
    bounds are set by)."""
    q1, med, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / abs(med)


# Published peaks of one H100 SXM at 700 W (NVIDIA's data sheet, dense):
# float32 outside the tensor cores, and device memory.
PEAKS: Dict[str, float] = {"f32_flops": 67e12, "hbm_bytes_per_s": 3.35e12}

# float32 operations per unit of kernel A's work, counted from the
# kernels' sources (chip_smoke.py): an FMA counts 2, any other
# arithmetic, min, max or compare 1, abs, negation, conversions and index
# arithmetic 0, an exp 27.  Per (candidate, pixel, tap): the range weight,
# its exp, the flush and two sums; per (pixel, tap): the frame-1 range
# distance; per (shift, padded pixel): the AD + census term.
COST_SUM_OPS = 41
COST_DR1_OPS = 5
COST_TERM_OPS = 66


def bound_ms(ops: float, nbytes: float,
             peaks: Dict[str, float] = PEAKS) -> Tuple[float, str]:
    """(ms, what bounds it): the least time for ``ops`` float32
    operations and ``nbytes`` of device memory traffic, the larger of the
    two."""
    t_ops = ops / peaks["f32_flops"] * 1e3
    t_bytes = nbytes / peaks["hbm_bytes_per_s"] * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def _taps(radius: int, stride: int):
    r = range(-radius, radius + 1, stride)
    return [(i, j) for i in r for j in r]


def _cands(radius: int, shape: str):
    c = [(m, n) for m in range(-radius, radius + 1)
         for n in range(-radius, radius + 1)]
    if shape == "plus":
        c = [x for x in c if abs(x[0]) + abs(x[1]) <= radius]
    return c


def refine_cost_work(h: int, w: int, patch_radius: int, patch_stride: int,
                     search_radius: int, cand_shape: str
                     ) -> Tuple[float, float]:
    """(operations, bytes) of one fronto-parallel dense refine pass's cost
    at an H x W level: K candidates, each one shift of frame 2, over the
    T taps of the patch grid.  The AD + census term once per (shift,
    padded pixel), the frame-1 range distance per (pixel, tap), the
    weighted sums per (candidate, pixel, tap); both packed frames
    (float4) read once, a float32 cost per (candidate, pixel) written."""
    taps = _taps(patch_radius, patch_stride)
    k = len(_cands(search_radius, cand_shape))
    reach = max(max(abs(a), abs(b)) for a, b in taps)
    hp, wp = h + 2 * reach, w + 2 * reach
    ops = (k * h * w * len(taps) * COST_SUM_OPS
           + h * w * len(taps) * COST_DR1_OPS
           + k * hp * wp * COST_TERM_OPS)
    nbytes = 2 * h * w * 16 + k * h * w * 4
    return float(ops), float(nbytes)


def roofline_pct(works: Sequence[Tuple[float, float]], measured_ms: float,
                 peaks: Dict[str, float] = PEAKS) -> Optional[float]:
    """The least time of the ``works`` ((operations, bytes) each, bounded
    one by one) over ``measured_ms``, in %; None without a time."""
    if not measured_ms or measured_ms <= 0:
        return None
    least = sum(bound_ms(ops, nbytes, peaks)[0] for ops, nbytes in works)
    return 100.0 * least / measured_ms
