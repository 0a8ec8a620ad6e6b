"""``plane_refine_roofline_pct`` (layer: fine levels, plane mode,
``ops/dense.py::dense_refine_flow`` over kernel A's plane tables): the
least time for the cost of level 0's refine passes over the 4 plane
tables (``plane_work.plane_refine_work``, counted from the configuration
and the frame size, against the published float32 and memory peaks,
``stats.bound_ms``), over the program's own spans of those passes, the
median over the span stretch's pairs (``spans.py``) of ``L0.pass<n>``
summed.  Nothing where a pass is fronto-parallel, or the spans are
missing."""

from .. import spans
from ..plane_work import plane_refine_work
from ..stats import roofline_pct


def read(run):
    works = plane_refine_work(run.config, run.height, run.width)
    if not works:
        return None
    names = [f"L0.pass{i + 1}" for i in range(len(works))]
    s = spans.of(run)
    if any(spans.stage_ms(s, lambda m, n=n: m == n) is None for n in names):
        return None
    ms = spans.stage_ms(s, set(names).__contains__)
    if ms is None:
        return None
    return roofline_pct(works, ms)
