"""``gather_refine_roofline_pct`` (layer: fine levels, the gathered
plane-fitting refine over kernel E): the least time for kernel E's work
in the refine at every fine level (``gather_work.gather_refine_work``:
9 candidates x 4 plane tables x T taps a pixel, counted from the
configuration and the frame size, against the published float32 and
memory peaks, ``stats.bound_ms``), over ``gather_refine_span_ms``, the
program's own spans.  Nothing where the configuration refines by dense
passes, or the spans are missing."""

from ..gather_work import gather_refine_work
from ..stats import roofline_pct
from . import gather_refine_span_ms


def read(run):
    if run.config["refine_impl"] != "gather":
        return None
    ms = gather_refine_span_ms.read(run)
    if ms is None:
        return None
    return roofline_pct(gather_refine_work(run.config, run.height,
                                           run.width), ms)
