"""``gather_refine_span_ms`` (layer: fine levels, the gathered
plane-fitting refine, ``ops/refine.py::blf_refine_flow`` over kernel E):
the median over the span stretch's pairs (``spans.py``) of the pair's
``L<l>.gather_refine`` spans of every level, summed; nothing where the
configuration refines by dense passes."""

from .. import spans


def gather_refine(name: str) -> bool:
    return name.startswith("L") and name.endswith(".gather_refine")


def read(run):
    return spans.stage_ms(spans.of(run), gather_refine)
