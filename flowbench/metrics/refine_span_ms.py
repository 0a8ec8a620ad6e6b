"""``refine_span_ms`` (layer: the fine levels, ``ops/dense.py::
dense_refine_flow`` over kernel A): the median over the span stretch's
pairs (``spans.py``) of the pair's ``L<l>.upsample``, ``L<l>.pass<n>`` or
``L<l>.gather_refine`` spans of every level, and ``subpixel``, summed."""

from .. import spans


def read(run):
    return spans.stage_ms(spans.of(run), spans.REFINE)
