"""``smooth_span_ms`` (layer: smoothing, kernel B via
``ops/cuda_smooth.py``): the median over the span stretch's pairs
(``spans.py``) of the pair's ``L<l>.smooth`` spans and ``final_smooth``,
summed."""

from .. import spans


def read(run):
    return spans.stage_ms(spans.of(run), spans.SMOOTH)
