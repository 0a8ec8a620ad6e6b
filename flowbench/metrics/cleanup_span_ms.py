"""``cleanup_span_ms`` (layer: the coarse clean-up, ``ops/refine.py``'s
LR check and outlier removal, ``ops/occlusion.py``): the median over the
span stretch's pairs (``spans.py``) of the pair's ``lr_check``,
``outliers`` and ``occlusion`` spans, summed."""

from .. import spans


def read(run):
    return spans.stage_ms(spans.of(run), lambda name: name in spans.CLEANUP)
