"""``prepare_span_ms`` (layer: prepare, ``pipeline.prepare_pyramids``):
the median over the span stretch's pairs (``spans.py``) of the pair's
``prepare`` span, stamped by the port's marks inside the replayed graph."""

from .. import spans


def read(run):
    return spans.stage_ms(spans.of(run), lambda name: name == "prepare")
