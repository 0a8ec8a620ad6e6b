"""``match_span_ms`` (layer: the coarse match, ``ops/match.py`` or
``ops/patchmatch.py``): the median over the span stretch's pairs
(``spans.py``) of the pair's ``match`` span, stamped by the port's marks
inside the replayed graph."""

from .. import spans


def read(run):
    return spans.stage_ms(spans.of(run), lambda name: name == "match")
