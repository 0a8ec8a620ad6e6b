"""``occlusion_wmf_span_ms`` (layer: coarse clean-up, ``ops/occlusion.py``'s
legacy order over kernel C): the median over the span stretch's pairs
(``spans.py``) of the pair's ``occlusion.wmf`` span, the
``wmf_coarse_iters`` occlusion-only Jacobi iterations before the hole
fill; nothing where the program does not mark it (the fill-first order,
or a program without the mark)."""

from .. import spans


def read(run):
    return spans.stage_ms(spans.of(run), lambda name: name == "occlusion.wmf")
