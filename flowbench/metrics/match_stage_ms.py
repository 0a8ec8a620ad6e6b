"""``match_stage_ms`` (layer: the coarse match, ``ops/match.py::
match_coarse_bidi`` or the PatchMatch stage): the median device ms of the
stage's replays, the stage captured as a CUDA graph of its own on the
cell's pair (``stages.py``)."""

import statistics


def read(run):
    if not run.stages or "match" not in run.stages:
        return None
    return statistics.median(run.stages["match"])
