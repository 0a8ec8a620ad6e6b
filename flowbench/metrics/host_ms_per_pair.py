"""``host_ms_per_pair`` (layer: the entry, ``pipeline.compute_flow_jit``
over ``graphs.py``, the frames' upload and the flow's read back): the
median over the window's pairs of the pair's host ms less its replay's
device ms (CUDA events around the entry point's call)."""

import statistics


def read(run):
    if not run.replay_ms:
        return None
    return statistics.median(p - r for p, r in zip(run.pair_ms, run.replay_ms))
