"""``pair_ms_p90``: the 90th percentile of the latency of every pair of
the window, from handing over its host frames to its flow on the host."""

from ..stats import percentile


def read(run):
    return percentile(run.pair_ms, 90)
