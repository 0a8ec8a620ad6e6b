"""``pairs_per_s``: pairs whose flow reached the host in the window, over
the window's seconds (from its start to its last pair's end)."""

from ..stats import rate


def read(run):
    return rate(len(run.pair_ms), run.window_s)
