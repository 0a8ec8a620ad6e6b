"""``device_idle_pct`` (layer: the device): 100 x (1 - the span stretch's
``graph`` spans, one a pair, over the stretch, from its first client
span's start to its last one's end; ``spans.py``).  The client's upload
and read back count as idle: the card runs no graph of the pipeline
then.  The spans are the port's marks inside the replay, which cost a
node each, not a profiler's records."""

from .. import spans


def read(run):
    return spans.idle_pct(spans.of(run))
