"""``graph_nodes_per_pair`` (layer: the entry, ``pipeline.
compute_flow_jit`` over ``graphs.py``): the nodes of the CUDA graph that
the window replays (in a video the warm pair's), counted on the card by
``FlowGraph.nodes()`` (``cudaGraphGetNodes``); captured again with
tracing off by the span stretch (``spans.py``), so it holds no mark."""

from .. import spans


def read(run):
    s = spans.of(run)
    if s is None or not s.equal or s.nodes_untraced is None:
        return None
    return sum(s.nodes_untraced["total"].values())
