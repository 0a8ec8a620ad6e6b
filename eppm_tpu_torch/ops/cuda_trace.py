"""The tracer's device side (``csrc/trace.cu``): a mark kernel that stamps
the card's clock into a ring held in device memory, its anchor, and the
count of a captured CUDA graph's nodes.

Replaces no TPU kernel.  ``MARK.launches`` counts the marks that ran on the
card: under capture ``graphs.py`` takes them back off and each replay adds
them, as for every kernel.  ``read`` and ``reset`` block; the tracer calls
them only when it starts and when it collects (``utils/trace.py``), never
inside a replay.
"""

from __future__ import annotations

import ctypes
from typing import Dict, List, Tuple

import numpy as np
import torch

from ._build import CudaKernel

__all__ = ["MARK", "ANCHOR", "NODE_TYPES", "geometry", "mark", "anchor",
           "reset", "read", "graph_nodes", "by_type", "rows_by_type"]

_P = ctypes.c_void_p
_I = ctypes.c_int
MARK = CudaKernel("eppm_trace_mark", [_I, _I, _P])
ANCHOR = CudaKernel("eppm_trace_anchor", [_P])
_GEOMETRY = CudaKernel("eppm_trace_geometry", [_P, _P])
_RESET = CudaKernel("eppm_trace_reset", [])
_READ = CudaKernel("eppm_trace_read", [_P, _P, _P, _P])
_NODES = CudaKernel("eppm_graph_nodes", [_P, _I, _P, _P])
# the columns of ``graph_nodes``' counts, csrc/trace.cu's order
NODE_TYPES = ("kernel", "memcpy", "memset", "other", "mark")


def geometry() -> Tuple[int, int]:
    """(rows, slots) of the ring: the sequences it keeps, the marks a
    sequence may hold."""
    rows, slots = ctypes.c_int(), ctypes.c_int()
    _GEOMETRY.call(ctypes.byref(rows), ctypes.byref(slots))
    return rows.value, slots.value


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def mark(device: torch.device, slot: int, last: bool) -> None:
    """Stamp slot ``slot`` of the current sequence's row on the current
    stream of ``device``; ``last`` ends the sequence."""
    with torch.cuda.device(device):
        MARK.launch(slot, int(last), _stream(device))


def anchor(device: torch.device) -> None:
    """Stamp the anchor word on the current stream of ``device``."""
    with torch.cuda.device(device):
        ANCHOR.launch(_stream(device))


def reset(device: torch.device) -> None:
    """Zero ``device``'s count of finished sequences (blocking)."""
    with torch.cuda.device(device):
        _RESET.call()


def read(device: torch.device):
    """(ring (rows, slots), each row's sequence number, the count of
    finished sequences, the anchor's stamp) of ``device``, as uint64 ns
    (blocking)."""
    rows, slots = geometry()
    ring = np.zeros((rows, slots), np.uint64)
    seq = np.zeros(rows, np.uint64)
    count, stamp = ctypes.c_ulonglong(), ctypes.c_ulonglong()
    with torch.cuda.device(device):
        _READ.call(ring.ctypes.data, seq.ctypes.data, ctypes.byref(count),
                   ctypes.byref(stamp))
    return ring, seq, count.value, stamp.value


def graph_nodes(raw_graph: int, rows: int) -> Tuple[np.ndarray, int]:
    """(counts (rows, len(NODE_TYPES)), marks found) of the CUDA graph at
    ``raw_graph`` (``CUDAGraph.raw_cuda_graph()``): row 0 the nodes before
    the first mark, row m + 1 those after the graph's m-th mark."""
    counts = np.zeros((rows, len(NODE_TYPES)), np.int32)
    found = ctypes.c_int()
    _NODES.call(raw_graph, rows, counts.ctypes.data, ctypes.byref(found))
    return counts, found.value


def by_type(counts: np.ndarray) -> Dict[str, int]:
    """A ``graph_nodes`` count summed over its rows, by node type."""
    return {t: int(n) for t, n in zip(NODE_TYPES, counts.sum(axis=0))}


def rows_by_type(counts: np.ndarray) -> List[Dict[str, int]]:
    return [{t: int(n) for t, n in zip(NODE_TYPES, row)} for row in counts]
