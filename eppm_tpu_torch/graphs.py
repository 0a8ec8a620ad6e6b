"""One CUDA graph per pair shape: the port's counterpart of the JAX
package's one-program entry point (``eppm_tpu/pipeline.py::
compute_flow_jit``, a ``jit`` whose cache keys on the shapes and on the
static ``cfg`` and ``fine_level_wmf``).

A pair of the eager pipeline makes tens of thousands of launches (about
72,700 device events at 1080p), each a few microseconds of host work
against little device work.  ``GraphCache.run`` captures the whole pair
into one CUDA graph the first time its key is seen and replays the graph
after that:

* the key: the device, both frames' shape and dtype, the ``EPPMConfig``
  (frozen and hashable), ``fine_level_wmf``, and whether ``init_flow``
  (with its shape and dtype) and the PatchMatch ``key`` are given
  (``graph_key``);
* the capture (``capture``): static input buffers hold the call's
  tensors; one eager warm-up call on a side stream makes the tables
  (each op's cache of device tables), the kernel library and cuBLAS's
  workspace for that stream outside the capture; then the same call is
  captured on the same stream into a graph with a memory pool of its own,
  and instantiated;
* a replay copies the call's tensors into the static buffers, replays
  the graph on the current stream and returns a clone of the static
  output, so that a later replay does not overwrite what a caller holds.

Every op of the pipeline runs on the device without reading anything
back, and copies nothing from the host once its tables are made
(``tests/test_torch_graph_ready.py``), so the graph runs the same
kernels on the same operands as the eager call: the replayed flow is
the eager flow, bit for bit.

Launch counts: under capture a kernel wrapper's ``launch`` records a
launch that does not run, so the capture takes its launches back off
each ``CudaKernel.launches`` and each replay adds them again: the counts
go on counting launches on the device.  A failed capture or replay
raises with the key; nothing falls back to the eager path.  The cache
holds ``MAX_GRAPHS`` graphs and evicts the least recently used (logged).
The multi-device entry, ``parallel.compute_flow_sharded``, keeps its
graphs of a mesh of one card in the same cache (``GRAPHS``), under keys
of its own (``parallel.sharded.sharded_graph_key``).
"""

from __future__ import annotations

import collections
import dataclasses
import logging
import time
from typing import Callable, Dict, Mapping, Optional

import torch

from .ops._build import CudaKernel

__all__ = ["MAX_GRAPHS", "FlowGraph", "GraphCache", "GRAPHS", "graph_key",
           "tensor_meta", "launch_counts", "take_back_launches"]

log = logging.getLogger(__name__)

MAX_GRAPHS = 8


def tensor_meta(t: Optional[torch.Tensor]) -> Optional[tuple]:
    """What a graph is specialised to of an argument: its shape and dtype
    (None where it is not given)."""
    return None if t is None else (tuple(t.shape), t.dtype)


def graph_key(img1: torch.Tensor, img2: torch.Tensor, cfg,
              fine_level_wmf: bool, init_flow: Optional[torch.Tensor],
              key: Optional[torch.Tensor]) -> tuple:
    """What a graph of ``compute_flow_jit`` is specialised to: what the
    JAX entry's jit cache keys on (shapes, dtypes, ``cfg``,
    ``fine_level_wmf``, which optional arguments are given) and the
    device."""
    return (img1.device, tensor_meta(img1), tensor_meta(img2), cfg,
            bool(fine_level_wmf), tensor_meta(init_flow), key is not None)


def launch_counts() -> Dict[CudaKernel, int]:
    """Every kernel entry point's launch count."""
    return {k: k.launches for k in CudaKernel.instances}


def take_back_launches(before: Mapping[CudaKernel, int]
                       ) -> Dict[CudaKernel, int]:
    """The launches each kernel recorded since ``before`` (a
    ``launch_counts``) under a capture, where none of them ran: taken
    back off the counts and returned, by kernel, for the replays to add
    (kernels that recorded none are left out)."""
    delta = {}
    for k in CudaKernel.instances:
        n = k.launches - before.get(k, 0)
        if n:
            k.launches -= n
            delta[k] = n
    return delta


@dataclasses.dataclass
class FlowGraph:
    """A captured pair: the graph, its static inputs (by argument name,
    None for an argument not given) and output, the launches of one
    replay by kernel, and the capture's measurements: seconds of the
    warm-up call, of the capture and of the instantiation, the device
    memory allocated at most while they ran and how much of it the pair
    added."""

    key: tuple
    graph: object
    inputs: Dict[str, Optional[torch.Tensor]]
    output: torch.Tensor
    launches: Dict[CudaKernel, int]
    warmup_s: float = 0.0
    capture_s: float = 0.0
    instantiate_s: float = 0.0
    max_allocated: int = 0
    pair_bytes: int = 0
    replays: int = 0

    def replay(self, inputs: Mapping[str, Optional[torch.Tensor]]
               ) -> torch.Tensor:
        for name, buf in self.inputs.items():
            if buf is not None:
                buf.copy_(inputs[name])
        self.run()
        return self.output.clone()

    def run(self) -> None:
        """Replay the graph on what its static inputs hold, leaving the
        result in ``output`` (the stage timer of ``bench/_timing.py``
        replays this way, without the copies in and out)."""
        try:
            self.graph.replay()
        except Exception as e:
            raise RuntimeError(f"replay of the CUDA graph of {self.key} "
                               f"failed: {e}") from e
        for k, n in self.launches.items():
            k.launches += n
        self.replays += 1


def capture(key: tuple, fn: Callable[..., torch.Tensor],
            inputs: Mapping[str, Optional[torch.Tensor]]) -> FlowGraph:
    """The CUDA graph of ``fn(**inputs)`` (CUDA tensors, or None): static
    copies of the inputs, one eager warm-up call on them on a side stream,
    then the capture of the same call on that stream into a graph with a
    pool of its own, then its instantiation."""
    dev = next(t for t in inputs.values() if t is not None).device
    with torch.cuda.device(dev):
        static = {name: None if t is None else t.clone()
                  for name, t in inputs.items()}
        stream = torch.cuda.Stream(dev)
        stream.wait_stream(torch.cuda.current_stream(dev))
        torch.cuda.synchronize(dev)
        base = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        with torch.cuda.stream(stream):
            fn(**static)
        torch.cuda.synchronize(dev)
        t1 = time.perf_counter()
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        before = launch_counts()
        try:
            # thread_local: a sync in this thread breaks the capture;
            # another thread (the stream CLI's drain) may read back
            with torch.cuda.graph(graph, stream=stream,
                                  capture_error_mode="thread_local"):
                output = fn(**static)
        except Exception as e:
            raise RuntimeError(f"CUDA graph capture of {key} failed: "
                               f"{e}") from e
        finally:
            launches = take_back_launches(before)
        t2 = time.perf_counter()
        try:
            graph.instantiate()
        except Exception as e:
            raise RuntimeError(f"instantiation of the CUDA graph of {key} "
                               f"failed: {e}") from e
        torch.cuda.synchronize(dev)
        t3 = time.perf_counter()
        peak = torch.cuda.max_memory_allocated(dev)
        torch.cuda.current_stream(dev).wait_stream(stream)
    return FlowGraph(key, graph, static, output, launches, t1 - t0, t2 - t1,
                     t3 - t2, peak, peak - base)


class GraphCache:
    """Captured pairs by key, at most ``capacity``, the least recently
    used evicted first.  ``captures`` counts the captures made and
    ``evictions`` the graphs dropped, over the cache's life."""

    def __init__(self, capacity: int = MAX_GRAPHS,
                 make: Callable[..., FlowGraph] = capture):
        self.capacity = capacity
        self.make = make
        self.entries: "collections.OrderedDict[tuple, FlowGraph]" = \
            collections.OrderedDict()
        self.captures = 0
        self.evictions = 0

    def run(self, key: tuple, fn: Callable[..., torch.Tensor],
            inputs: Mapping[str, Optional[torch.Tensor]]) -> torch.Tensor:
        """``fn(**inputs)`` by replay of the graph of ``key``, captured
        first if the cache lacks it."""
        entry = self.entries.get(key)
        if entry is None:
            entry = self.make(key, fn, inputs)
            self.captures += 1
            self.entries[key] = entry
            while len(self.entries) > self.capacity:
                old, _ = self.entries.popitem(last=False)
                self.evictions += 1
                log.warning("CUDA graph cache full (%d): evicted the graph "
                            "of %s", self.capacity, old)
        else:
            self.entries.move_to_end(key)
        return entry.replay(inputs)

    def clear(self) -> None:
        self.entries.clear()


# the graphs of compute_flow_jit and of compute_flow_sharded on one card
# (parallel/sharded.py): one budget of device memory for both entries
GRAPHS = GraphCache()
