"""What the measurement programs share: the device and its label, the
flags every program takes, the timer of a stage, the timers of a whole
pair, and the quality gates.

* A stage (``StageTimer``) is captured as a CUDA graph through
  ``graphs.capture``, the counterpart of the JAX scripts' ``jax.jit`` of
  a stage, on static copies of its inputs; the graph is replayed once as
  a warm-up, then ``reps`` times, each replay between two CUDA events;
  the outputs are cloned and the graph dropped, so that the stage graphs
  of a 4K pair do not pile up.
* A whole pair goes through ``pipeline.compute_flow_jit``, the path
  ``EPPMFlow`` and the command line run: ``device_ms`` takes CUDA events
  around each call, ``e2e_ms`` the host clock around the call and the
  flow's read back.  Each timed window runs inside ``window``, which
  fails if ``graphs.GRAPHS`` captured or evicted a graph in it.
* Every result is labelled with the card as ``nvidia-smi
  --query-gpu=name,power.limit`` prints it.  Without a card the programs
  exit non-zero; ``--device cpu`` runs the kernels' plain versions, and
  then a program prints its gates and no time or rate.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import statistics
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from .. import graphs
from ..eval_report import card_label
from ..metrics import flow_error, warp_error

__all__ = ["add_common", "device_of", "parse_size", "frames",
           "window", "event_ms", "summary", "StageTimer", "warp_gate",
           "interior_epe", "card_label", "WARP_GATE", "EPE_BORDER"]

# bench.py's gates: the flow's warp error under half the zero-flow one,
# the EPE over the pixels 16 px inside the frame
WARP_GATE = 0.5
EPE_BORDER = 16


def add_common(p: argparse.ArgumentParser, sets: bool = False) -> None:
    """The flags of every program: ``--device``, ``--seed`` and, where
    ``sets``, ``--set``."""
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="cuda (default; exits without one) or cpu: the "
                        "kernels' plain versions, untimed")
    p.add_argument("--seed", type=int, default=0,
                   help="seed of the synthetic pairs (default 0)")
    if sets:
        p.add_argument("--set", action="append", default=[], metavar="K=V",
                       dest="sets", help="override a config field (dotted "
                       "path, or preset=NAME), repeatable")


def device_of(name: str) -> torch.device:
    """The device of ``--device``: a CUDA device where there is none
    exits non-zero, naming it; nothing falls back to the CPU."""
    if name == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: the measurement programs time the "
                         "card; pass --device cpu for an untimed run of the "
                         "plain versions")
    return torch.device(name)


def parse_size(text: str):
    """"HxW" -> (h, w)."""
    try:
        h, w = (int(v) for v in text.lower().split("x"))
    except ValueError:
        raise SystemExit(f"expected a size HxW, got {text!r}")
    return h, w


def frames(pair, device: torch.device):
    """A pair of numpy frames as tensors on ``device``."""
    return [torch.from_numpy(f).to(device) for f in pair]


@contextlib.contextmanager
def window(what: str, captures: bool = True):
    """A timed window: fails if ``graphs.GRAPHS`` evicted a graph in it,
    or, with ``captures``, captured one (the warm-up before it should
    have)."""
    cache = graphs.GRAPHS
    c0, e0 = cache.captures, cache.evictions
    yield
    if cache.evictions != e0:
        raise RuntimeError(f"{what}: {cache.evictions - e0} CUDA graph(s) "
                           "evicted inside a timed window")
    if captures and cache.captures != c0:
        raise RuntimeError(f"{what}: {cache.captures - c0} CUDA graph(s) "
                           "captured inside a timed window")


def event_ms(fn: Callable[[], object], reps: int) -> List[float]:
    """The device time of each of ``reps`` calls of ``fn`` in ms: CUDA
    events on the current stream before and after each call, read once
    all have run."""
    marks = [(torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    for start, end in marks:
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return [start.elapsed_time(end) for start, end in marks]


def summary(ms: Sequence[float]) -> Dict[str, float]:
    return {"median_ms": statistics.median(ms), "min_ms": min(ms),
            "max_ms": max(ms), "n": len(ms)}


class _Slot:
    """The place of a tensor argument in a stage's arguments."""

    def __init__(self, i: int):
        self.name = f"t{i}"


def _tree_map(fn, x, leaf=torch.Tensor):
    """``fn`` on every ``leaf`` of ``x``, a leaf or a nested list or tuple
    of leaves and other values (kept as they are)."""
    if isinstance(x, leaf):
        return fn(x)
    if isinstance(x, (list, tuple)):
        return type(x)(_tree_map(fn, v, leaf) for v in x)
    return x


def _shapes(x):
    return _tree_map(lambda t: list(t.shape), x)


@dataclasses.dataclass
class Row:
    """One stage: its name, the shapes of its outputs and, on the card,
    its replays' ms."""

    name: str
    shapes: object
    ms: Optional[List[float]] = None

    def line(self) -> dict:
        out = {"stage": self.name, "shapes": self.shapes}
        if self.ms is not None:
            out.update(summary(self.ms))
        return out


class StageTimer:
    """``timer(name, fn, *args)`` returns ``fn(*args)`` and records a
    ``Row``.  On the card it captures the CUDA graph of the call
    (``graphs.capture``: static copies of the tensor arguments, which may
    sit in nested lists and tuples, an eager warm-up call on a side stream
    that builds the kernels and tables, then the capture), replays it
    once, times ``reps`` replays by CUDA events, clones the outputs and
    drops the graph.  On the CPU it calls ``fn`` and times nothing."""

    def __init__(self, device: torch.device, reps: int = 5):
        self.device = device
        self.reps = reps
        self.rows: List[Row] = []

    def __call__(self, name: str, fn: Callable, *args):
        if self.device.type != "cuda":
            out = fn(*args)
            self.rows.append(Row(name, _shapes(out)))
            return out
        tensors: Dict[str, torch.Tensor] = {}

        def slot(t):
            s = _Slot(len(tensors))
            tensors[s.name] = t
            return s

        spec = _tree_map(slot, args)

        def call(**static):
            return fn(*_tree_map(lambda s: static[s.name], spec, _Slot))

        entry = graphs.capture(("stage", name), call, tensors)
        entry.run()
        ms = event_ms(entry.run, self.reps)
        out = _tree_map(torch.clone, entry.output)
        del entry
        self.rows.append(Row(name, _shapes(out), ms))
        return out


def warp_gate(f1: np.ndarray, f2: np.ndarray, flow: np.ndarray):
    """(finite, warp error, zero-flow warp error, ok): the first of
    bench.py's gates on uint8 frames and their flow."""
    finite = bool(np.isfinite(flow).all())
    a = f1.astype(np.float64) / 255.0
    b = f2.astype(np.float64) / 255.0
    we = warp_error(a, b, flow) if finite else float("nan")
    we0 = warp_error(a, b, np.zeros_like(flow))
    return finite, we, we0, finite and we < WARP_GATE * we0


def interior_epe(flow: np.ndarray, dx: float, dy: float,
                 border: int = EPE_BORDER) -> float:
    """EPE of ``flow`` against the constant flow (dx, dy) over the pixels
    ``border`` px inside the frame (``metrics.flow_error``)."""
    gt = np.empty(flow.shape, np.float32)
    gt[..., 0], gt[..., 1] = dx, dy
    return flow_error(flow, gt, border=border)[0]
