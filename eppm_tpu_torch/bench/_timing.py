"""What the stage profilers share: the device and its label, the flags
every program takes, and the timer of a stage.

* A stage is a span of a traced replay (``utils/trace.py``): the pair,
  or the chain of rows (``Rows``), is captured as one CUDA graph with
  tracing on, and ``traced_replays`` replays it between CUDA events and
  collects the spans the marks inside it stamped.
* Every result is labelled with the card as ``nvidia-smi
  --query-gpu=name,power.limit`` prints it.  Without a card the programs
  exit non-zero; ``--device cpu`` runs the kernels' plain versions, and
  then a program prints its stages and no time.
"""

from __future__ import annotations

import argparse
import dataclasses
import statistics
from typing import Callable, Dict, List, Optional, Sequence

import torch

from .. import graphs
from ..eval_report import card_label
from ..utils import trace

__all__ = ["add_common", "device_of", "parse_size", "frames",
           "event_ms", "summary", "Row", "Rows", "traced_replays",
           "card_label"]


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
        raise SystemExit("no CUDA device: the stage profilers time the "
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
    """One row: its name, the shapes of its outputs and, on the card, the
    ms of its span in each replay."""

    name: str
    shapes: object
    ms: Optional[List[float]] = None

    def line(self) -> dict:
        out = {"stage": self.name, "shapes": self.shapes}
        if self.ms is not None:
            out.update(summary(self.ms))
        return out


class Rows:
    """``rows(name, fn, *args)`` returns ``fn(*args)`` and keeps a ``Row``
    of it (a name seen again keeps its first place); with tracing on the
    call is a stage of its own, between a mark of its name and the end of
    that stage, so that a traced replay times it."""

    def __init__(self):
        self._rows: Dict[str, Row] = {}

    @property
    def rows(self) -> List[Row]:
        return list(self._rows.values())

    def __call__(self, name: str, fn: Callable, *args):
        trace.mark(name)
        out = fn(*args)
        trace.mark(None)
        self._rows[name] = Row(name, _shapes(out))
        return out


def traced_replays(entry: "graphs.FlowGraph", reps: int):
    """``reps`` replays of ``entry``, a graph captured with tracing on,
    each between two CUDA events (the graph alone: no copy in or out):
    (each replay's ms by the events, its ``graph`` span, the collected
    trace).  What the tracer held before is dropped."""
    trace.collect()
    ms = event_ms(entry.run, reps)
    tr = trace.collect()
    spans = sorted(tr.named("graph"), key=lambda s: s.start_ns)
    if len(spans) != reps or tr.lost:
        raise RuntimeError(f"{len(spans)} graph spans of {reps} replays "
                           f"({tr.lost} lost)")
    return ms, spans, tr
