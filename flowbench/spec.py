"""What the harness finds by name: the cell in ``BENCHMARK.json``, its
configuration (``configs/<name>.json``), its traffic
(``traffic/<name>.json``), its limits (``limits/<cell>.json``) and the
reader of each metric (``metrics/<name>.py``).  A name that is
not there is refused with the names that are."""

from __future__ import annotations

import dataclasses
import importlib
import json
from pathlib import Path
from typing import Callable, Dict, List, Optional

__all__ = ["HERE", "ROOT", "NotFound", "Cell", "Metric", "load", "config",
           "traffic", "limits", "reader", "readers"]

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


class NotFound(LookupError):
    """A workload, configuration, traffic mix, limit file or metric that
    the benchmark does not have."""


@dataclasses.dataclass(frozen=True)
class Metric:
    """A metric of ``BENCHMARK.json`` as the harness reports it: its name,
    its unit and the cells that report it (every cell where None)."""

    name: str
    unit: str
    workloads: Optional[tuple] = None

    def applies(self, cell: str) -> bool:
        return self.workloads is None or cell in self.workloads


@dataclasses.dataclass(frozen=True)
class Cell:
    name: str
    config: str
    traffic: str
    chips: int
    end_to_end: tuple
    per_layer: tuple


def _metric(d: dict) -> Metric:
    w = d.get("workloads")
    return Metric(d["name"], d["unit"], tuple(w) if w is not None else None)


def load(workload: str, root: Path = ROOT) -> Cell:
    """The cell named ``workload`` of ``root/BENCHMARK.json`` with the
    metrics it reports."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise NotFound(f"no workload {workload!r} in BENCHMARK.json; "
                       f"known: {sorted(cells)}")
    w = cells[workload]
    if w["config"] not in {c["name"] for c in bench["configs"]}:
        raise NotFound(f"workload {workload!r} names configuration "
                       f"{w['config']!r}, which BENCHMARK.json lacks")
    e2e = tuple(m for m in map(_metric, bench["end_to_end"])
                if m.applies(workload))
    per = tuple(m for m in map(_metric, bench["per_layer"])
                if m.applies(workload))
    return Cell(w["name"], w["config"], w["traffic"], int(w["chips"]),
                e2e, per)


def _json(kind: str, name: str, base: Path = HERE) -> dict:
    path = base / kind / f"{name}.json"
    if not path.is_file():
        known = sorted(p.stem for p in (base / kind).glob("*.json"))
        raise NotFound(f"no {kind[:-1] if kind != 'traffic' else kind} "
                       f"{name!r} ({path.relative_to(base.parent)}); "
                       f"known: {known}")
    return json.loads(path.read_text())


def config(name: str, base: Path = HERE) -> dict:
    """``configs/<name>.json``: ``config``, the configuration as run (an
    ``EPPMConfig`` as a dict), with its ``source``, ``assumed`` and
    ``reduced``."""
    return _json("configs", name, base)


def traffic(name: str, base: Path = HERE) -> dict:
    """``traffic/<name>.json``: the parameters that the generator it names
    (``generators/<name>.py``, through ``generator.make``) reads."""
    return _json("traffic", name, base)


def limits(cell: str, base: Path = HERE) -> Dict[str, float]:
    """``limits/<cell>.json``: the limit of each number the correctness
    check compares, by the number's name."""
    return _json("limits", cell, base)["limits"]


def reader(name: str) -> Callable:
    """``metrics/<name>.py``'s ``read``: the metric ``name`` from a
    ``trace.Run``, or None where the run has nothing to read for it."""
    if not (HERE / "metrics" / f"{name}.py").is_file():
        known = sorted(p.stem for p in (HERE / "metrics").glob("*.py")
                       if not p.stem.startswith("_"))
        raise NotFound(f"no reader for the metric {name!r} "
                       f"(flowbench/metrics/{name}.py); known: {known}")
    return importlib.import_module(f"flowbench.metrics.{name}").read


def readers(metrics: List[Metric]) -> Dict[str, Callable]:
    return {m.name: reader(m.name) for m in metrics}
