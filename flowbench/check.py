"""The comparison that decides ``correct``: flows the timed path produced
in the window against the plain reference (``reference/``), run on the
same frames once the window has closed.

* A pool (independent pairs, cycled): ``check_pairs`` pool entries are
  drawn from the seed among those the window served; the reference
  computes each once, and every flow the window produced for such an
  entry is compared with it.
* A warm traffic (a video: pair i + 1 warm-started from pair i's flow):
  the reference follows the window from its first pair, cold, through
  its first ``check_chain`` pairs, each warm-started from the
  reference's own flow of the pair before, and every one of those flows
  is compared.  A pair deep in the window lies hundreds of pairs on,
  out of the reference's reach in a run's time; for ``check_pairs``
  pairs drawn from the seed among the rest, the reference recomputes
  the one step, warm-started from the flow the port returned for the
  pair before it (the flow the window handed over as that pair's
  ``init_flow``).

The numbers, each the worst over the compared flows, and each held to
its limit in ``limits/<cell>.json``:

* ``differ_pct``: the percentage of pixels whose flow (either component)
  is not equal to the reference's; a NaN is never equal.
* ``mean_abs_px``: the mean over pixels and components of the absolute
  difference from the reference's flow, in px; NaN where a flow holds
  one, which no limit passes.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Callable, Dict, List, Sequence, Tuple

import numpy as np
import torch

__all__ = ["Compared", "compare", "numbers", "sample", "judge", "NUMBERS"]

NUMBERS = ("differ_pct", "mean_abs_px")


def numbers(flow: np.ndarray, ref: np.ndarray) -> Dict[str, float]:
    """The compared numbers of one flow against its reference flow."""
    if flow.shape != ref.shape:
        return {"differ_pct": 100.0, "mean_abs_px": math.inf}
    same = (flow == ref).all(axis=-1)
    diff = np.abs(flow.astype(np.float64) - ref.astype(np.float64))
    return {"differ_pct": 100.0 * float(1.0 - same.mean()),
            "mean_abs_px": float(diff.mean())}


def sample(seed: int, population: Sequence[int], k: int) -> List[int]:
    """``k`` members of ``population`` drawn from ``seed`` (all of them
    where it holds no more)."""
    pop = sorted(set(population))
    if len(pop) <= k:
        return pop
    rng = np.random.default_rng([int(seed) % (2**63), 7])
    return sorted(int(v) for v in rng.choice(pop, size=k, replace=False))


@dataclasses.dataclass
class Compared:
    """The worst of each number over the compared flows, how many flows
    were compared, and the reference's seconds."""

    worst: Dict[str, float]
    flows: int
    pairs: List[int]
    ref_s: float


def _worst(rows: List[Dict[str, float]]) -> Dict[str, float]:
    out = {}
    for name in NUMBERS:
        vals = [r[name] for r in rows]
        out[name] = math.nan if any(math.isnan(v) for v in vals) else max(vals)
    return out


def compare(seed: int, traffic, flows: List[np.ndarray], keys: List[int],
            reference: Callable, device: torch.device) -> Compared:
    """Compare the window's ``flows`` (pair i's flow, served for traffic
    entry ``keys[i]``) with ``reference(img1, img2, init_flow)`` (device
    tensors in, a device flow out), run on ``device``."""
    def ref(i: int, init=None) -> np.ndarray:
        _, a, b = traffic.pair(i)
        a = torch.from_numpy(a).to(device)
        b = torch.from_numpy(b).to(device)
        if init is not None:
            init = torch.from_numpy(init).to(device)
        return reference(a, b, init).cpu().numpy()

    t0 = time.perf_counter()
    rows = []
    pairs: List[int] = []
    if not traffic.warm:
        pairs = sample(seed, keys, traffic.check_pairs)
        for k in pairs:
            r = ref(keys.index(k))
            rows += [numbers(f, r) for f, kk in zip(flows, keys) if kk == k]
    else:
        n = len(flows)
        prev = None
        for i in range(min(traffic.check_chain, n)):
            prev = ref(i, prev)
            rows.append(numbers(flows[i], prev))
            pairs.append(i)
        for i in sample(seed, range(len(pairs), n), traffic.check_pairs):
            rows.append(numbers(flows[i], ref(i, flows[i - 1])))
            pairs.append(i)
    return Compared(_worst(rows), len(rows), pairs, time.perf_counter() - t0)


def judge(worst: Dict[str, float], limits: Dict[str, float]
          ) -> Tuple[bool, Dict[str, Dict[str, float]]]:
    """(correct, each number with its limit): correct where every number
    is at or under its limit (a NaN is not)."""
    missing = set(NUMBERS) - set(limits)
    if missing:
        raise KeyError(f"no limit for {sorted(missing)}")
    checks = {n: {"value": worst[n], "limit": float(limits[n])}
              for n in NUMBERS}
    ok = all(c["value"] <= c["limit"] for c in checks.values())
    return ok, checks
