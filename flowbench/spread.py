"""The spread of each end-to-end metric over sets of runs, and the bound
it suggests: for each set, the distance between the first and the third
quartile over the median (``stats.spread``); for each metric the wider
over the sets; the bound about five times the widest over the cells,
never under 1% nor over 25%.

    python3 -m flowbench.spread CELL=FILE[,FILE...] [CELL=FILE...]

Each FILE holds one run's result line a line (its last JSON object with
``metrics``); the files of one cell are its sets.
"""

from __future__ import annotations

import json
import statistics
import sys
from typing import Dict, List

from .stats import spread


def lines(path: str) -> List[dict]:
    out = []
    with open(path) as f:
        for raw in f:
            raw = raw.strip()
            if raw.startswith("{") and '"metrics"' in raw:
                out.append(json.loads(raw))
    return out


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    widest: Dict[str, float] = {}
    for arg in argv:
        cell, files = arg.split("=", 1)
        for path in files.split(","):
            runs = lines(path)
            by: Dict[str, List[float]] = {}
            for r in runs:
                for k, m in r["metrics"].items():
                    by.setdefault(k, []).append(m["value"])
            for k, v in by.items():
                s = spread(v) if len(v) >= 2 else float("nan")
                print(f"{cell} {path} {k}: n={len(v)} median="
                      f"{statistics.median(v)!r} spread={s:.4%} "
                      f"values={v}")
                if k != "setup_s" and s == s:
                    widest[k] = max(widest.get(k, 0.0), s)
    for k, s in sorted(widest.items()):
        print(f"{k}: widest spread {s:.4%} -> bound "
              f"{min(0.25, max(0.01, 5 * s)):.4f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
