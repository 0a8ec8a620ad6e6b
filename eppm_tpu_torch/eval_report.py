"""The evaluation dossier on the local eval set (counterpart of
``tools/eval_report.py`` and ``tools/quick_eval.py``).

For each group of the set (``eppm_tpu_torch.evalset``) and each engine
(``dense``, and ``patchmatch`` through ``match_engine=patchmatch``) it
scores the flow of every case with ``cli.evaluate_dir``, in process: EPE,
AAE and bad3 over the interior (``--border``, 12 as in the JAX package's
dossier) and each pair's ms by ``utils.timing.DeviceTimer``.  It prints a
table in the layout of the JAX package's ``EVAL.md``, with each group's
mean and the device (the card's name and power limit), then one JSON line.

Each case's EPE is held to the JAX package's on the same case
(``evalset_reference.json``, written on the CPU by
``tools/torch_eval_parity.py``): a case outside the holdout group whose
EPE differs by more than ``TOLERANCE`` is a miss, marked in the table and
listed in the JSON line, and the exit code is 1.  On the holdout group,
where the reference itself collapses on periodic texture, a difference
beyond it is marked "off" and not judged.  Under ``--set`` overrides
nothing is compared: the reference holds the default configuration only.

  python -m eppm_tpu_torch.evalset --root evalset
  python -m eppm_tpu_torch.eval_report --root evalset [--engines dense]
      [--cases holdout/stripes_large_disp ...] [--set k=v] [--device cpu]

The flow runs on the card by default, and without one it raises;
``--device cpu`` runs the kernels' plain versions.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
from typing import Dict, List, Optional

import torch

from .cli import apply_overrides, evaluate_dir
from .config import DEFAULT_CONFIG
from .evalset import GROUPS

__all__ = ["ENGINES", "TOLERANCE", "REFERENCE", "load_reference",
           "card_label", "run", "format_table", "main"]

ENGINES = {"dense": [], "patchmatch": ["match_engine=patchmatch"]}
TOLERANCE = 0.01
REFERENCE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "evalset_reference.json")


def load_reference(path: str = REFERENCE) -> dict:
    """The JAX package's scores: {engine: {"group/name": record}}."""
    with open(path) as f:
        return json.load(f)["engines"]


def card_label(device: torch.device) -> str:
    """The device as ``nvidia-smi --query-gpu=name,power.limit`` prints
    it (the card a number was taken on), or "cpu"."""
    if device.type != "cuda":
        return "cpu"
    index = device.index if device.index is not None else \
        torch.cuda.current_device()
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader", f"--id={index}"],
            capture_output=True, text=True, timeout=30)
        label = out.stdout.strip()
    except (OSError, subprocess.TimeoutExpired):
        label = ""
    return label or f"{torch.cuda.get_device_name(device)}, power limit " \
                     "not read"


def run(root: str, engines: List[str], device: torch.device,
        cases: Optional[List[str]] = None,
        overrides: Optional[List[str]] = None, border: int = 12, reference: Optional[Dict[str, dict]] = None,
        warmup: bool = False) -> dict:
    """Score every case of ``root`` (or ``cases``, "group/name") on each
    engine -> {"groups": {"group/engine": evaluate_dir's report}, "misses":
    ["engine:group/name", ...]}; with a ``reference`` each scored report
    also holds "epe_jax", "delta" (this EPE less JAX's) and "off" (|delta|
    above ``TOLERANCE``) where the reference has the case; an "off" case
    outside the holdout group is a miss.  ``warmup`` runs each group's
    first case once, untimed, before its timed pass (the kernels' build
    and first-call tables at each shape)."""
    overrides = list(overrides or [])
    picked = None
    if cases:
        picked = {}
        for c in cases:
            group, _, name = c.partition("/")
            if group not in GROUPS or not name:
                raise ValueError(f"case {c!r}: expected group/name with a "
                                 f"group of {list(GROUPS)}")
            picked.setdefault(group, []).append(name)
    groups, misses = {}, []
    for engine in engines:
        cfg = apply_overrides(DEFAULT_CONFIG, ENGINES[engine] + overrides)
        ref = (reference or {}).get(engine, {})
        for group, pattern in GROUPS.items():
            gdir = os.path.join(root, group)
            if (picked is not None and group not in picked) or \
                    not os.path.isdir(gdir):
                continue
            names = None if picked is None else picked[group]
            if warmup:
                first = names[0] if names else sorted(os.listdir(gdir))[0]
                evaluate_dir(gdir, pattern, cfg, device, border,
                             names=[first])
            rep = evaluate_dir(gdir, pattern, cfg, device, border,
                               names=names, timed=True)
            for name, r in rep["sequences"].items():
                want = ref.get(f"{group}/{name}")
                if want is None or r["epe"] is None:
                    continue
                r["epe_jax"] = want["jax"]["epe"]
                r["delta"] = r["epe"] - r["epe_jax"]
                r["off"] = abs(r["delta"]) > TOLERANCE
                if r["off"] and group != "holdout":
                    misses.append(f"{engine}:{group}/{name}")
            groups[f"{group}/{engine}"] = rep
    return {"groups": groups, "misses": misses}


def _fmt(v, spec):
    return "-" if v is None else format(v, spec)


def format_table(report: dict, engines: List[str], label: str) -> str:
    """The EVAL.md layout: per group, a row per case with each engine's
    EPE, AAE, bad3, ms and the EPE's difference from JAX's (marked MISS,
    or "off" in the holdout group, beyond ``TOLERANCE``), then the group's
    mean EPE."""
    lines = [f"device: {label}"]
    groups = [g for g in GROUPS
              if any(f"{g}/{e}" in report["groups"] for e in engines)]
    miss = set(report["misses"])
    for group in groups:
        head = "| sequence |" + "".join(
            f" {e} EPE | AAE | bad3 | ms | dEPE |" for e in engines)
        lines += ["", f"## {group}", "", head,
                  "|---|" + "---|---|---|---|---|" * len(engines)]
        reps = [report["groups"].get(f"{group}/{e}", {"sequences": {},
                                                      "mean_epe": None})
                for e in engines]
        names = sorted({n for r in reps for n in r["sequences"]})
        for name in names:
            row = f"| {name} |"
            for e, r in zip(engines, reps):
                s = r["sequences"].get(name, {})
                flag = (" MISS" if f"{e}:{group}/{name}" in miss
                        else " off" if s.get("off") else "")
                row += (f" {_fmt(s.get('epe'), '.3f')} | "
                        f"{_fmt(s.get('aae_deg'), '.2f')} | "
                        f"{_fmt(s.get('bad3'), '.3f')} | "
                        f"{_fmt(s.get('ms'), '.1f')} | "
                        f"{_fmt(s.get('delta'), '+.5f')}{flag} |")
            lines.append(row)
        lines.append("| **mean** |" + "".join(
            f" **{_fmt(r['mean_epe'], '.3f')}** | | | | |" for r in reps))
    return "\n".join(lines)


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(prog="python -m eppm_tpu_torch.eval_report",
                                description=__doc__.split("\n\n")[0])
    p.add_argument("--root", default="evalset",
                   help="the set (python -m eppm_tpu_torch.evalset)")
    p.add_argument("--engines", default="dense,patchmatch")
    p.add_argument("--cases", nargs="*", default=None, metavar="GROUP/NAME",
                   help="only these cases (default: every case of the set)")
    p.add_argument("--set", action="append", default=[], metavar="K=V",
                   help="override a config field (dotted path), repeatable")
    p.add_argument("--border", type=int, default=12)
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    p.add_argument("--reference", default=REFERENCE,
                   help="the JAX package's scores (tools/"
                        "torch_eval_parity.py)")
    args = p.parse_args(argv)

    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --device cpu to run on the CPU")
    engines = args.engines.split(",")
    unknown = set(engines) - set(ENGINES)
    if unknown:
        raise SystemExit(f"unknown engines {sorted(unknown)} "
                         f"(have: {list(ENGINES)})")
    if not os.path.isdir(args.root):
        raise SystemExit(f"{args.root} missing: run python -m "
                         f"eppm_tpu_torch.evalset --root {args.root}")
    device = torch.device(args.device)
    reference = None if args.set else load_reference(args.reference)
    report = run(args.root, engines, device, args.cases, args.set,
                 args.border, reference, warmup=device.type == "cuda")
    label = card_label(device)
    print(format_table(report, engines, label))
    print(json.dumps({"device": label, "border": args.border,
                      "overrides": args.set, **report}))
    return 1 if report["misses"] else 0


if __name__ == "__main__":
    raise SystemExit(main())
