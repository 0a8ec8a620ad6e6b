#!/usr/bin/env python
"""Hold the PyTorch port to the JAX package on the local eval set, on the CPU.

For each case of the set (``eppm_tpu_torch.evalset``) and each engine, the
flow of ``eppm_tpu.pipeline.compute_flow_jit`` on the frames as
``python -m eppm_tpu.cli --eval-dir`` loads them (uint8 PPM), and the flow
of ``eppm_tpu_torch.pipeline.compute_flow`` on the same frames on the CPU.
Per case: the share of pixels whose flows agree within 1e-3 (the larger
|delta| of u and v), the mean and the max |delta|, both packages' EPE, AAE
and bad3 over the interior (border 12, the dossier's setting) and both run
times (each a process of its own, the first call: JAX's compile
included).  The contract: >= 98% within 1e-3 and a mean |delta| < 0.05;
outside the holdout group, also |EPE_port - EPE_jax| <= 0.01.

The results are merged into ``eppm_tpu_torch/evalset_reference.json``
(JAX's scores per engine and case, the agreement, the commit and both
versions), which ``chip_smoke.py`` holds the card's dossier to.

  python tools/torch_eval_parity.py [--root evalset]
      [--engines dense,patchmatch] [--cases holdout/stripes_large_disp ...]
      [--jobs 4] [--threads 2] [--cache DIR]

Each flow is computed in a process of its own, ``--jobs`` at a time on
``--threads`` cores each.  ``--cache DIR`` keeps every flow there as .npy
and takes JAX's flows from it when present (the JAX package does not
change).  On 8 cores, 4 jobs of 2 threads, a case takes 23-135 s on the
JAX side and 80-550 s on the port's; the whole set about 16 minutes for
the port's dense flows and 25 for both sides of the PatchMatch engine.
"""

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

OUT = os.path.join(ROOT, "eppm_tpu_torch", "evalset_reference.json")
BORDER = 12
ENGINES = ("dense", "patchmatch")


def _cfg_overrides(engine):
    return ["match_engine=patchmatch"] if engine == "patchmatch" else []


def worker(side, engine, case_dir, out_npy, threads):
    """Compute one flow and save it; prints the seconds of the call."""
    f1, f2 = (os.path.join(case_dir, n) for n in ("frame10.ppm",
                                                   "frame11.ppm"))
    if side == "jax":
        from eppm_tpu.cli import _compute, apply_overrides, load_image
        from eppm_tpu.config import DEFAULT_CONFIG

        cfg = apply_overrides(DEFAULT_CONFIG, _cfg_overrides(engine))
        img1, img2 = load_image(f1), load_image(f2)
        t0 = time.perf_counter()
        flow = _compute(img1, img2, cfg)
    else:
        import torch

        torch.set_num_threads(threads)
        from eppm_tpu_torch.cli import _load, apply_overrides
        from eppm_tpu_torch.config import DEFAULT_CONFIG
        from eppm_tpu_torch.pipeline import compute_flow

        cfg = apply_overrides(DEFAULT_CONFIG, _cfg_overrides(engine))
        cpu = torch.device("cpu")
        img1, img2 = _load(f1, cpu), _load(f2, cpu)
        t0 = time.perf_counter()
        flow = compute_flow(img1, img2, cfg).numpy()
    seconds = time.perf_counter() - t0
    np.save(out_npy, np.asarray(flow, np.float32))
    print(json.dumps({"seconds": seconds}))


def _run_worker(side, engine, case_dir, out_npy, cpus):
    env = dict(os.environ, JAX_PLATFORMS="cpu", OMP_NUM_THREADS=str(len(cpus)),
               PYTHONPATH=ROOT)
    cmd = ["taskset", "-c", ",".join(map(str, cpus)), sys.executable,
           os.path.abspath(__file__), "--worker", side, engine, case_dir,
           out_npy, "--threads", str(len(cpus))]
    out = subprocess.run(cmd, capture_output=True, text=True, env=env,
                         cwd=ROOT)
    if out.returncode != 0:
        raise RuntimeError(f"{side} {engine} {case_dir} failed:\n"
                           f"{out.stderr[-3000:]}")
    return json.loads(out.stdout.strip().splitlines()[-1])["seconds"]


def agreement(a, b):
    """Share of pixels within 1e-3, mean and max |delta| (the larger
    component's), the repository's cross-program contract."""
    d = np.abs(a.astype(np.float64) - b.astype(np.float64)).max(axis=-1)
    return {"within_1e3": float((d < 1e-3).mean()),
            "mean_abs": float(d.mean()), "max_abs": float(d.max())}


def meets_contract(rec, holdout):
    ok = rec["within_1e3"] >= 0.98 and rec["mean_abs"] < 0.05
    if not holdout:
        ok = ok and abs(rec["port"]["epe"] - rec["jax"]["epe"]) <= 0.01
    return ok


def _git_commit():
    def git(*a):
        return subprocess.run(["git", *a], capture_output=True, text=True,
                              cwd=ROOT).stdout.strip()

    commit = git("rev-parse", "--short", "HEAD") or "unknown"
    if git("status", "--porcelain", "--untracked-files=no", "--",
           "eppm_tpu_torch", "eppm_tpu"):
        commit += "+dirty"
    return commit


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--root", default="evalset")
    p.add_argument("--engines", default="dense")
    p.add_argument("--cases", nargs="*", default=[],
                   help="group/name of the cases to run (default: all)")
    p.add_argument("--jobs", type=int, default=4)
    p.add_argument("--threads", type=int, default=2)
    p.add_argument("--cache", help="directory for the flows (.npy)")
    p.add_argument("--out", default=OUT)
    p.add_argument("--worker", nargs=4, metavar=("SIDE", "ENGINE", "CASE",
                                                  "OUT"),
                   help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    if args.worker:
        worker(*args.worker, args.threads)
        return 0

    from eppm_tpu.cli import _evaluate as jax_evaluate
    from eppm_tpu_torch import evalset
    from eppm_tpu_torch.cli import _evaluate as port_evaluate

    root = os.path.join(ROOT, args.root)
    if not all(os.path.isdir(os.path.join(root, g)) for g in evalset.GROUPS):
        evalset.build(root)
    cases = [f"{g}/{n}" for g in evalset.GROUPS
             for n in sorted(os.listdir(os.path.join(root, g)))]
    if args.cases:
        unknown = set(args.cases) - set(cases)
        if unknown:
            raise SystemExit(f"unknown cases {sorted(unknown)}")
        cases = [c for c in cases if c in args.cases]
    engines = args.engines.split(",")
    if set(engines) - set(ENGINES):
        raise SystemExit(f"--engines: {engines}, have {ENGINES}")

    cache = args.cache or tempfile.mkdtemp(prefix="eval_parity_")
    tasks = []
    for engine in engines:
        for case in cases:
            for side in ("jax", "port"):
                npy = os.path.join(cache, side, engine, case + ".npy")
                os.makedirs(os.path.dirname(npy), exist_ok=True)
                if side == "jax" and os.path.exists(npy + ".json"):
                    continue
                tasks.append((side, engine, case, npy))
    # The largest frames first, so that the pool ends together.
    tasks.sort(key=lambda t: -os.path.getsize(
        os.path.join(root, t[2], "frame10.ppm")))

    ncpu = os.cpu_count() or 1
    slots = [[(s * args.threads + i) % ncpu for i in range(args.threads)]
             for s in range(args.jobs)]
    free = list(range(args.jobs))

    def run(task):
        slot = free.pop()
        side, engine, case, npy = task
        try:
            secs = _run_worker(side, engine, os.path.join(root, case), npy,
                               slots[slot])
        finally:
            free.append(slot)
        with open(npy + ".json", "w") as f:
            json.dump({"seconds": secs}, f)
        print(f"  {side:4s} {engine:10s} {case:40s} {secs:8.1f} s", flush=True)

    t0 = time.perf_counter()
    with ThreadPoolExecutor(args.jobs) as pool:
        list(pool.map(run, tasks))
    print(f"flows done in {time.perf_counter() - t0:.0f} s", flush=True)

    import jax
    import torch

    ref = {}
    if os.path.exists(args.out):
        with open(args.out) as f:
            ref = json.load(f)
    ref.update({"border": BORDER, "commit": _git_commit(),
                "jax": jax.__version__, "torch": torch.__version__,
                "threads": args.threads, "jobs": args.jobs})
    ref.setdefault("engines", {})
    bad = []
    for engine in engines:
        table = ref["engines"].setdefault(engine, {})
        print(f"\n{engine}: case | within 1e-3 | mean |d| | max |d| | "
              "EPE jax / port | s jax / port")
        for case in cases:
            group = case.split("/")[0]
            gt = os.path.join(root, case,
                              evalset.GROUPS[group].split(",")[2])
            flows, secs = {}, {}
            for side in ("jax", "port"):
                npy = os.path.join(cache, side, engine, case + ".npy")
                flows[side] = np.load(npy)
                with open(npy + ".json") as f:
                    secs[side] = json.load(f)["seconds"]
            rec = {"shape": list(flows["jax"].shape[:2]),
                   **agreement(flows["jax"], flows["port"]),
                   "jax": jax_evaluate(flows["jax"], gt, BORDER),
                   "port": port_evaluate(flows["port"], gt, BORDER),
                   "seconds_jax": secs["jax"], "seconds_port": secs["port"]}
            rec["contract"] = meets_contract(rec, group == "holdout")
            table[case] = rec
            if not rec["contract"]:
                bad.append(f"{engine}:{case}")
            print(f"  {case:38s} {rec['within_1e3']:.4%} "
                  f"{rec['mean_abs']:.2e} "
                  f"{rec['max_abs']:.3f}  {rec['jax']['epe']:.5f} / "
                  f"{rec['port']['epe']:.5f}  {secs['jax']:.1f} / "
                  f"{secs['port']:.1f}{'' if rec['contract'] else '  MISS'}")
        ref["engines"][engine] = dict(sorted(table.items()))
    with open(args.out, "w") as f:
        json.dump(ref, f, indent=1, sort_keys=True)
        f.write("\n")
    print("wrote", args.out)
    print(json.dumps({"cases": len(cases), "engines": engines,
                      "contract_missed": bad}))
    return 1 if bad else 0


if __name__ == "__main__":
    raise SystemExit(main())
