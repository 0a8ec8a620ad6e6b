"""The benchmark of ``eppm_tpu_torch``: one cell of ``BENCHMARK.json``,
one run, one JSON line.

    python3 -m flowbench.run --workload NAME --seed N --seconds S
                             --trace 0|1 [--control]

Each run is a new process and does four things in order:

1. Set-up: loads the port's kernel library (``eppm_tpu_torch/_build/``,
   built by nvcc on the first run in a checkout), makes the cell's
   traffic on the card from ``--seed`` (``generator.py``), and warms up:
   every CUDA graph the window replays is captured, then replayed.
2. Window: one client in a closed loop for ``--seconds``: pair i + 1 is
   handed over only once pair i's flow is on the host.  Each pair is
   timed from handing over its host uint8 frames to holding its float32
   flow as a host array: the frames' upload, the replay of
   ``eppm_tpu_torch.pipeline.compute_flow_jit`` and the read back.  In a
   video, pair i's flow, still on the card, is pair i + 1's
   ``init_flow``.  A graph captured or evicted inside the window fails
   the run.  With ``--trace 1`` CUDA events time each replay, and after
   the window a few more pairs run under ``torch.profiler`` and the
   cell's pair runs stage by stage (``stages.py``).
3. Correctness: the port's state is freed, and the plain reference
   (``reference/``) recomputes a sample of the window's flows on the card
   (``check.py``); each compared number is held to its limit
   (``limits/<workload>.json``).
4. Report: the compared numbers with their limits as the last lines of
   standard error, then one JSON line on standard output: ``correct``,
   ``attempted`` (the window's pairs), ``failed`` (compared flows over a
   limit), ``metrics`` (the cell's end-to-end metrics, or with
   ``--trace 1`` its per-layer ones, each read by ``metrics/<name>.py``),
   ``device``, ``breakdown`` (traced runs) and ``checks``.

Without a CUDA device, or with fewer than the cell asks for, it exits 2
and prints no result; likewise (exit 3) if ``jax``, ``jaxlib``, ``flax``
or ``eppm_tpu`` is loaded once the window has closed.  ``--control``
runs the port with its own lower-precision path switched on (the
fine-level warp gathered in bfloat16, ``dense_warp_bf16``): the control
that the comparison has to fail.  The benchmark's own runs never pass it.
"""

from __future__ import annotations

import os
import time


def _process_age() -> float:
    """Seconds since this process started (Linux's /proc), 0 elsewhere."""
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        return max(0.0, up - int(fields[19]) / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return 0.0


T0 = time.perf_counter() - _process_age()

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from typing import Callable, Dict, List, Optional  # noqa: E402

import torch  # noqa: E402

from . import check, generator, spec  # noqa: E402
from .trace import Run, kineto_events, reduce_profile  # noqa: E402

__all__ = ["main", "run_cell", "Client", "FORBIDDEN"]

# top-level module names the process must not hold once the window closes
FORBIDDEN = ("jax", "jaxlib", "flax", "eppm_tpu")
# pairs under the profiler after a traced window
PROFILE_PAIRS = 3


def forbidden_modules() -> List[str]:
    return sorted(m for m in list(sys.modules)
                  if m.split(".")[0] in FORBIDDEN)


class Client:
    """The closed loop's one client: hands over pair i's host frames,
    waits for its flow on the host, and (in a video) keeps the flow on the
    device as the next pair's ``init_flow``."""

    def __init__(self, traffic, flow_fn: Callable, device: torch.device,
                 video: bool, events: bool = False):
        self.traffic = traffic
        self.flow_fn = flow_fn
        self.device = device
        self.video = video
        self.events = events and device.type == "cuda"
        self.prev: Optional[torch.Tensor] = None

    def restart(self) -> None:
        self.prev = None

    def pair(self, i: int, spans: bool = False):
        """(traffic key, host flow, ms, replay events or None)."""
        from torch.profiler import record_function

        def span(name):
            return record_function(name) if spans else _nothing()

        key, f1, f2 = self.traffic.pair(i)
        marks = None
        t0 = time.perf_counter()
        with span("flowbench.upload"):
            a = torch.from_numpy(f1).to(self.device)
            b = torch.from_numpy(f2).to(self.device)
        with span("flowbench.flow"):
            if self.events:
                marks = (torch.cuda.Event(enable_timing=True),
                         torch.cuda.Event(enable_timing=True))
                marks[0].record()
            flow = self.flow_fn(a, b, self.prev if self.video else None)
            if marks:
                marks[1].record()
        with span("flowbench.readback"):
            host = flow.cpu().numpy()
        ms = (time.perf_counter() - t0) * 1e3
        if self.video:
            self.prev = flow
        return key, host, ms, marks


class _nothing:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def _card_label(device: torch.device) -> Dict[str, object]:
    """The card's name, count and power limit, as the driver reads them."""
    out: Dict[str, object] = {"platform": "gpu" if device.type == "cuda"
                              else device.type}
    if device.type == "cuda":
        out["kind"] = torch.cuda.get_device_name(device)
        out["count"] = 1
        try:
            smi = subprocess.run(
                ["nvidia-smi", "--query-gpu=power.limit",
                 "--format=csv,noheader,nounits", "-i", str(device.index or 0)],
                capture_output=True, text=True, timeout=20)
            out["power_limit_w"] = float(smi.stdout.strip().splitlines()[0])
        except (OSError, ValueError, IndexError, subprocess.SubprocessError):
            pass
    else:
        out["kind"] = "cpu"
        out["count"] = 1
    return out


def _program(config: dict, control: bool):
    """The port's configuration as run (the control switches its bfloat16
    fine-level warp on) and its entry point."""
    from eppm_tpu_torch.config import config_from_dict
    from eppm_tpu_torch.pipeline import compute_flow_jit

    cfg = config_from_dict(config)
    if control:
        cfg = dataclasses.replace(cfg, dense_warp_bf16=True)

    def flow_fn(a, b, init):
        return compute_flow_jit(a, b, cfg=cfg, init_flow=init)

    return cfg, flow_fn


def _log(*parts) -> None:
    print(*parts, file=sys.stderr, flush=True)


def run_cell(cell: spec.Cell, seed: int, seconds: float, traced: bool,
             device: torch.device, control: bool = False,
             traffic_spec: Optional[dict] = None,
             wrap: Optional[Callable[[Callable], Callable]] = None) -> dict:
    """One run of ``cell``; returns the result line as a dict.
    ``traffic_spec`` replaces the cell's traffic file (the tests' small
    runs); ``wrap`` wraps the port's entry point (the tests' planted
    faults)."""
    from eppm_tpu_torch.graphs import GRAPHS

    from . import reference

    conf = spec.config(cell.config)
    tspec = traffic_spec or spec.traffic(cell.traffic)
    limits = spec.limits(cell.name)
    names = cell.per_layer if traced else cell.end_to_end
    readers = spec.readers(list(names))
    cuda = device.type == "cuda"

    # -- set-up
    if cuda:
        from eppm_tpu_torch.ops._build import build_library

        build_library()
    cfg, flow_fn = _program(conf["config"], control)
    if wrap is not None:
        flow_fn = wrap(flow_fn)
    traffic = generator.make(tspec, seed, device, seconds)
    video = traffic.warm
    h, w = traffic.pair(0)[1].shape[:2]
    client = Client(traffic, flow_fn, device, video, events=traced)
    for i in range(3 if video else 2):
        client.pair(i)
    client.restart()
    if cuda:
        torch.cuda.synchronize(device)
    captures, evictions = GRAPHS.captures, GRAPHS.evictions

    # -- window
    setup_s = time.perf_counter() - T0
    flows: List = []
    keys: List[int] = []
    pair_ms: List[float] = []
    marks = []
    w0 = time.perf_counter()
    i = 0
    while True:
        key, flow, ms, ev = client.pair(i)
        keys.append(key)
        flows.append(flow)
        pair_ms.append(ms)
        marks.append(ev)
        i += 1
        if time.perf_counter() - w0 >= seconds:
            break
    window_s = time.perf_counter() - w0
    if GRAPHS.captures != captures or GRAPHS.evictions != evictions:
        raise RuntimeError(
            f"{GRAPHS.captures - captures} CUDA graph(s) captured and "
            f"{GRAPHS.evictions - evictions} evicted inside the window")
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    run = Run(pair_ms, window_s, setup_s, conf["config"], h, w)

    # -- traced extras: replay events, the profiled stretch, the stages
    breakdown = None
    if traced and cuda:
        torch.cuda.synchronize(device)
        run.replay_ms = [s.elapsed_time(e) for s, e in marks]
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for j in range(i, i + PROFILE_PAIRS):
                client.pair(j, spans=True)
            torch.cuda.synchronize(device)
        run.profile = reduce_profile(kineto_events(prof))
        del prof
        breakdown = {"device_ops": [list(x) for x in run.profile.device_ops],
                     "idle_gaps": [list(x) for x in run.profile.idle_gaps]}
        run.stages = _stage_ms(traffic, cfg, device, video, flows)
    client.restart()

    # -- correctness, with the port's graphs and buffers freed
    GRAPHS.clear()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    rcfg = reference.config_from_dict(conf["config"])

    def ref_fn(a, b, init):
        return reference.compute_flow(a, b, rcfg, init_flow=init)

    got = check.compare(seed, traffic, flows, keys, ref_fn, device)
    correct, checks = check.judge(got.worst, limits)
    failed = 0 if correct else got.flows
    _log(f"compared {got.flows} flows of pairs {got.pairs} with the "
         f"reference ({got.ref_s:.1f} s)")

    metrics = {}
    for m in names:
        value = readers[m.name](run)
        if value is not None:
            metrics[m.name] = {"value": value, "unit": m.unit}
    dev = _card_label(device)
    dev["memory_peak_bytes"] = int(peak)
    if traced and run.profile is not None:
        dev["busy_s"] = run.profile.busy_s
        dev["window_s"] = run.profile.window_s
    line = {"correct": bool(correct), "attempted": len(flows),
            "failed": failed, "metrics": metrics, "device": dev}
    if breakdown is not None:
        line["breakdown"] = breakdown
    line["checks"] = checks
    for name, c in checks.items():
        _log(f"check {name}: {c['value']!r} against the limit "
             f"{c['limit']!r}: {'ok' if c['value'] <= c['limit'] else 'FAIL'}")
    return line


def _stage_ms(traffic, cfg, device, video: bool, flows
              ) -> Optional[Dict[str, List[float]]]:
    """The cell's pair stage by stage (pool entry 0 cold; in a video the
    second pair, warm-started from the window's first flow), each stage a
    CUDA graph timed by events; logs each stage's median.  None where the
    stages' flow is not the flow the window produced for that pair:
    ``stages.py`` no longer runs what ``compute_flow`` runs, and the
    stage metrics would time code the program does not run, so they
    report nothing."""
    import statistics

    from .stages import GraphTimer, stages

    i = 1 if video and len(flows) > 1 else 0
    _, f1, f2 = traffic.pair(i)
    init = torch.from_numpy(flows[0]).to(device) if i == 1 else None
    timer = GraphTimer(device)
    flow = stages(torch.from_numpy(f1).to(device),
                  torch.from_numpy(f2).to(device), cfg, timer, init)
    same = bool(torch.equal(flow.cpu(), torch.from_numpy(flows[i])))
    total = sum(statistics.median(v) for v in timer.ms.values())
    _log(json.dumps({"stages_ms": {k: statistics.median(v)
                                   for k, v in timer.ms.items()},
                     "sum_ms": total, "flow_equals_window": same}))
    if not same:
        _log("flowbench: the stages' flow is not the window's flow; the "
             "stage metrics report nothing")
        return None
    return timer.ms


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m flowbench.run",
                                description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--control", action="store_true",
                   help="the port with its bfloat16 fine-level warp on: "
                        "the control the comparison has to fail")
    args = p.parse_args(argv)
    try:
        cell = spec.load(args.workload)
        spec.config(cell.config)
        generator.resolve(spec.traffic(cell.traffic))
        spec.limits(cell.name)
        spec.readers(list(cell.end_to_end + cell.per_layer))
    except spec.NotFound as e:
        _log(f"flowbench: {e}")
        return 2
    if not torch.cuda.is_available():
        _log("flowbench: no CUDA device; the benchmark runs on the card")
        return 2
    if torch.cuda.device_count() < cell.chips:
        _log(f"flowbench: {cell.name} needs {cell.chips} CUDA devices, "
             f"{torch.cuda.device_count()} present")
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    line = run_cell(cell, args.seed, args.seconds, bool(args.trace), device,
                    control=args.control)
    found = forbidden_modules()
    if found:
        _log(f"flowbench: the process holds {found} after the window")
        return 3
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
