"""Video-streaming throughput of the port, cold against the temporal warm
start (counterpart of the JAX package's ``tools/stream_bench.py``).

    python -m eppm_tpu_torch.bench.stream_bench [--frames 32]
        [--size 480x640] [--seed N]

Writes a synthetic video of ``--frames`` PPM frames to a temporary
directory: a ``testing.texture`` moving by a constant (3, 2) px a frame
(x, y), each frame a crop of one larger texture so that no wrap shows.
Streams it through the command line (``cli.main(["--frames-dir", ...])``)
cold, then with ``--temporal``, and prints one JSON line a mode: pairs a
second as the CLI reports them, end to end (decode, the replayed
pairs, the drain thread's read back and .flo writes), not device time.
Then the warm EPE line: the temporal run's flow of the middle pair
against the known motion, 16 px inside the frame, with
``speedup_vs_cold``.  Exits 1 if that EPE is 1 or more.  No CUDA graph
may be evicted during a mode's run.  With ``--device cpu`` the lines
hold no rate.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import shutil
import sys
import tempfile
from typing import List, Optional

import numpy as np

from .. import cli
from ..graphs import GRAPHS
from ..io import read_flo, write_ppm
from ..testing import texture
from . import _timing as T

DX, DY = 3, 2  # px a frame, constant


def make_frames(fdir: str, n: int, h: int, w: int, seed: int) -> None:
    """``n`` frames f0000.ppm ...: frame i is the crop of one texture at
    (DY * (n - 1 - i), DX * (n - 1 - i)), so the flow from each frame to
    the next is (DX, DY) everywhere the target lies in the frame."""
    big = (texture(h + DY * (n - 1), w + DX * (n - 1), seed) * 255
           ).astype(np.uint8)
    for i in range(n):
        y, x = DY * (n - 1 - i), DX * (n - 1 - i)
        write_ppm(os.path.join(fdir, f"f{i:04d}.ppm"),
                  np.ascontiguousarray(big[y : y + h, x : x + w]))


def run_mode(fdir: str, odir: str, temporal: bool, device: str) -> dict:
    """Stream the directory through the command line -> its JSON report."""
    argv = ["--frames-dir", fdir, "--out-dir", odir, "--device", device]
    if temporal:
        argv.append("--temporal")
    buf = io.StringIO()
    with T.window(f"stream {'temporal' if temporal else 'cold'}",
                  captures=False), contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    if rc != 0:
        raise RuntimeError(f"cli failed rc={rc}: {buf.getvalue()[-400:]}")
    return json.loads(buf.getvalue().strip().splitlines()[-1])


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m eppm_tpu_torch.bench.stream_bench",
        description=__doc__.split("\n\n")[0])
    T.add_common(p)
    p.add_argument("--frames", type=int, default=32)
    p.add_argument("--size", default="480x640", help="HxW")
    args = p.parse_args(argv)
    device = T.device_of(args.device)
    card = device.type == "cuda"
    h, w = T.parse_size(args.size)
    label = T.card_label(device)
    GRAPHS.clear()

    tmp = tempfile.mkdtemp(prefix="stream_bench_")
    try:
        fdir = os.path.join(tmp, "frames")
        os.makedirs(fdir)
        make_frames(fdir, args.frames, h, w, args.seed)
        fps = {}
        for mode, temporal in (("cold", False), ("temporal", True)):
            rep = run_mode(fdir, os.path.join(tmp, f"flo_{mode}"), temporal,
                           args.device)
            line = {"metric": f"stream_{h}x{w}_{mode}_fps",
                    "pairs": rep["pairs"], "device": label,
                    "frames": "synthetic (testing.texture, seed "
                              f"{args.seed}), ({DX}, {DY}) px a frame"}
            if card:
                fps[mode] = rep["fps"]
                line.update(value=rep["fps"], unit="frames/sec",
                            timing="end to end")
            print(json.dumps(line), flush=True)

        flow = read_flo(os.path.join(tmp, "flo_temporal",
                                     f"f{args.frames // 2:04d}.flo"))
        epe = T.interior_epe(flow, DX, DY)
        line = {"metric": f"stream_{h}x{w}_temporal_epe", "value": epe,
                "unit": "px", "device": label}
        if card:
            line["speedup_vs_cold"] = fps["temporal"] / fps["cold"]
        print(json.dumps(line), flush=True)
        return 0 if epe < 1.0 else 1
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


if __name__ == "__main__":
    sys.exit(main())
