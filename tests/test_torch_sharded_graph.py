"""The sharded entry point's graph (``eppm_tpu_torch/parallel/sharded.py``
over ``eppm_tpu_torch/graphs.py``): ``compute_flow_sharded`` splits into a
front (checks, padding, default keys on the device, crop) and a body,
the loop over the pairs, which on a mesh of one card is one CUDA graph
per key, captured once and replayed.  On the CPU, at 32x48:

(a) on each mesh, (1, 1, 2), (1, 2, 2) padded from 30x46, a (2, 1, 1)
    batch of two, a warm (1, 1, 2) pair with ``init_flows`` and
    PatchMatch on its default keys, the entry reads nothing back to the
    host, and makes no host data on a second call (the monkeypatches of
    ``tests/test_torch_graph_ready.py``);
(b) the graph key tells apart the mesh's shape and devices, the batch,
    the padded shape, the dtype, the config, and whether ``init_flows``
    and ``keys`` are given; one capture per key, none on a repeated call;
(c) on a stub graph (the graph path forced on a CPU mesh): a replay adds
    the launches the capture recorded, the same as the eager call, once
    a tile for the refine and the smoothing; the replayed flow is the
    eager flow;
(d) which meshes take the graph: one card does, CPU meshes and meshes of
    several cards run the eager body (the latter logged once a mesh); a
    failed capture raises with its key and nothing falls back;
(e) ``cli --mesh`` and the stream CLI with ``--mesh`` go through the
    graphed entry;
(f) on the card (``gpu``, skipped without one): the replay ``torch.equal``
    to the eager body on (1, 1, 2) and (2, 1, 1) meshes (on the GPU host:
    ``python3 -m pytest -q -p no:cacheprovider --noconftest -m gpu
    tests/test_torch_sharded_graph.py``).

The parity of the sharded flow with ``eppm_tpu.parallel`` stays in
``tests/test_torch_sharded*.py``: this file imports no jax, so that its
``gpu`` tests run on the GPU host, which has none."""

import contextlib
import dataclasses
import io
import json
import logging
import math

import numpy as np
import pytest
import torch

from eppm_tpu_torch import cli, graphs
from eppm_tpu_torch.config import DEFAULT_CONFIG as TC
from eppm_tpu_torch.io import write_ppm
from eppm_tpu_torch.ops._build import CudaKernel
from eppm_tpu_torch.ops.prng import fold_in, prng_key
from eppm_tpu_torch.parallel import (compute_flow_sharded,
                                     compute_flow_sharded_eager, make_mesh,
                                     sharded)
from test_torch_graph_ready import (HOST_DATA, HOST_READS, StubGraph,
                                    shifted_pair)

# The suite runs several test processes per host: one torch thread each
# keeps them from oversubscribing the cores.
torch.set_num_threads(1)

PM = dataclasses.replace(TC, match_engine="patchmatch")
H, W = 32, 48


def cpu_mesh(b, y, x):
    return make_mesh(b, y, x, devices=["cpu"] * (b * y * x))


@pytest.fixture(scope="module")
def frames():
    """(2, H, W, 3) float32 frames of two shifted pairs."""
    pairs = [shifted_pair(H, W, 3, -2, seed=7),
             shifted_pair(H, W, -2, 1, seed=8)]
    return [torch.from_numpy(np.stack([p[k] for p in pairs]))
            for k in (0, 1)]


def shift_flow(b, h, w):
    """A warm start: the pairs' first shift everywhere."""
    return torch.tensor([3.0, -2.0]).expand(b, h, w, 2).contiguous()


def call(case, frames):
    """The arguments of ``compute_flow_sharded`` for a mesh ``case``."""
    a, b = frames
    one = (a[:1], b[:1])
    return {
        "(1, 1, 2)": lambda: (*one, cpu_mesh(1, 1, 2), TC),
        "(1, 2, 2), padded": lambda: (
            a[:1, :30, :46], b[:1, :30, :46], cpu_mesh(1, 2, 2), TC),
        "(2, 1, 1), a batch of two": lambda: (a, b, cpu_mesh(2, 1, 1), TC),
        "(1, 1, 2), warm": lambda: (
            *one, cpu_mesh(1, 1, 2), TC, None, True, shift_flow(1, H, W)),
        "(1, 1, 2), patchmatch on its default keys": lambda: (
            *one, cpu_mesh(1, 1, 2), PM),
    }[case]()


CASES = ["(1, 1, 2)", "(1, 2, 2), padded", "(2, 1, 1), a batch of two",
         "(1, 1, 2), warm", "(1, 1, 2), patchmatch on its default keys"]


@pytest.mark.parametrize("case", CASES)
def test_no_host_read_back_and_no_host_data_on_a_second_call(
        frames, case, monkeypatch):
    args = call(case, frames)
    with monkeypatch.context() as m:
        def raiser(name):
            def read(*a, **k):
                raise AssertionError(f"{name} reads a tensor back to the "
                                     "host")
            return read

        for name in HOST_READS:
            m.setattr(torch.Tensor, name, raiser(f"Tensor.{name}"))
        m.setattr(torch, "nonzero", raiser("torch.nonzero"))
        want = compute_flow_sharded(*args)
    assert want.shape == args[0].shape[:3] + (2,)

    made = []
    for name in HOST_DATA:
        real = getattr(torch, name)

        def counted(*a, _real=real, _name=name, **k):
            made.append(_name)
            return _real(*a, **k)

        monkeypatch.setattr(torch, name, counted)
    setitem = torch.Tensor.__setitem__

    def checked_setitem(self, index, value):
        if not isinstance(value, torch.Tensor):  # a copy from the host
            made.append(f"Tensor.__setitem__ of {type(value).__name__}")
        return setitem(self, index, value)

    monkeypatch.setattr(torch.Tensor, "__setitem__", checked_setitem)
    assert torch.equal(compute_flow_sharded(*args), want)
    assert made == []


def test_graph_key_tells_every_specialisation_apart(frames):
    a, b = frames[0][:1], frames[1][:1]
    mesh = make_mesh(1, 1, 2, devices=["cuda:0"] * 2)
    base = sharded.sharded_graph_key(a, b, None, False, TC, mesh)
    assert base == sharded.sharded_graph_key(
        a.clone(), b.clone(), None, False, TC,
        make_mesh(1, 1, 2, devices=["cuda:0"] * 2))
    two = torch.cat([a, a]), torch.cat([b, b])
    variants = {
        "mesh shape": sharded.sharded_graph_key(
            a, b, None, False, TC, make_mesh(1, 2, 1, devices=["cuda:0"] * 2)),
        "device list": sharded.sharded_graph_key(
            a, b, None, False, TC, make_mesh(1, 1, 2, devices=["cuda:1"] * 2)),
        "batch": sharded.sharded_graph_key(*two, None, False, TC, make_mesh(
            1, 1, 2, devices=["cuda:0"] * 2)),
        "padded shape": sharded.sharded_graph_key(
            a[:, :16], b[:, :16], None, False, TC, mesh),
        "dtype": sharded.sharded_graph_key(
            (a * 255).to(torch.uint8), (b * 255).to(torch.uint8), None,
            False, TC, mesh),
        "config": sharded.sharded_graph_key(a, b, None, False, PM, mesh),
        "init_flows": sharded.sharded_graph_key(
            a, b, shift_flow(1, H, W), False, TC, mesh),
        "keys": sharded.sharded_graph_key(a, b, None, True, TC, mesh),
        "compute_flow_jit's key": graphs.graph_key(a[0], b[0], TC, False,
                                                   None, None),
    }
    keys = [base] + list(variants.values())
    assert len(set(keys)) == len(keys)


def stub_cache(recording=None, fail=False):
    """A ``GraphCache`` of stub graphs for the CPU: the capture runs ``fn``
    once (its wrappers record launches, which are taken back), a replay
    runs it again with ``recording[0]`` False (on the card a replay runs
    no wrapper); ``fail``: the capture raises, naming its key."""
    def make(key, fn, inputs):
        static = {n: None if t is None else t.clone()
                  for n, t in inputs.items()}
        before = graphs.launch_counts()
        output = fn(**static)
        launches = graphs.take_back_launches(before)
        if fail:
            raise RuntimeError(f"CUDA graph capture of {key} failed: stub")

        def replay(**kw):
            if recording is None:
                return fn(**kw)
            recording[0] = False
            try:
                return fn(**kw)
            finally:
                recording[0] = True

        return graphs.FlowGraph(key, StubGraph(replay, static, output),
                                static, output, launches)
    return graphs.GraphCache(make=make)


def fake_body(seen):
    """A cheap stand-in for the sharded body that records its arguments:
    the frames' difference as the flow."""
    def body(imgs1, imgs2, keys, init_flows, cfg, mesh):
        seen.append((imgs1.shape, keys, init_flows, cfg, mesh))
        return (imgs1[..., :2] - imgs2[..., :2]).float()
    return body


def force_graph(monkeypatch, cache):
    """Send CPU meshes down the graph path, into ``cache``."""
    monkeypatch.setattr(sharded, "one_card", lambda mesh: torch.device("cpu"))
    monkeypatch.setattr(sharded, "GRAPHS", cache)


def test_one_capture_per_key_and_the_front(frames, monkeypatch):
    """The front hands the body the padded frames and the default keys
    ``fold_in(prng_key(seed), b)`` made on the device, and crops; a
    repeated call replays, each new specialisation captures."""
    monkeypatch.setattr(sharded, "_sharded_body", fake_body([]))
    cache = stub_cache()
    force_graph(monkeypatch, cache)
    a, b = frames
    m12 = cpu_mesh(1, 1, 2)
    runs = [
        ((a[:1], b[:1], m12), {}),
        ((a[:1], b[:1], m12), {}),                       # replayed
        ((a[:1], b[:1], cpu_mesh(1, 2, 1)), {}),          # mesh shape
        ((a, b, m12), {}),                                # batch
        ((a[:1, :30, :46], b[:1, :30, :46], cpu_mesh(1, 2, 2)), {}),
        ((a[:1], b[:1], m12), {"init_flows": shift_flow(1, H, W)}),
        ((a[:1], b[:1], m12), {"keys": prng_key(5)[None]}),
        ((a[:1], b[:1], m12), {"cfg": PM}),
        ((a[:1], b[:1], m12), {}),                        # replayed
    ]
    for args, kw in runs:
        out = compute_flow_sharded(*args, **kw)
        assert torch.equal(out, (args[0][..., :2] - args[1][..., :2]))
    assert cache.captures == 7
    first = cache.entries[sharded.sharded_graph_key(
        a[:1], b[:1], None, False, TC, m12)]
    assert first.replays == 3
    assert torch.equal(first.inputs["keys"],
                       fold_in(prng_key(TC.seed), torch.arange(1)))
    batch = cache.entries[sharded.sharded_graph_key(a, b, None, False, TC,
                                                    m12)]
    assert torch.equal(batch.inputs["keys"],
                       fold_in(prng_key(TC.seed), torch.arange(2)))
    # the padded frames are the graph's inputs; the crop is the front's
    (padded,) = [e for k, e in cache.entries.items() if k[1] == (1, 2, 2)]
    assert padded.inputs["imgs1"].shape == (1, 32, 48, 3)


def test_replays_add_the_launches_of_every_tile(frames, monkeypatch):
    """Kernel A's and B's stand-ins count a launch a call of the tiled
    refine and smoothing while wrappers run (eager, capture): a replay
    adds what the eager call launched, once a tile a pass, and its flow
    is the eager flow."""
    a, b, mesh, cfg = call("(1, 2, 2), padded", frames)
    refine, smooth = CudaKernel("stub_a", []), CudaKernel("stub_b", [])
    recording = [True]
    try:
        for name, kernel in (("dense_refine_flow", refine),
                             ("flow_smoothing_auto", smooth)):
            real = getattr(sharded, name)

            def counted(*args, _real=real, _kernel=kernel, **kw):
                if recording[0]:
                    _kernel.launches += 1
                return _real(*args, **kw)

            monkeypatch.setattr(sharded, name, counted)
        want = compute_flow_sharded_eager(a, b, mesh, cfg)
        eager = {refine: refine.launches, smooth: smooth.launches}
        levels = len(cfg.pyramid.level_dims(32, 48))
        tiles = 4
        assert eager == {refine: tiles * (levels - 1) * 2,
                         smooth: tiles * levels}
        refine.launches = smooth.launches = 0
        cache = stub_cache(recording)
        force_graph(monkeypatch, cache)
        first = compute_flow_sharded(a, b, mesh, cfg)
        assert {refine: refine.launches, smooth: smooth.launches} == eager
        again = compute_flow_sharded(a, b, mesh, cfg)
        assert refine.launches == 2 * eager[refine]
        assert smooth.launches == 2 * eager[smooth]
        assert cache.captures == 1
        (entry,) = cache.entries.values()
        assert entry.launches == eager and entry.replays == 2
        assert torch.equal(first, want) and torch.equal(again, want)
    finally:
        CudaKernel.instances.remove(refine)
        CudaKernel.instances.remove(smooth)


def test_which_meshes_take_the_graph(frames, monkeypatch, caplog):
    """One card takes the graph (a device with and without its index
    counts as one); a CPU mesh and a mesh of two cards run the eager body,
    the latter logged once a mesh."""
    assert sharded.one_card(make_mesh(1, 1, 2, devices=["cuda:0"] * 2)) \
        == torch.device("cuda", 0)
    assert sharded.one_card(make_mesh(1, 2, 1, devices=["cuda:1"] * 2)) \
        == torch.device("cuda", 1)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    assert sharded.one_card(make_mesh(1, 1, 2, devices=["cuda", "cuda:0"])) \
        == torch.device("cuda", 0)
    for devices in (["cuda:0", "cuda:1"], ["cuda:0", "cpu"], ["cpu"] * 2):
        assert sharded.one_card(make_mesh(1, 1, 2, devices=devices)) is None

    seen = []
    monkeypatch.setattr(sharded, "_sharded_body", fake_body(seen))
    cache = stub_cache(fail=True)    # any capture would raise
    monkeypatch.setattr(sharded, "GRAPHS", cache)
    monkeypatch.setattr(sharded, "_EAGER_MESHES", set())
    a, b = frames[0][:1], frames[1][:1]
    keys = prng_key(0)[None]         # on the CPU: no card is touched
    caplog.set_level(logging.WARNING, logger=sharded.__name__)
    for mesh in (cpu_mesh(1, 1, 2),
                 make_mesh(1, 1, 2, devices=["cuda:0", "cuda:1"])):
        for _ in range(2):
            compute_flow_sharded(a, b, mesh, TC, keys)
    assert len(seen) == 4 and cache.captures == 0
    logged = [r for r in caplog.records if "spans 2 cards" in r.getMessage()]
    assert len(logged) == 1


def test_a_failed_capture_raises_and_nothing_falls_back(frames, monkeypatch):
    seen = []
    monkeypatch.setattr(sharded, "_sharded_body", fake_body(seen))
    cache = stub_cache(fail=True)
    force_graph(monkeypatch, cache)
    a, b = frames[0][:1], frames[1][:1]
    for _ in range(2):   # not cached as failed: each call tries again
        with pytest.raises(RuntimeError, match=r"capture of \("
                           r"'compute_flow_sharded', \(1, 1, 2\)"):
            compute_flow_sharded(a, b, cpu_mesh(1, 1, 2), TC)
    assert len(seen) == 2 and not cache.entries


def _cli(args):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert cli.main(args) == 0
    return json.loads(buf.getvalue().strip().splitlines()[-1])


def test_cli_mesh_goes_through_the_graphed_entry(frames, tmp_path,
                                                 monkeypatch):
    """``--mesh`` for a pair and for a ``--temporal`` stream: each pair
    through ``compute_flow_sharded``'s graph, the stream's cold pairs and
    its warm pairs a graph each."""
    monkeypatch.setattr(sharded, "_sharded_body", fake_body([]))
    cache = stub_cache()
    force_graph(monkeypatch, cache)
    f1, f2 = ((f[0].numpy() * 255).astype(np.uint8) for f in frames)
    write_ppm(str(tmp_path / "a.ppm"), f1)
    write_ppm(str(tmp_path / "b.ppm"), f2)
    rep = _cli([str(tmp_path / "a.ppm"), str(tmp_path / "b.ppm"), "-o",
                str(tmp_path / "flow.flo"), "--mesh", "1,1,2", "--device",
                "cpu"])
    assert rep["shape"] == [H, W, 2] and cache.captures == 1
    (entry,) = cache.entries.values()
    assert entry.key[:2] == ("compute_flow_sharded", (1, 1, 2))
    frames_dir = tmp_path / "frames"
    frames_dir.mkdir()
    for i, f in enumerate((f1, f2, f1, f2)):
        write_ppm(str(frames_dir / f"{i}.ppm"), f)
    rep = _cli(["--frames-dir", str(frames_dir), "--temporal", "--mesh",
                "1,2,1", "--device", "cpu"])
    assert rep["pairs"] == 3
    stream = [e for k, e in cache.entries.items() if k[1] == (1, 2, 1)]
    assert cache.captures == 3 and len(stream) == 2
    cold, warm = sorted(stream, key=lambda e: e.key[6] is not None)
    # the warm-up pair, cold then warm; then the first pair cold, the
    # next two warm
    assert cold.key[6] is None and warm.key[6] is not None
    assert cold.replays == 2 and warm.replays == 3


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: CUDA graphs are captured and "
                    "replayed only on the GPU host (chip_smoke.py phase 7 "
                    "runs the same check at 1080p)")
    return torch.device("cuda", 0)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(1, 1, 2), (2, 1, 1)],
                         ids=["(1, 1, 2)", "(2, 1, 1)"])
def test_replay_equals_eager_on_the_card(cuda, shape):
    pairs = [shifted_pair(96, 160, 3, -2, seed=8),
             shifted_pair(96, 160, -2, 1, seed=9)][:shape[0]]
    a, b = (torch.from_numpy(np.stack([p[k] for p in pairs])).to(cuda)
            for k in (0, 1))
    mesh = make_mesh(*shape, devices=[cuda] * math.prod(shape))
    eager = compute_flow_sharded_eager(a, b, mesh)
    captures = graphs.GRAPHS.captures
    first = compute_flow_sharded(a, b, mesh)
    again = compute_flow_sharded(a, b, mesh)
    assert graphs.GRAPHS.captures == captures + 1
    assert torch.equal(first, eager) and torch.equal(again, eager)
