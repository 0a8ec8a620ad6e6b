"""The port's CUDA-graph entry point, ``compute_flow_jit`` (``eppm_tpu_torch/
graphs.py``), and what a graph of the pipeline needs from every op, on the
CPU at 64x96:

(a) no read back to the host on the main path: ``Tensor.item``, ``tolist``,
    ``__bool__``, ``__int__``, ``__float__``, ``nonzero``, ``numpy`` and
    ``torch.nonzero`` raise while ``compute_flow`` runs the default
    config, the temporal warm pair and PatchMatch on its key (no plain
    version of a kernel needs an exemption);
(b) no host data turned into tensors per call: a second call of the same
    shape and config calls ``torch.from_numpy``, ``torch.tensor`` and
    ``torch.as_tensor`` no time (each op's tables are made once), nor
    sets a tensor's element to a Python value (a copy from the host);
(c) ``bilinear_resize``'s cached tables give its old per-call form's
    output bit for bit (the old form is kept here as the oracle);
(d) ``compute_flow_jit`` on CPU frames is ``compute_flow``, and held to
    ``eppm_tpu.pipeline.compute_flow_jit`` on a crop of
    ``holdout/disk_layered`` it agrees on every pixel (the contract's
    strongest form: no pixel disagrees, so none is left to be a tie);
    ``EPPMFlow`` and the command line go through it;
(e) the cache key, the launch accounting of capture and replay (a stub
    graph on the CPU), the eviction of the least recently used graph, and
    ``evaluate_dir``'s timing of a replay apart from a capture;
(f) on the card (``gpu``, skipped without one): the replayed flow
    ``torch.equal`` to the eager flow at 96x160, default and PatchMatch
    (on the GPU host: ``python3 -m pytest -q -p no:cacheprovider
    --noconftest -m gpu tests/test_torch_graph_ready.py``).
"""

import dataclasses

import numpy as np
import pytest
import torch

from eppm_tpu_torch import cli, graphs
from eppm_tpu_torch import pipeline as tpipe
from eppm_tpu_torch.config import DEFAULT_CONFIG as TC
from eppm_tpu_torch.ops import resize
from eppm_tpu_torch.ops._build import CudaKernel
from eppm_tpu_torch.ops._util import fma32
from eppm_tpu_torch.ops.prng import prng_key

# The suite runs several test processes per host: one torch thread each
# keeps them from oversubscribing the cores.
torch.set_num_threads(1)


def shifted_pair(h, w, dx, dy, seed):
    """float32 frames with frame1(p) = frame2(p + (dx, dy)), from a smooth
    seeded texture quantized to 8 bits (``tests/test_torch_pipeline.py``'s;
    this file imports no jax outside test (d), so that its ``gpu`` tests
    run on the GPU host, which has none)."""
    rng = np.random.default_rng(seed)
    m = 8
    small = rng.random((3, (h + 2 * m) // 8 + 2, (w + 2 * m) // 8 + 2))
    big = torch.nn.functional.interpolate(
        torch.from_numpy(small.astype(np.float32))[None], scale_factor=8,
        mode="bicubic", align_corners=False)[0].permute(1, 2, 0).numpy()
    big = (np.clip(big, 0, 1) * 255).astype(np.uint8)
    f2 = big[m : m + h, m : m + w]
    f1 = big[m + dy : m + dy + h, m + dx : m + dx + w]
    return [np.ascontiguousarray(f).astype(np.float32) / np.float32(255)
            for f in (f1, f2)]


PM = dataclasses.replace(TC, match_engine="patchmatch")
HOST_READS = ["item", "tolist", "__bool__", "__int__", "__float__",
              "nonzero", "numpy"]
HOST_DATA = ["from_numpy", "tensor", "as_tensor"]


@pytest.fixture(scope="module")
def pair():
    return [torch.from_numpy(f) for f in shifted_pair(64, 96, 3, -2, seed=7)]


@pytest.fixture(scope="module")
def warm_init(pair):
    """Pair 1's flow, the temporal init of the warm pair."""
    return tpipe.compute_flow(*pair)


def _calls(pair, warm_init):
    return {
        "default": lambda: tpipe.compute_flow(*pair),
        "temporal warm pair": lambda: tpipe.compute_flow(
            *pair, init_flow=warm_init),
        "patchmatch on its key": lambda: tpipe.compute_flow(
            *pair, PM, key=prng_key(PM.seed)),
    }


CALLS = ["default", "temporal warm pair", "patchmatch on its key"]


@pytest.mark.parametrize("call", CALLS)
def test_no_host_read_back(pair, warm_init, call, monkeypatch):
    run = _calls(pair, warm_init)[call]

    def raiser(name):
        def read(*args, **kwargs):
            raise AssertionError(f"{name} reads a tensor back to the host")
        return read

    for name in HOST_READS:
        monkeypatch.setattr(torch.Tensor, name, raiser(f"Tensor.{name}"))
    monkeypatch.setattr(torch, "nonzero", raiser("torch.nonzero"))
    flow = run()
    assert flow.shape == (64, 96, 2)


@pytest.mark.parametrize("call", CALLS)
def test_no_host_data_on_a_second_call(pair, warm_init, call, monkeypatch):
    run = _calls(pair, warm_init)[call]
    want = run()
    made = []
    for name in HOST_DATA:
        real = getattr(torch, name)

        def counted(*args, _real=real, _name=name, **kwargs):
            made.append(_name)
            return _real(*args, **kwargs)

        monkeypatch.setattr(torch, name, counted)
    setitem = torch.Tensor.__setitem__

    def checked_setitem(self, index, value):
        if not isinstance(value, torch.Tensor):  # a copy from the host
            made.append(f"Tensor.__setitem__ of {type(value).__name__}")
        return setitem(self, index, value)

    monkeypatch.setattr(torch.Tensor, "__setitem__", checked_setitem)
    assert torch.equal(run(), want)
    assert made == []


def resize_per_call(img, out_h, out_w, ratio, fused=False, shift=0):
    """``bilinear_resize`` as it was before its tables were cached: the
    indices and fractions made in numpy and copied on each call."""
    h, w = img.shape[0], img.shape[1]
    y0, y1, fy = resize._resize_axis_indices(out_h, h, ratio, shift)
    x0, x1, fx = resize._resize_axis_indices(out_w, w, ratio, shift)
    tail = (1,) * (img.dim() - 2)
    fy = torch.from_numpy(fy).reshape((-1, 1) + tail)
    fx = torch.from_numpy(fx).reshape((1, -1) + tail)
    r0 = img.index_select(0, torch.from_numpy(y0))
    r1 = img.index_select(0, torch.from_numpy(y1))

    def lerp(a, b, f):
        if fused:
            return fma32(a, 1.0 - f, b * f)
        return a * (1.0 - f) + b * f

    def row(r):
        return lerp(r.index_select(1, torch.from_numpy(x0)),
                    r.index_select(1, torch.from_numpy(x1)), fx)

    return lerp(row(r0), row(r1), fy)


RESIZES = {  # (input shape, out_h, out_w, ratio, fused, shift)
    "pyramid level 1": ((64, 96, 3), 32, 48, 0.5, False, 0),
    "pyramid level 3, effective ratio": ((60, 90, 3), 7, 11, 0.125 * 96 / 90,
                                         False, 0),
    "flow upsample x2": ((16, 24, 2), 32, 48, 2.0, False, 0),
    "temporal init, fused": ((64, 96, 2), 16, 24, 0.25, True, 0),
    "sharded tile, shift 2": ((20, 28, 2), 32, 48, 2.0, False, 2),
}


@pytest.mark.parametrize("case", list(RESIZES))
def test_bilinear_resize_tables_bit_for_bit(case):
    shape, oh, ow, ratio, fused, shift = RESIZES[case]
    img = torch.from_numpy(np.random.default_rng(3).normal(
        size=shape).astype(np.float32) * 7)
    want = resize_per_call(img, oh, ow, ratio, fused, shift)
    for _ in range(2):  # the table made, then found
        got = resize.bilinear_resize(img, oh, ow, ratio, fused, shift)
        assert got.shape == want.shape
        assert torch.equal(got, want)


def test_compute_flow_jit_on_cpu_is_compute_flow(pair, warm_init):
    assert torch.equal(tpipe.compute_flow_jit(*pair),
                       tpipe.compute_flow(*pair))
    assert torch.equal(
        tpipe.compute_flow_jit(*pair, init_flow=warm_init,
                               fine_level_wmf=True),
        tpipe.compute_flow(*pair, init_flow=warm_init, fine_level_wmf=True))
    key = prng_key(PM.seed + 1)
    assert torch.equal(tpipe.compute_flow_jit(*pair, key, PM),
                       tpipe.compute_flow(*pair, PM, key=key))


def test_compute_flow_jit_matches_jax_on_a_crop():
    import jax.numpy as jnp

    from eppm_tpu.config import DEFAULT_CONFIG as JC
    from eppm_tpu.pipeline import compute_flow_jit as jax_compute_flow_jit
    from test_torch_xla_sums import COST_CROP, disk_layered_frames

    y, x, h, w = COST_CROP
    f1, f2 = (f[y:y + h, x:x + w].copy() for f in disk_layered_frames()[:2])
    want = np.asarray(jax_compute_flow_jit(jnp.asarray(f1), jnp.asarray(f2),
                                           None, JC))
    got = tpipe.compute_flow_jit(torch.from_numpy(f1), torch.from_numpy(f2),
                                 None, TC).numpy()
    np.testing.assert_array_equal(got, want)


def test_entry_points_go_through_compute_flow_jit(pair, monkeypatch):
    seen = []
    real = tpipe.compute_flow_jit

    def spy(*args, **kwargs):
        seen.append(args[0].shape)
        return real(*args, **kwargs)

    monkeypatch.setattr(tpipe, "compute_flow_jit", spy)
    monkeypatch.setattr(cli, "compute_flow_jit", spy)
    model = tpipe.EPPMFlow(device="cpu")
    flow = model(*pair)
    assert torch.equal(model.set_data(*pair).compute_flow(), flow)
    assert torch.equal(cli.flow_fn(TC)(*pair), flow)
    assert len(seen) == 3
    # port-only draws stay on the eager compute_flow
    model.compute_flow(generator=torch.Generator().manual_seed(0))
    assert len(seen) == 3


def test_evaluate_dir_times_a_replay_apart_from_the_capture(
        tmp_path, monkeypatch):
    """``cli.evaluate_dir(timed=True)``: where a pair's call captured a
    graph (the first pair of a shape on the card; a stub here) its ms
    is "capture_ms", and "ms" is a second call's."""
    from eppm_tpu_torch.io import write_flo, write_ppm

    f1, f2 = shifted_pair(16, 24, 1, 0, seed=9)
    for name in ("a", "b"):
        d = tmp_path / name
        d.mkdir()
        write_ppm(str(d / "frame10.ppm"), (f1 * 255).astype(np.uint8))
        write_ppm(str(d / "frame11.ppm"), (f2 * 255).astype(np.uint8))
        write_flo(str(d / "flow10.flo"), np.zeros((16, 24, 2), np.float32))
    calls = []

    def stub_flow_fn(cfg, mesh=None):
        def run(a, b, init=None):
            calls.append(a.shape)
            if len(calls) == 1:
                graphs.GRAPHS.captures += 1   # as a first call captures
            return torch.zeros(a.shape[:2] + (2,))
        return run

    monkeypatch.setattr(cli, "flow_fn", stub_flow_fn)
    monkeypatch.setattr(graphs.GRAPHS, "captures", graphs.GRAPHS.captures)
    rep = cli.evaluate_dir(str(tmp_path), "frame10.ppm,frame11.ppm,"
                           "flow10.flo", TC, torch.device("cpu"),
                           timed=True)["sequences"]
    assert len(calls) == 3   # a: capture, then a replay; b: a replay
    assert "capture_ms" in rep["a"] and "capture_ms" not in rep["b"]
    assert rep["a"]["ms"] >= 0 and rep["b"]["ms"] >= 0
    assert rep["a"]["epe"] == rep["b"]["epe"] == 0.0


def test_graph_key_tells_every_specialisation_apart(pair, warm_init):
    a, b = pair
    base = graphs.graph_key(a, b, TC, False, None, None)
    assert base == graphs.graph_key(a.clone(), b.clone(), TC, False, None,
                                    None)
    variants = {
        "shape": graphs.graph_key(a[:32], b[:32], TC, False, None, None),
        "dtype": graphs.graph_key(a.double(), b.double(), TC, False, None,
                                  None),
        "config": graphs.graph_key(a, b, PM, False, None, None),
        "fine_level_wmf": graphs.graph_key(a, b, TC, True, None, None),
        "init_flow": graphs.graph_key(a, b, TC, False, warm_init, None),
        "key": graphs.graph_key(a, b, TC, False, None, prng_key(0)),
    }
    keys = [base] + list(variants.values())
    assert len(set(keys)) == len(keys)


class StubGraph:
    """A captured graph's stand-in on the CPU: a replay runs ``fn`` on the
    static inputs into the static output."""

    def __init__(self, fn, inputs, output):
        self.fn, self.inputs, self.output = fn, inputs, output

    def replay(self):
        self.output.copy_(self.fn(**self.inputs))


def stub_capture(kernel, per_run):
    """A ``graphs.capture`` for the CPU: ``fn`` runs once as the captured
    call, its wrapper counting ``per_run`` launches of ``kernel`` that a
    capture only records."""
    def make(key, fn, inputs):
        static = {n: None if t is None else t.clone()
                  for n, t in inputs.items()}
        before = graphs.launch_counts()

        def counted(**kw):
            kernel.launches += per_run
            return fn(**kw)

        output = counted(**static)
        launches = graphs.take_back_launches(before)
        return graphs.FlowGraph(key, StubGraph(fn, static, output), static,
                                output, launches)
    return make


def test_replays_add_the_captured_launches():
    kernel, idle = CudaKernel("stub_a", []), CudaKernel("stub_b", [])
    try:
        cache = graphs.GraphCache(make=stub_capture(kernel, 5))
        x = torch.arange(6.0)
        out = cache.run("k", lambda x: x * 2, {"x": x})
        # the capture recorded 5 launches and ran none; its replay ran 5
        assert kernel.launches == 5 and idle.launches == 0
        assert torch.equal(out, x * 2)
        y = torch.full((6,), 3.0)
        got = cache.run("k", lambda x: x * 2, {"x": y})
        assert torch.equal(got, y * 2)
        assert not torch.equal(got, out)   # a clone, not the static output
        cache.run("k", lambda x: x * 2, {"x": y})
        assert kernel.launches == 15 and idle.launches == 0
        assert cache.captures == 1
        (entry,) = cache.entries.values()
        assert entry.launches == {kernel: 5} and entry.replays == 3
    finally:
        CudaKernel.instances.remove(kernel)
        CudaKernel.instances.remove(idle)


def test_cache_evicts_the_least_recently_used():
    cache = graphs.GraphCache(capacity=2, make=lambda key, fn, inputs:
                              graphs.FlowGraph(key, StubGraph(fn, inputs,
                                                              fn(**inputs)),
                                               dict(inputs), fn(**inputs),
                                               {}))
    x = {"x": torch.ones(2)}
    for key in ("a", "b", "a", "c"):
        cache.run(key, lambda x: x + 1, x)
    assert list(cache.entries) == ["a", "c"]
    assert cache.captures == 3 and cache.evictions == 1


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: CUDA graphs are captured and "
                    "replayed only on the GPU host (chip_smoke.py runs the "
                    "same check)")
    return torch.device("cuda", 0)


@pytest.mark.gpu
@pytest.mark.parametrize("cfg", [TC, PM], ids=["default", "patchmatch"])
def test_replay_equals_eager_on_the_card(cuda, cfg):
    a, b = (torch.from_numpy(f).to(cuda)
            for f in shifted_pair(96, 160, 3, -2, seed=8))
    eager = tpipe.compute_flow(a, b, cfg)
    first = tpipe.compute_flow_jit(a, b, None, cfg)
    again = tpipe.compute_flow_jit(a, b, None, cfg)
    assert torch.equal(first, eager) and torch.equal(again, eager)
