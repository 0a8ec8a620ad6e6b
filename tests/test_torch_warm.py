"""The temporal warm start of the PyTorch port against ``eppm_tpu``: the
saturating float -> int32 truncation it relies on, the coarse init resize,
and the bidirectional coarse matcher with ``init_flow`` (both
``warm_skip_global`` values).  The single-direction matcher and the whole
warm-started pipeline are in tests/test_torch_warm_flow.py and
tests/test_torch_legacy_wmf.py, ``EPPMFlow.compute_flow(init_flow=...)``
in tests/test_torch_utils.py: the JAX compiles are split so that no file
runs long."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import eppm_tpu.ops.match as jmatch
from eppm_tpu.config import DEFAULT_CONFIG as JD
from eppm_tpu.pipeline import _coarse_init

from eppm_tpu_torch import pipeline as tpipe
from eppm_tpu_torch.config import UNKNOWN_FLOW, config_from_dict
from eppm_tpu_torch.ops import match as tmatch
from eppm_tpu_torch.ops._util import trunc_i32
from eppm_tpu_torch.ops.census import census_transform
from eppm_tpu_torch.ops.cost import pack_frame
from test_torch_match import _exact_cost
from test_torch_pipeline import shifted_pair

torch.set_num_threads(1)

JCFG = dataclasses.replace(JD, pyramid=dataclasses.replace(JD.pyramid,
                                                          max_depth=2))


def configs(**match):
    """The JAX package's config with ``match`` fields changed, and the
    port's built from it."""
    jc = dataclasses.replace(JCFG, match=dataclasses.replace(JCFG.match,
                                                             **match))
    return jc, config_from_dict(dataclasses.asdict(jc))


def warm_init(flow: np.ndarray) -> np.ndarray:
    """A previous pair's flow as a stream hands it on, with what such a
    flow may hold: unknown flow (1e10) and values beyond +-2^31."""
    init = flow.copy()
    init[:6, :9] = UNKNOWN_FLOW
    init[12:14, 4:10, 0] = -3.7e9
    init[20, 20:30, 1] = 3.7e9
    return init


def test_trunc_i32_saturates_like_xla():
    x = np.array([1e10, -1e10, 3.7e9, -3.7e9, np.nan, 0.5, -0.5, -2.7, 2.7,
                  np.inf, -np.inf, 2147483520.0, 2147483648.0, -2147483648.0],
                 np.float32)
    want = np.asarray(jax.jit(lambda v: jnp.trunc(v).astype(jnp.int32))(x))
    got = trunc_i32(torch.from_numpy(x))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_coarse_init_matches_jax():
    """The resize of a full-resolution init (holding unknown flow) to the
    coarse level, at a ratio that is not a power of two."""
    rng = np.random.default_rng(3)
    init = warm_init(rng.normal(0, 4, (60, 100, 2)).astype(np.float32))
    want = np.asarray(jax.jit(
        lambda f: _coarse_init(f, 23, 38, None))(init))
    got = tpipe._coarse_init(torch.from_numpy(init), 23, 38)
    np.testing.assert_array_equal(got.numpy(), want)


def _level(h, w, dx, dy, seed):
    """A coarse-level pair: images and packs, numpy and torch."""
    f1, f2 = shifted_pair(h, w, dx, dy, seed)
    out = []
    for f in (f1, f2):
        t = torch.from_numpy(f)
        out.append((f, t, pack_frame(t, census_transform(t))))
    return out


@pytest.fixture(scope="module")
def level():
    (a1, t1, p1), (a2, t2, p2) = _level(48, 64, 5, -3, seed=4)
    rng = np.random.default_rng(4)
    flow = np.zeros((48, 64, 2), np.float32)
    flow[..., 0], flow[..., 1] = 5, -3
    flow += rng.integers(-2, 3, flow.shape).astype(np.float32)
    return (a1, t1, p1), (a2, t2, p2), warm_init(flow)


def assert_direction_agrees(got, want, pa, pb, skip):
    """One direction's (tx, ty, cost) against the JAX package's.  Under
    ``warm_skip_global`` no global stage runs, so the targets are
    identical.  Otherwise the global argmax multiplies in float64 here and
    in float32 there (tests/test_torch_match.py): <= 2% of the targets may
    differ, each a tie of the quantized exact cost.  The costs: identical
    but where the exact stage's float32 sums round to the neighbouring
    2^-17 step (<= 0.1% of pixels, one step)."""
    gx, gy, gc = (t.numpy() for t in got)
    wx, wy, wc = (np.asarray(t) for t in want)
    differ = (gx != wx) | (gy != wy)
    if skip:
        assert not differ.any(), f"{differ.sum()} targets differ"
    else:
        assert differ.mean() <= 0.02, differ.mean()
        if differ.any():
            np.testing.assert_array_equal(_exact_cost(pa, pb, gx, gy)[differ],
                                          _exact_cost(pa, pb, wx, wy)[differ])
    same = ~differ
    steps = np.abs(gc[same] - wc[same]) * 131072.0
    assert (steps > 0).mean() <= 1e-3 and steps.max() <= 1.0 + 1e-6


@pytest.mark.parametrize("skip", [True, False])
def test_match_coarse_bidi_warm_start_matches_jax(level, skip):
    (a1, t1, p1), (a2, t2, p2), init = level
    jc, tc = configs(warm_skip_global=skip)
    want = jax.jit(lambda i1, i2, q1, q2, f: jmatch.match_coarse_bidi(
        i1, i2, jc.cost, jc.match, jc.cost_tap_chunk, q1, q2, init_flow=f))(
        a1, a2, p1.numpy(), p2.numpy(), init)
    got = tmatch.match_coarse_bidi(t1, t2, tc.cost, tc.match, p1, p2,
                                   init_flow=torch.from_numpy(init))
    q1, q2 = p1.numpy(), p2.numpy()
    assert_direction_agrees(got[0], want[0], q1, q2, skip)
    assert_direction_agrees(got[1], want[1], q2, q1, skip)


def stream_pairs():
    """Pairs 1 and 2 of a constant-motion stream (3, -2) at 64x96 (frame 3
    is frame 2 rolled by the motion), and
    pair 1's flow by the port (the default path agrees with the JAX
    package: tests/test_torch_pipeline.py) with unknown and huge values
    as the init of pair 2."""
    f1, f2 = shifted_pair(64, 96, 3, -2, seed=6)
    # frame 3 continues the motion: f2(p) = f3(p + (3, -2))
    f3 = np.ascontiguousarray(np.roll(f2, (-2, 3), (0, 1)))
    _, tc = configs()
    flow1 = tpipe.compute_flow(torch.from_numpy(f1), torch.from_numpy(f2), tc)
    return f2, f3, warm_init(flow1.numpy())
