"""The PyTorch port's config, I/O, metrics and prepare stage against the
JAX package: same inputs (made with numpy from a seed), same outputs.

Prepare (resize, pyramid, census, pack) is exact, for float and for
uint8 frames (where the JAX program folds the 1/255 scale into one tap of
the pre-smoothing filter, and the port reproduces the fold)."""

import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import eppm_tpu.config as jcfg
import eppm_tpu.metrics as jmetrics
import eppm_tpu.pipeline as jpipe
from eppm_tpu.io.flo import read_flo as j_read_flo
from eppm_tpu.io.ppm import read_ppm as j_read_ppm
from eppm_tpu.ops import census as jcensus
from eppm_tpu.ops import resize as jresize

import eppm_tpu_torch.config as tcfg
import eppm_tpu_torch.pipeline as tpipe
from eppm_tpu_torch import io as tio
from eppm_tpu_torch import metrics as tmetrics
from eppm_tpu_torch.ops import census as tcensus
from eppm_tpu_torch.ops import resize as tresize
from eppm_tpu_torch.ops._util import exp_cephes

# The suite runs several test processes per host: one torch thread each
# keeps them from oversubscribing the cores.
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def T(a):
    return torch.from_numpy(np.array(a))


def test_import_pulls_in_no_jax():
    """The GPU host has no jax: the port must not import it, nor the JAX
    package (whose __init__ imports jax)."""
    code = (
        "import sys, eppm_tpu_torch, eppm_tpu_torch.pipeline, "
        "eppm_tpu_torch.cli, eppm_tpu_torch.ops.cuda_cost, "
        "eppm_tpu_torch.ops.cuda_smooth, eppm_tpu_torch.ops.cuda_wmf, "
        "eppm_tpu_torch.ops.cuda_match; "
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.') "
        "or m == 'eppm_tpu' or m.startswith('eppm_tpu.')]; "
        "assert not bad, bad"
    )
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True,
                   timeout=120)


def test_default_config_equal_and_same_fingerprint():
    assert (tcfg.config_fingerprint(tcfg.DEFAULT_CONFIG)
            == jcfg.config_fingerprint(jcfg.DEFAULT_CONFIG))
    tj = dataclasses.asdict(jcfg.DEFAULT_CONFIG)
    tt = dataclasses.asdict(tcfg.DEFAULT_CONFIG)
    assert tt == tj
    for name in ("INVALID_LOCATION", "UNKNOWN_FLOW", "UNKNOWN_FLOW_THRESH",
                 "FLT_MAX"):
        assert getattr(tcfg, name) == getattr(jcfg, name)
    c = tcfg.DEFAULT_CONFIG
    assert c.cost.tap_offsets == jcfg.DEFAULT_CONFIG.cost.tap_offsets
    assert c.pass2_cost.tap_offsets == jcfg.DEFAULT_CONFIG.pass2_cost.tap_offsets
    assert c.warp_dtype in (None, torch.bfloat16)


def test_config_from_dict_round_trip_non_default():
    j = dataclasses.replace(
        jcfg.DEFAULT_CONFIG,
        dense_search_radius=2,
        cost=dataclasses.replace(jcfg.DEFAULT_CONFIG.cost, patch_radius=5),
        match=dataclasses.replace(jcfg.DEFAULT_CONFIG.match,
                                  prop_steps=(4, 2, 1)),
        refine=dataclasses.replace(jcfg.DEFAULT_CONFIG.refine,
                                   wmf_polish_dilations=(2, 1)),
    )
    t = tcfg.config_from_dict(dataclasses.asdict(j))
    assert tcfg.config_fingerprint(t) == jcfg.config_fingerprint(j)
    assert t.match.prop_steps == (4, 2, 1)
    assert t.refine.wmf_polish_dilations == (2, 1)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    with pytest.raises(ValueError):
        tcfg.config_from_dict({"no_such_field": 1})


def test_exp_cephes_is_xla_exp_bit_for_bit(rng):
    """The port's exp (plain versions and kernels) reproduces the JAX
    package's float32 exp on the CPU, subnormal flush included."""
    x = np.concatenate([-rng.random(100_000) * 95.0,
                        rng.random(20_000) * 10.0 - 5.0,
                        [0.0, -87.8, -88.0, -104.0, 88.0]]).astype(np.float32)
    want = np.asarray(jax.jit(jnp.exp)(jnp.asarray(x)))
    np.testing.assert_array_equal(exp_cephes(T(x)).numpy(), want)


@pytest.mark.parametrize("h,w", [(96, 160), (1080, 1920), (375, 1242)])
def test_level_dims_match(h, w):
    assert (tcfg.DEFAULT_CONFIG.pyramid.level_dims(h, w)
            == jcfg.DEFAULT_CONFIG.pyramid.level_dims(h, w))


@pytest.mark.parametrize("sigma,radius", [(0.5, 2), (1.0, 3), (2.0, 6)])
def test_gaussian_filter_exact(rng, sigma, radius):
    x = rng.random((37, 53, 3)).astype(np.float32)
    want = np.asarray(jax.jit(
        lambda a: jresize.gaussian_filter(a, sigma, radius))(jnp.asarray(x)))
    got = tresize.gaussian_filter(T(x), sigma, radius).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("src,oh,ow,ratio", [
    ((48, 80), 24, 40, 0.5), ((48, 80), 12, 20, 0.25),
    ((48, 80), 96, 160, 2.0), ((135, 240), 67, 120, 0.5),
])
def test_bilinear_resize_exact(rng, src, oh, ow, ratio):
    x = rng.random(src + (2,)).astype(np.float32)
    want = np.asarray(jax.jit(
        lambda a: jresize.bilinear_resize(a, oh, ow, ratio))(jnp.asarray(x)))
    got = tresize.bilinear_resize(T(x), oh, ow, ratio).numpy()
    np.testing.assert_array_equal(got, want)


def test_census_exact(rng):
    img = rng.random((33, 47, 3)).astype(np.float32)
    want = np.asarray(jax.jit(jcensus.census_transform)(jnp.asarray(img)))
    got = tcensus.census_transform(T(img)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kind", ["float", "uint8"])
def test_prepare_pyramids(rng, kind):
    img = rng.integers(0, 256, (96, 160, 3)).astype(np.uint8)
    if kind == "float":
        img = img.astype(np.float32) / np.float32(255)
    jl, jp = jax.jit(lambda a: jpipe.prepare_pyramids(
        a, jcfg.DEFAULT_CONFIG))(jnp.asarray(img))
    tl, tp = tpipe.prepare_pyramids(T(img), tcfg.DEFAULT_CONFIG)
    assert len(tl) == len(jl) == 3
    for a, b, c, d in zip(jl, tl, jp, tp):
        assert tuple(b.shape) == a.shape and tuple(d.shape) == c.shape
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
        np.testing.assert_array_equal(d.numpy(), np.asarray(c))


def test_io_round_trips_and_matches_jax_readers(tmp_path, rng):
    img = rng.integers(0, 256, (7, 9, 3)).astype(np.uint8)
    flow = rng.normal(0, 3, (7, 9, 2)).astype(np.float32)
    flow[0, 0] = 1e10
    p_img, p_flo = str(tmp_path / "a.ppm"), str(tmp_path / "a.flo")
    tio.write_ppm(p_img, img)
    tio.write_flo(p_flo, flow)
    np.testing.assert_array_equal(tio.read_ppm(p_img), img)
    np.testing.assert_array_equal(j_read_ppm(p_img), img)
    np.testing.assert_array_equal(tio.read_flo(p_flo), flow)
    np.testing.assert_array_equal(j_read_flo(p_flo), flow)
    gray = img[..., 0]
    tio.write_ppm(p_img, gray)
    np.testing.assert_array_equal(tio.read_ppm(p_img), gray)


def test_metrics_match_jax(rng):
    flow = rng.normal(0, 2, (20, 30, 2))
    gt = rng.normal(0, 2, (20, 30, 2))
    gt[0, :5] = 0.0
    gt[1, :5] = 1e10
    assert tmetrics.flow_error(flow, gt) == jmetrics.flow_error(flow, gt)
    assert (tmetrics.flow_error(flow, gt, border=2)
            == jmetrics.flow_error(flow, gt, border=2))
    a = rng.random((20, 30, 3))
    b = rng.random((20, 30, 3))
    assert tmetrics.warp_error(a, b, flow) == jmetrics.warp_error(a, b, flow)
