"""The PyTorch port's utility ops and frame I/O against ``eppm_tpu`` —
colour conversions, the flow colour coding, warping by a flow, the
median and guide-image filters, the still-region suppressor, the PNG
codec — and its entry points on the CPU: the command line's stream and
``--viz`` modes and ``EPPMFlow.compute_flow(init_flow=...)``."""

import json
import os

import jax
import numpy as np
import pytest
import torch

from eppm_tpu.config import DEFAULT_CONFIG as JD
from eppm_tpu.io import png as jpng
from eppm_tpu.ops import color as jcolor
from eppm_tpu.ops import cost as jcost
from eppm_tpu.ops import refine as jrefine
from eppm_tpu.ops import warp as jwarp

from eppm_tpu_torch import cli, io
from eppm_tpu_torch.config import DEFAULT_CONFIG as TD
from eppm_tpu_torch.ops import color, cost, refine, warp
from eppm_tpu_torch import pipeline as tpipe
from test_torch_pipeline import shifted_pair
from test_torch_warm import configs, stream_pairs

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def rgb255():
    """uint8-range RGB values as float32, with the extremes."""
    img = np.random.default_rng(20).integers(0, 256, (40, 56, 3))
    img[0, :4] = [[0, 0, 0], [255, 255, 255], [255, 0, 0], [0, 0, 255]]
    return img.astype(np.float32)


@pytest.mark.parametrize("name", ["rgb2yuv", "yuv2rgb", "rgb2luv"])
def test_color_conversions_match_jax(rgb255, name):
    want = np.asarray(jax.jit(getattr(jcolor, name))(rgb255))
    got = getattr(color, name)(torch.from_numpy(rgb255)).numpy()
    assert np.abs(got - want).max() <= 1e-5


def test_flow_to_color_matches_jax():
    """uint8 colours; +-1 allowed (a float32 colour that lands within
    rounding of an integer may truncate to either neighbour)."""
    rng = np.random.default_rng(21)
    flow = rng.normal(0, 6, (40, 56, 2)).astype(np.float32)
    flow[5:9, 10:20] = 1e10
    for max_rad in (None, 20.0):
        want = np.asarray(jax.jit(
            lambda f: jcolor.flow_to_color(f, max_rad))(flow))
        got = color.flow_to_color(torch.from_numpy(flow), max_rad)
        assert got.dtype == torch.uint8
        assert np.abs(got.numpy().astype(int) - want).max() <= 1
    np.testing.assert_array_equal(color.make_color_wheel(),
                                  jcolor.make_color_wheel())
    assert color.luminance is not None and color.luminance.__module__.endswith(
        "census")


def test_warp_image_by_flow_matches_jax():
    rng = np.random.default_rng(22)
    img = rng.random((40, 56, 3)).astype(np.float32)
    flow = rng.normal(0, 5, (40, 56, 2)).astype(np.float32)
    flow[3:5, 3:9] = 1e10
    flow[7, 7:12, 0] = -3.7e9
    want = np.asarray(jax.jit(jwarp.warp_image_by_flow)(img, flow))
    got = warp.warp_image_by_flow(torch.from_numpy(img),
                                  torch.from_numpy(flow)).numpy()
    assert np.abs(got - want).max() <= 1e-5
    gray = warp.warp_image_by_flow(torch.from_numpy(img[..., 0]),
                                   torch.from_numpy(flow))
    assert tuple(gray.shape) == (40, 56)


def test_median_and_guide_filters_match_jax():
    img = shifted_pair(40, 56, 0, 0, seed=23)[0]
    img = img + np.random.default_rng(23).normal(0, 0.02, img.shape).astype(
        np.float32)
    t = torch.from_numpy(img)
    np.testing.assert_array_equal(
        refine.median_filter(t).numpy(),
        np.asarray(jax.jit(jrefine.median_filter)(img)))
    want = np.asarray(jax.jit(
        lambda x: jrefine.guide_image_smoothing(x, JD.refine))(img))
    got = refine.guide_image_smoothing(t, TD.refine).numpy()
    assert np.abs(got - want).max() <= 1e-5
    np.testing.assert_array_equal(
        refine.flow_cutoff(t * 400 - 200, 20.0).numpy(),
        np.clip(img * 400 - 200, -20.0, 20.0))


def test_eliminate_still_region_matches_jax():
    f1, f2 = shifted_pair(40, 56, 0, 0, seed=24)
    f2 = f2.copy()
    f2[:, 28:] = shifted_pair(40, 56, 4, 1, seed=24)[0][:, 28:]
    flow = np.random.default_rng(24).normal(0, 2, (40, 56, 2)).astype(
        np.float32)
    ys, xs = np.mgrid[0:40, 0:56].astype(np.int32)
    want_cost = np.asarray(jax.jit(lambda a, b, x, y: jcost.patch_cost_ad_l2(
        a, b, x, y, JD.cost))(f1, f2, xs, ys))
    got_cost = cost.patch_cost_ad_l2(*(torch.from_numpy(a) for a in
                                       (f1, f2, xs, ys)), TD.cost).numpy()
    assert np.abs(got_cost - want_cost).max() <= 1e-5
    want = np.asarray(jax.jit(lambda f, a, b: jrefine.eliminate_still_region(
        f, a, b, JD.cost))(flow, f1, f2))
    got = refine.eliminate_still_region(
        *(torch.from_numpy(a) for a in (flow, f1, f2)), TD.cost).numpy()
    assert np.abs(got - want).max() <= 1e-5
    assert (got == 0).any() and (got != 0).any()


@pytest.mark.parametrize("shape,dtype", [((9, 13), np.uint8),
                                         ((9, 13, 3), np.uint8),
                                         ((9, 13, 4), np.uint16)])
def test_png_codec_reads_what_the_jax_package_writes(tmp_path, shape, dtype):
    img = np.random.default_rng(25).integers(
        0, np.iinfo(dtype).max + 1, shape).astype(dtype)
    a, b = str(tmp_path / "a.png"), str(tmp_path / "b.png")
    jpng.write_png(a, img)
    io.write_png(b, img)
    np.testing.assert_array_equal(io.read_png(a), img)
    np.testing.assert_array_equal(jpng.read_png(b), img)
    frame = io.read_image(a)
    assert frame.shape == (9, 13, 3) and frame.dtype == np.uint8


def test_png_filters_are_undone():
    """Every scanline filter type (a writer picks them per row)."""
    rng = np.random.default_rng(26)
    h, w, bpp = 5, 6, 3
    rows = rng.integers(0, 256, (h, w * bpp)).astype(np.int32)
    raw, prev = b"", np.zeros(w * bpp, np.int32)
    for y, ftype in enumerate([0, 1, 2, 3, 4]):
        cur = rows[y]
        left = np.concatenate([np.zeros(bpp, np.int32), cur[:-bpp]])
        upleft = np.concatenate([np.zeros(bpp, np.int32), prev[:-bpp]])
        if ftype == 0:
            pred = 0
        elif ftype == 1:
            pred = left
        elif ftype == 2:
            pred = prev
        elif ftype == 3:
            pred = (left + prev) >> 1
        else:
            p = left + prev - upleft
            pa, pb, pc = np.abs(p - left), np.abs(p - prev), np.abs(p - upleft)
            pred = np.where((pa <= pb) & (pa <= pc), left,
                            np.where(pb <= pc, prev, upleft))
        raw += bytes([ftype]) + ((cur - pred) & 0xFF).astype(np.uint8).tobytes()
        prev = cur
    np.testing.assert_array_equal(io._png_unfilter(raw, h, w, bpp), rows)


def _frames(tmp_path, ext, n=4, h=48, w=64):
    """``n`` frames of a constant motion (2, -1), written as ``ext``."""
    big = (shifted_pair(h + 16, w + 16, 0, 0, seed=27)[0] * 255).astype(
        np.uint8)
    d = tmp_path / f"frames_{ext}"
    d.mkdir()
    for k in range(n):
        f = np.ascontiguousarray(big[8 + k : 8 + k + h, 8 - 2 * k + 8 :
                                     8 - 2 * k + 8 + w])
        path = str(d / f"frame{k:02d}.{ext}")
        (io.write_png if ext == "png" else io.write_ppm)(path, f)
    return str(d)


@pytest.mark.parametrize("ext", ["ppm", "png"])
def test_stream_cli_on_cpu(tmp_path, capsys, ext):
    frames = _frames(tmp_path, ext)
    out_q, out_x = str(tmp_path / "q16"), str(tmp_path / "exact")
    assert cli.main(["--frames-dir", frames, "--out-dir", out_q, "--temporal",
                     "--device", "cpu"]) == 0
    report = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(report) == {"frames", "pairs", "fps", "out_dir", "device"}
    assert (report["frames"], report["pairs"]) == (4, 3)
    assert report["device"] == "cpu" and report["fps"] > 0
    names = [f"frame{k:02d}.flo" for k in range(3)]
    assert sorted(os.listdir(out_q)) == names
    assert cli.main(["--frames-dir", frames, "--out-dir", out_x, "--temporal",
                     "--exact-readback", "--device", "cpu"]) == 0
    capsys.readouterr()
    for name in names:
        q, x = io.read_flo(os.path.join(out_q, name)), io.read_flo(
            os.path.join(out_x, name))
        assert np.abs(q - np.clip(x, -512, 32767 / 64)).max() <= 1 / 128
        inner = x[12:-12, 12:-12]
        assert np.abs(inner - [2.0, -1.0]).max(axis=-1).mean() < 0.5


def test_stream_cli_needs_two_frames(tmp_path):
    (tmp_path / "only.ppm").write_bytes(b"")
    with pytest.raises(SystemExit):
        cli.main(["--frames-dir", str(tmp_path), "--device", "cpu"])


@pytest.mark.parametrize("ext", ["ppm", "png"])
def test_viz_cli_on_cpu(tmp_path, capsys, ext):
    frames = _frames(tmp_path, "ppm", n=2)
    viz = str(tmp_path / f"flow.{ext}")
    assert cli.main([os.path.join(frames, "frame00.ppm"),
                     os.path.join(frames, "frame01.ppm"), "--viz", viz,
                     "--device", "cpu"]) == 0
    capsys.readouterr()
    rgb = io.read_image(viz)
    assert rgb.shape == (48, 64, 3) and rgb.dtype == np.uint8
    assert rgb.std() > 0


def test_eppmflow_warm_start_on_cpu():
    """``EPPMFlow.compute_flow(init_flow=...)`` moves the init to the
    model's device and equals ``compute_flow`` with it."""
    f2, f3, init = stream_pairs()
    _, tc = configs()
    a, b, i = (torch.from_numpy(x) for x in (f2, f3, init))
    model = tpipe.EPPMFlow(tc, device="cpu").set_data(a, b)
    got = model.compute_flow(init_flow=i)
    np.testing.assert_array_equal(
        got.numpy(), tpipe.compute_flow(a, b, tc, init_flow=i).numpy())
