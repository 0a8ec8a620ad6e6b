"""The whole default slice of the PyTorch port against
``eppm_tpu.pipeline.compute_flow_jit`` at 96x160 (coarse level 24x40: no
mini-pyramid level below it), plus the port's entry points on the CPU.

Contract (the repo's cross-program one, tests/test_sharded.py): at least
98% of pixels agree to 1e-3 and the mean |difference| is below 0.05.  The
frames here are float32 in [0, 1]; tests/test_torch_uint8*.py hold uint8
frames to the same contract."""

import dataclasses
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eppm_tpu.pipeline import compute_flow_jit

from eppm_tpu_torch import cli
from eppm_tpu_torch.config import DEFAULT_CONFIG
from eppm_tpu_torch.io import read_flo, write_ppm
from eppm_tpu_torch.pipeline import EPPMFlow, compute_flow

# The suite runs several test processes per host: one torch thread each
# keeps them from oversubscribing the cores.
torch.set_num_threads(1)


def shifted_pair(h, w, dx, dy, seed, uint8=False):
    """float32 frames (uint8 with ``uint8``) with frame1(p) = frame2(p +
    (dx, dy)), from a smooth seeded texture quantized to 8 bits."""
    rng = np.random.default_rng(seed)
    m = 8
    small = rng.random((3, (h + 2 * m) // 8 + 2, (w + 2 * m) // 8 + 2))
    big = torch.nn.functional.interpolate(
        torch.from_numpy(small.astype(np.float32))[None], scale_factor=8,
        mode="bicubic", align_corners=False)[0].permute(1, 2, 0).numpy()
    big = (np.clip(big, 0, 1) * 255).astype(np.uint8)
    f2 = big[m : m + h, m : m + w]
    f1 = big[m + dy : m + dy + h, m + dx : m + dx + w]
    if uint8:
        return [np.ascontiguousarray(f) for f in (f1, f2)]
    return [np.ascontiguousarray(f).astype(np.float32) / np.float32(255)
            for f in (f1, f2)]


def assert_contract(got, want):
    d = np.abs(got - want).max(axis=-1)
    agree = (d < 1e-3).mean()
    assert agree >= 0.98, f"only {agree:.2%} of pixels agree"
    assert d.mean() < 0.05, f"mean |delta| {d.mean():.4f}"


def test_compute_flow_matches_jax_96x160():
    f1, f2 = shifted_pair(96, 160, 3, -2, seed=0)
    want = np.asarray(compute_flow_jit(jnp.asarray(f1), jnp.asarray(f2)))
    got = compute_flow(torch.from_numpy(f1), torch.from_numpy(f2))
    assert got.dtype == torch.float32 and tuple(got.shape) == (96, 160, 2)
    assert_contract(got.numpy(), want)
    # the translation is recovered away from the borders
    inner = got.numpy()[16:-16, 16:-16]
    assert np.abs(inner - [3.0, -2.0]).max(axis=-1).mean() < 0.5


def test_eppmflow_object_api():
    f1, f2 = shifted_pair(48, 64, 2, 1, seed=1)
    a, b = torch.from_numpy(f1), torch.from_numpy(f2)
    model = EPPMFlow(device="cpu")
    flow = model.init(48, 64).set_data(a, b).compute_flow()
    assert flow.device.type == "cpu"
    np.testing.assert_array_equal(flow.numpy(), model(a, b).numpy())
    np.testing.assert_array_equal(flow.numpy(), compute_flow(a, b).numpy())
    with pytest.raises(ValueError):
        model.set_data(a[:24], b[:24])
    with pytest.raises(RuntimeError):
        EPPMFlow(device="cpu").compute_flow()


def test_eppmflow_runs_on_the_card_by_default(monkeypatch):
    """``EPPMFlow()`` takes the CUDA device; without one it raises rather
    than run the plain versions on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        EPPMFlow()
    with pytest.raises(RuntimeError, match="CUDA"):
        EPPMFlow(device="cuda:0")
    assert EPPMFlow(device="cpu").device == torch.device("cpu")


@pytest.mark.parametrize("change", [
    dict(match_engine="patchmatch"),
    dict(dense_subpixel_fit=True),
    dict(refine=dataclasses.replace(DEFAULT_CONFIG.refine,
                                    wmf_fill_first=False)),
    dict(subpixel_refine=True),
])
def test_settings_off_the_slice_raise(change):
    """Every setting off the default slice runs, the PatchMatch engine
    included (it raised until it was ported): a finite flow of the
    frames' shape, the same through ``compute_flow`` and ``EPPMFlow``.
    Their agreement with the JAX package: tests/test_torch_pm_flow.py,
    tests/test_torch_warm*.py, _legacy_wmf.py, _subpixel*.py."""
    cfg = dataclasses.replace(DEFAULT_CONFIG, **change)
    img = torch.zeros((32, 48, 3))
    flow = EPPMFlow(cfg, device="cpu")(img, img)
    assert tuple(flow.shape) == (32, 48, 2) and bool(torch.isfinite(flow).all())
    np.testing.assert_array_equal(flow.numpy(),
                                  compute_flow(img, img, cfg).numpy())


def test_temporal_init_and_fine_wmf_raise():
    """``init_flow`` and ``fine_level_wmf`` are ported: both run (their
    agreement with the JAX package: tests/test_torch_warm*.py and
    tests/test_torch_fine_wmf_flow.py); a warm start on another device
    than the frames raises."""
    img = torch.zeros((32, 48, 3))
    init = torch.full((32, 48, 2), 1e10)
    for kw in (dict(init_flow=init), dict(fine_level_wmf=True)):
        flow = compute_flow(img, img, **kw)
        assert tuple(flow.shape) == (32, 48, 2)
        assert bool(torch.isfinite(flow).all())
    with pytest.raises(ValueError, match="init_flow"):
        compute_flow(img, img, init_flow=init.to(torch.device("meta")))


def test_cli_cpu(tmp_path, capsys):
    f1, f2 = shifted_pair(48, 64, 2, -1, seed=2)
    paths = []
    for i, f in enumerate((f1, f2)):
        p = str(tmp_path / f"f{i}.ppm")
        write_ppm(p, np.round(f * 255).astype(np.uint8))
        paths.append(p)
    out = str(tmp_path / "flow.flo")
    assert cli.main([*paths, "-o", out, "--device", "cpu", "--time",
                     "--set", "refine.blf_sigma_spatial=3.0"]) == 0
    report = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert report["shape"] == [48, 64, 2] and report["device"] == "cpu"
    assert report["seconds"] > 0
    flow = read_flo(out)
    assert flow.shape == (48, 64, 2) and np.isfinite(flow).all()
    with pytest.raises(SystemExit):
        cli.main([*paths, "--device", "cpu", "--set", "no_such=1"])
