"""The port's multi-device path over the batch axis and through the
command line: two pairs on a (2, 1, 1) CPU mesh under the PatchMatch
engine with the default per-pair keys (``fold_in(prng_key(seed), b)``)
against ``eppm_tpu.parallel.compute_flow_sharded`` on the same mesh (the
repo's contract, >= 98% of pixels within 1e-3, mean |delta| < 0.05), and
``cli --mesh`` on the CPU equal to ``compute_flow_sharded``
(identical)."""

import contextlib
import io
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eppm_tpu.parallel import compute_flow_sharded as j_sharded
from eppm_tpu.parallel import make_mesh as j_mesh

from eppm_tpu_torch import cli
from eppm_tpu_torch.config import DEFAULT_CONFIG as TC
from eppm_tpu_torch.io import read_flo, write_ppm
from eppm_tpu_torch.ops.prng import fold_in, prng_key
from eppm_tpu_torch.parallel import compute_flow_sharded
from eppm_tpu_torch.pipeline import compute_flow
from test_torch_pipeline import assert_contract, shifted_pair
from test_torch_sharded import configs, cpu_mesh

# The suite runs several test processes per host: one torch thread each
# keeps them from oversubscribing the cores.
torch.set_num_threads(1)


def test_sharded_batch_default_keys_matches_jax():
    jc, tc = configs(match_engine="patchmatch")
    pairs = [shifted_pair(48, 64, 2 + i, -1, seed=8 + i) for i in range(2)]
    imgs1, imgs2 = (np.stack([p[k] for p in pairs]) for k in (0, 1))
    want = np.asarray(j_sharded(jnp.asarray(imgs1), jnp.asarray(imgs2),
                                j_mesh(2, 1, 1), jc))
    got = compute_flow_sharded(torch.from_numpy(imgs1),
                               torch.from_numpy(imgs2), cpu_mesh(2, 1, 1), tc)
    assert tuple(got.shape) == (2, 48, 64, 2)
    for b in range(2):
        assert_contract(got[b].numpy(), want[b])
    # pair b draws from fold_in(prng_key(seed), b): against the
    # single-device path given that key, at tests/test_sharded.py::
    # test_sharded_batch_parallel's gate (> 90% within 1e-3, mean |delta|
    # < 0.3: a one-tile mesh still takes pass 2's median over an
    # edge-filled halo, as the JAX package's sharded program does, so
    # border pixels may differ)
    key1 = fold_in(prng_key(tc.seed), 1)
    single = compute_flow(torch.from_numpy(imgs1[1]),
                          torch.from_numpy(imgs2[1]), tc, key=key1)
    d = (got[1] - single).abs().max(-1).values
    assert float((d < 1e-3).float().mean()) > 0.9
    assert float(d.mean()) < 0.3


def _cli(args):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert cli.main(args) == 0
    return json.loads(buf.getvalue().strip().splitlines()[-1])


def test_cli_mesh_on_the_cpu(tmp_path):
    """``--mesh 1,2,2 --device cpu`` writes the flow of
    ``compute_flow_sharded`` on that mesh, for a pair and for a stream;
    a batch axis other than 1 and a malformed mesh exit with a message."""
    f1, f2 = shifted_pair(64, 96, 3, -2, seed=4, uint8=True)
    write_ppm(str(tmp_path / "a.ppm"), f1)
    write_ppm(str(tmp_path / "b.ppm"), f2)
    out = tmp_path / "flow.flo"
    rep = _cli([str(tmp_path / "a.ppm"), str(tmp_path / "b.ppm"), "-o",
                str(out), "--mesh", "1,2,2", "--device", "cpu"])
    assert rep["shape"] == [64, 96, 2] and rep["device"] == "cpu"
    want = compute_flow_sharded(torch.from_numpy(f1)[None],
                                torch.from_numpy(f2)[None],
                                cpu_mesh(1, 2, 2), TC)[0]
    np.testing.assert_array_equal(read_flo(str(out)), want.numpy())
    frames = tmp_path / "frames"
    frames.mkdir()
    write_ppm(str(frames / "0.ppm"), f1)
    write_ppm(str(frames / "1.ppm"), f2)
    rep = _cli(["--frames-dir", str(frames), "--out-dir",
                str(tmp_path / "out"), "--exact-readback", "--mesh", "1,2,1",
                "--device", "cpu"])
    assert rep["pairs"] == 1
    np.testing.assert_array_equal(read_flo(str(tmp_path / "out" / "0.flo")),
                                  want.numpy())
    for bad in ("2,1,1", "1,2"):
        with pytest.raises(SystemExit, match="--mesh"):
            cli.main([str(tmp_path / "a.ppm"), str(tmp_path / "b.ppm"),
                      "--mesh", bad, "--device", "cpu"])
