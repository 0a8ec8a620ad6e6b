"""The port's multi-device path on shapes that do not tile, and warm
started: ``compute_flow_sharded`` pads to ``pad_to_tileable``, crops the
flow back and holds the repo's cross-program contract against
``eppm_tpu.parallel.compute_flow_sharded`` at 62x94 on a (1, 2, 2) CPU
mesh (tests/test_sharded.py::test_sharded_pad_to_tileable's case); a
temporal warm start (``init_flows``) against the port's single-device
chain.  Contract: >= 98% of pixels within 1e-3, mean |delta| < 0.05; the
chained pair against the single-device chain at tests/test_sharded.py::
test_sharded_temporal_streaming_chain's gate, > 95% within 1e-3 and mean
|delta| < 0.1 (the sharded program's pass-2 median reads an edge-filled
halo, so each pair's border pixels may differ, and the second pair starts
from the first's)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eppm_tpu.parallel import compute_flow_sharded as j_sharded
from eppm_tpu.parallel import make_mesh as j_mesh

from eppm_tpu_torch.parallel import (check_tileable, compute_flow_sharded,
                                     pad_to_tileable)
from eppm_tpu_torch.pipeline import compute_flow
from test_torch_pipeline import assert_contract, shifted_pair
from test_torch_sharded import configs, cpu_mesh

# The suite runs several test processes per host: one torch thread each
# keeps them from oversubscribing the cores.
torch.set_num_threads(1)


def test_sharded_pad_and_crop_matches_jax():
    jc, tc = configs()
    h, w = 62, 94
    f1, f2 = shifted_pair(h, w, 3, -2, seed=4)
    with pytest.raises(ValueError):
        check_tileable(h, w, tc, 2, 2)
    assert pad_to_tileable(h, w, tc, 2, 2) == (64, 96)
    want = np.asarray(j_sharded(jnp.asarray(f1)[None], jnp.asarray(f2)[None],
                                j_mesh(1, 2, 2), jc))[0]
    a, b = torch.from_numpy(f1)[None], torch.from_numpy(f2)[None]
    got = compute_flow_sharded(a, b, cpu_mesh(1, 2, 2), tc)
    assert tuple(got.shape) == (1, h, w, 2)
    assert_contract(got[0].numpy(), want)
    # strict mode refuses the shape
    with pytest.raises(ValueError):
        compute_flow_sharded(a, b, cpu_mesh(1, 2, 2), tc, pad_to_fit=False)


def test_sharded_warm_start_matches_single_device():
    """``init_flows`` through the (1, 2, 2) mesh: the second pair of a
    stream warm-started from the first pair's sharded flow, against the
    single-device chain; the coarse level sees the same init on every
    device."""
    _, tc = configs()
    f0, f1 = shifted_pair(64, 96, 3, -2, seed=7)
    f2 = np.roll(f1, (-2, 1), axis=(0, 1))
    fr = [torch.from_numpy(np.ascontiguousarray(f)) for f in (f0, f1, f2)]
    mesh = cpu_mesh(1, 2, 2)
    t01 = compute_flow_sharded(fr[0][None], fr[1][None], mesh, tc)
    t12 = compute_flow_sharded(fr[1][None], fr[2][None], mesh, tc,
                               init_flows=t01)
    s01 = compute_flow(fr[0], fr[1], tc)
    s12 = compute_flow(fr[1], fr[2], tc, init_flow=s01)
    d = (t12[0] - s12).abs().max(-1).values
    assert float((d < 1e-3).float().mean()) > 0.95
    assert float(d.mean()) < 0.1
    # the warm start is used: it changes the flow of the second pair
    assert not torch.equal(t12, compute_flow_sharded(fr[1][None],
                                                     fr[2][None], mesh, tc))
    with pytest.raises(ValueError, match="not divisible"):
        compute_flow_sharded(fr[0][None], fr[1][None],
                             cpu_mesh(2, 1, 1), tc)
