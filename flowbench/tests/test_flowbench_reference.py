"""The reference agrees with the port, bit for bit, on tiny pairs of each
configuration on the CPU: cold, and warm-started from a flow.  (This test
imports the port; the reference itself does not.)"""

import pytest
import torch

from eppm_tpu_torch.config import config_from_dict as port_config
from eppm_tpu_torch.pipeline import compute_flow
from flowbench import generator, reference, spec

CPU = torch.device("cpu")


def pair(seed, h=64, w=96):
    s = {"generator": "pool", "height": h, "width": w, "scenes": [
        {"kind": "layered", "count": 1, "bg_max": 3, "fg": [4, 8],
         "boxes": 2}]}
    _, a, b = generator.make(s, seed, CPU, 1.0).pair(0)
    return torch.from_numpy(a), torch.from_numpy(b)


@pytest.mark.parametrize("config", ["eppm_default", "eppm_patchmatch"])
def test_reference_equals_port(config):
    d = spec.config(config)["config"]
    a, b = pair(11)
    want = compute_flow(a, b, port_config(d))
    got = reference.compute_flow(a, b, reference.config_from_dict(d))
    assert torch.equal(got, want)


def test_reference_equals_port_warm():
    d = spec.config("eppm_default")["config"]
    a, b = pair(12)
    cfg = port_config(d)
    init = compute_flow(a, b, cfg)
    want = compute_flow(a, b, cfg, init_flow=init)
    got = reference.compute_flow(a, b, reference.config_from_dict(d),
                                 init_flow=init)
    assert torch.equal(got, want)
