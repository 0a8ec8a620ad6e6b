"""The PatchMatch path of the PyTorch port end to end: ``compute_flow``
with ``match_engine="patchmatch"`` against ``eppm_tpu.pipeline.
compute_flow_jit`` at 96x160 (coarse level 24x40), and the engine on its
default ``torch.Generator``.

The port is fed JAX's draws through ``JaxSampler`` (tests/
test_torch_patchmatch.py), one a direction from ``split(PRNGKey(cfg.
seed))`` as ``compute_flow`` splits its key.  Contract: the repo's
cross-program one (tests/test_torch_pipeline.py::assert_contract)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from eppm_tpu.config import DEFAULT_CONFIG as JC
from eppm_tpu.pipeline import compute_flow_jit

from eppm_tpu_torch.config import DEFAULT_CONFIG as TC
from eppm_tpu_torch.pipeline import EPPMFlow, compute_flow
from test_torch_patchmatch import JaxSampler
from test_torch_pipeline import assert_contract, shifted_pair

# The suite runs several test processes per host: one torch thread each
# keeps them from oversubscribing the cores.
torch.set_num_threads(1)

JPM = dataclasses.replace(JC, match_engine="patchmatch")
TPM = dataclasses.replace(TC, match_engine="patchmatch")


def test_patchmatch_flow_matches_jax_96x160():
    f1, f2 = shifted_pair(96, 160, 3, -2, seed=4)
    key = jax.random.PRNGKey(JPM.seed)
    want = np.asarray(compute_flow_jit(jnp.asarray(f1), jnp.asarray(f2),
                                       key, JPM))
    samplers = tuple(JaxSampler.of(k) for k in jax.random.split(key))
    # init_flow is ignored by this engine, as in the JAX package
    got = compute_flow(torch.from_numpy(f1), torch.from_numpy(f2), TPM,
                       init_flow=torch.full((96, 160, 2), 1e10),
                       samplers=samplers)
    assert got.dtype == torch.float32 and tuple(got.shape) == (96, 160, 2)
    assert_contract(got.numpy(), want)


def test_patchmatch_default_generator():
    """The default generator (``cfg.seed`` on the frames' device): the
    shift is recovered in the interior, two runs are identical, an
    explicit generator with the same seed gives the same flow and another
    seed runs too."""
    f1, f2 = (torch.from_numpy(f) for f in shifted_pair(64, 96, 2, 1,
                                                        seed=6))
    model = EPPMFlow(TPM, device="cpu")
    flow = model(f1, f2)
    assert torch.equal(flow, model(f1, f2))
    inner = flow.numpy()[12:-12, 12:-12]
    assert np.abs(inner - [2.0, 1.0]).max(axis=-1).mean() < 0.5
    g = torch.Generator().manual_seed(TPM.seed)
    assert torch.equal(flow, compute_flow(f1, f2, TPM, generator=g))
    other = model.init(64, 96).set_data(f1, f2).compute_flow(
        generator=torch.Generator().manual_seed(7))
    assert bool(torch.isfinite(other).all())
