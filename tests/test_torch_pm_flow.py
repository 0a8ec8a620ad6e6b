"""The PatchMatch path of the PyTorch port end to end: ``compute_flow``
with ``match_engine="patchmatch"`` against ``eppm_tpu.pipeline.
compute_flow_jit`` at 96x160 (coarse level 24x40), fed JAX's draws
through ``JaxSampler`` (tests/test_torch_patchmatch.py), one a direction
from ``split(PRNGKey(cfg.seed))`` as ``compute_flow`` splits its key, and
on its default key (``prng_key(cfg.seed)``, JAX's draws made by the
port); then the engine's other sources of draws.  Contract: the repo's
cross-program one (tests/test_torch_pipeline.py::assert_contract)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eppm_tpu.config import DEFAULT_CONFIG as JC
from eppm_tpu.pipeline import compute_flow_jit

from eppm_tpu_torch.config import DEFAULT_CONFIG as TC
from eppm_tpu_torch.ops.prng import prng_key
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


def test_patchmatch_default_key_matches_jax_96x160():
    """With no key, generator or samplers, the port draws from
    ``prng_key(cfg.seed)`` what ``compute_flow_jit(key=None)`` draws from
    ``PRNGKey(cfg.seed)``."""
    f1, f2 = shifted_pair(96, 160, 3, -2, seed=4)
    want = np.asarray(compute_flow_jit(jnp.asarray(f1), jnp.asarray(f2),
                                       None, JPM))
    got = compute_flow(torch.from_numpy(f1), torch.from_numpy(f2), TPM)
    assert_contract(got.numpy(), want)


def test_patchmatch_default_generator():
    """The default key (``prng_key(cfg.seed)`` on the frames' device): the
    shift is recovered in the interior, two runs are identical, the
    explicit key of that seed gives the same flow and another key runs
    too; a ``torch.Generator`` still feeds the engine, the same flow for
    the same seed; two sources of draws at once raise."""
    f1, f2 = (torch.from_numpy(f) for f in shifted_pair(64, 96, 2, 1,
                                                        seed=6))
    model = EPPMFlow(TPM, device="cpu")
    flow = model(f1, f2)
    assert torch.equal(flow, model(f1, f2))
    inner = flow.numpy()[12:-12, 12:-12]
    assert np.abs(inner - [2.0, 1.0]).max(axis=-1).mean() < 0.5
    assert torch.equal(flow, compute_flow(f1, f2, TPM,
                                          key=prng_key(TPM.seed)))
    other = model.init(64, 96).set_data(f1, f2).compute_flow(
        key=prng_key(7))
    assert bool(torch.isfinite(other).all())
    by_gen = [compute_flow(f1, f2, TPM, generator=torch.Generator()
                           .manual_seed(TPM.seed)) for _ in range(2)]
    assert torch.equal(*by_gen)
    inner = by_gen[0].numpy()[12:-12, 12:-12]
    assert np.abs(inner - [2.0, 1.0]).max(axis=-1).mean() < 0.5
    with pytest.raises(ValueError, match="one of"):
        compute_flow(f1, f2, TPM, key=prng_key(0),
                     generator=torch.Generator())
