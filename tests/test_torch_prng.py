"""JAX's threefry key arithmetic in the PyTorch port (``eppm_tpu_torch/
ops/prng.py``) and the PatchMatch sampler built on it
(``ops/patchmatch.py::ThreefrySampler``), against ``jax.random`` on the
CPU.  Tolerance: none, every key and every draw is ``torch.equal`` to
JAX's."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eppm_tpu_torch.config import DEFAULT_CONFIG as TC
from eppm_tpu_torch.ops import patchmatch as tpm
from eppm_tpu_torch.ops import prng
from test_torch_patchmatch import JaxSampler, packs

# The suite runs several test processes per host: one torch thread each
# keeps them from oversubscribing the cores.
torch.set_num_threads(1)


def T(a):
    return torch.from_numpy(np.array(a).astype(np.int64))


@pytest.mark.parametrize("seed", [0, 1, 1234, 2**31 - 1, -7])
def test_key_split_fold_in_match_jax(seed):
    key = jax.random.PRNGKey(seed)
    tkey = prng.prng_key(seed)
    assert torch.equal(tkey, T(key))
    for n in (1, 2, 3, 7):
        assert torch.equal(prng.split(tkey, n), T(jax.random.split(key, n)))
    for d in (0, 5, 2**31 + 3):
        assert torch.equal(prng.fold_in(tkey, d),
                           T(jax.random.fold_in(key, d)))
    # the sharded path's per-pair keys: fold_in over arange(B)
    want = jax.vmap(jax.random.fold_in, (None, 0))(key, jnp.arange(5))
    assert torch.equal(prng.fold_in(tkey, torch.arange(5)), T(want))
    # stacked keys split each alike
    keys = jax.random.split(key, 3)
    assert torch.equal(prng.split(T(keys), 4),
                       T(jax.vmap(lambda k: jax.random.split(k, 4))(keys)))


@pytest.mark.parametrize("low,high", [
    (0, 64),            # a span that is a power of two
    (0, 161),           # one that is not (x in [0, w] of a 160-wide level)
    (-5, 70_001),       # a span above 2^16: the multiplier wraps in uint32
    (9, 9),             # high <= low gives low
    (-(2**31), 2**31 - 1),
])
def test_randint_scalar_bounds_match_jax(low, high):
    key = jax.random.PRNGKey(1234)
    want = jax.random.randint(key, (13, 17), low, high, dtype=jnp.int32)
    got = prng.randint(prng.prng_key(1234), (13, 17), low, high)
    assert got.dtype == torch.int32
    assert torch.equal(got, torch.from_numpy(np.array(want)))


def test_randint_field_bounds_match_jax(rng):
    """Per-pixel int32 bounds, as the random search draws them: spans of
    every kind (empty, powers of two, above 2^16), and stacked keys."""
    lo = rng.integers(-100, 100, (3, 11, 9)).astype(np.int32)
    hi = (lo + rng.choice([-2, 0, 1, 2, 7, 64, 100, 70_000, 300_001],
                          lo.shape)).astype(np.int32)
    keys = jax.random.split(jax.random.PRNGKey(3), 3)
    want = jnp.stack([jax.random.randint(k, (11, 9), lo[i], hi[i],
                                         dtype=jnp.int32)
                      for i, k in enumerate(keys)])
    got = prng.randint(T(keys), (11, 9), torch.from_numpy(lo),
                       torch.from_numpy(hi))
    assert torch.equal(got, torch.from_numpy(np.array(want)))


class Recorder:
    """A sampler that draws through ``inner`` and records each call."""

    def __init__(self, inner):
        self.inner, self.calls = inner, []

    def init(self, shape, bounds, device):
        out = self.inner.init(shape, bounds, device)
        self.calls.append(("init", None, shape, bounds, out))
        return out

    def search(self, it, shape, bounds, device):
        out = self.inner.search(it, shape, bounds, device)
        self.calls.append(("search", it, shape, bounds, out))
        return out


@pytest.mark.parametrize("search", ["patchmatch", "patchmatch_scaled",
                                    "patchmatch_planefitting"])
def test_threefry_sampler_matches_jax_sampler(rng, search):
    """Every ``init`` and ``search(it)`` call of each search, at the
    bounds that search asks for (per-pixel windows around its incumbents,
    scale draws), gives ``JaxSampler``'s draws bit for bit."""
    _, (p1, p2) = packs(rng, 20, 24)
    pm_cfg = dataclasses.replace(TC.patchmatch, num_iters=2)
    key = jax.random.PRNGKey(11)
    rec = Recorder(JaxSampler.of(key))
    getattr(tpm, search)(p1, p2, rec, pm_cfg, TC.cost)
    assert [c[0] for c in rec.calls] == ["init", "search", "search"]
    sampler = tpm.ThreefrySampler(prng.prng_key(11))
    for kind, it, shape, bounds, want in rec.calls:
        got = (sampler.init(shape, bounds, "cpu") if kind == "init"
               else sampler.search(it, shape, bounds, "cpu"))
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert torch.equal(g, w)
    # iterations past the first block of keys the sampler makes
    _, _, shape, bounds, _ = rec.calls[-1]
    for it in (17, 40):
        for g, w in zip(sampler.search(it, shape, bounds, "cpu"),
                        JaxSampler.of(key).search(it, shape, bounds, "cpu")):
            assert torch.equal(g, w)
