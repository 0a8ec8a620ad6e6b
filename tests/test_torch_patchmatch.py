"""The PatchMatch engine of the PyTorch port (``eppm_tpu_torch/ops/
patchmatch.py``) against ``eppm_tpu/ops/patchmatch.py`` on the CPU.

torch cannot make JAX's threefry draws, so these tests feed the port
``JaxSampler``: it rebuilds the JAX package's key structure (``split``
into the init and loop keys, ``split(init_key, n)`` for the init fields,
``split(fold_in(loop_key, i), n)`` for iteration i's guesses) and draws
with ``jax.random.randint`` at the bounds the port asks for.  Where the
two programs hold the same incumbent, they then get the same guesses.

The costs are unquantized and a candidate wins on a strict '<', so one
sum an ulp apart (the gathered cost agrees with XLA's to 1e-6,
tests/test_torch_planes.py) can flip an acceptance, and propagation
spreads it.  Pass: targets identical on at least 98% of pixels, costs
within 1e-6 where the targets agree, scales bit-identical where they
agree."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eppm_tpu.config import CostConfig as JCost
from eppm_tpu.config import PatchMatchConfig as JPM
from eppm_tpu.ops import cost as jcost
from eppm_tpu.ops.census import census_transform as j_census

from eppm_tpu_torch.config import CostConfig as TCost
from eppm_tpu_torch.config import PatchMatchConfig as TPM
from eppm_tpu_torch.ops import cost as tcost
from eppm_tpu_torch.ops import patchmatch as tpm

# ``eppm_tpu.ops`` exports the function ``patchmatch`` under the module's
# name
jpm = importlib.import_module("eppm_tpu.ops.patchmatch")

# The suite runs several test processes per host: one torch thread each
# keeps them from oversubscribing the cores.
torch.set_num_threads(1)

PM = dict(num_iters=3, prop_steps=(4, 2, 1))


class JaxSampler:
    """The port's sampler seam, drawing ``eppm_tpu``'s random numbers
    from the keys of its init fields and of its loop (``of`` splits the
    key that a JAX search function takes into the two)."""

    def __init__(self, init_key=None, loop_key=None):
        self.init_key, self.loop_key = init_key, loop_key

    @classmethod
    def of(cls, key):
        return cls(*jax.random.split(key))

    @staticmethod
    def _draw(keys, shape, bounds, device):
        out = []
        for k, (lo, hi) in zip(keys, bounds):
            lo, hi = (np.asarray(b.cpu()) if torch.is_tensor(b) else b
                      for b in (lo, hi))
            r = jax.random.randint(k, shape, lo, hi, dtype=jnp.int32)
            out.append(torch.from_numpy(np.array(r)).to(device))
        return out

    def init(self, shape, bounds, device):
        return self._draw(jax.random.split(self.init_key, len(bounds)),
                          shape, bounds, device)

    def search(self, it, shape, bounds, device):
        keys = jax.random.split(jax.random.fold_in(self.loop_key, it),
                                len(bounds))
        return self._draw(keys, shape, bounds, device)


def textured(rng, h, w):
    """A smooth random RGB texture in [0, 1] (float32)."""
    small = rng.random((h // 4 + 2, w // 4 + 2, 3))
    big = np.kron(small, np.ones((4, 4, 1)))[:h, :w]
    k = np.array([1, 4, 6, 4, 1], np.float64) / 16.0
    for ax in (0, 1):
        big = np.apply_along_axis(lambda v: np.convolve(v, k, "same"), ax,
                                  big)
    return np.clip(big + rng.normal(0, 0.01, big.shape), 0, 1).astype(
        np.float32)


def packs(rng, h, w, sx=2, sy=1):
    """(JAX packs, port packs) of a textured frame and its copy rolled by
    (sx, sy): the true target is the pixel plus (sx, sy)."""
    img2 = textured(rng, h, w)
    img1 = np.roll(img2, (-sy, -sx), axis=(0, 1))
    j = [jcost.pack_frame(jnp.asarray(i), j_census(jnp.asarray(i)))
         for i in (img1, img2)]
    return j, [torch.from_numpy(np.array(p)) for p in j]


def assert_fields(got, want, scale_idx=None):
    """Targets identical on >= 98% of pixels, the cost (last) within
    1e-6 where they agree, scales bit-identical where they agree."""
    got = [g.numpy() for g in got]
    want = [np.asarray(w) for w in want]
    same = (got[0] == want[0]) & (got[1] == want[1])
    assert same.mean() >= 0.98, f"targets agree on only {same.mean():.2%}"
    np.testing.assert_allclose(got[-1][same], want[-1][same], rtol=0,
                               atol=1e-6)
    if scale_idx is not None:
        np.testing.assert_array_equal(
            got[scale_idx][same].view(np.int32),
            want[scale_idx][same].view(np.int32))
    return same.mean()


def test_random_init_bounds():
    """The default sampler: x in [0, w], y in [0, h] inclusive, random,
    the same for the same seed; scales only the 9 of the reference."""
    g = torch.Generator().manual_seed(0)
    tx, ty = tpm.random_init(g, 20, 30)
    assert tx.dtype == torch.int32 and tuple(tx.shape) == (20, 30)
    assert int(tx.min()) == 0 and int(tx.max()) == 30
    assert int(ty.min()) == 0 and int(ty.max()) == 20
    assert float(tx.float().std()) > 1
    tx2, _ = tpm.random_init(torch.Generator().manual_seed(0), 20, 30)
    assert torch.equal(tx, tx2)
    _, _, sc = tpm.random_init_scaled(g, 40, 50)
    want = (10.0 + np.arange(-4, 5, dtype=np.float32)) * np.float32(0.1)
    assert set(sc.unique().tolist()) == set(want.astype(np.float32).tolist())


def test_init_and_scales_match_jax():
    """Through ``JaxSampler`` the init fields are JAX's, and the scales
    are those of JAX's compiled program bit for bit (XLA multiplies by
    the float32 reciprocal of 10)."""
    key = jax.random.PRNGKey(5)
    want = jax.jit(jpm.random_init_scaled, static_argnums=(1, 2))(key, 24,
                                                                   28)
    # random_init(_scaled) takes the init key itself
    got = tpm.random_init_scaled(JaxSampler(init_key=key), 24, 28)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy().view(np.int32),
                                      np.asarray(w).view(np.int32))
    for g, w in zip(tpm.random_init(JaxSampler(init_key=key), 24, 28),
                    jpm.random_init(key, 24, 28)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def _start(rng, h=24, w=28):
    """Packs and a random NNF with its JAX cost, the same on both sides."""
    (j1, j2), (t1, t2) = packs(rng, h, w)
    tx, ty = (np.array(a) for a in jpm.random_init(jax.random.PRNGKey(3),
                                                   h, w))
    cost = np.array(jcost.patch_cost(j1, j2, tx, ty, JCost()))
    return (j1, j2), (t1, t2), tx, ty, cost


def test_propagate_round_matches_jax(rng):
    (j1, j2), (t1, t2), tx, ty, cost = _start(rng)
    for step in (4, 1):
        want = jax.jit(jpm.propagate_round, static_argnums=(5, 6))(
            j1, j2, tx, ty, cost, step, JCost())
        got = tpm.propagate_round(t1, t2, *map(torch.from_numpy,
                                               (tx, ty, cost)), step,
                                  TCost())
        assert_fields(got, want)
        # ties keep the incumbent: the cost never rises
        assert (got[2].numpy() <= cost).all()


def test_random_search_matches_jax(rng):
    (j1, j2), (t1, t2), tx, ty, cost = _start(rng)
    key = jax.random.PRNGKey(9)
    s = JaxSampler(loop_key=key)
    it = 2
    want = jax.jit(jpm.random_search, static_argnums=(6, 7))(
        jax.random.fold_in(key, it), j1, j2, tx, ty, cost, JPM(), JCost())
    got = tpm.random_search(s, it, t1, t2, *map(torch.from_numpy,
                                                (tx, ty, cost)), TPM(),
                            TCost())
    assert_fields(got, want)
    # every accepted guess lies in its window around the incumbent
    mag = TPM().search_range
    moved = got[0].numpy() != tx
    assert (np.abs(got[0].numpy() - tx)[moved] <= mag).all()


@pytest.mark.parametrize("variant", ["patchmatch", "planefitting"])
def test_patchmatch_matches_jax(rng, variant):
    (j1, j2), (t1, t2) = packs(rng, 24, 28)
    key = jax.random.PRNGKey(1234)
    jfn = {"patchmatch": jpm.patchmatch,
           "planefitting": jpm.patchmatch_planefitting}[variant]
    tfn = {"patchmatch": tpm.patchmatch,
           "planefitting": tpm.patchmatch_planefitting}[variant]
    want = jfn(j1, j2, key, JPM(**PM), JCost())
    got = tfn(t1, t2, JaxSampler.of(key), TPM(**PM), TCost())
    assert_fields(got, want)
    # the shift is found in the interior
    u = got[0].numpy()[6:-6, 6:-8] - np.arange(28)[None, 6:-8]
    assert (u == 2).mean() > 0.9


def test_patchmatch_scaled_matches_jax(rng):
    (j1, j2), (t1, t2) = packs(rng, 24, 28)
    key = jax.random.PRNGKey(77)
    want = jpm.patchmatch_scaled(j1, j2, key, JPM(**PM), JCost())
    got = tpm.patchmatch_scaled(t1, t2, JaxSampler.of(key), TPM(**PM),
                                TCost())
    assert_fields(got, want, scale_idx=2)
    sc = got[2].numpy()
    assert sc.min() >= np.float32(0.6) and sc.max() <= np.float32(1.4)


def test_line_propagate_matches_jax(rng):
    """The sequential scan, one column or row a step, at 20x24 (the JAX
    package's own test size, tests/test_extras.py)."""
    (j1, j2), (t1, t2) = packs(rng, 20, 24)
    jc, tc = JCost(patch_radius=3), TCost(patch_radius=3)
    tx, ty = (np.array(a) for a in jpm.random_init(jax.random.PRNGKey(0),
                                                   20, 24))
    cost = np.array(jcost.patch_cost(j1, j2, tx, ty, jc))
    want = jax.jit(jpm.line_propagate, static_argnums=(5,))(
        j1, j2, tx, ty, cost, jc)
    got = tpm.line_propagate(t1, t2, *map(torch.from_numpy, (tx, ty, cost)),
                             tc)
    assert_fields(got, want)
    assert got[2].numpy().mean() < cost.mean()
    # the stored costs are those of the accepted targets
    np.testing.assert_allclose(
        got[2].numpy(), tcost.patch_cost(t1, t2, got[0], got[1], tc).numpy(),
        rtol=0, atol=1e-6)
