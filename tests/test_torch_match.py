"""The coarse matcher of the PyTorch port against the JAX package on the
CPU.  The global match multiplies in float64 here and in float32 there,
so a score within float32 rounding of a half step may round the other
way; the matcher's contract is the repo's cross-program one: >= 98% of
pixels agree, and where they do not, both choices have the same
quantized exact cost (a tie)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from eppm_tpu.config import DEFAULT_CONFIG as JC
from eppm_tpu.ops import cost as jcost
from eppm_tpu.ops import match as jmatch

from eppm_tpu_torch.config import DEFAULT_CONFIG as TC
from eppm_tpu_torch.ops import match as tmatch
from eppm_tpu_torch.ops.census import census_transform
from eppm_tpu_torch.ops.cost import pack_frame

# The suite runs several test processes per host: one torch thread each
# keeps them from oversubscribing the cores.
torch.set_num_threads(1)


def T(a):
    return torch.from_numpy(np.array(a))


def J(a):
    return jnp.asarray(np.asarray(a))


def _textured(rng, h, w):
    small = rng.random((h // 4 + 3, w // 4 + 3, 3)).astype(np.float32)
    big = torch.nn.functional.interpolate(
        torch.from_numpy(small).permute(2, 0, 1)[None], scale_factor=4,
        mode="bicubic", align_corners=False)[0].permute(1, 2, 0).numpy()
    return np.clip(big, 0, 1).astype(np.float32)


def _level_pair(rng, h, w, dx, dy):
    big = _textured(rng, h + 16, w + 16)
    img2 = big[8 : 8 + h, 8 : 8 + w]
    img1 = big[8 + dy : 8 + dy + h, 8 + dx : 8 + dx + w]
    out = []
    for img in (img1, img2):
        t = torch.from_numpy(np.ascontiguousarray(img))
        out.append((img, pack_frame(t, census_transform(t)).numpy()))
    return out


def test_patch_descriptors_exact(rng):
    (_, p1), _ = _level_pair(rng, 30, 40, 2, 1)
    for stride in (1, 2):
        want = jmatch.patch_descriptors(J(p1), JC.match, stride=stride)
        got = tmatch.patch_descriptors(T(p1), TC.match, stride=stride)
        np.testing.assert_array_equal(
            got.to(torch.float32).numpy(),
            np.asarray(want.astype(jnp.float32)))


def test_global_match_bidi_matches_jax(rng):
    (_, p1), (_, p2) = _level_pair(rng, 30, 40, 3, -2)
    d1 = jmatch.patch_descriptors(J(p1), JC.match)
    d2 = jmatch.patch_descriptors(J(p2), JC.match)
    want = jax.jit(lambda a, b: jmatch.global_match_bidi(a, b, 512))(d1, d2)
    got = tmatch.global_match_bidi(
        tmatch.patch_descriptors(T(p1), TC.match),
        tmatch.patch_descriptors(T(p2), TC.match), 512)
    # (t1y, t1x) and (t2y, t2x): block size 512 < 1200 targets exercises
    # the running maximum across blocks
    for g, wnt in zip(got, want):
        assert (g.numpy() == np.asarray(wnt)).mean() >= 0.99


def test_descend_and_propagate_match_jax(rng):
    (_, p1), (_, p2) = _level_pair(rng, 32, 44, 3, -2)
    flow = np.zeros((32, 44, 2), np.float32)
    flow[..., 0] = 1.0
    jf, jc = jax.jit(lambda f, a, b: jmatch.descend_level(
        a, b, f, 3, JC.cost, 25))(J(flow), J(p1), J(p2))
    tf, tc = tmatch.descend_level(T(p1), T(p2), T(flow), 3, TC.cost)
    assert (tf.numpy() == np.asarray(jf)).all(axis=-1).mean() >= 0.99
    jf2, jc2 = jax.jit(lambda f, c, a, b: jmatch.propagate_dense(
        a, b, f, c, (4, 2, 1), JC.cost, 25))(jf, jc, J(p1), J(p2))
    tf2, tc2 = tmatch.propagate_dense(T(p1), T(p2), T(np.asarray(jf)),
                                      T(np.asarray(jc)), (4, 2, 1), TC.cost)
    assert (tf2.numpy() == np.asarray(jf2)).all(axis=-1).mean() >= 0.99


def _exact_cost(p1, p2, tx, ty):
    """One oracle for both programs' choices: the matcher's quantized
    exact-stage cost, from the JAX package."""
    cfg = dataclasses.replace(JC.cost, patch_stride=JC.match.exact_tap_stride)
    offs = cfg.tap_offsets
    stack = jcost.make_patch_stack(J(p2), offs, dtype=jnp.bfloat16)
    c = jcost.patch_cost_stack(J(p1), stack, J(tx)[None], J(ty)[None], cfg,
                               offs)[0]
    return np.asarray(jnp.round(c * 131072.0) * (1.0 / 131072.0))


def test_match_coarse_bidi_matches_jax(rng):
    """48x64 coarse level: one mini-pyramid level below it."""
    h, w = 48, 64
    (i1, p1), (i2, p2) = _level_pair(rng, h, w, 4, -3)
    assert tmatch._mini_levels(h, w, TC.match) == 1
    want = jax.jit(lambda a, b, c, d: jmatch.match_coarse_bidi(
        a, b, JC.cost, JC.match, 25, c, d))(J(i1), J(i2), J(p1), J(p2))
    got = tmatch.match_coarse_bidi(T(i1), T(i2), TC.cost, TC.match,
                                   T(p1), T(p2))
    for (gx, gy, _), (wx, wy, _), (a, b) in zip(got, want,
                                                 [(p1, p2), (p2, p1)]):
        gx, gy = gx.numpy(), gy.numpy()
        wx, wy = np.asarray(wx), np.asarray(wy)
        differ = (gx != wx) | (gy != wy)
        assert differ.mean() <= 0.02, differ.mean()
        if differ.any():
            cg = _exact_cost(a, b, gx, gy)
            cw = _exact_cost(a, b, wx, wy)
            np.testing.assert_array_equal(cg[differ], cw[differ])
