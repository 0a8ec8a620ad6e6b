"""Regression tests for the faults the eval-set parity run
(``tools/torch_eval_parity.py``) found in the port, each on the content
of the case that showed it, cut to the smallest size that still shows it.

``holdout/stripes_large_disp`` (oriented stripes, 436x1024): the census
luminance.  XLA's CPU backend fuses the JAX package's
``0.3R + 0.6G + 0.1B`` into fma(B, 0.1, fma(R, 0.3, 0.6G)); the port
summed the three products unfused.  On stripes, neighbouring pixels'
luminances tie up to the last bit, so the two roundings set different
census bits (0.12% of a 218x512 level), and through them the coarse
match and the flow moved (96.62% of pixels within 1e-3).

The same case: the coarse matcher's exact-cost stage
(``ops/cost.py::patch_cost_stack``, also the photometric arbitration's
cost).  The JAX form adds its taps in an unrolled loop, whose
multiply-adds XLA fuses (dr1^2 + dr2^2 and cost_sum + w * term); the
port rounded each product, so its quantized costs differed from the JAX
package's on 0.67% of a 109x256 level's entries and moved match targets
at ties."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import eppm_tpu.pipeline as jpipe
from eppm_tpu.config import DEFAULT_CONFIG as JC
from eppm_tpu.ops import census as jcensus
from eppm_tpu.ops import cost as jcost

import eppm_tpu_torch.pipeline as tpipe
from eppm_tpu_torch import evalset
from eppm_tpu_torch.config import DEFAULT_CONFIG as TC
from eppm_tpu_torch.ops import census as tcensus
from eppm_tpu_torch.ops import cost as tcost
from eppm_tpu_torch.ops._util import pad_edge
from test_torch_cost import sequential_cost

# The suite runs several test processes per host: one torch thread each
# keeps them from oversubscribing the cores.
torch.set_num_threads(1)


def unfused_census(img):
    """The census of the unfused luminance sum: what the port computed
    before the repair."""
    f = np.float32
    lum = (f(0.3) * img[..., 0] + f(0.6) * img[..., 1]) + f(0.1) * img[..., 2]
    h, w = lum.shape
    pad = np.pad(lum, 1, mode="edge")
    out = np.zeros((h, w), np.int32)
    for bit, (dx, dy) in enumerate(jcensus.NEIGHBOR_OFFSETS):
        out |= (pad[1 + dy : 1 + dy + h, 1 + dx : 1 + dx + w] > lum) << bit
    return out


def stripes_large_disp_frame10():
    """Frame 10 of ``holdout/stripes_large_disp`` as its PPM holds it."""
    rng = np.random.default_rng(evalset.HOLDOUT_SEED)
    evalset.cartoon(rng, 480, 640)  # the two cases drawn before it
    evalset.cartoon(rng, 480, 640)
    img2 = evalset.stripes(rng, 436, 1024)
    img1 = evalset.warp(img2, evalset.const_flow(436, 1024, -95.0, 18.0))
    return (img1 * 255 + 0.5).astype(np.uint8)


# crops (top, left, height, width) of the case's frame 10 whose 2x
# pyramid level holds luminance ties that the unfused sum breaks
CROPS = [(0, 40, 64, 96), (0, 0, 96, 128)]


@pytest.fixture(scope="module")
def frame10():
    return stripes_large_disp_frame10()


def _prepared(frame10, crop):
    y, x, h, w = crop
    img = frame10[y : y + h, x : x + w]
    jlv, jpk = jpipe._prep_stage(jnp.asarray(img), JC)
    return img, [np.array(a) for a in jlv], [np.array(a) for a in jpk]


@pytest.mark.parametrize("crop", CROPS)
def test_census_luminance_fused_as_xla(frame10, crop):
    """On the crop's pyramid level 1, the port's luminance equals the
    JAX package's jitted one bit for bit and its census the JAX
    package's; the unfused sum's census would not (the content shows
    the fault)."""
    _, levels, packs = _prepared(frame10, crop)
    level = levels[1]
    lum = np.asarray(jax.jit(
        lambda x: 0.3 * x[..., 0] + 0.6 * x[..., 1] + 0.1 * x[..., 2])(
            jnp.asarray(level)))
    np.testing.assert_array_equal(
        tcensus.luminance(torch.from_numpy(level)).numpy(), lum)
    got = tcensus.census_transform(torch.from_numpy(level)).numpy()
    np.testing.assert_array_equal(got, packs[1][..., 3])
    assert (unfused_census(level) != packs[1][..., 3]).any()


@pytest.mark.parametrize("crop", CROPS)
def test_prepare_stripes_large_disp_crop(frame10, crop):
    """The crop (uint8, as the PPM holds it) through ``prepare_pyramids``:
    every level and pack (RGB and census) equals the JAX package's
    staged prepare program."""
    img, levels, packs = _prepared(frame10, crop)
    tlv, tpk = tpipe.prepare_pyramids(torch.from_numpy(img), TC)
    assert len(tpk) == len(packs)
    for j_level, j_pack, t_level, t_pack in zip(levels, packs, tlv, tpk):
        np.testing.assert_array_equal(t_level.numpy(), j_level)
        np.testing.assert_array_equal(t_pack.numpy(), j_pack)


def unfused_stack_cost(pack1, stack2, txs, tys, cfg, offs):
    """The exact-stage cost with every product rounded: what the port
    computed before the repair."""
    K, H, W = txs.shape
    H2, W2 = stack2.shape[0], stack2.shape[1]
    T, R = len(offs), cfg.patch_radius
    pad1 = pad_edge(pack1, R, R)
    idx = (tys.clamp(0, H2 - 1) * W2 + txs.clamp(0, W2 - 1)).reshape(-1)
    taps2 = stack2.reshape(H2 * W2, -1)[idx.long()].reshape(
        K, H, W, T + 1, 4).to(torch.float32)
    taps1 = list(cfg.tap_offsets)[:T]
    pairs = ((pad1[R + i : R + i + H, R + j : R + j + W], taps2[..., t, :])
             for t, (i, j) in enumerate(taps1))
    gws = [tcost.tap_weight(i, j, cfg.sigma_spatial) for (i, j) in taps1]
    return sequential_cost(pairs, pack1[..., :3], taps2[..., T, :3], gws,
                           cfg, len(gws))


@pytest.mark.parametrize("crop", [(0, 0, 96, 128), (0, 40, 64, 96)])
def test_exact_stage_cost_fused_as_xla(frame10, crop):
    """The exact stage's quantized cost of three target fields (each
    pixel's own position moved by up to 3 px, from a seed) on the coarse
    level of a crop of the case's frame 10 equals the JAX package's
    jitted ``patch_cost_stack`` on the same bfloat16 tap stack; the
    unfused sums' would not."""
    y, x, h, w = crop
    img = torch.from_numpy(frame10[y : y + h, x : x + w].copy())
    pack = tpipe.prepare_pyramids(img, TC)[1][-1]
    H, W = pack.shape[:2]
    rng = np.random.default_rng(0)
    ys, xs = np.mgrid[0:H, 0:W]
    tx = (xs[None] + rng.integers(-3, 4, (3, H, W))).astype(np.int32)
    ty = (ys[None] + rng.integers(-3, 4, (3, H, W))).astype(np.int32)
    tcfg = dataclasses.replace(TC.cost, patch_stride=TC.match.exact_tap_stride)
    jcfg = dataclasses.replace(JC.cost, patch_stride=JC.match.exact_tap_stride)
    offs = tcfg.tap_offsets

    def jax_cost(p, txs, tys):
        stack = jcost.make_patch_stack(p, jcfg.tap_offsets,
                                       dtype=jnp.bfloat16)
        return jcost.patch_cost_stack(p, stack, txs, tys, jcfg,
                                      jcfg.tap_offsets)

    want = tcost.quantize_cost(torch.from_numpy(np.array(jax.jit(jax_cost)(
        jnp.asarray(pack.numpy()), jnp.asarray(tx), jnp.asarray(ty)))))
    stack = tcost.make_patch_stack(pack, offs, dtype=torch.bfloat16)
    args = (pack, stack, torch.from_numpy(tx), torch.from_numpy(ty), tcfg,
            offs)
    got = tcost.quantize_cost(tcost.patch_cost_stack(*args))
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert (tcost.quantize_cost(unfused_stack_cost(*args)) != want).any()
