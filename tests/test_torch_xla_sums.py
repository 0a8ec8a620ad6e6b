"""The dense residual cost (kernel A's plain version, ``ops/dense.py::
residual_costs``) sums its taps in the arithmetic XLA's CPU code gives the
JAX package's ``dense.residual_costs``, at each of the pipeline's call
sites, on crops of ``holdout/disk_layered`` (cartoon disks moving over a
cartoon background, 480x640), whose flow missed the contract while the
port added each chunk's rounded products in sequence.

XLA's form depends on the program (``tools/torch_xla_arith.py --sites``
holds the port to every call of ``compute_flow_jit`` on the whole case):
a chunk of at most 32 taps sums in 8 vector lanes of fused multiply-adds,
a longer one in windows of 32; the weight's exponent fuses dr2^2 or
dr1^2 into its multiply-add as XLA hoists dr1^2 or not; the weights sum
in lanes or in sequence.  Each case below is one such form, held
``np.array_equal`` on the quantized costs to the JAX function jitted
alone (the form the pipeline's program takes at that site), and the
dense flow of a crop of the case to ``compute_flow_jit`` on every
pixel."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eppm_tpu.config import DEFAULT_CONFIG as JC
from eppm_tpu.ops import dense as jdense
from eppm_tpu.ops import match as jmatch
from eppm_tpu.pipeline import compute_flow_jit

from eppm_tpu_torch import evalset
from eppm_tpu_torch.config import DEFAULT_CONFIG as TC
from eppm_tpu_torch.ops import dense as tdense
from eppm_tpu_torch.ops import match as tmatch
from eppm_tpu_torch.pipeline import compute_flow, prepare_pyramids

# The suite runs several test processes per host: one torch thread each
# keeps them from oversubscribing the cores.
torch.set_num_threads(1)


def disk_layered_frames():
    """Frames 10 and 11 of ``holdout/disk_layered`` as its PPMs hold them
    (uint8), and its ground truth."""
    rng = np.random.default_rng(evalset.HOLDOUT_SEED)
    for _ in range(2):  # the cases drawn before it
        evalset.cartoon(rng, 480, 640)
    for _ in range(2):
        evalset.stripes(rng, 436, 1024)
    img1, img2, gt = evalset.disk_layered_scene(
        rng, 480, 640, (11.0, -4.0), (-38.0, 14.0), evalset.cartoon)
    return [(im * 255 + 0.5).astype(np.uint8) for im in (img1, img2)] + [gt]


@pytest.fixture(scope="module")
def frames():
    return disk_layered_frames()


# the cost sites' crop (top, left, height, width): background and the
# edges of two disks
COST_CROP = (64, 384, 64, 96)
# crops whose dense flow missed compute_flow_jit's while the residual cost
# summed each chunk in sequence (79.49% and 64.10% of pixels within 1e-3;
# the first the smallest found)
FLOW_CROPS = [(0, 432, 32, 48), (0, 400, 48, 64)]

MINI = jmatch._make_mini_cost(JC.cost, JC.match)

# (id, cost config, candidate radius, tap chunk, plane tables): one site of
# the pipeline each (the config's taps: 49 for cost, 25 for pass2_cost,
# 81 for the mini levels' cost)
SITES = [
    ("refine-pass1", "cost", 1, 25, False),
    ("refine-pass2", "pass2", 1, 25, False),
    ("refine-pass1-chunk49", "cost", 1, 49, False),
    ("refine-pass2-chunk49", "pass2", 1, 49, False),
    ("descent-mini-81taps", "mini", 3, 25, False),
    ("descent-mini-81taps-chunk49", "mini", 3, 49, False),
    ("polish-radius3", "cost", 3, 25, False),
    ("rescore-K1", "cost", 0, 25, False),
    ("rescore-K1-chunk49", "cost", 0, 49, False),
    ("planes-pass1", "cost", 1, 25, True),
    ("planes-pass2", "pass2", 1, 25, True),
]


def _cfgs(name):
    tc = {"cost": TC.cost, "pass2": TC.pass2_cost,
          "mini": tmatch._make_mini_cost(TC.cost, TC.match)}[name]
    jc = {"cost": JC.cost, "pass2": JC.pass2_cost, "mini": MINI}[name]
    return jc, tc


def _packs(frames, crop):
    """The crop's level-0 packs, frame 2 warped by the integer ground
    truth (the refine's own warp)."""
    y, x, h, w = crop
    f1, f2, gt = frames
    p1 = prepare_pyramids(torch.from_numpy(f1[y:y + h, x:x + w].copy()),
                          TC)[1][0]
    p2 = prepare_pyramids(torch.from_numpy(f2[y:y + h, x:x + w].copy()),
                          TC)[1][0]
    g = torch.from_numpy(gt[y:y + h, x:x + w]).trunc().to(torch.int32)
    return p1, p2, g


@pytest.mark.parametrize("site,cfg_name,radius,chunk,planes", SITES,
                         ids=[s[0] for s in SITES])
def test_residual_costs_equal_xla(frames, site, cfg_name, radius, chunk,
                                  planes):
    p1, p2, g = _packs(frames, COST_CROP)
    warped = tdense.warp_pack(p2, g[..., 0], g[..., 1])
    jc, tc = _cfgs(cfg_name)
    cands = tdense.center_out_offsets(radius)
    want = np.asarray(jax.jit(lambda a, b: jdense.residual_costs(
        a, b, cands, jc, planes, chunk))(p1.numpy(), warped.numpy()))
    got = tdense.residual_costs(p1, warped, cands, tc, planes, chunk)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("chunk", [25, 49])
def test_multiwarp_costs_equal_xla(frames, chunk):
    """``rescore_multi``: 5 warps of the jump flood (the ground truth and
    four shifts of it); the JAX package's ``lax.map`` over the warps, the
    port's multiwarp cost (one call)."""
    p1, p2, g = _packs(frames, COST_CROP)
    shifts = [(0, 0), (0, 3), (0, -3), (3, 0), (-3, 0)]
    gys = torch.stack([g[..., 1] + dy for dy, _ in shifts])
    gxs = torch.stack([g[..., 0] + dx for _, dx in shifts])
    want = np.asarray(jax.jit(lambda a, b, y, x: jmatch.rescore_multi(
        a, b, y, x, JC.cost, chunk))(p1.numpy(), p2.numpy(), gys.numpy(),
                                     gxs.numpy()))
    got = tmatch.rescore_multi(p1, p2, gys, gxs, TC.cost, chunk)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("crop", FLOW_CROPS)
def test_flow_equals_compute_flow_jit(frames, crop):
    """The dense flow of the crop equals ``compute_flow_jit``'s on every
    pixel (it missed on some while kernel A's plain version summed each
    chunk in sequence)."""
    y, x, h, w = crop
    f1, f2 = (f[y:y + h, x:x + w].copy() for f in frames[:2])
    want = np.asarray(compute_flow_jit(jnp.asarray(f1), jnp.asarray(f2),
                                       None, JC))
    got = compute_flow(torch.from_numpy(f1), torch.from_numpy(f2),
                       TC).numpy()
    np.testing.assert_array_equal(got, want)
