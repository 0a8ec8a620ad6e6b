"""Kernel A's two-pass form on the CPU: the AD + census term computed once
per shifted pixel (``ops/dense.py::cost_terms``, the plain version of the
terms pass) and looked up through the wrapper's own map-index table
(``ops/cuda_cost.py::cost_plan``) gives the residual cost bit for bit.

The frames (7x11) are smaller than the tap reach (9 and 8), so taps and
candidates run past every border.  Everything is held with
``torch.equal``: the two-pass form computes the same float32 operations
on the same operands, in the same order, as ``residual_costs``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eppm_tpu.config import DEFAULT_CONFIG as JC
from eppm_tpu.ops import dense as jdense

from eppm_tpu_torch.config import DEFAULT_CONFIG as TC
from eppm_tpu_torch.ops import cost as tcost
from eppm_tpu_torch.ops import cuda_cost
from eppm_tpu_torch.ops import dense as tdense
from eppm_tpu_torch.ops._util import exp_cephes, fma32, ftz, shift2d
from eppm_tpu_torch.ops.census import census_transform

# The suite runs several test processes per host: one torch thread each
# keeps them from oversubscribing the cores.
torch.set_num_threads(1)

H, W = 7, 11

# (mode, candidate radius or frame count, cost config, maps expected):
# the plane shift sets of refine pass 1 (49 taps) and pass 2 (25 taps)
CASES = [
    ("fronto", 1, "cost", 9),
    ("fronto", 3, "cost", 49),
    ("multiwarp", 5, "cost", 5),
    ("planes", 1, "cost", 100),
    ("planes", 1, "pass2", 84),
]
IDS = [f"{m}-{n}-{c}" for m, n, c, _ in CASES]


def _cfg(name):
    return {"cost": TC.cost, "pass2": TC.pass2_cost}[name]


def _packs(seed, n_frames=1):
    """pack1 (H, W, 4) and a frame-2 stack (n_frames, H, W, 4): noisy
    shifted copies of a random frame."""
    rng = np.random.default_rng(seed)
    img1 = rng.random((H, W, 3)).astype(np.float32)
    packs = []
    for i in range(n_frames + 1):
        img = img1 if i == 0 else np.clip(
            np.roll(img1, (i % 3 - 1, 2 - i), (0, 1))
            + rng.normal(0, 0.05, (H, W, 3)), 0, 1).astype(np.float32)
        t = torch.from_numpy(img)
        packs.append(tcost.pack_frame(t, census_transform(t)))
    return packs[0], torch.stack(packs[1:])


def _setup(mode, n, cfg_name, seed=0):
    """(pack1, frames, candidate rows (cy, cx, frame), cfg, tables, the
    plain cost)."""
    cfg = _cfg(cfg_name)
    p1, frames = _packs(seed, n if mode == "multiwarp" else 1)
    if mode == "multiwarp":
        cands = [(0, 0, k) for k in range(n)]
        want = tdense.residual_costs_multiwarp(p1, frames, cfg)
    else:
        offsets = tdense.center_out_offsets(n)
        cands = [(cy, cx, 0) for cy, cx in offsets]
        want = tdense.residual_costs(p1, frames[0], offsets, cfg,
                                     use_planes=mode == "planes")
    tables = tdense.cost_tables(cfg, mode == "planes")
    return p1, frames, cands, cfg, tables, want


@pytest.mark.parametrize("mode,n,cfg_name,n_maps", CASES, ids=IDS)
def test_shift_sets(mode, n, cfg_name, n_maps):
    """One map per candidate (fronto), per frame (multiwarp), per distinct
    c + e - d (planes); outside the plane mode every tap of a candidate
    reads the candidate's own map."""
    _, _, cands, cfg, tables, _ = _setup(mode, n, cfg_name)
    plan = cuda_cost.cost_plan(cands, cfg.tap_offsets, tables)
    k, b, t = len(cands), len(tables), len(cfg.tap_offsets)
    assert plan.maps.shape == (n_maps, 3)
    assert plan.map_of.shape == (k, b, t) and plan.taps2.shape == (b, t, 2)
    assert sorted(set(plan.map_of.ravel().tolist())) == list(range(n_maps))
    for kk, (cy, cx, f) in enumerate(cands):
        for bb in range(b):
            for tt, (dy, dx) in enumerate(cfg.tap_offsets):
                ey, ex = plan.taps2[bb, tt]
                assert plan.maps[plan.map_of[kk, bb, tt]].tolist() == [
                    f, cy + ey - dy, cx + ex - dx]
    if mode != "planes":
        assert (plan.map_of == plan.map_of[:, :, :1]).all()
        assert len(set(plan.map_of[:, 0, 0].tolist())) == k


@pytest.mark.parametrize("mode,n,cfg_name,n_maps", CASES, ids=IDS)
def test_terms_equal_the_per_tap_terms_of_the_plain_cost(
        monkeypatch, mode, n, cfg_name, n_maps):
    """Every c_ad + c_cen that ``bilateral_cost`` computes inside the plain
    cost (recorded call by call) is the terms map's value at u = p + d."""
    seen = []
    orig = tcost.ad_census

    def record(*args):
        seen.append(orig(*args))
        return seen[-1]

    monkeypatch.setattr(tcost, "ad_census", record)
    p1, frames, cands, cfg, tables, _ = _setup(mode, n, cfg_name)
    taps = list(cfg.tap_offsets)
    assert len(seen) == len(tables) * len(taps)
    plan = cuda_cost.cost_plan(cands, taps, tables)
    R = tdense._reach(cfg.tap_offsets)
    terms = tdense.cost_terms(p1, frames, plan.maps, R, cfg)
    assert terms.shape == (n_maps, H + 2 * R, W + 2 * R)
    for b in range(len(tables)):
        for t, (dy, dx) in enumerate(taps):
            for k in range(len(cands)):
                got = terms[plan.map_of[k, b, t], R + dy : R + dy + H,
                            R + dx : R + dx + W]
                assert torch.equal(got, seen[b * len(taps) + t][k]), (b, t, k)


def reassemble(p1, frames, cands, cfg, tables):
    """Kernel A's second pass written in torch: per (candidate, table,
    tap) the range weight of the frame-2 tap at clamp(p + c + e), the
    term looked up through the plan's map-index table, summed in the
    kernel's loops (each chunk's first taps in 8 lanes, a halving tree,
    the rest in sequence), quantized, least over the tables."""
    h, w = p1.shape[0], p1.shape[1]
    taps = list(cfg.tap_offsets)
    plan = cuda_cost.cost_plan(cands, taps, tables)
    R = tdense._reach(cfg.tap_offsets)
    terms = tdense.cost_terms(p1, frames, plan.maps, R, cfg)
    inv_sig_r2 = tcost.cost_constants(cfg)[2]
    chunk, lanes = tcost.TAP_CHUNK, 8
    full = chunk // lanes * lanes

    def tree(v):
        return (((v[0] + v[4]) + (v[2] + v[6]))
                + ((v[1] + v[5]) + (v[3] + v[7])))

    best = None
    for b in range(len(tables)):
        costs = []
        for k, (cy, cx, f) in enumerate(cands):
            c2 = shift2d(frames[f], cy, cx)[..., :3]
            one_chunk = len(taps) <= chunk
            dr1_apart = one_chunk and len(cands) > 1
            w_lanes = one_chunk and full > 0 and not (len(tables) > 1
                                                      and b == 0)

            def tap(t):
                """(e, g, w, term) of tap t, as the kernel's lambda."""
                dy, dx = taps[t]
                ey, ex = (int(v) for v in plan.taps2[b, t])
                tap1 = shift2d(p1, dy, dx)[..., :3]
                tap2 = shift2d(frames[f], cy + ey, cx + ex)[..., :3]
                dr1 = tcost.maxabs3(p1[..., :3], tap1)
                dr2 = tcost.maxabs3(c2, tap2)
                arg = (fma32(dr2, dr2, dr1 * dr1) if dr1_apart
                       else fma32(dr1, dr1, dr2 * dr2))
                e = exp_cephes(-arg * inv_sig_r2)
                g = tcost.tap_weight(dy, dx, cfg.sigma_spatial)
                term = terms[plan.map_of[k, b, t], R + dy : R + dy + h,
                             R + dx : R + dx + w]
                return e, g, ftz(e * g), term

            cost_sum = weight_sum = 0.0
            for c0 in range(0, len(taps), chunk):
                m = min(chunk, len(taps) - c0)
                in_lanes = min(full, m)
                lane_c, lane_w = [0.0] * lanes, [0.0] * lanes
                part_w = 0.0
                for g0 in range(0, in_lanes, lanes):
                    for i in range(min(lanes, in_lanes - g0)):
                        e, g, wgt, term = tap(c0 + g0 + i)
                        lane_c[i] = fma32(wgt, term, lane_c[i])
                        if w_lanes:
                            lane_w[i] = (wgt if g0 == 0
                                         else fma32(e, g, lane_w[i]))
                        else:
                            part_w = (wgt if g0 + i == 0
                                      else fma32(e, g, part_w))
                part_c = tree(lane_c)
                if w_lanes:
                    part_w = tree(lane_w)
                for t in range(c0 + in_lanes, c0 + m):
                    e, g, wgt, term = tap(t)
                    part_c = fma32(wgt, term, part_c)
                    part_w = (fma32(e, g, part_w) if w_lanes or t > c0
                              else wgt)
                cost_sum = cost_sum + part_c
                weight_sum = weight_sum + part_w
            costs.append(tcost.quantize_cost(
                cost_sum / weight_sum.clamp_min(1e-30)))
        cost = torch.stack(costs)
        best = cost if best is None else torch.minimum(best, cost)
    return best


@pytest.mark.parametrize("mode,n,cfg_name,n_maps", CASES, ids=IDS)
def test_reassembly_from_the_maps_equals_the_plain_cost(
        mode, n, cfg_name, n_maps):
    p1, frames, cands, cfg, tables, want = _setup(mode, n, cfg_name)
    got = reassemble(p1, frames, cands, cfg, tables)
    assert got.shape == (len(cands), H, W)
    assert torch.equal(got, want)


@pytest.mark.parametrize("planes", [False, True])
def test_reassembly_matches_jax(planes):
    """The two-pass form against the JAX package's residual cost (the
    tolerance of tests/test_torch_cost.py: at most one 2^-17 step apart,
    on fewer than 1% of the entries), at 16x24 with 9 candidates."""
    rng = np.random.default_rng(7)
    img1 = rng.random((16, 24, 3)).astype(np.float32)
    img2 = np.clip(np.roll(img1, (1, -2), (0, 1))
                   + rng.normal(0, 0.02, (16, 24, 3)), 0, 1).astype(np.float32)
    p1, p2 = (tcost.pack_frame(torch.from_numpy(i),
                               census_transform(torch.from_numpy(i)))
              for i in (img1, img2))
    offsets = tdense.center_out_offsets(1)
    want = np.asarray(jax.jit(lambda a, b: jdense.residual_costs(
        a, b, offsets, JC.cost, planes, 25))(jnp.asarray(p1.numpy()),
                                            jnp.asarray(p2.numpy())))
    got = reassemble(p1, p2[None], [(cy, cx, 0) for cy, cx in offsets],
                     TC.cost, tdense.cost_tables(TC.cost, planes)).numpy()
    d = np.abs(got - want)
    assert d.max() <= 2.0**-17 + 1e-9 and (d > 0).mean() < 0.01
