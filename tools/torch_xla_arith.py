#!/usr/bin/env python
"""Where the PyTorch port's arithmetic parts from XLA's CPU code for the
JAX package, measured on one eval-set case, on the CPU.

XLA's CPU backend fuses multiply-adds and sums reductions in vector lanes,
which the JAX source does not show, and a quantized decision can turn on
the last bit.  On the case's frames (the JAX package's prepared levels,
fed to both packages) this prints:

1. the census luminance: how many luminances of each level differ from
   the jitted ``0.3R + 0.6G + 0.1B``, for the port's fused form and for
   the unfused sum, and how many census values the unfused sum changes;
2. the exact-stage cost (``patch_cost_stack``) on the coarse level, for
   three target fields (each pixel moved by up to 3 px, seed 0): costs
   differing from the jitted JAX function, raw and quantized, for the
   port and for the unfused form it had;
3. the dense refine's residual cost at level 1 (pass 1 on the upsampled
   coarse flow of ``compute_flow_jit``'s chain, pass 2 on its median
   after pass 1): quantized costs differing from the JAX package's
   ``residual_costs`` jitted alone, for the port's plain version
   (``ops/cost.py::bilateral_cost``, kernel A's arithmetic) and for the
   sequential sums kernel A had before (``sequential_cost``: each
   chunk's rounded products added in order);
4. the global sweep of the coarse match: the targets that differ from
   the JAX package's on the same descriptors, with the exact scores x4096
   of both targets (``eppm_tpu`` sums in float32, the port exactly).

``--flow`` also runs the port's whole pipeline and holds its flow to
``compute_flow_jit``'s (the contract's share within 1e-3).

``--sites`` instead records every residual cost of ``compute_flow_jit``
on the case (``--set KEY=VALUE`` overrides the config, e.g.
``cost_tap_chunk=49`` or ``dense_pass2_planes=True``): each call's
inputs and quantized costs, as the program the pipeline compiles computes
them (a ``jax.debug.callback`` beside ``dense.residual_costs``), labelled
by the call site (the refine passes, ``rescore``, ``rescore_multi``'s
``lax.map``, the descent chain, the polish).  Per site it prints how many
quantized costs of the port's plain version differ from the program's,
how many the sequential sums' would, and how many the JAX function
jitted alone gives differently from the program.

  python tools/torch_xla_arith.py evalset/holdout/disk_layered [--flow]
  python tools/torch_xla_arith.py evalset/holdout/disk_layered --sites \
      [--set cost_tap_chunk=49]

XLA's arithmetic depends on the program it compiles (``--sites`` shows
where the function jitted alone parts from the pipeline's program); dump
a program's optimised HLO and IR with ``XLA_FLAGS=--xla_dump_to=DIR`` to
read the form it takes.
"""

import argparse
import contextlib
import dataclasses
import functools
import inspect
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from eppm_tpu_torch.ops._util import pad_edge  # noqa: E402
from eppm_tpu_torch.ops.cost import quantize_cost  # noqa: E402


def sequential_cost(taps, center1, center2, gws, cfg, chunk,
                    plane_fronto=False):
    """``ops/cost.py::bilateral_cost`` as it was before it took XLA's
    arithmetic: every product rounded, each chunk's taps added in table
    order, the chunks' partial sums in chunk order."""
    from eppm_tpu_torch.ops import cost as tcost
    from eppm_tpu_torch.ops._util import exp_cephes, ftz

    inv_lam_ad2, inv_lam_cen2, inv_sig_r2 = tcost.cost_constants(cfg)
    pairs = list(zip(taps, gws))
    cost_sum = weight_sum = 0.0
    for c0 in range(0, len(pairs), chunk):
        part_c = part_w = 0.0
        for (p1, p2), gw in pairs[c0 : c0 + chunk]:
            dr1 = tcost.maxabs3(center1, p1[..., :3])
            dr2 = tcost.maxabs3(center2, p2[..., :3])
            wgt = ftz(exp_cephes(-(dr1 * dr1 + dr2 * dr2) * inv_sig_r2) * gw)
            term = tcost.ad_census(p1, p2, inv_lam_ad2, inv_lam_cen2)
            part_c = part_c + wgt * term
            part_w = part_w + wgt
        cost_sum = cost_sum + part_c
        weight_sum = weight_sum + part_w
    return cost_sum / weight_sum.clamp_min(1e-30)


@contextlib.contextmanager
def sequential_sums():
    """The port's dense residual cost in the sequential sums kernel A had
    before it took XLA's arithmetic (``sequential_cost``)."""
    from eppm_tpu_torch.ops import dense as tdense

    orig = tdense.bilateral_cost
    tdense.bilateral_cost = sequential_cost
    try:
        yield
    finally:
        tdense.bilateral_cost = orig


def _unfused_census(lum):
    from eppm_tpu_torch.ops.census import NEIGHBOR_OFFSETS

    h, w = lum.shape
    pad = np.pad(lum, 1, mode="edge")
    out = np.zeros((h, w), np.int32)
    for bit, (dx, dy) in enumerate(NEIGHBOR_OFFSETS):
        out |= (pad[1 + dy : 1 + dy + h, 1 + dx : 1 + dx + w] > lum) << bit
    return out


# the callers of dense.residual_costs in eppm_tpu's pipeline, innermost
# first (rescore_multi's lax.map is recorded whole, beside the port's
# multiwarp call)
SITES = ("dense_refine_flow", "rescore", "_descend_chain",
         "_polish_direction")


def sites(case, overrides):
    """Every residual cost of ``compute_flow_jit`` on the case, in the
    program the pipeline compiles, against the port's plain version."""
    from eppm_tpu import pipeline as jp
    from eppm_tpu.cli import load_image
    from eppm_tpu.config import DEFAULT_CONFIG as JC
    from eppm_tpu.ops import dense as jdense
    from eppm_tpu.ops import match as jmatch
    from eppm_tpu.ops import pallas_cost as jpc
    from eppm_tpu_torch.config import CostConfig
    from eppm_tpu_torch.ops import dense as tdense
    from eppm_tpu_torch.ops import match as tmatch

    cfg = JC
    for kv in overrides:
        key, value = kv.split("=", 1)
        cfg = dataclasses.replace(cfg, **{key: eval(value)})
    records = []
    in_multi = []

    def record(meta, *arrays):
        jax.debug.callback(lambda *a: records.append(
            (meta, [np.array(x) for x in a])), *arrays)

    def residual_costs(pack1, warped2, cand_offsets, cost_cfg,
                       use_planes=True, tap_chunk=25):
        out = jdense.residual_costs(pack1, warped2, cand_offsets, cost_cfg,
                                    use_planes, tap_chunk)
        if not in_multi:
            names = [f.function for f in inspect.stack()[1:12]]
            site = next((s for s in SITES if s in names), "?")
            record((site, tuple(cand_offsets), cost_cfg, use_planes,
                    tap_chunk), pack1, warped2, out)
        return out

    multi = jmatch.rescore_multi

    def rescore_multi(pack1, pack2, gys, gxs, cost_cfg, tap_chunk=25):
        in_multi.append(True)
        try:
            out = multi(pack1, pack2, gys, gxs, cost_cfg, tap_chunk)
        finally:
            in_multi.pop()
        record(("rescore_multi", None, cost_cfg, False, tap_chunk),
               pack1, pack2, gys, gxs, out)
        return out

    originals = (jpc.residual_costs_auto, jmatch.rescore_multi)
    jpc.residual_costs_auto = jmatch.residual_costs_auto = residual_costs
    jmatch.rescore_multi = rescore_multi
    img1 = load_image(os.path.join(case, "frame10.ppm"))
    img2 = load_image(os.path.join(case, "frame11.ppm"))
    try:
        jp.compute_flow_jit(jnp.asarray(img1), jnp.asarray(img2), None,
                            cfg).block_until_ready()
        jax.effects_barrier()  # every callback has run
    finally:
        jpc.residual_costs_auto = jmatch.residual_costs_auto = originals[0]
        jmatch.rescore_multi = originals[1]
    print(f"{len(records)} residual-cost calls of compute_flow_jit on "
          f"{case} ({overrides or 'the default config'}): quantized costs "
          "differing from the program's (the port / sequential sums / "
          "the JAX function jitted alone)")
    counts, alone = {}, {}
    for (site, cands, jcfg, planes, chunk), arrays in records:
        tcfg = CostConfig(**dataclasses.asdict(jcfg))
        want = arrays[-1]
        if site == "rescore_multi":
            def port():
                return tmatch.rescore_multi(
                    *[torch.from_numpy(a) for a in arrays[:4]], tcfg,
                    chunk).numpy()
            fn = functools.partial(multi, cost_cfg=jcfg, tap_chunk=chunk)
        else:
            def port():
                return tdense.residual_costs(
                    *[torch.from_numpy(a) for a in arrays[:2]], cands, tcfg,
                    planes, chunk).numpy()
            fn = functools.partial(jdense.residual_costs,
                                   cand_offsets=cands, cfg=jcfg,
                                   use_planes=planes, tap_chunk=chunk)
        key = (site, cands, jcfg, planes, chunk)
        if key not in alone:
            alone[key] = jax.jit(fn)
        with sequential_sums():
            seq = port()
        got = (port(), seq, np.asarray(alone[key](*arrays[:-1])))
        label = (f"{site} {want.shape[-2]}x{want.shape[-1]} K="
                 f"{want.shape[0]} taps={len(jcfg.tap_offsets)} chunk="
                 f"{chunk}{' planes' if planes else ''}")
        c = counts.setdefault(label, [0, 0, 0, 0, 0])
        c[0] += 1
        c[4] += want.size
        for i, g in enumerate(got):
            c[i + 1] += int((g != want).sum())
    for label, (n, port_d, seq_d, alone_d, size) in counts.items():
        print(f"   {label}: {n} calls, {port_d} / {seq_d} / {alone_d} of "
              f"{size}")
    return 0


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("case", help="directory with frame10.ppm, frame11.ppm")
    p.add_argument("--flow", action="store_true",
                   help="the port's whole flow against compute_flow_jit's")
    p.add_argument("--sites", action="store_true",
                   help="the residual costs of every call site of "
                   "compute_flow_jit's program against the port's")
    p.add_argument("--set", action="append", default=[],
                   metavar="KEY=VALUE", help="config override for --sites")
    args = p.parse_args(argv)
    if args.sites:
        return sites(args.case, args.set)

    from eppm_tpu import pipeline as jp
    from eppm_tpu.cli import load_image
    from eppm_tpu.config import DEFAULT_CONFIG as JC
    from eppm_tpu.ops import cost as jcost
    from eppm_tpu.ops import dense as jdense
    from eppm_tpu.ops import match as jmatch
    from eppm_tpu_torch import pipeline as tp
    from eppm_tpu_torch.config import DEFAULT_CONFIG as TC
    from eppm_tpu_torch.ops import census as tcensus
    from eppm_tpu_torch.ops import cost as tcost
    from eppm_tpu_torch.ops import dense as tdense
    from eppm_tpu_torch.ops import match as tmatch
    from eppm_tpu_torch.ops.resize import bilinear_resize

    def T(x):
        return torch.from_numpy(np.array(x))

    img1 = load_image(os.path.join(args.case, "frame10.ppm"))
    img2 = load_image(os.path.join(args.case, "frame11.ppm"))
    jl1, jp1 = jp._prep_stage(jnp.asarray(img1), JC)
    jl2, jp2 = jp._prep_stage(jnp.asarray(img2), JC)
    f = np.float32

    print("1. census luminance: differing luminances (fused / unfused), "
          "census values the unfused sum changes")
    jlum = jax.jit(lambda x: 0.3 * x[..., 0] + 0.6 * x[..., 1]
                   + 0.1 * x[..., 2])
    for i, (lv, pk) in enumerate(zip(jl1, jp1)):
        lv = np.asarray(lv)
        want = np.asarray(jlum(jnp.asarray(lv)))
        fused = tcensus.luminance(T(lv)).numpy()
        unfused = (f(0.3) * lv[..., 0] + f(0.6) * lv[..., 1]) \
            + f(0.1) * lv[..., 2]
        cen = (_unfused_census(unfused) != np.asarray(pk)[..., 3]).sum()
        print(f"   level {i} {lv.shape[:2]}: {(fused != want).sum()} / "
              f"{(unfused != want).sum()} of {want.size}; census {cen}")

    top = len(jp1) - 1
    pk1, pk2 = T(jp1[top]), T(jp2[top])
    H, W = pk1.shape[:2]
    rng = np.random.default_rng(0)
    ys, xs = np.mgrid[0:H, 0:W]
    tx = (xs[None] + rng.integers(-3, 4, (3, H, W))).astype(np.int32)
    ty = (ys[None] + rng.integers(-3, 4, (3, H, W))).astype(np.int32)
    tcfg = dataclasses.replace(TC.cost, patch_stride=TC.match.exact_tap_stride)
    jcfg = dataclasses.replace(JC.cost, patch_stride=JC.match.exact_tap_stride)
    offs = tcfg.tap_offsets
    want = np.asarray(jax.jit(lambda a, b, x, y: jcost.patch_cost_stack(
        a, jcost.make_patch_stack(b, jcfg.tap_offsets, dtype=jnp.bfloat16),
        x, y, jcfg, jcfg.tap_offsets))(jp1[top], jp2[top], tx, ty))
    stack = tcost.make_patch_stack(pk2, offs, dtype=torch.bfloat16)
    got = tcost.patch_cost_stack(pk1, stack, T(tx), T(ty), tcfg, offs).numpy()
    K = tx.shape[0]
    idx = (T(ty).clamp(0, H - 1) * W + T(tx).clamp(0, W - 1)).reshape(-1)
    taps2 = stack.reshape(H * W, -1)[idx.long()].reshape(
        K, H, W, len(offs) + 1, 4).to(torch.float32)
    R = tcfg.patch_radius
    pad1 = pad_edge(pk1, R, R)
    pairs = [(pad1[R + i : R + i + H, R + j : R + j + W], taps2[..., t, :])
             for t, (i, j) in enumerate(tcfg.tap_offsets)]
    gws = [tcost.tap_weight(i, j, tcfg.sigma_spatial)
           for (i, j) in tcfg.tap_offsets]
    old = sequential_cost(pairs, pk1[..., :3], taps2[..., -1, :3], gws,
                          tcfg, len(gws)).numpy()
    def q(a):
        return quantize_cost(torch.from_numpy(np.array(a))).numpy()

    print(f"2. exact-stage cost at {H}x{W}, 3 fields: raw {(got != want).sum()}"
          f" (unfused {(old != want).sum()}), quantized "
          f"{(q(got) != q(want)).sum()} ({(q(old) != q(want)).sum()}) of "
          f"{want.size} differ")

    # 3. the refine passes at level 1, on the JAX chain's flows
    m1, m2 = jp._match_stage_bidi(jl1[top], jl2[top], jp1[top], jp2[top],
                                  jax.random.PRNGKey(JC.seed), JC)
    coarse = jp._coarse_refine_stage(m1, m2, jl1[top], JC, jp1[top],
                                     jp2[top])
    lvl = top - 1
    oh, ow = jp1[lvl].shape[:2]
    up = bilinear_resize(T(coarse), oh, ow, 2.0) * 2.0
    pass1 = jp._refine_pass_stage(coarse, jp1[lvl], jp2[lvl], JC, oh, ow,
                                  False)
    med = tdense.median3_flow(T(pass1))
    chunk = TC.cost_tap_chunk
    print(f"3. residual costs at level {lvl} ({oh}x{ow}): quantized costs "
          "differing from eppm_tpu's (the port / sequential sums)")
    for name, flow, jcf, tcf, shape in (
            ("pass 1", up, JC.cost, TC.cost, TC.dense_cand_shape),
            ("pass 2", med, JC.pass2_cost, TC.pass2_cost,
             TC.pass2_cand_shape)):
        g = flow.trunc().to(torch.int32)
        warped = tdense.warp_pack(T(jp2[lvl]), g[..., 0], g[..., 1])
        cands = tdense.center_out_offsets(TC.dense_search_radius, shape)
        want = np.asarray(jax.jit(lambda a, b: jdense.residual_costs(
            a, b, cands, jcf, False, chunk))(jp1[lvl], warped.numpy()))
        port = tdense.residual_costs(T(jp1[lvl]), warped, cands, tcf,
                                     False, chunk).numpy()
        with sequential_sums():
            seq = tdense.residual_costs(T(jp1[lvl]), warped, cands, tcf,
                                        False, chunk).numpy()
        print(f"   {name} ({len(tcf.tap_offsets)} taps, chunk {chunk}): "
              f"{(port != want).sum()} / {(seq != want).sum()} of "
              f"{want.size}")

    # 4. the global sweep of the coarse match, on the same descriptors
    h, w = jl1[top].shape[:2]
    s = 2 if h * w > JC.match.global_stride_threshold else 1
    dj = [jax.jit(lambda x: jmatch.patch_descriptors(x, JC.match,
                                                     stride=s))(pk)
          for pk in (jp1[top], jp2[top])]
    d64 = [np.asarray(d).astype(np.float32).reshape(-1, d.shape[-1])
           .astype(np.float64) for d in dj]
    jg = jax.jit(lambda a, b: jmatch.global_match_bidi(
        a, b, JC.match.global_block))(*dj)
    tg = tmatch.global_match_bidi(
        *[torch.from_numpy(np.asarray(d).astype(np.float32)).to(
            torch.bfloat16) for d in dj], TC.match.global_block)
    w2 = dj[1].shape[1]
    print(f"4. global sweep at stride {s}: targets differing from "
          "eppm_tpu's, exact scores x4096 (eppm_tpu's target / the port's)")
    for direction, (a, b, jy, jx, ty_, tx_) in enumerate((
            (0, 1, jg[0], jg[1], tg[0], tg[1]),
            (1, 0, jg[2], jg[3], tg[2], tg[3]))):
        jt = (np.asarray(jy) * (w2 if direction == 0 else dj[0].shape[1])
              + np.asarray(jx)).ravel()
        pt = (ty_.numpy() * (w2 if direction == 0 else dj[0].shape[1])
              + tx_.numpy()).ravel()
        rows = np.nonzero(jt != pt)[0]
        hn = 0.5 * (d64[b] * d64[b]).sum(1)
        print(f"   direction {direction + 1}: {rows.size} of {jt.size}")
        for r in rows:
            sj = (d64[a][r] @ d64[b][jt[r]] - hn[jt[r]]) * 4096
            sp = (d64[a][r] @ d64[b][pt[r]] - hn[pt[r]]) * 4096
            print(f"     row {r}: {sj:.4f} / {sp:.4f}")

    if args.flow:
        one = np.asarray(jp.compute_flow_jit(jnp.asarray(img1),
                                             jnp.asarray(img2), None, JC))
        flow = tp.compute_flow(T(img1), T(img2), TC).numpy()
        d = np.abs(flow.astype(np.float64) - one).max(axis=-1)
        print(f"5. the port's flow vs compute_flow_jit: "
              f"{(d < 1e-3).mean():.4%} within 1e-3, mean {d.mean():.3e}, "
              f"max {d.max():.4g}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
