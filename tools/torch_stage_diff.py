#!/usr/bin/env python
"""Find the first stage at which the PyTorch port leaves the JAX package,
for one eval-set case (or any frame pair), on the CPU.

Each stage of the pipeline runs in both packages on the SAME inputs, the
JAX package's outputs of the stage before, so that a difference belongs to
the stage that shows it: ``prepare_pyramids``; the coarse match
(``match_coarse_bidi``, or the PatchMatch searches on the default key);
``lr_check``; ``outlier_removal``; ``coarse_occlusion_reconstruct`` and
``nnf_to_flow``; then at each finer level the upsample, pass 1,
``median3_flow``, pass 2 and the smoothing; and the last smoothing.  The
JAX side runs the staged programs' pieces (``eppm_tpu.pipeline``'s
``_prep_stage``, ``_match_stage_bidi``, ``_refine_pass_stage``,
``_smooth_stage``) and the clean-up ops under ``jax.jit``; at the end the
chained JAX flow is held to ``compute_flow_jit``'s as a check of the
staging itself.

  python tools/torch_stage_diff.py evalset/holdout/stripes_large_disp \
      [--engine patchmatch] [--save DIR]

Per stage: the share of entries equal (targets) or within 1e-3 (flows),
the mean and the max |delta|, and the rows and columns where the
differences lie.  ``--save DIR`` keeps every stage's pair of outputs as
.npz for a closer look.  ``--ties`` weighs each pixel where a refine
pass chose another candidate than the JAX package: both packages'
quantized costs (in 2^-17 steps) of the two chosen candidates, from the
JAX package's ``residual_costs`` (jitted alone) and the port's plain
version on the pass's input, and how far apart the JAX package's own
two costs lie.
"""

import argparse
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
os.environ.setdefault("JAX_PLATFORMS", "cpu")


def describe(name, a, b, tol=1e-3):
    """One line on how far ``b`` (port) is from ``a`` (JAX)."""
    a = np.asarray(a)
    b = np.asarray(b)
    if a.shape != b.shape:
        print(f"{name:34s} SHAPES {a.shape} vs {b.shape}")
        return False
    d = np.abs(a.astype(np.float64) - b.astype(np.float64))
    if d.ndim == 3:
        d = d.max(axis=-1)
    off = d > (0 if np.issubdtype(a.dtype, np.integer) else tol)
    line = (f"{name:34s} {a.shape!s:18s} agree {1 - off.mean():.5%}  "
            f"mean {d.mean():.3e}  max {d.max():.4g}")
    if off.any() and d.ndim == 2:
        rows = np.nonzero(off.any(axis=1))[0]
        cols = np.nonzero(off.any(axis=0))[0]
        line += (f"  rows {rows.min()}-{rows.max()} ({rows.size})"
                 f"  cols {cols.min()}-{cols.max()} ({cols.size})")
    print(line, flush=True)
    return not off.any()


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("case", help="directory with frame10.ppm, frame11.ppm")
    p.add_argument("--engine", default="dense",
                   choices=("dense", "patchmatch"))
    p.add_argument("--set", dest="overrides", action="append", default=[])
    p.add_argument("--save", help="directory for each stage's .npz")
    p.add_argument("--ties", action="store_true",
                   help="weigh the refine passes' differing decisions")
    p.add_argument("--no-final", action="store_true",
                   help="skip the check of the staging against "
                        "compute_flow_jit")
    args = p.parse_args(argv)

    import jax
    import jax.numpy as jnp
    import torch

    from eppm_tpu import pipeline as jp
    from eppm_tpu.cli import apply_overrides as j_over
    from eppm_tpu.cli import load_image
    from eppm_tpu.config import DEFAULT_CONFIG as J_CFG
    from eppm_tpu.ops import dense as j_dense
    from eppm_tpu.ops import pallas_wmf as j_wmf
    from eppm_tpu.ops import refine as j_ref
    from eppm_tpu_torch import pipeline as tp
    from eppm_tpu_torch.cli import apply_overrides as t_over
    from eppm_tpu_torch.config import DEFAULT_CONFIG as T_CFG
    from eppm_tpu_torch.ops import dense as t_dense
    from eppm_tpu_torch.ops import refine as t_ref
    from eppm_tpu_torch.ops.cuda_smooth import flow_smoothing_auto
    from eppm_tpu_torch.ops.dense import dense_refine_flow, median3_flow
    from eppm_tpu_torch.ops.match import match_coarse_bidi
    from eppm_tpu_torch.ops.occlusion import coarse_occlusion_reconstruct
    from eppm_tpu_torch.ops.patchmatch import ThreefrySampler, patchmatch
    from eppm_tpu_torch.ops.prng import prng_key, split
    from eppm_tpu_torch.ops.resize import bilinear_resize

    ov = args.overrides + (["match_engine=patchmatch"]
                           if args.engine == "patchmatch" else [])
    jcfg, tcfg = j_over(J_CFG, ov), t_over(T_CFG, ov)
    img1 = load_image(os.path.join(args.case, "frame10.ppm"))
    img2 = load_image(os.path.join(args.case, "frame11.ppm"))
    if args.save:
        os.makedirs(args.save, exist_ok=True)

    def T(x):
        return torch.from_numpy(np.array(x))

    def N(x):
        return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)

    def check(name, a, b, tol=1e-3):
        a, b = N(a), N(b)
        describe(name, a, b, tol)
        if args.save:
            np.savez(os.path.join(args.save, name.replace(" ", "_") + ".npz"),
                     jax=a, port=b)

    def ties(name, flow_in, pk1, pk2, cost_cfg_j, cost_cfg_t, shape, jout,
             tout):
        """The two candidates each package chose where they differ, with
        both packages' quantized costs of each (2^-17 steps)."""
        jout, tout = N(jout), N(tout)
        off = np.abs(jout - tout).max(axis=-1) > 1e-3
        if not off.any():
            return
        g = np.trunc(N(flow_in)).astype(np.int32)
        cands = j_dense.center_out_offsets(tcfg.dense_search_radius, shape)
        warped = t_dense.warp_pack(pk2, T(g[..., 0]), T(g[..., 1]))
        jc = np.asarray(jax.jit(lambda a, b: j_dense.residual_costs(
            a, b, cands, cost_cfg_j, False, jcfg.cost_tap_chunk))(
                jnp.asarray(N(pk1)), jnp.asarray(N(warped)))) * 131072.0
        tc = t_dense.residual_costs(pk1, warped, cands, cost_cfg_t, False,
                                    chunk).numpy() * 131072.0
        k_of = {c: k for k, c in enumerate(cands)}
        gaps = []
        for y, x in zip(*np.nonzero(off)):
            # (dy, dx) of each package's choice
            kj = k_of[tuple(int(v) for v in jout[y, x, ::-1] - g[y, x, ::-1])]
            kt = k_of[tuple(int(v) for v in tout[y, x, ::-1] - g[y, x, ::-1])]
            gaps.append(abs(jc[kj, y, x] - jc[kt, y, x]))
            print(f"    ({y}, {x}) jax {cands[kj]} port {cands[kt]}: jax "
                  f"costs {jc[kj, y, x]:.0f} / {jc[kt, y, x]:.0f}, port "
                  f"{tc[kj, y, x]:.0f} / {tc[kt, y, x]:.0f}")
        gaps = np.asarray(gaps)
        print(f"  {name}: {gaps.size} decisions differ; the JAX package's "
              f"two costs equal at {(gaps == 0).sum()}, one step apart at "
              f"{(gaps == 1).sum()}, further at {(gaps > 1).sum()}; "
              f"{(jc != tc).mean():.3%} of the pass's costs differ",
              flush=True)

    t0 = time.perf_counter()
    # 1. prepare
    jl1, jp1 = jp._prep_stage(jnp.asarray(img1), jcfg)
    jl2, jp2 = jp._prep_stage(jnp.asarray(img2), jcfg)
    tl1, tp1 = tp.prepare_pyramids(T(img1), tcfg)
    tl2, tp2 = tp.prepare_pyramids(T(img2), tcfg)
    for i in range(len(jp1)):
        check(f"prepare level {i} frame 1", jl1[i], tl1[i], 0)
        check(f"prepare pack {i} frame 1", jp1[i], tp1[i], 0)
        check(f"prepare pack {i} frame 2", jp2[i], tp2[i], 0)
    L1, P1 = [T(x) for x in jl1], [T(x) for x in jp1]
    L2, P2 = [T(x) for x in jl2], [T(x) for x in jp2]
    top = len(P1) - 1

    # 2. coarse match
    key = jax.random.PRNGKey(jcfg.seed)
    jm1, jm2 = jp._match_stage_bidi(jl1[top], jl2[top], jp1[top], jp2[top],
                                    key, jcfg)
    chunk = tcfg.cost_tap_chunk
    if tcfg.match_engine == "dense":
        tm1, tm2 = match_coarse_bidi(L1[top], L2[top], tcfg.cost, tcfg.match,
                                     P1[top], P2[top], tap_chunk=chunk)
    else:
        s = tuple(ThreefrySampler(k) for k in split(prng_key(tcfg.seed)))
        tm1 = patchmatch(P1[top], P2[top], s[0], tcfg.patchmatch, tcfg.cost,
                         chunk)
        tm2 = patchmatch(P2[top], P1[top], s[1], tcfg.patchmatch, tcfg.cost,
                         chunk)
    for d, (jm, tm) in enumerate(((jm1, tm1), (jm2, tm2))):
        for nm, a, b in zip(("tx", "ty", "cost"), jm, tm):
            check(f"match dir {d + 1} {nm}", a, b, 0)
    m = [T(x) for x in (*jm1, *jm2)]

    # 3. clean-up, each op on JAX's input
    lr = jax.jit(j_ref.lr_check, static_argnames=("thresh",))
    jlr = lr(*jm1, *jm2, thresh=jcfg.lr_thresh)
    tlr = t_ref.lr_check(*m, tcfg.lr_thresh)
    for nm, a, b in zip(("tx1", "ty1", "c1"), jlr, tlr):
        check(f"lr_check {nm}", a, b, 0)
    jo = jax.jit(j_ref.outlier_removal, static_argnames=("cfg",))(
        *jlr[:3], cfg=jcfg.refine)
    to = t_ref.outlier_removal(*[T(x) for x in jlr[:3]], tcfg.refine)
    for nm, a, b in zip(("tx", "ty", "cost"), jo, to):
        check(f"outlier_removal {nm}", a, b, 0)
    jocc = jax.jit(j_wmf.coarse_occlusion_reconstruct,
                   static_argnames=("rcfg", "cost_cfg"))(
        jo[0], jo[1], jl1[top], rcfg=jcfg.refine,
        packs=(jp1[top], jp2[top]), cost_cfg=jcfg.cost,
        orig=(jm1[0], jm1[1]))
    tocc = coarse_occlusion_reconstruct(
        T(jo[0]), T(jo[1]), L1[top], tcfg.refine, packs=(P1[top], P2[top]),
        cost_cfg=tcfg.cost, orig=(m[0], m[1]))
    check("occlusion tx", jocc[0], tocc[0], 0)
    check("occlusion ty", jocc[1], tocc[1], 0)
    jflow = jax.jit(j_ref.nnf_to_flow)(*jocc)
    staged = jp._coarse_refine_stage(jm1, jm2, jl1[top], jcfg, jp1[top],
                                     jp2[top])
    check("coarse flow (staged vs ops)", staged, jflow)
    check("coarse flow", jflow, t_ref.nnf_to_flow(*[T(x) for x in jocc]))

    # 4. the finer levels
    r = 1.0 / tcfg.pyramid.ratio
    n = tcfg.dense_refine_passes
    if tcfg.refine_impl != "dense" or tcfg.subpixel_refine:
        raise SystemExit("the finer levels are compared for the dense "
                         "refine without the subpixel stage")
    for lvl in range(top - 1, -1, -1):
        oh, ow = jp1[lvl].shape[0], jp1[lvl].shape[1]
        up = bilinear_resize(T(jflow), oh, ow, r) * r
        jf = jp._refine_pass_stage(jflow, jp1[lvl], jp2[lvl], jcfg, oh, ow,
                                   False)
        tf = dense_refine_flow(up, P1[lvl], P2[lvl], tcfg.cost,
                               tcfg.dense_search_radius,
                               tcfg.dense_cand_shape, tcfg.warp_dtype,
                               tcfg.dense_pass1_planes, tap_chunk=chunk)
        check(f"level {lvl} pass 1", jf, tf)
        if args.ties:
            ties(f"level {lvl} pass 1", up, P1[lvl], P2[lvl], jcfg.cost,
                 tcfg.cost, tcfg.dense_cand_shape, jf, tf)
        for _ in range(n - 1):
            med = median3_flow(T(jf))
            jf2 = jp._refine_pass_stage(jf, jp1[lvl], jp2[lvl], jcfg, oh, ow,
                                        True)
            tf = dense_refine_flow(med, P1[lvl], P2[lvl], tcfg.pass2_cost,
                                   tcfg.dense_search_radius,
                                   tcfg.pass2_cand_shape, tcfg.warp_dtype,
                                   tcfg.dense_pass2_planes, tap_chunk=chunk)
            check(f"level {lvl} pass 2", jf2, tf)
            if args.ties:
                ties(f"level {lvl} pass 2", med, P1[lvl], P2[lvl],
                     jcfg.pass2_cost, tcfg.pass2_cost,
                     tcfg.pass2_cand_shape, jf2, tf)
            jf = jf2
        js = jp._smooth_stage(jf, jl1[lvl], jcfg)
        check(f"level {lvl} smoothing", js,
              flow_smoothing_auto(T(jf), L1[lvl], tcfg.refine))
        jflow = js
    jfinal = jp._smooth_stage(jflow, jl1[0], jcfg)
    check("final smoothing", jfinal,
          flow_smoothing_auto(T(jflow), L1[0], tcfg.refine))
    print(f"stages done in {time.perf_counter() - t0:.0f} s", flush=True)

    # 5. the staging against the one program, and the whole port
    if not args.no_final:
        one = jp.compute_flow_jit(jnp.asarray(img1), jnp.asarray(img2), None,
                                  jcfg)
        check("jax staged vs compute_flow_jit", one, jfinal)
        check("port compute_flow vs compute_flow_jit", one,
              tp.compute_flow(T(img1), T(img2), tcfg))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
