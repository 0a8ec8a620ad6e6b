"""Configuration of the PyTorch port — a copy of ``eppm_tpu/config.py``.

The class names, fields, defaults and field order are those of the JAX
package, so ``config_fingerprint`` hashes both trees alike and a config
built for one package runs the other (``config_from_dict``).  The only
difference is ``EPPMConfig.warp_dtype``, which names a torch dtype.  The
port cannot import the JAX package's module: ``import eppm_tpu`` imports
jax, which the GPU host does not have.  The field comments are the JAX
package's: every time they quote was measured on a TPU v5e, none on a GPU.

The reference implementation (linchaobao/EPPM) hardcodes every parameter as a
compile-time ``#define`` in ``defs.h:31-91`` plus a handful of kernel-local
macros.  Here they become frozen dataclasses so runs are configurable from the
CLI / Python while the defaults reproduce the reference binary exactly.

Reference parameter provenance (file:line in the reference repository):
  - pyramid:      defs.h:31-34   (PYR_MAX_DEPTH=3, PYR_MIN_WIDTH=20, PYR_RATIO=0.5)
  - patchmatch:   defs.h:36-48   (SEARCH_RANGE=30, SEARCH_RADIUS_MIN=1,
                                  NUM_RAND_GUESS=6, PATCH_R=9, NUM_ITER=10,
                                  PM_SIG_S=0.5*PATCH_R, PM_SIG_R=0.1)
  - cost:         defs.h:51-52   (LAMBDA_AD=0.1, LAMBDA_CENSUS=0.3)
                  bao_pmflow_kernel.cu:32 (CENSUS_MAX_DIFF=8)
  - refinement:   defs.h:58-68   (WMF_RADIUS=4, WMF_SIG_S=4.0, WMF_SIG_R=0.02,
                                  POSTPROC_BLF_SIG_S=5, STAT_RADIUS=6)
                  bao_pmflow_refine_kernel.cu:146-147 (STAT_COUNT_THRESH,
                  STAT_SIM_THRESH=2), :752 (POSTPROC_BLF_SIG_R=0.02)
  - subpixel:     defs.h:72-76
  - invalid flow: defs.h:84-91   (UNKNOWN_FLOW=1e10, UNKNOWN_FLOW_THRESH=1e9)
  - scaled PM:    defs.h:40-41   (PM_SCALE_RANGE=9, PM_SCALE_MIN=4)
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

# Sentinels, identical to the reference (defs.h:84-91,
# bao_pmflow_refine_kernel.cu:46).
UNKNOWN_FLOW = 1e10
UNKNOWN_FLOW_THRESH = 1e9
INVALID_LOCATION = -10000
FLT_MAX = 3.402823466e38


@dataclasses.dataclass(frozen=True)
class PyramidConfig:
    """Coarse-to-fine pyramid (defs.h:31-34)."""

    max_depth: int = 3
    ratio: float = 0.5
    # Used by level_dims_min_width (the reference's alternative
    # bao_pyr_init_dim overload); the default pipeline derives depth from
    # max_depth exactly as the reference binary does.
    min_width: int = 20
    # Auto-deepening cap: extra levels beyond max_depth while the
    # coarsest level's min dimension still exceeds this (0 disables).
    # The reference's fixed depth 3 was tuned for its hardcoded 640x480
    # (coarse 160x120, main.cpp:38); at 1080p that leaves a 480x270
    # coarse level where the match engine + occlusion WMF burn ~60% of
    # the frame.  Capping the coarse level at ~160 px reproduces the
    # reference's coarse-size philosophy at every input size (and is the
    # reference's own min-width bao_pyr_init_dim overload in spirit,
    # basic/bao_basic.h:179-198).  640x480-class inputs are unaffected
    # (depth stays 3); search coverage at full resolution grows with the
    # extra levels, which large-displacement 1080p+ content needs anyway.
    auto_depth_dim: int = 160
    # Pre-smoothing before pyramid construction
    # (bao_pmflow_refine_kernel.cu:1063-1064: sigma=0.5, radius=2).
    presmooth_sigma: float = 0.5
    presmooth_radius: int = 2

    def depth(self, h: int, w: int) -> int:
        """Effective depth: max_depth, auto-deepened for large inputs
        (see auto_depth_dim)."""
        d = max(self.max_depth, 1)
        if self.auto_depth_dim > 0:
            while (
                int(min(h, w) * self.ratio ** (d - 1)) > self.auto_depth_dim
            ):
                d += 1
        return d

    def level_dims(self, h: int, w: int) -> Tuple[Tuple[int, int], ...]:
        """Per-level (h, w), level 0 = full resolution.

        Mirrors the max-depth ``bao_pyr_init_dim`` overload the reference
        pipeline uses (basic/bao_basic.h:201-211, called at
        bao_flow_patchmatch_multiscale_cuda.cpp:116): dims are
        ``int(h * ratio**i)`` — truncation, not rounding.
        """
        return tuple(
            (int(h * self.ratio**i), int(w * self.ratio**i))
            for i in range(self.depth(h, w))
        )

    def level_dims_min_width(self, h: int, w: int) -> Tuple[Tuple[int, int], ...]:
        """Depth-from-min-width variant (the reference's other
        ``bao_pyr_init_dim`` overload, basic/bao_basic.h:179-198): level
        count = log(min_width / w) / log(ratio), at least 1."""
        import math as _math

        n = int(_math.log(max(self.min_width, 1) / w) / _math.log(self.ratio))
        n = max(n, 1)
        return tuple(
            (int(h * self.ratio**i), int(w * self.ratio**i))
            for i in range(n)
        )


@dataclasses.dataclass(frozen=True)
class CostConfig:
    """Bilateral AD+census patch cost (bao_pmflow_kernel.cu:255-301)."""

    patch_radius: int = 9          # PATCH_R (defs.h:44)
    # Tap grid stride over the (2R+1)^2 patch.  Reference value: 2
    # ("skip pixels", bao_pmflow_kernel.cu:269-272) — but that grid
    # {-9,-7,...,7,9} samples only odd offsets and EXCLUDES the center
    # pixel.  Default 3 ({-9,-6,-3,0,3,6,9}, 49 taps) includes the
    # center and measures dramatically better EPE on every synthetic
    # case (mean 0.348 vs 0.563 across QUALITY.md cases) at half the
    # arithmetic; the reference's own README notes its parameters
    # differ from the benchmarked ones (README.md:14), and the
    # acceptance bar is EPE.  Set 2 to reproduce the reference grid.
    patch_stride: int = 3
    sigma_spatial: float = 4.5     # PM_SIG_S = 0.5*PATCH_R (defs.h:47)
    sigma_range: float = 0.1       # PM_SIG_R (defs.h:48)
    lambda_ad: float = 0.1         # LAMBDA_AD (defs.h:51)
    lambda_census: float = 0.3     # LAMBDA_CENSUS (defs.h:52)
    census_max_diff: int = 8       # CENSUS_MAX_DIFF (bao_pmflow_kernel.cu:32)

    @property
    def tap_offsets(self) -> Tuple[Tuple[int, int], ...]:
        """(dy, dx) tap offsets: -R..R with stride 2 -> 10x10 = 100 taps."""
        r, s = self.patch_radius, self.patch_stride
        rng = range(-r, r + 1, s)
        return tuple((i, j) for i in rng for j in rng)


@dataclasses.dataclass(frozen=True)
class PatchMatchConfig:
    """PatchMatch loop (defs.h:36-45, bao_pmflow_kernel.cu:1760-1826)."""

    num_iters: int = 10            # NUM_ITER (defs.h:45)
    num_random_guesses: int = 6    # NUM_RAND_GUESS (defs.h:38)
    search_range: int = 30         # SEARCH_RANGE (defs.h:36)
    search_radius_min: int = 1     # SEARCH_RADIUS_MIN (defs.h:37)
    # TPU-native propagation: the reference's sequential 10-px segmented
    # scanline sweeps (bao_pmflow_kernel.cu:979-1181) are restructured as
    # Jacobi jump-flood rounds (the reference ships its own jump-flood
    # variant at bao_pmflow_kernel.cu:800-857, proving the substitution is
    # algorithmically acceptable).  Each round tries the 4 axial neighbors
    # at each step distance, carrying the neighbor's *offset*.
    prop_steps: Tuple[int, ...] = (8, 4, 2, 1)

    def search_mags(self) -> Tuple[int, ...]:
        """Shrinking search-window magnitudes, one per random guess.

        Mirrors bao_pmflow_kernel.cu:1534,1564: start at SEARCH_RANGE and
        halve while mag/2 >= SEARCH_RADIUS_MIN.
        """
        mags = []
        mag = self.search_range
        for _ in range(self.num_random_guesses):
            mags.append(mag)
            if mag // 2 >= self.search_radius_min:
                mag //= 2
        return tuple(mags)


@dataclasses.dataclass(frozen=True)
class MatchConfig:
    """Dense coarse-level matcher (ops/match.py) — the TPU-native engine
    replacing PatchMatch's sequential per-pixel search.  PatchMatch's
    global random init becomes a global MXU descriptor argmax; its
    propagate/random-search refinement becomes dense residual sweeps on a
    mini-pyramid."""

    # Extra pyramid levels below the coarse level (160x120 -> 80x60 ->
    # 40x30 for the default 2); levels whose min dim would drop below
    # ``min_level_dim`` are skipped.
    descent_levels: int = 2
    min_level_dim: int = 24
    # Residual search radius per descent sweep.
    descent_radius: int = 3
    # Dense jump-flood propagation rounds at the coarse level: each round
    # tries the 4 axial neighbors' offsets at this step distance plus the
    # 3x3 flow median, kept on true-cost improvement.  The doubled-tail
    # schedule measurably improves large-displacement recovery (60 px
    # case: 0.66 -> 0.48 EPE) for ~4 ms.
    prop_steps: Tuple[int, ...] = (16, 8, 4, 2, 1, 1)
    # Patch radius for mini-level sweeps (full-size patches span most of a
    # mini level and lose discrimination); stride 1.
    mini_patch_radius: int = 4
    # Final polish sweep radius at the coarse level (0 disables);
    # radius 3 measures ~0.05 px better EPE than 2 on every synthetic
    # case for ~8 ms.
    final_radius: int = 3
    # Exact-cost polish after the warp-approximated sweeps (0 disables):
    # rescores the (2r+1)^2 neighborhood of the final match with the
    # *gathered* patch cost (ops/cost.py patch_cost, the PatchMatch
    # oracle).  The warp-once evaluation is direction-asymmetric (fwd
    # warps frame 2, bwd warps frame 1), which desynchronizes the
    # fwd/bwd argmins by +-1 px wherever the true displacement is
    # fractional at coarse scale; the exact cost is symmetric
    # (cost(p,q) == cost(q,p)), so this final step restores the strict
    # left-right consistency the reference engine has
    # (bao_pmflow_refine_kernel.cu:51 DIFF_THRESH=0) and lets
    # EPPMConfig.lr_thresh return to 0 for the dense engine.
    exact_polish_radius: int = 1
    # Exact-cost jump-flood propagation after the polish: each round
    # tries the 4 axial neighbors' offsets at the given step distance,
    # scored with the same gathered cost, kept on strict improvement.
    # Where the true displacement is fractional at coarse scale, the
    # per-pixel exact argmins fragment into a salt-and-pepper mix of the
    # two nearest integers; strictly-improving propagation spreads the
    # locally cheapest choice into coherent regions — the role
    # PatchMatch's propagation plays for the reference engine
    # (bao_pmflow_kernel.cu:979-1181) — which both raises left-right
    # survival and clusters the survivors.
    # Measured (synthetic sweep + Grove): one step-2 round plus the
    # median-consensus round below matches (2, 1) + 2 rounds on every
    # case (mean EPE 0.348 vs 0.350) at ~40% fewer exact-stage gather
    # rounds, so the lighter schedule is the default.
    exact_prop_steps: Tuple[int, ...] = (2,)
    # Tap stride of the exact-stage cost (patch radius unchanged).  The
    # exact scores are only ever COMPARED (polish/propagation argmins and
    # the returned cost feeds nothing but FLT_MAX bookkeeping), so a
    # sparser grid than the reference's stride-2 pixel skipping is
    # admissible; what matters for lr_thresh=0 is that both directions
    # share one symmetric metric.  4 -> 25 taps vs 100: quarters the
    # gather volume of the exact stage; measured slightly BETTER EPE
    # than stride 2/3 on every synthetic case (the sparse grid spans the
    # same radius with less redundancy).
    exact_tap_stride: int = 4
    # Consensus relaxation rounds after exact propagation: the candidate
    # is the 3x3 median of the offset field, adopted when its exact cost
    # is EQUAL or better (quantized costs make exact ties common where
    # the true displacement is fractional; adopting at equality pulls
    # isolated tie-breaks toward the regional majority without ever
    # increasing cost).  This reproduces the clustered decision structure
    # PatchMatch propagation produces, which the downstream outlier
    # removal + occlusion WMF need to reconstruct occluded regions well.
    exact_median_rounds: int = 1
    # Global descriptor matching: tap grid and feature scaling.
    desc_radius: int = 8
    desc_tap_stride: int = 4
    desc_sigma_spatial: float = 6.0
    desc_census_scale: float = 0.1
    # Frame-2 pixels scored per MXU block in the global argmax.
    global_block: int = 2048
    # Above this many coarse pixels the global proposal grid subsamples
    # by 2 on both frames (N^2 argmax cost; the 1-px proposal loss is
    # recovered by the final polish sweep).  30000 (round-5, was 40000):
    # the cost is NOT the matmul (chip-measured free at 32.4k targets)
    # but the HBM score-panel traffic of the argmax reduction — 4.2 GB
    # at 32.4k^2, ~10 ms one-way / ~21 ms bidi; stride 2 cuts it 16x.
    # 1080p's 135x240 coarse level (32.4k) now strides; 640x480-class
    # (19.2k) and the eval-set coarse levels (<28k) keep stride 1, so
    # dossier numbers are unaffected.  1080p quality re-checked at the
    # flip (PERF.md round-5).
    global_stride_threshold: int = 30000
    # Also run the global matcher at full coarse resolution and merge by
    # true-cost argmin (large-displacement recall).
    global_at_coarse: bool = True
    # Temporal warm start (video streaming).  When the pipeline is given
    # an ``init_flow`` (the previous pair's flow), the coarse matcher
    # always rescores it with the true cost and merges it by per-pixel
    # argmin — a pure-quality proposal.  With ``warm_skip_global`` the
    # matcher additionally skips the global descriptor stages (the
    # tiny-level argmax + mini-pyramid descent + coarse proposals):
    # their large-displacement-recall duty is covered by the warm
    # proposal for temporally coherent video, and what remains
    # (propagation + polish + exact stage) re-acquires motion changes up
    # to the propagation span per frame.  The reference has no streaming
    # mode at all (main.cpp processes one hardcoded pair).
    warm_skip_global: bool = True


@dataclasses.dataclass(frozen=True)
class RefineConfig:
    """Post-PM refinement chain (defs.h:58-68, bao_pmflow_refine_kernel.cu)."""

    # Left-right check tolerance in pixels; None = engine-matched auto
    # (see EPPMConfig.lr_thresh): 0 for the patchmatch engine exactly
    # like the reference (bao_pmflow_refine_kernel.cu:51), 1 for the
    # dense engine, whose warp-approximated evaluation carries +-1 px of
    # direction-dependent quantization (the reference's own buffered
    # variant runs at 50, :95-140).
    lr_diff_thresh: "int | None" = None
    # Outlier removal (defs.h:68, bao_pmflow_refine_kernel.cu:146-147)
    stat_radius: int = 6
    stat_sim_thresh: int = 2
    # Proportional survival threshold: a pixel survives when its similar
    # count reaches half the *valid* (in-image, non-invalidated) window
    # population, max(valid//2, 4), instead of the reference's fixed
    # (2R+1)^2/2.  Identical to the reference wherever the window is
    # fully valid; differs where a strict left-right check has
    # invalidated most of a region (the fixed threshold then also culls
    # the scattered consistent survivors).  Default False: the fixed
    # reference threshold measures better on every quality case — its
    # aggressive pruning of half-valid regions lets the occlusion WMF
    # reconstruct from coherent clusters — with the collapse guard below
    # as the safety net.
    stat_proportional: bool = False
    # Collapse guard (fixed-threshold mode only): when fixed culling
    # would leave under this fraction of the previously-valid pixels, the
    # whole frame switches to the proportional threshold instead — a
    # per-frame torch.where, no recompile.  Guards the failure mode where
    # fwd/bwd integer rounding of a fractional true displacement fails
    # the strict LR check almost everywhere and fixed culling then wipes
    # the scattered survivors, collapsing the frame to unknown flow.
    # 0 disables.
    stat_collapse_guard: float = 0.1
    # Weighted median filter (defs.h:58-60)
    wmf_radius: int = 4
    wmf_sigma_spatial: float = 4.0
    wmf_sigma_range: float = 0.02
    # Occlusion-only WMF iterations at the coarse level.  The reference
    # runs 20 (compute_flow .cpp:239); measured here the Jacobi filter
    # reaches its fixed point by iteration 2 on 240x320 occlusion cases
    # and by 5 on a 1080p layered case (bit-identical EPE/bad3 for 5 vs
    # 20 at both scales; 0 is clearly worse, 2.05 vs 1.76 mean EPE), so
    # the default keeps a 2.5x margin over measured convergence at 4x
    # less work.  --set refine.wmf_coarse_iters=20 restores the
    # reference schedule.
    wmf_coarse_iters: int = 5
    # Occlusion reconstruction order at the coarse level.  False = the
    # reference-faithful order (occlusion WMF then hole fill); True =
    # fill-then-polish (ops/pallas_wmf.py::wmf_polish_occlusions):
    # holes are initialized by the 4-direction color-nearest fill, then
    # ONE frozen-valid WMF iteration per dilation pass re-medians each
    # hole from originally-valid data (one iteration is that pass's
    # fixed point, so wmf_coarse_iters does not apply on this path).  Rationale: the reference's in-place
    # sequential WMF diffuses across an occluded band in few passes; a
    # clean Jacobi port needs ~band/radius passes and compounds errors
    # inward (layered stress case: 6.7 px mean band error after 5
    # Jacobi iterations vs ~bg-level error with fill-first — see
    # EVAL.md / PERF.md round-4 notes).  Default True since round 4
    # (layered 3.157 -> 2.300 final EPE, QUALITY sweep neutral); False
    # restores the reference-faithful order.
    wmf_fill_first: bool = True
    # Dilation schedule of the fill-first polish cascade (coarse to
    # fine; each entry is one frozen-valid WMF pass with window offsets
    # scaled by the entry).  Default (1,): with the two-pass corner
    # fill, deeper schedules measured NO quality win anywhere ((16,4,1)
    # vs (1,): zoom_rot 0.637 vs 0.613, layered 2.295 vs 2.300, every
    # QUALITY case identical) while costing two extra kernel launches +
    # bilateral-weight precomputes per frame (~15 ms of the 1080p
    # budget).  Ungated dilated medians are additionally WRONG on
    # two-layer content whose coarse textures homogenize ((4,1) 2.91 vs
    # 2.59 ungated) — the agreement gate below keeps any dilated entry
    # safe if a user config enables one.
    wmf_polish_dilations: Tuple[int, ...] = (1,)
    # Agreement gate of the dilated (>1) polish passes: a hole adopts a
    # dilated median only if it agrees with its current fill hypothesis
    # within this many pixels per component (0 = ungated).  Border
    # bands at large translations: the median agrees within +-1 and
    # denoises; two-layer occlusions with homogenized coarse colors:
    # the mixed-layer median jumps far from the one-sided fill and is
    # rejected.
    wmf_polish_accept_thresh: float = 3.0
    # Patch radius of the fill-first hole fill's color test: 0 = the
    # reference's single-pixel max-channel difference; r > 0 = mean
    # (2r+1)^2 patch SAD between the hole's and the candidate source's
    # neighborhoods (texture comparison — decides reliably where
    # single-pixel color is one noisy sample, e.g. textures that
    # homogenize at the coarse level).  Only the fill-first path uses
    # it; the legacy WMF-then-fill path stays reference-faithful.
    # Default 1: radius 2 measured only noise-level better on layered
    # (2.502 vs 2.517) at ~3x the gather count — the fill's per-tap
    # gathers are a fixed coarse-level cost on every frame.
    fill_patch_radius: int = 1
    # First-order (linear-extrapolating) fill baseline, in pixels.
    # 0 = the reference's constant fill (refine_kernel.cu:297-371).
    # b > 0: the adopted value extrapolates the chosen side's per-
    # component slope (estimated over b and 2b px behind the nearest
    # valid pixel, accepted only where the two estimates agree — see
    # ops/refine.py::fill_holes).  Constant-flow regions measure slope
    # ~0 twice and behave exactly like the reference; smoothly-varying
    # fields (zoom/rotation border wedges) are extrapolated instead of
    # flattened.
    # Default 6 (round-5): measured on the tuning evalset —
    # zoom_rot 0.680 -> 0.535, layered 2.180 -> 2.169, grove_layered
    # 0.517 -> 0.515, every other case bit-identical EXCEPT
    # large_disp_120 0.154 -> 0.183 (+0.03: residual slope noise times
    # a 30-px constant band; accepted against the -0.145 zoom_rot win —
    # see PERF.md round-5 notes; 0 restores the reference fill).
    # b=2 and b=4 are no-ops/marginal: integer NNF quantization hides
    # sub-1/(2b) slopes, and real coarse-level zoom/rot slopes are
    # ~0.05-0.1 px/px.
    fill_linear_baseline: int = 6
    # Agreement gate of the linear fill's two half-segment slope
    # estimates (px/px): disagreement falls back to the constant fill.
    # 0.2 passes a true smooth field's staircase estimates at b=6
    # (multiples of 1/6 differ by 0 or 0.167) while rejecting the
    # oscillating-noise pattern (+1/6 vs -1/6 = 0.33) that injected
    # ramps into constant-field borders (large_disp_120 0.154->0.183 at
    # the looser 0.35 during bring-up).
    fill_linear_slope_tol: float = 0.2
    # Photometric arbitration of the fill (0 disables): every hole
    # evaluates the TRUE bilateral AD+census patch cost of each
    # directional fill candidate (plus its own pre-LR match) against
    # frame 2, and where the best candidate's cost is below this
    # threshold the hole adopts the photometric argmin instead of the
    # color pick.  Rationale (tools/layered_diag.py): over half the
    # foreground is invalidated by the strict LR check + outlier
    # removal although it is VISIBLE in both frames — for those pixels
    # frame-2 appearance identifies the right candidate, while truly
    # occluded pixels (no frame-2 evidence, all costs high) keep the
    # color/majority decision, where photometric voting would
    # systematically pick the WRONG layer (the round-4 negative
    # result).  Candidates: the 4 directional fill sources plus the
    # pixel's own pre-LR match, the latter gated by directional
    # corroboration (ops/pallas_wmf.py::_photometric_arbitrate).
    # Cost units: normalized AD+census in [0, 2].  Measured (tuning
    # evalset, CPU, round 5): 0.6 -> layered 2.169->2.112,
    # large_disp_120 0.183->0.212, zoom_rot 0.535->0.534; 1.0
    # over-admits catastrophically (large_disp_120 -> 3.06, zoom_rot
    # -> 1.56 — occluded borders sneak under a loose gate); an
    # UN-corroborated pre-LR candidate at 0.6 buys layered 2.00 but
    # costs large_disp_120 1.18 (rejected trade — the corroboration
    # gate keeps the safe subset).  0 restores the pure color fill.
    fill_photometric_thresh: float = 0.6
    # Majority-correction rounds after the fill-first reconstruction:
    # iterated 3x3 component medians over ALL values, applied to the
    # was-invalid set only.  Wrong scanline-fill picks are streak-
    # correlated; a few median rounds let the correct majority
    # overwrite wrong streaks.  0 disables.  Measured on layered
    # (tools/layered_diag.py): 3 rounds 2.330, 6 rounds 2.300, 12
    # rounds 2.288 final EPE — 6 is the knee.
    fill_median_rounds: int = 6
    # Full-image WMF passes after hole filling at the coarse level
    # (0 disables).  No reference counterpart at the coarse level, but
    # the reference *intended* a full-image WMF at fine levels (the dead
    # call at .cpp:281 — see pipeline.py fidelity note); running it once
    # at the coarse level is the cheapest point to clean the +-1
    # integer-rounding noise that fractional true displacements leave in
    # the valid (non-occluded) pixels.
    wmf_coarse_full_iters: int = 0
    # Post-process joint bilateral flow smoothing
    # (defs.h:64, bao_pmflow_refine_kernel.cu:752-753)
    blf_sigma_spatial: float = 5.0
    blf_sigma_range: float = 0.02

    @property
    def stat_count_thresh(self) -> int:
        d = 2 * self.stat_radius + 1
        return (d * d) // 2

    @property
    def blf_radius(self) -> int:
        return int(2 * self.blf_sigma_spatial)


@dataclasses.dataclass(frozen=True)
class SubpixelConfig:
    """Subpixel refinement (defs.h:72-76); declared-but-unused in the
    reference default path (bao_pmflow_refine_kernel.cu:393-722)."""

    up_factor: float = 2.0
    patch_radius: int = 9
    sigma_spatial: float = 9.0
    sigma_range: float = 0.2
    neighborhood_radius: int = 2   # SUBPIX_NEIG_RADIUS (refine_kernel.cu:395)


@dataclasses.dataclass(frozen=True)
class EPPMConfig:
    """Top-level configuration; defaults reproduce the reference binary."""

    pyramid: PyramidConfig = PyramidConfig()
    cost: CostConfig = CostConfig()
    patchmatch: PatchMatchConfig = PatchMatchConfig()
    match: MatchConfig = MatchConfig()
    refine: RefineConfig = RefineConfig()
    subpixel: SubpixelConfig = SubpixelConfig()
    seed: int = 1234               # reference cuRAND seed (bao_pmflow_kernel.cu:68)
    max_flow: float = 200.0        # MAX_FLOW_VAL (defs.h:54), cutoff disabled
                                   # in the default path (.cpp:288)

    # Memory knob: taps evaluated per scan step inside the cost evaluator;
    # bounds peak HBM for full-resolution candidate evaluation.
    cost_tap_chunk: int = 25

    @property
    def pass2_cost(self) -> CostConfig:
        """Cost config of refine passes after the first
        (dense_pass2_tap_stride / dense_pass2_patch_radius)."""
        stride = self.dense_pass2_tap_stride or self.cost.patch_stride
        radius = self.dense_pass2_patch_radius or self.cost.patch_radius
        if (stride, radius) == (self.cost.patch_stride,
                                self.cost.patch_radius):
            return self.cost
        return dataclasses.replace(
            self.cost, patch_stride=stride, patch_radius=radius
        )

    @property
    def pass2_cand_shape(self) -> str:
        return self.dense_pass2_cand_shape or self.dense_cand_shape

    @property
    def warp_dtype(self):
        """Gather dtype for the fine-level warp (dense_warp_bf16)."""
        if self.dense_warp_bf16:
            import torch

            return torch.bfloat16
        return None

    @property
    def lr_thresh(self) -> int:
        """Effective left-right tolerance (see RefineConfig.lr_diff_thresh).

        The reference runs strict (0, bao_pmflow_refine_kernel.cu:51).
        The dense engine can only afford strict checking when its final
        match is scored with the symmetric exact cost
        (MatchConfig.exact_polish_radius); with warp-approximated scores
        the fwd/bwd argmins carry +-1 px of direction-dependent
        quantization and strict checking invalidates whole textured
        regions wherever the true coarse displacement is fractional.
        """
        if self.refine.lr_diff_thresh is not None:
            return self.refine.lr_diff_thresh
        if self.match_engine == "patchmatch":
            return 0
        return 0 if self.match.exact_polish_radius > 0 else 1

    # Coarse-level matching engine:
    #   "dense"      — global MXU descriptor argmax + dense residual
    #                  descent (ops/match.py); the TPU-native default.
    #   "patchmatch" — random init + jump-flood propagation + random
    #                  search (ops/patchmatch.py), faithful to the
    #                  reference's search structure.
    match_engine: str = "dense"

    # Fine-level refinement implementation:
    #   "dense"  — TPU-native warp-once + dense residual search
    #              (ops/dense.py); zero data-dependent gathers in the
    #              search, the default and the fast path on TPU.
    #   "gather" — per-pixel target gathers, bit-faithful to the
    #              reference kernel (ops/refine.py blf_refine_flow).
    refine_impl: str = "dense"
    # Residual search radius for the dense path (reference re-search grid
    # is 3x3 == radius 1; radius 2 widens recovery from warp error).
    dense_search_radius: int = 1
    # Candidate set shape within that radius: "square" = full (2r+1)^2
    # grid (the reference's 3x3 re-search); "plus" = the L1 ball (5
    # candidates at r=1, ~1.8x less refine arithmetic; diagonals resolve
    # over the iterative-warping passes).  Measured on the synthetic
    # sweep: plus = mean EPE 0.360 vs square 0.350 (worst case +0.042 on
    # 25 px translation) — a speed knob, not the default.
    dense_cand_shape: str = "square"
    # Optional subpixel refinement (quadratic fit on a half-pixel cost
    # grid, ops/subpixel.py) after the last integer refine.  The
    # reference allocates buffers for this stage but never calls it in
    # its default path (.cpp:135-136) — default off to match.  Measured:
    # helps fractional-motion fields (affine 0.518 -> 0.447, rotation
    # 0.487 -> 0.395) but regresses integer motion (5 px translation
    # 0.264 -> 0.567); see dense_subpixel_fit for the free alternative.
    subpixel_refine: bool = False
    # Near-free subpixel: 1-D parabola per axis through the residual
    # search's own 3x3 costs where the center candidate wins
    # (ops/dense.py), applied on the last refine pass of level 0 only.
    # Zero extra cost evaluations.  Measured (PERF.md): small gain on
    # fractional-motion fields (affine 0.492 vs 0.518), but the
    # texture-biased fractional noise costs more on integer motion
    # (mean 0.406 vs 0.348) — default off; the integer argmin + bilateral
    # smoothing is the better subpixel estimator overall.
    dense_subpixel_fit: bool = False
    # Confidence gate for dense_subpixel_fit: minimum axis curvature
    # (lo - 2*cc + hi of the 3-point cost parabola, normalized cost
    # units) for a fractional offset to be applied; below it the axis
    # keeps the integer argmin.  Round-3 verdict asked for exactly this
    # gate: the ungated fit's loss on integer motion is texture noise at
    # WEAK minima, so a curvature floor keeps the fractional gain where
    # the surface is clearly convex.  Measured sweep: PERF.md
    # ("confidence-gated subpixel").  Only meaningful with
    # dense_subpixel_fit=True.
    dense_subpixel_min_curv: float = 0.0
    # Iterative-warping passes per fine level: between passes the integer
    # flow is 3x3-median-filtered and frame 2 re-warped, making the
    # warp-approximated taps self-consistent (kills the +-1 px noise halo
    # the single-pass approximation leaves in mixed-flow regions).
    dense_refine_passes: int = 2
    # Plane-fitting hypotheses in passes after the first.  Pass 1 mirrors
    # the reference's plane-fitting re-search; later passes are our
    # iterative-warping stabilization (the reference has no equivalent),
    # where fronto-only costs measure equal quality at 3.5x less work.
    dense_pass2_planes: bool = False
    # Tap grid for passes after the first (0 = inherit cost values).
    # The stabilization passes re-rank a +-1 neighborhood on an already
    # self-consistent warp; a sparser CENTERED grid spanning nearly the
    # same patch reach keeps the rank structure at half the arithmetic
    # in the pipeline's single most expensive kernel.  radius 8 stride 4
    # = {-8,-4,0,4,8}^2, 25 taps — the center tap is load-bearing
    # (stride 4 at radius 9 excludes it and measured 2.3x worse on 5 px
    # translation, the same defect PERF.md documents for the reference's
    # stride-2 grid).  Quality at these defaults: QUALITY.md.
    dense_pass2_tap_stride: int = 4
    dense_pass2_patch_radius: int = 8
    # Candidate shape for passes after the first ("" = dense_cand_shape).
    dense_pass2_cand_shape: str = ""
    # Narrow the fine-level warp gather (the one data-dependent memory
    # access) to bfloat16.  The isolated gather measures ~25% faster at
    # 1080p and quality is EPE-neutral to three decimals, but end-to-end
    # the bf16 copy of pack2 (one materialization per refine pass) eats
    # the gain — measured 213.9 vs 211.7 ms staged 1080p — so the
    # default stays f32-exact.  Census integers are exact in bf16; RGB
    # keeps an 8-bit mantissa; all consumers of one warp see the same
    # rounded values, so cross-program consistency holds either way.
    dense_warp_bf16: bool = False
    # Plane-fitting hypotheses in pass 1 (the reference re-search,
    # bao_pmflow_kernel.cu:334-513, always evaluates all 4).  Measured on
    # the full synthetic sweep + Grove: fronto-only pass 1 is EPE-neutral
    # (mean 0.350 vs 0.349; Grove warp error 7.695 vs 7.713/255) at 4x
    # less arithmetic in the dominant fine-level stage — the +-1
    # re-search is too local for the affine hypotheses to change the
    # argmin.  Set True to score the reference's 4 hypotheses on this grid.
    dense_pass1_planes: bool = False


DEFAULT_CONFIG = EPPMConfig()

# The deployment of linchaobao/EPPM's own binary: one pair at a time at its
# hardcoded 640x480 (main.cpp:38), with the settings of defs.h:31-91 and the
# stage order of bao_flow_patchmatch_multiscale_cuda.cpp:217-315.  Every
# field whose comment above names the binary's value takes that value:
# the PatchMatch search, the stride-2 grid of 100 taps (no centre tap), the
# gathered plane-fitting re-search at the fine levels, the fixed depth 3,
# the strict LR check, no collapse guard, 20 occlusion-only WMF iterations
# and then the constant single-pixel scan-line fill (the fill-first keys
# below are the binary's values too, though only the fill-first order
# reads them).  What the port cannot reproduce, and why:
#   - propagation: jump-flood rounds (``patchmatch.prop_steps``) for the
#     sequential 10-px segmented scan lines (bao_pmflow_kernel.cu:979-1181),
#     a chain of dependent reads along each row that a data-parallel program
#     does not run; the binary ships a jump-flood variant itself (:800-857);
#   - draws: the JAX package's threefry stream from ``seed`` for cuRAND's
#     (seed 1234, bao_pmflow_kernel.cu:48-71), so that the port and
#     ``eppm_tpu`` draw alike; no cuRAND stream is reproduced;
#   - the occlusion WMF: Jacobi iterations (every pixel reads the previous
#     iteration) for the binary's in-place sweep, whose result depends on
#     the order its threads run in;
#   - arithmetic: the cost sums its taps in partial sums of
#     ``cost_tap_chunk`` and rounds every product alone, with a Cephes
#     exp, as the JAX package's program computes it (the binary's one
#     running sum is compiled with fused multiply-adds and CUDA's exp).
UPSTREAM_CONFIG = dataclasses.replace(
    DEFAULT_CONFIG,
    pyramid=dataclasses.replace(DEFAULT_CONFIG.pyramid, auto_depth_dim=0),
    cost=dataclasses.replace(DEFAULT_CONFIG.cost, patch_stride=2),
    refine=dataclasses.replace(
        DEFAULT_CONFIG.refine, lr_diff_thresh=0, stat_collapse_guard=0.0,
        wmf_coarse_iters=20, wmf_fill_first=False, fill_patch_radius=0,
        fill_linear_baseline=0, fill_photometric_thresh=0.0,
        fill_median_rounds=0,
    ),
    match_engine="patchmatch",
    refine_impl="gather",
)

# The reference's plane hypotheses on the port's grids and dense engine
# (Bao, Yang, Jin, CVPR 2014: linchaobao/EPPM re-searches its fine levels
# over fronto-parallel plus 3 fixed slant hypotheses, the least of the 4
# kept, bao_pmflow_kernel.cu:319-513, on its 100-tap grid by the gathered
# refine, as UPSTREAM_CONFIG runs it).  Every dense refine pass scores its
# candidates over the 4 frame-2 tap tables (kernel A's plane mode): pass 1
# on the radius-9 stride-3 grid of 49 taps, pass 2 on the radius-8 stride-4
# grid of 25.  Everything else is DEFAULT_CONFIG.
PLANES_CONFIG = dataclasses.replace(
    DEFAULT_CONFIG, dense_pass1_planes=True, dense_pass2_planes=True)


def config_fingerprint(cfg: EPPMConfig = DEFAULT_CONFIG) -> str:
    """Short stable hash of a full config tree.

    Equal to ``eppm_tpu.config.config_fingerprint`` of the same tree:
    dataclass repr is deterministic, covers every field recursively and
    names only the classes, which both packages share.
    """
    import hashlib

    return hashlib.sha256(repr(cfg).encode()).hexdigest()[:12]


def _from_dict(cls, d: dict):
    kwargs = {}
    for f in dataclasses.fields(cls):
        if f.name not in d:
            continue
        v = d[f.name]
        default = getattr(cls(), f.name)
        if dataclasses.is_dataclass(default):
            v = _from_dict(type(default), v)
        elif isinstance(default, tuple):
            v = tuple(v)
        kwargs[f.name] = v
    unknown = set(d) - {f.name for f in dataclasses.fields(cls)}
    if unknown:
        raise ValueError(f"unknown {cls.__name__} fields: {sorted(unknown)}")
    return cls(**kwargs)


def config_from_dict(d: dict) -> EPPMConfig:
    """Build the port's ``EPPMConfig`` from ``dataclasses.asdict`` of a
    config tree — the JAX package's or this one's.  The config (and the
    tables derived from it) is all the state the two packages share: the
    system has no learned weights."""
    return _from_dict(EPPMConfig, d)
