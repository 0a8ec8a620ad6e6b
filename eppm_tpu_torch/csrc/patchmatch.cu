// Kernel E: PatchMatch's gathered AD + census cost and its candidate fold
// on Hopper (sm_90a).
//
// It replaces no Pallas kernel: the JAX package computes this cost in XLA
// (eppm_tpu/ops/cost.py::_patch_cost_offsets).  It was added because the
// plain version (eppm_tpu_torch/ops/cost.py::patch_cost_offsets, then
// ops/patchmatch.py::_select_best) is several hundred small launches a
// call, ~90% of a PatchMatch pair's device time.  Per pixel p and
// candidate target c = (cx, cy), over the frame-1 taps d (in table order)
// and a frame-2 tap table e (e == d outside the plane tables):
//   p1 = P1(p + d)   (frame 1 edge-padded; a tile's halo honoured)
//   p2 = P2(clamp(c + e)),  c2 = P2(clamp(c))   (every frame-2 read clamped)
//   w    = ftz(exp(-(dr1^2 + dr2^2) * inv_sig_r2) * g(d)),
//          dr1 = maxabs3(P1(p) - p1), dr2 = maxabs3(c2 - p2)
//   term = (1 - exp(-ad^2 * inv_lam_ad2)) + lut[cen(p1) ^ cen(p2)],
//          ad = maxabs3(p1 - p2), lut the plain version's census_lut
//   cost = sum(w * term) / max(sum(w), 1e-30)
// with the taps summed in partial sums of `chunk` taps in table order and
// the partial sums added in chunk order from 0 (ops/cost.py::_chunk_sums),
// every product rounded alone (--fmad=false), exp the plain version's
// exp_cephes; the least over the tables (the plane-fitting cost).  The
// result is unquantized.  Then, in the fold modes, the K candidates are
// folded into the incumbent (tx, ty, cost) in candidate order, replacing
// it on a strictly lower cost only, so ties keep the incumbent
// (ops/patchmatch.py::_select_best).  Three modes, one launch a call:
//   * cost only: K candidate fields in, K costs out (the init, and the
//     gathered cost of the plane-fitting refine and line propagation);
//   * fold: K candidate fields in (the random search's guesses);
//   * propagation (step > 0): the 4 candidates are the axial neighbours'
//     targets at distance `step`, computed here as ops/patchmatch.py::
//     _neighbour_targets computes them (the neighbour's index clamped to
//     the field, its target less the step clamped to the field).
// The fold modes write fresh buffers: a round is Jacobi, so no pixel
// writes what another reads.
//
// What bounds it on the H100: the two exps a (candidate, pixel, tap).
// exp_cephes is a float32 polynomial whose multiply-adds round through
// float64 (fma32): ~19 conversions between float32 and float64 an exp, and
// an SM issues 16 of those a clock; the ~20 other float32 operations of a
// tap (two maxabs3 for the range weight, one for ad, squares, products,
// the flush, three sums) cost far less, and so do its reads: 16 B of frame
// 2 a tap from L1 (frame 2 is 307 KB at a 120x160 level and stays in L2),
// frame 1 from shared memory.  Kernel A bounds the same way.
// The design follows from the level's size: at 120x160 a thread per pixel
// would be 600 warps, under 5 an SM, and the exps' latency would show.  So
// a block takes a 32x2 tile of pixels and threadIdx.z spreads the
// candidates over its threads (K x 2 warps a block for K <= 8): 2400
// warps for K = 4.  The block stages its frame-1 tile with the taps' halo,
// the census table, the tap tables and the spatial weights in shared
// memory; each thread computes its candidates' costs, and for the fold
// one thread a pixel then walks the K costs, kept in shared memory, in
// candidate order.

#include "common.cuh"

#define PM_MAX_TAPS 256
#define PM_MAX_TABLES 4
#define PM_MAX_CANDS 32
#define PM_MAX_REACH 32      // frame-1 taps' reach: the tile's halo
#define PM_MAX_KZ 8          // candidate threads a pixel
#define PM_BX 32             // pixels of a block: 32 x 2
#define PM_BY 2
#define PM_PIX (PM_BX * PM_BY)
#define PM_LUT 256           // census XORs of two 8-bit signatures
#define PM_SMEM_DEFAULT 49152

struct PmArgs {
    const float4* pack1;     // (H1, W1) frame 1 with `halo` of context
    const float4* pack2;     // (H2, W2) frame 2
    const int* txs;          // (K, H, W) candidate targets, or null
    const int* tys;
    const int* in_tx;        // (H, W) incumbent, or null (cost only)
    const int* in_ty;
    const float* in_cost;
    int* out_tx;             // (H, W) folded state
    int* out_ty;
    float* out_cost;         // (H, W) folded, or (K, H, W) costs
    const int* offs;         // (T, 2) frame-1 taps, then (B, T, 2) tables
    const float* gws;        // (T,) spatial weights
    const float* lut;        // (256,) census term of each XOR
    int H1, W1, halo, H2, W2, H, W, K, step, T, B, chunk, R;
    float inv_sig_r2, inv_lam_ad2;
};

// Candidate k of pixel (y, x): the given field's, or in propagation mode
// the target of the neighbour in direction k of ((0, -s), (0, s), (-s, 0),
// (s, 0)) less that (dy, dx), clamped to the field.
__device__ __forceinline__ void candidate(const PmArgs& a, int k, int y,
                                          int x, int& cx, int& cy)
{
    if (a.step > 0) {
        const int dx = k == 0 ? -a.step : (k == 1 ? a.step : 0);
        const int dy = k == 2 ? -a.step : (k == 3 ? a.step : 0);
        const size_t n = (size_t)clampi(y + dy, a.H) * a.W +
                         clampi(x + dx, a.W);
        cx = clampi(a.in_tx[n] - dx, a.W);
        cy = clampi(a.in_ty[n] - dy, a.H);
    } else {
        const size_t i = ((size_t)k * a.H + y) * a.W + x;
        cx = a.txs[i];
        cy = a.tys[i];
    }
}

// int32 addition that wraps as torch's does (no signed overflow).
__device__ __forceinline__ int add_wrap(int a, int b)
{
    return (int)((unsigned)a + (unsigned)b);
}

__global__ void __launch_bounds__(PM_PIX * PM_MAX_KZ)
patchmatch_kernel(const PmArgs a)
{
    extern __shared__ float4 pm_smem[];
    const int TW = PM_BX + 2 * a.R, TH = PM_BY + 2 * a.R;
    float4* tile = pm_smem;
    float* lut = (float*)(tile + TH * TW);
    float* gws = lut + PM_LUT;
    int* offs = (int*)(gws + a.T);
    const bool fold = a.in_cost != nullptr;
    float* fold_cost = (float*)(offs + 2 * a.T * (1 + a.B));
    int* fold_tx = (int*)(fold_cost + a.K * PM_PIX);
    int* fold_ty = fold_tx + a.K * PM_PIX;

    const int pix = threadIdx.y * PM_BX + threadIdx.x;
    const int tid = threadIdx.z * PM_PIX + pix;
    const int nthreads = PM_PIX * blockDim.z;
    const int x0 = blockIdx.x * PM_BX, y0 = blockIdx.y * PM_BY;
    // frame 1 around the tile: row r, column c of the tile is the
    // field's (y0 - R + r, x0 - R + c), read at that place plus the halo,
    // clamped to the pack (the plain version's edge padding)
    for (int i = tid; i < TH * TW; i += nthreads) {
        const int r = i / TW, c = i - r * TW;
        tile[i] = a.pack1[(size_t)clampi(a.halo + y0 - a.R + r, a.H1) * a.W1
                          + clampi(a.halo + x0 - a.R + c, a.W1)];
    }
    for (int i = tid; i < PM_LUT; i += nthreads) lut[i] = a.lut[i];
    for (int i = tid; i < a.T; i += nthreads) gws[i] = a.gws[i];
    for (int i = tid; i < 2 * a.T * (1 + a.B); i += nthreads)
        offs[i] = a.offs[i];
    __syncthreads();

    const int x = x0 + threadIdx.x, y = y0 + threadIdx.y;
    const bool inside = x < a.W && y < a.H;
    const int u = (threadIdx.y + a.R) * TW + threadIdx.x + a.R;
    const float4 c1 = tile[u];
    if (inside) {
        for (int k = threadIdx.z; k < a.K; k += blockDim.z) {
            int cx, cy;
            candidate(a, k, y, x, cx, cy);
            const float4 c2 = __ldg(a.pack2 + (size_t)clampi(cy, a.H2) * a.W2
                                    + clampi(cx, a.W2));
            float cost = 0.f;
            for (int b = 0; b < a.B; ++b) {
                const int* e = offs + 2 * a.T * (1 + b);
                float cost_sum = 0.f, weight_sum = 0.f;
                for (int c0 = 0; c0 < a.T; c0 += a.chunk) {
                    const int c_end = min(c0 + a.chunk, a.T);
                    float part_c = 0.f, part_w = 0.f;
                    for (int t = c0; t < c_end; ++t) {
                        const float4 p1 =
                            tile[u + offs[2 * t] * TW + offs[2 * t + 1]];
                        const float4 p2 = __ldg(
                            a.pack2 +
                            (size_t)clampi(add_wrap(cy, e[2 * t]), a.H2) * a.W2
                            + clampi(add_wrap(cx, e[2 * t + 1]), a.W2));
                        const float dr1 = maxabs3(c1, p1);
                        const float dr2 = maxabs3(c2, p2);
                        const float wgt = ftz(
                            exp_cephes(-(dr1 * dr1 + dr2 * dr2) *
                                       a.inv_sig_r2) * gws[t]);
                        const float ad = maxabs3(p1, p2);
                        const float c_ad =
                            1.f - exp_cephes(-(ad * ad) * a.inv_lam_ad2);
                        // census is stored as float in the pack
                        const float term =
                            c_ad + lut[((int)p1.w ^ (int)p2.w) & (PM_LUT - 1)];
                        const float prod = wgt * term;
                        // a chunk's sums start from its first tap
                        part_c = t == c0 ? prod : part_c + prod;
                        part_w = t == c0 ? wgt : part_w + wgt;
                    }
                    cost_sum = cost_sum + part_c;
                    weight_sum = weight_sum + part_w;
                }
                const float c = cost_sum / fmaxf(weight_sum, EPPM_TINY);
                cost = b == 0 ? c : fminf(cost, c);
            }
            if (fold) {
                fold_cost[k * PM_PIX + pix] = cost;
                fold_tx[k * PM_PIX + pix] = cx;
                fold_ty[k * PM_PIX + pix] = cy;
            } else {
                a.out_cost[((size_t)k * a.H + y) * a.W + x] = cost;
            }
        }
    }
    if (!fold) return;
    __syncthreads();
    if (threadIdx.z != 0 || !inside) return;
    const size_t i = (size_t)y * a.W + x;
    int best_x = a.in_tx[i], best_y = a.in_ty[i];
    float best = a.in_cost[i];
    for (int k = 0; k < a.K; ++k) {
        const float c = fold_cost[k * PM_PIX + pix];
        if (c < best) {   // strict: ties keep the incumbent
            best = c;
            best_x = fold_tx[k * PM_PIX + pix];
            best_y = fold_ty[k * PM_PIX + pix];
        }
    }
    a.out_tx[i] = best_x;
    a.out_ty[i] = best_y;
    a.out_cost[i] = best;
}

// pack1 (H1, W1) and pack2 (H2, W2) float4; txs, tys (K, H, W) int32 or
// null in propagation mode (step > 0, K = 4); in_tx, in_ty, in_cost (H, W)
// or null for cost only; out_tx, out_ty, out_cost (H, W), or out_cost
// (K, H, W) for cost only; offs int32 (T, 2) frame-1 taps then (B, T, 2)
// frame-2 tables, gws (T,) float32, lut (256,) float32; all on the device.
// Returns cudaGetLastError() after the launch.
extern "C" int eppm_patchmatch_costs(
    const void* pack1, const void* pack2, const void* txs, const void* tys,
    const void* in_tx, const void* in_ty, const void* in_cost, void* out_tx,
    void* out_ty, void* out_cost, const void* offs, const void* gws,
    const void* lut, int H1, int W1, int halo, int H2, int W2, int H, int W,
    int K, int step, int T, int B, int chunk, int R, float inv_sig_r2,
    float inv_lam_ad2, void* stream)
{
    const bool fold = in_cost != nullptr;
    if (H < 1 || W < 1 || H1 < 1 || W1 < 1 || H2 < 1 || W2 < 1 || halo < 0
        || K < 1 || K > PM_MAX_CANDS || T < 1 || T > PM_MAX_TAPS || B < 1
        || B > PM_MAX_TABLES || chunk < 1 || R < 0 || R > PM_MAX_REACH
        || step < 0 || (step > 0 && (K != 4 || !fold))
        || (step == 0 && (txs == nullptr || tys == nullptr))
        || (fold && (in_tx == nullptr || in_ty == nullptr ||
                     out_tx == nullptr || out_ty == nullptr)))
        return (int)cudaErrorInvalidValue;
    PmArgs a;
    a.pack1 = (const float4*)pack1;
    a.pack2 = (const float4*)pack2;
    a.txs = (const int*)txs;
    a.tys = (const int*)tys;
    a.in_tx = (const int*)in_tx;
    a.in_ty = (const int*)in_ty;
    a.in_cost = (const float*)in_cost;
    a.out_tx = (int*)out_tx;
    a.out_ty = (int*)out_ty;
    a.out_cost = (float*)out_cost;
    a.offs = (const int*)offs;
    a.gws = (const float*)gws;
    a.lut = (const float*)lut;
    a.H1 = H1; a.W1 = W1; a.halo = halo; a.H2 = H2; a.W2 = W2;
    a.H = H; a.W = W; a.K = K; a.step = step; a.T = T; a.B = B;
    a.chunk = chunk; a.R = R;
    a.inv_sig_r2 = inv_sig_r2;
    a.inv_lam_ad2 = inv_lam_ad2;
    const size_t smem =
        (size_t)(PM_BX + 2 * R) * (PM_BY + 2 * R) * sizeof(float4) +
        (PM_LUT + T) * sizeof(float) + 2 * T * (1 + B) * sizeof(int) +
        (fold ? (size_t)K * PM_PIX * (sizeof(float) + 2 * sizeof(int)) : 0);
    if (smem > PM_SMEM_DEFAULT) {
        const cudaError_t err = cudaFuncSetAttribute(
            patchmatch_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            (int)smem);
        if (err != cudaSuccess) return (int)err;
    }
    const dim3 block(PM_BX, PM_BY, K < PM_MAX_KZ ? K : PM_MAX_KZ);
    const dim3 grid((W + PM_BX - 1) / PM_BX, (H + PM_BY - 1) / PM_BY);
    patchmatch_kernel<<<grid, block, smem, (cudaStream_t)stream>>>(a);
    return (int)cudaGetLastError();
}
