// Kernel F: the dense coarse matcher's exact stage on Hopper (sm_90a).
//
// It replaces no Pallas kernel: the JAX package computes this stage in XLA
// (eppm_tpu/ops/match.py::_polish_direction over ops/cost.py::
// patch_cost_stack).  It was added because the plain version
// (eppm_tpu_torch/ops/match.py::exact_best_of) is ~5,000 small launches a
// call, four calls a direction: most of the dense engine's coarse match.
// Per pixel p = (x, y) and candidate offset field k, with the target
// t = p + (gx_k, gy_k) (int32, wrapping as torch adds) and c = clamp(t) to
// frame 2, over the taps d in table order:
//   p1 = P1(clamp(p + d))                (frame 1, float32, edge-padded)
//   p2 = bf16(P2(clamp(c + d))),  c2 = bf16(P2(c))
//        (make_patch_stack's bfloat16 tap stack read at row c: its group
//        d holds P2 at clamp(q + d) rounded to bfloat16, its last group P2)
//   w    = ftz(exp(-fma(dr1, dr1, dr2^2) * inv_sig_r2) * g(d)),
//          dr1 = maxabs3(P1(p) - p1), dr2 = maxabs3(c2 - p2)
//   term = (1 - exp(-ad^2 * inv_lam_ad2)) + lut[cen(p1) ^ cen(p2)],
//          ad = maxabs3(p1 - p2), lut the plain version's census_lut
//   cost_sum = fma(w, term, cost_sum),  weight_sum = weight_sum + w
//   cost = rint(cost_sum / max(weight_sum, 1e-30) * 2^17) * 2^-17
// with one running sum in tap order (ops/cost.py::patch_cost_stack, not
// kernel E's chunked sums), every product rounded alone (--fmad=false),
// exp the plain version's exp_cephes, rint rounding half to even as
// torch.round does; then FLT_MAX where t lies outside frame 2.  Then the
// first least cost over k (torch.argmin's) is accepted against the
// incumbent on strict '<' or on '<=' (ops/match.py::exact_best_of).
// Three rules, one launch a call:
//   * score: K = 1, the cost alone and unmasked (the incumbent's scoring);
//   * strict: the polish ring and the propagation rounds;
//   * at equality: the median rounds.
// A fourth rule is the coarse occlusion chain's photometric arbitration
// (eppm_tpu_torch/ops/occlusion.py::arbitrate_holes over patch_cost_stack's
// float32 stack): frame 2 read in float32 (no bf16 rounding), the cost not
// quantized, a candidate masked by its own flag as well as by frame 2, and
// the first least cost accepted where the pixel is a hole (either LR-checked
// target < 0) and the cost is below a threshold: the candidate's target,
// else the fill's.  Those departures are compile-time: the kernel is a
// template on its argument struct, ExArgs for the matcher's three rules
// (the code they compiled to before the arbitration existed) and ArbArgs
// for the arbitration, so no rule is tested inside the tap loop.
// The fold writes fresh buffers: no pixel writes what another reads.
//
// What bounds it on the H100: the two exps a (candidate, pixel, tap).
// exp_cephes is a float32 polynomial whose multiply-adds round through
// float64 (fma32): ~19 conversions between float32 and float64 an exp, 45
// a tap with the range weight's and the running sum's fma32, and an SM
// converts 16 a clock.  The reads cost far less: 16 B of frame 2 a tap
// from L1 (frame 2 is 518 KB at the 135x240 level and stays in L2), frame
// 1 from shared memory.  The design follows kernel E's (csrc/patchmatch.cu)
// and the level's size: at 135x240 a thread per pixel would be ~1,000
// warps, under 8 an SM, so a block takes a 32x2 tile of pixels and
// threadIdx.z spreads the candidates over its threads (K x 2 warps a block
// for K <= 8).  The block stages its frame-1 tile with the taps' halo, the
// census table, the taps and their spatial weights in shared memory; each
// thread computes its candidates' costs into shared memory, and one thread
// a pixel then walks the K costs in candidate order.

#include <cfloat>
#include <type_traits>

#include "common.cuh"

#define EX_MAX_TAPS 256
#define EX_MAX_CANDS 32
#define EX_MAX_REACH 32      // the taps' reach: the tile's halo
#define EX_MAX_KZ 8          // candidate threads a pixel
#define EX_BX 32             // pixels of a block: 32 x 2
#define EX_BY 2
#define EX_PIX (EX_BX * EX_BY)
#define EX_LUT 256           // census XORs of two 8-bit signatures
#define EX_SMEM_DEFAULT 49152
#define EX_GRID 0x1p17f      // the quantization grid, 2^17 steps a unit

// How the candidates' least cost meets the incumbent.
#define EX_SCORE 0           // no incumbent: K = 1, the cost unmasked
#define EX_STRICT 1          // accepted on a strictly lower cost
#define EX_AT_EQUALITY 2     // accepted on an equal or lower cost
#define EX_ARBITRATE 3       // the occlusion arbitration (ArbArgs)

struct ExArgs {
    const float4* pack1;     // (H, W) frame 1
    const float4* pack2;     // (H2, W2) frame 2
    const int* cgx;          // (K, H, W) candidate offsets
    const int* cgy;
    const int* in_gx;        // (H, W) incumbent, null when scoring
    const int* in_gy;
    const float* in_cost;
    int* out_gx;             // (H, W) folded state, null when scoring
    int* out_gy;
    float* out_cost;         // (H, W)
    const int* offs;         // (T, 2) taps
    const float* gws;        // (T,) spatial weights
    const float* lut;        // (256,) census term of each XOR
    int H, W, H2, W2, K, T, R, rule;
    float inv_sig_r2, inv_lam_ad2;
};

// The arbitration's arguments: in_gx, in_gy are the fill's absolute targets
// and out_gx, out_gy the arbitrated ones; in_cost and out_cost are unused.
struct ArbArgs : ExArgs {
    const unsigned char* found;  // (K, H, W) each candidate's own flag
    const int* hole_tx;          // (H, W) the LR-checked targets: a hole
    const int* hole_ty;          //   where either is < 0
    float thresh;                // the accept's bound, strict '<'
};

// float32 -> bfloat16 -> float32, rounding to nearest even as torch's
// float -> bfloat16 conversion does (c10::BFloat16, NaN to 0x7fc0).
__device__ __forceinline__ float bf16_round(float v)
{
    if (v != v) return __uint_as_float(0x7fc00000u);
    const unsigned u = __float_as_uint(v);
    return __uint_as_float((u + 0x7fffu + ((u >> 16) & 1u)) & 0xffff0000u);
}

__device__ __forceinline__ float4 bf16_round(float4 v)
{
    return make_float4(bf16_round(v.x), bf16_round(v.y), bf16_round(v.z),
                       bf16_round(v.w));
}

// A frame-2 pixel as the rule reads it: the matcher's bfloat16 tap stack,
// or the arbitration's float32 one.
template <bool ROUND>
__device__ __forceinline__ float4 read2(const float4* p)
{
    if constexpr (ROUND) return bf16_round(__ldg(p));
    return __ldg(p);
}

// int32 addition that wraps as torch's does (no signed overflow).
__device__ __forceinline__ int add_wrap(int a, int b)
{
    return (int)((unsigned)a + (unsigned)b);
}

template <class Args>
__global__ void __launch_bounds__(EX_PIX * EX_MAX_KZ)
exact_kernel(const Args a)
{
    constexpr bool ARB = std::is_same<Args, ArbArgs>::value;
    extern __shared__ float4 ex_smem[];
    const int TW = EX_BX + 2 * a.R, TH = EX_BY + 2 * a.R;
    float4* tile = ex_smem;
    float* lut = (float*)(tile + TH * TW);
    float* gws = lut + EX_LUT;
    int* offs = (int*)(gws + a.T);
    float* costs = (float*)(offs + 2 * a.T);   // (K, EX_PIX)

    const int pix = threadIdx.y * EX_BX + threadIdx.x;
    const int tid = threadIdx.z * EX_PIX + pix;
    const int nthreads = EX_PIX * blockDim.z;
    const int x0 = blockIdx.x * EX_BX, y0 = blockIdx.y * EX_BY;
    // frame 1 around the tile: row r, column c of the tile is the
    // field's (y0 - R + r, x0 - R + c), clamped (the plain version's edge
    // padding)
    for (int i = tid; i < TH * TW; i += nthreads) {
        const int r = i / TW, c = i - r * TW;
        tile[i] = a.pack1[(size_t)clampi(y0 - a.R + r, a.H) * a.W
                          + clampi(x0 - a.R + c, a.W)];
    }
    for (int i = tid; i < EX_LUT; i += nthreads) lut[i] = a.lut[i];
    for (int i = tid; i < a.T; i += nthreads) gws[i] = a.gws[i];
    for (int i = tid; i < 2 * a.T; i += nthreads) offs[i] = a.offs[i];
    __syncthreads();

    const int x = x0 + threadIdx.x, y = y0 + threadIdx.y;
    const bool inside = x < a.W && y < a.H;
    const int u = (threadIdx.y + a.R) * TW + threadIdx.x + a.R;
    if (inside) {
        const float4 c1 = tile[u];
        for (int k = threadIdx.z; k < a.K; k += blockDim.z) {
            const size_t i = ((size_t)k * a.H + y) * a.W + x;
            const int tx = add_wrap(x, a.cgx[i]), ty = add_wrap(y, a.cgy[i]);
            const int cx = clampi(tx, a.W2), cy = clampi(ty, a.H2);
            const float4 c2 = read2<!ARB>(a.pack2 + (size_t)cy * a.W2 + cx);
            float cost_sum = 0.f, weight_sum = 0.f;
            for (int t = 0; t < a.T; ++t) {
                const int dy = offs[2 * t], dx = offs[2 * t + 1];
                const float4 p1 = tile[u + dy * TW + dx];
                const float4 p2 = read2<!ARB>(
                    a.pack2 + (size_t)clampi(cy + dy, a.H2) * a.W2
                    + clampi(cx + dx, a.W2));
                const float dr1 = maxabs3(c1, p1);
                const float dr2 = maxabs3(c2, p2);
                const float wgt = ftz(
                    exp_cephes(-fma32(dr1, dr1, dr2 * dr2) * a.inv_sig_r2)
                    * gws[t]);
                const float ad = maxabs3(p1, p2);
                const float c_ad =
                    1.f - exp_cephes(-(ad * ad) * a.inv_lam_ad2);
                // census is stored as float in the pack
                const float term =
                    c_ad + lut[((int)p1.w ^ (int)p2.w) & (EX_LUT - 1)];
                cost_sum = fma32(wgt, term, cost_sum);
                weight_sum = weight_sum + wgt;
            }
            float cost;
            if constexpr (ARB) {
                cost = cost_sum / fmaxf(weight_sum, EPPM_TINY);
            } else {
                cost = rintf(cost_sum / fmaxf(weight_sum, EPPM_TINY)
                             * EX_GRID) * (1.f / EX_GRID);
                if (a.rule == EX_SCORE) {
                    a.out_cost[i] = cost;   // K = 1: i is the pixel's index
                    continue;
                }
            }
            bool masked = tx < 0 || tx >= a.W2 || ty < 0 || ty >= a.H2;
            if constexpr (ARB) masked = masked || !a.found[i];
            if (masked) cost = FLT_MAX;
            costs[k * EX_PIX + pix] = cost;
        }
    }
    if constexpr (!ARB) {
        if (a.rule == EX_SCORE) return;
    }
    __syncthreads();
    if (threadIdx.z != 0 || !inside) return;
    // the first least cost, then the accept
    int best_k = 0;
    float best = costs[pix];
    for (int k = 1; k < a.K; ++k) {
        const float c = costs[k * EX_PIX + pix];
        if (c < best) {
            best = c;
            best_k = k;
        }
    }
    const size_t i = (size_t)y * a.W + x;
    const size_t j = ((size_t)best_k * a.H + y) * a.W + x;
    if constexpr (ARB) {
        // a hole takes the candidate's target below the threshold
        const bool win =
            (a.hole_tx[i] < 0 || a.hole_ty[i] < 0) && best < a.thresh;
        a.out_gx[i] = win ? add_wrap(x, a.cgx[j]) : a.in_gx[i];
        a.out_gy[i] = win ? add_wrap(y, a.cgy[j]) : a.in_gy[i];
    } else {
        const float cost0 = a.in_cost[i];
        const bool win = a.rule == EX_STRICT ? best < cost0 : best <= cost0;
        a.out_gx[i] = win ? a.cgx[j] : a.in_gx[i];
        a.out_gy[i] = win ? a.cgy[j] : a.in_gy[i];
        a.out_cost[i] = win ? best : cost0;
    }
}

template <class Args>
static int launch(const Args& a, size_t smem, cudaStream_t stream)
{
    if (smem > EX_SMEM_DEFAULT) {
        const cudaError_t err = cudaFuncSetAttribute(
            exact_kernel<Args>, cudaFuncAttributeMaxDynamicSharedMemorySize,
            (int)smem);
        if (err != cudaSuccess) return (int)err;
    }
    const dim3 block(EX_BX, EX_BY, a.K < EX_MAX_KZ ? a.K : EX_MAX_KZ);
    const dim3 grid((a.W + EX_BX - 1) / EX_BX, (a.H + EX_BY - 1) / EX_BY);
    exact_kernel<Args><<<grid, block, smem, stream>>>(a);
    return (int)cudaGetLastError();
}

// pack1 (H, W) and pack2 (H2, W2) float4; cgx, cgy (K, H, W) int32
// candidate offsets; in_gx, in_gy, in_cost (H, W) and out_gx, out_gy (H, W)
// for the strict and at-equality rules, null for the score (K = 1);
// out_cost (H, W); offs int32 (T, 2) taps, gws (T,) float32, lut (256,)
// float32; all on the device.  The arbitration takes the fill's targets as
// in_gx, in_gy, writes out_gx, out_gy and no cost (in_cost, out_cost null),
// and takes found (K, H, W) bool, hole_tx, hole_ty (H, W) int32 and thresh,
// which the other rules leave null and 0.  Returns cudaGetLastError() after
// the launch.
extern "C" int eppm_exact_best_of(
    const void* pack1, const void* pack2, const void* cgx, const void* cgy,
    const void* in_gx, const void* in_gy, const void* in_cost, void* out_gx,
    void* out_gy, void* out_cost, const void* offs, const void* gws,
    const void* lut, const void* found, const void* hole_tx,
    const void* hole_ty, int H, int W, int H2, int W2, int K, int T, int R,
    int rule, float inv_sig_r2, float inv_lam_ad2, float thresh,
    void* stream)
{
    const bool score = rule == EX_SCORE, arb = rule == EX_ARBITRATE;
    if (H < 1 || W < 1 || H2 < 1 || W2 < 1 || K < 1 || K > EX_MAX_CANDS
        || T < 1 || T > EX_MAX_TAPS || R < 0 || R > EX_MAX_REACH
        || rule < EX_SCORE || rule > EX_ARBITRATE
        || cgx == nullptr || cgy == nullptr
        || (!arb && out_cost == nullptr)
        || (score && K != 1)
        || (!score && (in_gx == nullptr || in_gy == nullptr ||
                       out_gx == nullptr || out_gy == nullptr))
        || (!score && !arb && in_cost == nullptr)
        || (arb && (found == nullptr || hole_tx == nullptr ||
                    hole_ty == nullptr)))
        return (int)cudaErrorInvalidValue;
    ArbArgs a;
    a.pack1 = (const float4*)pack1;
    a.pack2 = (const float4*)pack2;
    a.cgx = (const int*)cgx;
    a.cgy = (const int*)cgy;
    a.in_gx = (const int*)in_gx;
    a.in_gy = (const int*)in_gy;
    a.in_cost = (const float*)in_cost;
    a.out_gx = (int*)out_gx;
    a.out_gy = (int*)out_gy;
    a.out_cost = (float*)out_cost;
    a.offs = (const int*)offs;
    a.gws = (const float*)gws;
    a.lut = (const float*)lut;
    a.H = H; a.W = W; a.H2 = H2; a.W2 = W2; a.K = K; a.T = T; a.R = R;
    a.rule = rule;
    a.inv_sig_r2 = inv_sig_r2;
    a.inv_lam_ad2 = inv_lam_ad2;
    a.found = (const unsigned char*)found;
    a.hole_tx = (const int*)hole_tx;
    a.hole_ty = (const int*)hole_ty;
    a.thresh = thresh;
    const size_t smem =
        (size_t)(EX_BX + 2 * R) * (EX_BY + 2 * R) * sizeof(float4) +
        (EX_LUT + T) * sizeof(float) + 2 * T * sizeof(int) +
        (score ? 0 : (size_t)K * EX_PIX * sizeof(float));
    if (arb) return launch<ArbArgs>(a, smem, (cudaStream_t)stream);
    return launch<ExArgs>(a, smem, (cudaStream_t)stream);
}
