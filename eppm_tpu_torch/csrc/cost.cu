// Kernel A: bilateral AD + census residual patch cost on Hopper (sm_90a).
//
// Replaces two Pallas kernels of eppm_tpu, in three modes:
//   * ops/pallas_cost.py::_cost_kernel_sep — K candidate offsets (cy, cx)
//     against ONE warped frame (fronto-parallel, separable tap grid);
//   * ops/pallas_cost.py::_cost_kernel in multiwarp mode — candidate (0, 0)
//     against K separately warped frames;
//   * ops/pallas_cost.py::_cost_kernel with plane tables
//     (residual_costs_pallas(use_planes=True)) — the least cost over the 4
//     plane-hypothesis frame-2 tap tables (bao_pmflow_kernel.cu:334-513).
// The three are one candidate table (cy, cx, frame) and one set of frame-2
// tap tables e_b (the frame-1 grid itself outside the plane mode).
//
// Per candidate k, table b and pixel p, over the taps t = (d, e_b(t), g):
//   q1 = clamp(p + d),  q2 = clamp(p + c + e)   (composite index clamped once)
//   ad    = max_c |P1(q1) - F(q2)|,       c_ad  = 1 - exp(-ad^2 / lam_ad2)
//   ham   = popcount(cen1 ^ cen2),        c_cen = 1 - exp(-ham^2 / lam_cen2)
//   w     = exp(-(dr1^2 + dr2^2) / sig_r^2) * g
//   cost  = sum(w * (c_ad + c_cen)) / max(sum(w), 1e-30), on a 2^-17 grid,
// and the least over the tables.  dr1 compares the frame-1 tap with the
// frame-1 centre, dr2 the frame-2 tap with the candidate's own centre
// F(clamp(p + c)).  The taps are summed in partial sums of `chunk` taps in
// table order, as the plain version (eppm_tpu_torch/ops/dense.py::
// residual_costs) sums them; common.cuh says why the two must agree bit
// for bit.
//
// What bounds it on the H100: the float32 <-> float64 conversions inside
// exp_cephes (each fma32 widens and narrows: ~19 conversions an exp, at 16
// a clock per SM), not memory (32 B a tap, nearly all from L1).  Of the
// three exps per (candidate, pixel, tap), two do not need the tap's own
// candidate: with u = p + d (unclamped) and s = c + e - d, q1 = clamp(u)
// and q2 = clamp(u + s), so E = c_ad + c_cen depends on (frame, s, u)
// alone.  Many (k, b, t) share a shift s: one per candidate in fronto mode,
// one per frame in multiwarp mode, 100 for 9 candidates x 4 tables x 49
// taps in the plane mode.  So two passes:
//   1. cost_terms_kernel writes E for each map (frame, s) over the padded
//      domain u in [-R, H+R) x [-R, W+R), R the frame-1 taps' reach (u is
//      not clamped first: clamp(u + s) != clamp(clamp(u) + s) at the
//      border).  2 exps per (map, padded pixel).
//   2. residual_cost_kernel: one thread per pixel and a group of up to
//      GROUP candidates (blockIdx.z walks the groups).  Per tap, the
//      frame-1 tap and dr1 once for the group; per (candidate, tap) the
//      frame-2 tap, dr2, the weight's exp, and E looked up as
//      terms[map(k, b, t)][u].  One exp per (candidate, pixel, tap) is
//      left: the weight's argument mixes both frames.
// Pass 2 computes the same float32 operations on the same operands as one
// pass would, in the same order, so the results are the same bits by
// construction.  The maps live in device memory (scratch from the wrapper:
// 9 x 1098 x 1938 floats, 77 MB, at 1080p with 49 taps; ~0.85 GB for the
// plane mode's 100 maps), not per block in shared memory: a 32x8 block
// with R = 9 would recompute a 50x26 window, 5x the terms work.
// Pass 2 is bound by the exps' latency as much as by their conversions:
// the candidates' frame-2 centres sit in shared memory and the least over
// the tables in `out`, not in registers, so that 3 blocks of 8 warps fit
// on an SM (73 registers instead of 119) to hide it.
// The tables of a call (e_b(t), map(k, b, t), and each map's frame and
// shift) are int32 device tensors that the wrapper makes once per distinct
// set and never frees (ops/cuda_cost.py).

#include "common.cuh"

#define MAX_TAPS 256
#define MAX_CANDS 128
#define MAX_MAPS 65535  // gridDim.z of the terms pass
#define GROUP 9         // candidates per thread: a radius-1 search in one
#define BLOCK_X 32      // pass 2's block: 32 x 8 pixels
#define BLOCK_Y 8

struct CostTables {
    short dy[MAX_TAPS];
    short dx[MAX_TAPS];
    float g[MAX_TAPS];
    short cy[MAX_CANDS];
    short cx[MAX_CANDS];
    short frame[MAX_CANDS];
    int n_cands;
    int n_taps;
    int n_tables;
    int chunk;
    int reach;
};

// c_ad + c_cen of one tap pair (eppm_tpu_torch/ops/cost.py::ad_census)
__device__ __forceinline__ float ad_census(float4 p1, float4 p2,
                                           float inv_lam_ad2,
                                           float inv_lam_cen2)
{
    const float ad = maxabs3(p1, p2);
    const float c_ad = 1.f - exp_cephes(-(ad * ad) * inv_lam_ad2);
    // census is stored as float in the pack: cast before the XOR
    const float ham = (float)__popc((int)p1.w ^ (int)p2.w);
    const float c_cen = 1.f - exp_cephes(-(ham * ham) * inv_lam_cen2);
    return c_ad + c_cen;
}

// Pass 1: terms[m][j][i] = E of map m = (frame, sy, sx) at u = (j - R, i - R).
__global__ void cost_terms_kernel(
    const float4* __restrict__ pack1, const float4* __restrict__ frames,
    const int* __restrict__ maps, float* __restrict__ terms, int H, int W,
    int R, float inv_lam_ad2, float inv_lam_cen2)
{
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    const int j = blockIdx.y * blockDim.y + threadIdx.y;
    const int m = blockIdx.z;
    const int Hp = H + 2 * R, Wp = W + 2 * R;
    if (i >= Wp || j >= Hp) return;
    const int f = maps[3 * m], sy = maps[3 * m + 1], sx = maps[3 * m + 2];
    const int uy = j - R, ux = i - R;
    const float4 p1 = pack1[(size_t)clampi(uy, H) * W + clampi(ux, W)];
    const float4 p2 = frames[((size_t)f * H + clampi(uy + sy, H)) * W +
                             clampi(ux + sx, W)];
    terms[((size_t)m * Hp + j) * Wp + i] =
        ad_census(p1, p2, inv_lam_ad2, inv_lam_cen2);
}

// Pass 2.  plan: int32 [n_tables][T][2] frame-2 taps (ey, ex), then
// [K][n_tables][T] map indices.
__global__ void __launch_bounds__(BLOCK_X * BLOCK_Y) residual_cost_kernel(
    const float4* __restrict__ pack1, const float4* __restrict__ frames,
    const float* __restrict__ terms, const int* __restrict__ plan,
    float* __restrict__ out, int H, int W, float inv_sig_r2,
    const CostTables tab)
{
    const int x = blockIdx.x * BLOCK_X + threadIdx.x;
    const int y = blockIdx.y * BLOCK_Y + threadIdx.y;
    const int k0 = blockIdx.z * GROUP;
    if (x >= W || y >= H) return;
    const int n = min(GROUP, tab.n_cands - k0);
    const int T = tab.n_taps, R = tab.reach;
    const int Wp = W + 2 * R;
    const size_t map_size = (size_t)(H + 2 * R) * Wp;
    const int* taps2 = plan;
    const int* map_of = plan + 2 * tab.n_tables * T;
    const float4 c1 = pack1[(size_t)y * W + x];
    // the candidates' frame-2 centres, in shared memory rather than in 27
    // registers: fewer registers, more warps to hide the exp's latency
    __shared__ float4 c2[GROUP][BLOCK_X * BLOCK_Y];
    const int tid = threadIdx.y * BLOCK_X + threadIdx.x;
#pragma unroll
    for (int j = 0; j < GROUP; ++j)
        if (j < n) {
            const int k = k0 + j;
            c2[j][tid] = frames[((size_t)tab.frame[k] * H +
                                 clampi(y + tab.cy[k], H)) * W +
                                clampi(x + tab.cx[k], W)];
        }
    for (int b = 0; b < tab.n_tables; ++b) {
        float cost_sum[GROUP], weight_sum[GROUP];
#pragma unroll
        for (int j = 0; j < GROUP; ++j) cost_sum[j] = weight_sum[j] = 0.f;
        for (int t0 = 0; t0 < T; t0 += tab.chunk) {
            const int t1 = min(t0 + tab.chunk, T);
            float part_c[GROUP], part_w[GROUP];
#pragma unroll
            for (int j = 0; j < GROUP; ++j) part_c[j] = part_w[j] = 0.f;
            for (int t = t0; t < t1; ++t) {
                const int dy = tab.dy[t], dx = tab.dx[t];
                const float4 p1 = pack1[(size_t)clampi(y + dy, H) * W +
                                        clampi(x + dx, W)];
                const float dr1 = maxabs3(c1, p1);
                const int bt = b * T + t;
                const int ey = __ldg(taps2 + 2 * bt);
                const int ex = __ldg(taps2 + 2 * bt + 1);
                const size_t u = (size_t)(y + dy + R) * Wp + (x + dx + R);
#pragma unroll
                for (int j = 0; j < GROUP; ++j) {
                    if (j < n) {
                        const int k = k0 + j;
                        const float4 p2 =
                            frames[((size_t)tab.frame[k] * H +
                                    clampi(y + tab.cy[k] + ey, H)) * W +
                                   clampi(x + tab.cx[k] + ex, W)];
                        const float dr2 = maxabs3(c2[j][tid], p2);
                        const float w = ftz(exp_cephes(
                            -(dr1 * dr1 + dr2 * dr2) * inv_sig_r2) * tab.g[t]);
                        const int m = __ldg(map_of +
                                            (size_t)k * tab.n_tables * T + bt);
                        const float e = __ldg(terms + m * map_size + u);
                        part_c[j] = part_c[j] + w * e;
                        part_w[j] = part_w[j] + w;
                    }
                }
            }
#pragma unroll
            for (int j = 0; j < GROUP; ++j) {
                cost_sum[j] = cost_sum[j] + part_c[j];
                weight_sum[j] = weight_sum[j] + part_w[j];
            }
        }
        // the least over the tables, kept in `out` (this thread's own
        // entries) rather than in registers
#pragma unroll
        for (int j = 0; j < GROUP; ++j)
            if (j < n) {
                const float cost =
                    cost_sum[j] / fmaxf(weight_sum[j], EPPM_TINY);
                // rintf rounds half to even, like torch.round and jnp.round
                const float q = rintf(cost * 131072.f) * (1.f / 131072.f);
                float* o = out + ((size_t)(k0 + j) * H + y) * W + x;
                *o = b == 0 ? q : fminf(*o, q);
            }
    }
}

extern "C" const char* eppm_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}

// Pass 1.  pack1 (H, W) float4, frames (F, H, W) float4, maps (M, 3) int32
// rows (frame, sy, sx), terms (M, H + 2R, W + 2R) float32, all on the
// device.  Returns cudaGetLastError() after the launch.
extern "C" int eppm_cost_terms(
    const void* pack1, const void* frames, const void* maps, void* terms,
    int M, int H, int W, int R, float inv_lam_ad2, float inv_lam_cen2,
    void* stream)
{
    if (M < 1 || M > MAX_MAPS || H < 1 || W < 1 || R < 0)
        return (int)cudaErrorInvalidValue;
    const dim3 block(32, 8);
    const dim3 grid((W + 2 * R + 31) / 32, (H + 2 * R + 7) / 8, M);
    cost_terms_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
        (const float4*)pack1, (const float4*)frames, (const int*)maps,
        (float*)terms, H, W, R, inv_lam_ad2, inv_lam_cen2);
    return (int)cudaGetLastError();
}

// Pass 2.  cands: host (K, 3) int32 rows (cy, cx, frame); taps: host (T, 2)
// int32 rows (dy, dx); gws: host (T,) float32.  pack1, frames and terms as
// in pass 1, plan on the device (see residual_cost_kernel), out (K, H, W)
// float32.  Returns cudaGetLastError() after the launch.
extern "C" int eppm_residual_costs(
    const void* pack1, const void* frames, const void* terms,
    const void* plan, void* out, const int* cands, const int* taps,
    const float* gws, int K, int T, int n_tables, int chunk, int R, int H,
    int W, float inv_sig_r2, void* stream)
{
    if (K < 1 || K > MAX_CANDS || T < 1 || T > MAX_TAPS || n_tables < 1 ||
        chunk < 1 || R < 0 || H < 1 || W < 1)
        return (int)cudaErrorInvalidValue;
    CostTables tab;
    tab.n_cands = K;
    tab.n_taps = T;
    tab.n_tables = n_tables;
    tab.chunk = chunk;
    tab.reach = R;
    for (int t = 0; t < T; ++t) {
        tab.dy[t] = (short)taps[2 * t];
        tab.dx[t] = (short)taps[2 * t + 1];
        tab.g[t] = gws[t];
    }
    for (int k = 0; k < K; ++k) {
        tab.cy[k] = (short)cands[3 * k];
        tab.cx[k] = (short)cands[3 * k + 1];
        tab.frame[k] = (short)cands[3 * k + 2];
    }
    const dim3 block(BLOCK_X, BLOCK_Y);
    const dim3 grid((W + BLOCK_X - 1) / BLOCK_X, (H + BLOCK_Y - 1) / BLOCK_Y,
                    (K + GROUP - 1) / GROUP);
    residual_cost_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
        (const float4*)pack1, (const float4*)frames, (const float*)terms,
        (const int*)plan, (float*)out, H, W, inv_sig_r2, tab);
    return (int)cudaGetLastError();
}
