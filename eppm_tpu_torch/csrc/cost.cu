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
//   e     = exp(-(dr1^2 + dr2^2) / sig_r^2),   w = e * g
//   cost  = sum(w * (c_ad + c_cen)) / max(sum(w), 1e-30), on a 2^-17 grid,
// and the least over the tables.  dr1 compares the frame-1 tap with the
// frame-1 centre, dr2 the frame-2 tap with the candidate's own centre
// F(clamp(p + c)).  The taps are summed in partial sums of `chunk` taps,
// each in XLA's CPU arithmetic for eppm_tpu's dense.residual_costs: the
// exponent one fused multiply-add, LANES vector lanes of fused
// multiply-adds, a halving tree, the rest in sequence
// (eppm_tpu_torch/ops/cost.py::bilateral_cost with lanes=True, the plain
// version); common.cuh says why the two must agree bit for bit.
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
//      GROUP candidates (blockIdx.z walks the groups), visiting each tap
//      once.  Per tap, the frame-1 tap and dr1 once for the
//      group; per (candidate, tap) the frame-2 tap, dr2, the weight's exp,
//      and E looked up as terms[map(k, b, t)][u], added to the tap's lane
//      of the cost sum (and of the weight sum when the cost has one
//      chunk; with more, XLA sums the weights in sequence).  One exp per
//      (candidate, pixel, tap) is left: the weight's argument mixes both
//      frames.
// Pass 2 computes the same float32 operations on the same operands as one
// pass would, in the same order, so the results are the same bits by
// construction.  The maps live in device memory (scratch from the wrapper:
// 9 x 1098 x 1938 floats, 77 MB, at 1080p with 49 taps; ~0.85 GB for the
// plane mode's 100 maps), not per block in shared memory: a 32x8 block
// with R = 9 would recompute a 50x26 window, 5x the terms work.
// Pass 2 is bound by the exps' latency as much as by their conversions:
// the candidates' frame-2 centres sit in shared memory and the least over
// the tables in `out`, not in registers, and a thread takes few
// candidates, each with up to 2 x LANES partial sums: 3 where the weights
// are in lanes or windows, 1 where the cost is in lanes and the weights
// in sequence (the 8 cost lanes of 3 candidates spill).  The launch bound
// asks for 3 blocks of 8 warps an SM (at most 85 registers).  Each form's
// group and bound is the fastest of those tools/time_kernel_a.py --groups
// timed (1, 3 or 9 candidates; 1, 2 or 3 blocks) at 1080p on the H100;
// 9 candidates were slower in every form.
// Where both sums are in lanes they are visited lane by lane, in the order
// the tree meets them, so that a sum holds 4 partials rather than LANES.
// The tables of a call (e_b(t), map(k, b, t), and each map's frame and
// shift) are int32 device tensors that the wrapper makes once per distinct
// set and never frees (ops/cuda_cost.py).

#include "common.cuh"

#define MAX_TAPS 256
#define MAX_CANDS 128
#define MAX_MAPS 65535  // gridDim.z of the terms pass
#define LANES 8         // XLA's CPU vector lanes (ops/cost.py::LANES)
#define WINDOW 32       // XLA's reduction windows (ops/cost.py::WINDOW)
// Pass 2's candidates a thread (GROUP) for each form of the sums: the
// windows, both sums in lanes, the cost in lanes and the weights in
// sequence; and the blocks an SM its launch bound asks for (see above).
#define WINDOW_GROUP 3
#define LANE_GROUP 3
#define SEQ_GROUP 1
#define SUMS_BLOCKS 3
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

// The halving tree that meets XLA's LANES vector lanes
// (eppm_tpu_torch/ops/cost.py::_lane_tree).
__device__ __forceinline__ float lane_tree(const float* l)
{
    return ((l[0] + l[4]) + (l[2] + l[6])) + ((l[1] + l[5]) + (l[3] + l[7]));
}

// Pass 2.  plan: int32 [n_tables][T][2] frame-2 taps (ey, ex), then
// [K][n_tables][T] map indices.  The forms of ops/dense.py::
// _cost_from_stack: with one chunk and more than one candidate the
// exponent is fma(dr2, dr2, dr1^2), else fma(dr1, dr1, dr2^2); with one
// chunk the weights sum in lanes (W_LANES, the chunk at least LANES
// taps), except in the plane mode's first (fronto) table; WINDOWS: a
// chunk of more than WINDOW taps sums in windows (ops/cost.py::
// _window_chunk), else in lanes (_lane_chunk).  The template flags keep
// the lanes a form does not use out of its registers.  A thread takes
// GROUP candidates; the launch bound asks for MIN_BLOCKS blocks an SM.
template <bool WINDOWS, bool W_LANES, int GROUP, int MIN_BLOCKS>
__global__ void __launch_bounds__(BLOCK_X * BLOCK_Y, MIN_BLOCKS)
residual_cost_kernel(
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
    // the candidates' frame-2 centres, in shared memory rather than in
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
    // the first `full` taps of a chunk padded to `chunk` go to the lanes
    const int full = tab.chunk / LANES * LANES;
    const bool one_chunk = T <= tab.chunk;
    const bool dr1_apart = one_chunk && tab.n_cands > 1;
    for (int b = 0; b < tab.n_tables; ++b) {
        // tap t of table b for each candidate j of the group: f(j, e, w,
        // term) with e the range weight's exp, w = e * g flushed, term
        // c_ad + c_cen from the terms pass
        auto tap = [&](int t, auto&& f) {
            const int dy = tab.dy[t], dx = tab.dx[t];
            const float4 p1 = pack1[(size_t)clampi(y + dy, H) * W +
                                    clampi(x + dx, W)];
            const float dr1 = maxabs3(c1, p1);
            const float dr1_sq = dr1 * dr1;
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
                    const float e = exp_cephes(
                        -(dr1_apart ? fma32(dr2, dr2, dr1_sq)
                                    : fma32(dr1, dr1, dr2 * dr2)) *
                        inv_sig_r2);
                    const int m = __ldg(map_of +
                                        (size_t)k * tab.n_tables * T + bt);
                    f(j, e, ftz(e * tab.g[t]), __ldg(terms + m * map_size + u));
                }
            }
        };
        const bool w_lanes = W_LANES && !(tab.n_tables > 1 && b == 0);
        float cost_sum[GROUP], weight_sum[GROUP];
#pragma unroll
        for (int j = 0; j < GROUP; ++j) cost_sum[j] = weight_sum[j] = 0.f;
        for (int c0 = 0; c0 < T; c0 += tab.chunk) {
            const int m = min(tab.chunk, T - c0);
            float part_c[GROUP], part_w[GROUP];
#pragma unroll
            for (int j = 0; j < GROUP; ++j) part_c[j] = part_w[j] = 0.f;
            if (WINDOWS) {
                // windows of WINDOW taps after the lesser half of the
                // padding to whole windows, each summed in sequence
                const int n_win = (tab.chunk + WINDOW - 1) / WINDOW;
                const int front = (n_win * WINDOW - tab.chunk) / 2;
                for (int s = 0; s < n_win; ++s) {
                    const int lo = max(s * WINDOW - front, 0);
                    const int hi = min(max((s + 1) * WINDOW - front, 0), m);
                    float win_c[GROUP], win_w[GROUP];
#pragma unroll
                    for (int j = 0; j < GROUP; ++j) win_c[j] = win_w[j] = 0.f;
                    for (int t = lo; t < hi; ++t)
                        tap(c0 + t, [&](int j, float, float w, float term) {
                            win_c[j] = win_c[j] + w * term;
                            win_w[j] = win_w[j] + w;
                        });
#pragma unroll
                    for (int j = 0; j < GROUP; ++j) {
                        part_c[j] = part_c[j] + win_c[j];
                        part_w[j] = part_w[j] + win_w[j];
                    }
                }
            } else {
                // the first `full` taps of the chunk padded to `chunk` in
                // LANES lanes, the halving tree, the rest in sequence
                const int in_lanes = min(full, m);
                if (w_lanes) {
                    // both sums in lanes: lane by lane, in the order the
                    // tree meets them (0, 4, 2, 6, 1, 5, 3, 7), so that a
                    // sum holds 4 partials, not LANES
                    float prev_c[GROUP], prev_w[GROUP], half_c[GROUP],
                        half_w[GROUP];
#pragma unroll
                    for (int q = 0; q < LANES; ++q) {
                        const int i = (q & 1) * 4 + (q & 2) + (q >> 2);
                        float lc[GROUP], lw[GROUP];
#pragma unroll
                        for (int j = 0; j < GROUP; ++j) lc[j] = lw[j] = 0.f;
                        for (int t = i; t < in_lanes; t += LANES) {
                            const float gt = tab.g[c0 + t];
                            tap(c0 + t, [&](int j, float e, float w, float term) {
                                lc[j] = fma32(w, term, lc[j]);
                                lw[j] = t < LANES ? w : fma32(e, gt, lw[j]);
                            });
                        }
#pragma unroll
                        for (int j = 0; j < GROUP; ++j) {
                            if (!(q & 1)) {
                                prev_c[j] = lc[j];
                                prev_w[j] = lw[j];
                                continue;
                            }
                            const float ac = prev_c[j] + lc[j];
                            const float aw = prev_w[j] + lw[j];
                            if (q == 1 || q == 5) {  // l0 + l4, l1 + l5
                                half_c[j] = ac;
                                half_w[j] = aw;
                            } else if (q == 3) {     // + (l2 + l6)
                                part_c[j] = half_c[j] + ac;
                                part_w[j] = half_w[j] + aw;
                            } else {                 // + ((l1 + l5) + (l3 + l7))
                                part_c[j] = part_c[j] + (half_c[j] + ac);
                                part_w[j] = part_w[j] + (half_w[j] + aw);
                            }
                        }
                    }
                } else {
                    float lane_c[GROUP][LANES];
#pragma unroll
                    for (int j = 0; j < GROUP; ++j)
#pragma unroll
                        for (int i = 0; i < LANES; ++i) lane_c[j][i] = 0.f;
                    for (int g = 0; g < in_lanes; g += LANES) {
#pragma unroll
                        for (int i = 0; i < LANES; ++i) {
                            if (g + i < in_lanes) {
                                const float gt = tab.g[c0 + g + i];
                                tap(c0 + g + i,
                                    [&](int j, float e, float w, float term) {
                                    lane_c[j][i] =
                                        fma32(w, term, lane_c[j][i]);
                                    part_w[j] = g + i == 0
                                                    ? w
                                                    : fma32(e, gt, part_w[j]);
                                });
                            }
                        }
                    }
#pragma unroll
                    for (int j = 0; j < GROUP; ++j)
                        part_c[j] = lane_tree(lane_c[j]);
                }
                for (int t = c0 + in_lanes; t < c0 + m; ++t) {
                    const float gt = tab.g[t];
                    tap(t, [&](int j, float e, float w, float term) {
                        part_c[j] = fma32(w, term, part_c[j]);
                        part_w[j] =
                            w_lanes || t > c0 ? fma32(e, gt, part_w[j]) : w;
                    });
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

// One form of pass 2 at GROUP candidates a thread.
template <bool WINDOWS, bool W_LANES, int GROUP, int MIN_BLOCKS>
int launch_sums(const void* pack1, const void* frames, const void* terms,
                const void* plan, void* out, int H, int W, float inv_sig_r2,
                const CostTables& tab, void* stream)
{
    const dim3 block(BLOCK_X, BLOCK_Y);
    const dim3 grid((W + BLOCK_X - 1) / BLOCK_X, (H + BLOCK_Y - 1) / BLOCK_Y,
                    (tab.n_cands + GROUP - 1) / GROUP);
    residual_cost_kernel<WINDOWS, W_LANES, GROUP, MIN_BLOCKS>
        <<<grid, block, 0, (cudaStream_t)stream>>>(
            (const float4*)pack1, (const float4*)frames, (const float*)terms,
            (const int*)plan, (float*)out, H, W, inv_sig_r2, tab);
    return (int)cudaGetLastError();
}

// Pass 2 (eppm_residual_costs) with each form of the sums at its own
// GROUP: WG for the windows, LG where both sums are in lanes, SG for the
// cost in lanes and the weights in sequence; MIN_BLOCKS for all three.
template <int WG, int LG, int SG, int MIN_BLOCKS>
int residual_costs(
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
    if (chunk > WINDOW)
        return launch_sums<true, false, WG, MIN_BLOCKS>(
            pack1, frames, terms, plan, out, H, W, inv_sig_r2, tab, stream);
    if (T <= chunk && chunk >= LANES)
        return launch_sums<false, true, LG, MIN_BLOCKS>(
            pack1, frames, terms, plan, out, H, W, inv_sig_r2, tab, stream);
    return launch_sums<false, false, SG, MIN_BLOCKS>(
        pack1, frames, terms, plan, out, H, W, inv_sig_r2, tab, stream);
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
    return residual_costs<WINDOW_GROUP, LANE_GROUP, SEQ_GROUP, SUMS_BLOCKS>(
        pack1, frames, terms, plan, out, cands, taps, gws, K, T, n_tables,
        chunk, R, H, W, inv_sig_r2, stream);
}
