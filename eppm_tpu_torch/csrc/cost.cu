// Kernel A: bilateral AD + census residual patch cost on Hopper (sm_90a).
//
// Replaces two Pallas kernels of eppm_tpu:
//   * ops/pallas_cost.py::_cost_kernel_sep — K candidate offsets (cy, cx)
//     against ONE warped frame (fronto-parallel, separable tap grid);
//   * ops/pallas_cost.py::_cost_kernel in multiwarp mode — candidate (0, 0)
//     against K separately warped frames.
// Both are one table of candidates (cy, cx, frame) here.  A third use,
//   * ops/pallas_cost.py::_cost_kernel with plane tables
//     (residual_costs_pallas(use_planes=True)) — the least cost over the 4
//     plane-hypothesis frame-2 tap tables (bao_pmflow_kernel.cu:334-513),
// is the same kernel's PLANES instance: the frame-1 taps stay the grid's,
// the frame-2 taps of table b are (dy2, dx2)[b][t], each table's cost is
// quantized on its own and the least is kept, as the plain version does.
//
// Per candidate k and pixel p, over the tap table (dy, dx, g):
//   q1 = clamp(p + d),  q2 = clamp(p + c + d)   (composite index clamped once)
//   ad    = max_c |P1(q1) - F(q2)|,       c_ad  = 1 - exp(-ad^2 / lam_ad2)
//   ham   = popcount(cen1 ^ cen2),        c_cen = 1 - exp(-ham^2 / lam_cen2)
//   w     = exp(-(dr1^2 + dr2^2) / sig_r^2) * g
//   cost  = sum(w * (c_ad + c_cen)) / max(sum(w), 1e-30), on a 2^-17 grid.
// dr1 compares the frame-1 tap with the frame-1 centre, dr2 the frame-2 tap
// with the candidate's own centre F(clamp(p + c)).  The weight is the plain
// version's single exp (eppm_tpu/ops/dense.py:242), not the Pallas kernel's
// product of two exps, and the taps are summed in partial sums of `chunk`
// taps in table order, as the plain version sums them (common.cuh says why
// the two must agree bit for bit).
//
// What bounds it on the H100: arithmetic.  Each (candidate, pixel, tap)
// reads two float4 (32 B, nearly all from L1/L2: neighbouring threads read
// neighbouring pixels) and spends three exps (each a float64-emulated
// polynomial, ~10 double operations) plus ~30 float operations.  At 1080p,
// K=9 and 49 taps that is 0.9 G tap evaluations.  Simple design: one thread
// per (candidate, pixel), x fastest so a warp reads 32 consecutive float4;
// the tap and candidate tables travel by value in the kernel parameters
// (constant bank, broadcast to the warp).  The plane tables (4 x 256 taps x
// 2 offsets, 4 KB) would push the parameter block past the classic 4 KB
// limit, so they live in __constant__ memory instead, written on the
// launch's stream just before it (stream order keeps an earlier launch's
// tables in place until it has finished).  The plane mode costs the work of
// its 4 tables: 64.9 ms against the fronto mode's 16.0 ms at 1080x1920, K=9,
// 49 taps (NVIDIA H100 80GB HBM3, 700 W).  Not yet done: the Pallas
// kernel's hoists (frame-1 terms shared across candidates, the frame-2
// range weight shared across candidates) and a shared-memory tile.

#include "common.cuh"

#define MAX_TAPS 256
#define MAX_CANDS 128
#define MAX_TABLES 4

struct CostTables {
    short dy[MAX_TAPS];
    short dx[MAX_TAPS];
    float g[MAX_TAPS];
    short cy[MAX_CANDS];
    short cx[MAX_CANDS];
    short frame[MAX_CANDS];
    int n_taps;
    int chunk;
};

// Frame-2 tap tables of the plane mode: [table][tap] (dy2, dx2).
__constant__ short c_plane_dy[MAX_TABLES][MAX_TAPS];
__constant__ short c_plane_dx[MAX_TABLES][MAX_TAPS];

template <bool PLANES>
__global__ void residual_cost_kernel(
    const float4* __restrict__ pack1, const float4* __restrict__ frames,
    float* __restrict__ out, int H, int W, float inv_lam_ad2,
    float inv_lam_cen2, float inv_sig_r2, const CostTables tab, int n_tables)
{
    const int x = blockIdx.x * blockDim.x + threadIdx.x;
    const int y = blockIdx.y * blockDim.y + threadIdx.y;
    const int k = blockIdx.z;
    if (x >= W || y >= H) return;
    const float4* f2 = frames + (size_t)tab.frame[k] * H * W;
    const int cy = tab.cy[k], cx = tab.cx[k];
    const float4 c1 = pack1[(size_t)y * W + x];
    const float4 c2 = f2[(size_t)clampi(y + cy, H) * W + clampi(x + cx, W)];
    float best = 0.f;
    for (int b = 0; b < (PLANES ? n_tables : 1); ++b) {
        float cost_sum = 0.f, weight_sum = 0.f;
        for (int t0 = 0; t0 < tab.n_taps; t0 += tab.chunk) {
            const int t1 = min(t0 + tab.chunk, tab.n_taps);
            float part_c = 0.f, part_w = 0.f;
            for (int t = t0; t < t1; ++t) {
                const int dy = tab.dy[t], dx = tab.dx[t];
                const int ey = PLANES ? c_plane_dy[b][t] : dy;
                const int ex = PLANES ? c_plane_dx[b][t] : dx;
                const float4 p1 =
                    pack1[(size_t)clampi(y + dy, H) * W + clampi(x + dx, W)];
                const float4 p2 = f2[(size_t)clampi(y + cy + ey, H) * W +
                                     clampi(x + cx + ex, W)];
                const float ad = maxabs3(p1, p2);
                const float c_ad = 1.f - exp_cephes(-(ad * ad) * inv_lam_ad2);
                // census is stored as float in the pack: cast before the XOR
                const float ham = (float)__popc((int)p1.w ^ (int)p2.w);
                const float c_cen =
                    1.f - exp_cephes(-(ham * ham) * inv_lam_cen2);
                const float dr1 = maxabs3(c1, p1);
                const float dr2 = maxabs3(c2, p2);
                const float w = ftz(exp_cephes(
                    -(dr1 * dr1 + dr2 * dr2) * inv_sig_r2) * tab.g[t]);
                part_c = part_c + w * (c_ad + c_cen);
                part_w = part_w + w;
            }
            cost_sum = cost_sum + part_c;
            weight_sum = weight_sum + part_w;
        }
        const float cost = cost_sum / fmaxf(weight_sum, EPPM_TINY);
        // rintf rounds half to even, like torch.round and jnp.round
        const float q = rintf(cost * 131072.f) * (1.f / 131072.f);
        best = b == 0 ? q : fminf(best, q);
    }
    out[((size_t)k * H + y) * W + x] = best;
}

extern "C" const char* eppm_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}

// Fills the parameter tables; false if a count is out of range.
static bool fill_tables(CostTables& tab, const int* cands, const int* taps,
                        const float* gws, int K, int T, int chunk, int H,
                        int W)
{
    if (K < 1 || K > MAX_CANDS || T < 1 || T > MAX_TAPS || chunk < 1 ||
        H < 1 || W < 1)
        return false;
    tab.n_taps = T;
    tab.chunk = chunk;
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
    return true;
}

// cands: host (K, 3) int32 rows (cy, cx, frame); taps: host (T, 2) int32
// rows (dy, dx); gws: host (T,) float32.  pack1 (H, W) float4, frames
// (F, H, W) float4, out (K, H, W) float32, all on the device.  Returns
// cudaGetLastError() after the launch.
extern "C" int eppm_residual_costs(
    const void* pack1, const void* frames, void* out,
    const int* cands, const int* taps, const float* gws,
    int K, int T, int chunk, int H, int W,
    float inv_lam_ad2, float inv_lam_cen2, float inv_sig_r2, void* stream)
{
    CostTables tab;
    if (!fill_tables(tab, cands, taps, gws, K, T, chunk, H, W))
        return (int)cudaErrorInvalidValue;
    const dim3 block(32, 8);
    const dim3 grid((W + 31) / 32, (H + 7) / 8, K);
    residual_cost_kernel<false><<<grid, block, 0, (cudaStream_t)stream>>>(
        (const float4*)pack1, (const float4*)frames, (float*)out, H, W,
        inv_lam_ad2, inv_lam_cen2, inv_sig_r2, tab, 1);
    return (int)cudaGetLastError();
}

// The plane mode: as eppm_residual_costs, plus planes: host
// (n_tables, T, 2) int32 frame-2 tap tables (dy2, dx2), copied to
// __constant__ memory on the stream before the launch.
extern "C" int eppm_residual_costs_planes(
    const void* pack1, const void* frames, void* out,
    const int* cands, const int* taps, const float* gws,
    int K, int T, int chunk, int H, int W,
    float inv_lam_ad2, float inv_lam_cen2, float inv_sig_r2,
    const int* planes, int n_tables, void* stream)
{
    CostTables tab;
    if (!fill_tables(tab, cands, taps, gws, K, T, chunk, H, W) ||
        n_tables < 1 || n_tables > MAX_TABLES)
        return (int)cudaErrorInvalidValue;
    short dy2[MAX_TABLES][MAX_TAPS] = {}, dx2[MAX_TABLES][MAX_TAPS] = {};
    for (int b = 0; b < n_tables; ++b)
        for (int t = 0; t < T; ++t) {
            dy2[b][t] = (short)planes[(b * T + t) * 2];
            dx2[b][t] = (short)planes[(b * T + t) * 2 + 1];
        }
    // from pageable host memory: staged before the call returns, so the
    // local arrays may go
    cudaStream_t s = (cudaStream_t)stream;
    cudaError_t err = cudaMemcpyToSymbolAsync(
        c_plane_dy, dy2, sizeof(dy2), 0, cudaMemcpyHostToDevice, s);
    if (err == cudaSuccess)
        err = cudaMemcpyToSymbolAsync(c_plane_dx, dx2, sizeof(dx2), 0,
                                      cudaMemcpyHostToDevice, s);
    if (err != cudaSuccess) return (int)err;
    const dim3 block(32, 8);
    const dim3 grid((W + 31) / 32, (H + 7) / 8, K);
    residual_cost_kernel<true><<<grid, block, 0, s>>>(
        (const float4*)pack1, (const float4*)frames, (float*)out, H, W,
        inv_lam_ad2, inv_lam_cen2, inv_sig_r2, tab, n_tables);
    return (int)cudaGetLastError();
}
