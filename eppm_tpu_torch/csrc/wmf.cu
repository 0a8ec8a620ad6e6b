// Kernel C: one Jacobi iteration of the weighted median displacement
// filter on Hopper (sm_90a).
//
// Replaces both Pallas forms of eppm_tpu/ops/pallas_wmf.py: _wmf_kernel
// (whole level in VMEM, all iterations in one launch) and _wmf_tile_kernel
// (halo tiles, one iteration per launch).  Spec: d_weighted_median_filtering
// (bao_pmflow_refine_kernel.cu:206-286).  Per pixel p, over the window
// offsets o_s (raster order, already scaled by the dilation):
//   w_s     = valid(p+o_s) * g_s * exp(-maxabs3(img(p+o_s) - img(p))^2 / sig_r2)
//   cost(c) = sum_s w_s * max(|ox(c) - ox(s)|, |oy(c) - oy(s)|)
// over valid candidates c of the same window; the strict minimum in raster
// order wins (the first minimum).  g_s is the spatial Gaussian of the
// UNDILATED offset.  Offsets outside the image are invalid.  A winner whose
// target (offset + position) is negative is not written (the reference's
// write guard, refine_kernel.cu:286).  only_occlusion replaces only invalid
// pixels; freeze_valid (the polish mode) keeps the valid set as it came in,
// otherwise replaced pixels become valid.  Each launch reads the *_in
// planes and writes the *_out planes: the wrapper ping-pongs them.  The
// support sums run in partial sums of `chunk` supports, as the plain
// version's (eppm_tpu_torch/ops/refine.py::weighted_median_filter) do, so
// the two pick the same candidate on exact cost ties (common.cuh).
//
// What bounds it on the H100: arithmetic — n^2 = 6561 (candidate, support)
// pairs per pixel at the default radius 4, 4 operations each.  Simple
// design: one thread per pixel gathers its window once (offset, validity,
// weight) into per-thread arrays in local memory, which stays in L1, then
// runs the n x n loop from there.  Not yet done: a shared-memory tile
// shared by the block's pixels, or keeping the window in registers.

#include "common.cuh"
#include <cfloat>

#define MAX_WIN 225  // radius <= 7

struct WmfTable {
    short oy[MAX_WIN];
    short ox[MAX_WIN];
    float g[MAX_WIN];
    int n;
    int chunk;
};

__global__ void wmf_iter_kernel(
    const float* __restrict__ ox_in, const float* __restrict__ oy_in,
    const float* __restrict__ val_in, const float* __restrict__ img,
    float* __restrict__ ox_out, float* __restrict__ oy_out,
    float* __restrict__ val_out, int H, int W, float inv_sig_r2,
    int only_occlusion, int freeze_valid, const WmfTable tab)
{
    const int x = blockIdx.x * blockDim.x + threadIdx.x;
    const int y = blockIdx.y * blockDim.y + threadIdx.y;
    if (x >= W || y >= H) return;
    const size_t p = (size_t)y * W + x;
    const float cr = img[3 * p], cg = img[3 * p + 1], cb = img[3 * p + 2];
    const int n = tab.n;

    float sw[MAX_WIN], sx[MAX_WIN], sy[MAX_WIN];
    bool sv[MAX_WIN];
    bool any_weight = false;
    for (int s = 0; s < n; ++s) {
        const int qy = y + tab.oy[s], qx = x + tab.ox[s];
        float w = 0.f, vx = 0.f, vy = 0.f;
        bool v = false;
        if (qy >= 0 && qy < H && qx >= 0 && qx < W) {
            const size_t q = (size_t)qy * W + qx;
            const float val = val_in[q];
            v = val > 0.f;
            vx = ox_in[q];
            vy = oy_in[q];
            const float dr = maxabs3(img[3 * q], img[3 * q + 1],
                                     img[3 * q + 2], cr, cg, cb);
            w = ftz(val * tab.g[s] * exp_cephes(-(dr * dr) * inv_sig_r2));
        }
        sw[s] = w;
        sx[s] = vx;
        sy[s] = vy;
        sv[s] = v;
        any_weight = any_weight || w > 0.f;
    }

    float best = FLT_MAX, bx = ox_in[p], by = oy_in[p];
    if (any_weight) {
        for (int c = 0; c < n; ++c) {
            if (!sv[c]) continue;
            const float cx = sx[c], cy = sy[c];
            float cost = 0.f;
            for (int s0 = 0; s0 < n; s0 += tab.chunk) {
                const int s1 = min(s0 + tab.chunk, n);
                float part = 0.f;
                for (int s = s0; s < s1; ++s)
                    part = part +
                           sw[s] * fmaxf(fabsf(cx - sx[s]), fabsf(cy - sy[s]));
                cost = cost + part;
            }
            if (cost < best) {
                best = cost;
                bx = cx;
                by = cy;
            }
        }
    }
    const float cval = val_in[p];
    const bool found = best < FLT_MAX && bx + (float)x >= 0.f &&
                       by + (float)y >= 0.f;
    const bool replace = found && (!only_occlusion || cval == 0.f);
    ox_out[p] = replace ? bx : ox_in[p];
    oy_out[p] = replace ? by : oy_in[p];
    val_out[p] = (freeze_valid || !replace) ? cval : 1.f;
}

// Planes (H, W) float32 and img (H, W, 3) float32 on the device; offs:
// host (n, 2) int32 rows (oy, ox), dilated; g: host (n,) float32.  Returns
// cudaGetLastError() after the launch.
extern "C" int eppm_wmf_iteration(
    const void* ox_in, const void* oy_in, const void* val_in, const void* img,
    void* ox_out, void* oy_out, void* val_out, const int* offs, const float* g,
    int n, int chunk, int H, int W, float inv_sig_r2, int only_occlusion,
    int freeze_valid, void* stream)
{
    if (n < 1 || n > MAX_WIN || chunk < 1 || H < 1 || W < 1)
        return (int)cudaErrorInvalidValue;
    WmfTable tab;
    tab.n = n;
    tab.chunk = chunk;
    for (int s = 0; s < n; ++s) {
        tab.oy[s] = (short)offs[2 * s];
        tab.ox[s] = (short)offs[2 * s + 1];
        tab.g[s] = g[s];
    }
    const dim3 block(32, 8);
    const dim3 grid((W + 31) / 32, (H + 7) / 8);
    wmf_iter_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
        (const float*)ox_in, (const float*)oy_in, (const float*)val_in,
        (const float*)img, (float*)ox_out, (float*)oy_out, (float*)val_out,
        H, W, inv_sig_r2, only_occlusion, freeze_valid, tab);
    return (int)cudaGetLastError();
}
