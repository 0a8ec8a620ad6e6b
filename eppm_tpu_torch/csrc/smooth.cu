// Kernel B: joint bilateral flow smoothing on Hopper (sm_90a).
//
// Replaces eppm_tpu/ops/pallas_smooth.py::_smooth_kernel (spec:
// d_flow_bilateral_filtering, bao_pmflow_refine_kernel.cu:749-826).  Per
// pixel p, over the (2r+1)^2 window (r = 10 by default, 441 taps):
//   w = exp(-maxabs3(img(q) - img(p))^2 / sig_r2) * g(dy, dx) * known(q)
//   out(p) = sum(w * flow(q)) / sum(w), or flow(p) where sum(w) == 0.
// Taps outside the image and taps whose flow is unknown (> 1e9 in either
// component: the 1e10 sentinel) weigh 0, so they are skipped: adding a zero
// term leaves a float sum unchanged.  g is the plain version's float32
// table of exp(-dy^2/s^2) * exp(-dx^2/s^2), passed by value.  The sums
// follow the plain version (eppm_tpu_torch/ops/refine.py::flow_smoothing)
// bit for bit: taps in row-major order, in partial sums of `chunk` taps,
// the weighted flow in two interleaved partials (even and odd taps of the
// chunk).  The next pyramid level truncates this flow, so the last bit
// matters (common.cuh).
//
// What bounds it on the H100: arithmetic and L1 traffic — 441 taps each
// read 20 B (flow float2 + three image floats) and spend one exp (a
// float64-emulated polynomial).  Simple design: one thread per pixel, a
// 32 x 8 block so each warp reads consecutive pixels of a row; the window
// stays in L1/L2.  Not yet done: a shared-memory tile with halo, or the
// separable row/column structure the Pallas kernel used.

#include "common.cuh"

#define MAX_SMOOTH_TAPS 961  // radius <= 15

struct SmoothTable {
    float g[MAX_SMOOTH_TAPS];
    int r;
    int chunk;
};

__global__ void flow_smooth_kernel(
    const float2* __restrict__ flow, const float* __restrict__ img,
    float2* __restrict__ out, int H, int W, float inv_sig_r2,
    const SmoothTable tab)
{
    const int x = blockIdx.x * blockDim.x + threadIdx.x;
    const int y = blockIdx.y * blockDim.y + threadIdx.y;
    if (x >= W || y >= H) return;
    const size_t p = (size_t)y * W + x;
    const float cr = img[3 * p], cg = img[3 * p + 1], cb = img[3 * p + 2];
    const int r = tab.r, n = 2 * r + 1, n_taps = n * n;
    float su = 0.f, sv = 0.f, sw = 0.f;
    for (int k0 = 0; k0 < n_taps; k0 += tab.chunk) {
        const int k1 = min(k0 + tab.chunk, n_taps);
        float pu[2] = {0.f, 0.f}, pv[2] = {0.f, 0.f}, pw = 0.f;
        for (int k = k0; k < k1; ++k) {
            const int yy = y + k / n - r, xx = x + k % n - r;
            if (yy < 0 || yy >= H || xx < 0 || xx >= W) continue;
            const size_t q = (size_t)yy * W + xx;
            const float2 f = flow[q];
            if (!(f.x <= EPPM_UNKNOWN_THRESH && f.y <= EPPM_UNKNOWN_THRESH))
                continue;  // unknown flow
            const float dr = maxabs3(img[3 * q], img[3 * q + 1],
                                     img[3 * q + 2], cr, cg, cb);
            const float w =
                ftz(exp_cephes(-(dr * dr) * inv_sig_r2) * tab.g[k]);
            const int j = (k - k0) & 1;
            pu[j] = pu[j] + w * f.x;
            pv[j] = pv[j] + w * f.y;
            pw = pw + w;
        }
        su = su + (pu[0] + pu[1]);
        sv = sv + (pv[0] + pv[1]);
        sw = sw + pw;
    }
    if (sw > 0.f) {
        const float den = fmaxf(sw, EPPM_TINY);
        out[p] = make_float2(su / den, sv / den);
    } else {
        out[p] = flow[p];
    }
}

// flow (H, W) float2, img (H, W, 3) float32, out (H, W) float2 on the
// device; g: host ((2r+1)^2,) float32, row-major over (dy, dx).  Returns
// cudaGetLastError() after the launch.
extern "C" int eppm_flow_smoothing(
    const void* flow, const void* img, void* out, const float* g,
    int r, int chunk, int H, int W, float inv_sig_r2, void* stream)
{
    const int n = 2 * r + 1;
    if (r < 0 || n * n > MAX_SMOOTH_TAPS || chunk < 1 || H < 1 || W < 1)
        return (int)cudaErrorInvalidValue;
    SmoothTable tab;
    tab.r = r;
    tab.chunk = chunk;
    for (int i = 0; i < n * n; ++i) tab.g[i] = g[i];
    const dim3 block(32, 8);
    const dim3 grid((W + 31) / 32, (H + 7) / 8);
    flow_smooth_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
        (const float2*)flow, (const float*)img, (float2*)out, H, W,
        inv_sig_r2, tab);
    return (int)cudaGetLastError();
}
