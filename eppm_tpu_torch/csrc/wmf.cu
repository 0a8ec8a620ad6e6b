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
// otherwise replaced pixels become valid.  Each iteration reads the *_in
// planes and writes the *_out planes: the wrapper ping-pongs them.  The
// support sums run in partial sums of `chunk` supports, as the plain
// version's (eppm_tpu_torch/ops/refine.py::weighted_median_filter) do, so
// the two pick the same candidate on exact cost ties (common.cuh).
//
// What bounds it on the H100: arithmetic, (valid candidate, support) pairs
// at 5 operations each, but only at the pixels whose output can change:
// with only_occlusion (the polish and Jacobi modes) a valid pixel keeps its
// input.  The design spends threads on those pixels alone and gives each a
// whole group of lanes:
//   1. wmf_list_kernel copies the *_in planes to the *_out planes and
//      appends each pixel that can change (every pixel without
//      only_occlusion) to a list, one atomicAdd a warp; the count stays on
//      the device.
//   2. wmf_median_kernel takes the list in a grid-stride loop, one group of
//      LANES lanes a pixel.  The lanes compute the support weights (the
//      same expression, in the same order) and gather, in raster order,
//      the supports of nonzero weight and the valid candidates into the
//      group's slice of shared memory.  Lane l sums the costs of candidates
//      l, l + LANES, ... over the supports in partial sums of `chunk`, two
//      candidates at a time; a reduction over (cost, candidate) keeps the
//      least cost and, among equal costs, the first candidate.  One lane
//      writes the winner.
// Identical to the plain version by construction: an invalid support's
// weight is +0 without its exp; a support of zero weight adds +0 * finite
// = +0 to a partial sum of non-negative terms, which leaves it as it was,
// so skipping it changes no bit; each candidate's cost
// is the same operations on the same operands in the same order; the
// reduction picks what the sequential strict-< scan picks.

#include "common.cuh"
#include <cfloat>
#include <climits>

#define MAX_WIN 225       // radius <= 7
#define WMF_THREADS 256   // threads a block of the median kernel
#define WMF_LANES 32      // lanes a pixel (tools/time_kernel_c.py --forms)

struct WmfTable {
    short oy[MAX_WIN];
    short ox[MAX_WIN];
    float g[MAX_WIN];
    int n;
    int chunk;
};

__global__ void wmf_list_kernel(
    const float* __restrict__ ox_in, const float* __restrict__ oy_in,
    const float* __restrict__ val_in, float* __restrict__ ox_out,
    float* __restrict__ oy_out, float* __restrict__ val_out,
    int* __restrict__ list, int* __restrict__ count, int HW,
    int only_occlusion)
{
    const int p = blockIdx.x * blockDim.x + threadIdx.x;
    bool listed = false;
    if (p < HW) {
        const float v = val_in[p];
        ox_out[p] = ox_in[p];
        oy_out[p] = oy_in[p];
        val_out[p] = v;
        listed = !only_occlusion || v == 0.f;
    }
    const int lane = threadIdx.x & 31;
    const unsigned ballot = __ballot_sync(0xffffffffu, listed);
    if (ballot == 0u)
        return;
    const int leader = __ffs(ballot) - 1;
    int base = 0;
    if (lane == leader)
        base = atomicAdd(count, __popc(ballot));
    base = __shfl_sync(0xffffffffu, base, leader);
    if (listed)
        list[base + __popc(ballot & ((1u << lane) - 1u))] = p;
}

// Bytes of dynamic shared memory of a block: per group, the supports
// (x, y, w, -) and the candidates (x, y) of one window and the end of each
// partial sum in the support list.
template <int LANES>
__host__ __device__ constexpr size_t wmf_smem_bytes(int n, int nchunks) {
    return (size_t)(WMF_THREADS / LANES) * (n * 16 + n * 8 + nchunks * 4);
}

template <int LANES>
__global__ void __launch_bounds__(WMF_THREADS) wmf_median_kernel(
    const float* __restrict__ ox_in, const float* __restrict__ oy_in,
    const float* __restrict__ val_in, const float* __restrict__ img,
    float* __restrict__ ox_out, float* __restrict__ oy_out,
    float* __restrict__ val_out, const int* __restrict__ list,
    const int* __restrict__ count, int H, int W, float inv_sig_r2,
    int freeze_valid, const __grid_constant__ WmfTable tab)
{
    constexpr int GROUPS = WMF_THREADS / LANES;
    extern __shared__ float4 wmf_smem[];
    const int n = tab.n, chunk = tab.chunk;
    const int nchunks = (n + chunk - 1) / chunk;
    const int group = threadIdx.x / LANES;
    const int lane = threadIdx.x % LANES;
    const int wl = threadIdx.x & 31;  // lane in the warp
    const unsigned gmask =
        LANES == 32 ? 0xffffffffu : ((1u << LANES) - 1u) << (wl - lane);
    const unsigned below = (1u << wl) - 1u;  // warp lanes before this one
    float4* sup = wmf_smem + group * n;
    float2* cand = reinterpret_cast<float2*>(wmf_smem + GROUPS * n) + group * n;
    int* ends = reinterpret_cast<int*>(
        reinterpret_cast<float2*>(wmf_smem + GROUPS * n) + GROUPS * n) +
        group * nchunks;

    const int total = *count;
    for (int i = blockIdx.x * GROUPS + group; i < total;
         i += gridDim.x * GROUPS) {
        const int p = list[i];
        const int y = p / W, x = p - y * W;
        const float cr = img[3 * p], cg = img[3 * p + 1], cb = img[3 * p + 2];

        // the window, LANES supports a round: weights as before; the
        // supports of nonzero weight and the valid candidates gathered in
        // raster order
        int nsup = 0, ncand = 0;
        for (int s0 = 0; s0 < n; s0 += LANES) {
            const int s = s0 + lane;
            float w = 0.f, vx = 0.f, vy = 0.f;
            bool v = false;
            if (s < n) {
                const int qy = y + tab.oy[s], qx = x + tab.ox[s];
                if (qy >= 0 && qy < H && qx >= 0 && qx < W) {
                    const size_t q = (size_t)qy * W + qx;
                    const float val = val_in[q];
                    v = val > 0.f;
                    vx = ox_in[q];
                    vy = oy_in[q];
                    // an invalid support's weight is 0 * g * exp = +0
                    if (v) {
                        const float dr = maxabs3(img[3 * q], img[3 * q + 1],
                                                 img[3 * q + 2], cr, cg, cb);
                        w = ftz(val * tab.g[s] *
                                exp_cephes(-(dr * dr) * inv_sig_r2));
                    }
                }
            }
            const unsigned ws = __ballot_sync(gmask, w > 0.f) & gmask;
            const int rank = __popc(ws & below);
            if (w > 0.f)
                sup[nsup + rank] = make_float4(vx, vy, w, 0.f);
            if (s < n && ((s + 1) % chunk == 0 || s + 1 == n))
                ends[s / chunk] = nsup + rank + (w > 0.f);
            nsup += __popc(ws);

            const unsigned cs = __ballot_sync(gmask, v) & gmask;
            if (v)
                cand[ncand + __popc(cs & below)] = make_float2(vx, vy);
            ncand += __popc(cs);
            __syncwarp(gmask);
        }

        // the costs: lane l takes candidates l, l + LANES, ..., two at a
        // time, each summed over the supports in partial sums of `chunk`
        float best = FLT_MAX;
        int bj = INT_MAX;
        if (nsup > 0) {
            for (int j = lane; j < ncand; j += 2 * LANES) {
                const bool two = j + LANES < ncand;
                const float2 c0 = cand[j];
                const float2 c1 = two ? cand[j + LANES] : c0;
                float cost0 = 0.f, cost1 = 0.f;
                int t = 0;
                for (int k = 0; k < nchunks; ++k) {
                    const int e = ends[k];
                    float part0 = 0.f, part1 = 0.f;
                    for (; t < e; ++t) {
                        const float4 sp = sup[t];
                        part0 = part0 + sp.z * fmaxf(fabsf(c0.x - sp.x),
                                                     fabsf(c0.y - sp.y));
                        part1 = part1 + sp.z * fmaxf(fabsf(c1.x - sp.x),
                                                     fabsf(c1.y - sp.y));
                    }
                    cost0 = cost0 + part0;
                    cost1 = cost1 + part1;
                }
                if (cost0 < best) {
                    best = cost0;
                    bj = j;
                }
                if (two && cost1 < best) {
                    best = cost1;
                    bj = j + LANES;
                }
            }
        }
        // the least (cost, candidate) of the group
        for (int off = LANES / 2; off > 0; off >>= 1) {
            const float ob = __shfl_xor_sync(gmask, best, off, LANES);
            const int oj = __shfl_xor_sync(gmask, bj, off, LANES);
            if (ob < best || (ob == best && oj < bj)) {
                best = ob;
                bj = oj;
            }
        }
        if (lane == 0 && best < FLT_MAX) {
            const float2 c = cand[bj];
            if (c.x + (float)x >= 0.f && c.y + (float)y >= 0.f) {
                ox_out[p] = c.x;
                oy_out[p] = c.y;
                if (!freeze_valid)
                    val_out[p] = 1.f;
            }
        }
        __syncwarp(gmask);
    }
}

// One iteration at one form: the counter zeroed, the list pass, the median
// kernel on a grid of one group a pixel of the level (the groups past the
// count exit at once).  Returns the first CUDA error.
template <int LANES>
int wmf_iteration(const float* ox_in, const float* oy_in,
                  const float* val_in, const float* img, float* ox_out,
                  float* oy_out, float* val_out, int* list, int* count,
                  const WmfTable& tab, int H, int W, float inv_sig_r2,
                  int only_occlusion, int freeze_valid, cudaStream_t stream)
{
    constexpr int GROUPS = WMF_THREADS / LANES;
    const int HW = H * W;
    cudaError_t e = cudaMemsetAsync(count, 0, sizeof(int), stream);
    if (e != cudaSuccess)
        return (int)e;
    wmf_list_kernel<<<(HW + 255) / 256, 256, 0, stream>>>(
        ox_in, oy_in, val_in, ox_out, oy_out, val_out, list, count, HW,
        only_occlusion);
    e = cudaGetLastError();
    if (e != cudaSuccess)
        return (int)e;
    auto kernel = wmf_median_kernel<LANES>;
    const size_t smem =
        wmf_smem_bytes<LANES>(tab.n, (tab.n + tab.chunk - 1) / tab.chunk);
    // past the 48 KB a block has without asking (8 lanes a pixel, or a
    // long window in short partial sums)
    if (smem > 48 * 1024) {
        e = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (e != cudaSuccess)
            return (int)e;
    }
    kernel<<<(HW + GROUPS - 1) / GROUPS, WMF_THREADS, smem, stream>>>(
        ox_in, oy_in, val_in, img, ox_out, oy_out, val_out, list, count, H,
        W, inv_sig_r2, freeze_valid, tab);
    return (int)cudaGetLastError();
}

static int wmf_table(WmfTable& tab, const int* offs, const float* g, int n,
                     int chunk, int H, int W)
{
    if (n < 1 || n > MAX_WIN || chunk < 1 || H < 1 || W < 1 ||
        (long long)H * W > INT_MAX)
        return (int)cudaErrorInvalidValue;
    tab.n = n;
    tab.chunk = chunk;
    for (int s = 0; s < n; ++s) {
        tab.oy[s] = (short)offs[2 * s];
        tab.ox[s] = (short)offs[2 * s + 1];
        tab.g[s] = g[s];
    }
    return 0;
}

// Planes (H, W) float32 and img (H, W, 3) float32 on the device; list: an
// int32 scratch of H * W entries and count: one int32, both on the device;
// offs: host (n, 2) int32 rows (oy, ox), dilated; g: host (n,) float32.
// Returns the first CUDA error of the iteration's launches.
extern "C" int eppm_wmf_iteration(
    const void* ox_in, const void* oy_in, const void* val_in, const void* img,
    void* ox_out, void* oy_out, void* val_out, void* list, void* count,
    const int* offs, const float* g, int n, int chunk, int H, int W,
    float inv_sig_r2, int only_occlusion, int freeze_valid, void* stream)
{
    WmfTable tab;
    const int rc = wmf_table(tab, offs, g, n, chunk, H, W);
    if (rc != 0)
        return rc;
    return wmf_iteration<WMF_LANES>(
        (const float*)ox_in, (const float*)oy_in, (const float*)val_in,
        (const float*)img, (float*)ox_out, (float*)oy_out, (float*)val_out,
        (int*)list, (int*)count, tab, H, W, inv_sig_r2, only_occlusion,
        freeze_valid, (cudaStream_t)stream);
}
