// Kernel B: joint bilateral flow smoothing on Hopper (sm_90a).
//
// Replaces eppm_tpu/ops/pallas_smooth.py::_smooth_kernel (spec:
// d_flow_bilateral_filtering, bao_pmflow_refine_kernel.cu:749-826).  Per
// pixel p, over the (2r+1)^2 window (r = 10 by default, 441 taps):
//   w = exp(-maxabs3(img(q) - img(p))^2 / sig_r2) * g(dy, dx) * known(q)
//   out(p) = sum(w * flow(q)) / sum(w), or flow(p) where sum(w) == 0.
// Taps outside the image and taps whose flow is unknown (> 1e9 in either
// component: the 1e10 sentinel) weigh 0: their weight is skipped and their
// weighted flow is a +0 term.  g is the plain version's float32 table of
// exp(-dy^2/s^2) * exp(-dx^2/s^2), passed by value.  Both kernels below
// follow the plain version (eppm_tpu_torch/ops/refine.py::flow_smoothing)
// bit for bit: taps in row-major order, in partial sums of 21 taps, the
// weights in sequence and the weighted flow in XLA's order of a chunk
// (tree21 below, ops/refine.py::chunk_sum21).  The next pyramid level
// truncates this flow, so the last bit matters (common.cuh).
//
// What bounds it on the H100: the exp.  exp_cephes is a float32 polynomial
// whose multiply-adds round through float64 (fma32), ~19 conversions
// between float32 and float64 an exp, and the SM issues 16 of those a
// clock; the ~40 other float32 operations of a tap and its 20 B of reads
// cost far less.
//
// flow_smooth_pair_kernel, the default radius 10, where 2r + 1 == chunk
// and so each partial sum is one row of the window: each range weight once
// per unordered pixel pair.  The weight is symmetric bit for bit:
// |a - b| == |b - a| in IEEE arithmetic and g(dy, dx) == g(-dy, -dx), so
// w(p, p + d) at tap k is w(p + d, p) at tap n^2 - 1 - k.  A block owns a
// TH x TW tile and stages the (TH + 2r) x (TW + 2r) window of image and
// flow in shared memory.  For dy = r down to 1 it computes the 2r + 1
// fields W_e(x) = w(x, x + (-dy, e)) over their bounding box (rows of the
// tile and dy below it, TW + |e| columns), spread over the block's threads
// by one flat index; then each thread sums row -dy of its pixel p from
// W_e(p), e ascending, and adds it at once (rows -r..-1 come in sum order),
// and row +dy from W_{-dx}(p + (dy, dx)), dx ascending, and keeps it.
// Row 0 takes r fields the same way, then rows +1..+r are added in order.
// A 32 x 32 tile needs ~299 exps a pixel instead of 441; one block of 1024
// threads fills an SM's shared memory.
//
// flow_smooth_kernel, every other radius (a chunk then spans rows): one
// thread per pixel walking its window through L1, one exp per tap.

#include "common.cuh"

#define MAX_SMOOTH_TAPS 961  // radius <= 15
#define EPPM_UNKNOWN_FLOW 1e10f  // the plain version's pad: unknown flow
#define SMOOTH_CHUNK 21          // taps a partial sum

// The sum of a chunk's 21 terms t(0..20) (+0 for a missing tap) in the
// order XLA's CPU backend sums the JAX package's chunk (its reduction over
// the chunk, vectorised 8 wide): s_i = t(i) + t(i + 8), then ((s0 + s4) +
// (s2 + s6)) + ((s1 + s5) + (s3 + s7)), then ((that + t16) + t18) + (t17 +
// t19), then + t20.  t is called once a term, in the order it is needed
// (t(i), t(i + 8), t(i + 4), t(i + 12) for i = 0..3, then 16..20), so that
// only four partials are live.
template <class Term>
__device__ __forceinline__ float2 tree21(Term t)
{
    float2 a[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const float2 p0 = t(i), p8 = t(i + 8), p4 = t(i + 4),
                     p12 = t(i + 12);
        const float2 s0 = make_float2(p0.x + p8.x, p0.y + p8.y);
        const float2 s4 = make_float2(p4.x + p12.x, p4.y + p12.y);
        a[i] = make_float2(s0.x + s4.x, s0.y + s4.y);
    }
    float2 v = make_float2((a[0].x + a[2].x) + (a[1].x + a[3].x),
                           (a[0].y + a[2].y) + (a[1].y + a[3].y));
    const float2 p16 = t(16), p18 = t(18), p17 = t(17), p19 = t(19);
    v = make_float2((v.x + p16.x) + p18.x, (v.y + p16.y) + p18.y);
    v = make_float2(v.x + (p17.x + p19.x), v.y + (p17.y + p19.y));
    const float2 p20 = t(20);
    return make_float2(v.x + p20.x, v.y + p20.y);
}

struct SmoothTable {
    float g[MAX_SMOOTH_TAPS];
    int r;
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
    for (int k0 = 0; k0 < n_taps; k0 += SMOOTH_CHUNK) {
        // the chunk's weighted flows, +0 where a tap is missing, out of
        // the image or of unknown flow; its weights summed in sequence
        float2 wf[SMOOTH_CHUNK];
        float pw = 0.f;
#pragma unroll
        for (int j = 0; j < SMOOTH_CHUNK; ++j) {
            wf[j] = make_float2(0.f, 0.f);
            const int k = k0 + j;
            const int yy = y + k / n - r, xx = x + k % n - r;
            if (k >= n_taps || yy < 0 || yy >= H || xx < 0 || xx >= W)
                continue;
            const size_t q = (size_t)yy * W + xx;
            const float2 f = flow[q];
            if (!(f.x <= EPPM_UNKNOWN_THRESH && f.y <= EPPM_UNKNOWN_THRESH))
                continue;  // unknown flow
            const float dr = maxabs3(img[3 * q], img[3 * q + 1],
                                     img[3 * q + 2], cr, cg, cb);
            const float w =
                ftz(exp_cephes(-(dr * dr) * inv_sig_r2) * tab.g[k]);
            wf[j] = make_float2(w * f.x, w * f.y);
            pw = pw + w;
        }
        const float2 c = tree21([&](int j) { return wf[j]; });
        su = su + c.x;
        sv = sv + c.y;
        sw = sw + pw;
    }
    if (sw > 0.f) {
        const float den = fmaxf(sw, EPPM_TINY);
        out[p] = make_float2(su / den, sv / den);
    } else {
        out[p] = flow[p];
    }
}

// ---- the paired kernel ---------------------------------------------------

#define PAIR_R 10                       // the radius whose rows are chunks
#define PAIR_N (2 * PAIR_R + 1)
#define PAIR_G ((PAIR_R + 1) * PAIR_N)  // g of rows -r..0
static_assert(PAIR_N == SMOOTH_CHUNK, "a row of the window is a chunk");

struct PairTable {
    float g[PAIR_G];
};

// Field ei (e = ei - r) of a row pair is TW + |e| wide; in one row of the
// fields they lie side by side, e ascending, field ei from column
// pair_start(ei).  Row 0's fields, e = -r..-1, are the first r of them.
__host__ __device__ constexpr int pair_start(int ei, int TW) {
    return ei * TW + (ei <= PAIR_R
                      ? ei * PAIR_R - ei * (ei - 1) / 2
                      : PAIR_R * (PAIR_R + 1) / 2
                        + (ei - PAIR_R - 1) * (ei - PAIR_R) / 2);
}

// A TH x TW tile, PPT pixels a thread (rows ty, ty + TH / PPT, ...).
template <int TH, int TW, int PPT>
struct PairTile {
    static constexpr int R = PAIR_R, N = PAIR_N;
    static constexpr int THREADS = TH * TW / PPT;
    static constexpr int WH = TH + 2 * R, WW = TW + 2 * R;  // staged window
    static constexpr int L = pair_start(N, TW);    // a row of the fields
    static constexpr int L0 = pair_start(R, TW);   // a row of row 0's
    static constexpr int FIELD = (TH + R) * L;
    // rows +r and +r-1 of the kept row partials wait in shared memory, so
    // that the other 3 (r - 2) a pixel fit in registers without a spill
    // (64 a thread in a block of 1024)
    static constexpr int KEEP = 2;
    // image (r, g, b, known) float4 and flow float2 per window pixel, the
    // fields, g of rows -r..0, the kept partials, and the column table of
    // a row of fields
    static constexpr int SMEM = WH * WW * (16 + 8) + FIELD * 4 + PAIR_G * 4
                                + KEEP * 3 * TH * TW * 4 + L * 2;
    static_assert(TH % PPT == 0 && THREADS % 32 == 0, "tile");
    static_assert(TW + R < 64, "a field column takes 6 bits");
    static_assert(R <= TH, "a row pair's box is one span of rows");
};

// W(x) = w(x, x + (-dy, e)) for the positions (by, c) of `rows` rows of
// `len` field columns from the tile's first row (dy = 0: row 0's fields,
// len = L0, e < 0).  A weight that no known tap reads (neither x nor its
// partner holds known flow) is left 0.
template <class T>
__device__ __forceinline__ void pair_fields(
    float* field, const float4* simg, const unsigned short* cols,
    const float* sg, int dy, int rows, int len, float inv_sig_r2)
{
    const int total = rows * len;
    for (int i = threadIdx.x; i < total; i += T::THREADS) {
        const int by = i / len, c = i - by * len;
        const int code = cols[c], ei = code >> 6, e = ei - T::R;
        const int wy = T::R + by, wx = T::R - max(e, 0) + (code & 63);
        const float4 a = simg[wy * T::WW + wx];
        const float4 b = simg[(wy - dy) * T::WW + wx + e];
        float v = 0.f;
        if (a.w != 0.f || b.w != 0.f) {
            const float dr = maxabs3(b, a);
            v = ftz(exp_cephes(-(dr * dr) * inv_sig_r2)
                    * sg[(T::R - dy) * T::N + ei]);
        }
        field[by * T::L + c] = v;
    }
}

// One row of taps of a pixel, as a chunk of the plain version: the known
// taps' weights in sequence, t = dx + r ascending, and their weighted
// flows in tree21's order; returns (sum u, sum v, sum w).  frow points at
// the row's dx = 0 flow, weight(t) gives the tap's weight (a shared-memory
// read or a register: read twice, the weight sum and the tree need
// different orders, and four partials in registers keep the kernel within
// its 64 registers).
template <class Weight>
__device__ __forceinline__ float3 pair_row(const float2* frow,
                                           Weight weight)
{
    float pw = 0.f;
#pragma unroll
    for (int t = 0; t < PAIR_N; ++t) {
        const float2 f = frow[t - PAIR_R];
        if (f.x <= EPPM_UNKNOWN_THRESH && f.y <= EPPM_UNKNOWN_THRESH)
            pw = pw + weight(t);
    }
    const float2 c = tree21([&](int t) {
        const float2 f = frow[t - PAIR_R];
        if (!(f.x <= EPPM_UNKNOWN_THRESH && f.y <= EPPM_UNKNOWN_THRESH))
            return make_float2(0.f, 0.f);
        const float w = weight(t);
        return make_float2(w * f.x, w * f.y);
    });
    return make_float3(c.x, c.y, pw);
}

template <int TH, int TW, int PPT>
__global__ void __launch_bounds__(PairTile<TH, TW, PPT>::THREADS, 1)
flow_smooth_pair_kernel(
    const float2* __restrict__ flow, const float* __restrict__ img,
    float2* __restrict__ out, int H, int W, float inv_sig_r2,
    const PairTable tab)
{
    using T = PairTile<TH, TW, PPT>;
    constexpr int R = T::R, N = T::N, WW = T::WW, L = T::L;
    extern __shared__ float4 smem[];
    float4* simg = smem;
    float2* sflow = (float2*)(simg + T::WH * WW);
    float* field = (float*)(sflow + T::WH * WW);
    float* sg = field + T::FIELD;
    float* skeep = sg + PAIR_G;  // (KEEP, 3, TH * TW)
    unsigned short* cols = (unsigned short*)(skeep + T::KEEP * 3 * TH * TW);
    const int tid = threadIdx.x;
    const int y0 = blockIdx.y * TH, x0 = blockIdx.x * TW;

    // the window; out of the image the flow is unknown, as in the plain
    // version's constant pad
    for (int i = tid; i < T::WH * WW; i += T::THREADS) {
        const int wy = i / WW, wx = i - wy * WW;
        const int y = y0 - R + wy, x = x0 - R + wx;
        float4 c = make_float4(0.f, 0.f, 0.f, 0.f);
        float2 f = make_float2(EPPM_UNKNOWN_FLOW, EPPM_UNKNOWN_FLOW);
        if (y >= 0 && y < H && x >= 0 && x < W) {
            const size_t q = (size_t)y * W + x;
            f = flow[q];
            const bool known =
                f.x <= EPPM_UNKNOWN_THRESH && f.y <= EPPM_UNKNOWN_THRESH;
            c = make_float4(img[3 * q], img[3 * q + 1], img[3 * q + 2],
                            known ? 1.f : 0.f);
        }
        simg[i] = c;
        sflow[i] = f;
    }
    // column c of a row of fields -> (ei << 6) | column within field ei
    for (int c = tid; c < L; c += T::THREADS) {
        int ei = 0;
        while (c >= pair_start(ei + 1, TW)) ++ei;
        cols[c] = (unsigned short)((ei << 6) | (c - pair_start(ei, TW)));
    }
    for (int k = tid; k < PAIR_G; k += T::THREADS) sg[k] = tab.g[k];
    __syncthreads();

    const int tx = tid % TW, ty0 = tid / TW;
    constexpr int TS = TH / PPT;  // rows between a thread's pixels
    float su[PPT], sv[PPT], sw[PPT];
    float ku[PPT][R], kv[PPT][R], kw[PPT][R];  // rows +1..+r - KEEP, kept
#pragma unroll
    for (int j = 0; j < PPT; ++j) su[j] = sv[j] = sw[j] = 0.f;

#pragma unroll
    for (int dy = R; dy >= 1; --dy) {
        pair_fields<T>(field, simg, cols, sg, dy, TH + dy, L, inv_sig_r2);
        __syncthreads();
#pragma unroll
        for (int j = 0; j < PPT; ++j) {
            const int ty = ty0 + j * TS;
            const float* wneg = field + ty * L + tx;         // W_e(p)
            const float* wpos = field + (ty + dy) * L + tx;  // rows +dy
            const float3 a = pair_row(
                sflow + (ty + R - dy) * WW + tx + R, [&](int t) {
                    return wneg[pair_start(t, TW) + max(t - R, 0)];
                });
            su[j] = su[j] + a.x;
            sv[j] = sv[j] + a.y;
            sw[j] = sw[j] + a.z;
            // tap dx of row +dy: W_{-dx}(p + (dy, dx))
            const float3 b = pair_row(
                sflow + (ty + R + dy) * WW + tx + R, [&](int t) {
                    return wpos[pair_start(N - 1 - t, TW) + max(t - R, 0)];
                });
            if (dy > R - T::KEEP) {
                float* k = skeep + (R - dy) * 3 * TH * TW + ty * TW + tx;
                k[0] = b.x;
                k[TH * TW] = b.y;
                k[2 * TH * TW] = b.z;
            } else {
                ku[j][dy - 1] = b.x;
                kv[j][dy - 1] = b.y;
                kw[j][dy - 1] = b.z;
            }
        }
        __syncthreads();
    }

    // row 0: fields e = -r..-1 serve dx < 0 at p and dx > 0 at p + (0, dx)
    pair_fields<T>(field, simg, cols, sg, 0, TH, T::L0, inv_sig_r2);
    __syncthreads();
#pragma unroll
    for (int j = 0; j < PPT; ++j) {
        const int ty = ty0 + j * TS;
        const float4 c = simg[(ty + R) * WW + tx + R];
        const float dc = maxabs3(c, c);
        const float wc =
            ftz(exp_cephes(-(dc * dc) * inv_sig_r2) * sg[R * N + R]);
        const float* w0 = field + ty * L + tx;
        const float3 a = pair_row(sflow + (ty + R) * WW + tx + R, [&](int t) {
            return t < R ? w0[pair_start(t, TW)]
                 : t == R ? wc
                 : w0[pair_start(N - 1 - t, TW) + t - R];
        });
        su[j] = su[j] + a.x;
        sv[j] = sv[j] + a.y;
        sw[j] = sw[j] + a.z;
#pragma unroll
        for (int dy = 1; dy <= R; ++dy) {
            if (dy > R - T::KEEP) {
                const float* k = skeep + (R - dy) * 3 * TH * TW + ty * TW + tx;
                su[j] = su[j] + k[0];
                sv[j] = sv[j] + k[TH * TW];
                sw[j] = sw[j] + k[2 * TH * TW];
            } else {
                su[j] = su[j] + ku[j][dy - 1];
                sv[j] = sv[j] + kv[j][dy - 1];
                sw[j] = sw[j] + kw[j][dy - 1];
            }
        }
        const int y = y0 + ty, x = x0 + tx;
        if (y < H && x < W) {
            const size_t p = (size_t)y * W + x;
            if (sw[j] > 0.f) {
                const float den = fmaxf(sw[j], EPPM_TINY);
                out[p] = make_float2(su[j] / den, sv[j] / den);
            } else {
                out[p] = flow[p];
            }
        }
    }
}

template <int TH, int TW, int PPT>
static int launch_pair(const void* flow, const void* img, void* out,
                       const float* g, int H, int W, float inv_sig_r2,
                       cudaStream_t stream)
{
    using T = PairTile<TH, TW, PPT>;
    PairTable tab;
    for (int k = 0; k < PAIR_G; ++k) tab.g[k] = g[k];
    cudaError_t err = cudaFuncSetAttribute(
        flow_smooth_pair_kernel<TH, TW, PPT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH);
    flow_smooth_pair_kernel<TH, TW, PPT><<<grid, T::THREADS, T::SMEM,
                                           stream>>>(
        (const float2*)flow, (const float*)img, (float2*)out, H, W,
        inv_sig_r2, tab);
    return (int)cudaGetLastError();
}

// flow (H, W) float2, img (H, W, 3) float32, out (H, W) float2 on the
// device; g: host ((2r+1)^2,) float32, row-major over (dy, dx).  Returns
// cudaGetLastError() after the launch.
extern "C" int eppm_flow_smoothing(
    const void* flow, const void* img, void* out, const float* g,
    int r, int chunk, int H, int W, float inv_sig_r2, void* stream)
{
    const int n = 2 * r + 1;
    if (r < 0 || n * n > MAX_SMOOTH_TAPS || chunk != SMOOTH_CHUNK || H < 1
        || W < 1)
        return (int)cudaErrorInvalidValue;
    SmoothTable tab;
    tab.r = r;
    for (int i = 0; i < n * n; ++i) tab.g[i] = g[i];
    const dim3 block(32, 8);
    const dim3 grid((W + 31) / 32, (H + 7) / 8);
    flow_smooth_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
        (const float2*)flow, (const float*)img, (float2*)out, H, W,
        inv_sig_r2, tab);
    return (int)cudaGetLastError();
}

// The paired kernel: the same arguments; only r = 10 with chunk = 2r + 1.
// 32 x 32 tiles, one pixel a thread.
extern "C" int eppm_flow_smoothing_paired(
    const void* flow, const void* img, void* out, const float* g,
    int r, int chunk, int H, int W, float inv_sig_r2, void* stream)
{
    if (r != PAIR_R || chunk != PAIR_N || H < 1 || W < 1)
        return (int)cudaErrorInvalidValue;
    return launch_pair<32, 32, 1>(flow, img, out, g, H, W, inv_sig_r2,
                                  (cudaStream_t)stream);
}
