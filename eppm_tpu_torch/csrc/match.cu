// Kernel D: exact global descriptor argmax on the H100's float64 tensor
// cores (sm_90a).
//
// Replaces ops/pallas_match.py::_match_kernel of eppm_tpu (wrapper
// global_argmax_pallas).  For every frame-1 descriptor a (N1 rows of D
// bf16) it finds the first frame-2 descriptor b (N2 rows) with the largest
//   s(a, b) = rint((a.b - |b|^2/2) * 4096)        (argmin |a - b|^2)
// without materialising the N1 x N2 score panel.
//
// Exactness, and its condition.  The plain version (eppm_tpu_torch/ops/
// match.py::global_argmax) multiplies and sums the bf16 values in float64.
// A product of two bf16 values has 16 significant bits and is exact; a
// sum of such products is exact in every order when the lowest bit of
// every product lies within float64's 53 bits of the largest partial sum.
// With partial sums below 2^10 that holds when no nonzero feature is
// smaller than 2^-15 in magnitude (its lowest bit >= 2^-22, a product's
// >= 2^-44).  Then the tensor cores' float64 MMA (DMMA), which multiplies
// and adds in IEEE float64 in its own order, gives the plain version's
// dot products bit for bit.  Descriptors of frames with near-black
// regions break the condition (smoothing leaves features of 2^-28 there):
// the sums may then round, the kernel's and the plain version's dot
// products may differ in their last bits, and an index differs only where
// a score lies within those bits of a rounding half-step.
// The epilogue rounds (dot - half_norm) * 4096 with rint (half to even, as
// torch.round), in the plain version's float64 operations and order (the
// library is built with --fmad=false), keeps the first maximum and never
// looks at targets past N2.  A float32 accumulation, as the TPU's MXU
// does, would not be exact.
//
// What bounds it on the H100: float64 tensor-core arithmetic.  2 N1 N2 D
// operations (9.24e12 at the 4K depth-3 proposal grid, N1 = N2 = 129,600,
// D = 275) at 67 TFLOP/s take 138 ms; the descriptors (143 MB) take
// 0.04 ms.  The design:
//   * DMMA: mma.sync with float64 operands, m16n8k4 (one of sm_90's
//     shapes).  The features are padded with zeros to a multiple of 32:
//     zeros change no sum.
//   * Register blocking: a block of 8 warps computes a 128 x 64 tile of
//     raw dot products, each warp a 32 x 32 part in 32 float64 accumulators
//     per thread; two blocks fit on an SM.  Each fragment value loaded
//     from shared memory and widened from bf16 to float64 feeds 2 (frame 2)
//     or 4 (frame 1) MMAs.
//   * A cp.async pipeline: a first kernel copies both frames' rows into
//     scratch padded to a multiple of 32 features (rows of 275 bf16 are
//     only 2-byte aligned, cp.async moves aligned 16-byte pieces); the
//     block then streams 32-feature chunks of its 192 rows through a ring
//     of 4 shared-memory stages, 3 chunks in flight while one is
//     multiplied, one barrier per chunk.  This took 210 ms against 233 ms
//     for staging each chunk synchronously, widened to float64 on the way
//     in, with two barriers (NVIDIA H100 80GB HBM3, 700 W).
//   * Fused epilogue: each thread rounds its own accumulators and keeps a
//     running (score, index) per row in registers, the first maximum
//     (strict > in ascending target order).  A block walks its range of
//     frame-2 tiles, so the maximum never leaves the chip (the Pallas
//     kernel's VMEM scratch).  At the end the 4 threads that share a row
//     merge by shuffles and the 2 warps that share rows through shared
//     memory, by (score descending, index ascending).
//   * Frame 2 split across blocks: when N1 has too few 128-row tiles to
//     fill the SMs, the wrapper's planner (ops/cuda_match.py::
//     plan_global_argmax) cuts the frame-2 tiles into `splits` ranges, one
//     grid row each; it takes the tile and the blocks resident per SM
//     from eppm_global_argmax_geometry, so the two never disagree.  Each
//     split writes its (score, index) for every row to
//     a scratch, and merge_split_kernel takes the largest score and, on
//     ties, the lowest index: deterministic, and the same result as one
//     sweep.
// The half norms |b|^2/2 come from a small kernel of their own.

#include "common.cuh"
#include <cuda_bf16.h>
#include <math_constants.h>

#define ARGMAX_BM 128       // frame-1 rows per block
#define ARGMAX_BN 64        // frame-2 rows per tile
#define ARGMAX_BK 32        // features per shared-memory chunk
#define ARGMAX_WARPS_M 4
#define ARGMAX_WARPS_N 2
#define ARGMAX_THREADS (32 * ARGMAX_WARPS_M * ARGMAX_WARPS_N)
#define ARGMAX_MI (ARGMAX_BM / ARGMAX_WARPS_M / 8)  // 8-row groups per warp
#define ARGMAX_NI (ARGMAX_BN / ARGMAX_WARPS_N / 8)  // 8-column groups per warp
#define ARGMAX_MAX_D 768

// Shared-memory ring of chunks: each stage holds the block's 128 frame-1
// and 64 frame-2 rows of one 32-feature chunk in bf16, rows 40 values
// (80 B) apart: 16-byte aligned for cp.async, and the fragment loads of a
// warp fall on distinct banks.
#define ARGMAX_STAGES 4
#define ARGMAX_LDK 40
#define ARGMAX_STAGE_ELEMS ((ARGMAX_BM + ARGMAX_BN) * ARGMAX_LDK)

typedef double Acc[ARGMAX_MI][ARGMAX_NI][2];

// One 4-feature step of the warp's 32 x 32 part: m16n8k4 float64 MMAs,
// row groups 2q and 2q + 1 as each MMA's upper and lower 8 rows.
// acc[r][c][h] is row 8r + g, column 8c + 2t + h of the part, for
// lane = 4g + t (the float64 MMA accumulator layout); a[r] is row 8r + g,
// feature t of the step; b[c] is column 8c + g, feature t.
__device__ __forceinline__ void mma_step(Acc& acc,
                                         const double (&a)[ARGMAX_MI],
                                         const double (&b)[ARGMAX_NI])
{
#pragma unroll
    for (int q = 0; q < ARGMAX_MI / 2; ++q)
#pragma unroll
        for (int c = 0; c < ARGMAX_NI; ++c)
            asm("mma.sync.aligned.m16n8k4.row.col.f64.f64.f64.f64 "
                "{%0,%1,%2,%3}, {%4,%5}, {%6}, {%0,%1,%2,%3};"
                : "+d"(acc[2 * q][c][0]), "+d"(acc[2 * q][c][1]),
                  "+d"(acc[2 * q + 1][c][0]), "+d"(acc[2 * q + 1][c][1])
                : "d"(a[2 * q]), "d"(a[2 * q + 1]), "d"(b[c]));
}

// (s, j) replaces (best, best_j) if it scores higher, or the same at a
// lower index: the merge order of everything that is not one ascending
// sweep.
__device__ __forceinline__ void take_better(double& best, int& best_j,
                                            double s, int j)
{
    if (s > best || (s == best && j < best_j)) {
        best = s;
        best_j = j;
    }
}

__global__ void half_norm_kernel(const __nv_bfloat16* __restrict__ d2,
                                 double* __restrict__ hn, int N2, int D)
{
    const int j = blockIdx.x * blockDim.x + threadIdx.x;
    if (j >= N2) return;
    const __nv_bfloat16* row = d2 + (size_t)j * D;
    double s = 0.0;
    for (int d = 0; d < D; ++d) {
        const double v = (double)__bfloat162float(row[d]);
        s = __fma_rn(v, v, s);
    }
    hn[j] = 0.5 * s;
}

// Rows of the padded copies: n rows of Dp bf16, zero from D on.
__global__ void pad_rows_kernel(const __nv_bfloat16* __restrict__ src,
                                __nv_bfloat16* __restrict__ dst, int n, int D,
                                int Dp)
{
    const long long total = (long long)n * Dp;
    for (long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x;
         e < total; e += (long long)gridDim.x * blockDim.x) {
        const int k = (int)(e % Dp);
        dst[e] = k < D ? src[e / Dp * D + k] : __float2bfloat16(0.f);
    }
}

// Blocks of 256 threads for pad_rows_kernel over n rows: one element a
// thread, at most 2^20 blocks.
static int pad_blocks(int n, int Dp)
{
    const long long blocks = ((long long)n * Dp + 255) / 256;
    return (int)(blocks < (1 << 20) ? blocks : (1 << 20));
}

__device__ __forceinline__ double widen(__nv_bfloat16 v)
{
    return (double)__bfloat162float(v);
}

// 16 bytes from global to shared memory, asynchronously; zeros where
// !valid (src is then not read).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid)
{
    const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
                 "l"(src), "r"(valid ? 16 : 0));
}

// Chunk [k0, k0 + 32) of frame-1 rows i0.. and frame-2 rows j0.. (padded
// copies, Dp bf16 a row) into one stage: 192 rows of four 16-byte pieces,
// three per thread; rows past N1 or N2 are zeros.
__device__ __forceinline__ void fetch_chunk(
    __nv_bfloat16* stage, const __nv_bfloat16* __restrict__ d1p,
    const __nv_bfloat16* __restrict__ d2p, int i0, int j0, int k0, int N1,
    int N2, int Dp)
{
#pragma unroll
    for (int q = 0; q < (ARGMAX_BM + ARGMAX_BN) * 4 / ARGMAX_THREADS; ++q) {
        const int e = threadIdx.x + q * ARGMAX_THREADS;
        const int row = e / 4, piece = e % 4;
        const bool a = row < ARGMAX_BM;
        const int i = a ? i0 + row : j0 + row - ARGMAX_BM;
        const int n = a ? N1 : N2;
        const __nv_bfloat16* src =
            (a ? d1p : d2p) + (size_t)min(i, n - 1) * Dp + k0 + 8 * piece;
        cp_async16(stage + row * ARGMAX_LDK + 8 * piece, src, i < n);
    }
    asm volatile("cp.async.commit_group;\n" ::);
}

// Grid (ceil(N1 / 128), splits): block (x, y) takes frame-1 rows
// [128 x, 128 x + 128) against frame-2 tiles [y tps, (y + 1) tps), one
// 32-feature chunk after another through a ring of ARGMAX_STAGES stages
// (ARGMAX_STAGES - 1 chunks in flight while one is multiplied).  With
// part_score == nullptr (one split) it writes the indices to out, else its
// (score, index) per row to part_score / part_idx [y][row].
__global__ void __launch_bounds__(ARGMAX_THREADS, 2) global_argmax_kernel(
    const __nv_bfloat16* __restrict__ d1p,
    const __nv_bfloat16* __restrict__ d2p, const double* __restrict__ hn,
    double* __restrict__ part_score, int* __restrict__ part_idx,
    int* __restrict__ out, int N1, int N2, int Dp, int tiles_per_split)
{
    extern __shared__ double smem[];
    __nv_bfloat16* ring = (__nv_bfloat16*)smem;
    const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
    const int g = lane / 4, t = lane % 4;
    const int wm = (warp % ARGMAX_WARPS_M) * (ARGMAX_MI * 8);
    const int wn = (warp / ARGMAX_WARPS_M) * (ARGMAX_NI * 8);
    const int i0 = blockIdx.x * ARGMAX_BM;
    const int tile0 = blockIdx.y * tiles_per_split;
    const int tile1 = min(tile0 + tiles_per_split,
                          (N2 + ARGMAX_BN - 1) / ARGMAX_BN);
    const int chunks = Dp / ARGMAX_BK;              // per tile
    const int steps = (tile1 - tile0) * chunks;     // (tile, chunk) pairs

    double best[ARGMAX_MI];
    int best_j[ARGMAX_MI];
#pragma unroll
    for (int r = 0; r < ARGMAX_MI; ++r) {
        best[r] = -CUDART_INF;
        best_j[r] = tile0 * ARGMAX_BN;
    }
    for (int q = 0; q < ARGMAX_STAGES - 1; ++q) {
        if (q < steps)
            fetch_chunk(ring + q * ARGMAX_STAGE_ELEMS, d1p, d2p, i0,
                        (tile0 + q / chunks) * ARGMAX_BN,
                        q % chunks * ARGMAX_BK, N1, N2, Dp);
        else
            asm volatile("cp.async.commit_group;\n" ::);  // keep the count
    }
    Acc acc;
#pragma unroll
    for (int r = 0; r < ARGMAX_MI; ++r)
#pragma unroll
        for (int c = 0; c < ARGMAX_NI; ++c) acc[r][c][0] = acc[r][c][1] = 0.0;
    for (int step = 0; step < steps; ++step) {
        // this step's chunk has landed, and every thread is done with the
        // stage the next fetch overwrites (the previous step's)
        asm volatile("cp.async.wait_group %0;\n" ::"n"(ARGMAX_STAGES - 2));
        __syncthreads();
        const int next = step + ARGMAX_STAGES - 1;
        if (next < steps)
            fetch_chunk(ring + next % ARGMAX_STAGES * ARGMAX_STAGE_ELEMS, d1p,
                        d2p, i0, (tile0 + next / chunks) * ARGMAX_BN,
                        next % chunks * ARGMAX_BK, N1, N2, Dp);
        else
            asm volatile("cp.async.commit_group;\n" ::);
        const __nv_bfloat16* As =
            ring + step % ARGMAX_STAGES * ARGMAX_STAGE_ELEMS;
        const __nv_bfloat16* Bs = As + ARGMAX_BM * ARGMAX_LDK;
#pragma unroll
        for (int kb = 0; kb < ARGMAX_BK; kb += 4) {
            const int k = kb + t;
            double a[ARGMAX_MI], b[ARGMAX_NI];
#pragma unroll
            for (int r = 0; r < ARGMAX_MI; ++r)
                a[r] = widen(As[(wm + 8 * r + g) * ARGMAX_LDK + k]);
#pragma unroll
            for (int c = 0; c < ARGMAX_NI; ++c)
                b[c] = widen(Bs[(wn + 8 * c + g) * ARGMAX_LDK + k]);
            mma_step(acc, a, b);
        }
        if (step % chunks != chunks - 1) continue;
        // the tile's dot products are complete: each row's columns in
        // ascending order, so the first maximum stays
        const int j0 = (tile0 + step / chunks) * ARGMAX_BN;
#pragma unroll
        for (int c = 0; c < ARGMAX_NI; ++c)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                const int j = j0 + wn + 8 * c + 2 * t + h;
                if (j < N2) {
                    const double hj = __ldg(hn + j);
#pragma unroll
                    for (int r = 0; r < ARGMAX_MI; ++r) {
                        const double s = rint((acc[r][c][h] - hj) * 4096.0);
                        if (s > best[r]) {
                            best[r] = s;
                            best_j[r] = j;
                        }
                    }
                }
            }
#pragma unroll
        for (int r = 0; r < ARGMAX_MI; ++r)
#pragma unroll
            for (int c = 0; c < ARGMAX_NI; ++c) acc[r][c][0] = acc[r][c][1] = 0.0;
    }
    asm volatile("cp.async.wait_group 0;\n" ::);

    // the 4 lanes of a row, then the warps of a row
#pragma unroll
    for (int r = 0; r < ARGMAX_MI; ++r)
#pragma unroll
        for (int off = 1; off < 4; off *= 2)
            take_better(best[r], best_j[r],
                        __shfl_xor_sync(0xffffffffu, best[r], off),
                        __shfl_xor_sync(0xffffffffu, best_j[r], off));
    __syncthreads();  // the ring is no longer read
    double* ms = smem;                                         // [WARPS_N][BM]
    int* mj = (int*)(smem + ARGMAX_WARPS_N * ARGMAX_BM);       // [WARPS_N][BM]
    if (t == 0) {
        const int w = warp / ARGMAX_WARPS_M;
#pragma unroll
        for (int r = 0; r < ARGMAX_MI; ++r) {
            ms[w * ARGMAX_BM + wm + 8 * r + g] = best[r];
            mj[w * ARGMAX_BM + wm + 8 * r + g] = best_j[r];
        }
    }
    __syncthreads();
    for (int row = threadIdx.x; row < ARGMAX_BM; row += ARGMAX_THREADS) {
        const int i = i0 + row;
        if (i >= N1) break;
        double s = ms[row];
        int j = mj[row];
        for (int w = 1; w < ARGMAX_WARPS_N; ++w)
            take_better(s, j, ms[w * ARGMAX_BM + row], mj[w * ARGMAX_BM + row]);
        if (part_score == nullptr) {
            out[i] = j;
        } else {
            part_score[(size_t)blockIdx.y * N1 + i] = s;
            part_idx[(size_t)blockIdx.y * N1 + i] = j;
        }
    }
}

// The splits' (score, index) per row -> the index of the largest score,
// the lowest index on ties.
__global__ void merge_split_kernel(const double* __restrict__ part_score,
                                   const int* __restrict__ part_idx,
                                   int* __restrict__ out, int N1, int splits)
{
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= N1) return;
    double s = part_score[i];
    int j = part_idx[i];
    for (int q = 1; q < splits; ++q)
        take_better(s, j, part_score[(size_t)q * N1 + i],
                    part_idx[(size_t)q * N1 + i]);
    out[i] = j;
}

// The argmax kernel's dynamic shared memory, the larger of the ring and
// the end's merge ((double, int) per row and warp column), allowed for it
// on the current device.
static cudaError_t allow_argmax_smem(int* smem)
{
    const int ring_bytes = ARGMAX_STAGES * ARGMAX_STAGE_ELEMS * 2;
    const int merge_bytes =
        ARGMAX_WARPS_N * ARGMAX_BM * (int)(sizeof(double) + sizeof(int));
    *smem = ring_bytes > merge_bytes ? ring_bytes : merge_bytes;
    return cudaFuncSetAttribute(global_argmax_kernel,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                *smem);
}

// What the wrapper's planner needs, from the library itself: geo[0..2] =
// the tile (ARGMAX_BM, ARGMAX_BN, ARGMAX_BK), geo[3] = argmax blocks
// resident on one SM of the current device, and for the record geo[4] =
// its registers a thread and geo[5] = its local memory a thread in bytes
// (spills).  Returns a CUDA error code.
extern "C" int eppm_global_argmax_geometry(int* geo)
{
    int smem;
    cudaError_t err = allow_argmax_smem(&smem);
    if (err != cudaSuccess) return (int)err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &geo[3], global_argmax_kernel, ARGMAX_THREADS, smem);
    if (err != cudaSuccess) return (int)err;
    cudaFuncAttributes attr;
    err = cudaFuncGetAttributes(&attr, global_argmax_kernel);
    if (err != cudaSuccess) return (int)err;
    geo[0] = ARGMAX_BM;
    geo[1] = ARGMAX_BN;
    geo[2] = ARGMAX_BK;
    geo[4] = attr.numRegs;
    geo[5] = (int)attr.localSizeBytes;
    return 0;
}

// d1 (N1, D) and d2 (N2, D) bf16; scratch d1p (N1, Dp) and d2p (N2, Dp)
// bf16 for the copies padded to Dp = D rounded up to 32, hn (N2,)
// float64; out (N1,) int32; all on the device.  Frame 2's ceil(N2 / 64)
// tiles go to `splits` ranges of `tiles_per_split`, none of them empty;
// with splits > 1, part_score (splits, N1) float64 and part_idx (splits,
// N1) int32 are the scratch of the merge.  Returns cudaGetLastError()
// after the launches.
extern "C" int eppm_global_argmax(const void* d1, const void* d2, void* d1p,
                                  void* d2p, void* hn, void* part_score,
                                  void* part_idx, void* out, int N1, int N2,
                                  int D, int splits, int tiles_per_split,
                                  void* stream)
{
    const long long tiles = (N2 + (long long)ARGMAX_BN - 1) / ARGMAX_BN;
    if (N1 < 1 || N2 < 1 || D < 1 || D > ARGMAX_MAX_D || splits < 1 ||
        splits > 65535 || tiles_per_split < 1 ||
        (long long)(splits - 1) * tiles_per_split >= tiles ||
        (long long)splits * tiles_per_split < tiles ||
        (splits > 1 && (part_score == nullptr || part_idx == nullptr)))
        return (int)cudaErrorInvalidValue;
    const int Dp = (D + ARGMAX_BK - 1) / ARGMAX_BK * ARGMAX_BK;
    cudaStream_t s = (cudaStream_t)stream;
    pad_rows_kernel<<<pad_blocks(N1, Dp), 256, 0, s>>>(
        (const __nv_bfloat16*)d1, (__nv_bfloat16*)d1p, N1, D, Dp);
    pad_rows_kernel<<<pad_blocks(N2, Dp), 256, 0, s>>>(
        (const __nv_bfloat16*)d2, (__nv_bfloat16*)d2p, N2, D, Dp);
    half_norm_kernel<<<(N2 + 255) / 256, 256, 0, s>>>(
        (const __nv_bfloat16*)d2, (double*)hn, N2, D);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    int smem;
    err = allow_argmax_smem(&smem);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((N1 + ARGMAX_BM - 1) / ARGMAX_BM, splits);
    global_argmax_kernel<<<grid, ARGMAX_THREADS, smem, s>>>(
        (const __nv_bfloat16*)d1p, (const __nv_bfloat16*)d2p,
        (const double*)hn, splits > 1 ? (double*)part_score : nullptr,
        (int*)part_idx, (int*)out, N1, N2, Dp, tiles_per_split);
    err = cudaGetLastError();
    if (err != cudaSuccess || splits == 1) return (int)err;
    merge_split_kernel<<<(N1 + 255) / 256, 256, 0, s>>>(
        (const double*)part_score, (const int*)part_idx, (int*)out, N1,
        splits);
    return (int)cudaGetLastError();
}
