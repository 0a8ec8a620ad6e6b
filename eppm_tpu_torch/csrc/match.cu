// Kernel D: streaming global descriptor argmax on Hopper (sm_90a).
//
// Replaces ops/pallas_match.py::_match_kernel of eppm_tpu (wrapper
// global_argmax_pallas).  For every frame-1 descriptor a (N1 rows of D
// bf16) it finds the first frame-2 descriptor b (N2 rows) with the largest
//   s(a, b) = rint((a.b - |b|^2/2) * 4096)        (argmin |a - b|^2)
// without materialising the N1 x N2 score panel.
//
// Exactness.  The plain version (eppm_tpu_torch/ops/match.py::
// global_argmax) multiplies and sums the bf16 values in float64: a product
// of two bf16 values has 16 significant bits, so the dot products and the
// norms are exact sums and every summation order gives the same bits.
// This kernel does the same (float64 fma of bf16 values widened exactly;
// the library is built with --fmad=false, so nothing else fuses), rounds
// (dot - half_norm) * 4096 with rint (half to even, as torch.round), keeps
// the first maximum (strict > in ascending target order) and never looks
// at targets past N2.  The indices agree with the plain version's bit for
// bit.  A float32 accumulation, as the TPU's MXU does, would not.
//
// What bounds it on the H100: float64 arithmetic.  N1 * N2 * D
// multiply-adds (129,600^2 x 275 = 4.6e12 at the 4K depth-3 proposal grid)
// at the card's 64 float64 fma per clock and SM.  Simple design: one
// thread per frame-1 row keeps a running (score, index) in registers and
// 32 float64 dot-product accumulators; each block streams frame 2 through
// shared memory in tiles of 32 rows, widened to float64 once per tile and
// stored [d][row], so each step reads one frame-1 value (its own row,
// through L1) and broadcasts 32 frame-2 values to the warp.  The half
// norms |b|^2/2 come from a first, small kernel.  Measured on an NVIDIA
// H100 80GB HBM3 at 700 W: 1.33 s at N1 = N2 = 129,600 (6.95 float64
// TFLOP/s, ~20% of the card's float64 rate outside the tensor cores) and
// 17.8 ms at N1 = N2 = 8160, where 64 blocks leave half the SMs idle; the
// plain version's float64 matrix products take 0.58 s and 2.6 ms.  Not yet
// done: the tensor-core (DMMA) form, which stays exact for the same
// reason, and splitting frame 2 across blocks for small N1.

#include "common.cuh"
#include <cuda_bf16.h>
#include <math_constants.h>

#define ARGMAX_THREADS 128  // frame-1 rows per block
#define ARGMAX_TILE 32      // frame-2 rows per shared-memory tile
#define ARGMAX_MAX_D 768    // 768 x 32 x 8 B = 192 KB of tile

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

__global__ void __launch_bounds__(ARGMAX_THREADS) global_argmax_kernel(
    const __nv_bfloat16* __restrict__ d1, const __nv_bfloat16* __restrict__ d2,
    const double* __restrict__ hn, int* __restrict__ out, int N1, int N2,
    int D)
{
    extern __shared__ double2 tile2[];  // 16-byte aligned for double2 reads
    double* tile = (double*)tile2;      // [D][ARGMAX_TILE]
    const int i = blockIdx.x * ARGMAX_THREADS + threadIdx.x;
    const __nv_bfloat16* a = d1 + (size_t)min(i, N1 - 1) * D;
    double best = -CUDART_INF;
    int best_j = 0;
    for (int j0 = 0; j0 < N2; j0 += ARGMAX_TILE) {
        const int nj = min(ARGMAX_TILE, N2 - j0);
        __syncthreads();  // the previous tile is no longer read
        // neighbouring threads take neighbouring rows of one column, so the
        // shared-memory stores do not conflict
        for (int e = threadIdx.x; e < ARGMAX_TILE * D; e += ARGMAX_THREADS) {
            const int jj = e % ARGMAX_TILE, d = e / ARGMAX_TILE;
            tile[e] = jj < nj
                ? (double)__bfloat162float(d2[(size_t)(j0 + jj) * D + d])
                : 0.0;
        }
        __syncthreads();
        double acc[ARGMAX_TILE];
#pragma unroll
        for (int jj = 0; jj < ARGMAX_TILE; ++jj) acc[jj] = 0.0;
        for (int d = 0; d < D; ++d) {
            const double av = (double)__bfloat162float(a[d]);
            const double2* col = tile2 + d * (ARGMAX_TILE / 2);
#pragma unroll
            for (int q = 0; q < ARGMAX_TILE / 2; ++q) {
                const double2 b = col[q];
                acc[2 * q] = __fma_rn(av, b.x, acc[2 * q]);
                acc[2 * q + 1] = __fma_rn(av, b.y, acc[2 * q + 1]);
            }
        }
#pragma unroll
        for (int jj = 0; jj < ARGMAX_TILE; ++jj) {
            if (jj < nj) {
                const double s = rint((acc[jj] - hn[j0 + jj]) * 4096.0);
                if (s > best) {
                    best = s;
                    best_j = j0 + jj;
                }
            }
        }
    }
    if (i < N1) out[i] = best_j;
}

// d1 (N1, D) and d2 (N2, D) bf16, hn (N2,) float64 scratch, out (N1,)
// int32, all on the device.  Returns cudaGetLastError() after the launches.
extern "C" int eppm_global_argmax(const void* d1, const void* d2, void* hn,
                                  void* out, int N1, int N2, int D,
                                  void* stream)
{
    if (N1 < 1 || N2 < 1 || D < 1 || D > ARGMAX_MAX_D)
        return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    half_norm_kernel<<<(N2 + 255) / 256, 256, 0, s>>>(
        (const __nv_bfloat16*)d2, (double*)hn, N2, D);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    const int smem = D * ARGMAX_TILE * (int)sizeof(double);
    err = cudaFuncSetAttribute(global_argmax_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return (int)err;
    global_argmax_kernel<<<(N1 + ARGMAX_THREADS - 1) / ARGMAX_THREADS,
                           ARGMAX_THREADS, smem, s>>>(
        (const __nv_bfloat16*)d1, (const __nv_bfloat16*)d2,
        (const double*)hn, (int*)out, N1, N2, D);
    return (int)cudaGetLastError();
}
