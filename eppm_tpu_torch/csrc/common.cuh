// Arithmetic shared by the port's CUDA kernels (cost.cu, smooth.cu, wmf.cu).
//
// Each kernel computes the same float32 operations, in the same order, as
// its plain PyTorch version, so the two agree bit for bit: the pipeline
// takes argmins over quantized costs and truncates smoothed flow, and a
// last-bit difference there moves whole pixels.  To that end:
//   * the library is built with --fmad=false, so a * b + c stays two
//     roundings unless written as fma32 below;
//   * fma32 is the plain version's float64 form of a fused multiply-add
//     (eppm_tpu_torch/ops/_util.py::fma32): the product of two float32
//     values is exact in float64, then one addition and one rounding;
//   * exp_cephes is eppm_tpu_torch/ops/_util.py::exp_cephes, the float32
//     exp of the JAX package's CPU backend, step for step (expf and
//     __expf round differently);
//   * constants are hexadecimal literals of the float32 values the plain
//     version holds, so no decimal literal is rounded differently.

#pragma once

#include <cuda_runtime.h>

#define EPPM_FLT_MIN 0x1p-126f           // smallest normal float32
#define EPPM_TINY 0x1.4484cp-100f        // float32(1e-30), the divisor floor
#define EPPM_UNKNOWN_THRESH 0x1.dcd65p+29f  // 1e9: larger flow is unknown

// Subnormal values flush to zero (eppm_tpu_torch/ops/_util.py::ftz).
__device__ __forceinline__ float ftz(float v) {
    return v < EPPM_FLT_MIN ? 0.f : v;
}

__device__ __forceinline__ float fma32(float a, float b, float c) {
    return (float)((double)a * (double)b + (double)c);
}

__device__ __forceinline__ float exp_cephes(float x) {
    x = fminf(fmaxf(x, -0x1.5f3334p+6f), 0x1.633334p+6f);  // [-87.8, 88.8]
    float n = floorf(fma32(x, 0x1.715476p+0f, 0.5f));       // x log2(e) + .5
    n = fminf(fmaxf(n, -127.f), 127.f);
    float a = fma32(n, -0x1.63p-1f, x);                     // - n ln2 (hi)
    a = fma32(n, 0x1.bd0106p-13f, a);                       // - n ln2 (lo)
    float z = fma32(a, 0x1.a0d2cep-13f, 0x1.6e879cp-10f);
    z = fma32(z, a, 0x1.11121p-7f);
    z = fma32(z, a, 0x1.555382p-5f);
    z = fma32(z, a, 0x1.555554p-3f);
    z = fma32(z, a, 0.5f);
    z = fma32(z, a * a, a);
    z = 1.f + z;
    const float pow2 = __int_as_float(((int)n + 127) << 23);
    return ftz(z * pow2);
}

__device__ __forceinline__ int clampi(int v, int n) {
    return v < 0 ? 0 : (v >= n ? n - 1 : v);
}

// max over r, g, b of |a - b|
__device__ __forceinline__ float maxabs3(float ar, float ag, float ab,
                                         float br, float bg, float bb) {
    return fmaxf(fmaxf(fabsf(ar - br), fabsf(ag - bg)), fabsf(ab - bb));
}

__device__ __forceinline__ float maxabs3(float4 a, float4 b) {
    return maxabs3(a.x, a.y, a.z, b.x, b.y, b.z);
}
