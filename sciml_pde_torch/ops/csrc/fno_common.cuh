// Shared helpers of the FNO-2D fused-step kernels (fno_fwd.cu, fno_bwd.cu).
//
// Precision contract (mirrors the JAX package's SCIML_DFT_PRECISION knob):
// every product that the reference writes as a matrix product ("dot") takes
// its inputs rounded to bf16 when `bf` is set and accumulates in f32.  The
// wrappers pass constant matrices (DFT factors, dense weights) already
// rounded; the kernels round activations at the point where they enter a
// product.  Mode mixes, bias adds and sums are never rounded.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

#define FNO_EXPORT extern "C" __attribute__((visibility("default")))

// Most channels a thread keeps in registers (width, lift inputs, head outputs).
#define FNO_MAXC 32
#define FNO_MAXCO 8

__device__ __forceinline__ float rd(float x, int bf) {
  return bf ? __bfloat162float(__float2bfloat16_rn(x)) : x;
}

__device__ __forceinline__ float ldv(const float* p) { return *p; }
__device__ __forceinline__ float ldv(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void stv(float* p, float v) { *p = v; }
__device__ __forceinline__ void stv(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// Exact (erf) gelu, torch F.gelu's default, and its derivative.
__device__ __forceinline__ float gelu_f(float x) {
  return 0.5f * x * (1.0f + erff(x * 0.70710678118654752f));
}
__device__ __forceinline__ float gelu_grad_f(float x) {
  const float cdf = 0.5f * (1.0f + erff(x * 0.70710678118654752f));
  const float pdf = expf(-0.5f * x * x) * 0.39894228040143268f;
  return cdf + x * pdf;
}

// Kernels above 48 KB of dynamic shared memory must opt in before launch.
template <typename F>
static cudaError_t fno_set_smem(F* kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}
