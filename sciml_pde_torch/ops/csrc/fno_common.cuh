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
#include <stdint.h>

#define FNO_EXPORT extern "C" __attribute__((visibility("default")))

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

// ---------------------------------------------------------------------------
// Warp-tile products of the head kernels (head_fwd_kernel in fno_fwd.cu,
// head_bwd_kernel in fno_bwd.cu).  acc is one 16 x 8 tile of an output in
// the mma.m16n8k16 accumulator layout: lane 4g + t holds rows g and g + 8,
// columns 2t and 2t + 1, as acc[0], acc[1] (row g) and acc[2], acc[3] (row
// g + 8).  tile_prod adds A (16 x K) B (K x 8) to it, both operands in
// shared memory (tiles_prod several such tiles at once):
//   A(m, k) = a[m * lda + k] (A_ROW) or a[k * lda + m]
//   B(k, n) = b[n * ldb + k] (B_NMAJ) or b[k * ldb + n]
// bf16 operands: fragments by ldmatrix (.trans where the operand is stored
// the other way round) and mma.sync m16n8k16 with f32 accumulation, one k16
// step at a time, so K is a multiple of 16 (operands zero-padded), every
// row 16-byte aligned, and rows 16 bytes apart modulo 128 are free of bank
// conflicts.  f32 operands: FMAs on the CUDA cores over k in order, any K.
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// cp.async copies into shared memory: 16 bytes (f32), 8 bytes (bf16) or
// one f32 (any 4-byte aligned address); cp_async_wait_all commits the
// thread's copies in flight and waits for all of them.
__device__ __forceinline__ void cp_async(void* dst, const float* src) {  // 16 bytes
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async(void* dst, const __nv_bfloat16* src) {  // 8 bytes
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}
// wait until at most N of the thread's committed groups are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

template <bool TRANS>
__device__ __forceinline__ void ldsm_x4(uint32_t r[4], const __nv_bfloat16* p) {
  if constexpr (TRANS)
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(smem_u32(p))
                 : "memory");
  else
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(smem_u32(p))
                 : "memory");
}

template <bool TRANS>
__device__ __forceinline__ void ldsm_x2(uint32_t r[2], const __nv_bfloat16* p) {
  if constexpr (TRANS)
    asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
                 : "=r"(r[0]), "=r"(r[1])
                 : "r"(smem_u32(p))
                 : "memory");
  else
    asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
                 : "=r"(r[0]), "=r"(r[1])
                 : "r"(smem_u32(p))
                 : "memory");
}

__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4], const uint32_t b[2]) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// two f32 values as one bf16x2 A-fragment register (lo at the lower k)
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// The A fragment of one k16 step (a points at A(0, 0) of the step): the four
// 8 x 8 matrices (rows 0-7 | 8-15) x (k 0-7 | 8-15), lanes 8s..8s+7 giving
// the row addresses of matrix s.
template <bool A_ROW>
__device__ __forceinline__ void frag_a(uint32_t r[4], const __nv_bfloat16* a, int lda) {
  const int lane = threadIdx.x & 31, i = lane & 7, m = (lane >> 3 & 1) * 8, k = (lane >> 4) * 8;
  if constexpr (A_ROW)
    ldsm_x4<false>(r, a + (m + i) * lda + k);
  else
    ldsm_x4<true>(r, a + (k + i) * lda + m);
}

// The B fragment of one k16 step (b points at B(0, 0) of the step): k 0-7
// from lanes 0-7, k 8-15 from lanes 8-15.
template <bool B_NMAJ>
__device__ __forceinline__ void frag_b(uint32_t r[2], const __nv_bfloat16* b, int ldb) {
  const int lane = threadIdx.x & 31, i = lane & 7, k = (lane >> 3 & 1) * 8;
  if constexpr (B_NMAJ)
    ldsm_x2<false>(r, b + i * ldb + k);
  else
    ldsm_x2<true>(r, b + (k + i) * ldb);
}

// tiles_prod: NA x NB tiles at once, A's m16 tiles 16 rows apart and B's n8
// tiles 8 columns apart, every k step's fragments loaded once and the NA * NB
// products independent (instruction-level parallelism); tile_prod: one tile.
template <int NA, int NB, bool A_ROW, bool B_NMAJ>
__device__ __forceinline__ void tiles_prod(float (&acc)[NA][NB][4], const __nv_bfloat16* a,
                                           int lda, const __nv_bfloat16* b, int ldb, int K) {
  const int sa = A_ROW ? 16 * lda : 16, sb = B_NMAJ ? 8 * ldb : 8;
  for (int k = 0; k < K; k += 16) {
    const __nv_bfloat16 *ak = A_ROW ? a + k : a + k * lda, *bk = B_NMAJ ? b + k : b + k * ldb;
    uint32_t fa[NA][4], fb[NB][2];
#pragma unroll
    for (int i = 0; i < NA; ++i) frag_a<A_ROW>(fa[i], ak + i * sa, lda);
#pragma unroll
    for (int j = 0; j < NB; ++j) frag_b<B_NMAJ>(fb[j], bk + j * sb, ldb);
#pragma unroll
    for (int i = 0; i < NA; ++i)
#pragma unroll
      for (int j = 0; j < NB; ++j) mma_bf16(acc[i][j], fa[i], fb[j]);
  }
}

template <int NA, int NB, bool A_ROW, bool B_NMAJ>
__device__ __forceinline__ void tiles_prod(float (&acc)[NA][NB][4], const float* a, int lda,
                                           const float* b, int ldb, int K) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int am = A_ROW ? lda : 1, ak = A_ROW ? 1 : lda;
  const int bk = B_NMAJ ? 1 : ldb, bn = B_NMAJ ? ldb : 1;
  for (int k = 0; k < K; ++k) {
    float x[NA][2], y[NB][2];
#pragma unroll
    for (int i = 0; i < NA; ++i)
#pragma unroll
      for (int r = 0; r < 2; ++r) x[i][r] = a[(16 * i + g + 8 * r) * am + k * ak];
#pragma unroll
    for (int j = 0; j < NB; ++j)
#pragma unroll
      for (int c = 0; c < 2; ++c) y[j][c] = b[k * bk + (8 * j + 2 * t + c) * bn];
#pragma unroll
    for (int i = 0; i < NA; ++i)
#pragma unroll
      for (int j = 0; j < NB; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] = fmaf(x[i][e >> 1], y[j][e & 1], acc[i][j][e]);
  }
}

template <bool A_ROW, bool B_NMAJ, typename T>
__device__ __forceinline__ void tile_prod(float (&acc)[4], const T* a, int lda, const T* b,
                                          int ldb, int K) {
  tiles_prod<1, 1, A_ROW, B_NMAJ>(*reinterpret_cast<float(*)[1][1][4]>(&acc), a, lda, b, ldb, K);
}

// The head kernels' shared-memory element: bf16 on the tensor-core path
// (`default`), f32 on the CUDA cores (`highest`).  Their layouts pad rows by
// 16 bytes of bf16 (ldmatrix without bank conflicts) or 4 floats.
template <bool TC>
struct HeadElem {
  using T = float;
};
template <>
struct HeadElem<true> {
  using T = __nv_bfloat16;
};

__device__ __forceinline__ void st_pair(float* p, float lo, float hi) {
  *reinterpret_cast<float2*>(p) = make_float2(lo, hi);
}
__device__ __forceinline__ void st_pair(__nv_bfloat16* p, float lo, float hi) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(lo, hi);
}

template <typename E>
__device__ __forceinline__ E to_elem(float v);
template <>
__device__ __forceinline__ float to_elem<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 to_elem<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// dst[r * ld + c] = src[r * cols + c] for r < rows, c < cols, and 0 for the
// rest of rows_p x cols_p, in the element type, by the whole block: lanes
// along a row (coalesced), warps over rows, 8 loads in flight a thread.
template <typename E>
__device__ __forceinline__ void stage_matrix(E* dst, int ld, const float* __restrict__ src,
                                             int rows, int cols, int rows_p, int cols_p) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nw = blockDim.x >> 5;
  for (int c = lane; c < cols_p; c += 32)
    for (int r0 = warp; r0 < rows_p; r0 += 8 * nw) {
      float v[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int r = r0 + u * nw;
        v[u] = r < rows && c < cols ? src[(size_t)r * cols + c] : 0.f;
      }
#pragma unroll
      for (int u = 0; u < 8; ++u)
        if (r0 + u * nw < rows_p) dst[(r0 + u * nw) * ld + c] = to_elem<E>(v[u]);
    }
}

// gelu(x) and gelu'(x) from one erff, with the values of gelu_f and gelu_grad_f
__device__ __forceinline__ void gelu_pair(float x, float& gelu, float& grad) {
  const float cdf = 0.5f * (1.0f + erff(x * 0.70710678118654752f));
  gelu = x * cdf;
  grad = cdf + x * (expf(-0.5f * x * x) * 0.39894228040143268f);
}

// A logical pixel pix = (b * X + x) * Y + y of a (B, ., X, Y) output, and its
// offset x * Wp + y in a channel plane of the padded (B, ., Hp, Wp) field.
struct Pixel {
  int b, xy, hw;
};
__device__ __forceinline__ Pixel pixel_at(int pix, int XY, int Y, int Wp) {
  const int b = pix / XY, xy = pix - b * XY, x = xy / Y;
  return {b, xy, x * Wp + (xy - x * Y)};
}

__host__ __device__ inline int fno_round_up(int n, int m) { return (n + m - 1) / m * m; }
__host__ __device__ inline size_t fno_align16(size_t n) { return (n + 15) / 16 * 16; }
