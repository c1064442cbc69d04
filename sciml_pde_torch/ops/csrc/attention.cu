// Flash attention on Hopper (sm_90a): forward, dQ and dK/dV.
//
// Replaces the TPU kernels of sciml_pde_tpu/ops/attention.py:
//   attention_fwd  <- _fwd_kernel (_attention_fwd_flat)      B3
//   attention_dq   <- _dq_kernel  (_attention_bwd_flat)      B4
//   attention_dkv  <- _dkv_kernel (_attention_bwd_flat)      B5
// on (BH, N, D) panels, q/k/v/do in f32 or bf16, l and delta (BH, N, 1) f32.
//
// The TPU kernels hold a whole K/V (or Q/dO) panel in VMEM.  At the NS
// transformer's shape (N = 1280, D = 64, bf16) K plus V alone are 320 KB,
// above the 227 KB of shared memory a block may use.  So each block owns a
// 64-row tile and loops over the other panel in 64-row tiles:
//   forward  one block per (bh, 64 queries); an online max and sum over the
//            K/V tiles (rescaling the running output), then o = acc / sum and
//            l = m + log(sum), as _fwd_kernel's m + log(denom);
//   dQ       one block per (bh, 64 queries), loops over K/V tiles;
//   dK/dV    one block per (bh, 64 keys), loops over Q/dO tiles.
// No block writes what another reads, and there are no atomics.
//
// Numerics follow the Pallas bodies: every input is widened to f32 on load,
// q is scaled in f32 before q.k^T, p and ds stay f32 into their products,
// dq = (ds.k) * scale and dk = (ds^T.q) * scale with the unscaled q, and the
// outputs are rounded to the input type once, at the store.
//
// Bound (H100 SXM data sheet): 4*BH*N^2*D operations in the forward, 6x and
// 8x that over two in dQ and dK/dV, all far above the bytes moved (N^2*D
// work on N*D data), so every kernel is bound by operations.  p and ds are
// f32, so at least half of the products run at the f32 rate of the CUDA
// cores (67 TFLOP/s).  This first design keeps every product as f32 FMAs on
// the CUDA cores: 256 threads, each owning a 4x4 tile of the 64x64 score
// tile and 4 x D/16 of the output tile, operands read from row-major
// shared-memory tiles padded by 4 floats (rows stay 16-byte aligned and the
// reads are free of bank conflicts).  Tensor cores (mma/wgmma on the bf16
// products), TMA and warp specialisation are left for a later change.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

#define ATT_EXPORT extern "C" __attribute__((visibility("default")))

namespace {

constexpr int TILE = 64;       // query rows and key rows per tile
constexpr int NT = 256;        // threads per block: 16 x 16
constexpr int SP = TILE + 4;   // row stride of the 64x64 score tiles

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ void st(float* p, float v) { *p = v; }
__device__ __forceinline__ void st(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

// Rows [r0, r0 + TILE) of a (n, D) panel into a row-major f32 tile with row
// stride D + 4, each value times `mul` in f32 (1 leaves it exact); rows at
// or past n are zero.
template <int D, typename T>
__device__ __forceinline__ void load_tile(float* dst, const T* src, int r0, int n,
                                          float mul = 1.f) {
  for (int i = threadIdx.x; i < TILE * D; i += NT) {
    const int r = i / D, c = i - r * D;
    dst[r * (D + 4) + c] = (r0 + r < n) ? ld(src + (size_t)(r0 + r) * D + c) * mul : 0.f;
  }
}

__device__ __forceinline__ void load_rows(float* dst, const float* src, int r0, int n) {
  for (int i = threadIdx.x; i < TILE; i += NT) dst[i] = (r0 + i < n) ? src[r0 + i] : 0.f;
}

// s[i][j] = sum_d a'[ra + i][d] * b[tx + 16 j][d]: the 4 rows of a tile at
// ra against 4 strided rows of another, both row stride D + 4.  With SCALED,
// a' = a * scale in f32 before the product (q.astype(f32) * scale), else a.
template <int D, bool SCALED>
__device__ __forceinline__ void dot_tile(float s[4][4], const float* a, int ra,
                                         const float* b, int tx, float scale) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; d += 4) {
    float4 av[4], bv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      av[i] = *reinterpret_cast<const float4*>(a + (ra + i) * (D + 4) + d);
      if (SCALED) {
        av[i].x *= scale; av[i].y *= scale; av[i].z *= scale; av[i].w *= scale;
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      bv[j] = *reinterpret_cast<const float4*>(b + (tx + 16 * j) * (D + 4) + d);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = fmaf(av[i].x, bv[j].x, s[i][j]);
        s[i][j] = fmaf(av[i].y, bv[j].y, s[i][j]);
        s[i][j] = fmaf(av[i].z, bv[j].z, s[i][j]);
        s[i][j] = fmaf(av[i].w, bv[j].w, s[i][j]);
      }
  }
}

// acc[i][c] += sum_r p[ra + i][r] * b[r][tx * DPT + c]: a 64-wide row of a
// score tile (stride SP) against a row-major D-wide tile (stride D + 4).
template <int D>
__device__ __forceinline__ void acc_tile(float acc[4][D / 16], const float* p, int ra,
                                         const float* b, int tx) {
  constexpr int DPT = D / 16;
#pragma unroll 2
  for (int r = 0; r < TILE; r += 4) {
    float4 pv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) pv[i] = *reinterpret_cast<const float4*>(p + (ra + i) * SP + r);
#pragma unroll
    for (int rr = 0; rr < 4; ++rr) {
      float bv[DPT];
      const float* brow = b + (r + rr) * (D + 4) + tx * DPT;
      if constexpr (DPT % 4 == 0) {
#pragma unroll
        for (int c = 0; c < DPT; c += 4) {
          const float4 t = *reinterpret_cast<const float4*>(brow + c);
          bv[c] = t.x; bv[c + 1] = t.y; bv[c + 2] = t.z; bv[c + 3] = t.w;
        }
      } else {
#pragma unroll
        for (int c = 0; c < DPT; ++c) bv[c] = brow[c];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float pi = rr == 0 ? pv[i].x : rr == 1 ? pv[i].y : rr == 2 ? pv[i].z : pv[i].w;
#pragma unroll
        for (int c = 0; c < DPT; ++c) acc[i][c] = fmaf(pi, bv[c], acc[i][c]);
      }
    }
  }
}

// max / sum over the 16 threads (tx) that share a row
__device__ __forceinline__ float row_max(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}
__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// ---------------------------------------------------------------------------
// forward: o = softmax(q*scale . k^T) . v, l = m + log(sum e)
// ---------------------------------------------------------------------------

template <int D, typename T>
__global__ void __launch_bounds__(NT)
fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
           T* __restrict__ o, float* __restrict__ lse, int n, float scale) {
  constexpr int DPT = D / 16;
  extern __shared__ __align__(16) float sm[];
  float* qs = sm;                     // [TILE][D + 4], q * scale
  float* ks = qs + TILE * (D + 4);
  float* vs = ks + TILE * (D + 4);
  float* ps = vs + TILE * (D + 4);    // [TILE queries][SP]
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16, ra = ty * 4;
  const int q0 = blockIdx.x * TILE;
  const size_t base = (size_t)blockIdx.y * n * D;
  load_tile<D>(qs, q + base, q0, n, scale);

  float m[4], lsum[4], acc[4][DPT];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    lsum[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DPT; ++c) acc[i][c] = 0.f;
  }
  for (int k0 = 0; k0 < n; k0 += TILE) {
    __syncthreads();  // the previous tile's products are done with ks, vs, ps
    load_tile<D>(ks, k + base, k0, n);
    load_tile<D>(vs, v + base, k0, n);
    __syncthreads();
    float s[4][4];
    dot_tile<D, false>(s, qs, ra, ks, tx, 0.f);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (k0 + tx + 16 * j >= n) s[i][j] = -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max(mx));  // finite: the tile holds a key
      const float alpha = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        ps[(ra + i) * SP + tx + 16 * j] = p;
        rs += p;
      }
      lsum[i] = lsum[i] * alpha + row_sum(rs);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < DPT; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();
    acc_tile<D>(acc, ps, ra, vs, tx);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ra + i;
    if (row >= n) continue;
#pragma unroll
    for (int c = 0; c < DPT; ++c) st(o + base + (size_t)row * D + tx * DPT + c, acc[i][c] / lsum[i]);
    if (tx == 0) lse[(size_t)blockIdx.y * n + row] = m[i] + logf(lsum[i]);
  }
}

// ---------------------------------------------------------------------------
// dQ: p = exp(s - l), ds = p * (do.v^T - delta), dq = (ds.k) * scale
// ---------------------------------------------------------------------------

template <int D, typename T>
__global__ void __launch_bounds__(NT)
dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
          const T* __restrict__ dout, const float* __restrict__ lse,
          const float* __restrict__ delta, T* __restrict__ dq, int n, float scale) {
  constexpr int DPT = D / 16;
  extern __shared__ __align__(16) float sm[];
  float* qs = sm;                     // [TILE][D + 4], q * scale
  float* dos = qs + TILE * (D + 4);
  float* ks = dos + TILE * (D + 4);
  float* vs = ks + TILE * (D + 4);
  float* dss = vs + TILE * (D + 4);   // [TILE queries][SP]
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16, ra = ty * 4;
  const int q0 = blockIdx.x * TILE;
  const size_t base = (size_t)blockIdx.y * n * D;
  const size_t rbase = (size_t)blockIdx.y * n;
  load_tile<D>(qs, q + base, q0, n, scale);
  load_tile<D>(dos, dout + base, q0, n);
  float l[4], dl[4], acc[4][DPT];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = min(q0 + ra + i, n - 1);
    l[i] = lse[rbase + row];
    dl[i] = delta[rbase + row];
#pragma unroll
    for (int c = 0; c < DPT; ++c) acc[i][c] = 0.f;
  }
  for (int k0 = 0; k0 < n; k0 += TILE) {
    __syncthreads();
    load_tile<D>(ks, k + base, k0, n);
    load_tile<D>(vs, v + base, k0, n);
    __syncthreads();
    float s[4][4], dp[4][4];
    dot_tile<D, false>(s, qs, ra, ks, tx, 0.f);
    dot_tile<D, false>(dp, dos, ra, vs, tx, 0.f);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bool ok = k0 + tx + 16 * j < n;
        const float p = ok ? expf(s[i][j] - l[i]) : 0.f;
        dss[(ra + i) * SP + tx + 16 * j] = p * (dp[i][j] - dl[i]);
      }
    __syncthreads();
    acc_tile<D>(acc, dss, ra, ks, tx);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ra + i;
    if (row >= n) continue;
#pragma unroll
    for (int c = 0; c < DPT; ++c) st(dq + base + (size_t)row * D + tx * DPT + c, acc[i][c] * scale);
  }
}

// ---------------------------------------------------------------------------
// dK/dV: dk = (ds^T.q) * scale, dv = p^T.do, over the queries of each key
// ---------------------------------------------------------------------------

template <int D, typename T>
__global__ void __launch_bounds__(NT)
dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
           const T* __restrict__ dout, const float* __restrict__ lse,
           const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv,
           int n, float scale) {
  constexpr int DPT = D / 16;
  extern __shared__ __align__(16) float sm[];
  float* ks = sm;                     // [TILE keys][D + 4]
  float* vs = ks + TILE * (D + 4);
  float* qs = vs + TILE * (D + 4);    // [TILE queries][D + 4], unscaled
  float* dos = qs + TILE * (D + 4);
  float* pt = dos + TILE * (D + 4);   // [TILE keys][SP]: p transposed
  float* dst = pt + TILE * SP;        // [TILE keys][SP]: ds transposed
  float* ls = dst + TILE * SP;        // [TILE] logsumexp of the query tile
  float* dls = ls + TILE;             // [TILE] delta of the query tile
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16, ra = ty * 4;
  const int k0 = blockIdx.x * TILE;
  const size_t base = (size_t)blockIdx.y * n * D;
  const size_t rbase = (size_t)blockIdx.y * n;
  load_tile<D>(ks, k + base, k0, n);
  load_tile<D>(vs, v + base, k0, n);
  float gk[4][DPT], gv[4][DPT];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < DPT; ++c) gk[i][c] = gv[i][c] = 0.f;

  for (int r0 = 0; r0 < n; r0 += TILE) {
    __syncthreads();
    load_tile<D>(qs, q + base, r0, n);
    load_tile<D>(dos, dout + base, r0, n);
    load_rows(ls, lse + rbase, r0, n);
    load_rows(dls, delta + rbase, r0, n);
    __syncthreads();
    // scores of the query rows ra.. against the keys tx + 16 j
    float s[4][4], dp[4][4];
    dot_tile<D, true>(s, qs, ra, ks, tx, scale);
    dot_tile<D, false>(dp, dos, ra, vs, tx, 0.f);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const bool key_ok = k0 + tx + 16 * j < n;
      float pp[4], dd[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const bool ok = key_ok && r0 + ra + i < n;
        const float p = ok ? expf(s[i][j] - ls[ra + i]) : 0.f;
        pp[i] = p;
        dd[i] = p * (dp[i][j] - dls[ra + i]);
      }
      *reinterpret_cast<float4*>(pt + (tx + 16 * j) * SP + ra) =
          make_float4(pp[0], pp[1], pp[2], pp[3]);
      *reinterpret_cast<float4*>(dst + (tx + 16 * j) * SP + ra) =
          make_float4(dd[0], dd[1], dd[2], dd[3]);
    }
    __syncthreads();
    // keys ra.. of this block against the query rows of the tile
    acc_tile<D>(gv, pt, ra, dos, tx);
    acc_tile<D>(gk, dst, ra, qs, tx);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int key = k0 + ra + i;
    if (key >= n) continue;
#pragma unroll
    for (int c = 0; c < DPT; ++c) {
      st(dk + base + (size_t)key * D + tx * DPT + c, gk[i][c] * scale);
      st(dv + base + (size_t)key * D + tx * DPT + c, gv[i][c]);
    }
  }
}

constexpr size_t tile_bytes(int d) { return (size_t)TILE * (d + 4) * sizeof(float); }
constexpr size_t score_bytes() { return (size_t)TILE * SP * sizeof(float); }

template <int D, typename T>
cudaError_t run_fwd(const void* q, const void* k, const void* v, void* o, float* l,
                    int bh, int n, float scale, cudaStream_t stream) {
  const size_t smem = 3 * tile_bytes(D) + score_bytes();
  auto kern = fwd_kernel<D, T>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  kern<<<dim3((n + TILE - 1) / TILE, bh), NT, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, l, n, scale);
  return cudaGetLastError();
}

template <int D, typename T>
cudaError_t run_dq(const void* q, const void* k, const void* v, const void* dout,
                   const float* l, const float* delta, void* dq, int bh, int n, float scale,
                   cudaStream_t stream) {
  const size_t smem = 4 * tile_bytes(D) + score_bytes();
  auto kern = dq_kernel<D, T>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  kern<<<dim3((n + TILE - 1) / TILE, bh), NT, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout, l, delta, (T*)dq, n, scale);
  return cudaGetLastError();
}

template <int D, typename T>
cudaError_t run_dkv(const void* q, const void* k, const void* v, const void* dout,
                    const float* l, const float* delta, void* dk, void* dv, int bh, int n,
                    float scale, cudaStream_t stream) {
  const size_t smem = 4 * tile_bytes(D) + 2 * score_bytes() + 2 * TILE * sizeof(float);
  auto kern = dkv_kernel<D, T>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  kern<<<dim3((n + TILE - 1) / TILE, bh), NT, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout, l, delta, (T*)dk, (T*)dv, n,
      scale);
  return cudaGetLastError();
}

// Dispatch on the head dim (16, 32, 64, 128) and the input type.
#define ATT_DISPATCH(d, bf, CALL)                                             \
  switch (d) {                                                                \
    case 16: return (int)(bf ? CALL(16, __nv_bfloat16) : CALL(16, float));    \
    case 32: return (int)(bf ? CALL(32, __nv_bfloat16) : CALL(32, float));    \
    case 64: return (int)(bf ? CALL(64, __nv_bfloat16) : CALL(64, float));    \
    case 128: return (int)(bf ? CALL(128, __nv_bfloat16) : CALL(128, float)); \
    default: return (int)cudaErrorInvalidValue;                               \
  }

}  // namespace

ATT_EXPORT int attention_fwd(const void* q, const void* k, const void* v, void* o, float* l,
                             int bh, int n, int d, int bf, float scale, void* stream) {
#define CALL(D, T) run_fwd<D, T>(q, k, v, o, l, bh, n, scale, (cudaStream_t)stream)
  ATT_DISPATCH(d, bf, CALL)
#undef CALL
}

ATT_EXPORT int attention_dq(const void* q, const void* k, const void* v, const void* dout,
                            const float* l, const float* delta, void* dq, int bh, int n,
                            int d, int bf, float scale, void* stream) {
#define CALL(D, T) run_dq<D, T>(q, k, v, dout, l, delta, dq, bh, n, scale, (cudaStream_t)stream)
  ATT_DISPATCH(d, bf, CALL)
#undef CALL
}

ATT_EXPORT int attention_dkv(const void* q, const void* k, const void* v, const void* dout,
                             const float* l, const float* delta, void* dk, void* dv, int bh,
                             int n, int d, int bf, float scale, void* stream) {
#define CALL(D, T) \
  run_dkv<D, T>(q, k, v, dout, l, delta, dk, dv, bh, n, scale, (cudaStream_t)stream)
  ATT_DISPATCH(d, bf, CALL)
#undef CALL
}
