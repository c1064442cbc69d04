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
// tile of rows and loops over the other panel in 64-row tiles:
//   forward  one block per (bh, 64 or 128 queries); an online max and sum over the
//            K/V tiles (rescaling the running output), then o = acc / sum and
//            l = m + log(sum), as _fwd_kernel's m + log(denom);
//   dQ       one block per (bh, 64 queries), loops over K/V tiles;
//   dK/dV    one block per (bh, 64 keys), loops over Q/dO tiles.
// No block writes what another reads, and there are no atomics.  The
// blocks of all (bh, tile) pairs lie on grid.x, bh-major, so batch*heads
// has no 65535 limit.
//
// Head dims: any d % 8 == 0 up to 128.  A kernel is built for the padded
// dims 16, 32, 64, 96 and 128; a panel's head dim is padded in shared memory
// to the next of them with zero columns, which change no score and no
// product and are never stored.
//
// Numerics follow the Pallas bodies: every input is widened to f32, p and ds
// stay f32 into their products, dq = (ds.k) * scale and dk = (ds^T.q) * scale
// with the unscaled q, and the outputs are rounded to the input type once,
// at the store.
//
// Two forward bodies:
//
//   bf16 (fwd_tc_kernel; the NS trainer's launch).  Bound by operations:
//   q.k^T and p.v on the tensor cores at the bf16 rate (989 TFLOP/s dense).
//   Four warps own a 128-row query tile, 32 rows (two m16 tiles) each, so
//   every K and V fragment read from shared memory feeds two rows' products
//   (for d > 64, where the registers would not hold two tiles' output, 64
//   rows and 16 each).  K/V tiles of 64 keys are double-buffered in shared
//   memory by cp.async, so the next tile's loads overlap this tile's
//   products.  s = q.k^T runs as mma.sync m16n8k16 bf16
//   with f32 accumulation (k and q are exactly bf16), then s * scale in f32:
//   for a power-of-two scale (d = 16, 64) that is bit for bit the Pallas
//   body's (q * scale).k, for any other scale it differs by one f32
//   rounding of each score, far below one bf16 step and the f32 bound.  The
//   online max and sum stay in f32 registers (quad shuffles).  p is f32, so
//   p.v runs split-bf16: p_hi = bf16(p), p_lo = bf16(p - p_hi), two MMAs into
//   the same f32 accumulator (p is carried to 2^-17 of itself, the f32 bound
//   of the checks is 1e-5), the S accumulator fragment reused as the P
//   operand fragment without shared memory.  The output accumulates in f32
//   registers and is normalised and rounded to bf16 once, at the store;
//   l = m + log(sum) is written in f32.  Three products of 2*BH*N^2*D each.
//
//   f32 and the backward (dq_kernel, dkv_kernel; f32 p and ds, f32 inputs).
//   Every product as f32 FMAs on the CUDA cores: 256 threads, each owning a
//   4x4 tile of the 64x64 score tile and 4 x DP/16 of the output tile,
//   operands read from row-major shared-memory tiles padded by 4 floats
//   (rows stay 16-byte aligned and the reads are free of bank conflicts).
//   Bound by operations as well: at least half of the products take f32 p
//   or ds.  Tensor cores for these bodies are left for a later change.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#define ATT_EXPORT extern "C" __attribute__((visibility("default")))

namespace {

constexpr int TILE = 64;       // query rows and key rows per tile
constexpr int NT = 256;        // threads per block of the CUDA-core bodies: 16 x 16
constexpr int SP = TILE + 4;   // row stride of the 64x64 score tiles
constexpr int NT_TC = 128;     // threads per block of the tensor-core forward: 4 warps
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ void st(float* p, float v) { *p = v; }
__device__ __forceinline__ void st(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

// The (bh, tile) pair of this block: grid.x = bh * ntiles + tile.
__device__ __forceinline__ void block_pair(int ntiles, size_t& bh, int& tile) {
  bh = blockIdx.x / (unsigned)ntiles;
  tile = (int)(blockIdx.x - bh * (unsigned)ntiles);
}

// ---------------------------------------------------------------------------
// CUDA-core tiles (f32 forward, dQ, dK/dV)
// ---------------------------------------------------------------------------

// Rows [r0, r0 + TILE) of a (n, d) panel into a row-major f32 tile with row
// stride DP + 4, each value times `mul` in f32 (1 leaves it exact); rows at
// or past n and columns at or past d are zero.
template <int DP, typename T>
__device__ __forceinline__ void load_tile(float* dst, const T* src, int r0, int n, int d,
                                          float mul = 1.f) {
  for (int i = threadIdx.x; i < TILE * DP; i += NT) {
    const int r = i / DP, c = i - r * DP;
    dst[r * (DP + 4) + c] =
        (r0 + r < n && c < d) ? ld(src + (size_t)(r0 + r) * d + c) * mul : 0.f;
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

// Stores the first d of a thread's DPT output columns tx*DPT.. of one row.
template <int DPT, typename T>
__device__ __forceinline__ void store_row(T* dst, const float* acc, int tx, int d, float mul) {
#pragma unroll
  for (int c = 0; c < DPT; ++c)
    if (tx * DPT + c < d) st(dst + tx * DPT + c, acc[c] * mul);
}

// ---------------------------------------------------------------------------
// forward, CUDA cores (f32 inputs): o = softmax(q*scale . k^T) . v
// ---------------------------------------------------------------------------

template <int DP, typename T>
__global__ void __launch_bounds__(NT)
fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
           T* __restrict__ o, float* __restrict__ lse, int n, int d, int ntiles, float scale) {
  constexpr int DPT = DP / 16;
  extern __shared__ __align__(16) float sm[];
  float* qs = sm;                     // [TILE][DP + 4], q * scale
  float* ks = qs + TILE * (DP + 4);
  float* vs = ks + TILE * (DP + 4);
  float* ps = vs + TILE * (DP + 4);   // [TILE queries][SP]
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16, ra = ty * 4;
  size_t bh;
  int tile;
  block_pair(ntiles, bh, tile);
  const int q0 = tile * TILE;
  const size_t base = bh * n * d;
  load_tile<DP>(qs, q + base, q0, n, d, scale);

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
    load_tile<DP>(ks, k + base, k0, n, d);
    load_tile<DP>(vs, v + base, k0, n, d);
    __syncthreads();
    float s[4][4];
    dot_tile<DP, false>(s, qs, ra, ks, tx, 0.f);
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
    acc_tile<DP>(acc, ps, ra, vs, tx);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ra + i;
    if (row >= n) continue;
    store_row<DPT>(o + base + (size_t)row * d, acc[i], tx, d, 1.f / lsum[i]);
    if (tx == 0) lse[bh * n + row] = m[i] + logf(lsum[i]);
  }
}

// ---------------------------------------------------------------------------
// forward, tensor cores (bf16 inputs)
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// Rows [r0, r0 + TILE) of a (n, d) bf16 panel into a [TILE][DP + 8] tile by
// cp.async, 16 bytes (8 columns) per copy; rows at or past n and columns at
// or past d (d % 8 == 0) are zero-filled.
template <int DP>
__device__ __forceinline__ void load_tile_async(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                                int r0, int n, int d) {
  constexpr int CPR = DP / 8;  // copies per row
  for (int i = threadIdx.x; i < TILE * CPR; i += NT_TC) {
    const int r = i / CPR, c = (i - r * CPR) * 8;
    const bool ok = r0 + r < n && c < d;
    const __nv_bfloat16* g = ok ? src + (size_t)(r0 + r) * d + c : src;
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                     smem_addr(dst + r * (DP + 8) + c)),
                 "l"(g), "r"(ok ? 16 : 0)
                 : "memory");
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t r[4], const __nv_bfloat16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p))
               : "memory");
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t r[4], const __nv_bfloat16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p))
               : "memory");
}

// c += a (16x16 bf16, row) . b (16x8 bf16, col), f32 accumulation
__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// Fragment layout (PTX m16n8k16; lane = 4 g + t): the accumulator holds rows
// g (c0, c1) and g + 8 (c2, c3) at columns 2t, 2t + 1.  Two adjacent n8
// accumulator tiles of s are one k16 A fragment of p: {c0c1, c2c3} of the
// first, then of the second.  Each warp owns MT m16 row tiles, so every K
// and V fragment read from shared memory feeds MT (K) or 2 MT (V) products.
template <int DP>
constexpr int TC_MT = DP <= 64 ? 2 : 1;

template <int DP>
__global__ void __launch_bounds__(NT_TC, 2)
fwd_tc_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
              const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
              float* __restrict__ lse, int n, int d, int ntiles, float scale) {
  constexpr int MT = TC_MT<DP>;  // m16 row tiles per warp
  constexpr int TQ = 4 * 16 * MT;      // query rows per block
  constexpr int LD = DP + 8;   // row stride in shared memory (conflict-free ldmatrix)
  constexpr int KS = DP / 16;  // k16 steps of q.k^T
  constexpr int NO = DP / 8;   // n8 tiles of the output
  constexpr int TS = TILE * LD;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [TQ][LD]
  __nv_bfloat16* ks = qs + TQ * LD;  // 2 x [TILE][LD]
  __nv_bfloat16* vs = ks + 2 * TS;   // 2 x [TILE][LD]
  size_t bh;
  int tile;
  block_pair(ntiles, bh, tile);
  const int q0 = tile * TQ;
  const size_t base = bh * n * d;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  // ldmatrix x4 row addresses: matrix lane >> 3, row lane & 7
  const int lm_row = ((lane >> 3) & 1) * 8 + (lane & 7);  // A (q) and B-trans (v)
  const int lm_col = (lane >> 4) * 8;
  const int lk_row = (lane >> 4) * 8 + (lane & 7);        // B (k)
  const int lk_col = ((lane >> 3) & 1) * 8;
  const int nkt = (n + TILE - 1) / TILE;

  for (int r = 0; r < TQ; r += TILE) load_tile_async<DP>(qs + r * LD, q + base, q0 + r, n, d);
  load_tile_async<DP>(ks, k + base, 0, n, d);
  load_tile_async<DP>(vs, v + base, 0, n, d);
  cp_async_commit();

  uint32_t qf[MT][KS][4];
  float acc[MT][NO][4];
  float m[MT][2], l[MT][2];  // rows g, g + 8 of each m16 tile
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int i = 0; i < NO; ++i) acc[mt][i][0] = acc[mt][i][1] = acc[mt][i][2] = acc[mt][i][3] = 0.f;
    m[mt][0] = m[mt][1] = -INFINITY;
    l[mt][0] = l[mt][1] = 0.f;
  }

  for (int j = 0; j < nkt; ++j) {
    const int buf = j & 1;
    if (j + 1 < nkt) {  // the next tile's copies fly while this one is used
      load_tile_async<DP>(ks + (buf ^ 1) * TS, k + base, (j + 1) * TILE, n, d);
      load_tile_async<DP>(vs + (buf ^ 1) * TS, v + base, (j + 1) * TILE, n, d);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (j == 0) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int kk = 0; kk < KS; ++kk)
          ldsm_x4(qf[mt][kk], qs + ((warp * MT + mt) * 16 + lm_row) * LD + kk * 16 + lm_col);
    }
    const __nv_bfloat16* kb = ks + buf * TS;
    const __nv_bfloat16* vb = vs + buf * TS;

    // s = q . k^T over this tile's 64 keys: 8 n8 tiles per m16 tile
    float s[MT][8][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int i = 0; i < 8; ++i) s[mt][i][0] = s[mt][i][1] = s[mt][i][2] = s[mt][i][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t b[4];
        ldsm_x4(b, kb + (np * 16 + lk_row) * LD + kk * 16 + lk_col);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          mma_bf16(s[mt][2 * np], qf[mt][kk], b[0], b[1]);
          mma_bf16(s[mt][2 * np + 1], qf[mt][kk], b[2], b[3]);
        }
      }
    }

    // scale, mask, online max and sum (f32)
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int col = j * TILE + i * 8 + 2 * t;
#pragma unroll
        for (int e = 0; e < 4; ++e)
          s[mt][i][e] = (col + (e & 1) < n) ? s[mt][i][e] * scale : -INFINITY;
        mx0 = fmaxf(mx0, fmaxf(s[mt][i][0], s[mt][i][1]));
        mx1 = fmaxf(mx1, fmaxf(s[mt][i][2], s[mt][i][3]));
      }
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
      }
      // finite: the tile holds a key
      const float mn0 = fmaxf(m[mt][0], mx0), mn1 = fmaxf(m[mt][1], mx1);
      const float a0 = exp2f((m[mt][0] - mn0) * LOG2E), a1 = exp2f((m[mt][1] - mn1) * LOG2E);
      m[mt][0] = mn0;
      m[mt][1] = mn1;
      float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        s[mt][i][0] = exp2f((s[mt][i][0] - mn0) * LOG2E);
        s[mt][i][1] = exp2f((s[mt][i][1] - mn0) * LOG2E);
        s[mt][i][2] = exp2f((s[mt][i][2] - mn1) * LOG2E);
        s[mt][i][3] = exp2f((s[mt][i][3] - mn1) * LOG2E);
        rs0 += s[mt][i][0] + s[mt][i][1];
        rs1 += s[mt][i][2] + s[mt][i][3];
      }
      l[mt][0] = l[mt][0] * a0 + rs0;  // this thread's columns; summed over the quad at the end
      l[mt][1] = l[mt][1] * a1 + rs1;
#pragma unroll
      for (int i = 0; i < NO; ++i) {
        acc[mt][i][0] *= a0; acc[mt][i][1] *= a0;
        acc[mt][i][2] *= a1; acc[mt][i][3] *= a1;
      }
    }

    // acc += p . v, p split into bf16 hi + lo terms
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t hi[MT][4], lo[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const float* s0 = s[mt][2 * kk];
        const float* s1 = s[mt][2 * kk + 1];
        const float p[8] = {s0[0], s0[1], s0[2], s0[3], s1[0], s1[1], s1[2], s1[3]};
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const __nv_bfloat162 h = __floats2bfloat162_rn(p[2 * r], p[2 * r + 1]);
          hi[mt][r] = *reinterpret_cast<const uint32_t*>(&h);
          lo[mt][r] = pack_bf16(p[2 * r] - __low2float(h), p[2 * r + 1] - __high2float(h));
        }
      }
#pragma unroll
      for (int dp = 0; dp < NO / 2; ++dp) {
        uint32_t b[4];
        ldsm_x4_trans(b, vb + (kk * 16 + lm_row) * LD + dp * 16 + lm_col);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          mma_bf16(acc[mt][2 * dp], hi[mt], b[0], b[1]);
          mma_bf16(acc[mt][2 * dp], lo[mt], b[0], b[1]);
          mma_bf16(acc[mt][2 * dp + 1], hi[mt], b[2], b[3]);
          mma_bf16(acc[mt][2 * dp + 1], lo[mt], b[2], b[3]);
        }
      }
    }
    __syncthreads();  // this buffer is refilled by the next iteration's copies
  }

#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    float l0 = l[mt][0], l1 = l[mt][1];
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      l0 += __shfl_xor_sync(0xffffffffu, l0, off);
      l1 += __shfl_xor_sync(0xffffffffu, l1, off);
    }
    const int row0 = q0 + (warp * MT + mt) * 16 + g, row1 = row0 + 8;
    const float inv0 = 1.f / l0, inv1 = 1.f / l1;
#pragma unroll
    for (int i = 0; i < NO; ++i) {
      const int col = i * 8 + 2 * t;
      if (i * 8 >= d) continue;  // a padded column tile (d % 8 == 0)
      if (row0 < n)
        *reinterpret_cast<__nv_bfloat162*>(o + base + (size_t)row0 * d + col) =
            __floats2bfloat162_rn(acc[mt][i][0] * inv0, acc[mt][i][1] * inv0);
      if (row1 < n)
        *reinterpret_cast<__nv_bfloat162*>(o + base + (size_t)row1 * d + col) =
            __floats2bfloat162_rn(acc[mt][i][2] * inv1, acc[mt][i][3] * inv1);
    }
    if (t == 0) {
      if (row0 < n) lse[bh * n + row0] = m[mt][0] + logf(l0);
      if (row1 < n) lse[bh * n + row1] = m[mt][1] + logf(l1);
    }
  }
}

// ---------------------------------------------------------------------------
// dQ: p = exp(s - l), ds = p * (do.v^T - delta), dq = (ds.k) * scale
// ---------------------------------------------------------------------------

template <int DP, typename T>
__global__ void __launch_bounds__(NT)
dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
          const T* __restrict__ dout, const float* __restrict__ lse,
          const float* __restrict__ delta, T* __restrict__ dq, int n, int d, int ntiles,
          float scale) {
  constexpr int DPT = DP / 16;
  extern __shared__ __align__(16) float sm[];
  float* qs = sm;                     // [TILE][DP + 4], q * scale
  float* dos = qs + TILE * (DP + 4);
  float* ks = dos + TILE * (DP + 4);
  float* vs = ks + TILE * (DP + 4);
  float* dss = vs + TILE * (DP + 4);  // [TILE queries][SP]
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16, ra = ty * 4;
  size_t bh;
  int tile;
  block_pair(ntiles, bh, tile);
  const int q0 = tile * TILE;
  const size_t base = bh * n * d;
  const size_t rbase = bh * n;
  load_tile<DP>(qs, q + base, q0, n, d, scale);
  load_tile<DP>(dos, dout + base, q0, n, d);
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
    load_tile<DP>(ks, k + base, k0, n, d);
    load_tile<DP>(vs, v + base, k0, n, d);
    __syncthreads();
    float s[4][4], dp[4][4];
    dot_tile<DP, false>(s, qs, ra, ks, tx, 0.f);
    dot_tile<DP, false>(dp, dos, ra, vs, tx, 0.f);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bool ok = k0 + tx + 16 * j < n;
        const float p = ok ? expf(s[i][j] - l[i]) : 0.f;
        dss[(ra + i) * SP + tx + 16 * j] = p * (dp[i][j] - dl[i]);
      }
    __syncthreads();
    acc_tile<DP>(acc, dss, ra, ks, tx);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ra + i;
    if (row < n) store_row<DPT>(dq + base + (size_t)row * d, acc[i], tx, d, scale);
  }
}

// ---------------------------------------------------------------------------
// dK/dV: dk = (ds^T.q) * scale, dv = p^T.do, over the queries of each key
// ---------------------------------------------------------------------------

template <int DP, typename T>
__global__ void __launch_bounds__(NT)
dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
           const T* __restrict__ dout, const float* __restrict__ lse,
           const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv,
           int n, int d, int ntiles, float scale) {
  constexpr int DPT = DP / 16;
  extern __shared__ __align__(16) float sm[];
  float* ks = sm;                     // [TILE keys][DP + 4]
  float* vs = ks + TILE * (DP + 4);
  float* qs = vs + TILE * (DP + 4);   // [TILE queries][DP + 4], unscaled
  float* dos = qs + TILE * (DP + 4);
  float* pt = dos + TILE * (DP + 4);  // [TILE keys][SP]: p transposed
  float* dst = pt + TILE * SP;        // [TILE keys][SP]: ds transposed
  float* ls = dst + TILE * SP;        // [TILE] logsumexp of the query tile
  float* dls = ls + TILE;             // [TILE] delta of the query tile
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16, ra = ty * 4;
  size_t bh;
  int tile;
  block_pair(ntiles, bh, tile);
  const int k0 = tile * TILE;
  const size_t base = bh * n * d;
  const size_t rbase = bh * n;
  load_tile<DP>(ks, k + base, k0, n, d);
  load_tile<DP>(vs, v + base, k0, n, d);
  float gk[4][DPT], gv[4][DPT];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < DPT; ++c) gk[i][c] = gv[i][c] = 0.f;

  for (int r0 = 0; r0 < n; r0 += TILE) {
    __syncthreads();
    load_tile<DP>(qs, q + base, r0, n, d);
    load_tile<DP>(dos, dout + base, r0, n, d);
    load_rows(ls, lse + rbase, r0, n);
    load_rows(dls, delta + rbase, r0, n);
    __syncthreads();
    // scores of the query rows ra.. against the keys tx + 16 j
    float s[4][4], dp[4][4];
    dot_tile<DP, true>(s, qs, ra, ks, tx, scale);
    dot_tile<DP, false>(dp, dos, ra, vs, tx, 0.f);
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
    acc_tile<DP>(gv, pt, ra, dos, tx);
    acc_tile<DP>(gk, dst, ra, qs, tx);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int key = k0 + ra + i;
    if (key >= n) continue;
    store_row<DPT>(dk + base + (size_t)key * d, gk[i], tx, d, scale);
    store_row<DPT>(dv + base + (size_t)key * d, gv[i], tx, d, 1.f);
  }
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

constexpr size_t tile_bytes(int dp) { return (size_t)TILE * (dp + 4) * sizeof(float); }
constexpr size_t score_bytes() { return (size_t)TILE * SP * sizeof(float); }

template <typename K>
cudaError_t prepare(K kern, size_t smem, int bh, int n, unsigned& grid, int& ntiles,
                    int rows = TILE) {
  ntiles = (n + rows - 1) / rows;
  if (bh <= 0 || n <= 0 || (long long)bh * ntiles > INT_MAX) return cudaErrorInvalidValue;
  grid = (unsigned)(bh * ntiles);
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <int DP, typename T>
cudaError_t run_fwd(const void* q, const void* k, const void* v, void* o, float* l,
                    int bh, int n, int d, float scale, cudaStream_t stream) {
  unsigned grid;
  int ntiles;
  if constexpr (sizeof(T) == 2) {
    constexpr int TQ = 64 * TC_MT<DP>;
    const size_t smem = (size_t)(TQ + 4 * TILE) * (DP + 8) * sizeof(__nv_bfloat16);
    auto kern = fwd_tc_kernel<DP>;
    cudaError_t e = prepare(kern, smem, bh, n, grid, ntiles, TQ);
    if (e != cudaSuccess) return e;
    kern<<<grid, NT_TC, smem, stream>>>((const T*)q, (const T*)k, (const T*)v, (T*)o, l, n, d,
                                        ntiles, scale);
  } else {
    const size_t smem = 3 * tile_bytes(DP) + score_bytes();
    auto kern = fwd_kernel<DP, T>;
    cudaError_t e = prepare(kern, smem, bh, n, grid, ntiles);
    if (e != cudaSuccess) return e;
    kern<<<grid, NT, smem, stream>>>((const T*)q, (const T*)k, (const T*)v, (T*)o, l, n, d,
                                     ntiles, scale);
  }
  return cudaGetLastError();
}

template <int DP, typename T>
cudaError_t run_dq(const void* q, const void* k, const void* v, const void* dout,
                   const float* l, const float* delta, void* dq, int bh, int n, int d,
                   float scale, cudaStream_t stream) {
  const size_t smem = 4 * tile_bytes(DP) + score_bytes();
  auto kern = dq_kernel<DP, T>;
  unsigned grid;
  int ntiles;
  cudaError_t e = prepare(kern, smem, bh, n, grid, ntiles);
  if (e != cudaSuccess) return e;
  kern<<<grid, NT, smem, stream>>>((const T*)q, (const T*)k, (const T*)v, (const T*)dout, l,
                                   delta, (T*)dq, n, d, ntiles, scale);
  return cudaGetLastError();
}

template <int DP, typename T>
cudaError_t run_dkv(const void* q, const void* k, const void* v, const void* dout,
                    const float* l, const float* delta, void* dk, void* dv, int bh, int n,
                    int d, float scale, cudaStream_t stream) {
  const size_t smem = 4 * tile_bytes(DP) + 2 * score_bytes() + 2 * TILE * sizeof(float);
  auto kern = dkv_kernel<DP, T>;
  unsigned grid;
  int ntiles;
  cudaError_t e = prepare(kern, smem, bh, n, grid, ntiles);
  if (e != cudaSuccess) return e;
  kern<<<grid, NT, smem, stream>>>((const T*)q, (const T*)k, (const T*)v, (const T*)dout, l,
                                   delta, (T*)dk, (T*)dv, n, d, ntiles, scale);
  return cudaGetLastError();
}

// Dispatch on the padded head dim (16, 32, 64, 96, 128; d % 8 == 0) and the
// input type.
#define ATT_DISPATCH(d, bf, CALL)                                               \
  if ((d) <= 0 || (d) % 8 != 0 || (d) > 128) return (int)cudaErrorInvalidValue; \
  if ((d) <= 16) return (int)(bf ? CALL(16, __nv_bfloat16) : CALL(16, float));  \
  if ((d) <= 32) return (int)(bf ? CALL(32, __nv_bfloat16) : CALL(32, float));  \
  if ((d) <= 64) return (int)(bf ? CALL(64, __nv_bfloat16) : CALL(64, float));  \
  if ((d) <= 96) return (int)(bf ? CALL(96, __nv_bfloat16) : CALL(96, float));  \
  return (int)(bf ? CALL(128, __nv_bfloat16) : CALL(128, float));

}  // namespace

ATT_EXPORT int attention_fwd(const void* q, const void* k, const void* v, void* o, float* l,
                             int bh, int n, int d, int bf, float scale, void* stream) {
#define CALL(DP, T) run_fwd<DP, T>(q, k, v, o, l, bh, n, d, scale, (cudaStream_t)stream)
  ATT_DISPATCH(d, bf, CALL)
#undef CALL
}

ATT_EXPORT int attention_dq(const void* q, const void* k, const void* v, const void* dout,
                            const float* l, const float* delta, void* dq, int bh, int n,
                            int d, int bf, float scale, void* stream) {
#define CALL(DP, T) \
  run_dq<DP, T>(q, k, v, dout, l, delta, dq, bh, n, d, scale, (cudaStream_t)stream)
  ATT_DISPATCH(d, bf, CALL)
#undef CALL
}

ATT_EXPORT int attention_dkv(const void* q, const void* k, const void* v, const void* dout,
                             const float* l, const float* delta, void* dk, void* dv, int bh,
                             int n, int d, int bf, float scale, void* stream) {
#define CALL(DP, T) \
  run_dkv<DP, T>(q, k, v, dout, l, delta, dk, dv, bh, n, d, scale, (cudaStream_t)stream)
  ATT_DISPATCH(d, bf, CALL)
#undef CALL
}
