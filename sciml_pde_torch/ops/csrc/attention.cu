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
//   dQ       one block per (bh, 64 or 128 queries), loops over K/V tiles;
//   dK/dV    one block per (bh, 64 keys), loops over Q/dO tiles.
// No block writes what another reads, and there are no atomics, so the
// results are the same bits from run to run.  The blocks of all (bh, tile)
// pairs lie on grid.x, bh-major, so batch*heads has no 65535 limit.
//
// Head dims: any d % 8 == 0 up to 256.  A kernel is built for the padded
// dims 16, 32, 64, 96, 128, 160, 192 and 256; a panel's head dim is padded in
// shared memory to the next of them with zero columns, which change no score
// and no product and are never stored.  Above 128 the CUDA-core dQ and dK/dV
// bodies own 32-row tiles, and each tensor-core body splits its output
// columns over two blocks, which both compute the scores (see below).
//
// Numerics follow the Pallas bodies: every input is widened to f32, p and ds
// stay f32 into their products, dq = (ds.k) * scale and dk = (ds^T.q) * scale
// with the unscaled q, and the outputs are rounded to the input type once,
// at the store.
//
// bf16 (the NS trainer's launches): three tensor-core bodies, bound by
// operations at the bf16 rate (989 TFLOP/s dense), 4 warps a block, tiles of
// the other panel double-buffered in shared memory by cp.async so the next
// tile's loads overlap this tile's products, fragments read by ldmatrix from
// rows padded by 8 elements (conflict-free).  Scores run raw as mma.sync
// m16n8k16 bf16 with f32 accumulation (q, k, v and do are exactly bf16),
// then take the scale in f32.  The f32 operands p and ds run split-bf16:
// x_hi = bf16(x), x_lo = bf16(x - x_hi), two MMAs into the same f32
// accumulator (x is carried to 2^-17 of itself; the f32 bound of the checks
// is 1e-5), the accumulator fragment of the scores reused as the A operand
// fragment without shared memory.  Each body counts the products its design
// needs to be exact as its bound, all at the bf16 rate.  Beside the MMAs each
// score costs an exp, its share of the split, of ldmatrix and of the
// cp.async addressing, and at 170-255 registers a thread (chip_smoke.py
// prints them) only 8-12 warps share an SM, few to hide the MMA -> exp ->
// split -> MMA chain: that, and mma.sync's rate below wgmma's, keeps the
// bodies at several times their bounds.  Above head dim 128 a block's f32 accumulators over all columns
// would not fit the registers beside the scores; two blocks each take half
// of the output columns (the forward's part 0 writes l).
//
//   forward (fwd_tc_kernel): q.k^T, then p.v as p_hi.v + p_lo.v: three
//   products of 2*BH*N^2*D.  s * scale in f32 is bit for bit the Pallas
//   body's (q * scale).k for a power-of-two scale (d = 16, 64, 256), one f32
//   rounding of each score away otherwise.  Four warps own a 128-row query
//   tile, 32 rows (two m16 tiles) each, so every K and V fragment read from
//   shared memory feeds two rows' products (for d > 64, where the registers
//   would not hold two tiles' output, 64 rows and 16 each).  The online max
//   and sum stay in f32 registers (quad shuffles); the output accumulates in
//   f32 registers and is normalised and rounded to bf16 once, at the store;
//   l = m + log(sum) is written in f32.
//
//   dQ (dq_tc_kernel): q.k^T, do.v^T, then ds.k as ds_hi.k + ds_lo.k: four
//   products.  Each warp owns 32 queries (two m16 tiles, d <= 64; else 16),
//   so every K and V fragment feeds two tiles' products; their q and do A
//   fragments stay in registers for the block's life (d <= 128).  Per 16
//   keys (32 for one m16 tile) of a K/V tile: s and dp in f32 registers, p =
//   2^(s * scale * log2(e) - l * log2(e)) (one FMA and one ex2.approx; p
//   moves by about 2^-22 of itself, far below the f32 bound) and ds = p *
//   (dp - delta) in place, then the ds fragments against K through
//   ldmatrix.trans.
//
//   dK/dV (dkv_tc_kernel): k.q^T and v.do^T with keys as rows, so that p^T
//   and ds^T come out as A fragments at once, then p^T.do and ds^T.q, each
//   as two terms: six products.  Each warp owns 16 keys; their k and v A
//   fragments stay in registers (d <= 64).  Q, dO and the tile's l and delta
//   are double-buffered; do and q enter the gradient products through
//   ldmatrix.trans.  p^T as in dQ, per 32 queries.
//
// f32 (fwd_kernel, dq_kernel, dkv_kernel; phase-6 and phase-7 checks, no
// trainer launch): every product as f32 FMAs on the CUDA cores, bound by
// operations at the f32 rate (67 TFLOP/s).  256 threads; each owns a 4x4 tile
// of the 64x64 score tile and R x DP/16 of the output tile, operands read
// from row-major shared-memory tiles padded by 4 floats (rows stay 16-byte
// aligned and the reads are free of bank conflicts).  In-order FMAs: the
// products match cuBLAS's f32 GEMM bit for bit at the checked shapes.  dQ
// and dK/dV own 64-row tiles (R = 4) up to d = 128 and 32-row tiles (R = 2)
// above: four f32 64-row panels of 256 columns (266 KB) would overflow
// shared memory, and dK/dV's two accumulators (8 x 16 floats a thread) the
// registers.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#define ATT_EXPORT extern "C" __attribute__((visibility("default")))

namespace {

constexpr int TILE = 64;       // rows of the looped-over panel per tile
constexpr int NT = 256;        // threads per block of the CUDA-core bodies: 16 x 16
constexpr int SP = TILE + 4;   // row stride of the score tiles
constexpr int NT_TC = 128;     // threads per block of the tensor-core bodies: 4 warps
constexpr float LOG2E = 1.4426950408889634f;

// The (bh, tile) pair of this block: grid.x = bh * ntiles + tile.
__device__ __forceinline__ void block_pair(int ntiles, size_t& bh, int& tile) {
  bh = blockIdx.x / (unsigned)ntiles;
  tile = (int)(blockIdx.x - bh * (unsigned)ntiles);
}

// ---------------------------------------------------------------------------
// CUDA-core tiles (f32 forward, dQ, dK/dV)
// ---------------------------------------------------------------------------

// rows per thread of the CUDA-core dQ and dK/dV bodies' own tile (16 R rows)
template <int DP>
constexpr int RPT = DP <= 128 ? 4 : 2;

// Rows [r0, r0 + rows) of a (n, d) panel into a row-major f32 tile with row
// stride DP + 4, each value times `mul` in f32 (1 leaves it exact); rows at
// or past n and columns at or past d are zero.
template <int DP>
__device__ __forceinline__ void load_tile(float* dst, const float* src, int r0, int rows, int n,
                                          int d, float mul = 1.f) {
  for (int i = threadIdx.x; i < rows * DP; i += NT) {
    const int r = i / DP, c = i - r * DP;
    dst[r * (DP + 4) + c] = (r0 + r < n && c < d) ? src[(size_t)(r0 + r) * d + c] * mul : 0.f;
  }
}

__device__ __forceinline__ void load_rows(float* dst, const float* src, int r0, int n) {
  for (int i = threadIdx.x; i < TILE; i += NT) dst[i] = (r0 + i < n) ? src[r0 + i] : 0.f;
}

// s[i][j] = sum_d a'[ra + i][d] * b[tx + 16 j][d]: RI rows of a tile at ra
// against RJ strided rows of another, both row stride D + 4.  With SCALED,
// a' = a * scale in f32 before the product (q.astype(f32) * scale), else a.
template <int D, bool SCALED, int RI, int RJ>
__device__ __forceinline__ void dot_tile(float s[RI][RJ], const float* a, int ra,
                                         const float* b, int tx, float scale) {
#pragma unroll
  for (int i = 0; i < RI; ++i)
#pragma unroll
    for (int j = 0; j < RJ; ++j) s[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; d += 4) {
    float4 av[RI], bv[RJ];
#pragma unroll
    for (int i = 0; i < RI; ++i) {
      av[i] = *reinterpret_cast<const float4*>(a + (ra + i) * (D + 4) + d);
      if (SCALED) {
        av[i].x *= scale; av[i].y *= scale; av[i].z *= scale; av[i].w *= scale;
      }
    }
#pragma unroll
    for (int j = 0; j < RJ; ++j)
      bv[j] = *reinterpret_cast<const float4*>(b + (tx + 16 * j) * (D + 4) + d);
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < RJ; ++j) {
        s[i][j] = fmaf(av[i].x, bv[j].x, s[i][j]);
        s[i][j] = fmaf(av[i].y, bv[j].y, s[i][j]);
        s[i][j] = fmaf(av[i].z, bv[j].z, s[i][j]);
        s[i][j] = fmaf(av[i].w, bv[j].w, s[i][j]);
      }
  }
}

// acc[i][c] += sum_r p[ra + i][r] * b[r][tx * DPT + c]: RI 64-wide rows of a
// score tile (stride SP) against a row-major D-wide tile (stride D + 4).
template <int D, int RI>
__device__ __forceinline__ void acc_tile(float acc[RI][D / 16], const float* p, int ra,
                                         const float* b, int tx) {
  constexpr int DPT = D / 16;
#pragma unroll 2
  for (int r = 0; r < TILE; r += 4) {
    float4 pv[RI];
#pragma unroll
    for (int i = 0; i < RI; ++i) pv[i] = *reinterpret_cast<const float4*>(p + (ra + i) * SP + r);
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
      for (int i = 0; i < RI; ++i) {
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
template <int DPT>
__device__ __forceinline__ void store_row(float* dst, const float* acc, int tx, int d, float mul) {
#pragma unroll
  for (int c = 0; c < DPT; ++c)
    if (tx * DPT + c < d) dst[tx * DPT + c] = acc[c] * mul;
}

// ---------------------------------------------------------------------------
// forward, CUDA cores (f32 inputs): o = softmax(q*scale . k^T) . v
// ---------------------------------------------------------------------------

template <int DP>
__global__ void __launch_bounds__(NT)
fwd_kernel(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
           float* __restrict__ o, float* __restrict__ lse, int n, int d, int ntiles, float scale) {
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
  load_tile<DP>(qs, q + base, q0, TILE, n, d, scale);

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
    load_tile<DP>(ks, k + base, k0, TILE, n, d);
    load_tile<DP>(vs, v + base, k0, TILE, n, d);
    __syncthreads();
    float s[4][4];
    dot_tile<DP, false, 4, 4>(s, qs, ra, ks, tx, 0.f);
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
    acc_tile<DP, 4>(acc, ps, ra, vs, tx);
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
// dQ, CUDA cores: p = exp(s - l), ds = p * (do.v^T - delta), dq = (ds.k) * scale
// ---------------------------------------------------------------------------

template <int DP>
__global__ void __launch_bounds__(NT)
dq_kernel(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
          const float* __restrict__ dout, const float* __restrict__ lse,
          const float* __restrict__ delta, float* __restrict__ dq, int n, int d, int ntiles,
          float scale) {
  constexpr int R = RPT<DP>, TR = 16 * R, DPT = DP / 16;
  extern __shared__ __align__(16) float sm[];
  float* qs = sm;                     // [TR][DP + 4], q * scale
  float* dos = qs + TR * (DP + 4);
  float* ks = dos + TR * (DP + 4);    // [TILE][DP + 4]
  float* vs = ks + TILE * (DP + 4);
  float* dss = vs + TILE * (DP + 4);  // [TR queries][SP]
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16, ra = ty * R;
  size_t bh;
  int tile;
  block_pair(ntiles, bh, tile);
  const int q0 = tile * TR;
  const size_t base = bh * n * d;
  const size_t rbase = bh * n;
  load_tile<DP>(qs, q + base, q0, TR, n, d, scale);
  load_tile<DP>(dos, dout + base, q0, TR, n, d);
  float l[R], dl[R], acc[R][DPT];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int row = min(q0 + ra + i, n - 1);
    l[i] = lse[rbase + row];
    dl[i] = delta[rbase + row];
#pragma unroll
    for (int c = 0; c < DPT; ++c) acc[i][c] = 0.f;
  }
  for (int k0 = 0; k0 < n; k0 += TILE) {
    __syncthreads();
    load_tile<DP>(ks, k + base, k0, TILE, n, d);
    load_tile<DP>(vs, v + base, k0, TILE, n, d);
    __syncthreads();
    float s[R][4], dp[R][4];
    dot_tile<DP, false, R, 4>(s, qs, ra, ks, tx, 0.f);
    dot_tile<DP, false, R, 4>(dp, dos, ra, vs, tx, 0.f);
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bool ok = k0 + tx + 16 * j < n;
        const float p = ok ? expf(s[i][j] - l[i]) : 0.f;
        dss[(ra + i) * SP + tx + 16 * j] = p * (dp[i][j] - dl[i]);
      }
    __syncthreads();
    acc_tile<DP, R>(acc, dss, ra, ks, tx);
  }
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int row = q0 + ra + i;
    if (row < n) store_row<DPT>(dq + base + (size_t)row * d, acc[i], tx, d, scale);
  }
}

// ---------------------------------------------------------------------------
// dK/dV, CUDA cores: dk = (ds^T.q) * scale, dv = p^T.do, over the queries of
// each key
// ---------------------------------------------------------------------------

template <int DP>
__global__ void __launch_bounds__(NT)
dkv_kernel(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
           const float* __restrict__ dout, const float* __restrict__ lse,
           const float* __restrict__ delta, float* __restrict__ dk, float* __restrict__ dv,
           int n, int d, int ntiles, float scale) {
  constexpr int R = RPT<DP>, TR = 16 * R, DPT = DP / 16;
  extern __shared__ __align__(16) float sm[];
  float* ks = sm;                     // [TR keys][DP + 4]
  float* vs = ks + TR * (DP + 4);
  float* qs = vs + TR * (DP + 4);     // [TILE queries][DP + 4], unscaled
  float* dos = qs + TILE * (DP + 4);
  float* pt = dos + TILE * (DP + 4);  // [TR keys][SP]: p transposed
  float* dst = pt + TR * SP;          // [TR keys][SP]: ds transposed
  float* ls = dst + TR * SP;          // [TILE] logsumexp of the query tile
  float* dls = ls + TILE;             // [TILE] delta of the query tile
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int rq = ty * 4, rk = ty * R;  // this thread's query rows (scores), key rows (output)
  size_t bh;
  int tile;
  block_pair(ntiles, bh, tile);
  const int k0 = tile * TR;
  const size_t base = bh * n * d;
  const size_t rbase = bh * n;
  load_tile<DP>(ks, k + base, k0, TR, n, d);
  load_tile<DP>(vs, v + base, k0, TR, n, d);
  float gk[R][DPT], gv[R][DPT];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int c = 0; c < DPT; ++c) gk[i][c] = gv[i][c] = 0.f;

  for (int r0 = 0; r0 < n; r0 += TILE) {
    __syncthreads();
    load_tile<DP>(qs, q + base, r0, TILE, n, d);
    load_tile<DP>(dos, dout + base, r0, TILE, n, d);
    load_rows(ls, lse + rbase, r0, n);
    load_rows(dls, delta + rbase, r0, n);
    __syncthreads();
    // scores of the query rows rq.. against the keys tx + 16 j
    float s[4][R], dp[4][R];
    dot_tile<DP, true, 4, R>(s, qs, rq, ks, tx, scale);
    dot_tile<DP, false, 4, R>(dp, dos, rq, vs, tx, 0.f);
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const bool key_ok = k0 + tx + 16 * j < n;
      float pp[4], dd[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const bool ok = key_ok && r0 + rq + i < n;
        const float p = ok ? expf(s[i][j] - ls[rq + i]) : 0.f;
        pp[i] = p;
        dd[i] = p * (dp[i][j] - dls[rq + i]);
      }
      *reinterpret_cast<float4*>(pt + (tx + 16 * j) * SP + rq) =
          make_float4(pp[0], pp[1], pp[2], pp[3]);
      *reinterpret_cast<float4*>(dst + (tx + 16 * j) * SP + rq) =
          make_float4(dd[0], dd[1], dd[2], dd[3]);
    }
    __syncthreads();
    // keys rk.. of this block against the query rows of the tile
    acc_tile<DP, R>(gv, pt, rk, dos, tx);
    acc_tile<DP, R>(gk, dst, rk, qs, tx);
  }
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int key = k0 + rk + i;
    if (key >= n) continue;
    store_row<DPT>(dk + base + (size_t)key * d, gk[i], tx, d, scale);
    store_row<DPT>(dv + base + (size_t)key * d, gv[i], tx, d, 1.f);
  }
}

// ---------------------------------------------------------------------------
// tensor-core building blocks (bf16 inputs)
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// Rows [r0, r0 + TILE) of a (n, d) bf16 panel into a [TILE][DP + 8] tile by
// cp.async, 16 bytes (8 columns) per copy, DP / 16 copies a thread; rows at
// or past n and columns at or past d (d % 8 == 0) are zero-filled.
template <int DP>
__device__ __forceinline__ void load_tile_async(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                                int r0, int n, int d) {
  constexpr int CPR = DP / 8;  // copies per row
  const __nv_bfloat16* tile = src + (size_t)r0 * d;
#pragma unroll
  for (int it = 0; it < TILE * CPR / NT_TC; ++it) {
    const int i = threadIdx.x + it * NT_TC;
    const int r = i / CPR, c = (i - r * CPR) * 8;
    const bool ok = r0 + r < n && c < d;
    const __nv_bfloat16* g = ok ? tile + r * d + c : src;
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                     smem_addr(dst + r * (DP + 8) + c)),
                 "l"(g), "r"(ok ? 16 : 0)
                 : "memory");
  }
}

// Rows [r0, r0 + TILE) of an f32 (n) row vector by cp.async, 4 bytes per
// copy (a row's offset need not be 16-byte aligned); rows at or past n are 0.
__device__ __forceinline__ void load_rows_async(float* dst, const float* src, int r0, int n) {
  for (int i = threadIdx.x; i < TILE; i += NT_TC) {
    const bool ok = r0 + i < n;
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst + i)),
                 "l"(ok ? src + r0 + i : src), "r"(ok ? 4 : 0)
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
// accumulator tiles c0 (columns 0-7) and c1 (8-15) are one k16 A fragment
// {c0[0]c0[1], c0[2]c0[3], c1[0]c1[1], c1[2]c1[3]}; split_frag gives it as
// hi = bf16(x) and lo = bf16(x - hi).
__device__ __forceinline__ void split_frag(const float c0[4], const float c1[4], uint32_t hi[4],
                                           uint32_t lo[4]) {
  const float x[8] = {c0[0], c0[1], c0[2], c0[3], c1[0], c1[1], c1[2], c1[3]};
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(x[2 * r], x[2 * r + 1]);
    hi[r] = *reinterpret_cast<const uint32_t*>(&h);
    lo[r] = pack_bf16(x[2 * r] - __low2float(h), x[2 * r + 1] - __high2float(h));
  }
}

// ldmatrix x4 row and column offsets of this lane (matrix lane >> 3, row
// lane & 7): an A fragment (16 rows x k16) or a B fragment read transposed
// (k16 rows x 16 columns) at (lm_row, lm_col); a B fragment pair read as
// rows (16 n rows x k16) at (lk_row, lk_col).
struct Lanes {
  int warp, g, t, lm_row, lm_col, lk_row, lk_col;
  __device__ __forceinline__ Lanes() {
    const int lane = threadIdx.x % 32;
    warp = threadIdx.x / 32;
    g = lane >> 2;
    t = lane & 3;
    lm_row = ((lane >> 3) & 1) * 8 + (lane & 7);
    lm_col = (lane >> 4) * 8;
    lk_row = (lane >> 4) * 8 + (lane & 7);
    lk_col = ((lane >> 3) & 1) * 8;
  }
};

// ---------------------------------------------------------------------------
// tensor-core bodies (bf16 inputs)
// ---------------------------------------------------------------------------

// Output columns of a tensor-core block: all of them up to head dim 128;
// above, two blocks each take half of the columns (and both compute the
// scores), so that a thread's f32 accumulators stay within 64 registers a
// term.
template <int DP>
constexpr int TC_CW = DP <= 128 ? DP : DP / 2;

// 2^x, flushing results below 2^-126 to 0 (one MUFU instruction)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Stores rows row0 and row0 + 8 of a 16 x 8 NC f32 accumulator tile, times
// mul0 and mul1, as bf16 at columns c0 + 8 i + 2t; rows at or past n and column
// tiles at or past d are not stored.
template <int NC>
__device__ __forceinline__ void store_acc(__nv_bfloat16* out, const float acc[NC][4], int row0,
                                          int c0, int t, int n, int d, float mul0, float mul1) {
#pragma unroll
  for (int i = 0; i < NC; ++i) {
    const int col = c0 + i * 8 + 2 * t;
    if (c0 + i * 8 >= d) continue;
    if (row0 < n)
      *reinterpret_cast<__nv_bfloat162*>(out + (size_t)row0 * d + col) =
          __floats2bfloat162_rn(acc[i][0] * mul0, acc[i][1] * mul0);
    if (row0 + 8 < n)
      *reinterpret_cast<__nv_bfloat162*>(out + (size_t)(row0 + 8) * d + col) =
          __floats2bfloat162_rn(acc[i][2] * mul1, acc[i][3] * mul1);
  }
}

// ---------------------------------------------------------------------------
// forward, tensor cores: one block per (bh, 64 MT queries, column part)
// ---------------------------------------------------------------------------

// Each warp owns MT m16 row tiles, so every K and V fragment read from shared
// memory feeds MT (K) or 2 MT (V) products.
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
  constexpr int CW = TC_CW<DP>, NO = CW / 8, PARTS = DP / CW;  // n8 tiles of the output
  constexpr int TS = TILE * LD;
  constexpr bool QREG = DP <= 128;  // q fragments held in registers
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [TQ][LD]
  __nv_bfloat16* ks = qs + TQ * LD;  // 2 x [TILE][LD]
  __nv_bfloat16* vs = ks + 2 * TS;   // 2 x [TILE][LD]
  size_t bh;
  int tile;
  block_pair(ntiles, bh, tile);
  const int q0 = tile / PARTS * TQ, c0 = tile % PARTS * CW;
  const size_t base = bh * n * d;
  const Lanes ln;
  const int warp = ln.warp, g = ln.g, t = ln.t;
  const int nkt = (n + TILE - 1) / TILE;

  for (int r = 0; r < TQ; r += TILE) load_tile_async<DP>(qs + r * LD, q + base, q0 + r, n, d);
  load_tile_async<DP>(ks, k + base, 0, n, d);
  load_tile_async<DP>(vs, v + base, 0, n, d);
  cp_async_commit();

  uint32_t qf[MT][QREG ? KS : 1][4];
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
    if (QREG && j == 0) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int kk = 0; kk < (QREG ? KS : 1); ++kk)
          ldsm_x4(qf[mt][kk], qs + ((warp * MT + mt) * 16 + ln.lm_row) * LD + kk * 16 + ln.lm_col);
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
      uint32_t qa[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        if constexpr (QREG) {
#pragma unroll
          for (int r = 0; r < 4; ++r) qa[mt][r] = qf[mt][kk][r];
        } else {
          ldsm_x4(qa[mt], qs + ((warp * MT + mt) * 16 + ln.lm_row) * LD + kk * 16 + ln.lm_col);
        }
      }
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t b[4];
        ldsm_x4(b, kb + (np * 16 + ln.lk_row) * LD + kk * 16 + ln.lk_col);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          mma_bf16(s[mt][2 * np], qa[mt], b[0], b[1]);
          mma_bf16(s[mt][2 * np + 1], qa[mt], b[2], b[3]);
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
      for (int mt = 0; mt < MT; ++mt) split_frag(s[mt][2 * kk], s[mt][2 * kk + 1], hi[mt], lo[mt]);
#pragma unroll
      for (int dp = 0; dp < NO / 2; ++dp) {
        uint32_t b[4];
        ldsm_x4_trans(b, vb + (kk * 16 + ln.lm_row) * LD + c0 + dp * 16 + ln.lm_col);
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
    store_acc<NO>(o + base, acc[mt], row0, c0, t, n, d, 1.f / l0, 1.f / l1);
    if (t == 0 && c0 == 0) {
      if (row0 < n) lse[bh * n + row0] = m[mt][0] + logf(l0);
      if (row1 < n) lse[bh * n + row1] = m[mt][1] + logf(l1);
    }
  }
}

// ---------------------------------------------------------------------------
// dQ, tensor cores: one block per (bh, 64 MT queries, column part), 16 MT a
// warp
// ---------------------------------------------------------------------------

template <int DP>
constexpr int DQ_MT = DP <= 64 ? 2 : 1;

template <int DP>
__global__ void __launch_bounds__(NT_TC)
dq_tc_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
             const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
             const float* __restrict__ lse, const float* __restrict__ delta,
             __nv_bfloat16* __restrict__ dq, int n, int d, int ntiles, float scale) {
  constexpr int MT = DQ_MT<DP>, TQ = 64 * MT;
  constexpr int SC = 32 / MT;  // keys per score step: 16 x SC scores of s and dp per m16 tile
  constexpr int LD = DP + 8, KS = DP / 16, TS = TILE * LD;
  constexpr int CW = TC_CW<DP>, NC = CW / 8, PARTS = DP / CW;
  constexpr bool QREG = MT * DP <= 128;  // q and do fragments held in registers
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [TQ][LD]
  __nv_bfloat16* dos = qs + TQ * LD;  // [TQ][LD]
  __nv_bfloat16* ks = dos + TQ * LD;  // 2 x [TILE][LD]
  __nv_bfloat16* vs = ks + 2 * TS;    // 2 x [TILE][LD]
  size_t bh;
  int tile;
  block_pair(ntiles, bh, tile);
  const int q0 = tile / PARTS * TQ, c0 = tile % PARTS * CW;
  const size_t base = bh * n * d;
  const Lanes ln;
  const int nkt = (n + TILE - 1) / TILE;
  const float sl = scale * LOG2E;

  for (int r = 0; r < TQ; r += TILE) {
    load_tile_async<DP>(qs + r * LD, q + base, q0 + r, n, d);
    load_tile_async<DP>(dos + r * LD, dout + base, q0 + r, n, d);
  }
  load_tile_async<DP>(ks, k + base, 0, n, d);
  load_tile_async<DP>(vs, v + base, 0, n, d);
  cp_async_commit();

  // rows g and g + 8 of each m16 tile: l * log2(e) and delta; rows past n
  // read row n - 1 and are never stored
  int row0[MT];
  float ll[MT][2], dl[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    row0[mt] = q0 + (ln.warp * MT + mt) * 16 + ln.g;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const size_t r = bh * n + min(row0[mt] + 8 * h, n - 1);
      ll[mt][h] = lse[r] * LOG2E;
      dl[mt][h] = delta[r];
    }
  }
  uint32_t qf[MT][QREG ? KS : 1][4], df[MT][QREG ? KS : 1][4];
  float acc[MT][NC][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int i = 0; i < NC; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][i][e] = 0.f;

  for (int j = 0; j < nkt; ++j) {
    const int buf = j & 1;
    if (j + 1 < nkt) {
      load_tile_async<DP>(ks + (buf ^ 1) * TS, k + base, (j + 1) * TILE, n, d);
      load_tile_async<DP>(vs + (buf ^ 1) * TS, v + base, (j + 1) * TILE, n, d);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (QREG && j == 0) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int kk = 0; kk < (QREG ? KS : 1); ++kk) {
          const int off = ((ln.warp * MT + mt) * 16 + ln.lm_row) * LD + kk * 16 + ln.lm_col;
          ldsm_x4(qf[mt][kk], qs + off);
          ldsm_x4(df[mt][kk], dos + off);
        }
    }
    const __nv_bfloat16* kb = ks + buf * TS;
    const __nv_bfloat16* vb = vs + buf * TS;

#pragma unroll
    for (int kc = 0; kc < TILE; kc += SC) {
      // s = q . k^T and dp = do . v^T over SC keys: SC / 8 n8 tiles each
      float s[MT][SC / 8][4], dp[MT][SC / 8][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int i = 0; i < SC / 8; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[mt][i][e] = dp[mt][i][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        uint32_t qa[MT][4], da[MT][4];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          if constexpr (QREG) {
#pragma unroll
            for (int r = 0; r < 4; ++r) qa[mt][r] = qf[mt][kk][r], da[mt][r] = df[mt][kk][r];
          } else {
            const int off = ((ln.warp * MT + mt) * 16 + ln.lm_row) * LD + kk * 16 + ln.lm_col;
            ldsm_x4(qa[mt], qs + off);
            ldsm_x4(da[mt], dos + off);
          }
        }
#pragma unroll
        for (int np = 0; np < SC / 16; ++np) {
          const int off = (kc + np * 16 + ln.lk_row) * LD + kk * 16 + ln.lk_col;
          uint32_t b[4];
          ldsm_x4(b, kb + off);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            mma_bf16(s[mt][2 * np], qa[mt], b[0], b[1]);
            mma_bf16(s[mt][2 * np + 1], qa[mt], b[2], b[3]);
          }
          ldsm_x4(b, vb + off);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            mma_bf16(dp[mt][2 * np], da[mt], b[0], b[1]);
            mma_bf16(dp[mt][2 * np + 1], da[mt], b[2], b[3]);
          }
        }
      }
      if (j * TILE + kc + SC > n) {  // keys at or past n: p = 0
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int i = 0; i < SC / 8; ++i)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              if (j * TILE + kc + i * 8 + 2 * ln.t + (e & 1) >= n) s[mt][i][e] = -INFINITY;
      }
      // p = 2^(s * scale * log2(e) - l * log2(e)), ds = p * (dp - delta) in
      // place of s
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int i = 0; i < SC / 8; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float p = ex2(fmaf(s[mt][i][e], sl, -ll[mt][e >> 1]));
            s[mt][i][e] = p * (dp[mt][i][e] - dl[mt][e >> 1]);
          }
      // acc += ds . k, ds split into bf16 hi + lo terms, k read transposed
#pragma unroll
      for (int kq = 0; kq < SC / 16; ++kq) {
        uint32_t hi[MT][4], lo[MT][4];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) split_frag(s[mt][2 * kq], s[mt][2 * kq + 1], hi[mt], lo[mt]);
#pragma unroll
        for (int dc = 0; dc < NC / 2; ++dc) {
          uint32_t b[4];
          ldsm_x4_trans(b, kb + (kc + kq * 16 + ln.lm_row) * LD + c0 + dc * 16 + ln.lm_col);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            mma_bf16(acc[mt][2 * dc], hi[mt], b[0], b[1]);
            mma_bf16(acc[mt][2 * dc], lo[mt], b[0], b[1]);
            mma_bf16(acc[mt][2 * dc + 1], hi[mt], b[2], b[3]);
            mma_bf16(acc[mt][2 * dc + 1], lo[mt], b[2], b[3]);
          }
        }
      }
    }
    __syncthreads();  // this buffer is refilled by the next iteration's copies
  }
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
    store_acc<NC>(dq + base, acc[mt], row0[mt], c0, ln.t, n, d, scale, scale);
}

// ---------------------------------------------------------------------------
// dK/dV, tensor cores: one block per (bh, 64 keys, column part), 16 a warp
// ---------------------------------------------------------------------------

template <int DP>
__global__ void __launch_bounds__(NT_TC)
dkv_tc_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
              const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ delta,
              __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, int n, int d,
              int ntiles, float scale) {
  constexpr int SC = 32;  // queries per score step: 16 x SC scores of s^T and dp^T
  constexpr int LD = DP + 8, KS = DP / 16, TS = TILE * LD;
  constexpr int CW = TC_CW<DP>, NC = CW / 8, PARTS = DP / CW;
  constexpr bool KREG = DP <= 64;  // k and v fragments held in registers
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [TILE][LD]
  __nv_bfloat16* vs = ks + TS;       // [TILE][LD]
  __nv_bfloat16* qs = vs + TS;       // 2 x [TILE][LD]
  __nv_bfloat16* dos = qs + 2 * TS;  // 2 x [TILE][LD]
  float* ls = reinterpret_cast<float*>(dos + 2 * TS);  // 2 x [TILE] logsumexp of the query tile
  float* dls = ls + 2 * TILE;                          // 2 x [TILE] delta of the query tile
  size_t bh;
  int tile;
  block_pair(ntiles, bh, tile);
  const int k0 = tile / PARTS * TILE, c0 = tile % PARTS * CW;
  const size_t base = bh * n * d;
  const Lanes ln;
  const int nqt = (n + TILE - 1) / TILE;
  const int row0 = k0 + ln.warp * 16 + ln.g;  // this lane's keys row0 and row0 + 8
  const __nv_bfloat16* kw = ks + (ln.warp * 16 + ln.lm_row) * LD + ln.lm_col;
  const __nv_bfloat16* vw = vs + (ln.warp * 16 + ln.lm_row) * LD + ln.lm_col;
  const float sl = scale * LOG2E;

  load_tile_async<DP>(ks, k + base, k0, n, d);
  load_tile_async<DP>(vs, v + base, k0, n, d);
  load_tile_async<DP>(qs, q + base, 0, n, d);
  load_tile_async<DP>(dos, dout + base, 0, n, d);
  load_rows_async(ls, lse + bh * n, 0, n);
  load_rows_async(dls, delta + bh * n, 0, n);
  cp_async_commit();

  uint32_t kf[KREG ? KS : 1][4], vf[KREG ? KS : 1][4];
  float gk[NC][4], gv[NC][4];
#pragma unroll
  for (int i = 0; i < NC; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) gk[i][e] = gv[i][e] = 0.f;

  for (int j = 0; j < nqt; ++j) {
    const int buf = j & 1;
    if (j + 1 < nqt) {
      const int r1 = (j + 1) * TILE;
      load_tile_async<DP>(qs + (buf ^ 1) * TS, q + base, r1, n, d);
      load_tile_async<DP>(dos + (buf ^ 1) * TS, dout + base, r1, n, d);
      load_rows_async(ls + (buf ^ 1) * TILE, lse + bh * n, r1, n);
      load_rows_async(dls + (buf ^ 1) * TILE, delta + bh * n, r1, n);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (KREG && j == 0) {
#pragma unroll
      for (int kk = 0; kk < (KREG ? KS : 1); ++kk) {
        ldsm_x4(kf[kk], kw + kk * 16);
        ldsm_x4(vf[kk], vw + kk * 16);
      }
    }
    const __nv_bfloat16* qb = qs + buf * TS;
    const __nv_bfloat16* db = dos + buf * TS;
    const float* lb = ls + buf * TILE;
    const float* dlb = dls + buf * TILE;

#pragma unroll
    for (int qc = 0; qc < TILE; qc += SC) {
      // s^T = k . q^T and dp^T = v . do^T over SC queries: SC / 8 n8 tiles each
      float s[SC / 8][4], dp[SC / 8][4];
#pragma unroll
      for (int i = 0; i < SC / 8; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[i][e] = dp[i][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        uint32_t ka[4], va[4];
        if constexpr (KREG) {
#pragma unroll
          for (int r = 0; r < 4; ++r) ka[r] = kf[kk][r], va[r] = vf[kk][r];
        } else {
          ldsm_x4(ka, kw + kk * 16);
          ldsm_x4(va, vw + kk * 16);
        }
#pragma unroll
        for (int np = 0; np < SC / 16; ++np) {
          const int off = (qc + np * 16 + ln.lk_row) * LD + kk * 16 + ln.lk_col;
          uint32_t b[4];
          ldsm_x4(b, qb + off);
          mma_bf16(s[2 * np], ka, b[0], b[1]);
          mma_bf16(s[2 * np + 1], ka, b[2], b[3]);
          ldsm_x4(b, db + off);
          mma_bf16(dp[2 * np], va, b[0], b[1]);
          mma_bf16(dp[2 * np + 1], va, b[2], b[3]);
        }
      }
      if (k0 + TILE > n || j * TILE + qc + SC > n) {  // keys or queries at or past n: p = 0
#pragma unroll
        for (int i = 0; i < SC / 8; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (j * TILE + qc + i * 8 + 2 * ln.t + (e & 1) >= n || row0 + (e >> 1) * 8 >= n)
              s[i][e] = -INFINITY;
      }
      // p^T = 2^(s^T * scale * log2(e) - l * log2(e)) in s, ds^T = p^T *
      // (dp^T - delta) in dp
#pragma unroll
      for (int i = 0; i < SC / 8; ++i) {
        const int col = qc + i * 8 + 2 * ln.t;  // query in the tile
        const float2 l2 = *reinterpret_cast<const float2*>(lb + col);
        const float2 d2 = *reinterpret_cast<const float2*>(dlb + col);
        const float ll0 = l2.x * LOG2E, ll1 = l2.y * LOG2E;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = ex2(fmaf(s[i][e], sl, -(e & 1 ? ll1 : ll0)));
          s[i][e] = p;
          dp[i][e] = p * (dp[i][e] - (e & 1 ? d2.y : d2.x));
        }
      }
      // dv += p^T . do and dk += ds^T . q, each split into bf16 hi + lo terms,
      // do and q read transposed
#pragma unroll
      for (int kq = 0; kq < SC / 16; ++kq) {
        uint32_t phi[4], plo[4], dhi[4], dlo[4];
        split_frag(s[2 * kq], s[2 * kq + 1], phi, plo);
        split_frag(dp[2 * kq], dp[2 * kq + 1], dhi, dlo);
#pragma unroll
        for (int dc = 0; dc < NC / 2; ++dc) {
          const int off = (qc + kq * 16 + ln.lm_row) * LD + c0 + dc * 16 + ln.lm_col;
          uint32_t b[4];
          ldsm_x4_trans(b, db + off);
          mma_bf16(gv[2 * dc], phi, b[0], b[1]);
          mma_bf16(gv[2 * dc], plo, b[0], b[1]);
          mma_bf16(gv[2 * dc + 1], phi, b[2], b[3]);
          mma_bf16(gv[2 * dc + 1], plo, b[2], b[3]);
          ldsm_x4_trans(b, qb + off);
          mma_bf16(gk[2 * dc], dhi, b[0], b[1]);
          mma_bf16(gk[2 * dc], dlo, b[0], b[1]);
          mma_bf16(gk[2 * dc + 1], dhi, b[2], b[3]);
          mma_bf16(gk[2 * dc + 1], dlo, b[2], b[3]);
        }
      }
    }
    __syncthreads();  // this buffer is refilled by the next iteration's copies
  }
  store_acc<NC>(dk + base, gk, row0, c0, ln.t, n, d, scale, scale);
  store_acc<NC>(dv + base, gv, row0, c0, ln.t, n, d, 1.f, 1.f);
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

constexpr size_t f32_tile_bytes(int rows, int dp) { return (size_t)rows * (dp + 4) * sizeof(float); }
constexpr size_t bf16_tile_bytes(int dp) { return (size_t)TILE * (dp + 8) * sizeof(__nv_bfloat16); }

// grid = bh * ceil(n / rows) * parts blocks, and the kernel's shared memory
template <typename K>
cudaError_t prepare(K kern, size_t smem, int bh, int n, unsigned& grid, int& ntiles, int rows,
                    int parts = 1) {
  if (bh <= 0 || n <= 0) return cudaErrorInvalidValue;
  ntiles = (n + rows - 1) / rows * parts;
  if ((long long)bh * ntiles > INT_MAX) return cudaErrorInvalidValue;
  grid = (unsigned)(bh * ntiles);
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <int DP, bool BF>
cudaError_t run_fwd(const void* q, const void* k, const void* v, void* o, float* l,
                    int bh, int n, int d, float scale, cudaStream_t stream) {
  unsigned grid;
  int ntiles;
  if constexpr (BF) {
    constexpr int TQ = 64 * TC_MT<DP>;
    const size_t smem = (TQ / TILE + 4) * bf16_tile_bytes(DP);
    auto kern = fwd_tc_kernel<DP>;
    cudaError_t e = prepare(kern, smem, bh, n, grid, ntiles, TQ, DP / TC_CW<DP>);
    if (e != cudaSuccess) return e;
    using T = __nv_bfloat16;
    kern<<<grid, NT_TC, smem, stream>>>((const T*)q, (const T*)k, (const T*)v, (T*)o, l, n, d,
                                        ntiles, scale);
  } else {
    const size_t smem = 3 * f32_tile_bytes(TILE, DP) + f32_tile_bytes(TILE, TILE);
    auto kern = fwd_kernel<DP>;
    cudaError_t e = prepare(kern, smem, bh, n, grid, ntiles, TILE);
    if (e != cudaSuccess) return e;
    kern<<<grid, NT, smem, stream>>>((const float*)q, (const float*)k, (const float*)v,
                                     (float*)o, l, n, d, ntiles, scale);
  }
  return cudaGetLastError();
}

template <int DP, bool BF>
cudaError_t run_dq(const void* q, const void* k, const void* v, const void* dout,
                   const float* l, const float* delta, void* dq, int bh, int n, int d,
                   float scale, cudaStream_t stream) {
  unsigned grid;
  int ntiles;
  if constexpr (BF) {
    constexpr int TQ = 64 * DQ_MT<DP>;
    const size_t smem = (2 * TQ / TILE + 4) * bf16_tile_bytes(DP);
    auto kern = dq_tc_kernel<DP>;
    cudaError_t e = prepare(kern, smem, bh, n, grid, ntiles, TQ, DP / TC_CW<DP>);
    if (e != cudaSuccess) return e;
    using T = __nv_bfloat16;
    kern<<<grid, NT_TC, smem, stream>>>((const T*)q, (const T*)k, (const T*)v, (const T*)dout,
                                        l, delta, (T*)dq, n, d, ntiles, scale);
  } else {
    constexpr int TR = 16 * RPT<DP>;
    const size_t smem = 2 * f32_tile_bytes(TR, DP) + 2 * f32_tile_bytes(TILE, DP) +
                        f32_tile_bytes(TR, TILE);
    auto kern = dq_kernel<DP>;
    cudaError_t e = prepare(kern, smem, bh, n, grid, ntiles, TR);
    if (e != cudaSuccess) return e;
    kern<<<grid, NT, smem, stream>>>((const float*)q, (const float*)k, (const float*)v,
                                     (const float*)dout, l, delta, (float*)dq, n, d, ntiles,
                                     scale);
  }
  return cudaGetLastError();
}

template <int DP, bool BF>
cudaError_t run_dkv(const void* q, const void* k, const void* v, const void* dout,
                    const float* l, const float* delta, void* dk, void* dv, int bh, int n,
                    int d, float scale, cudaStream_t stream) {
  unsigned grid;
  int ntiles;
  if constexpr (BF) {
    const size_t smem = 6 * bf16_tile_bytes(DP) + 4 * TILE * sizeof(float);
    auto kern = dkv_tc_kernel<DP>;
    cudaError_t e = prepare(kern, smem, bh, n, grid, ntiles, TILE, DP / TC_CW<DP>);
    if (e != cudaSuccess) return e;
    using T = __nv_bfloat16;
    kern<<<grid, NT_TC, smem, stream>>>((const T*)q, (const T*)k, (const T*)v, (const T*)dout,
                                        l, delta, (T*)dk, (T*)dv, n, d, ntiles, scale);
  } else {
    constexpr int TR = 16 * RPT<DP>;
    const size_t smem = 2 * f32_tile_bytes(TR, DP) + 2 * f32_tile_bytes(TILE, DP) +
                        2 * f32_tile_bytes(TR, TILE) + 2 * TILE * sizeof(float);
    auto kern = dkv_kernel<DP>;
    cudaError_t e = prepare(kern, smem, bh, n, grid, ntiles, TR);
    if (e != cudaSuccess) return e;
    kern<<<grid, NT, smem, stream>>>((const float*)q, (const float*)k, (const float*)v,
                                     (const float*)dout, l, delta, (float*)dk, (float*)dv, n, d,
                                     ntiles, scale);
  }
  return cudaGetLastError();
}

// Dispatch on the padded head dim (16, 32, 64, 96, 128, 160, 192, 256;
// d % 8 == 0) and the input type (bf16 or f32).
#define ATT_DISPATCH(d, bf, CALL)                                               \
  if ((d) <= 0 || (d) % 8 != 0 || (d) > 256) return (int)cudaErrorInvalidValue; \
  if ((d) <= 16) return (int)(bf ? CALL(16, true) : CALL(16, false));           \
  if ((d) <= 32) return (int)(bf ? CALL(32, true) : CALL(32, false));           \
  if ((d) <= 64) return (int)(bf ? CALL(64, true) : CALL(64, false));           \
  if ((d) <= 96) return (int)(bf ? CALL(96, true) : CALL(96, false));           \
  if ((d) <= 128) return (int)(bf ? CALL(128, true) : CALL(128, false));        \
  if ((d) <= 160) return (int)(bf ? CALL(160, true) : CALL(160, false));        \
  if ((d) <= 192) return (int)(bf ? CALL(192, true) : CALL(192, false));        \
  return (int)(bf ? CALL(256, true) : CALL(256, false));

}  // namespace

ATT_EXPORT int attention_fwd(const void* q, const void* k, const void* v, void* o, float* l,
                             int bh, int n, int d, int bf, float scale, void* stream) {
#define CALL(DP, BF) run_fwd<DP, BF>(q, k, v, o, l, bh, n, d, scale, (cudaStream_t)stream)
  ATT_DISPATCH(d, bf, CALL)
#undef CALL
}

ATT_EXPORT int attention_dq(const void* q, const void* k, const void* v, const void* dout,
                            const float* l, const float* delta, void* dq, int bh, int n,
                            int d, int bf, float scale, void* stream) {
#define CALL(DP, BF) \
  run_dq<DP, BF>(q, k, v, dout, l, delta, dq, bh, n, d, scale, (cudaStream_t)stream)
  ATT_DISPATCH(d, bf, CALL)
#undef CALL
}

ATT_EXPORT int attention_dkv(const void* q, const void* k, const void* v, const void* dout,
                             const float* l, const float* delta, void* dk, void* dv, int bh,
                             int n, int d, int bf, float scale, void* stream) {
#define CALL(DP, BF) \
  run_dkv<DP, BF>(q, k, v, dout, l, delta, dk, dv, bh, n, d, scale, (cudaStream_t)stream)
  ATT_DISPATCH(d, bf, CALL)
#undef CALL
}
