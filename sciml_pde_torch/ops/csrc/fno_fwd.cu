// Forward kernels of the fused FNO-2D step on Hopper (sm_90a).
//
// Replaces the TPU kernel sciml_pde_tpu/ops/fno_fused_step.py::_full_fwd_kernel
// (B1), which runs the whole model per batch element inside VMEM.  One
// element's activation, (20, 130, 130) f32 = 1.35 MB, is far above the
// 227 KB of shared memory an SM offers, so the forward is split along the
// lines of the JAX file's _bb_fwd_kernel / _head_fwd_kernel and spills each
// layer's activation to device memory between launches:
//
//   fno_stats      instance-norm mean/std per (element, channel): one
//                  thread-block cluster per pair (see its note below)
//   fno_lift       normalise + grid channels + fc0, into the padded field
//   per layer:
//     fno_wdft     W-axis partial rDFT: (rows, Wp) x (Wp, 2*m2), on the
//                  tensor cores under bf16 dot inputs (see its note below)
//     fno_corner   H-axis corner DFT -> complex mode mix -> inverse H,
//                  a thread-block cluster per (element, W-mode) split
//                  along H (see its note below)
//     fno_iwdft_pw Hermitian inverse W + 1x1 conv + bias (+ gelu) as one
//                  product a row, a block over several image rows (see
//                  its note below)
//   fno_head_fwd   fc1 -> gelu -> fc2 -> de-norm, a warp per 32 pixels on the
//                  tensor cores under bf16 dot inputs (see its note below)
//
// The same wdft / corner / iwdft_pw kernels run the adjoint chain of the
// backward (fno_bwd.cu holds the rest): the caller hands them the adjoint
// factor matrices and sets `adj`.
//
// The JAX file's split kernels are sequences of these kernels as well
// (sciml_pde_torch/ops/fno_fused_step.py): _bb_fwd_kernel (B1a) is stats,
// lift and the layers with `pre` kept in f32, _head_fwd_kernel (B1b) is
// head_fwd, and the adjoint and weight-gradient passes of _bb_bwd_kernel
// (B2b) and _bb_wgrad_kernel (B2c) run wdft / corner / iwdft_pw; for B2c
// wdft applies gelu on load and corner stops after the spectrum.
//
// Bound at the flagship shape (B=4, 128^2, width 20, modes 12): a layer is
// ~60 MFLOP per element and moves a few MB, so every kernel here is
// latency-bound, not compute- or bandwidth-bound.  The products run on
// mma.sync under bf16 dot inputs and on f32 FMAs otherwise (the notes
// below); wgmma and TMA are left for a later change.

#include <cooperative_groups.h>
#include <stdint.h>

#include "fno_common.cuh"

// ---------------------------------------------------------------------------
// instance-norm statistics
//
// fno_stats replaces the statistics part of _full_fwd_kernel (B1) and
// _bb_fwd_kernel (B1a), the JAX file's _stats_cols: per (element, channel)
// of win (B, T, Cc, X*Y) the mean over (T, X, Y) and the two-pass unbiased
// std sqrt(sum((x - mean)^2) / (n - 1)) + 1e-7, n = T*X*Y.  Bound by bytes:
// each value read once (5.2 MB at the flagship shape, 1.6 us at 3.35 TB/s),
// while only B*Cc = 8 (element, channel) pairs exist.  So each pair gets a
// thread-block cluster of STATS_CLUSTER blocks (the portable size), 64
// blocks at the flagship shape.  Each block streams a contiguous share of
// its pair's n values (T runs of X*Y floats, Cc*X*Y apart) with 16-byte
// loads (scalar loads for each run's misaligned head and ragged tail), sums
// in registers and warp shuffles, and keeps its share in shared memory
// where it fits.  The cluster adds the blocks' sums through distributed
// shared memory in rank order, so every block forms the same mean; each
// block then sums its squared deviations (from its shared copy, about 10%
// faster on an H100 than a second read that hits L2, or from that read
// where the share does not fit) and rank 0 adds those in rank order.  One
// launch, one read of device memory, a fixed summation order, no atomics;
// E[x^2] - E[x]^2 is not used, as DR fields carry offsets that it cancels.
//
// The sums run in f64 (the f32 squares of the f32 deviations x - mean, as
// the reference forms them), and mean = f32(sum / n), var = f32(sum / (n -
// 1)): the correctly rounded statistics, which no summation order changes.
// An f32 sum in another order than the plain version's moves the mean by an
// ulp, and the bf16 roundings of every later product with it.
// ---------------------------------------------------------------------------

constexpr int STATS_CLUSTER = 8;
constexpr int STATS_NT = 512;
constexpr size_t STATS_KEEP_MAX = 192 * 1024;  // largest share kept in shared memory

// The block's sum of v in a fixed order (warp shuffles, then the warps in
// order); every thread gets it.
__device__ double block_sum(double v, double* red) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = v;
  __syncthreads();
  double r = 0.0;
  for (int w = 0; w < STATS_NT / 32; ++w) r += red[w];
  __syncthreads();
  return r;
}

// Calls f(value, j) or f(float4, j) on the values [lo, hi) of one pair's
// logical index space t*XY + p, j the index within the share.
template <typename F>
__device__ __forceinline__ void walk_share(const float* pair, long long lo, long long hi,
                                           int XY, size_t run_stride, F& f) {
  for (long long t = lo / XY; t * XY < hi; ++t) {
    const long long s0 = max(lo, t * XY), s1 = min(hi, (t + 1) * XY);
    const float* p = pair + t * run_stride + (s0 - t * XY);
    const int len = (int)(s1 - s0), j0 = (int)(s0 - lo);
    const int head = min(len, (int)(((16 - ((uintptr_t)p & 15)) & 15) / 4));
    const int n4 = (len - head) / 4;
    for (int i = threadIdx.x; i < head; i += STATS_NT) f(p[i], j0 + i);
    const float4* p4 = reinterpret_cast<const float4*>(p + head);
#pragma unroll 4
    for (int i = threadIdx.x; i < n4; i += STATS_NT) f(p4[i], j0 + head + 4 * i);
    for (int i = head + 4 * n4 + threadIdx.x; i < len; i += STATS_NT) f(p[i], j0 + i);
  }
}

struct SumKeep {  // pass 1: sum, and the share's copy when `keep` is set
  double s;
  float* keep;
  __device__ void operator()(float x, int j) {
    s += x;
    if (keep) keep[j] = x;
  }
  __device__ void operator()(float4 x, int j) {
    s += ((double)x.x + x.y) + ((double)x.z + x.w);
    if (keep) {
      keep[j] = x.x; keep[j + 1] = x.y; keep[j + 2] = x.z; keep[j + 3] = x.w;
    }
  }
};

struct SqDev {  // pass 2: sum of the f32 squares of the f32 deviations from m
  double s;
  float m;
  __device__ void operator()(float x, int) {
    const float d = __fsub_rn(x, m);
    s += __fmul_rn(d, d);
  }
  __device__ void operator()(float4 x, int) {
    (*this)(x.x, 0); (*this)(x.y, 0); (*this)(x.z, 0); (*this)(x.w, 0);
  }
};

// win (B, T, Cc, X*Y) -> mean, std (B, Cc); grid B*Cc clusters of STATS_CLUSTER.
__global__ void __cluster_dims__(STATS_CLUSTER, 1, 1) __launch_bounds__(STATS_NT)
stats_kernel(const float* __restrict__ win, float* __restrict__ mean,
             float* __restrict__ stdv, int T, int Cc, int XY, int keep) {
  extern __shared__ __align__(16) float share[];  // the block's share, when kept
  __shared__ double red[STATS_NT / 32];
  __shared__ double part[2];  // this block's sum, then its squared deviations
  __shared__ float mean_s;
  namespace cgrp = cooperative_groups;
  cgrp::cluster_group cluster = cgrp::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int pair = blockIdx.x / STATS_CLUSTER;  // b * Cc + cc
  const int b = pair / Cc, cc = pair - b * Cc;
  const float* base = win + ((size_t)b * T * Cc + cc) * XY;
  const size_t run_stride = (size_t)Cc * XY;
  const long long n = (long long)T * XY;
  const long long lo = n * rank / STATS_CLUSTER, hi = n * (rank + 1) / STATS_CLUSTER;

  SumKeep f1{0.0, keep ? share : nullptr};
  walk_share(base, lo, hi, XY, run_stride, f1);
  const double s = block_sum(f1.s, red);
  if (threadIdx.x == 0) part[0] = s;
  cluster.sync();
  if (threadIdx.x == 0) {
    double tot = 0.0;
    for (int r = 0; r < STATS_CLUSTER; ++r) tot += *cluster.map_shared_rank(&part[0], r);
    mean_s = (float)(tot / (double)n);
  }
  __syncthreads();
  SqDev f2{0.0, mean_s};
  if (keep) {
    for (int i = threadIdx.x; i < (int)(hi - lo); i += STATS_NT) f2(share[i], i);
  } else {
    walk_share(base, lo, hi, XY, run_stride, f2);
  }
  const double ss = block_sum(f2.s, red);
  if (threadIdx.x == 0) part[1] = ss;
  cluster.sync();
  if (rank == 0 && threadIdx.x == 0) {
    double v = 0.0;
    for (int r = 0; r < STATS_CLUSTER; ++r) v += *cluster.map_shared_rank(&part[1], r);
    mean[pair] = mean_s;
    stdv[pair] = __fadd_rn(sqrtf((float)(v / (double)(n - 1))), 1e-7f);
  }
  cluster.sync();  // no block leaves while rank 0 reads its shared memory
}

FNO_EXPORT int fno_stats(const float* win, float* mean, float* stdv, int B, int T,
                         int Cc, int XY, void* stream) {
  const long long n = (long long)T * XY;
  const size_t share = (size_t)((n + STATS_CLUSTER - 1) / STATS_CLUSTER) * sizeof(float);
  const int keep = share <= STATS_KEEP_MAX;
  const size_t smem = keep ? share : 0;
  const cudaError_t e = fno_set_smem(stats_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  stats_kernel<<<B * Cc * STATS_CLUSTER, STATS_NT, smem, (cudaStream_t)stream>>>(
      win, mean, stdv, T, Cc, XY, keep);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// lift: h0 (B, C, Hp, Wp) = fc0(normalised window ++ grid), zero in the pad;
// also writes the lift input finp (B, F, X, Y) that the lift gradient reads.
//
// Replaces the lift of _full_fwd_kernel (B1) and _bb_fwd_kernel (B1a):
// _prep_el (sciml_pde_tpu/ops/fno_fused_step.py:441), (win - mean) / std
// with the two grid channels appended, and _dot(p.w0t, inp) + b0 (:473,
// :494).  Bound by bytes at the flagship (F = T Cc + 2 = 22, C = 20): 5.24
// MB of window read, 5.77 MB of finp and 5.41 MB of h0 written, 4.94 us at
// 3.35 TB/s, against 58 MFLOP.  The first design gave each thread one
// padded pixel and made its F scalar loads one after another, too few bytes
// in flight to cover the latency of device memory.  Here:
//   - a thread takes 2 consecutive pixels of an image row and up to
//     LIFT_FMAX input features at once (all F = 22 of the flagship; a
//     larger F in chunks of that many): every load of the chunk (8 bytes a
//     feature where Y and the pointers allow, VEC; guarded scalars
//     otherwise) goes out before any arithmetic, about 5.8 MB in flight over
//     the card at the flagship, from 8 warps an SM;
//   - each value is normalised by an IEEE division (finp keeps its bits),
//     stored to finp (8 bytes at a time under VEC), and rounded once, in
//     place, for the product;
//   - then each output channel in turn: its 2 sums in order over f, the
//     (C, F) weights read from shared memory two at a time where F is even
//     (a broadcast), so any C whose weights fit in shared memory runs: C * F
//     * 4 bytes up to 227 KB, C up to 2641 at F = 22 (fno_kernels.lift
//     checks it).  A later chunk of F carries each sum on from the value the
//     chunk before stored in h0 (the same in-order sum); the last adds the
//     bias;
//   - h0 rows (Wp = 130 floats at the flagship) start 8 bytes apart from a
//     16-byte boundary: two floats a store where Wp is even (PAIR);
//   - blocks of their own, after the image's, write the pad's zeros, two
//     floats a store under PAIR: the columns Y.. of rows below X, then the
//     rows X.. .
// ---------------------------------------------------------------------------

constexpr int LIFT_FMAX = 24;  // input features a chunk, 2 pixels each in registers
constexpr int LIFT_NT = 256;   // threads a block

// 2 values from 2 consecutive floats: one 8-byte load (VEC), or n guarded scalars
template <bool VEC>
__device__ __forceinline__ float2 lift_load(const float* src, int n) {
  if constexpr (VEC) return *reinterpret_cast<const float2*>(src);
  return make_float2(src[0], n > 1 ? src[1] : 0.f);
}

template <bool VEC>
__global__ void __launch_bounds__(LIFT_NT)
lift_kernel(const float* __restrict__ win, const float* __restrict__ grid2,
            const float* __restrict__ mean, const float* __restrict__ stdv,
            const float* __restrict__ w0t, const float* __restrict__ b0, float* __restrict__ h0,
            float* __restrict__ finp, int B, int T, int Cc, int X, int Y, int C, int Hp, int Wp,
            int bf, int nmain, int pair) {
  const size_t plane = (size_t)Hp * Wp;
  if ((int)blockIdx.x >= nmain) {  // the pad's zeros, a store a thread
    const int pw = Wp - Y, step = pair ? 2 : 1;
    const int per = (Hp * Wp - X * Y) / step;  // stores a plane
    const int item = (blockIdx.x - nmain) * LIFT_NT + threadIdx.x;  // 32-bit index arithmetic
    if (item >= B * C * per) return;
    const int idx = item % per * step;
    const int pos = idx < X * pw ? idx / pw * Wp + Y + idx % pw : X * Wp + (idx - X * pw);
    float* dst = h0 + (size_t)(item / per) * plane + pos;
    if (pair)
      *reinterpret_cast<float2*>(dst) = make_float2(0.f, 0.f);
    else
      *dst = 0.f;
    return;
  }
  extern __shared__ float ws[];  // (C, F)
  const int TC = T * Cc, F = TC + 2;
  for (int i = threadIdx.x; i < C * F; i += LIFT_NT) ws[i] = w0t[i];
  __syncthreads();
  const int YP = (Y + 1) / 2;
  const int q = blockIdx.x * LIFT_NT + threadIdx.x;  // 32-bit index arithmetic
  if (q >= B * X * YP) return;
  const int y0 = q % YP * 2, x = q / YP % X, b = q / (YP * X);
  const int n = min(2, Y - y0);  // pixels of this thread (2 under VEC)
  const size_t XY = (size_t)X * Y, pix = (size_t)x * Y + y0;
  const float* wsrc = win + (size_t)b * TC * XY + pix;
  float* fdst = finp + (size_t)b * F * XY + pix;
  float* hout = h0 + (size_t)b * C * plane + (size_t)x * Wp + y0;
  const bool pairs = pair && n == 2, wpairs = F % 2 == 0;
  for (int f0 = 0; f0 < F; f0 += LIFT_FMAX) {
    float2 v[LIFT_FMAX];
#pragma unroll
    for (int k = 0; k < LIFT_FMAX; ++k) {  // the chunk's loads, all before any arithmetic
      const int f = f0 + k;
      if (f < TC)
        v[k] = lift_load<VEC>(wsrc + f * XY, n);
      else if (f < F)
        v[k] = lift_load<VEC>(grid2 + (f - TC) * XY + pix, n);
    }
#pragma unroll
    for (int k = 0; k < LIFT_FMAX; ++k) {
      const int f = f0 + k;
      if (f >= F) continue;
      if (f < TC) {
        const float mu = mean[b * Cc + f % Cc], sd = stdv[b * Cc + f % Cc];
        v[k] = make_float2((v[k].x - mu) / sd, (v[k].y - mu) / sd);
      }
      float* dst = fdst + f * XY;
      if constexpr (VEC) {
        *reinterpret_cast<float2*>(dst) = v[k];
      } else {
        dst[0] = v[k].x;
        if (n > 1) dst[1] = v[k].y;
      }
      v[k] = make_float2(rd(v[k].x, bf), rd(v[k].y, bf));
    }
    const bool last = f0 + LIFT_FMAX >= F;
    for (int c = 0; c < C; ++c) {
      float* dst = hout + c * plane;
      float2 acc = make_float2(0.f, 0.f);
      if (f0 > 0) acc = make_float2(dst[0], n > 1 ? dst[1] : 0.f);  // the chunks before
      const float* w = ws + c * F + f0;
      if (wpairs) {  // f0 and F even: the weights two at a time
#pragma unroll
        for (int k = 0; k < LIFT_FMAX; k += 2) {
          if (f0 + k >= F) continue;
          const float2 wk = *reinterpret_cast<const float2*>(w + k);
          acc.x += wk.x * v[k].x, acc.y += wk.x * v[k].y;
          acc.x += wk.y * v[k + 1].x, acc.y += wk.y * v[k + 1].y;
        }
      } else {
#pragma unroll
        for (int k = 0; k < LIFT_FMAX; ++k) {
          if (f0 + k >= F) continue;
          acc.x += w[k] * v[k].x, acc.y += w[k] * v[k].y;
        }
      }
      if (last) acc = make_float2(acc.x + b0[c], acc.y + b0[c]);
      if (pairs) {
        *reinterpret_cast<float2*>(dst) = acc;
      } else {
        dst[0] = acc.x;
        if (n > 1) dst[1] = acc.y;
      }
    }
  }
}

FNO_EXPORT int fno_lift(const float* win, const float* grid2, const float* mean,
                        const float* stdv, const float* w0t, const float* b0, float* h0,
                        float* finp, int B, int T, int Cc, int X, int Y, int C, int Hp,
                        int Wp, int bf, void* stream) {
  const size_t smem = (size_t)C * (T * Cc + 2) * sizeof(float);
  const auto a8 = [](const void* ptr) { return reinterpret_cast<uintptr_t>(ptr) % 8 == 0; };
  const bool vec = Y % 2 == 0 && a8(win) && a8(grid2) && a8(finp);
  // h0 pairs: Wp even keeps every row and the pad's pairs on 8 bytes; an odd
  // pad area per plane would leave one float over
  const int pair = Wp % 2 == 0 && Y % 2 == 0 && reinterpret_cast<uintptr_t>(h0) % 8 == 0;
  const size_t pairs = (size_t)B * X * ((Y + 1) / 2);
  const int nmain = (int)((pairs + LIFT_NT - 1) / LIFT_NT);
  const size_t pads = (size_t)B * C * (((size_t)Hp * Wp - (size_t)X * Y) / (pair ? 2 : 1));
  const unsigned grid = (unsigned)(nmain + (pads + LIFT_NT - 1) / LIFT_NT);
  const auto kernel = vec ? lift_kernel<true> : lift_kernel<false>;
  cudaError_t e = fno_set_smem(kernel, smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<grid, LIFT_NT, smem, (cudaStream_t)stream>>>(win, grid2, mean, stdv, w0t, b0, h0,
                                                         finp, B, T, Cc, X, Y, C, Hp, Wp, bf,
                                                         nmain, pair);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// W-axis partial DFT: out (M, J) = v (M, N) x fac (N, J), v = x.
// With `pre` set the input is the cotangent dh of a layer output and the
// kernel first forms dpre = dh * gelu'(pre) (or dh itself for the last
// layer), writes it out, and transforms it: the first stage of the adjoint.
// With `gelu_in` set the input is a saved pre-activation and the kernel
// transforms gelu(in), the layer's output: the split weight-gradient pass
// recomputes the spectrum of a layer's input from the previous `pre`.
//
// Replaces the W-axis products of _full_fwd_kernel and _full_bwd_kernel,
// _dot(hf, f.fr) and _dot(hf, f.fi) at sciml_pde_tpu/ops/fno_fused_step.py:300
// and, on dpre = dh * gelu'(pre) (:1058), _dot(dsf, f.wrt) at :333.  At the
// flagship shape (M = 4 * 20 * 130 rows, N = Wp = 130, J = 2 * m2 = 24) it
// is bound by bytes: 6.42 MB forward (1.92 us at 3.35 TB/s), 14.5 MB
// adjoint with a bf16 pre read and dpre written (4.34 us), against 65
// MFLOP.  A block-wide tile in shared memory fed every FMA two shared-memory
// loads, and each block read the factor with one dependent load after
// another before any of its rows.  Here a block owns WD_ROWS = 32 rows of x
// (325 blocks of 256 threads at the flagship shape, 2-3 an SM, one wave) and
// streams them through shared memory in chunks along N of up to WD_KC_MAX
// k16 steps (256 columns; the wrapper picks the chunk so that the layout
// fits, WdftLayout), so any N runs and shared memory grows with J only:
//   1. its threads copy the chunk's columns of those rows (and, for gelu',
//      the rows of pre) and the factor's rows into shared memory by
//      cp.async, the next chunk in flight while this one is computed (two
//      buffers); with one chunk (N up to 256 at J = 24, the flagship) the
//      block's rows are 32 N contiguous floats from a 16-byte boundary,
//      copied 16 bytes at a time, pre with them;
//   2. each thread forms v in place from the values it copied (gelu or
//      gelu', pre read from device memory when there are several chunks)
//      and writes dpre; gelu' (erff, expf, a branching chain) is spread over
//      every thread of the block;
//   3. the operands are rounded to bf16 once a chunk: v into a row-major
//      [32][16 KC + 8] tile (columns past N and rows past M zero; +8:
//      conflict-free ldmatrix), and the factor, already bf16-exact, into the
//      B fragments of every (k16 step, n8 tile) in lane order, rows past N
//      zero;
//   4. each warp takes (m16 row tile, n8 column tile) pairs of the output,
//      6 of them at J = 24: its accumulators come from the block's output
//      tile in shared memory, then per k16 step of the chunk one ldmatrix,
//      one 8-byte load and one mma.sync m16n8k16 bf16 with f32 accumulation
//      (the bf16 products are exact in f32, as the reference's _dot with
//      bf16 inputs), and go back to the tile: the same chain of k16 steps, in
//      the same order, as with the whole row in shared memory;
//   5. the block's rows of out, 32 J contiguous floats, leave by float4
//      stores.
// What bounds it is the work between the copies and the stores, not the
// bytes (PERF.md): the bf16 passes, the MMA chain and gelu'.
//   f32 (bf = 0, `highest`): products stay exact f32 (no TF32), on the CUDA
//   cores, from the f32 copies after step 2: a lane owns 2 rows x 2 columns
//   of a warp's 16 x 8 output tile, so each value loaded from shared memory
//   feeds 2 FMAs; in-order sums over k, carried from chunk to chunk through
//   the output tile.
// No atomics and no block reads what another writes: the same bits from
// launch to launch.
// ---------------------------------------------------------------------------

constexpr int WD_ROWS = 32;    // rows of x a block owns: two m16 tiles
constexpr int WD_WARPS = 8;    // warps a block
constexpr int WD_KC_MAX = 16;  // k16 steps a chunk at most

// four consecutive values from shared memory (8-byte aligned bf16, 16-byte f32)
__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 ld4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162 a = *reinterpret_cast<const __nv_bfloat162*>(&u.x);
  const __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(&u.y);
  return make_float4(__low2float(a), __high2float(a), __low2float(b), __high2float(b));
}

// v of one element: gelu(x) with gelu_in, times gelu'(pre) with gelu_grad.
__device__ __forceinline__ float wdft_v(float x, float pre, bool gelu_grad, int gelu_in) {
  const float v = gelu_in ? gelu_f(x) : x;
  return gelu_grad ? v * gelu_grad_f(pre) : v;
}

// One bf16x2 B-fragment register from fac[k][n], fac[k + 1][n] (row stride
// J); rows at or past N and columns at or past J are 0.
__device__ __forceinline__ uint32_t b_pair(const float* f, int k, int n, int N, int J) {
  const float lo = k < N && n < J ? f[k * J + n] : 0.f;
  const float hi = k + 1 < N && n < J ? f[(k + 1) * J + n] : 0.f;
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// Shared memory of one block for N, J and a chunk of at most kc k16 steps:
// NCH chunks of KC k16 steps (balanced), each buffer the chunk's factor rows
// (f32), its columns of the block's x rows (row stride LDX: N with one chunk,
// whose rows are then contiguous, else 16 KC) and, with one chunk, the rows
// of pre where gelu'(pre) is taken; two buffers with several chunks.  On the
// tensor-core path the bf16 tile of v and the factor's B fragments of one
// chunk; the f32 output tile.  At J = 24 the widest variant takes 209 KB at
// N = 256 (one chunk) and at most 127 KB beyond; fno_kernels.wdft_plan
// mirrors this layout, picks kc and names the widest J where none fits.
struct WdftLayout {
  int KS, NNT, NCH, KC, NC, LDX, LDA;
  size_t fac, xs, ps, buf, at, bf, ot, bytes;
  __host__ __device__ WdftLayout(int N, int J, bool tc, bool stage_pre, size_t pre_size, int kc) {
    KS = (N + 15) / 16;
    NNT = (J + 7) / 8;
    NCH = (KS + kc - 1) / kc;
    KC = (KS + NCH - 1) / NCH;
    NC = 16 * KC;
    LDX = NCH == 1 ? N : NC;
    LDA = NC + 8;  // +8 bf16: conflict-free ldmatrix
    const size_t ts = (size_t)(WD_ROWS * LDX + 7) / 8 * 8;
    fac = ((size_t)(NCH == 1 ? N : NC) * J + 3) / 4 * 16;
    xs = ts * 4;
    ps = stage_pre && NCH == 1 ? (ts * pre_size + 15) / 16 * 16 : 0;
    buf = fac + xs + ps;
    at = tc ? (size_t)WD_ROWS * LDA * 2 : 0;
    bf = tc ? (size_t)KC * NNT * 32 * 8 : 0;
    ot = ((size_t)WD_ROWS * J * 4 + 15) / 16 * 16;
    bytes = (NCH > 1 ? 2 : 1) * buf + at + bf + ot;
  }
};

template <typename S, bool TC>
__global__ void __launch_bounds__(WD_WARPS * 32)
wdft_kernel(const float* __restrict__ x, const float* __restrict__ fac, float* __restrict__ out,
            int M, int N, int J, const S* __restrict__ pre, int gelu_grad,
            float* __restrict__ dpre, int gelu_in, int kc) {
  extern __shared__ __align__(16) unsigned char wd_smem[];
  const bool gg = pre != nullptr && gelu_grad, op = gg || gelu_in;
  const WdftLayout L(N, J, TC, gg, sizeof(S), kc);
  unsigned char* tail = wd_smem + (L.NCH > 1 ? 2 : 1) * L.buf;
  __nv_bfloat16* at = reinterpret_cast<__nv_bfloat16*>(tail);
  uint2* bfr = reinterpret_cast<uint2*>(tail + L.at);
  float* ot = reinterpret_cast<float*>(tail + L.at + L.bf);
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int row0 = blockIdx.x * WD_ROWS, nrows = min(WD_ROWS, M - row0);
  const size_t g0 = (size_t)row0 * N;
  const int lane = tid % 32, warp = tid / 32, g = lane >> 2, t = lane & 3;

  // chunk ch into buffer ch & 1 by cp.async: the factor's rows c0.. (16-byte
  // aligned: c0 is a multiple of 16) and the chunk's columns of the block's
  // rows of x (and pre); ragged tails of pre by plain loads
  auto stage = [=](int ch) {
    unsigned char* base = wd_smem + (ch & 1) * L.buf;
    float* fst = reinterpret_cast<float*>(base);
    float* xs = reinterpret_cast<float*>(base + L.fac);
    S* ps = reinterpret_cast<S*>(base + L.fac + L.xs);
    const int c0 = ch * L.NC, nc = min(L.NC, N - c0), nf = nc * J;
    const float* fsrc = fac + (size_t)c0 * J;
    for (int i = tid; i < nf / 4; i += nthr) cp_async(fst + 4 * i, fsrc + 4 * i);
    for (int i = nf / 4 * 4 + tid; i < nf; i += nthr) cp_async4(fst + i, fsrc + i);
    if (L.NCH == 1) {
      const int cnt = nrows * N, n4 = cnt / 4;
      for (int i = tid; i < n4; i += nthr) {
        cp_async(xs + 4 * i, x + g0 + 4 * i);
        if (gg) cp_async(ps + 4 * i, pre + g0 + 4 * i);
      }
      for (int e = 4 * n4 + tid; e < cnt; e += nthr) {
        cp_async4(xs + e, x + g0 + e);
        if (gg) ps[e] = pre[g0 + e];
      }
    } else {
      for (int e = tid; e < nrows * nc; e += nthr) {
        const int r = e / nc, c = e - r * nc;
        cp_async4(xs + r * L.LDX + c, x + g0 + (size_t)r * N + c0 + c);
      }
    }
    cp_async_commit();
  };

  stage(0);
  for (int ch = 0; ch < L.NCH; ++ch) {
    if (ch + 1 < L.NCH) {
      stage(ch + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    unsigned char* base = wd_smem + (ch & 1) * L.buf;
    const float* fst = reinterpret_cast<const float*>(base);
    float* xs = reinterpret_cast<float*>(base + L.fac);
    const S* ps = reinterpret_cast<const S*>(base + L.fac + L.xs);
    const int c0 = ch * L.NC, nc = min(L.NC, N - c0);
    // v in place of x, and dpre = v: each thread the values it copied
    if (op || pre != nullptr) {
      if (L.NCH == 1) {
        const int cnt = nrows * N, n4 = cnt / 4;
        for (int i = tid; i < n4; i += nthr) {
          float4 v = ld4(xs + 4 * i);
          if (op) {
            const float4 p = gg ? ld4(ps + 4 * i) : make_float4(0.f, 0.f, 0.f, 0.f);
            v = make_float4(wdft_v(v.x, p.x, gg, gelu_in), wdft_v(v.y, p.y, gg, gelu_in),
                            wdft_v(v.z, p.z, gg, gelu_in), wdft_v(v.w, p.w, gg, gelu_in));
            *reinterpret_cast<float4*>(xs + 4 * i) = v;
          }
          if (pre != nullptr) *reinterpret_cast<float4*>(dpre + g0 + 4 * i) = v;
        }
        for (int e = 4 * n4 + tid; e < cnt; e += nthr) {
          const float v = wdft_v(xs[e], gg ? ldv(ps + e) : 0.f, gg, gelu_in);
          xs[e] = v;
          if (pre != nullptr) dpre[g0 + e] = v;
        }
      } else {
        for (int e = tid; e < nrows * nc; e += nthr) {
          const int r = e / nc, c = e - r * nc;
          const size_t gi = g0 + (size_t)r * N + c0 + c;
          const float v = wdft_v(xs[r * L.LDX + c], gg ? ldv(pre + gi) : 0.f, gg, gelu_in);
          xs[r * L.LDX + c] = v;
          if (pre != nullptr) dpre[gi] = v;
        }
      }
    }
    __syncthreads();

    if constexpr (TC) {
      // bf16 operands once a chunk: v as a row-major [WD_ROWS][LDA] tile
      // (columns past N and rows past the block's zero), and the factor as
      // the B fragments of each (k16 step, n8 tile) in lane order (PTX
      // m16n8k16: lane = 4 g + t holds column g, rows 2t, 2t + 1 and 2t + 8,
      // 2t + 9)
      const int kcc = min(L.KC, L.KS - ch * L.KC);  // this chunk's k16 steps
      for (int r = warp; r < WD_ROWS; r += WD_WARPS)
        for (int c = 2 * lane; c < 16 * kcc; c += 64) {
          const float* p = xs + r * L.LDX + c;
          const bool ok = r < nrows;
          const __nv_bfloat162 h = __floats2bfloat162_rn(ok && c < nc ? p[0] : 0.f,
                                                         ok && c + 1 < nc ? p[1] : 0.f);
          *reinterpret_cast<__nv_bfloat162*>(at + r * L.LDA + c) = h;
        }
      for (int i = tid; i < kcc * L.NNT * 32; i += nthr) {
        const int q = i >> 5, bg = (i & 31) >> 2, bt = i & 3;
        const int k = q / L.NNT * 16 + 2 * bt, n = q % L.NNT * 8 + bg;
        bfr[i] = make_uint2(b_pair(fst, k, n, nc, J), b_pair(fst, k + 8, n, nc, J));
      }
      __syncthreads();
      // one (m16 row tile, n8 column tile) of the output a warp at a time: A
      // by ldmatrix, B by one 8-byte load, the chain carried in the output tile
      const int lm_row = ((lane >> 3) & 1) * 8 + (lane & 7), lm_col = (lane >> 4) * 8;
      const int items = (nrows + 15) / 16 * L.NNT;
      for (int item = warp; item < items; item += WD_WARPS) {
        const int mt = item / L.NNT, nt = item - mt * L.NNT;
        const __nv_bfloat16* arow = at + (mt * 16 + lm_row) * L.LDA + lm_col;
        const uint2* bq = bfr + nt * 32 + lane;
        float acc[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int j = nt * 8 + 2 * t + (e & 1);
          acc[e] = ch > 0 && j < J ? ot[(mt * 16 + g + (e >> 1) * 8) * J + j] : 0.f;
        }
        for (int ks = 0; ks < kcc; ++ks) {
          uint32_t a[4];
          asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                       : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
                       : "r"(smem_u32(arow + ks * 16))
                       : "memory");
          const uint2 b = bq[ks * L.NNT * 32];
          asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
              "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
              : "+f"(acc[0]), "+f"(acc[1]), "+f"(acc[2]), "+f"(acc[3])
              : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b.x), "r"(b.y));
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int j = nt * 8 + 2 * t + (e & 1);
          if (j < J) ot[(mt * 16 + g + (e >> 1) * 8) * J + j] = acc[e];
        }
      }
    } else {
      // one 16 x 8 tile of the output a warp at a time, on the CUDA cores: a
      // lane owns rows 2 (lane / 4) + i and columns 2 (lane % 4) + c
      const int items = (nrows + 15) / 16 * L.NNT;
      for (int item = warp; item < items; item += WD_WARPS) {
        const int mt = item / L.NNT, j0 = (item - mt * L.NNT) * 8;
        const float* xt = xs + mt * 16 * L.LDX;
        const int rr = lane / 4 * 2, jj = j0 + lane % 4 * 2;
        const bool ok0 = jj < J, ok1 = jj + 1 < J;
        float acc[2][2];
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int c = 0; c < 2; ++c)
            acc[i][c] = ch > 0 && jj + c < J ? ot[(mt * 16 + rr + i) * J + jj + c] : 0.f;
        for (int k = 0; k < nc; ++k) {
          const float x0 = xt[rr * L.LDX + k], x1 = xt[(rr + 1) * L.LDX + k];
          const float f0 = ok0 ? fst[k * J + jj] : 0.f, f1 = ok1 ? fst[k * J + jj + 1] : 0.f;
          acc[0][0] = fmaf(x0, f0, acc[0][0]);
          acc[0][1] = fmaf(x0, f1, acc[0][1]);
          acc[1][0] = fmaf(x1, f0, acc[1][0]);
          acc[1][1] = fmaf(x1, f1, acc[1][1]);
        }
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int c = 0; c < 2; ++c)
            if (jj + c < J) ot[(mt * 16 + rr + i) * J + jj + c] = acc[i][c];
      }
    }
    __syncthreads();  // the chunk's buffer and tiles are free, its sums in the output tile
  }
  // the block's rows of out are nrows J contiguous floats from a 16-byte
  // boundary: float4 stores
  float* ob = out + (size_t)row0 * J;
  const int no = nrows * J;
  for (int i = tid; i < no / 4; i += nthr)
    *reinterpret_cast<float4*>(ob + 4 * i) = *reinterpret_cast<const float4*>(ot + 4 * i);
  for (int e = no / 4 * 4 + tid; e < no; e += nthr) ob[e] = ot[e];
}

template <typename S, bool TC>
static int launch_wdft(const float* x, const float* fac, float* out, int M, int N, int J,
                       const void* pre, int gelu_grad, float* dpre, int gelu_in, int kc,
                       cudaStream_t st) {
  const size_t smem = WdftLayout(N, J, TC, pre != nullptr && gelu_grad, sizeof(S), kc).bytes;
  cudaError_t e = fno_set_smem(wdft_kernel<S, TC>, smem);
  if (e != cudaSuccess) return (int)e;
  wdft_kernel<S, TC><<<(M + WD_ROWS - 1) / WD_ROWS, WD_WARPS * 32, smem, st>>>(
      x, fac, out, M, N, J, (const S*)pre, gelu_grad, dpre, gelu_in, kc);
  return (int)cudaGetLastError();
}

// Shared memory of one block of each redesigned kernel, as laid out here:
// chip_smoke.py holds fno_kernels' mirrors (wdft_smem_bytes,
// corner_smem_bytes, iwdft_smem_bytes), which its CPU tests use, to these.
FNO_EXPORT long long fno_wdft_smem(int N, int J, int tc, int pre_size, int kc) {
  return (long long)WdftLayout(N, J, tc != 0, pre_size != 0, (size_t)pre_size, kc).bytes;
}

FNO_EXPORT int fno_wdft(const float* x, const float* fac, float* out, int M, int N, int J,
                        const void* pre, int pre_bf16, int gelu_grad, float* dpre, int gelu_in,
                        int bf, int kc, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (pre_bf16)
    return bf ? launch_wdft<__nv_bfloat16, true>(x, fac, out, M, N, J, pre, gelu_grad, dpre,
                                                 gelu_in, kc, st)
              : launch_wdft<__nv_bfloat16, false>(x, fac, out, M, N, J, pre, gelu_grad, dpre,
                                                  gelu_in, kc, st);
  return bf ? launch_wdft<float, true>(x, fac, out, M, N, J, pre, gelu_grad, dpre, gelu_in, kc,
                                       st)
            : launch_wdft<float, false>(x, fac, out, M, N, J, pre, gelu_grad, dpre, gelu_in, kc,
                                        st);
}

// ---------------------------------------------------------------------------
// Corner stage, per (element b, W-mode k):
//   Bs[i, r] = sum_h A[b, i, h, k] P[h, r]              (complex, saved to spec)
//   Cm[j, r] = sum_i Bs[i, r] W[i, j, k, r]             (forward)
//            = sum_i Bs[i, r] conj(W[j, i, k, r])       (adjoint)
//   D[b, j, h, k] = sum_r Cm[j, r] Q[r, h]              (complex)
// A and D hold the real parts at [..., :K] and the imaginary parts at
// [..., K:2K].  spec is (B, Cin, K, R), real and imaginary apart.  With D
// null the kernel stops after the spectrum (the split weight-gradient pass
// needs only the spectra of a layer's input and of its cotangent).
//
// Replaces the H-axis corner DFT, the mode mix and the inverse H of
// _full_fwd_kernel and _full_bwd_kernel (sciml_pde_tpu/ops/fno_fused_step.py
// :302-313, the adjoint at :335-348).  At the flagship shape (B = 4, C = 20,
// Hp = 130, K = 12, R = 24) it moves 3.06 MB (A and D 1.0 MB each, W 0.92
// MB; 0.91 us at 3.35 TB/s) for 51.6 MFLOP.  The first design ran one block
// per (b, k), 48 blocks on 132 SMs, each copying the whole of P and Q with
// plain loads and running the three complex contractions as serial chains
// of scalar FMAs (25x its bound).  Here each (b, k) is a thread-block cluster
// of CN_CLUSTER blocks along H (192 blocks at the flagship), rank q owning
// rows [q Hb, (q + 1) Hb) of H, Hb = ceil(Hp / CN_CLUSTER):
//   0. by cp.async, all in flight at once: the first chunk's A, P and Q
//      rows and the block's slice of W where it fits (later chunks' copies
//      as their turn comes);
//   1. the block's rows of A and P in chunks of HC rows (the wrapper picks
//      HC, CornerLayout): A as the row-major [Cin][2 HC] operand with the
//      real and imaginary parts of a row h side by side, P as the matching
//      [[Pr, Pi], [-Pi, Pr]] rows, so [Br | Bi] is one real product; per
//      (m16, n8) tile its k16 steps (mma.sync bf16 -> f32 under `default`,
//      in-order f32 FMAs with 2 x 2 values a lane under `highest`) add to
//      the block's partial spectrum in shared memory;
//   2. the partial spectra of the cluster's blocks are added in rank order
//      through distributed shared memory: every block forms the same
//      spectrum (no atomics, the same bits from launch to launch), and
//      writes its share of the channels to spec;
//   3. the mode mix in f32 on the CUDA cores (the reference's VPU mix), the
//      output channels j = q, q + CN_CLUSTER, ... in block q, W from the
//      block's staged slice (or from device memory where the slice passes
//      CN_W_SMEM), each value once a cluster and the clusters of one mode
//      side by side; Cm rounded to the dot dtype and written straight into
//      every block's stage-4 operand through distributed shared memory;
//   4. each block computes its own rows of D in chunks of HC: [Dr | Di] =
//      [Cr | Ci] [[Qr, Qi], [-Qi, Qr]], k16 steps as in 1, two n8 tiles
//      (Dr and Di) from one A fragment, and writes them.
// The staging loops give a warp a row and its lanes the row's columns (no
// division per element).  __launch_bounds__(CN_NT, 1): without the minimum
// of one block an SM the compiler held some instances under a register
// target and spilled.
// Shared memory grows with C and R only (HC is at least 8): the wrapper
// names the widest C where even HC = 8 does not fit.
// ---------------------------------------------------------------------------

constexpr int CN_CLUSTER = 4;               // blocks of a (element, W-mode) cluster
constexpr int CN_NT = 256;                  // threads a block
constexpr size_t CN_W_SMEM = 64 * 1024;     // largest slice of W staged in shared memory

// Shared memory of one corner_kernel block, in bytes from the start; the
// element E is bf16 on the tensor-core path, f32 on the CUDA cores, and rows
// of E are padded by 16 bytes of bf16 or 4 floats.  part: the partial
// spectrum (f32 [Mi][KR + 4]); bsum: the spectrum (f32 [Cin][2R]); ca: Cm
// as the stage-4 operand ([Mo][KR], written by every block of the cluster);
// the chunk's copies as they arrive (f32): A ([Cin][2 HC]), P
// ([2][HC][R]), Q ([2][R][HC]); the block's slice of W (f32 [2][Cin][nj][R],
// nj = ceil(Cout / CN_CLUSTER) output channels) where it takes at most
// CN_W_SMEM; then a chunk's operands: A ([Mi][2 HC]) and P ([2 HC][KR]) in
// stage 1, Q ([KR][2 HC]: per n8 tile of rows, 8 columns of [Qr; -Qi] then 8
// of [Qi; Qr]) in stage 4.  fno_kernels.corner_plan mirrors it.
struct CornerLayout {
  int Mi, Mo, KR, lda, ldn, ldk, ldq, ldp, nj;
  size_t part, bsum, ca, araw, praw, qraw, wsm, wsm_bytes, chunk, pb, bytes;
  __host__ __device__ CornerLayout(int Cin, int Cout, int R, int HC, bool tc) {
    const int es = tc ? 2 : 4, pad = tc ? 8 : 4;
    Mi = fno_round_up(Cin, 16);
    Mo = fno_round_up(Cout, 16);
    KR = fno_round_up(2 * R, 16);
    lda = 2 * HC + pad;
    ldn = KR + pad;
    ldk = KR + pad;
    ldq = 2 * HC + pad;
    ldp = KR + 4;
    nj = (Cout + CN_CLUSTER - 1) / CN_CLUSTER;
    part = 0;
    bsum = part + fno_align16((size_t)Mi * ldp * 4);
    ca = bsum + fno_align16((size_t)Cin * 2 * R * 4);
    araw = ca + fno_align16((size_t)Mo * ldk * es);
    praw = araw + fno_align16((size_t)Cin * 2 * HC * 4);
    qraw = praw + fno_align16((size_t)2 * HC * R * 4);
    wsm = qraw + fno_align16((size_t)2 * R * HC * 4);
    wsm_bytes = (size_t)2 * Cin * nj * R * 4;
    if (wsm_bytes > CN_W_SMEM) wsm_bytes = 0;
    chunk = wsm + fno_align16(wsm_bytes);
    pb = chunk + fno_align16((size_t)Mi * lda * es);
    const size_t s1 = pb + fno_align16((size_t)2 * HC * ldn * es);
    const size_t s3 = chunk + fno_align16((size_t)KR * ldq * es);
    bytes = s1 > s3 ? s1 : s3;
  }
};

// corner_kernel's copies of a chunk of the block's rows hb.. (hc of them) by
// cp.async, 4 bytes each, a row a warp: A (2 values a channel and row) and
// the rows of P for stage 1; the rows' columns of Q for stage 4
__device__ __forceinline__ void corner_fetch1(float* araw, float* praw, const float* Ab,
                                              const float* pr, const float* pi, int Cin,
                                              int Hp, int K, int R, int HC, int hb, int hc) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int c = warp; c < Cin; c += CN_NT / 32)
    for (int kk = lane; kk < 2 * hc; kk += 32)
      cp_async4(araw + c * 2 * HC + kk,
                Ab + ((size_t)c * Hp + hb + (kk >> 1)) * 2 * K + (kk & 1) * K);
  for (int i = threadIdx.x; i < hc * R; i += CN_NT) {
    cp_async4(praw + i, pr + hb * R + i);
    cp_async4(praw + HC * R + i, pi + hb * R + i);
  }
}
__device__ __forceinline__ void corner_fetch3(float* qraw, const float* qr, const float* qi,
                                              int Hp, int R, int HC, int hb, int hc) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int r = warp; r < R; r += CN_NT / 32)
    for (int hl = lane; hl < hc; hl += 32) {
      cp_async4(qraw + r * HC + hl, qr + r * Hp + hb + hl);
      cp_async4(qraw + (R + r) * HC + hl, qi + r * Hp + hb + hl);
    }
}

template <typename S, bool ADJ, bool TC>
__global__ void __cluster_dims__(CN_CLUSTER, 1, 1) __launch_bounds__(CN_NT, 1)
corner_kernel(const float* __restrict__ A, const float* __restrict__ pr,
              const float* __restrict__ pi, const float* __restrict__ wr,
              const float* __restrict__ wi, const float* __restrict__ qr,
              const float* __restrict__ qi, S* __restrict__ spr, S* __restrict__ spi,
              float* __restrict__ D, int Cin, int Cout, int Hp, int K, int R, int HC) {
  using E = typename HeadElem<TC>::T;
  extern __shared__ __align__(16) unsigned char cn_smem[];
  namespace cgrp = cooperative_groups;
  cgrp::cluster_group cluster = cgrp::this_cluster();
  const int q = (int)cluster.block_rank();
  const CornerLayout L(Cin, Cout, R, HC, TC);
  float* part = reinterpret_cast<float*>(cn_smem + L.part);
  float* bsum = reinterpret_cast<float*>(cn_smem + L.bsum);
  E* ca = reinterpret_cast<E*>(cn_smem + L.ca);
  float* araw = reinterpret_cast<float*>(cn_smem + L.araw);
  float* praw = reinterpret_cast<float*>(cn_smem + L.praw);
  float* qraw = reinterpret_cast<float*>(cn_smem + L.qraw);
  float* wsm = L.wsm_bytes ? reinterpret_cast<float*>(cn_smem + L.wsm) : nullptr;
  E* as = reinterpret_cast<E*>(cn_smem + L.chunk);
  E* pb = reinterpret_cast<E*>(cn_smem + L.pb);
  E* qb = reinterpret_cast<E*>(cn_smem + L.chunk);
  // the clusters of one mode k are neighbours, so W[:, :, k] is read from L2
  const int Bn = gridDim.x / (CN_CLUSTER * K), pair = blockIdx.x / CN_CLUSTER;
  const int k = pair / Bn, b = pair - k * Bn;
  const int K2 = 2 * K, R2 = 2 * R;
  const int Hb = (Hp + CN_CLUSTER - 1) / CN_CLUSTER, h0 = q * Hb;
  const int hn = max(0, min(Hb, Hp - h0));
  const int nj = (Cout - q + CN_CLUSTER - 1) / CN_CLUSTER;  // output channels q, q + CL, ...
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, g = lane >> 2, t = lane & 3;
  constexpr int NW = CN_NT / 32;
  const float* Ab = A + (size_t)b * Cin * Hp * K2 + k;

  // in flight at once: the first chunk of both stages and this block's slice of W
  if (hn > 0) {
    corner_fetch1(araw, praw, Ab, pr, pi, Cin, Hp, K, R, HC, h0, min(HC, hn));
    if (D != nullptr) corner_fetch3(qraw, qr, qi, Hp, R, HC, h0, min(HC, hn));
  }
  if (wsm != nullptr && D != nullptr)
    for (int ij = warp; ij < Cin * nj; ij += NW) {
      const int ii = ij / nj, j = q + (ij - ii * nj) * CN_CLUSTER;
      const size_t wo = ADJ ? (((size_t)j * Cin + ii) * K + k) * R
                            : (((size_t)ii * Cout + j) * K + k) * R;
      for (int r = lane; r < R; r += 32) {
        cp_async4(wsm + ij * R + r, wr + wo + r);
        cp_async4(wsm + (Cin * nj + ij) * R + r, wi + wo + r);
      }
    }
  cp_async_commit();
  // zeros over Cm's padding in this block's stage-4 operand (the cluster's
  // blocks write the rest after the first cluster barrier)
  for (int m = warp; m < L.Mo; m += NW)
    for (int kk = lane; kk < L.KR; kk += 32)
      if (m >= Cout || kk >= R2) ca[m * L.ldk + kk] = to_elem<E>(0.f);

  // 1. the block's partial spectrum [Br | Bi] over its rows of H
  for (int i = tid; i < L.Mi * L.ldp; i += CN_NT) part[i] = 0.f;
  for (int c0 = 0; c0 < hn; c0 += HC) {
    const int hc = min(HC, hn - c0);
    if (c0 > 0) {
      corner_fetch1(araw, praw, Ab, pr, pi, Cin, Hp, K, R, HC, h0 + c0, hc);
      cp_async_commit();
    }
    cp_async_wait<0>();
    __syncthreads();
    // as[m][2 hl + s] = A[b, m, h, s K + k] (rounded to E); pb[2 hl + s][n]:
    // s = 0 [Pr | Pi], s = 1 [-Pi | Pr]; zeros past Cin, 2R and hc
    for (int m = warp; m < L.Mi; m += NW)
      for (int kk = 2 * lane; kk < 2 * HC; kk += 64) {
        const bool ok = m < Cin && kk < 2 * hc;
        st_pair(as + m * L.lda + kk, ok ? araw[m * 2 * HC + kk] : 0.f,
                ok ? araw[m * 2 * HC + kk + 1] : 0.f);
      }
    for (int kk = warp; kk < 2 * HC; kk += NW) {
      const int hl = kk >> 1;
      const float* gr = praw + hl * R;
      const float* gi = praw + (HC + hl) * R;
      for (int n = 2 * lane; n < L.KR; n += 64) {
        float v[2];
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int nn = n + u, rr = nn < R ? nn : nn - R;
          v[u] = hl >= hc || nn >= R2 ? 0.f
                 : (kk & 1) == 0      ? (nn < R ? gr[rr] : gi[rr])
                                      : (nn < R ? -gi[rr] : gr[rr]);
        }
        st_pair(pb + kk * L.ldn + n, v[0], v[1]);
      }
    }
    __syncthreads();
    const int nt16 = L.KR / 16, items = L.Mi / 16 * nt16;
    for (int it = warp; it < items; it += NW) {
      const int mt = it / nt16, nt = it - mt * nt16;
      float* pp = part + (mt * 16 + g) * L.ldp + nt * 16 + 2 * t;
      float acc[1][2][4];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        acc[0][u][0] = pp[8 * u];
        acc[0][u][1] = pp[8 * u + 1];
        acc[0][u][2] = pp[8 * L.ldp + 8 * u];
        acc[0][u][3] = pp[8 * L.ldp + 8 * u + 1];
      }
      tiles_prod<1, 2, true, false>(acc, as + mt * 16 * L.lda, L.lda, pb + nt * 16, L.ldn,
                                    2 * HC);
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        pp[8 * u] = acc[0][u][0];
        pp[8 * u + 1] = acc[0][u][1];
        pp[8 * L.ldp + 8 * u] = acc[0][u][2];
        pp[8 * L.ldp + 8 * u + 1] = acc[0][u][3];
      }
    }
    __syncthreads();
  }
  cp_async_wait<0>();  // W (and Q) where this block holds no rows
  cluster.sync();

  // 2. the spectrum: the blocks' partials added in rank order; block q writes
  // the channels c = q, q + CN_CLUSTER, ...
  for (int c = warp; c < Cin; c += NW)
    for (int n = lane; n < R2; n += 32) {
      float s = 0.f;
#pragma unroll
      for (int rk = 0; rk < CN_CLUSTER; ++rk)
        s += cluster.map_shared_rank(part, rk)[c * L.ldp + n];
      bsum[c * R2 + n] = s;
      if (c % CN_CLUSTER == q) {
        const size_t so = (((size_t)b * Cin + c) * K + k) * R + (n < R ? n : n - R);
        stv((n < R ? spr : spi) + so, s);
      }
    }
  if (D == nullptr) {  // uniform across the cluster
    cluster.sync();    // no block leaves while another reads its partial
    return;
  }
  __syncthreads();

  // 3. the mode mix in f32 for this block's output channels, W from its
  // staged slice or from device memory
  for (int o = tid; o < nj * R; o += CN_NT) {
    const int jj = o / R, r = o - jj * R, j = q + jj * CN_CLUSTER;
    float cr = 0.f, ci = 0.f;
#pragma unroll 4
    for (int i = 0; i < Cin; ++i) {
      float w_r, w_i;
      if (wsm != nullptr) {
        w_r = wsm[(i * nj + jj) * R + r];
        w_i = wsm[((Cin + i) * nj + jj) * R + r];
      } else {
        const size_t wo = ADJ ? (((size_t)j * Cin + i) * K + k) * R + r
                              : (((size_t)i * Cout + j) * K + k) * R + r;
        w_r = wr[wo];
        w_i = wi[wo];
      }
      if (ADJ) w_i = -w_i;
      const float br = bsum[i * R2 + r], bi = bsum[i * R2 + R + r];
      cr += br * w_r - bi * w_i;
      ci += br * w_i + bi * w_r;
    }
    // rounded to the dot dtype, into row j of every block's stage-4 operand
    const E er = to_elem<E>(cr), ei = to_elem<E>(ci);
#pragma unroll
    for (int rk = 0; rk < CN_CLUSTER; ++rk) {
      E* dst = cluster.map_shared_rank(ca, rk) + j * L.ldk;
      dst[r] = er;
      dst[R + r] = ei;
    }
  }
  cluster.sync();

  // 4. this block's rows of D
  for (int c0 = 0; c0 < hn; c0 += HC) {
    const int hc = min(HC, hn - c0), hb = h0 + c0;
    if (c0 > 0) {
      __syncthreads();  // the last chunk's operands are free
      corner_fetch3(qraw, qr, qi, Hp, R, HC, hb, hc);
      cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();
    }
    // row hb + hl: column 16 (hl / 8) + hl % 8 of qb holds [Qr; -Qi] and 8
    // columns on [Qi; Qr], so one product gives a tile of Dr and of Di
    for (int kk = warp; kk < L.KR; kk += NW) {
      const float* a = qraw + (kk < R ? kk : kk - R) * HC;
      const float* c = a + R * HC;
      for (int hl = lane; hl < HC; hl += 32) {
        const bool ok = hl < hc && kk < R2;
        const float vr = !ok ? 0.f : kk < R ? a[hl] : -c[hl];
        const float vi = !ok ? 0.f : kk < R ? c[hl] : a[hl];
        E* dst = qb + kk * L.ldq + (hl >> 3) * 16 + (hl & 7);
        dst[0] = to_elem<E>(vr);
        dst[8] = to_elem<E>(vi);
      }
    }
    __syncthreads();
    const int nt8 = HC / 8, items = L.Mo / 16 * nt8;
    for (int it = warp; it < items; it += NW) {
      const int mt = it / nt8, nt = it - mt * nt8;
      float acc[1][2][4] = {};
      tiles_prod<1, 2, true, false>(acc, ca + mt * 16 * L.ldk, L.ldk, qb + nt * 16, L.ldq,
                                    L.KR);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = mt * 16 + g + 8 * (e >> 1), hl = nt * 8 + 2 * t + (e & 1);
        if (j < Cout && hl < hc) {
          const size_t o = (((size_t)b * Cout + j) * Hp + hb + hl) * K2 + k;
          D[o] = acc[0][0][e];
          D[o + K] = acc[0][1][e];
        }
      }
    }
  }
}

template <typename S, bool ADJ, bool TC>
static int launch_corner(const float* A, const float* pr, const float* pi, const float* wr,
                         const float* wi, const float* qr, const float* qi, void* spr,
                         void* spi, float* D, int B, int Cin, int Cout, int Hp, int K, int R,
                         int HC, cudaStream_t st) {
  const size_t smem = CornerLayout(Cin, Cout, R, HC, TC).bytes;
  cudaError_t e = fno_set_smem(corner_kernel<S, ADJ, TC>, smem);
  if (e != cudaSuccess) return (int)e;
  corner_kernel<S, ADJ, TC><<<B * K * CN_CLUSTER, CN_NT, smem, st>>>(
      A, pr, pi, wr, wi, qr, qi, (S*)spr, (S*)spi, D, Cin, Cout, Hp, K, R, HC);
  return (int)cudaGetLastError();
}

template <bool TC>
static int dispatch_corner(const float* A, const float* pr, const float* pi, const float* wr,
                           const float* wi, const float* qr, const float* qi, void* spr,
                           void* spi, float* D, int B, int Cin, int Cout, int Hp, int K, int R,
                           int adj, int spec_bf16, int HC, cudaStream_t st) {
  if (adj)
    return launch_corner<float, true, TC>(A, pr, pi, wr, wi, qr, qi, spr, spi, D, B, Cin, Cout,
                                          Hp, K, R, HC, st);
  if (spec_bf16)
    return launch_corner<__nv_bfloat16, false, TC>(A, pr, pi, wr, wi, qr, qi, spr, spi, D, B,
                                                   Cin, Cout, Hp, K, R, HC, st);
  return launch_corner<float, false, TC>(A, pr, pi, wr, wi, qr, qi, spr, spi, D, B, Cin, Cout,
                                         Hp, K, R, HC, st);
}

FNO_EXPORT long long fno_corner_smem(int Cin, int Cout, int R, int HC, int tc) {
  return (long long)CornerLayout(Cin, Cout, R, HC, tc != 0).bytes;
}

FNO_EXPORT int fno_corner(const float* A, const float* pr, const float* pi, const float* wr,
                          const float* wi, const float* qr, const float* qi, void* spr,
                          void* spi, float* D, int B, int Cin, int Cout, int Hp, int K,
                          int R, int adj, int spec_bf16, int bf, int hc, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  return bf ? dispatch_corner<true>(A, pr, pi, wr, wi, qr, qi, spr, spi, D, B, Cin, Cout, Hp, K,
                                    R, adj, spec_bf16, hc, st)
            : dispatch_corner<false>(A, pr, pi, wr, wi, qr, qi, spr, spi, D, B, Cin, Cout, Hp,
                                     K, R, adj, spec_bf16, hc, st);
}

// ---------------------------------------------------------------------------
// Inverse W + 1x1 conv epilogue, per image row (b, h):
//   v[j, w] = sum_q D[b, j, h, q] Z[q, w] + sum_c M[j, c] xin[b, c, h, w] (+ bias[j])
// Forward: Z = [wr; -wi], M = pw^T, bias, pre saved, out = gelu(v) or v.
// Adjoint: Z = [fr^T; fi^T], M = pw, xin = dpre, out = v = dh of the layer input.
//
// Replaces the inverse W-axis products and the 1x1 conv of _full_fwd_kernel
// and _full_bwd_kernel (sciml_pde_tpu/ops/fno_fused_step.py:314-316 and
// :359-360, the adjoint at :349-351 and :373).  At the flagship shape (B = 4, C = 20, Hp = Wp =
// 130, K = 12) it moves about 14.5 MB with a bf16 pre (4.34 us at 3.35
// TB/s) for 59 MFLOP, plus an erff per value for gelu.  The first design ran
// a block per row (520) that recopied Z (12.5 KB, 6.5 MB of L2 reads a
// launch) and fed each of a row's 2,600 sums 44 pairs of shared loads.  Here
// v of a row is one product, [D_row | M] (Cout x (2K + Cin)) times [Z ;
// xin_row] ((2K + Cin) x Wp), K padded to 16 (44 -> 48):
//   - a block owns RB consecutive rows (b, h) and one chunk of WC columns of
//     W (the wrapper picks WC, IwdftLayout, and RB so that about IW_GRID
//     blocks run: 260 of 2 rows at the flagship); M, the chunk's columns of
//     Z (copied by cp.async with the first row) and the bias are laid out
//     once a block;
//   - each row's D (Cout x 2K) and xin (Cin x WC) come in by cp.async while
//     the row before is computed (two buffers), then go into the operands
//     (bf16, rounded once, under `default`; f32 under `highest`);
//   - each warp takes (m16 channel tile, 16 columns) pairs: k16 steps of
//     mma.sync bf16 -> f32 (or in-order f32 FMAs with 2 x 2 values a lane),
//     then the epilogue adds the bias, stores pre (bf16 or f32) and out
//     (gelu by erff) along w, two neighbouring values a store where Wp is
//     even (scattered 2-byte stores of a bf16 pre cost about a third of
//     the kernel's time).
// Shared memory grows with C and WC only (WC is at least 16): the wrapper
// names the widest C where even WC = 16 does not fit.  __launch_bounds__
// (.., 1) as for corner_kernel: without it the tensor-core instances spilled.
// ---------------------------------------------------------------------------

constexpr int IW_WARPS = 8;   // warps a block
constexpr int IW_GRID = 264;  // blocks aimed at (rows a block = ceil(rows x chunks / IW_GRID))

// Shared memory of one iwdft_pw_kernel block, in bytes from the start: the
// A operand [Mo][KP] ([D_row | M], rows padded by 16 bytes of bf16 or 4
// floats), the B operand [KP][WC] ([Z ; xin_row]), two row buffers (f32 D
// row then xin row), Z's chunk as copied (f32 [2K][WC]) and the bias;
// KP = 16 ceil((2K + Cin) / 16).  fno_kernels.iwdft_plan mirrors it.
struct IwdftLayout {
  int Mo, KP, ldk, ldw, raw_n;
  size_t a, b, raw, zraw, bias, bytes;
  __host__ __device__ IwdftLayout(int Cin, int Cout, int K, int WC, bool tc) {
    const int es = tc ? 2 : 4, pad = tc ? 8 : 4;
    Mo = fno_round_up(Cout, 16);
    KP = fno_round_up(2 * K + Cin, 16);
    ldk = KP + pad;
    ldw = WC + pad;
    raw_n = (int)(fno_align16((size_t)(Cout * 2 * K + Cin * WC) * 4) / 4);
    a = 0;
    b = a + fno_align16((size_t)Mo * ldk * es);
    raw = b + fno_align16((size_t)KP * ldw * es);
    zraw = raw + (size_t)2 * raw_n * 4;
    bias = zraw + fno_align16((size_t)2 * K * WC * 4);
    bytes = bias + fno_align16((size_t)Mo * 4);
  }
};

// iwdft_pw_kernel's copies of one row (b, h): its D (Cout x 2K) and its xin
// at the chunk's columns (Cin x wn, row stride WC) into row buffer rw, by
// cp.async, 4 bytes each (rows need not be aligned), a row a warp
__device__ __forceinline__ void iwdft_fetch(float* rw, const float* D, const float* xin,
                                            int Cin, int Cout, int Hp, int Wp, int K, int WC,
                                            int w0, int wn, int row) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, K2 = 2 * K;
  const int bb = row / Hp, h = row - bb * Hp;
  const float* drow = D + ((size_t)bb * Cout * Hp + h) * K2;
  for (int j = warp; j < Cout; j += IW_WARPS)
    for (int qq = lane; qq < K2; qq += 32)
      cp_async4(rw + j * K2 + qq, drow + (size_t)j * Hp * K2 + qq);
  const float* xrow = xin + ((size_t)bb * Cin * Hp + h) * Wp + w0;
  for (int c = warp; c < Cin; c += IW_WARPS)
    for (int w = lane; w < wn; w += 32)
      cp_async4(rw + Cout * K2 + c * WC + w, xrow + (size_t)c * Hp * Wp + w);
}

template <typename S, bool TC>
__global__ void __launch_bounds__(IW_WARPS * 32, 1)
iwdft_pw_kernel(const float* __restrict__ D, const float* __restrict__ Z,
                const float* __restrict__ xin, const float* __restrict__ Mw,
                const float* __restrict__ bias, float* __restrict__ out, S* __restrict__ pre,
                int gelu, int Cin, int Cout, int Hp, int Wp, int K, int nrow, int WC, int RB) {
  using E = typename HeadElem<TC>::T;
  extern __shared__ __align__(16) unsigned char iw_smem[];
  const IwdftLayout L(Cin, Cout, K, WC, TC);
  E* as = reinterpret_cast<E*>(iw_smem + L.a);
  E* bs = reinterpret_cast<E*>(iw_smem + L.b);
  float* raw = reinterpret_cast<float*>(iw_smem + L.raw);
  float* zraw = reinterpret_cast<float*>(iw_smem + L.zraw);
  float* bss = reinterpret_cast<float*>(iw_smem + L.bias);
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, g = lane >> 2, t = lane & 3;
  const int nwc = (Wp + WC - 1) / WC, wc = blockIdx.x % nwc, w0 = wc * WC;
  const int wn = min(WC, Wp - w0);
  const int r0 = blockIdx.x / nwc * RB, r1 = min(r0 + RB, nrow);
  const int K2 = 2 * K, KD = K2 + Cin;

  // in flight at once by cp.async: Z's chunk, the bias and the first row;
  // meanwhile M into A's columns [2K, 2K + Cin) by plain loads, and zeros
  // in the padding
  for (int qq = warp; qq < K2; qq += IW_WARPS)
    for (int w = lane; w < wn; w += 32)
      cp_async4(zraw + qq * WC + w, Z + (size_t)qq * Wp + w0 + w);
  for (int i = tid; i < L.Mo; i += nthr) {
    if (bias != nullptr && i < Cout)
      cp_async4(bss + i, bias + i);
    else
      bss[i] = 0.f;
  }
  if (r0 < r1) iwdft_fetch(raw, D, xin, Cin, Cout, Hp, Wp, K, WC, w0, wn, r0);
  cp_async_commit();
  for (int m = warp; m < L.Mo; m += IW_WARPS)
    for (int kk = K2 + lane; kk < L.KP; kk += 32)
      as[m * L.ldk + kk] = to_elem<E>(m < Cout && kk < KD ? Mw[m * Cin + kk - K2] : 0.f);
  for (int kk = KD + warp; kk < L.KP; kk += IW_WARPS)
    for (int w = lane; w < WC; w += 32) bs[kk * L.ldw + w] = to_elem<E>(0.f);

  for (int row = r0; row < r1; ++row) {
    const int buf = (row - r0) & 1;
    if (row + 1 < r1) {
      iwdft_fetch(raw + (buf ^ 1) * L.raw_n, D, xin, Cin, Cout, Hp, Wp, K, WC, w0, wn,
                  row + 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // the row's copies in, the last row's operands free
    // into the operands, a row a warp, two columns a lane: Z's chunk (the
    // first row), the row's D and xin; zeros past wn and Cout
    const float* rw = raw + buf * L.raw_n;
    const float* xr = rw + Cout * K2;
    for (int kk = (row == r0 ? 0 : K2) + warp; kk < KD; kk += IW_WARPS) {
      const float* src = kk < K2 ? zraw + kk * WC : xr + (kk - K2) * WC;
      for (int w = 2 * lane; w < WC; w += 64)
        st_pair(bs + kk * L.ldw + w, w < wn ? src[w] : 0.f, w + 1 < wn ? src[w + 1] : 0.f);
    }
    for (int m = warp; m < L.Mo; m += IW_WARPS)
      for (int qq = lane; qq < K2; qq += 32)
        as[m * L.ldk + qq] = to_elem<E>(m < Cout ? rw[m * K2 + qq] : 0.f);
    __syncthreads();
    const int bb = row / Hp, h = row - bb * Hp;
    const int nt16 = WC / 16, items = L.Mo / 16 * nt16;
    for (int it = warp; it < items; it += IW_WARPS) {
      const int mt = it / nt16, nt = it - mt * nt16;
      float acc[1][2][4] = {};
      tiles_prod<1, 2, true, false>(acc, as + mt * 16 * L.ldk, L.ldk, bs + nt * 16, L.ldw,
                                    L.KP);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int j = mt * 16 + g + 8 * r;
        if (j >= Cout) continue;
        const float bj = bss[j];
        const size_t o = (((size_t)bb * Cout + j) * Hp + h) * Wp + w0;
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int w = nt * 16 + u * 8 + 2 * t;  // and w + 1
          const float v0 = acc[0][u][2 * r] + bj, v1 = acc[0][u][2 * r + 1] + bj;
          if (w + 1 < wn && (Wp & 1) == 0) {  // an aligned pair
            if (pre != nullptr) st_pair(pre + o + w, v0, v1);
            st_pair(out + o + w, gelu ? gelu_f(v0) : v0, gelu ? gelu_f(v1) : v1);
          } else {
            for (int c = 0; c < 2 && w + c < wn; ++c) {
              const float v = c ? v1 : v0;
              if (pre != nullptr) stv(pre + o + w + c, v);
              out[o + w + c] = gelu ? gelu_f(v) : v;
            }
          }
        }
      }
    }
    __syncthreads();  // the operands and the row buffer are free
  }
}

template <typename S>
static int launch_iwdft(const float* D, const float* Z, const float* xin, const float* Mw,
                        const float* bias, float* out, void* pre, int gelu, int B, int Cin,
                        int Cout, int Hp, int Wp, int K, int bf, int WC, int RB,
                        cudaStream_t st) {
  const size_t smem = IwdftLayout(Cin, Cout, K, WC, bf != 0).bytes;
  const int nrow = B * Hp, grid = (Wp + WC - 1) / WC * ((nrow + RB - 1) / RB);
  cudaError_t e;
  if (bf) {
    e = fno_set_smem(iwdft_pw_kernel<S, true>, smem);
    if (e != cudaSuccess) return (int)e;
    iwdft_pw_kernel<S, true><<<grid, IW_WARPS * 32, smem, st>>>(
        D, Z, xin, Mw, bias, out, (S*)pre, gelu, Cin, Cout, Hp, Wp, K, nrow, WC, RB);
  } else {
    e = fno_set_smem(iwdft_pw_kernel<S, false>, smem);
    if (e != cudaSuccess) return (int)e;
    iwdft_pw_kernel<S, false><<<grid, IW_WARPS * 32, smem, st>>>(
        D, Z, xin, Mw, bias, out, (S*)pre, gelu, Cin, Cout, Hp, Wp, K, nrow, WC, RB);
  }
  return (int)cudaGetLastError();
}

FNO_EXPORT long long fno_iwdft_smem(int Cin, int Cout, int K, int WC, int tc) {
  return (long long)IwdftLayout(Cin, Cout, K, WC, tc != 0).bytes;
}

FNO_EXPORT int fno_iwdft_pw(const float* D, const float* Z, const float* xin,
                            const float* Mw, const float* bias, float* out, void* pre,
                            int pre_bf16, int gelu, int B, int Cin, int Cout, int Hp, int Wp,
                            int K, int bf, int wc, int rb, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (pre_bf16)
    return launch_iwdft<__nv_bfloat16>(D, Z, xin, Mw, bias, out, pre, gelu, B, Cin, Cout, Hp,
                                       Wp, K, bf, wc, rb, st);
  return launch_iwdft<float>(D, Z, xin, Mw, bias, out, pre, gelu, B, Cin, Cout, Hp, Wp, K, bf,
                             wc, rb, st);
}

// ---------------------------------------------------------------------------
// Head: pred (B, Co, X, Y) = (fc2(gelu(fc1(h))) + b2) * std + mean, per pixel.
//
// Replaces the TPU kernel _head_fwd_kernel (B1b,
// sciml_pde_tpu/ops/fno_fused_step.py:542) and the head stage of
// _full_fwd_kernel (B1, :942): t1 = gelu(_dot(w1t, bb) + b1), outn =
// _dot(w2t, t1) + b2, pred = outn * std + mean, the dot inputs rounded to
// bf16 under `default`.  At the flagship shape (65,536 pixels, C = 20,
// NH = 128, Co = 2) it moves 5.77 MB (hf's logical region read once, pred
// written; 1.72 us at 3.35 TB/s) for 0.37 GFLOP (5.5 us on the f32 CUDA
// cores, 0.4 us on the bf16 tensor cores), and evaluates 8.4 M erff for
// gelu.  One thread per pixel with the weights in shared memory fed each
// FMA a shared-memory load and kept bb and acc in runtime-indexed arrays
// (local memory, and a cap C <= 32, Co <= 8).  Here a block owns HF_PIX
// consecutive pixels, a warp two m16 tiles of 16 pixels (each fragment of
// W1 and W2 feeds both, and twice the gelu work is in flight):
//   1. the block copies its pixels of hf channels-first (coalesced along y),
//      W1 (NH, C), W2 (Co, NH) and b1 into shared memory by cp.async, all in
//      flight at once (a batch of loads after another paid the round trip
//      to device memory several times), then lays them out zero-padded to
//      NHp = 16 ceil(NH / 16), Cp = 16 ceil(C / 16) and Co8 = 8 ceil(Co /
//      8) in the element type: bf16 (rounded once) on the tensor-core path,
//      f32 on the CUDA cores;
//   2. per hidden chunk of 16, fc1 is 2 x 2 16 x 8 tiles [32 px x Cp] @
//      W1^T, A fragments from S by ldmatrix.trans, B from W1's rows by
//      ldmatrix; then + b1 and exact gelu on the accumulators;
//   3. under `default` the rounded gelu values are the A fragments of fc2
//      [16 px x 16 h] @ W2^T as they stand (the accumulator layout of the
//      two n8 tiles is the A layout of one k16 step, as the bf16 attention
//      forward uses for p), up to HF_OT output-channel tiles (32 channels)
//      a pass, more passes for wider Co; under `highest` the chunk goes
//      through a 32 x 16 f32 scratch a warp and FMAs;
//   4. the epilogue adds b2, times std, plus mean.
// What bounds it is not the bytes nor the products but gelu's erff on the
// CUDA cores (its two branches diverge across a warp on trained weights),
// then every block's copy of the same weights from L2.  No register array
// is indexed by a runtime bound; C and Co are bounded by shared memory
// only (HeadFwdLayout; fno_kernels.head_fwd names the widest C).
// ---------------------------------------------------------------------------

constexpr int HF_PIX = 256;            // pixels a block
constexpr int HF_WARPS = HF_PIX / 32;  // two m16 tiles a warp
constexpr int HF_OT = 4;               // output-channel n8 tiles a pass
constexpr int HF_TLD = 20;             // row stride of the f32 path's per-warp scratch

// Shared memory of one head_fwd_kernel block, in bytes from the start
// (fno_head_fwd_smem exports its size).
struct HeadFwdLayout {
  int Cp, NHp, Co8, ldw1, ldw2, lds;
  size_t w1, w2, b1, s, raw, wraw, ts, bytes;
  __host__ __device__ HeadFwdLayout(int C, int NH, int Co, bool tc) {
    const int es = tc ? 2 : 4, pad = tc ? 8 : 4;
    Cp = fno_round_up(C, 16);
    NHp = fno_round_up(NH, 16);
    Co8 = fno_round_up(Co, 8);
    ldw1 = Cp + pad;
    ldw2 = NHp + pad;
    lds = HF_PIX + pad;
    w1 = 0;
    w2 = w1 + fno_align16((size_t)NHp * ldw1 * es);
    b1 = w2 + fno_align16((size_t)Co8 * ldw2 * es);
    s = b1 + fno_align16((size_t)NHp * 4);
    // W1 and W2 as given (f32); hf's pixels as copied, f32 [C][HF_PIX].  On
    // the bf16 path the weights take S's place until laid out; on the f32
    // path the pixels are copied straight into S and the weights apart.
    const size_t s_bytes = fno_align16((size_t)Cp * lds * es);
    const size_t w_bytes = fno_align16((size_t)(NH * C + Co * NH) * 4);
    if (tc) {
      wraw = s;
      raw = s + (s_bytes > w_bytes ? s_bytes : w_bytes);
      ts = raw + fno_align16((size_t)C * HF_PIX * 4);
    } else {
      raw = s;
      wraw = s + s_bytes;
      ts = wraw + w_bytes;
    }
    bytes = ts + (tc ? 0 : (size_t)HF_WARPS * 32 * HF_TLD * 4);
  }
};

template <bool TC>
__global__ void __launch_bounds__(HF_WARPS * 32)
head_fwd_kernel(const float* __restrict__ hf, const float* __restrict__ w1t,
                const float* __restrict__ b1, const float* __restrict__ w2t,
                const float* __restrict__ b2, const float* __restrict__ mean,
                const float* __restrict__ stdv, float* __restrict__ pred, int B, int C, int X,
                int Y, int Hp, int Wp, int NH, int Co) {
  using E = typename HeadElem<TC>::T;
  extern __shared__ __align__(16) unsigned char hf_smem[];
  const HeadFwdLayout L(C, NH, Co, TC);
  E* w1s = reinterpret_cast<E*>(hf_smem + L.w1);  // [NHp][ldw1]
  E* w2s = reinterpret_cast<E*>(hf_smem + L.w2);  // [Co8][ldw2]
  float* b1s = reinterpret_cast<float*>(hf_smem + L.b1);
  E* s = reinterpret_cast<E*>(hf_smem + L.s);     // [Cp][lds] channels-first pixels
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int XY = X * Y, npix = B * XY, p0 = blockIdx.x * HF_PIX;
  const size_t plane = (size_t)Hp * Wp;
  // in flight at once, by cp.async (4 bytes a copy: rows of the padded field
  // need not start on 8 bytes): the block's pixels of hf channels-first (in
  // f32, into S itself on the f32 path); W1 and W2 as given; b1
  float* raw = reinterpret_cast<float*>(hf_smem + L.raw);
  float* wraw = reinterpret_cast<float*>(hf_smem + L.wraw);
  const int p = tid % HF_PIX, ldr = TC ? HF_PIX : L.lds;
  const bool ok = p0 + p < npix;
  if (ok) {
    const Pixel px = pixel_at(p0 + p, XY, Y, Wp);
    const float* src = hf + (size_t)px.b * C * plane + px.hw;
    for (int c = tid / HF_PIX; c < C; c += nthr / HF_PIX)
      cp_async4(raw + c * ldr + p, src + c * plane);
  }
  for (int i = tid; i < NH * C; i += nthr) cp_async4(wraw + i, w1t + i);
  for (int i = tid; i < Co * NH; i += nthr) cp_async4(wraw + NH * C + i, w2t + i);
  for (int i = tid; i < L.NHp; i += nthr) {
    if (i < NH)
      cp_async4(b1s + i, b1 + i);
    else
      b1s[i] = 0.f;
  }
  cp_async_wait_all();
  __syncthreads();
  stage_matrix(w1s, L.ldw1, wraw, NH, C, L.NHp, L.Cp);
  stage_matrix(w2s, L.ldw2, wraw + NH * C, Co, NH, L.Co8, L.NHp);
  __syncthreads();
  for (int c = tid / HF_PIX; c < L.Cp; c += nthr / HF_PIX)  // the values this thread copied
    s[c * L.lds + p] = to_elem<E>(ok && c < C ? raw[c * ldr + p] : 0.f);
  __syncthreads();

  const int lane = tid & 31, warp = tid >> 5, g = lane >> 2, t = lane & 3;
  const int m0 = warp * 32;
  const int K1 = TC ? L.Cp : C, NOT = L.Co8 / 8;
  for (int ot0 = 0; ot0 < NOT; ot0 += HF_OT) {
    float acc2[HF_OT][2][4] = {};
    for (int h0 = 0; h0 < L.NHp; h0 += 16) {
      float acc1[2][2][4] = {};
      tiles_prod<2, 2, false, true>(acc1, s + m0, L.lds, w1s + h0 * L.ldw1, L.ldw1, K1);
      float tv[2][2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            tv[mt][nt][e] = gelu_f(acc1[mt][nt][e] + b1s[h0 + nt * 8 + 2 * t + (e & 1)]);
      if constexpr (TC) {
        uint32_t fa[2][4];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          fa[mt][0] = pack_bf16(tv[mt][0][0], tv[mt][0][1]);
          fa[mt][1] = pack_bf16(tv[mt][0][2], tv[mt][0][3]);
          fa[mt][2] = pack_bf16(tv[mt][1][0], tv[mt][1][1]);
          fa[mt][3] = pack_bf16(tv[mt][1][2], tv[mt][1][3]);
        }
#pragma unroll
        for (int q = 0; q < HF_OT; ++q)
          if (ot0 + q < NOT) {
            uint32_t fb[2];
            frag_b<true>(fb, w2s + (ot0 + q) * 8 * L.ldw2 + h0, L.ldw2);
#pragma unroll
            for (int mt = 0; mt < 2; ++mt) mma_bf16(acc2[q][mt], fa[mt], fb);
          }
      } else {
        float* ts = reinterpret_cast<float*>(hf_smem + L.ts) + warp * 32 * HF_TLD;
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int nt = 0; nt < 2; ++nt)
#pragma unroll
            for (int r = 0; r < 2; ++r)
              st_pair(ts + (16 * mt + g + 8 * r) * HF_TLD + nt * 8 + 2 * t, tv[mt][nt][2 * r],
                      tv[mt][nt][2 * r + 1]);
        __syncwarp();
#pragma unroll
        for (int q = 0; q < HF_OT; ++q)
          if (ot0 + q < NOT)
            tiles_prod<2, 1, true, true>(*reinterpret_cast<float(*)[2][1][4]>(&acc2[q]), ts,
                                         HF_TLD, w2s + (ot0 + q) * 8 * L.ldw2 + h0, L.ldw2, 16);
        __syncwarp();
      }
    }
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int pix = p0 + m0 + 16 * mt + g + 8 * r;
        if (pix >= npix) continue;
        const Pixel px = pixel_at(pix, XY, Y, Wp);
#pragma unroll
        for (int q = 0; q < HF_OT; ++q)
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const int o = (ot0 + q) * 8 + 2 * t + j, bo = px.b * Co + o;
            if (o < Co)
              pred[(size_t)bo * XY + px.xy] =
                  (acc2[q][mt][2 * r + j] + b2[o]) * stdv[bo] + mean[bo];
          }
      }
  }
}

template <bool TC>
static int launch_head_fwd(const float* hf, const float* w1t, const float* b1, const float* w2t,
                           const float* b2, const float* mean, const float* stdv, float* pred,
                           int B, int C, int X, int Y, int Hp, int Wp, int NH, int Co,
                           cudaStream_t st) {
  const size_t smem = HeadFwdLayout(C, NH, Co, TC).bytes;
  cudaError_t e = fno_set_smem(head_fwd_kernel<TC>, smem);
  if (e != cudaSuccess) return (int)e;
  const int nblk = (B * X * Y + HF_PIX - 1) / HF_PIX;
  head_fwd_kernel<TC><<<nblk, HF_WARPS * 32, smem, st>>>(hf, w1t, b1, w2t, b2, mean, stdv,
                                                         pred, B, C, X, Y, Hp, Wp, NH, Co);
  return (int)cudaGetLastError();
}

// Shared memory of one head_fwd_kernel block (HeadFwdLayout): the wrapper's check
// of a shape against the card's limit reads it here.
FNO_EXPORT long long fno_head_fwd_smem(int C, int NH, int Co, int bf) {
  return (long long)HeadFwdLayout(C, NH, Co, bf != 0).bytes;
}

FNO_EXPORT int fno_head_fwd(const float* hf, const float* w1t, const float* b1,
                            const float* w2t, const float* b2, const float* mean,
                            const float* stdv, float* pred, int B, int C, int X, int Y, int Hp,
                            int Wp, int NH, int Co, int bf, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  return bf ? launch_head_fwd<true>(hf, w1t, b1, w2t, b2, mean, stdv, pred, B, C, X, Y, Hp, Wp,
                                    NH, Co, st)
            : launch_head_fwd<false>(hf, w1t, b1, w2t, b2, mean, stdv, pred, B, C, X, Y, Hp,
                                     Wp, NH, Co, st);
}
