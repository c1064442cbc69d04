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
//                  one block per (element, W-mode) keeps the whole column
//                  of retained modes in shared memory
//     fno_iwdft_pw Hermitian inverse W + 1x1 conv + bias (+ gelu), one
//                  block per (element, image row)
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
// latency-bound, not compute- or bandwidth-bound.  The design keeps each
// stage but fno_stats, fno_wdft and fno_head_fwd (their notes below) a
// plain tiled loop over shared memory with f32 FMAs on the CUDA cores; wgmma
// and TMA are left for a later change.

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
// One thread per pixel of the padded field; the output channels go in passes
// of LIFT_CC held in registers (each pass reads the F inputs again, the first
// writes finp), so any C whose (C, F) weights fit in shared memory runs:
// C * F * 4 bytes up to 227 KB, C up to 2641 at F = 22 (fno_kernels.lift
// checks it).
// ---------------------------------------------------------------------------

constexpr int LIFT_CC = 32;  // output channels a pass

__global__ void lift_kernel(const float* __restrict__ win, const float* __restrict__ grid2,
                            const float* __restrict__ mean, const float* __restrict__ stdv,
                            const float* __restrict__ w0t, const float* __restrict__ b0,
                            float* __restrict__ h0, float* __restrict__ finp, int B, int T,
                            int Cc, int X, int Y, int C, int Hp, int Wp, int bf) {
  extern __shared__ float sm[];
  const int F = T * Cc + 2;
  float* ws = sm;  // (C, F)
  for (int i = threadIdx.x; i < C * F; i += blockDim.x) ws[i] = w0t[i];
  __syncthreads();
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (size_t)B * Hp * Wp) return;
  const int w = idx % Wp;
  const int h = (idx / Wp) % Hp;
  const int b = idx / ((size_t)Hp * Wp);
  const size_t plane = (size_t)Hp * Wp;
  float* hout = h0 + (size_t)b * C * plane + (size_t)h * Wp + w;
  if (h >= X || w >= Y) {
    for (int c = 0; c < C; ++c) hout[c * plane] = 0.f;
    return;
  }
  const size_t xy = (size_t)X * Y, pix = (size_t)h * Y + w;
  for (int c0 = 0; c0 < C; c0 += LIFT_CC) {
    float acc[LIFT_CC];
#pragma unroll
    for (int i = 0; i < LIFT_CC; ++i) acc[i] = 0.f;
    for (int f = 0; f < F; ++f) {
      float v;
      if (f < T * Cc) {
        const int t = f / Cc, cc = f % Cc;
        v = (win[(((size_t)b * T + t) * Cc + cc) * xy + pix] - mean[b * Cc + cc]) /
            stdv[b * Cc + cc];
      } else {
        v = grid2[(size_t)(f - T * Cc) * xy + pix];
      }
      if (c0 == 0) finp[((size_t)b * F + f) * xy + pix] = v;
      const float vr = rd(v, bf);
#pragma unroll
      for (int i = 0; i < LIFT_CC; ++i)
        if (c0 + i < C) acc[i] += ws[(c0 + i) * F + f] * vr;
    }
#pragma unroll
    for (int i = 0; i < LIFT_CC; ++i)
      if (c0 + i < C) hout[(c0 + i) * plane] = acc[i] + b0[c0 + i];
  }
}

FNO_EXPORT int fno_lift(const float* win, const float* grid2, const float* mean,
                        const float* stdv, const float* w0t, const float* b0, float* h0,
                        float* finp, int B, int T, int Cc, int X, int Y, int C, int Hp,
                        int Wp, int bf, void* stream) {
  const size_t smem = (size_t)C * (T * Cc + 2) * sizeof(float);
  cudaError_t e = fno_set_smem(lift_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  const size_t n = (size_t)B * Hp * Wp;
  lift_kernel<<<(unsigned)((n + 255) / 256), 256, smem, (cudaStream_t)stream>>>(
      win, grid2, mean, stdv, w0t, b0, h0, finp, B, T, Cc, X, Y, C, Hp, Wp, bf);
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
// another before any of its rows.  Here a block owns WD_ROWS = 32 rows of x,
// 32 N contiguous floats from a 16-byte boundary (325 blocks of 256
// threads at the flagship shape, 2-3 an SM, one wave):
//   1. its threads copy those rows (and, for gelu', the rows of pre) and the
//      factor into shared memory by cp.async, all in flight at once, so the
//      launch waits on about one round trip to device memory;
//   2. each thread forms v in place from the float4s it copied (gelu or
//      gelu') and writes dpre with float4 stores; gelu' (erff, expf, a
//      branching chain) is spread over every thread of the block;
//   3. the operands are rounded to bf16 once a block: v into a row-major
//      [32][K + 8] tile, K = 16 ceil(N / 16) (130 -> 144, the padding and
//      any rows past M zero; +8: conflict-free ldmatrix), and the factor,
//      already bf16-exact, into the B fragments of every (k16 step, n8
//      tile) in lane order, rows past N zero;
//   4. each warp takes (m16 row tile, n8 column tile) pairs of the output,
//      6 of them at J = 24: per k16 step one ldmatrix, one 8-byte load and
//      one mma.sync m16n8k16 bf16 with f32 accumulation (the bf16 products
//      are exact in f32, as the reference's _dot with bf16 inputs), into the
//      block's output tile in shared memory;
//   5. the block's rows of out, 32 J contiguous floats, leave by float4
//      stores.
// What bounds it now is the work between the copies and the stores, not the
// bytes (PERF.md): the first designs spent it on per-element index
// arithmetic and per-step fragment assembly, this one on the two bf16
// passes, the MMA chain and gelu'.  The factor's fragments come from shared
// memory rather than registers so that N and J stay runtime sizes.
//   f32 (bf = 0, `highest`): products stay exact f32 (no TF32), on the CUDA
//   cores, from the f32 copies after step 2: a lane owns 2 rows x 2 columns
//   of a warp's 16 x 8 output tile, so each value loaded from shared memory
//   feeds 2 FMAs; in-order sums over k as before.
// No atomics and no block reads what another writes: the same bits from
// launch to launch.
// ---------------------------------------------------------------------------

constexpr int WD_ROWS = 32;  // rows of x a block owns: two m16 tiles
constexpr int WD_WARPS = 8;  // warps a block


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

// Shared memory of one block: the factor as given (f32, N * J rounded up to
// 4 values), the block's rows of x (WD_ROWS N values rounded up to 8), its
// rows of pre where gelu'(pre) is taken, and on the tensor-core path the
// bf16 tile of v, the factor's B fragments and the output tile.  About
// 224 N bytes with no pre on the CUDA cores, up to about 500 N with gelu',
// an f32 pre and the tensor cores; so at J = 24 the 227 KB a block may take
// hold N = Wp up to 492 in the widest variant and 1037 in the narrowest
// (the flagship's 130 takes 29-65 KB).  fno_kernels.wdft mirrors this
// layout (wdft_smem_bytes) and raises above it, naming the variant's limit.
struct WdftLayout {
  int TS, KS, NNT, LDA;
  size_t fac, xs, ps, at, bf, bytes;
  __host__ __device__ WdftLayout(int N, int J, bool tc, bool stage_pre, size_t pre_size) {
    TS = (WD_ROWS * N + 7) / 8 * 8;
    KS = (N + 15) / 16;
    NNT = (J + 7) / 8;
    LDA = 16 * KS + 8;  // +8 bf16: conflict-free ldmatrix
    fac = (size_t)(N * J + 3) / 4 * 16;
    xs = (size_t)TS * 4;
    ps = stage_pre ? ((size_t)TS * pre_size + 15) / 16 * 16 : 0;
    at = tc ? (size_t)WD_ROWS * LDA * 2 : 0;
    bf = tc ? (size_t)KS * NNT * 32 * 8 : 0;
    bytes = fac + xs + ps + at + bf + (tc ? ((size_t)WD_ROWS * J * 4 + 15) / 16 * 16 : 0);
  }
};

template <typename S, bool TC>
__global__ void __launch_bounds__(WD_WARPS * 32)
wdft_kernel(const float* __restrict__ x, const float* __restrict__ fac, float* __restrict__ out,
            int M, int N, int J, const S* __restrict__ pre, int gelu_grad,
            float* __restrict__ dpre, int gelu_in) {
  extern __shared__ __align__(16) unsigned char wd_smem[];
  const bool gg = pre != nullptr && gelu_grad, op = gg || gelu_in;
  const WdftLayout L(N, J, TC, gg, sizeof(S));
  float* fst = reinterpret_cast<float*>(wd_smem);
  float* xs = reinterpret_cast<float*>(wd_smem + L.fac);
  S* ps = reinterpret_cast<S*>(wd_smem + L.fac + L.xs);
  __nv_bfloat16* at = reinterpret_cast<__nv_bfloat16*>(wd_smem + L.fac + L.xs + L.ps);
  uint2* bfr = reinterpret_cast<uint2*>(wd_smem + L.fac + L.xs + L.ps + L.at);
  float* ot = reinterpret_cast<float*>(wd_smem + L.fac + L.xs + L.ps + L.at + L.bf);
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int row0 = blockIdx.x * WD_ROWS, nrows = min(WD_ROWS, M - row0);
  const size_t g0 = (size_t)row0 * N;
  const int cnt = nrows * N, n4 = cnt / 4, nf = N * J;

  // the factor and the block's rows of x (and pre) into shared memory by
  // cp.async, all in flight at once (the rows are WD_ROWS N contiguous
  // values from a 16-byte boundary); ragged tails by plain loads
  for (int i = tid; i < nf / 4; i += nthr) cp_async(fst + 4 * i, fac + 4 * i);
  for (int i = nf / 4 * 4 + tid; i < nf; i += nthr) fst[i] = fac[i];
  for (int i = tid; i < n4; i += nthr) {
    cp_async(xs + 4 * i, x + g0 + 4 * i);
    if (gg) cp_async(ps + 4 * i, pre + g0 + 4 * i);
  }
  for (int e = 4 * n4 + tid; e < cnt; e += nthr) {
    xs[e] = x[g0 + e];
    if (gg) ps[e] = pre[g0 + e];
  }
  cp_async_wait_all();
  if (op || pre != nullptr) {  // v in place of x, and dpre = v: each thread the values it copied
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
  }
  __syncthreads();

  const int lane = tid % 32, warp = tid / 32, g = lane >> 2, t = lane & 3;
  if constexpr (TC) {
    // bf16 operands once a block: v as a row-major [WD_ROWS][LDA] tile (columns
    // past N and rows past the block's zero), and the factor as the B
    // fragments of each (k16 step, n8 tile) in lane order (PTX m16n8k16: lane
    // = 4 g + t holds column g, rows 2t, 2t + 1 and 2t + 8, 2t + 9)
    for (int r = warp; r < WD_ROWS; r += WD_WARPS)
      for (int c = 2 * lane; c < 16 * L.KS; c += 64) {
        const float* p = xs + r * N + c;
        const bool ok = r < nrows;
        const __nv_bfloat162 h = __floats2bfloat162_rn(ok && c < N ? p[0] : 0.f,
                                                       ok && c + 1 < N ? p[1] : 0.f);
        *reinterpret_cast<__nv_bfloat162*>(at + r * L.LDA + c) = h;
      }
    for (int i = tid; i < L.KS * L.NNT * 32; i += nthr) {
      const int q = i >> 5, bg = (i & 31) >> 2, bt = i & 3;
      const int k = q / L.NNT * 16 + 2 * bt, n = q % L.NNT * 8 + bg;
      bfr[i] = make_uint2(b_pair(fst, k, n, N, J), b_pair(fst, k + 8, n, N, J));
    }
    __syncthreads();
    // one (m16 row tile, n8 column tile) of the output a warp at a time: A by
    // ldmatrix, B by one 8-byte load, into the block's output tile
    const int lm_row = ((lane >> 3) & 1) * 8 + (lane & 7), lm_col = (lane >> 4) * 8;
    const int items = (nrows + 15) / 16 * L.NNT;
    for (int item = warp; item < items; item += WD_WARPS) {
      const int mt = item / L.NNT, nt = item - mt * L.NNT;
      const __nv_bfloat16* arow = at + (mt * 16 + lm_row) * L.LDA + lm_col;
      const uint2* bq = bfr + nt * 32 + lane;
      float acc[4] = {};
      for (int ks = 0; ks < L.KS; ++ks) {
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
    __syncthreads();
    // the block's rows of out are nrows J contiguous floats from a 16-byte
    // boundary: float4 stores
    float* ob = out + (size_t)row0 * J;
    const int no = nrows * J;
    for (int i = tid; i < no / 4; i += nthr)
      *reinterpret_cast<float4*>(ob + 4 * i) = *reinterpret_cast<const float4*>(ot + 4 * i);
    for (int e = no / 4 * 4 + tid; e < no; e += nthr) ob[e] = ot[e];
  } else {
    // one 16 x 8 tile of the output a warp at a time, on the CUDA cores: a
    // lane owns rows 2 (lane / 4) + i and columns 2 (lane % 4) + c
    const int nnt = (J + 7) / 8, items = (nrows + 15) / 16 * nnt;
    for (int item = warp; item < items; item += WD_WARPS) {
      const int mt = item / nnt, j0 = (item - mt * nnt) * 8, r0 = row0 + mt * 16;
      const float* xt = xs + mt * 16 * N;
      const int rr = lane / 4 * 2, jj = j0 + lane % 4 * 2;
      const bool ok0 = jj < J, ok1 = jj + 1 < J;
      float acc[2][2] = {};
      for (int k = 0; k < N; ++k) {
        const float x0 = xt[rr * N + k], x1 = xt[(rr + 1) * N + k];
        const float f0 = ok0 ? fst[k * J + jj] : 0.f, f1 = ok1 ? fst[k * J + jj + 1] : 0.f;
        acc[0][0] = fmaf(x0, f0, acc[0][0]);
        acc[0][1] = fmaf(x0, f1, acc[0][1]);
        acc[1][0] = fmaf(x1, f0, acc[1][0]);
        acc[1][1] = fmaf(x1, f1, acc[1][1]);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int row = r0 + rr + i;
          if (row < M && jj + c < J) out[(size_t)row * J + jj + c] = acc[i][c];
        }
    }
  }
}

template <typename S, bool TC>
static int launch_wdft(const float* x, const float* fac, float* out, int M, int N, int J,
                       const void* pre, int gelu_grad, float* dpre, int gelu_in,
                       cudaStream_t st) {
  const size_t smem = WdftLayout(N, J, TC, pre != nullptr && gelu_grad, sizeof(S)).bytes;
  cudaError_t e = fno_set_smem(wdft_kernel<S, TC>, smem);
  if (e != cudaSuccess) return (int)e;
  wdft_kernel<S, TC><<<(M + WD_ROWS - 1) / WD_ROWS, WD_WARPS * 32, smem, st>>>(
      x, fac, out, M, N, J, (const S*)pre, gelu_grad, dpre, gelu_in);
  return (int)cudaGetLastError();
}

FNO_EXPORT int fno_wdft(const float* x, const float* fac, float* out, int M, int N, int J,
                        const void* pre, int pre_bf16, int gelu_grad, float* dpre, int gelu_in,
                        int bf, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (pre_bf16)
    return bf ? launch_wdft<__nv_bfloat16, true>(x, fac, out, M, N, J, pre, gelu_grad, dpre,
                                                 gelu_in, st)
              : launch_wdft<__nv_bfloat16, false>(x, fac, out, M, N, J, pre, gelu_grad, dpre,
                                                  gelu_in, st);
  return bf ? launch_wdft<float, true>(x, fac, out, M, N, J, pre, gelu_grad, dpre, gelu_in, st)
            : launch_wdft<float, false>(x, fac, out, M, N, J, pre, gelu_grad, dpre, gelu_in,
                                        st);
}

// ---------------------------------------------------------------------------
// Corner stage, one block per (element b, W-mode k):
//   Bs[i, r] = sum_h A[b, i, h, k] P[h, r]              (complex, saved to spec)
//   Cm[j, r] = sum_i Bs[i, r] W[i, j, k, r]             (forward)
//            = sum_i Bs[i, r] conj(W[j, i, k, r])       (adjoint)
//   D[b, j, h, k] = sum_r Cm[j, r] Q[r, h]              (complex)
// A and D hold the real parts at [..., :K] and the imaginary parts at
// [..., K:2K].  spec is (B, Cin, K, R), real and imaginary apart.  With D
// null the block stops after the spectrum (the split weight-gradient pass
// needs only the spectra of a layer's input and of its cotangent).
// ---------------------------------------------------------------------------

template <typename S, bool ADJ>
__global__ void corner_kernel(const float* __restrict__ A, const float* __restrict__ pr,
                              const float* __restrict__ pi, const float* __restrict__ wr,
                              const float* __restrict__ wi, const float* __restrict__ qr,
                              const float* __restrict__ qi, S* __restrict__ spr,
                              S* __restrict__ spi, float* __restrict__ D, int Cin, int Cout,
                              int Hp, int K, int R, int bf) {
  extern __shared__ float sm[];
  const int b = blockIdx.x / K, k = blockIdx.x % K;
  const int K2 = 2 * K;
  float* as_r = sm;
  float* as_i = as_r + Cin * Hp;
  float* ps_r = as_i + Cin * Hp;
  float* ps_i = ps_r + Hp * R;
  float* qs_r = ps_i + Hp * R;
  float* qs_i = qs_r + R * Hp;
  float* bs_r = qs_i + R * Hp;
  float* bs_i = bs_r + Cin * R;
  float* cs_r = bs_i + Cin * R;
  float* cs_i = cs_r + Cout * R;
  for (int i = threadIdx.x; i < Cin * Hp; i += blockDim.x) {
    const int c = i / Hp, h = i % Hp;
    const size_t g = (((size_t)b * Cin + c) * Hp + h) * K2 + k;
    as_r[i] = rd(A[g], bf);
    as_i[i] = rd(A[g + K], bf);
  }
  for (int i = threadIdx.x; i < Hp * R; i += blockDim.x) {
    ps_r[i] = pr[i];
    ps_i[i] = pi[i];
    qs_r[i] = qr[i];
    qs_i[i] = qi[i];
  }
  __syncthreads();
  for (int o = threadIdx.x; o < Cin * R; o += blockDim.x) {
    const int c = o / R, r = o % R;
    float sr = 0.f, si = 0.f;
    for (int h = 0; h < Hp; ++h) {
      const float ar = as_r[c * Hp + h], ai = as_i[c * Hp + h];
      const float gr = ps_r[h * R + r], gi = ps_i[h * R + r];
      sr += ar * gr - ai * gi;
      si += ar * gi + ai * gr;
    }
    bs_r[o] = sr;
    bs_i[o] = si;
    const size_t so = (((size_t)b * Cin + c) * K + k) * R + r;
    stv(spr + so, sr);
    stv(spi + so, si);
  }
  if (D == nullptr) return;  // uniform across the block
  __syncthreads();
  for (int o = threadIdx.x; o < Cout * R; o += blockDim.x) {
    const int j = o / R, r = o % R;
    float cr = 0.f, ci = 0.f;
    for (int i = 0; i < Cin; ++i) {
      const size_t wo = ADJ ? (((size_t)j * Cin + i) * K + k) * R + r
                            : (((size_t)i * Cout + j) * K + k) * R + r;
      const float w_r = wr[wo];
      const float w_i = ADJ ? -wi[wo] : wi[wo];
      const float br = bs_r[i * R + r], bi = bs_i[i * R + r];
      cr += br * w_r - bi * w_i;
      ci += br * w_i + bi * w_r;
    }
    cs_r[o] = rd(cr, bf);
    cs_i[o] = rd(ci, bf);
  }
  __syncthreads();
  for (int o = threadIdx.x; o < Cout * Hp; o += blockDim.x) {
    const int j = o / Hp, h = o % Hp;
    float dr = 0.f, di = 0.f;
    for (int r = 0; r < R; ++r) {
      const float cr = cs_r[j * R + r], ci = cs_i[j * R + r];
      const float q_r = qs_r[r * Hp + h], q_i = qs_i[r * Hp + h];
      dr += cr * q_r - ci * q_i;
      di += cr * q_i + ci * q_r;
    }
    const size_t g = (((size_t)b * Cout + j) * Hp + h) * K2 + k;
    D[g] = dr;
    D[g + K] = di;
  }
}

template <typename S, bool ADJ>
static int launch_corner(const float* A, const float* pr, const float* pi, const float* wr,
                         const float* wi, const float* qr, const float* qi, void* spr,
                         void* spi, float* D, int B, int Cin, int Cout, int Hp, int K, int R,
                         int bf, cudaStream_t st) {
  const size_t smem =
      (size_t)(2 * Cin * Hp + 4 * Hp * R + 2 * Cin * R + 2 * Cout * R) * sizeof(float);
  cudaError_t e = fno_set_smem(corner_kernel<S, ADJ>, smem);
  if (e != cudaSuccess) return (int)e;
  corner_kernel<S, ADJ><<<B * K, 256, smem, st>>>(A, pr, pi, wr, wi, qr, qi, (S*)spr,
                                                  (S*)spi, D, Cin, Cout, Hp, K, R, bf);
  return (int)cudaGetLastError();
}

FNO_EXPORT int fno_corner(const float* A, const float* pr, const float* pi, const float* wr,
                          const float* wi, const float* qr, const float* qi, void* spr,
                          void* spi, float* D, int B, int Cin, int Cout, int Hp, int K,
                          int R, int adj, int spec_bf16, int bf, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (adj)
    return launch_corner<float, true>(A, pr, pi, wr, wi, qr, qi, spr, spi, D, B, Cin, Cout,
                                      Hp, K, R, bf, st);
  if (spec_bf16)
    return launch_corner<__nv_bfloat16, false>(A, pr, pi, wr, wi, qr, qi, spr, spi, D, B,
                                               Cin, Cout, Hp, K, R, bf, st);
  return launch_corner<float, false>(A, pr, pi, wr, wi, qr, qi, spr, spi, D, B, Cin, Cout,
                                     Hp, K, R, bf, st);
}

// ---------------------------------------------------------------------------
// Inverse W + 1x1 conv epilogue, one block per (element b, row h):
//   v[j, w] = sum_q D[b, j, h, q] Z[q, w] + sum_c M[j, c] xin[b, c, h, w] (+ bias[j])
// Forward: Z = [wr; -wi], M = pw^T, bias, pre saved, out = gelu(v) or v.
// Adjoint: Z = [fr^T; fi^T], M = pw, xin = dpre, out = v = dh of the layer input.
// ---------------------------------------------------------------------------

template <typename S>
__global__ void iwdft_pw_kernel(const float* __restrict__ D, const float* __restrict__ Z,
                                const float* __restrict__ xin, const float* __restrict__ Mw,
                                const float* __restrict__ bias, float* __restrict__ out,
                                S* __restrict__ pre, int gelu, int Cin, int Cout, int Hp,
                                int Wp, int K, int bf) {
  extern __shared__ float sm[];
  const int b = blockIdx.x / Hp, h = blockIdx.x % Hp;
  const int K2 = 2 * K;
  float* ds = sm;                // (Cout, 2K)
  float* zs = ds + Cout * K2;    // (2K, Wp)
  float* xs = zs + K2 * Wp;      // (Cin, Wp)
  float* ms = xs + Cin * Wp;     // (Cout, Cin)
  for (int i = threadIdx.x; i < Cout * K2; i += blockDim.x) {
    const int j = i / K2, q = i % K2;
    ds[i] = rd(D[(((size_t)b * Cout + j) * Hp + h) * K2 + q], bf);
  }
  for (int i = threadIdx.x; i < K2 * Wp; i += blockDim.x) zs[i] = Z[i];
  for (int i = threadIdx.x; i < Cin * Wp; i += blockDim.x) {
    const int c = i / Wp, w = i % Wp;
    xs[i] = rd(xin[(((size_t)b * Cin + c) * Hp + h) * Wp + w], bf);
  }
  for (int i = threadIdx.x; i < Cout * Cin; i += blockDim.x) ms[i] = Mw[i];
  __syncthreads();
  for (int o = threadIdx.x; o < Cout * Wp; o += blockDim.x) {
    const int j = o / Wp, w = o % Wp;
    float s = 0.f;
    for (int q = 0; q < K2; ++q) s += ds[j * K2 + q] * zs[q * Wp + w];
    float p = 0.f;
    for (int c = 0; c < Cin; ++c) p += ms[j * Cin + c] * xs[c * Wp + w];
    float v = s + p;
    if (bias != nullptr) v += bias[j];
    const size_t g = (((size_t)b * Cout + j) * Hp + h) * Wp + w;
    if (pre != nullptr) stv(pre + g, v);
    out[g] = gelu ? gelu_f(v) : v;
  }
}

template <typename S>
static int launch_iwdft(const float* D, const float* Z, const float* xin, const float* Mw,
                        const float* bias, float* out, void* pre, int gelu, int B, int Cin,
                        int Cout, int Hp, int Wp, int K, int bf, cudaStream_t st) {
  const size_t smem =
      (size_t)(Cout * 2 * K + 2 * K * Wp + Cin * Wp + Cout * Cin) * sizeof(float);
  cudaError_t e = fno_set_smem(iwdft_pw_kernel<S>, smem);
  if (e != cudaSuccess) return (int)e;
  iwdft_pw_kernel<S><<<B * Hp, 256, smem, st>>>(D, Z, xin, Mw, bias, out, (S*)pre, gelu,
                                                Cin, Cout, Hp, Wp, K, bf);
  return (int)cudaGetLastError();
}

FNO_EXPORT int fno_iwdft_pw(const float* D, const float* Z, const float* xin,
                            const float* Mw, const float* bias, float* out, void* pre,
                            int pre_bf16, int gelu, int B, int Cin, int Cout, int Hp, int Wp,
                            int K, int bf, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (pre_bf16)
    return launch_iwdft<__nv_bfloat16>(D, Z, xin, Mw, bias, out, pre, gelu, B, Cin, Cout, Hp,
                                       Wp, K, bf, st);
  return launch_iwdft<float>(D, Z, xin, Mw, bias, out, pre, gelu, B, Cin, Cout, Hp, Wp, K,
                             bf, st);
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
