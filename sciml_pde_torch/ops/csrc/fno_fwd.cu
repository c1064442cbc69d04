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
//     fno_wdft     W-axis partial rDFT: (rows, Wp) x (Wp, 2*m2)
//     fno_corner   H-axis corner DFT -> complex mode mix -> inverse H,
//                  one block per (element, W-mode) keeps the whole column
//                  of retained modes in shared memory
//     fno_iwdft_pw Hermitian inverse W + 1x1 conv + bias (+ gelu), one
//                  block per (element, image row)
//   fno_head_fwd   fc1 -> gelu -> fc2 -> de-norm, one thread per pixel
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
// stage a plain tiled loop over shared memory with f32 FMAs on the CUDA
// cores; tensor cores (wgmma) and TMA are left for a later change.

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
// ---------------------------------------------------------------------------

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
  float acc[FNO_MAXC];
  for (int c = 0; c < C; ++c) acc[c] = 0.f;
  for (int f = 0; f < F; ++f) {
    float v;
    if (f < T * Cc) {
      const int t = f / Cc, cc = f % Cc;
      v = (win[(((size_t)b * T + t) * Cc + cc) * xy + pix] - mean[b * Cc + cc]) /
          stdv[b * Cc + cc];
    } else {
      v = grid2[(size_t)(f - T * Cc) * xy + pix];
    }
    finp[((size_t)b * F + f) * xy + pix] = v;
    const float vr = rd(v, bf);
    for (int c = 0; c < C; ++c) acc[c] += ws[c * F + f] * vr;
  }
  for (int c = 0; c < C; ++c) hout[c * plane] = acc[c] + b0[c];
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
// W-axis partial DFT: out (M, J) = in (M, N) x fac (N, J).
// With `pre` set the input is the cotangent dh of a layer output and the
// kernel first forms dpre = dh * gelu'(pre) (or dh itself for the last
// layer), writes it out, and transforms it: the first stage of the adjoint.
// With `gelu_in` set the input is a saved pre-activation and the kernel
// transforms gelu(in), the layer's output: the split weight-gradient pass
// recomputes the spectrum of a layer's input from the previous `pre`.
// ---------------------------------------------------------------------------

#define WDFT_ROWS 32

template <typename S>
__global__ void wdft_kernel(const float* __restrict__ x, const float* __restrict__ fac,
                            float* __restrict__ out, int M, int N, int J,
                            const S* __restrict__ pre, int gelu_grad,
                            float* __restrict__ dpre, int gelu_in, int bf) {
  extern __shared__ float sm[];
  float* xs = sm;                 // (WDFT_ROWS, N)
  float* fs = sm + WDFT_ROWS * N;  // (N, J)
  const int row0 = blockIdx.x * WDFT_ROWS;
  const int nrows = min(WDFT_ROWS, M - row0);
  for (int i = threadIdx.x; i < N * J; i += blockDim.x) fs[i] = fac[i];
  for (int i = threadIdx.x; i < nrows * N; i += blockDim.x) {
    const size_t g = (size_t)row0 * N + i;
    float v = x[g];
    if (gelu_in) v = gelu_f(v);
    if (pre != nullptr) {
      if (gelu_grad) v *= gelu_grad_f(ldv(pre + g));
      dpre[g] = v;
    }
    xs[i] = rd(v, bf);
  }
  __syncthreads();
  for (int o = threadIdx.x; o < nrows * J; o += blockDim.x) {
    const int r = o / J, j = o % J;
    const float* xr = xs + r * N;
    float acc = 0.f;
    for (int k = 0; k < N; ++k) acc += xr[k] * fs[k * J + j];
    out[(size_t)(row0 + r) * J + j] = acc;
  }
}

template <typename S>
static int launch_wdft(const float* x, const float* fac, float* out, int M, int N, int J,
                       const void* pre, int gelu_grad, float* dpre, int gelu_in, int bf,
                       cudaStream_t st) {
  const size_t smem = (size_t)(WDFT_ROWS * N + N * J) * sizeof(float);
  cudaError_t e = fno_set_smem(wdft_kernel<S>, smem);
  if (e != cudaSuccess) return (int)e;
  wdft_kernel<S><<<(M + WDFT_ROWS - 1) / WDFT_ROWS, 256, smem, st>>>(
      x, fac, out, M, N, J, (const S*)pre, gelu_grad, dpre, gelu_in, bf);
  return (int)cudaGetLastError();
}

FNO_EXPORT int fno_wdft(const float* x, const float* fac, float* out, int M, int N, int J,
                        const void* pre, int pre_bf16, int gelu_grad, float* dpre, int gelu_in,
                        int bf, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (pre_bf16)
    return launch_wdft<__nv_bfloat16>(x, fac, out, M, N, J, pre, gelu_grad, dpre, gelu_in, bf,
                                      st);
  return launch_wdft<float>(x, fac, out, M, N, J, pre, gelu_grad, dpre, gelu_in, bf, st);
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
// Head: pred (B, Co, X, Y) = (fc2(gelu(fc1(h))) ) * std + mean, per pixel.
// ---------------------------------------------------------------------------

__global__ void head_fwd_kernel(const float* __restrict__ hf, const float* __restrict__ w1t,
                                const float* __restrict__ b1, const float* __restrict__ w2t,
                                const float* __restrict__ b2, const float* __restrict__ mean,
                                const float* __restrict__ stdv, float* __restrict__ pred,
                                int B, int C, int X, int Y, int Hp, int Wp, int NH, int Co,
                                int bf) {
  extern __shared__ float sm[];
  float* w1s = sm;             // (NH, C)
  float* b1s = w1s + NH * C;   // (NH)
  float* w2s = b1s + NH;       // (Co, NH)
  for (int i = threadIdx.x; i < NH * C; i += blockDim.x) w1s[i] = w1t[i];
  for (int i = threadIdx.x; i < NH; i += blockDim.x) b1s[i] = b1[i];
  for (int i = threadIdx.x; i < Co * NH; i += blockDim.x) w2s[i] = w2t[i];
  __syncthreads();
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (size_t)B * X * Y) return;
  const int y = idx % Y;
  const int x = (idx / Y) % X;
  const int b = idx / ((size_t)X * Y);
  float bb[FNO_MAXC];
  for (int c = 0; c < C; ++c) bb[c] = rd(hf[(((size_t)b * C + c) * Hp + x) * Wp + y], bf);
  float acc[FNO_MAXCO];
  for (int o = 0; o < Co; ++o) acc[o] = 0.f;
  for (int j = 0; j < NH; ++j) {
    float a = 0.f;
    for (int c = 0; c < C; ++c) a += w1s[j * C + c] * bb[c];
    const float t = rd(gelu_f(a + b1s[j]), bf);
    for (int o = 0; o < Co; ++o) acc[o] += w2s[o * NH + j] * t;
  }
  for (int o = 0; o < Co; ++o)
    pred[(((size_t)b * Co + o) * X + x) * Y + y] =
        (acc[o] + b2[o]) * stdv[b * Co + o] + mean[b * Co + o];
}

FNO_EXPORT int fno_head_fwd(const float* hf, const float* w1t, const float* b1,
                            const float* w2t, const float* b2, const float* mean,
                            const float* stdv, float* pred, int B, int C, int X, int Y, int Hp,
                            int Wp, int NH, int Co, int bf, void* stream) {
  const size_t smem = (size_t)(NH * C + NH + Co * NH) * sizeof(float);
  cudaError_t e = fno_set_smem(head_fwd_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  const size_t n = (size_t)B * X * Y;
  head_fwd_kernel<<<(unsigned)((n + 127) / 128), 128, smem, (cudaStream_t)stream>>>(
      hf, w1t, b1, w2t, b2, mean, stdv, pred, B, C, X, Y, Hp, Wp, NH, Co, bf);
  return (int)cudaGetLastError();
}
