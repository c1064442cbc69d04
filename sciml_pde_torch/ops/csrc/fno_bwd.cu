// Backward kernels of the fused FNO-2D step on Hopper (sm_90a).
//
// Replaces the TPU kernel sciml_pde_tpu/ops/fno_fused_step.py::_full_bwd_kernel
// (B2), the hand-derived VJP that recomputes the forward in VMEM and
// accumulates the ten weight gradients over the batch in revisited output
// blocks.  Hopper runs blocks in parallel and in no order, so nothing can be
// carried from one block to the next: here the forward saves `pre` and the
// corner spectra (in the dot dtype), the adjoint chain reuses the forward's
// wdft / corner / iwdft_pw kernels (fno_fwd.cu) with adjoint factors, and
// every batch- or pixel-sum of a weight gradient is a per-block partial
// written to its own row, then summed in a fixed order by fno_reduce_rows.
// No float atomics, so repeated runs give the same bits.
//
//   fno_head_bwd       head recompute + backward per 64-pixel tile: dbb into
//                      the padded cotangent field, partial dW1/db1/dW2/db2
//   fno_mix_wgrad      mode-mix weight grads sum_b conj(spec) * dspec
//   fno_outer_partial  partial sum_p A[i,p] B[j,p] and sum_p A[i,p] over a
//                      pixel tile: 1x1-conv grads (A = dpre, B = layer
//                      input) and lift grads (A = dh0, B = lift input)
//   fno_reduce_rows    out[i] = sum_k partial[k, i] in a fixed order (see its
//                      note below)
//
// The split kernels _head_bwd_kernel (B2a), _bb_bwd_kernel (B2b) and
// _bb_wgrad_kernel (B2c) use head_bwd, outer_partial, mix_wgrad (on f32
// spectra) and reduce_rows the same way (sciml_pde_torch/ops/fno_fused_step.py).
//
// Bound at the flagship shape: as the forward, latency-bound (a few MB and
// a few tens of MFLOP per launch); fno_reduce_rows at the head shape by
// bytes.

#include <cooperative_groups.h>

#include "fno_common.cuh"

#define HEAD_PB 64      // pixels per head-backward block (4 threads each)
#define OUTER_PB 256    // pixels per outer-product block (1 thread each)

// ---------------------------------------------------------------------------
// head backward
// partial row layout: [dW1t (NH, C) | db1 (NH) | dW2t (Co, NH) | db2 (Co)]
// ---------------------------------------------------------------------------

__global__ void head_bwd_kernel(const float* __restrict__ dpred, const float* __restrict__ hf,
                                const float* __restrict__ w1t, const float* __restrict__ b1,
                                const float* __restrict__ w2t, const float* __restrict__ stdv,
                                float* __restrict__ dh, float* __restrict__ partial, int B,
                                int C, int X, int Y, int Hp, int Wp, int NH, int Co, int bf) {
  extern __shared__ float sm[];
  const int LD = HEAD_PB + 1;  // odd stride: column walks hit distinct banks
  const int NQ = blockDim.x / HEAD_PB;
  float* w1s = sm;               // (NH, C)
  float* b1s = w1s + NH * C;     // (NH)
  float* w2s = b1s + NH;         // (Co, NH)
  float* bbs = w2s + Co * NH;    // (C, LD)  rounded backbone output
  float* dos = bbs + C * LD;     // (Co, LD) dout = dpred * std
  float* t1s = dos + Co * LD;    // (NH, LD) rounded gelu(fc1)
  float* dps = t1s + NH * LD;    // (NH, LD) dpre1
  float* dbp = dps + NH * LD;    // (NQ, C, LD) per-quarter dbb
  const int npix = B * X * Y;
  const int p0 = blockIdx.x * HEAD_PB;
  for (int i = threadIdx.x; i < NH * C; i += blockDim.x) w1s[i] = w1t[i];
  for (int i = threadIdx.x; i < NH; i += blockDim.x) b1s[i] = b1[i];
  for (int i = threadIdx.x; i < Co * NH; i += blockDim.x) w2s[i] = w2t[i];
  for (int i = threadIdx.x; i < (C + Co) * HEAD_PB; i += blockDim.x) {
    const int ch = i / HEAD_PB, p = i % HEAD_PB, pix = p0 + p;
    float v = 0.f;
    if (pix < npix) {
      const int y = pix % Y, x = (pix / Y) % X, b = pix / (X * Y);
      if (ch < C) {
        v = rd(hf[(((size_t)b * C + ch) * Hp + x) * Wp + y], bf);
      } else {
        const int o = ch - C;
        v = dpred[(((size_t)b * Co + o) * X + x) * Y + y] * stdv[b * Co + o];
      }
    }
    if (ch < C) bbs[ch * LD + p] = v;
    else dos[(ch - C) * LD + p] = v;
  }
  __syncthreads();

  const int p = threadIdx.x % HEAD_PB, q = threadIdx.x / HEAD_PB;
  float bb[FNO_MAXC], dbb[FNO_MAXC], dor[FNO_MAXCO];
  for (int c = 0; c < C; ++c) {
    bb[c] = bbs[c * LD + p];
    dbb[c] = 0.f;
  }
  for (int o = 0; o < Co; ++o) dor[o] = rd(dos[o * LD + p], bf);
  for (int j = q; j < NH; j += NQ) {
    float a = 0.f;
    for (int c = 0; c < C; ++c) a += w1s[j * C + c] * bb[c];
    a += b1s[j];
    t1s[j * LD + p] = rd(gelu_f(a), bf);
    float dt = 0.f;
    for (int o = 0; o < Co; ++o) dt += w2s[o * NH + j] * dor[o];
    const float dp = dt * gelu_grad_f(a);
    dps[j * LD + p] = dp;
    const float dpr = rd(dp, bf);
    for (int c = 0; c < C; ++c) dbb[c] += w1s[j * C + c] * dpr;
  }
  for (int c = 0; c < C; ++c) dbp[(q * C + c) * LD + p] = dbb[c];
  __syncthreads();

  for (int i = threadIdx.x; i < C * HEAD_PB; i += blockDim.x) {
    const int c = i / HEAD_PB, pp = i % HEAD_PB, pix = p0 + pp;
    if (pix >= npix) continue;
    float s = 0.f;
    for (int qq = 0; qq < NQ; ++qq) s += dbp[(qq * C + c) * LD + pp];
    const int y = pix % Y, x = (pix / Y) % X, b = pix / (X * Y);
    dh[(((size_t)b * C + c) * Hp + x) * Wp + y] = s;
  }
  const int n1 = NH * C, n2 = n1 + NH, n3 = n2 + Co * NH, np = n3 + Co;
  float* part = partial + (size_t)blockIdx.x * np;
  for (int i = threadIdx.x; i < np; i += blockDim.x) {
    float s = 0.f;
    if (i < n1) {
      const int j = i / C, c = i % C;
      for (int pp = 0; pp < HEAD_PB; ++pp) s += rd(dps[j * LD + pp], bf) * bbs[c * LD + pp];
    } else if (i < n2) {
      const int j = i - n1;
      for (int pp = 0; pp < HEAD_PB; ++pp) s += dps[j * LD + pp];
    } else if (i < n3) {
      const int o = (i - n2) / NH, j = (i - n2) % NH;
      for (int pp = 0; pp < HEAD_PB; ++pp) s += rd(dos[o * LD + pp], bf) * t1s[j * LD + pp];
    } else {
      const int o = i - n3;
      for (int pp = 0; pp < HEAD_PB; ++pp) s += dos[o * LD + pp];
    }
    part[i] = s;
  }
}

FNO_EXPORT int fno_head_bwd(const float* dpred, const float* hf, const float* w1t,
                            const float* b1, const float* w2t, const float* stdv, float* dh,
                            float* partial, int B, int C, int X, int Y, int Hp, int Wp, int NH,
                            int Co, int bf, void* stream) {
  const int threads = 4 * HEAD_PB;
  const int LD = HEAD_PB + 1;
  const size_t smem =
      (size_t)(NH * C + NH + Co * NH + (C + Co + 2 * NH + 4 * C) * LD) * sizeof(float);
  cudaError_t e = fno_set_smem(head_bwd_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  const int nblk = (B * X * Y + HEAD_PB - 1) / HEAD_PB;
  head_bwd_kernel<<<nblk, threads, smem, (cudaStream_t)stream>>>(
      dpred, hf, w1t, b1, w2t, stdv, dh, partial, B, C, X, Y, Hp, Wp, NH, Co, bf);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// mode-mix weight gradients, one thread per (c, o, k*r):
//   dwr + i dwi = sum_b conj(spec[b, c]) * dspec[b, o]
// ---------------------------------------------------------------------------

template <typename S>
__global__ void mix_wgrad_kernel(const S* __restrict__ br, const S* __restrict__ bi,
                                 const float* __restrict__ dcr, const float* __restrict__ dci,
                                 float* __restrict__ dwr, float* __restrict__ dwi, int B, int C,
                                 int O, int KR) {
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (size_t)C * O * KR) return;
  const int kr = idx % KR;
  const int o = (idx / KR) % O;
  const int c = idx / ((size_t)O * KR);
  float sr = 0.f, si = 0.f;
  for (int b = 0; b < B; ++b) {
    const size_t xs = ((size_t)b * C + c) * KR + kr, gs = ((size_t)b * O + o) * KR + kr;
    const float xr = ldv(br + xs), xi = ldv(bi + xs);
    const float gr = dcr[gs], gi = dci[gs];
    sr += xr * gr + xi * gi;
    si += xr * gi - xi * gr;
  }
  dwr[idx] = sr;
  dwi[idx] = si;
}

FNO_EXPORT int fno_mix_wgrad(const void* br, const void* bi, const float* dcr,
                             const float* dci, float* dwr, float* dwi, int B, int C, int O,
                             int KR, int spec_bf16, void* stream) {
  const size_t n = (size_t)C * O * KR;
  const unsigned grid = (unsigned)((n + 255) / 256);
  cudaStream_t st = (cudaStream_t)stream;
  if (spec_bf16)
    mix_wgrad_kernel<__nv_bfloat16><<<grid, 256, 0, st>>>(
        (const __nv_bfloat16*)br, (const __nv_bfloat16*)bi, dcr, dci, dwr, dwi, B, C, O, KR);
  else
    mix_wgrad_kernel<float><<<grid, 256, 0, st>>>((const float*)br, (const float*)bi, dcr,
                                                  dci, dwr, dwi, B, C, O, KR);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// outer-product partials over a pixel tile of the region (nh, nw) of
// A (B, nA, ldhA, ldwA) f32 and Bm (B, nB, ldhB, ldwB):
//   partial[blk, i*nB + j] = sum_p A[i, p] Bm[j, p];  partial[blk, nA*nB + i] = sum_p A[i, p]
// With `gelu` set, Bm holds a saved pre-activation and the kernel reads gelu(Bm).
// ---------------------------------------------------------------------------

template <typename S>
__global__ void outer_partial_kernel(const float* __restrict__ A, const S* __restrict__ Bm,
                                     int gelu, float* __restrict__ partial, int Bn, int nA,
                                     int nB, int nh, int nw, int ldhA, int ldwA, int ldhB,
                                     int ldwB, int bf) {
  extern __shared__ float sm[];
  const int LD = OUTER_PB + 1;
  float* as = sm;            // (nA, LD)
  float* bs = sm + nA * LD;  // (nB, LD), rounded
  const int npix = Bn * nh * nw;
  const int t = threadIdx.x, pix = blockIdx.x * OUTER_PB + t;
  if (pix < npix) {
    const int x = pix % nw, y = (pix / nw) % nh, b = pix / (nh * nw);
    for (int a = 0; a < nA; ++a)
      as[a * LD + t] = A[(((size_t)b * nA + a) * ldhA + y) * ldwA + x];
    for (int j = 0; j < nB; ++j) {
      float v = ldv(Bm + (((size_t)b * nB + j) * ldhB + y) * ldwB + x);
      if (gelu) v = gelu_f(v);
      bs[j * LD + t] = rd(v, bf);
    }
  } else {
    for (int a = 0; a < nA; ++a) as[a * LD + t] = 0.f;
    for (int j = 0; j < nB; ++j) bs[j * LD + t] = 0.f;
  }
  __syncthreads();
  const int np = nA * nB + nA;
  float* part = partial + (size_t)blockIdx.x * np;
  for (int i = t; i < np; i += blockDim.x) {
    float s = 0.f;
    if (i < nA * nB) {
      const int a = i / nB, j = i % nB;
      for (int pp = 0; pp < OUTER_PB; ++pp) s += rd(as[a * LD + pp], bf) * bs[j * LD + pp];
    } else {
      const int a = i - nA * nB;
      for (int pp = 0; pp < OUTER_PB; ++pp) s += as[a * LD + pp];
    }
    part[i] = s;
  }
}

template <typename S>
static int launch_outer(const float* A, const void* Bm, int gelu, float* partial, int Bn,
                        int nA, int nB, int nh, int nw, int ldhA, int ldwA, int ldhB,
                        int ldwB, int bf, cudaStream_t st) {
  const size_t smem = (size_t)(nA + nB) * (OUTER_PB + 1) * sizeof(float);
  cudaError_t e = fno_set_smem(outer_partial_kernel<S>, smem);
  if (e != cudaSuccess) return (int)e;
  const int nblk = (Bn * nh * nw + OUTER_PB - 1) / OUTER_PB;
  outer_partial_kernel<S><<<nblk, OUTER_PB, smem, st>>>(A, (const S*)Bm, gelu, partial, Bn,
                                                        nA, nB, nh, nw, ldhA, ldwA, ldhB,
                                                        ldwB, bf);
  return (int)cudaGetLastError();
}

FNO_EXPORT int fno_outer_partial(const float* A, const void* Bm, int b_bf16, int gelu,
                                 float* partial, int Bn, int nA, int nB, int nh, int nw,
                                 int ldhA, int ldwA, int ldhB, int ldwB, int bf, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (b_bf16)
    return launch_outer<__nv_bfloat16>(A, Bm, gelu, partial, Bn, nA, nB, nh, nw, ldhA, ldwA,
                                       ldhB, ldwB, bf, st);
  return launch_outer<float>(A, Bm, gelu, partial, Bn, nA, nB, nh, nw, ldhA, ldwA, ldhB,
                             ldwB, bf, st);
}

// ---------------------------------------------------------------------------
// deterministic reduction of per-block partial rows
//
// fno_reduce_rows replaces the sums that _full_bwd_kernel (B2) carries from
// one sequential grid step to the next in revisited output blocks (the head
// gradients, dw1t_ref[:] += ... at sciml_pde_tpu/ops/fno_fused_step.py:1038-1043,
// and dwmr_ref[i] += ..., dpw_ref[i] += ... and the lift gradients at
// :1052-1075): out[i] = sum_k partial[k, i] over the partial rows that the
// kernels above write.  Bound by bytes, each partial read once: 12.08 MB at
// the head backward's (1024, 2946), 3.61 us at 3.35 TB/s; the outer
// products' (265, 420) and (256, 460) are latency-bound (0.13-0.14 us of
// bytes).  One thread per column walking all rows kept 24 SMs busy, each
// thread a chain of 1024 loads.  Here the rows are cut into RR_GROUPS fixed
// groups of ceil(rows / RR_GROUPS) consecutive rows (the last ragged, any
// past it empty): a cluster of RR_CLUSTER blocks per RR_COLS columns,
// RR_WARPS warps a block, one group a warp.  Each lane sums its column over
// its group's rows in order with RR_UNROLL loads in flight, coalesced
// across the warp's 32 columns (scalar loads: a row pitch of 2946 floats is
// not 16-byte aligned).  The block adds its warps' sums in warp order
// through shared memory, and rank 0 of the cluster adds the blocks' sums in
// rank order through distributed shared memory, as fno_stats does.  At the
// head shape that is 372 blocks of 256 threads on all 132 SMs, about 3 MB
// of loads in flight.  A fixed order and no atomics: the same bits from
// launch to launch (tests/test_torch_fno_fused_step.py rehearses the order).
// ---------------------------------------------------------------------------

constexpr int RR_COLS = 32, RR_WARPS = 8, RR_CLUSTER = 4, RR_UNROLL = 8;
constexpr int RR_GROUPS = RR_WARPS * RR_CLUSTER;

__global__ void __cluster_dims__(RR_CLUSTER, 1, 1) __launch_bounds__(RR_COLS * RR_WARPS)
reduce_rows_kernel(const float* __restrict__ partial, float* __restrict__ out, int nblk, int n) {
  __shared__ float warp_sum[RR_WARPS][RR_COLS];
  __shared__ float block_sum[RR_COLS];
  namespace cgrp = cooperative_groups;
  cgrp::cluster_group cluster = cgrp::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int col = blockIdx.x / RR_CLUSTER * RR_COLS + lane;
  const int per = (nblk + RR_GROUPS - 1) / RR_GROUPS;
  const int k0 = min((rank * RR_WARPS + warp) * per, nblk), k1 = min(k0 + per, nblk);
  float s = 0.f;
  if (col < n) {
    const float* p = partial + (size_t)k0 * n + col;
    int k = k0;
    for (; k + RR_UNROLL <= k1; k += RR_UNROLL, p += (size_t)RR_UNROLL * n) {
      float v[RR_UNROLL];
#pragma unroll
      for (int u = 0; u < RR_UNROLL; ++u) v[u] = p[(size_t)u * n];
#pragma unroll
      for (int u = 0; u < RR_UNROLL; ++u) s += v[u];
    }
    for (; k < k1; ++k, p += n) s += *p;
  }
  warp_sum[warp][lane] = s;
  __syncthreads();
  if (warp == 0) {
    float b = 0.f;
    for (int w = 0; w < RR_WARPS; ++w) b += warp_sum[w][lane];
    block_sum[lane] = b;
  }
  cluster.sync();
  if (rank == 0 && warp == 0 && col < n) {
    float t = 0.f;
    for (int r = 0; r < RR_CLUSTER; ++r) t += *cluster.map_shared_rank(&block_sum[lane], r);
    out[col] = t;
  }
  cluster.sync();  // no block leaves while rank 0 reads its shared memory
}

FNO_EXPORT int fno_reduce_rows(const float* partial, float* out, int nblk, int n,
                               void* stream) {
  const unsigned grid = (unsigned)((n + RR_COLS - 1) / RR_COLS * RR_CLUSTER);
  reduce_rows_kernel<<<grid, RR_COLS * RR_WARPS, 0, (cudaStream_t)stream>>>(partial, out,
                                                                           nblk, n);
  return (int)cudaGetLastError();
}
