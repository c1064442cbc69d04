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
//   fno_head_bwd       head recompute + backward, persistent blocks over
//                      64-pixel tiles: dbb into the padded cotangent field,
//                      one partial dW1/db1/dW2/db2 row a block (see its note)
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

#define OUTER_PB 256    // pixels per outer-product block (1 thread each)

// ---------------------------------------------------------------------------
// head backward
//
// Replaces _head_bwd_kernel (B2a, sciml_pde_tpu/ops/fno_fused_step.py:559)
// and the head stage of _full_bwd_kernel (B2, :972): the head's forward
// recomputed from the last layer's output, and its VJP.  Per pixel, with
// bb = rd(hf), dout = dpred * std and dor = rd(dout):
//   pre1 = W1 bb + b1,  t1 = rd(gelu(pre1)),  dt1 = W2^T dor,
//   dpre1 = dt1 * gelu'(pre1),  dbb = W1^T rd(dpre1)  (into dh),
// and over all pixels dW1 = sum rd(dpre1) bb^T, db1 = sum dpre1 (f32 and
// unrounded, as JAX's _sum_cols), dW2 = sum dor t1^T and db2 = sum dout.
// The TPU kernel carries the four sums over its sequential grid in
// revisited output blocks.  Bound at the flagship shape (65,536 pixels,
// C = 20, NH = 128, Co = 2): 11.3 MB (3.4 us at 3.35 TB/s) against 1.07
// GFLOP (1.1 us on the bf16 tensor cores, 16 us on the f32 CUDA cores),
// plus an erff and an expf per pixel and hidden unit on the CUDA cores.
// The first design took 64 pixels a block (1024 blocks), kept bb, dbb and
// dor in runtime-indexed arrays (local memory, and a cap C <= 32, Co <= 8),
// summed each weight-gradient entry serially over its block's pixels, and
// wrote 1024 partial rows (12.1 MB, more than the whole bound).  Here:
//   - at most HB_GRID persistent blocks (a constant, not the SM count, so
//     that the bits do not depend on the card) walk the tiles of HB_PIX
//     consecutive pixels, block k the tiles k, k + grid, ... in order.
//     W1, W2 and b1 come in once a block by cp.async, with the first tile,
//     and are laid out zero-padded to NHp = 16 ceil(NH / 16) and Cp = 16
//     ceil(C / 16); each tile's hf (channels-first, coalesced along y),
//     dpred and std come in by cp.async while the tile before is computed;
//   - per tile, S[c][p] and dor in the element type (bf16, rounded once, on
//     the tensor-core path under `default`; f32 under `highest`), dout in
//     f32;
//   - warp w owns the hidden chunks w, w + 8, ... of 16 units.  Per two m16
//     tiles of pixels it recomputes fc1 (2 x 2 16 x 8 tiles: mma.sync with
//     A from S by ldmatrix.trans, or FMAs), forms dt1 (K = Co, CUDA cores),
//     gelu and gelu' from one erff, t1 and dpre1, stores t1 and rd(dpre1)
//     in shared memory, and sums dpre1 over its rows of the tile for db1;
//     a shuffle tree over the lanes then adds the tile's db1 to the
//     block's sums, which no other warp touches;
//   - then dW1 += rd(dpre1)^T bb and dW2^T += t1^T dor (K = the tile's
//     pixels, A by ldmatrix.trans) and dbb = rd(dpre1) W1 (K = NH, B by
//     ldmatrix.trans) straight into dh, two n8 tiles an item where they
//     pair; a warp per output channel adds the tile's sum of dout to db2;
//   - each block writes its sums as one partial row (the grid's rows, 256 at
//     the flagship, not one per 64 pixels), which fno_reduce_rows sums in a
//     fixed order, and zeros over dh's pad, so dh needs no fill before.
// Every sum runs in a fixed order and nothing is atomic: the same bits from
// launch to launch (tests/test_torch_fno_fused_step.py rehearses the order).
// What bounds it is gelu and gelu' on the CUDA cores, then the latency of
// the products' chains between a tile's barriers, not the bytes.  No
// register array is indexed by a runtime bound; C and Co are bounded by
// shared memory only (HeadBwdLayout; fno_kernels.head_bwd names the widest C).
// partial row layout: [dW1t (NH, C) | db1 (NH) | dW2t (Co, NH) | db2 (Co)]
// ---------------------------------------------------------------------------

constexpr int HB_PIX = 64;    // pixels a tile: four m16 tiles
constexpr int HB_WARPS = 8;   // warps a block
constexpr int HB_GRID = 256;  // persistent blocks at most: one partial row each

// Shared memory of one head_bwd_kernel block, in bytes from the start
// (fno_head_bwd_smem exports its size).
struct HeadBwdLayout {
  int Cp, NHp, Co8, ldw1, ldw2, lds, ldp, ldg;
  size_t w1, w2, b1, s, dor, dts, dps, t1, dw1, dw2, db1, db2, w2raw, raw, bytes;
  __host__ __device__ HeadBwdLayout(int C, int NH, int Co, bool tc) {
    const int es = tc ? 2 : 4, pad = tc ? 8 : 4;
    Cp = fno_round_up(C, 16);
    NHp = fno_round_up(NH, 16);
    Co8 = fno_round_up(Co, 8);
    ldw1 = Cp + pad;     // W1 [NHp][ldw1]
    ldw2 = NHp + pad;    // W2 [Co][ldw2]
    lds = HB_PIX + pad;  // S [Cp][lds], dor [Co8][lds]
    ldp = NHp + pad;     // rd(dpre1), t1 [HB_PIX][ldp]
    ldg = Cp + 4;        // dW1 sums [NHp][ldg], f32
    w1 = 0;
    w2 = w1 + fno_align16((size_t)NHp * ldw1 * es);
    b1 = w2 + fno_align16((size_t)Co * ldw2 * es);
    s = b1 + fno_align16((size_t)NHp * 4);
    dor = s + fno_align16((size_t)Cp * lds * es);
    dts = dor + fno_align16((size_t)Co8 * lds * es);  // dout [Co][HB_PIX], f32
    dps = dts + fno_align16((size_t)Co * HB_PIX * 4);
    t1 = dps + fno_align16((size_t)HB_PIX * ldp * es);
    dw1 = t1 + fno_align16((size_t)HB_PIX * ldp * es);  // W1 as given before the sums
    dw2 = dw1 + fno_align16((size_t)NHp * ldg * 4);     // dW2^T sums [NHp][Co8]
    db1 = dw2 + fno_align16((size_t)NHp * Co8 * 4);
    db2 = db1 + fno_align16((size_t)NHp * 4);
    w2raw = db2 + fno_align16((size_t)Co * 4);          // W2 as given
    // the next tile as copied: hf f32 [C][HB_PIX], dpred and std [Co][HB_PIX]
    raw = w2raw + fno_align16((size_t)Co * NH * 4);
    bytes = raw + (size_t)(C + 2 * Co) * HB_PIX * 4;
  }
};

// the sum over the lanes of one g column group (lanes t, t + 4, ..., t + 28)
__device__ __forceinline__ float col_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 4);
  v += __shfl_xor_sync(0xffffffffu, v, 8);
  v += __shfl_xor_sync(0xffffffffu, v, 16);
  return v;
}

template <bool TC>
__global__ void __launch_bounds__(HB_WARPS * 32)
head_bwd_kernel(const float* __restrict__ dpred, const float* __restrict__ hf,
                const float* __restrict__ w1t, const float* __restrict__ b1,
                const float* __restrict__ w2t, const float* __restrict__ stdv,
                float* __restrict__ dh, float* __restrict__ partial, int B, int C, int X, int Y,
                int Hp, int Wp, int NH, int Co) {
  using E = typename HeadElem<TC>::T;
  extern __shared__ __align__(16) unsigned char hb_smem[];
  const HeadBwdLayout L(C, NH, Co, TC);
  E* w1s = reinterpret_cast<E*>(hb_smem + L.w1);
  E* w2s = reinterpret_cast<E*>(hb_smem + L.w2);
  float* b1s = reinterpret_cast<float*>(hb_smem + L.b1);
  E* s = reinterpret_cast<E*>(hb_smem + L.s);
  E* dors = reinterpret_cast<E*>(hb_smem + L.dor);
  float* dts = reinterpret_cast<float*>(hb_smem + L.dts);
  E* dps = reinterpret_cast<E*>(hb_smem + L.dps);
  E* t1s = reinterpret_cast<E*>(hb_smem + L.t1);
  float* dw1a = reinterpret_cast<float*>(hb_smem + L.dw1);
  float* dw2a = reinterpret_cast<float*>(hb_smem + L.dw2);
  float* db1a = reinterpret_cast<float*>(hb_smem + L.db1);
  float* db2a = reinterpret_cast<float*>(hb_smem + L.db2);
  float* w2raw = reinterpret_cast<float*>(hb_smem + L.w2raw);
  float* raw = reinterpret_cast<float*>(hb_smem + L.raw);
  float* draw = raw + C * HB_PIX;
  float* sraw = draw + Co * HB_PIX;
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, g = lane >> 2, t = lane & 3;
  const int XY = X * Y, npix = B * XY;
  const size_t plane = (size_t)Hp * Wp;
  const int ntiles = (npix + HB_PIX - 1) / HB_PIX, p = tid % HB_PIX;

  // this thread's copies of one tile (pixel p: hf rows, dpred and std), by
  // cp.async, 4 bytes a copy (rows of the padded field need not start on 8)
  auto fetch = [&](int tile) {
    const int pix = tile * HB_PIX + p;
    if (pix < npix) {
      const Pixel px = pixel_at(pix, XY, Y, Wp);
      const float* src = hf + (size_t)px.b * C * plane + px.hw;
      for (int c = tid / HB_PIX; c < C; c += nthr / HB_PIX)
        cp_async4(raw + c * HB_PIX + p, src + c * plane);
      for (int o = tid / HB_PIX; o < Co; o += nthr / HB_PIX) {
        const int bo = px.b * Co + o;
        cp_async4(draw + o * HB_PIX + p, dpred + (size_t)bo * XY + px.xy);
        cp_async4(sraw + o * HB_PIX + p, stdv + bo);
      }
    }
    cp_async_commit();
  };
  // in flight at once: the first tile, W1 (in the dW1 sums' place until laid
  // out), W2 and b1
  if (blockIdx.x < ntiles) fetch(blockIdx.x);
  for (int i = tid; i < NH * C; i += nthr) cp_async4(dw1a + i, w1t + i);
  for (int i = tid; i < Co * NH; i += nthr) cp_async4(w2raw + i, w2t + i);
  for (int i = tid; i < L.NHp; i += nthr) {
    if (i < NH)
      cp_async4(b1s + i, b1 + i);
    else
      b1s[i] = 0.f;
  }
  // zeros over dh's pad, a plane a block: columns Y.. of rows below X, rows X..
  const int padw = Wp - Y;
  for (int bc = blockIdx.x; bc < B * C; bc += gridDim.x) {
    float* pl = dh + (size_t)bc * plane;
    for (int i = tid; i < X * padw; i += nthr) pl[i / padw * Wp + Y + i % padw] = 0.f;
    for (int i = tid; i < (Hp - X) * Wp; i += nthr) pl[X * Wp + i] = 0.f;
  }
  cp_async_wait_all();
  __syncthreads();
  stage_matrix(w1s, L.ldw1, dw1a, NH, C, L.NHp, L.Cp);
  stage_matrix(w2s, L.ldw2, w2raw, Co, NH, Co, L.NHp);
  __syncthreads();
  for (int h = warp; h < L.NHp; h += HB_WARPS)  // the block's sums zeroed
    for (int c = lane; c < L.Cp; c += 32) dw1a[h * L.ldg + c] = 0.f;
  for (int i = tid; i < L.NHp * L.Co8; i += nthr) dw2a[i] = 0.f;
  for (int i = tid; i < L.NHp; i += nthr) db1a[i] = 0.f;
  for (int i = tid; i < Co; i += nthr) db2a[i] = 0.f;

  const int K1 = TC ? L.Cp : C, K2 = TC ? L.NHp : NH, NHC = L.NHp / 16;
  const int CQ = L.Cp / 16, NOT = L.Co8 / 8;  // pairs of channel n8 tiles, output n8 tiles
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const int p0 = tile * HB_PIX;
    cp_async_wait_all();
    {  // the values this thread copied: S channels-first, dout and dor
      const bool ok = p0 + p < npix;
      for (int c = tid / HB_PIX; c < L.Cp; c += nthr / HB_PIX)
        s[c * L.lds + p] = to_elem<E>(ok && c < C ? raw[c * HB_PIX + p] : 0.f);
      for (int o = tid / HB_PIX; o < L.Co8; o += nthr / HB_PIX) {
        const float d = ok && o < Co ? draw[o * HB_PIX + p] * sraw[o * HB_PIX + p] : 0.f;
        if (o < Co) dts[o * HB_PIX + p] = d;
        dors[o * L.lds + p] = to_elem<E>(d);
      }
    }
    __syncthreads();
    if (tile + (int)gridDim.x < ntiles) fetch(tile + gridDim.x);  // in flight meanwhile

    for (int o = warp; o < Co; o += HB_WARPS) {  // db2: the tile's sum of dout
      float v = 0.f;
      for (int j = lane; j < HB_PIX; j += 32) v += dts[o * HB_PIX + j];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
      if (lane == 0) db2a[o] += v;
    }
    for (int hc = warp; hc < NHC; hc += HB_WARPS) {
      const int h0 = hc * 16;
      float s1[2][2] = {};  // this lane's db1 columns over its rows of the tile
      for (int m0 = 0; m0 < HB_PIX; m0 += 32) {  // two m16 tiles at a time
        float acc[2][2][4] = {};
        tiles_prod<2, 2, false, true>(acc, s + m0, L.lds, w1s + h0 * L.ldw1, L.ldw1, K1);
        float dt[2][2][4] = {};  // dt1 = W2^T dor, in order over o
        for (int o = 0; o < Co; ++o) {
          float d[2][2];
#pragma unroll
          for (int mt = 0; mt < 2; ++mt)
#pragma unroll
            for (int r = 0; r < 2; ++r) d[mt][r] = ldv(dors + o * L.lds + m0 + 16 * mt + g + 8 * r);
#pragma unroll
          for (int nt = 0; nt < 2; ++nt)
#pragma unroll
            for (int j = 0; j < 2; ++j) {
              const float w = ldv(w2s + o * L.ldw2 + h0 + nt * 8 + 2 * t + j);
#pragma unroll
              for (int mt = 0; mt < 2; ++mt)
#pragma unroll
                for (int r = 0; r < 2; ++r)
                  dt[mt][nt][2 * r + j] = fmaf(w, d[mt][r], dt[mt][nt][2 * r + j]);
            }
        }
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int nt = 0; nt < 2; ++nt) {
            float tv[4], dp[4];
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              float gg;
              gelu_pair(acc[mt][nt][e] + b1s[h0 + nt * 8 + 2 * t + (e & 1)], tv[e], gg);
              dp[e] = dt[mt][nt][e] * gg;
            }
#pragma unroll
            for (int r = 0; r < 2; ++r) {
              const int at = (m0 + 16 * mt + g + 8 * r) * L.ldp + h0 + nt * 8 + 2 * t;
              st_pair(t1s + at, tv[2 * r], tv[2 * r + 1]);  // rounded to bf16 on that path
              st_pair(dps + at, dp[2 * r], dp[2 * r + 1]);
            }
#pragma unroll
            for (int j = 0; j < 2; ++j) s1[nt][j] += dp[j] + dp[2 + j];
          }
      }
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const float v = col_sum(s1[nt][j]);
          if (g == 0) db1a[h0 + nt * 8 + 2 * t + j] += v;
        }
    }
    __syncthreads();

    // dW1 += rd(dpre1)^T bb and dW2^T += t1^T dor (K = the tile's pixels),
    // dbb = rd(dpre1) W1 into dh (K = NH)
    const int n1 = NHC * CQ, n2 = n1 + NHC * NOT, items = n2 + HB_PIX / 16 * CQ;
    for (int it = warp; it < items; it += HB_WARPS) {
      if (it < n1) {
        const int hm = it / CQ, cq = it - hm * CQ;
        float acc[1][2][4] = {};
        tiles_prod<1, 2, false, true>(acc, dps + hm * 16, L.ldp, s + cq * 16 * L.lds, L.lds,
                                      HB_PIX);
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            dw1a[(hm * 16 + g + 8 * (e >> 1)) * L.ldg + cq * 16 + j * 8 + 2 * t + (e & 1)] +=
                acc[0][j][e];
      } else if (it < n2) {
        const int i = it - n1, hm = i / NOT, on = i - hm * NOT;
        float acc[4] = {};
        tile_prod<false, true>(acc, t1s + hm * 16, L.ldp, dors + on * 8 * L.lds, L.lds, HB_PIX);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          dw2a[(hm * 16 + g + 8 * (e >> 1)) * L.Co8 + on * 8 + 2 * t + (e & 1)] += acc[e];
      } else {
        const int i = it - n2, pm = i / CQ, cq = i - pm * CQ;
        float acc[1][2][4] = {};
        tiles_prod<1, 2, true, false>(acc, dps + pm * 16 * L.ldp, L.ldp, w1s + cq * 16, L.ldw1,
                                      K2);
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int pix = p0 + pm * 16 + g + 8 * r;
          if (pix >= npix) continue;
          const Pixel px = pixel_at(pix, XY, Y, Wp);
#pragma unroll
          for (int j = 0; j < 2; ++j)
#pragma unroll
            for (int jj = 0; jj < 2; ++jj) {
              const int c = cq * 16 + j * 8 + 2 * t + jj;
              if (c < C) dh[((size_t)px.b * C + c) * plane + px.hw] = acc[0][j][2 * r + jj];
            }
        }
      }
    }
    __syncthreads();
  }

  __syncthreads();  // a block's sums are complete (and zero without a tile)
  float* part = partial + (size_t)blockIdx.x * (NH * C + NH + Co * NH + Co);
  for (int h = warp; h < NH; h += HB_WARPS)
    for (int c = lane; c < C; c += 32) part[h * C + c] = dw1a[h * L.ldg + c];
  part += NH * C;
  for (int h = tid; h < NH; h += nthr) part[h] = db1a[h];
  part += NH;
  for (int o = 0; o < Co; ++o)
    for (int h = tid; h < NH; h += nthr) part[o * NH + h] = dw2a[h * L.Co8 + o];
  part += Co * NH;
  for (int o = tid; o < Co; o += nthr) part[o] = db2a[o];
}

template <bool TC>
static int launch_head_bwd(const float* dpred, const float* hf, const float* w1t,
                           const float* b1, const float* w2t, const float* stdv, float* dh,
                           float* partial, int B, int C, int X, int Y, int Hp, int Wp, int NH,
                           int Co, cudaStream_t st) {
  const size_t smem = HeadBwdLayout(C, NH, Co, TC).bytes;
  cudaError_t e = fno_set_smem(head_bwd_kernel<TC>, smem);
  if (e != cudaSuccess) return (int)e;
  const int ntiles = (B * X * Y + HB_PIX - 1) / HB_PIX;
  const int grid = ntiles < 1 ? 1 : ntiles < HB_GRID ? ntiles : HB_GRID;
  head_bwd_kernel<TC><<<grid, HB_WARPS * 32, smem, st>>>(dpred, hf, w1t, b1, w2t, stdv, dh,
                                                         partial, B, C, X, Y, Hp, Wp, NH, Co);
  return (int)cudaGetLastError();
}

// Shared memory of one head_bwd_kernel block (HeadBwdLayout): the wrapper's check
// of a shape against the card's limit reads it here.
FNO_EXPORT long long fno_head_bwd_smem(int C, int NH, int Co, int bf) {
  return (long long)HeadBwdLayout(C, NH, Co, bf != 0).bytes;
}

FNO_EXPORT int fno_head_bwd(const float* dpred, const float* hf, const float* w1t,
                            const float* b1, const float* w2t, const float* stdv, float* dh,
                            float* partial, int B, int C, int X, int Y, int Hp, int Wp, int NH,
                            int Co, int bf, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  return bf ? launch_head_bwd<true>(dpred, hf, w1t, b1, w2t, stdv, dh, partial, B, C, X, Y,
                                    Hp, Wp, NH, Co, st)
            : launch_head_bwd<false>(dpred, hf, w1t, b1, w2t, stdv, dh, partial, B, C, X, Y,
                                     Hp, Wp, NH, Co, st);
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
// A block of OUTER_PB pixels keeps its A values in shared memory and takes
// Bm's channels in passes of OUTER_BT, so shared memory grows with nA only:
// (nA + min(nB, OUTER_BT)) (OUTER_PB + 1) floats, nA up to 194 at any nB
// (fno_kernels.outer names the limit).  With nB <= OUTER_BT (PASSES
// false, every call of the flagship) the body is the single pass it was
// before the passes came: the loop over passes made the compiler build the
// products' chains some 30% slower.  Each entry is the same in-order sum
// over the block's pixels either way.
// ---------------------------------------------------------------------------

constexpr int OUTER_BT = 32;  // Bm channels a pass

template <typename S, bool PASSES>
__global__ void outer_partial_kernel(const float* __restrict__ A, const S* __restrict__ Bm,
                                     int gelu, float* __restrict__ partial, int Bn, int nA,
                                     int nB, int nh, int nw, int ldhA, int ldwA, int ldhB,
                                     int ldwB, int bf) {
  extern __shared__ float sm[];
  const int LD = OUTER_PB + 1;
  float* as = sm;            // (nA, LD)
  float* bs = sm + nA * LD;  // (min(nB, OUTER_BT), LD), rounded
  const int npix = Bn * nh * nw;
  const int t = threadIdx.x, pix = blockIdx.x * OUTER_PB + t;
  const int np = nA * nB + nA;
  float* part = partial + (size_t)blockIdx.x * np;
  if constexpr (!PASSES) {
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
  } else {
    const bool ok = pix < npix;
    const int x = pix % nw, y = (pix / nw) % nh, b = pix / (nh * nw);
    for (int a = 0; a < nA; ++a)
      as[a * LD + t] = ok ? A[(((size_t)b * nA + a) * ldhA + y) * ldwA + x] : 0.f;
    for (int j0 = 0; j0 < nB; j0 += OUTER_BT) {
      const int nbt = min(OUTER_BT, nB - j0);
      if (j0 > 0) __syncthreads();  // the last pass's reads of bs are done
      for (int j = 0; j < nbt; ++j) {
        float v = 0.f;
        if (ok) {
          v = ldv(Bm + (((size_t)b * nB + j0 + j) * ldhB + y) * ldwB + x);
          if (gelu) v = gelu_f(v);
        }
        bs[j * LD + t] = rd(v, bf);
      }
      __syncthreads();
      // the pass's products, and in the first pass the sums of A after them
      // (one list of entries over the threads, as with a single pass)
      const int na = nA * nbt, n = na + (j0 == 0 ? nA : 0);
      for (int i = t; i < n; i += blockDim.x) {
        float s = 0.f;
        if (i < na) {
          const int a = i / nbt, j = i - a * nbt;
          for (int pp = 0; pp < OUTER_PB; ++pp) s += rd(as[a * LD + pp], bf) * bs[j * LD + pp];
          part[a * nB + j0 + j] = s;
        } else {
          for (int pp = 0; pp < OUTER_PB; ++pp) s += as[(i - na) * LD + pp];
          part[nA * nB + i - na] = s;
        }
      }
    }
  }
}

template <typename S, bool PASSES>
static int launch_outer_passes(const float* A, const void* Bm, int gelu, float* partial,
                               int Bn, int nA, int nB, int nh, int nw, int ldhA, int ldwA,
                               int ldhB, int ldwB, int bf, cudaStream_t st) {
  const size_t smem = (size_t)(nA + min(nB, OUTER_BT)) * (OUTER_PB + 1) * sizeof(float);
  cudaError_t e = fno_set_smem(outer_partial_kernel<S, PASSES>, smem);
  if (e != cudaSuccess) return (int)e;
  const int nblk = (Bn * nh * nw + OUTER_PB - 1) / OUTER_PB;
  outer_partial_kernel<S, PASSES><<<nblk, OUTER_PB, smem, st>>>(
      A, (const S*)Bm, gelu, partial, Bn, nA, nB, nh, nw, ldhA, ldwA, ldhB, ldwB, bf);
  return (int)cudaGetLastError();
}

template <typename S>
static int launch_outer(const float* A, const void* Bm, int gelu, float* partial, int Bn,
                        int nA, int nB, int nh, int nw, int ldhA, int ldwA, int ldhB,
                        int ldwB, int bf, cudaStream_t st) {
  return nB > OUTER_BT ? launch_outer_passes<S, true>(A, Bm, gelu, partial, Bn, nA, nB, nh, nw,
                                                      ldhA, ldwA, ldhB, ldwB, bf, st)
                       : launch_outer_passes<S, false>(A, Bm, gelu, partial, Bn, nA, nB, nh,
                                                       nw, ldhA, ldwA, ldhB, ldwB, bf, st);
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
// kernels above write.  Bound by bytes, each partial read once: 3.02 MB at
// the head backward's (256, 2946), 0.90 us at 3.35 TB/s (12.08 MB at the
// 1024 rows of its first design); the outer products' (265, 420) and
// (256, 460) are latency-bound (0.13-0.14 us of bytes).  One thread per
// column walking all rows kept 24 SMs busy, each thread a chain of 1024
// loads at the first head shape.  Here the rows are cut into RR_GROUPS fixed
// groups of ceil(rows / RR_GROUPS) consecutive rows (the last ragged, any
// past it empty): a cluster of RR_CLUSTER blocks per RR_COLS columns,
// RR_WARPS warps a block, one group a warp.  Each lane sums its column over
// its group's rows in order with RR_UNROLL loads in flight, coalesced
// across the warp's 32 columns (scalar loads: a row pitch of 2946 floats is
// not 16-byte aligned).  The block adds its warps' sums in warp order
// through shared memory, and rank 0 of the cluster adds the blocks' sums in
// rank order through distributed shared memory, as fno_stats does.  At the
// head shape that is 372 blocks of 256 threads on all 132 SMs, each group
// 8 rows.  A fixed order and no atomics: the same bits from
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
