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
//   fno_outer_partial  sum_p A[i,p] B[j,p] and sum_p A[i,p]: 1x1-conv grads
//                      (A = dpre, B = layer input) and lift grads (A = dh0,
//                      B = lift input), persistent blocks over pixel tiles on
//                      the tensor cores under bf16 dot inputs, one partial
//                      row a block (see its note)
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
// mode-mix weight gradients
//
// Replaces the mode-mix weight gradients of _full_bwd_kernel (B2,
// sciml_pde_tpu/ops/fno_fused_step.py:1062-1063) and of _layer_wgrad_el
// (B2c, :382-383): for every (c, o, kr) of spec (B, C, KR) and dspec (B, O,
// KR), dwr + i dwi = sum_b conj(spec[b, c]) * dspec[b, o].  The TPU kernel
// adds each element's term to a revisited output block over its batch grid;
// here the batch is summed in the same order, b = 0, 1, ... from zero, one
// complex product a step, each term as JAX writes it (dwr += xr gr + xi gi,
// dwi += -xi gr + xr gi, every product and sum rounded to nearest in f32, no
// contraction into FMAs), so the bits do not depend on the launch shape.
// Bound by bytes: at the flagship (B 4, C = O = 20, KR = 24 x 12 = 288) the
// f32 output is 0.92 MB, dspec 0.18 MB and the bf16 spec 92 KB, 0.36 us at
// 3.35 TB/s.  The first design ran one thread an output with the batch a
// runtime loop (4-byte loads; each spec value loaded anew by the O threads
// that share it).  Here:
//   - a thread owns (c, V consecutive kr, MW_OG consecutive o): its spec
//     values are loaded once and serve its MW_OG o's;
//   - the batch is a template argument (1, 2, 4 or 8, fully unrolled; any
//     other B runs a generic body, one b a round), and the source issues
//     every load of the thread, spec and MW_OG x B dspec vectors, before
//     its first product.  ptxas interleaves some products with the later
//     loads, as it did the first design's (chip_smoke.py phase 2 prints
//     the order from the SASS); a variant that staged every load in
//     shared memory by cp.async, all in flight by construction, was no
//     faster on the card;
//   - loads and stores are V floats wide along kr: 4 (16 bytes; the bf16
//     spec 8) when KR % 4 == 0, 2 when KR is even, 1 when it is odd;
//   - the grid is (kr vectors, o groups, c): blockIdx names the thread's
//     o group and c, so no thread divides (an index split by 64-bit
//     division cost more than the loads' order); consecutive threads take
//     consecutive kr vectors, so a warp's loads and stores are contiguous;
//     at the flagship 72 kr vectors (three warps) x 10 o groups x 20 c, 200
//     blocks, all resident at once (one wave).
// ---------------------------------------------------------------------------

constexpr int MW_OG = 2;       // o's per thread
constexpr int MW_BLOCK = 128;  // most threads a block (along kr)

template <int V>
__device__ __forceinline__ void ld_vec(float (&x)[V], const float* p) {
  if constexpr (V == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    x[0] = t.x; x[1] = t.y; x[2] = t.z; x[3] = t.w;
  } else if constexpr (V == 2) {
    const float2 t = *reinterpret_cast<const float2*>(p);
    x[0] = t.x; x[1] = t.y;
  } else {
    x[0] = *p;
  }
}

template <int V>
__device__ __forceinline__ void ld_vec(float (&x)[V], const __nv_bfloat16* p) {
  if constexpr (V == 4) {
    const uint2 t = *reinterpret_cast<const uint2*>(p);
    const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&t.x));
    const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&t.y));
    x[0] = a.x; x[1] = a.y; x[2] = b.x; x[3] = b.y;
  } else if constexpr (V == 2) {
    const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
    x[0] = a.x; x[1] = a.y;
  } else {
    x[0] = __bfloat162float(*p);
  }
}

template <int V>
__device__ __forceinline__ void st_vec(float* p, const float (&x)[V]) {
  if constexpr (V == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
  } else if constexpr (V == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(x[0], x[1]);
  } else {
    *p = x[0];
  }
}

// NB: the batch, fully unrolled (0: any B, one b a round); V: kr a thread
template <typename S, int NB, int V>
__global__ void __launch_bounds__(MW_BLOCK)
mix_wgrad_kernel(const S* __restrict__ br, const S* __restrict__ bi,
                 const float* __restrict__ dcr, const float* __restrict__ dci,
                 float* __restrict__ dwr, float* __restrict__ dwi, int B, int C, int O, int KR) {
  constexpr int NU = NB > 0 ? NB : 1;  // batches a round
  const int kv = blockIdx.x * blockDim.x + threadIdx.x;  // this thread's kr vector
  if (kv >= KR / V) return;
  const int kr = kv * V, o0 = blockIdx.y * MW_OG, c = blockIdx.z;
  float sr[MW_OG][V], si[MW_OG][V];
#pragma unroll
  for (int j = 0; j < MW_OG; ++j)
#pragma unroll
    for (int e = 0; e < V; ++e) sr[j][e] = si[j][e] = 0.f;
  for (int b0 = 0; b0 < (NB > 0 ? 1 : B); ++b0) {
    float xr[NU][V], xi[NU][V], gr[NU][MW_OG][V], gi[NU][MW_OG][V];
#pragma unroll
    for (int u = 0; u < NU; ++u) {
      const int b = b0 + u;
      const size_t xs = ((size_t)b * C + c) * KR + kr;
      ld_vec<V>(xr[u], br + xs);
      ld_vec<V>(xi[u], bi + xs);
#pragma unroll
      for (int j = 0; j < MW_OG; ++j) {  // an o past O reads O - 1 and is not stored
        const size_t gs = ((size_t)b * O + min(o0 + j, O - 1)) * KR + kr;
        ld_vec<V>(gr[u][j], dcr + gs);
        ld_vec<V>(gi[u][j], dci + gs);
      }
    }
#pragma unroll
    for (int u = 0; u < NU; ++u)
#pragma unroll
      for (int j = 0; j < MW_OG; ++j)
#pragma unroll
        for (int e = 0; e < V; ++e) {
          const float xre = xr[u][e], xie = xi[u][e], gre = gr[u][j][e], gie = gi[u][j][e];
          sr[j][e] = __fadd_rn(sr[j][e], __fadd_rn(__fmul_rn(xre, gre), __fmul_rn(xie, gie)));
          si[j][e] = __fadd_rn(si[j][e], __fadd_rn(__fmul_rn(-xie, gre), __fmul_rn(xre, gie)));
        }
  }
#pragma unroll
  for (int j = 0; j < MW_OG; ++j) {
    if (o0 + j >= O) break;
    const size_t ws = ((size_t)c * O + o0 + j) * KR + kr;
    st_vec<V>(dwr + ws, sr[j]);
    st_vec<V>(dwi + ws, si[j]);
  }
}

template <typename S, int V>
cudaError_t launch_mix_wgrad(const void* br, const void* bi, const float* dcr, const float* dci,
                             float* dwr, float* dwi, int B, int C, int O, int KR,
                             cudaStream_t st) {
  const int nv = KR / V, ng = (O + MW_OG - 1) / MW_OG;
  if (C > 65535 || ng > 65535) return cudaErrorInvalidValue;
  // a block takes up to MW_BLOCK kr vectors (whole warps) of one (c, o group)
  const int bx = nv < MW_BLOCK ? (nv + 31) / 32 * 32 : MW_BLOCK;
  const dim3 grid((nv + bx - 1) / bx, ng, C);
  const S* xr = (const S*)br;
  const S* xi = (const S*)bi;
#define MW_LAUNCH(NB) \
  mix_wgrad_kernel<S, NB, V><<<grid, bx, 0, st>>>(xr, xi, dcr, dci, dwr, dwi, B, C, O, KR)
  switch (B) {
    case 1: MW_LAUNCH(1); break;
    case 2: MW_LAUNCH(2); break;
    case 4: MW_LAUNCH(4); break;
    case 8: MW_LAUNCH(8); break;
    default: MW_LAUNCH(0);
  }
#undef MW_LAUNCH
  return cudaGetLastError();
}

template <typename S>
cudaError_t launch_mix_wgrad_v(const void* br, const void* bi, const float* dcr,
                               const float* dci, float* dwr, float* dwi, int B, int C, int O,
                               int KR, cudaStream_t st) {
  if (KR % 4 == 0) return launch_mix_wgrad<S, 4>(br, bi, dcr, dci, dwr, dwi, B, C, O, KR, st);
  if (KR % 2 == 0) return launch_mix_wgrad<S, 2>(br, bi, dcr, dci, dwr, dwi, B, C, O, KR, st);
  return launch_mix_wgrad<S, 1>(br, bi, dcr, dci, dwr, dwi, B, C, O, KR, st);
}

// Pointers 16-byte aligned (the wrapper's _aligned); B, C, O, KR >= 1.
FNO_EXPORT int fno_mix_wgrad(const void* br, const void* bi, const float* dcr,
                             const float* dci, float* dwr, float* dwi, int B, int C, int O,
                             int KR, int spec_bf16, void* stream) {
  if (B <= 0 || C <= 0 || O <= 0 || KR <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  return (int)(spec_bf16 ? launch_mix_wgrad_v<__nv_bfloat16>(br, bi, dcr, dci, dwr, dwi, B, C,
                                                             O, KR, st)
                         : launch_mix_wgrad_v<float>(br, bi, dcr, dci, dwr, dwi, B, C, O, KR,
                                                     st));
}

// ---------------------------------------------------------------------------
// outer-product partials
//
// Replaces the 1x1-conv and lift weight gradients of _full_bwd_kernel (B2,
// sciml_pde_tpu/ops/fno_fused_step.py:1066-1067, :1072-1073), _bb_bwd_kernel
// (B2b, :632-633) and _bb_wgrad_kernel (B2c, :666).  Over the region (nh, nw)
// of A (B, nA, ldhA, ldwA) f32 and Bm (B, nB, ldhB, ldwB) f32 or bf16:
//   out[i, j] = sum_p rd(A[i, p]) rd(g(Bm[j, p])),   asum[i] = sum_p A[i, p]
// with g = gelu when `gelu` is set (Bm a saved pre-activation), rd the bf16
// rounding under `default` (JAX's _dot) and asum unrounded f32 (_sum_cols).
// The TPU kernels carry both over their sequential grid in revisited output
// blocks.  At the flagship a layer's call reads 5.41 MB of dpre and 2.70 MB
// of bf16 pre (2.42 us at 3.35 TB/s) for 0.11 GFLOP: bound by bytes.  The
// first design gave each of 265 blocks 256 pixels and each thread one or
// two entries as 256-long serial chains of shared-memory FMAs, and wrote 265
// partial rows.  Here it is the small GEMM (nA x P)(P x nB), K = P pixels,
// and what a block spends is the latency of its steps per tile, not bytes
// or products, so each tile takes as few steps as it can:
//   - at most OP_GRID persistent blocks of OP_WARPS warps (a constant, not
//     the SM count, so that the bits do not depend on the card; the fewest
//     that keep the rounds of tiles the same, outer_grid) walk the tiles of
//     OP_PIX consecutive pixels, block k the tiles k, k + grid, ... in order,
//     once for each chunk of OP_BT Bm channels (one chunk for nB <= 32, every
//     call of the flagship);
//   - the threads copy a tile (A's nA rows, the chunk's Bm rows) into one of
//     OP_STAGES buffers by cp.async, the block's first OP_STAGES tiles at
//     once (all three tiles of a block at the flagship), each later one as
//     its buffer's tile is done: 16 bytes a copy where the region's runs of
//     pixels, pitch and pointer allow (a layer's call), else 8 or 4 (the
//     lift's A, rows of 128 at a pitch of 130), a bf16 value alone by a
//     plain load;
//   - warp (r, q) holds the 16 x 8 accumulator tiles of A's m16 tiles
//     OP_MW r .. OP_MW r + OP_MW - 1 against the chunk's n8 tiles, over the
//     16-pixel units q, q + ks, ... of every tile, and builds its operands
//     from the copied values itself: A rounded to bf16 as it enters the
//     fragment (and, in the first chunk, added unrounded to the lane's row
//     sums, two pixels at a time in order), Bm through gelu once a value,
//     then rounded; mma.sync m16n8k16 bf16 with f32 accumulation under
//     `default`, exact f32 FMAs in pixel order under `highest`;
//   - at a chunk's end the ks slices (and the row sums, over a row's four
//     lanes, then the slices) are added in order through shared memory
//     (rows of OP_RLD floats, written two at a time without bank conflicts)
//     into the block's partial row, which fno_reduce_rows sums in a fixed
//     order.
// Every sum runs in a fixed order and nothing is atomic: the same bits from
// launch to launch (tests/test_torch_fno_fused_step.py rehearses the order).
// Shared memory grows with nA only (OuterLayout; fno_kernels.outer names the
// widest nA); any nB and region run.
// partial row layout: [out (nA, nB) | asum (nA)]
// ---------------------------------------------------------------------------

constexpr int OP_WARPS = 4;     // warps a block
constexpr int OP_GRID = 396;    // persistent blocks at most: one partial row each
constexpr int OP_BT = 32;       // Bm channels a chunk: four n8 tiles
constexpr int OP_MW = 4;        // m16 tiles of A a warp holds
constexpr int OP_PIX = 64;      // pixels a tile
constexpr int OP_UNITS = 4;     // 16-pixel units (k16 steps) a tile
constexpr int OP_STAGES = 3;    // copy buffers: tiles in flight
constexpr int OP_LD = 72;      // a copied row's pitch in elements (f32 or bf16), OP_PIX + 8:
                               // 16-byte rows, the fragments' reads free of bank conflicts
constexpr int OP_RLD = 40;     // the k slices' sums: OP_BT + 8 floats a row (8 modulo 32 banks)
static_assert(OP_LD == OP_PIX + 8 && OP_PIX == 16 * OP_UNITS && OP_RLD == OP_BT + 8,
              "tile geometry");

// The blocks of a launch over npix pixels: ceil(tiles / rounds) for the
// rounds that OP_GRID blocks take (fno_kernels.outer_rows mirrors it).
__host__ __device__ inline int outer_grid(int npix) {
  const int ntiles = (npix + OP_PIX - 1) / OP_PIX;
  if (ntiles < 1) return 1;
  const int rounds = (ntiles + OP_GRID - 1) / OP_GRID;
  return (ntiles + rounds - 1) / rounds;
}

// Shared memory of one outer_partial_kernel block, in bytes from the start
// (fno_outer_smem exports its size; fno_kernels.outer_smem_bytes mirrors it).
struct OuterLayout {
  int MT, mrows, ks;  // A's m16 tiles, warp rows, k slices
  size_t stage, red, ared, bytes;
  __host__ __device__ OuterLayout(int nA) {
    MT = (nA + 15) / 16;
    mrows = (MT + OP_MW - 1) / OP_MW;
    ks = OP_WARPS / mrows < OP_UNITS ? OP_WARPS / mrows : OP_UNITS;
    if (ks < 1) ks = 1;
    // a stage: A [nA][OP_LD] f32, then Bm [OP_BT][OP_LD] f32 (bf16 in its first half)
    stage = fno_align16((size_t)(nA + OP_BT) * OP_LD * 4);
    red = OP_STAGES * stage;                                      // [ks][16 MT][OP_RLD] f32
    ared = red + fno_align16((size_t)ks * 16 * MT * OP_RLD * 4);  // [ks][16 MT] f32
    bytes = ared + (size_t)ks * 16 * MT * 4;
  }
};

// pixels a copy: the widest of 4, 2, 1 whose groups of consecutive pixels
// stay in one contiguous run of the region (whole planes when the region
// spans its rows, else rows) and start on that many elements' bytes
static int outer_vw(const void* base, int es, int nh, int nw, int ldh, int ldw) {
  for (int vw = 4; vw > 1; vw /= 2) {
    const bool runs = nw == ldw ? (long long)nh * nw % vw == 0 && (long long)ldh * ldw % vw == 0
                                : nw % vw == 0 && ldw % vw == 0;
    if (runs && reinterpret_cast<uintptr_t>(base) % (vw * es) == 0) return vw;
  }
  return 1;
}

// a copy of `bytes` bytes into shared memory: cp.async for 16, 8 and 4, a
// plain load and store for 2 (a bf16 value alone)
__device__ __forceinline__ void copy_bytes(void* dst, const void* src, int bytes) {
  switch (bytes) {
    case 16:
      cp_async(dst, reinterpret_cast<const float*>(src));
      break;
    case 8:
      cp_async(dst, reinterpret_cast<const __nv_bfloat16*>(src));
      break;
    case 4:
      cp_async4(reinterpret_cast<float*>(dst), reinterpret_cast<const float*>(src));
      break;
    default:
      *reinterpret_cast<uint16_t*>(dst) = *reinterpret_cast<const uint16_t*>(src);
  }
}

// rows c < n of X (., nC, ldh, ldw) from channel c0, at the tile's pixels
// p0.. (those below npix), into dst rows of OP_LD elements, vw pixels a copy
// (a group of vw pixels lies below npix whole or not at all)
template <typename T>
__device__ __forceinline__ void copy_tile(T* dst, const T* X, int nC, int c0, int n, int p0,
                                          int npix, int vw, int nh, int nw, int ldh, int ldw) {
  const int groups = OP_PIX / vw, gi = threadIdx.x % groups;
  const int pix = p0 + gi * vw;
  if (pix >= npix) return;
  const int x = pix % nw, r = pix / nw, y = r % nh, b = r / nh;
  const T* src = X + (((size_t)b * nC + c0) * ldh + y) * ldw + x;
  const size_t plane = (size_t)ldh * ldw;
  for (int c = threadIdx.x / groups; c < n; c += OP_WARPS * 32 / groups)
    copy_bytes(dst + c * OP_LD + gi * vw, src + c * plane, vw * (int)sizeof(T));
}

// two consecutive copied values of a row as f32 (f32 rows; bf16 rows as one word)
__device__ __forceinline__ float2 row_pair(const float* row, int k) {
  return *reinterpret_cast<const float2*>(row + k);
}
__device__ __forceinline__ float2 row_pair(const __nv_bfloat16* row, int k) {
  const uint32_t w = *reinterpret_cast<const uint32_t*>(row + k);
  return make_float2(__uint_as_float(w << 16), __uint_as_float(w & 0xffff0000u));
}

template <typename S, bool TC>
__global__ void __launch_bounds__(OP_WARPS * 32)
outer_partial_kernel(const float* __restrict__ A, const S* __restrict__ Bm, int gelu,
                     float* __restrict__ partial, int Bn, int nA, int nB, int nh, int nw,
                     int ldhA, int ldwA, int ldhB, int ldwB, int va, int vb) {
  extern __shared__ __align__(16) unsigned char op_smem[];
  const OuterLayout L(nA);
  float* red = reinterpret_cast<float*>(op_smem + L.red);
  float* ared = reinterpret_cast<float*>(op_smem + L.ared);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, g = lane >> 2, t = lane & 3;
  const int npix = Bn * nh * nw, ntiles = (npix + OP_PIX - 1) / OP_PIX, G = gridDim.x;
  const int mine = (int)blockIdx.x < ntiles ? (ntiles - 1 - (int)blockIdx.x) / G + 1 : 0;
  const int items = mine * ((nB + OP_BT - 1) / OP_BT);
  float* part = partial + (size_t)blockIdx.x * (nA * nB + nA);
  auto stage_a = [&](int it) {
    return reinterpret_cast<float*>(op_smem + it % OP_STAGES * L.stage);
  };
  auto stage_b = [&](int it) {
    return reinterpret_cast<S*>(op_smem + it % OP_STAGES * L.stage + (size_t)nA * OP_LD * 4);
  };
  // item it: chunk it / mine of Bm, the block's tile it % mine
  auto fetch = [&](int it) {
    const int j0 = it / mine * OP_BT, p0 = ((int)blockIdx.x + it % mine * G) * OP_PIX;
    copy_tile(stage_a(it), A, nA, 0, nA, p0, npix, va, nh, nw, ldhA, ldwA);
    copy_tile(stage_b(it), Bm, nB, j0, min(OP_BT, nB - j0), p0, npix, vb, nh, nw, ldhB, ldwB);
    cp_async_commit();
  };

  const int wr = warp / L.ks, wq = warp % L.ks;  // this warp's row of m16 tiles, k slice
  const bool mma_warp = warp < L.mrows * L.ks;
  float acc[OP_MW][4][4] = {};
  float sa[OP_MW][2] = {};  // this lane's sums of A's rows g and g + 8 of its m16 tiles
  for (int i = 0; i < OP_STAGES && i < items; ++i) fetch(i);
  for (int it = 0; it < items; ++it) {
    const int ch = it / mine, j0 = ch * OP_BT, nbt = min(OP_BT, nB - j0);
    const int pv = min(OP_PIX, npix - ((int)blockIdx.x + it % mine * G) * OP_PIX);
    // tile it landed; the tiles copied after it may still be in flight
    static_assert(OP_STAGES == 3, "the waits below");
    switch (min(items, it + OP_STAGES) - it - 1) {
      case 2: cp_async_wait<2>(); break;
      case 1: cp_async_wait<1>(); break;
      default: cp_async_wait<0>();
    }
    __syncthreads();  // tile it visible to all

    if (mma_warp) {
      const float* ra = stage_a(it);
      const S* rb = stage_b(it);
      const bool sums = ch == 0;
      for (int ku = wq; ku < OP_UNITS; ku += L.ks) {
        const int k0 = ku * 16;
        if constexpr (TC) {
          uint32_t fb[4][2];
#pragma unroll
          for (int n = 0; n < 4; ++n) {
            const int j = 8 * n + g;
            if (8 * n >= nbt) continue;
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int k = k0 + 2 * t + 8 * h;
              float2 v = make_float2(0.f, 0.f);
              if (j < nbt) v = row_pair(rb + j * OP_LD, k);
              if (k >= pv) v.x = 0.f;
              if (k + 1 >= pv) v.y = 0.f;
              if (gelu) v = make_float2(gelu_f(v.x), gelu_f(v.y));
              fb[n][h] = pack_bf16(v.x, v.y);
            }
          }
#pragma unroll
          for (int i = 0; i < OP_MW; ++i) {
            const int mt = wr * OP_MW + i;
            if (mt >= L.MT) continue;
            uint32_t fa[4];
#pragma unroll
            for (int e = 0; e < 4; ++e) {  // rows g, g + 8 at k 2t.., then at k 2t + 8..
              const int r = 16 * mt + g + 8 * (e & 1), k = k0 + 2 * t + 8 * (e >> 1);
              float2 v = make_float2(0.f, 0.f);
              if (r < nA) v = row_pair(ra + r * OP_LD, k);
              if (k >= pv) v.x = 0.f;
              if (k + 1 >= pv) v.y = 0.f;
              if (sums) sa[i][e & 1] += v.x + v.y;
              fa[e] = pack_bf16(v.x, v.y);
            }
#pragma unroll
            for (int n = 0; n < 4; ++n)
              if (8 * n < nbt) mma_bf16(acc[i][n], fa, fb[n]);
          }
        } else {
          for (int k = k0; k < k0 + 16; ++k) {
            float y[4][2];
#pragma unroll
            for (int n = 0; n < 4; ++n)
#pragma unroll
              for (int cc = 0; cc < 2; ++cc) {
                const int j = 8 * n + 2 * t + cc;
                float v = 0.f;
                if (j < nbt && k < pv) {
                  v = (float)rb[j * OP_LD + k];
                  if (gelu) v = gelu_f(v);
                }
                y[n][cc] = v;
              }
#pragma unroll
            for (int i = 0; i < OP_MW; ++i) {
              const int mt = wr * OP_MW + i;
              if (mt >= L.MT) continue;
              const int r = 16 * mt + g;
              const float x0 = r < nA && k < pv ? ra[r * OP_LD + k] : 0.f;
              const float x1 = r + 8 < nA && k < pv ? ra[(r + 8) * OP_LD + k] : 0.f;
              if (sums && t == 0) sa[i][0] += x0, sa[i][1] += x1;
#pragma unroll
              for (int n = 0; n < 4; ++n) {
                if (8 * n >= nbt) continue;
                acc[i][n][0] = fmaf(x0, y[n][0], acc[i][n][0]);
                acc[i][n][1] = fmaf(x0, y[n][1], acc[i][n][1]);
                acc[i][n][2] = fmaf(x1, y[n][0], acc[i][n][2]);
                acc[i][n][3] = fmaf(x1, y[n][1], acc[i][n][3]);
              }
            }
          }
        }
      }
    }

    if (it % mine == mine - 1) {  // the chunk's last tile: its sums into the partial row
      if (mma_warp) {
#pragma unroll
        for (int i = 0; i < OP_MW; ++i) {
          const int mt = wr * OP_MW + i;
          if (mt >= L.MT) continue;
          float* rs = red + ((size_t)wq * 16 * L.MT + 16 * mt) * OP_RLD;
#pragma unroll
          for (int n = 0; n < 4; ++n) {
#pragma unroll
            for (int h = 0; h < 2; ++h)
              st_pair(rs + (g + 8 * h) * OP_RLD + 8 * n + 2 * t, acc[i][n][2 * h],
                      acc[i][n][2 * h + 1]);
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[i][n][e] = 0.f;
          }
          if (ch == 0) {
#pragma unroll
            for (int h = 0; h < 2; ++h) {  // over the row's four lanes: (t0 + t1) + (t2 + t3)
              float v = sa[i][h];
              v += __shfl_xor_sync(0xffffffffu, v, 1);
              v += __shfl_xor_sync(0xffffffffu, v, 2);
              if (t == 0) ared[wq * 16 * L.MT + 16 * mt + g + 8 * h] = v;
            }
          }
        }
      }
      __syncthreads();
      for (int idx = tid; idx < nA * nbt; idx += OP_WARPS * 32) {
        const int a = idx / nbt, j = idx - a * nbt;
        float s = 0.f;
        for (int q = 0; q < L.ks; ++q) s += red[((size_t)q * 16 * L.MT + a) * OP_RLD + j];
        part[a * nB + j0 + j] = s;
      }
      if (ch == 0)
        for (int a = tid; a < nA; a += OP_WARPS * 32) {
          float s = 0.f;
          for (int q = 0; q < L.ks; ++q) s += ared[q * 16 * L.MT + a];
          part[nA * nB + a] = s;
        }
    }
    if (it + OP_STAGES < items) {  // the tile OP_STAGES on, into this tile's buffer
      __syncthreads();
      fetch(it + OP_STAGES);
    }
  }
  if (items == 0)  // no pixel: a row of zeros
    for (int i = tid; i < nA * nB + nA; i += OP_WARPS * 32) part[i] = 0.f;
}

template <typename S, bool TC>
static int launch_outer(const float* A, const void* Bm, int gelu, float* partial, int Bn,
                        int nA, int nB, int nh, int nw, int ldhA, int ldwA, int ldhB, int ldwB,
                        cudaStream_t st) {
  const OuterLayout L(nA);
  if (L.mrows > OP_WARPS) return (int)cudaErrorInvalidValue;  // past the layout's widest nA
  cudaError_t e = fno_set_smem(outer_partial_kernel<S, TC>, L.bytes);
  if (e != cudaSuccess) return (int)e;
  const int va = outer_vw(A, 4, nh, nw, ldhA, ldwA);
  const int vb = outer_vw(Bm, (int)sizeof(S), nh, nw, ldhB, ldwB);
  outer_partial_kernel<S, TC><<<outer_grid(Bn * nh * nw), OP_WARPS * 32, L.bytes, st>>>(
      A, (const S*)Bm, gelu, partial, Bn, nA, nB, nh, nw, ldhA, ldwA, ldhB, ldwB, va, vb);
  return (int)cudaGetLastError();
}

// Shared memory of one outer_partial_kernel block (OuterLayout): the mirror in
// fno_kernels is held to it on the card.
FNO_EXPORT long long fno_outer_smem(int nA) { return (long long)OuterLayout(nA).bytes; }

FNO_EXPORT int fno_outer_partial(const float* A, const void* Bm, int b_bf16, int gelu,
                                 float* partial, int Bn, int nA, int nB, int nh, int nw,
                                 int ldhA, int ldwA, int ldhB, int ldwB, int bf, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (b_bf16)
    return bf ? launch_outer<__nv_bfloat16, true>(A, Bm, gelu, partial, Bn, nA, nB, nh, nw,
                                                  ldhA, ldwA, ldhB, ldwB, st)
              : launch_outer<__nv_bfloat16, false>(A, Bm, gelu, partial, Bn, nA, nB, nh, nw,
                                                   ldhA, ldwA, ldhB, ldwB, st);
  return bf ? launch_outer<float, true>(A, Bm, gelu, partial, Bn, nA, nB, nh, nw, ldhA, ldwA,
                                        ldhB, ldwB, st)
            : launch_outer<float, false>(A, Bm, gelu, partial, Bn, nA, nB, nh, nw, ldhA, ldwA,
                                         ldhB, ldwB, st);
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
