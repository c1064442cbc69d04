// One FNO layer on Hopper (sm_90a):
//   out = gelu(spectral_conv_2d_dft2(x, w1, w2) + x . pw + bias), exact f32.
//
// Replaces the TPU kernel sciml_pde_tpu/ops/spectral_fused.py::_kernel (B6),
// which holds one batch element's (H, W, C) field and every intermediate of
// the dft2 chain in VMEM.  One element's field at the flagship shape
// (130 x 130 x 20 f32, 1.35 MB) is far above the 227 KB of shared memory a
// block may use, so the layer is two kernels, channels-last throughout
// (layouts as the JAX module's; R = 2 * modes1 corner rows, K = modes2 rfft
// modes):
//
//   sf_spectrum_kernel  one thread-block cluster of P <= 16 blocks per
//                       element (above 8, Hopper's non-portable cluster
//                       size), rank p a band of ceil(H / 16) rows.  The
//                       band's rows (and their rows of the corner factor)
//                       stream through two shared-memory buffers by
//                       cp.async, RB rows at a time, so the next rows'
//                       copies fly while these compute: the W-axis partial
//                       rDFT of each row (fw^T . x_row), its w-sum split
//                       over S thread groups whose shares are added in
//                       group order, then the band's share of the corner
//                       DFT over H, accumulated in shared memory.  After a
//                       cluster barrier rank p adds every rank's share of
//                       its own corner rows, in rank order 0..P-1, through
//                       distributed shared memory (so the spectrum is formed
//                       once, in one order, and the bits repeat; no atomics,
//                       nothing through device memory) and takes the complex
//                       channel mix of those rows, w1 / w2 read straight from
//                       device memory -> yf (B, 2, R, K, O padded to a
//                       multiple of 4).  Where the band's share of the whole
//                       corner spectrum does not fit beside the buffers, the
//                       block takes it in passes over blocks of KP modes and
//                       of RP corner rows, streaming the band once a pass
//   sf_inverse_kernel   per (RT rows, WT columns, element): the inverse corner
//                       DFT at the rows, over the corner rows URC at a time,
//                       then the Hermitian-weighted inverse W step and x . pw
//                       as one product over 2K + C terms, + bias and the erf
//                       gelu; the rows of x are copied by cp.async while the
//                       inverse corner DFT runs, and the rows of out are
//                       staged in shared memory and stored 16 bytes a thread,
//                       neighbours on neighbours
//
// The wrapper (ops/spectral_fused.py::plan) chooses the rows a chunk, the
// w-sum's groups, the passes, the inverse's tile and every offset in shared
// memory for the shape, the largest that fit a block, and hands them in as a
// Plan.  A pass or a smaller tile changes no sum's order: only S does, and
// the plan fixes it per shape.
//
// Every product is an f32 FMA on the CUDA cores, whatever the module's dot
// precision: the Pallas body's einsums take no precision argument and the
// JAX module is exact f32 only.  Each thread computes a 4 x 4 register tile
// of its product (16 FMAs for one 16-byte load and four 4-byte loads of
// shared memory, where the first kernels took two loads an FMA), the
// 16-byte operands laid out padded to a multiple of four floats; the 4-byte
// ones are strided so that neighbouring lanes read neighbouring floats, for
// any channel count.  16-byte loads of x and xw too (two loads a tile)
// spilled the spectrum kernel at the 64 registers a thread of 1024 has and
// were slower on the card (PERF.md).  The
// factor matrices are the JAX module's numpy constants, handed in by the
// wrapper.
//
// Bound at the flagship layer shape (4, 130, 130, 20), modes 12: 11.8 MB of
// x, out, w1 and w2 at 3.35 TB/s and 235 MFLOP at 67 TFLOP/s f32 both give
// about 3.5 us.  The cluster kernel runs B * P blocks (60 at the flagship:
// 15 ranks of 9 rows), so the forward uses under half of the card's SMs:
// the price of summing the bands inside one launch without scratch in
// device memory.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#define SF_EXPORT extern "C" __attribute__((visibility("default")))

namespace {

constexpr int SF_NTH1 = 1024;  // threads of the spectrum kernel
constexpr int SF_NTH2 = 256;   // threads of the inverse kernel
constexpr int SF_MAX_DEVICES = 64;

// The layout of one shape, as ops/spectral_fused.py::plan lays it out (ints,
// in this order; offsets and sizes in floats, smem1 / smem2 in bytes).
struct Plan {
  int H, W, C, O, M1, K;
  // the spectrum kernel: ranks, band rows, corner rows, rows a chunk, w-sum
  // groups, modes and corner rows a pass, a rank's corner rows a pass, the
  // padded (s, k) columns of fws; the regions fws [W][MP], two chunk buffers
  // of cb floats at xb (x rows, then gh rows [RB][2][2 RP] at xg), after the
  // chunks xf [2][RR][KP C] at xb, xwp [S][RB][2 KP][C], part [2 RP][KP C]
  int P, HB, R, RB, S, KP, RP, RR, MP;
  int fws, xb, cb, xg, xwp, part, smem1;
  // the inverse kernel: rows and columns of a block, corner rows a stage, O
  // padded to 4, the row strides of xs and os; the regions yfs [URC][K][OP],
  // gis [RT][2][2R], vws [2K][up4(WT)], pws [C][OP], bs [OP],
  // yh [RT][2K][OP], xs [RT][XS], os [RT][OS]
  int RT, WT, URC, OP, XS, OS;
  int yfs, gis, vws, pws, bs, yh, xs, os, smem2;
};

__host__ __device__ constexpr int up4(int n) { return (n + 3) / 4 * 4; }

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}
// 4 bytes from src, or 0 when !ok (src is then not read)
__device__ __forceinline__ void cp4(float* dst, const float* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(ok ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}
__device__ __forceinline__ void commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void wait_group() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// n contiguous floats from src to dst (16-byte aligned) by cp.async: 16
// bytes a copy where src is 16-byte aligned and n % 4 == 0, else 4
__device__ __forceinline__ void copy_async(float* dst, const float* src, int n, int nth) {
  if (((uintptr_t)src & 15) == 0 && (n & 3) == 0) {
    for (int i = threadIdx.x; i < n / 4; i += nth) cp16(dst + 4 * i, src + 4 * i);
  } else {
    for (int i = threadIdx.x; i < n; i += nth) cp4(dst + i, src + i, true);
  }
}

// rows x cols of src (row stride ss) into dst (row stride ds >= cols) by
// cp.async, 4 bytes a copy, a warp a row; the columns [cols, ds) zero
__device__ __forceinline__ void copy_rows_async(float* dst, int ds, const float* src, int ss,
                                                int rows, int cols, int nth) {
  for (int r = threadIdx.x / 32; r < rows; r += nth / 32)
    for (int c = threadIdx.x % 32; c < ds; c += 32)
      cp4(dst + r * ds + c, c < cols ? src + (size_t)r * ss + c : src, c < cols);
}

// n contiguous floats from shared memory src to dst (16-byte aligned
// stores where dst is 16-byte aligned and n % 4 == 0)
__device__ __forceinline__ void store_rows(float* dst, const float* src, int n, int nth) {
  if (((uintptr_t)dst & 15) == 0 && (n & 3) == 0) {
    for (int i = threadIdx.x; i < n / 4; i += nth)
      reinterpret_cast<float4*>(dst)[i] = reinterpret_cast<const float4*>(src)[i];
  } else {
    for (int i = threadIdx.x; i < n; i += nth) dst[i] = src[i];
  }
}

__device__ __forceinline__ float gelu(float y) {
  return 0.5f * y * (1.f + erff(y * 0.70710678118654752f));
}

// The spectrum of one element and the mix of this rank's corner rows (see
// the note at the top).  Grid B * P blocks, clusters of P.
__global__ void __launch_bounds__(SF_NTH1, 1)
sf_spectrum_kernel(const float* __restrict__ x, const float* __restrict__ w1,
                   const float* __restrict__ w2, const float* __restrict__ fw,
                   const float* __restrict__ gh, float* __restrict__ yf, const Plan pl) {
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  const int H = pl.H, W = pl.W, C = pl.C, O = pl.O, M1 = pl.M1, K = pl.K;
  const int P = pl.P, R = pl.R, RB = pl.RB, S = pl.S, MP = pl.MP;
  const int rank = (int)cluster.block_rank(), b = blockIdx.x / P;
  const int h_lo = rank * pl.HB, rows = max(0, min(H, h_lo + pl.HB) - h_lo);
  extern __shared__ __align__(16) float sm[];
  float* fws = sm + pl.fws;    // [W][MP]: fw (W, 2, K) at the pass's (s, k), padded to MP
  float* xb = sm + pl.xb;      // 2 x cb: a chunk's rows of x [RB][W][C], then of gh
  float* xwp = sm + pl.xwp;    // [S][RB][2 kp][C]: the groups' shares of the rows' rDFT
  float* part = sm + pl.part;  // [2 rp][kp C]: the band's share of the corner spectrum
  const float* xe = x + (size_t)b * H * W * C;
  const int nch = (rows + RB - 1) / RB;

  for (int rp0 = 0; rp0 < R; rp0 += pl.RP) {
    for (int k0 = 0; k0 < K; k0 += pl.KP) {
      const int rp = min(pl.RP, R - rp0), kp = min(pl.KP, K - k0), K2 = 2 * kp, KC = kp * C;
      // a chunk's rows of x and of gh[s, h, t, rp0..rp0+rp) into buffer ch & 1
      auto stage = [&](int ch) {
        float* buf = xb + (ch & 1) * pl.cb;
        const int h1 = h_lo + ch * RB, rc = min(RB, rows - ch * RB);
        copy_async(buf, xe + (size_t)h1 * W * C, rc * W * C, SF_NTH1);
        for (int i = threadIdx.x; i < rc * 2 * 2 * rp; i += SF_NTH1) {
          const int tr = i % (2 * rp), s = (i / (2 * rp)) % 2, hh = i / (4 * rp);
          const int t = tr / rp, r = tr % rp;
          cp4(buf + pl.xg + (hh * 2 + s) * 2 * pl.RP + tr,
              gh + (((size_t)s * H + h1 + hh) * 2 + t) * R + rp0 + r, true);
        }
      };
      for (int i = threadIdx.x; i < W * MP; i += SF_NTH1) {
        const int m = i % MP, w = i / MP;
        cp4(fws + i, m < K2 ? fw + ((size_t)w * 2 + m / kp) * K + k0 + m % kp : fw, m < K2);
      }
      if (nch > 0) stage(0);
      commit();
      for (int i = threadIdx.x; i < 2 * rp * KC; i += SF_NTH1) part[i] = 0.f;

      // the rDFT's 4 x 4 tiles: (s, k) quads x 4 columns (row, c) of a chunk,
      // strided by NQ so that neighbouring lanes read neighbouring columns
      const int NQ = (RB * C + 3) / 4, tiles = up4(K2) / 4 * NQ;
      // the fold's 4 x 4 tiles: (t, r) quads x 4 (k, c) columns strided by FQ
      const int FQ = (KC + 3) / 4, ftiles = rp / 2 * FQ;
      for (int ch = 0; ch < nch; ++ch) {
        const int rc = min(RB, rows - ch * RB), n_cols = rc * C;
        const float* xc = xb + (ch & 1) * pl.cb;
        const float* ghc = xc + pl.xg;
        if (ch + 1 < nch) {  // the next chunk's copies fly while this one computes
          stage(ch + 1);
          commit();
          wait_group<1>();
        } else {
          wait_group<0>();
        }
        __syncthreads();

        // 1. xw[hh, m, c] = sum_w x[hh, w, c] fw[w, m] (m = (s, k)), the w-sum
        // split over S groups of threads, each group's share to xwp[group]
        for (int id = threadIdx.x; id < tiles * S; id += SF_NTH1) {
          const int grp = id / tiles, tile = id - grp * tiles;
          const int m0 = tile / NQ * 4, nq = tile % NQ;
          const int w0 = grp * W / S, w1e = (grp + 1) * W / S;
          int off[4];
          bool ok[4];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int col = nq + j * NQ;
            ok[j] = col < n_cols;
            off[j] = ok[j] ? col / C * W * C + col % C : 0;
          }
          float acc[4][4] = {};
          for (int w = w0; w < w1e; ++w) {
            const float4 f = *reinterpret_cast<const float4*>(fws + w * MP + m0);
            const float fv[4] = {f.x, f.y, f.z, f.w};
            float xv[4];
#pragma unroll
            for (int j = 0; j < 4; ++j) xv[j] = xc[off[j] + w * C];
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
              for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(fv[i], xv[j], acc[i][j]);
          }
          float* dst = xwp + (size_t)grp * RB * K2 * C;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            if (!ok[j]) continue;
            const int col = nq + j * NQ, hh = col / C, c = col % C;
#pragma unroll
            for (int i = 0; i < 4; ++i)
              if (m0 + i < K2) dst[(hh * K2 + m0 + i) * C + c] = acc[i][j];
          }
        }
        __syncthreads();
        // the groups' shares added in group order into group 0's
        for (int i = threadIdx.x; i < rc * K2 * C; i += SF_NTH1) {
          float v = xwp[i];
          for (int grp = 1; grp < S; ++grp) v += xwp[(size_t)grp * RB * K2 * C + i];
          xwp[i] = v;
        }
        __syncthreads();

        // 2. part[t r, k c] += sum_{hh, s} gh[s, h, t, r] xw[hh, s, k c]
        for (int tile = threadIdx.x; tile < ftiles; tile += SF_NTH1) {
          const int tr0 = tile / FQ * 4, nq = tile % FQ;
          float acc[4][4];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int col = nq + j * FQ;
#pragma unroll
            for (int i = 0; i < 4; ++i) acc[i][j] = col < KC ? part[(tr0 + i) * KC + col] : 0.f;
          }
          for (int hs = 0; hs < 2 * rc; ++hs) {  // (hh, s)
            const float4 gv = *reinterpret_cast<const float4*>(ghc + hs * 2 * pl.RP + tr0);
            const float g4[4] = {gv.x, gv.y, gv.z, gv.w};
            float xv[4];
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              const int col = nq + j * FQ;
              xv[j] = col < KC ? xwp[hs * KC + col] : 0.f;
            }
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
              for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(g4[i], xv[j], acc[i][j]);
          }
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int col = nq + j * FQ;
            if (col < KC)
#pragma unroll
              for (int i = 0; i < 4; ++i) part[(tr0 + i) * KC + col] = acc[i][j];
          }
        }
        __syncthreads();  // this chunk's buffer and xwp are free
      }
      if (nch == 0) wait_group<0>();

      // 3. every rank's share of this rank's corner rows of the pass, added
      // in rank order
      cluster.sync();
      const int rr = (rp + P - 1) / P, r0 = rank * rr, nr = max(0, min(rp, r0 + rr) - r0);
      float* xf = xb;  // [2][rr][KC]: the element's spectrum at this rank's corner rows
      for (int i = threadIdx.x; i < 2 * nr * KC; i += SF_NTH1) {
        const int col = i % KC, rl = (i / KC) % nr, t = i / (KC * nr);
        float* src = part + (t * rp + r0 + rl) * KC + col;
        float v = 0.f;
        for (int q0 = 0; q0 < P; q0 += 8) {  // eight ranks' loads in flight, added in order
          float xv[8];
#pragma unroll
          for (int u = 0; u < 8; ++u)
            if (q0 + u < P) xv[u] = *cluster.map_shared_rank(src, q0 + u);
#pragma unroll
          for (int u = 0; u < 8; ++u)
            if (q0 + u < P) v = q0 + u == 0 ? xv[u] : v + xv[u];
        }
        xf[(t * rr + rl) * KC + col] = v;
      }
      cluster.sync();  // no rank leaves, or zeroes part, while another reads its shares

      // 4. the complex mix: y[r, k, o] = sum_c x[r, k, c] w[c, o, r, k] with
      // w1 for the low corner rows and w2 for the high ones, to yf (B, 2R, K,
      // OP), the columns o >= O zero
      const size_t plane = (size_t)C * O * M1 * K;  // real part, then imaginary part
      const int OP = pl.OP;
      float* yb = yf + (size_t)b * 2 * R * K * OP;
      for (int i = threadIdx.x; i < nr * kp * OP; i += SF_NTH1) {
        const int kk = i % kp, o = (i / kp) % OP, rl = i / (kp * OP);
        const int r = rp0 + r0 + rl, k = k0 + kk;
        if (o >= O) {
          yb[((size_t)r * K + k) * OP + o] = 0.f;
          yb[((size_t)(R + r) * K + k) * OP + o] = 0.f;
          continue;
        }
        const float* wsrc = r < M1 ? w1 : w2;
        const int rw = r < M1 ? r : r - M1;
        const float* xr = xf + rl * KC + kk * C;
        const float* xi = xf + (rr + rl) * KC + kk * C;
        float yr = 0.f, yi = 0.f;
        for (int c = 0; c < C; ++c) {
          const size_t wo = ((size_t)c * O + o) * M1 * K + rw * K + k;
          const float wr = wsrc[wo], wi = wsrc[plane + wo];
          yr = fmaf(xr[c], wr, fmaf(-xi[c], wi, yr));
          yi = fmaf(xr[c], wi, fmaf(xi[c], wr, yi));
        }
        yb[((size_t)r * K + k) * OP + o] = yr;
        yb[((size_t)(R + r) * K + k) * OP + o] = yi;
      }
      __syncthreads();  // xf and fws are free for the next pass
    }
  }
}

// The inverse corner DFT, the inverse W step, x . pw + bias and the gelu at
// RT rows and WT columns of one element.  Grid (ceil(H / RT) * ceil(W / WT), B).
__global__ void __launch_bounds__(SF_NTH2)
sf_inverse_kernel(const float* __restrict__ yf, const float* __restrict__ gi,
                  const float* __restrict__ vw, const float* __restrict__ x,
                  const float* __restrict__ pw, const float* __restrict__ bias,
                  float* __restrict__ out, const Plan pl) {
  const int H = pl.H, W = pl.W, C = pl.C, O = pl.O, K = pl.K;
  const int R = pl.R, OP = pl.OP, K2 = 2 * K, OQ = OP / 4, WTP = up4(pl.WT), U = 2 * R;
  const int nwt = (W + pl.WT - 1) / pl.WT, b = blockIdx.y;
  const int h0 = blockIdx.x / nwt * pl.RT, rt = min(pl.RT, H - h0);
  const int w0 = blockIdx.x % nwt * pl.WT, wt = min(pl.WT, W - w0);
  extern __shared__ __align__(16) float sm[];
  float* yfs = sm + pl.yfs;  // [URC][K][OP]: corner rows of the element's mixed spectrum
  float* gis = sm + pl.gis;  // [RT][2][2R]: gi[u, r, v, h] at the rows
  float* vws = sm + pl.vws;  // [2K][WTP]: vw (2, K, W) at the columns
  float* pws = sm + pl.pws;  // [C][OP]
  float* bs = sm + pl.bs;    // [OP]
  float* yh = sm + pl.yh;    // [RT][2K][OP]: the rows' inverse corner DFT
  float* xs = sm + pl.xs;    // [RT][XS]: the rows of x at the columns
  float* os = sm + pl.os;    // [RT][OS]: the rows of out at the columns
  const float* yb = yf + (size_t)b * U * K * OP;

  copy_async(yfs, yb, min(pl.URC, U) * K * OP, SF_NTH2);
  for (int i = threadIdx.x; i < rt * 2 * U; i += SF_NTH2) {
    const int ur = i % U, v = (i / U) % 2, hh = i / (2 * U);
    cp4(gis + i, gi + ((size_t)ur * 2 + v) * H + h0 + hh, true);
  }
  copy_rows_async(vws, WTP, vw + w0, W, K2, wt, SF_NTH2);
  copy_rows_async(pws, OP, pw, O, C, O, SF_NTH2);
  copy_rows_async(bs, OP, bias, O, 1, O, SF_NTH2);
  commit();
  for (int hh = 0; hh < rt; ++hh)
    copy_async(xs + hh * pl.XS, x + (((size_t)b * H + h0 + hh) * W + w0) * C, wt * C, SF_NTH2);
  commit();
  wait_group<1>();
  __syncthreads();

  // 1. yh[hh, v k, o] = sum_{u r} gi[u, r, v, h] yf[u r, k, o], a row (hh, v,
  // k) x 4 columns o a thread, over the corner rows URC at a time in order
  for (int u0 = 0; u0 < U; u0 += pl.URC) {
    const int nu = min(pl.URC, U - u0);
    if (u0 > 0) {
      __syncthreads();  // yfs is free
      copy_async(yfs, yb + (size_t)u0 * K * OP, nu * K * OP, SF_NTH2);
      commit();
      wait_group<0>();
      __syncthreads();
    }
    for (int id = threadIdx.x; id < rt * K2 * OQ; id += SF_NTH2) {
      const int oq = id % OQ, row = id / OQ, k = row % K, hv = row / K;  // hv = hh * 2 + v
      float4 acc = u0 > 0 ? *reinterpret_cast<const float4*>(yh + row * OP + 4 * oq)
                          : make_float4(0.f, 0.f, 0.f, 0.f);
      for (int ur = 0; ur < nu; ++ur) {
        const float g = gis[hv * U + u0 + ur];
        const float4 y = *reinterpret_cast<const float4*>(yfs + (ur * K + k) * OP + 4 * oq);
        acc.x = fmaf(g, y.x, acc.x);
        acc.y = fmaf(g, y.y, acc.y);
        acc.z = fmaf(g, y.z, acc.z);
        acc.w = fmaf(g, y.w, acc.w);
      }
      *reinterpret_cast<float4*>(yh + row * OP + 4 * oq) = acc;
    }
  }
  wait_group<0>();
  __syncthreads();

  // 2. out[hh, w, o] = gelu(sum_{v k} vw[v k, w] yh[hh, v k, o] + sum_c x[hh,
  // w, c] pw[c, o] + bias[o]): 4 columns w (strided by WQ) x 4 o a thread
  const int WQ = WTP / 4;
  for (int id = threadIdx.x; id < rt * OQ * WQ; id += SF_NTH2) {
    const int wq = id % WQ, oq = (id / WQ) % OQ, hh = id / (WQ * OQ);
    float acc[4][4] = {};  // [w][o]
    const float* yr = yh + hh * K2 * OP + 4 * oq;
    for (int m = 0; m < K2; ++m) {
      const float4 y = *reinterpret_cast<const float4*>(yr + m * OP);
      const float yv[4] = {y.x, y.y, y.z, y.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float a = vws[m * WTP + wq + j * WQ];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[j][i] = fmaf(a, yv[i], acc[j][i]);
      }
    }
    int xo[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int w = wq + j * WQ;
      xo[j] = hh * pl.XS + (w < wt ? w : 0) * C;
    }
    for (int c = 0; c < C; ++c) {
      const float4 p = *reinterpret_cast<const float4*>(pws + c * OP + 4 * oq);
      const float pv[4] = {p.x, p.y, p.z, p.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float a = xs[xo[j] + c];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[j][i] = fmaf(a, pv[i], acc[j][i]);
      }
    }
    float* orow = os + hh * pl.OS;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int w = wq + j * WQ;
      if (w >= wt) continue;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int o = 4 * oq + i;
        if (o < O) orow[w * O + o] = gelu(acc[j][i] + bs[o]);
      }
    }
  }
  __syncthreads();
  for (int hh = 0; hh < rt; ++hh)
    store_rows(out + (((size_t)b * H + h0 + hh) * W + w0) * O, os + hh * pl.OS, wt * O, SF_NTH2);
}

// The plan handed in as n ints, checked for its length and shape.
bool read_plan(const int* ints, int n, Plan* pl) {
  if (n != (int)(sizeof(Plan) / sizeof(int))) return false;
  memcpy(pl, ints, sizeof(Plan));
  return pl->H > 0 && pl->W > 0 && pl->C > 0 && pl->O > 0 && pl->M1 > 0 && pl->K > 0 &&
         pl->P > 0 && pl->RB > 0 && pl->S > 0 && pl->KP > 0 && pl->RP > 0 && pl->RT > 0 &&
         pl->WT > 0 && pl->URC > 0;
}

// Lets the two kernels take the plan's shared memory (and the spectrum
// kernel clusters above the portable 8 ranks) on the current device.  The
// attributes are per device, so each device keeps the largest it was given.
cudaError_t raise_attributes(const Plan& pl) {
  static size_t set1[SF_MAX_DEVICES], set2[SF_MAX_DEVICES];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 0 || dev >= SF_MAX_DEVICES) return cudaErrorInvalidDevice;
  if ((size_t)pl.smem1 > set1[dev]) {
    e = cudaFuncSetAttribute(sf_spectrum_kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return e;
    e = cudaFuncSetAttribute(sf_spectrum_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             pl.smem1);
    if (e != cudaSuccess) return e;
    set1[dev] = pl.smem1;
  }
  if ((size_t)pl.smem2 > set2[dev]) {
    e = cudaFuncSetAttribute(sf_inverse_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             pl.smem2);
    if (e != cudaSuccess) return e;
    set2[dev] = pl.smem2;
  }
  return cudaSuccess;
}

cudaLaunchConfig_t spectrum_config(const Plan& pl, int B, cudaLaunchAttribute* attr,
                                   cudaStream_t st) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B * pl.P);
  cfg.blockDim = dim3(SF_NTH1);
  cfg.dynamicSmemBytes = pl.smem1;
  cfg.stream = st;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = pl.P;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

}  // namespace

// The most clusters of the spectrum kernel at this plan that the card holds
// at once (cudaOccupancyMaxActiveClusters), into *clusters.
SF_EXPORT int spectral_fused_max_clusters(const int* plan, int n, int* clusters) {
  Plan pl;
  if (!read_plan(plan, n, &pl)) return (int)cudaErrorInvalidValue;
  cudaError_t e = raise_attributes(pl);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = spectrum_config(pl, 1, &attr, 0);
  return (int)cudaOccupancyMaxActiveClusters(clusters, sf_spectrum_kernel, &cfg);
}

// fw (W, 2, K), gh (2, H, 2, R), gi (2, R, 2, H), vw (2, K, W): the dft2
// factors; yf (B, 2, R, K, OP) the mixed spectrum between the two kernels,
// OP = O rounded up to a multiple of 4; plan the n ints of a Plan for the
// shape (B, H, W, C) -> O, modes (M1, K).
SF_EXPORT int spectral_fused_forward(const float* x, const float* w1, const float* w2,
                                     const float* pw, const float* bias, const float* fw,
                                     const float* gh, const float* gi, const float* vw,
                                     float* yf, float* out, int B, const int* plan, int n,
                                     void* stream) {
  Plan pl;
  if (B <= 0 || !read_plan(plan, n, &pl)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t e = raise_attributes(pl);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = spectrum_config(pl, B, &attr, st);
  e = cudaLaunchKernelEx(&cfg, sf_spectrum_kernel, x, w1, w2, fw, gh, yf, pl);
  if (e != cudaSuccess) return (int)e;
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int nwt = (pl.W + pl.WT - 1) / pl.WT;
  sf_inverse_kernel<<<dim3((pl.H + pl.RT - 1) / pl.RT * nwt, B), SF_NTH2, pl.smem2, st>>>(
      yf, gi, vw, x, pw, bias, out, pl);
  return (int)cudaGetLastError();
}
