// One FNO layer on Hopper (sm_90a):
//   out = gelu(spectral_conv_2d_dft2(x, w1, w2) + x . pw + bias), exact f32.
//
// Replaces the TPU kernel sciml_pde_tpu/ops/spectral_fused.py::_kernel (B6),
// which holds one batch element's (H, W, C) field and every intermediate of
// the dft2 chain in VMEM.  One element's field at the flagship shape
// (130 x 130 x 20 f32, 1.35 MB) is far above the 227 KB of shared memory a
// block may use, so the layer is three kernels on row tiles, channels-last
// throughout (layouts as the JAX module's; R = 2 * modes1 corner rows,
// K = modes2 rfft modes):
//
//   sf_forward_partial  per (row tile, element): the W-axis partial rDFT of
//                       each row, then the tile's share of the corner DFT
//                       over H -> part (B, NT, 2, R, K, C)
//   sf_mix              per (corner row, element): the sum of the tiles'
//                       partials in tile order (no float atomics, so the
//                       bits repeat), then the complex channel mix read
//                       straight from w1 / w2 -> yf (B, 2, R, K, O); the
//                       (2, C, 2, O, R, K) block weight the JAX chain builds
//                       for XLA's einsum is never formed
//   sf_inverse_out      per (row tile, element): the inverse corner DFT at
//                       the tile's rows, the Hermitian-weighted inverse W
//                       step, x . pw + bias and the erf gelu, reading x once
//                       more
//
// Every product is an f32 FMA on the CUDA cores, whatever the module's dot
// precision: the Pallas body's einsums take no precision argument and the
// JAX module is exact f32 only.  The factor matrices are the JAX module's
// numpy constants, handed in by the wrapper.
//
// Bound at the flagship layer shape (4, 130, 130, 20), modes 12: 11.8 MB of
// x, out, w1 and w2 at 3.35 TB/s and 235 MFLOP at 67 TFLOP/s f32 both give
// about 3.5 us.  This first version aims at right, not at that bound.

#include <cuda_runtime.h>

#define SF_EXPORT extern "C" __attribute__((visibility("default")))
#define SF_TH 4         // rows per row tile (ROW_TILE in spectral_fused.py)
#define SF_THREADS 256

__global__ void sf_forward_partial_kernel(const float* __restrict__ x,
                                          const float* __restrict__ fw,
                                          const float* __restrict__ gh,
                                          float* __restrict__ part, int H, int W, int C,
                                          int K, int R) {
  extern __shared__ __align__(16) float sm[];
  const int tile = blockIdx.x, b = blockIdx.y, NT = gridDim.x;
  const int h0 = tile * SF_TH, th = min(SF_TH, H - h0);
  float* xs = sm;                          // (th, W, C)
  float* fws = xs + SF_TH * W * C;         // (W, 2, K)
  float* ghs = fws + W * 2 * K;            // (2, SF_TH, 2R): gh[s, h0 + hh, :, :]
  float* xws = ghs + 2 * SF_TH * 2 * R;    // (th, 2, K, C)
  const float* xb = x + ((size_t)b * H + h0) * W * C;
  for (int i = threadIdx.x; i < th * W * C; i += blockDim.x) xs[i] = xb[i];
  for (int i = threadIdx.x; i < W * 2 * K; i += blockDim.x) fws[i] = fw[i];
  for (int i = threadIdx.x; i < 2 * th * 2 * R; i += blockDim.x) {
    const int j = i % (2 * R), hh = (i / (2 * R)) % th, s = i / (2 * R * th);
    ghs[(s * SF_TH + hh) * 2 * R + j] = gh[((size_t)s * H + h0 + hh) * 2 * R + j];
  }
  __syncthreads();

  // W-axis partial rDFT of each row: xw[hh, s, k, c] = sum_w x[hh, w, c] fw[w, s, k]
  for (int i = threadIdx.x; i < th * 2 * K * C; i += blockDim.x) {
    const int c = i % C, k = (i / C) % K, s = (i / (C * K)) % 2, hh = i / (C * K * 2);
    const float* xr = xs + hh * W * C + c;
    const float* f = fws + s * K + k;
    float acc = 0.f;
    for (int w = 0; w < W; ++w) acc = fmaf(xr[w * C], f[w * 2 * K], acc);
    xws[i] = acc;
  }
  __syncthreads();

  // the tile's share of the corner DFT:
  // part[t, r, k, c] = sum_{hh, s} xw[hh, s, k, c] gh[s, h0 + hh, t, r]
  const int npart = 2 * R * K * C;
  float* pb = part + ((size_t)b * NT + tile) * npart;
  for (int i = threadIdx.x; i < npart; i += blockDim.x) {
    const int c = i % C, k = (i / C) % K, tr = i / (C * K);
    float acc = 0.f;
    for (int hh = 0; hh < th; ++hh)
      for (int s = 0; s < 2; ++s)
        acc = fmaf(xws[((hh * 2 + s) * K + k) * C + c], ghs[(s * SF_TH + hh) * 2 * R + tr], acc);
    pb[i] = acc;
  }
}

__global__ void sf_mix_kernel(const float* __restrict__ part, const float* __restrict__ w1,
                              const float* __restrict__ w2, float* __restrict__ yf, int NT,
                              int C, int O, int M1, int K) {
  extern __shared__ __align__(16) float sm[];  // (2, K, C): the spectrum at row r
  const int r = blockIdx.x, b = blockIdx.y, R = gridDim.x;
  const int kc = K * C;
  for (int i = threadIdx.x; i < 2 * kc; i += blockDim.x) {
    const int t = i / kc, j = i % kc;
    const float* p = part + (size_t)b * NT * 2 * R * kc + (size_t)(t * R + r) * kc + j;
    float acc = 0.f;
    for (int n = 0; n < NT; ++n) acc += p[(size_t)n * 2 * R * kc];
    sm[i] = acc;
  }
  __syncthreads();

  // complex mix with the corner block of row r (w1 for the low rows, w2 for
  // the high ones): y[r, k, o] = sum_c x[r, k, c] w[c, o, r, k]
  const float* wsrc = r < M1 ? w1 : w2;
  const int rr = r < M1 ? r : r - M1;
  const size_t plane = (size_t)C * O * M1 * K;  // real part, then imaginary part
  float* yb = yf + (size_t)b * 2 * R * K * O;
  for (int i = threadIdx.x; i < K * O; i += blockDim.x) {
    const int o = i % O, k = i / O;
    float yr = 0.f, yi = 0.f;
    for (int c = 0; c < C; ++c) {
      const float xr = sm[k * C + c], xi = sm[kc + k * C + c];
      const size_t wo = ((size_t)c * O + o) * M1 * K + rr * K + k;
      const float wr = wsrc[wo], wi = wsrc[plane + wo];
      yr = fmaf(xr, wr, fmaf(-xi, wi, yr));
      yi = fmaf(xr, wi, fmaf(xi, wr, yi));
    }
    yb[(r * K + k) * O + o] = yr;
    yb[((R + r) * K + k) * O + o] = yi;
  }
}

__global__ void sf_inverse_out_kernel(const float* __restrict__ yf, const float* __restrict__ gi,
                                      const float* __restrict__ vw, const float* __restrict__ x,
                                      const float* __restrict__ pw,
                                      const float* __restrict__ bias, float* __restrict__ out,
                                      int H, int W, int C, int O, int K, int R) {
  extern __shared__ __align__(16) float sm[];
  const int tile = blockIdx.x, b = blockIdx.y;
  const int h0 = tile * SF_TH, th = min(SF_TH, H - h0);
  const int nyf = 2 * R * K * O;
  float* yfs = sm;                         // (2, R, K, O)
  float* vws = yfs + nyf;                  // (2, K, W)
  float* gis = vws + 2 * K * W;            // (2, R, 2, SF_TH): gi[u, r, v, h0 + hh]
  float* yhs = gis + 2 * R * 2 * SF_TH;    // (th, 2, K, O)
  float* xs = yhs + SF_TH * 2 * K * O;     // (th, W, C)
  float* pws = xs + SF_TH * W * C;         // (C, O)
  float* bs = pws + C * O;                 // (O)
  const float* yb = yf + (size_t)b * nyf;
  for (int i = threadIdx.x; i < nyf; i += blockDim.x) yfs[i] = yb[i];
  for (int i = threadIdx.x; i < 2 * K * W; i += blockDim.x) vws[i] = vw[i];
  for (int i = threadIdx.x; i < 2 * R * 2 * th; i += blockDim.x) {
    const int hh = i % th, uvr = i / th;
    gis[uvr * SF_TH + hh] = gi[(size_t)uvr * H + h0 + hh];
  }
  const float* xb = x + ((size_t)b * H + h0) * W * C;
  for (int i = threadIdx.x; i < th * W * C; i += blockDim.x) xs[i] = xb[i];
  for (int i = threadIdx.x; i < C * O; i += blockDim.x) pws[i] = pw[i];
  for (int i = threadIdx.x; i < O; i += blockDim.x) bs[i] = bias[i];
  __syncthreads();

  // inverse corner DFT at the tile's rows:
  // yh[hh, v, k, o] = sum_{u, r} yf[u, r, k, o] gi[u, r, v, h0 + hh]
  for (int i = threadIdx.x; i < th * 2 * K * O; i += blockDim.x) {
    const int o = i % O, k = (i / O) % K, v = (i / (O * K)) % 2, hh = i / (O * K * 2);
    float acc = 0.f;
    for (int u = 0; u < 2; ++u)
      for (int r = 0; r < R; ++r)
        acc = fmaf(yfs[((u * R + r) * K + k) * O + o], gis[((u * R + r) * 2 + v) * SF_TH + hh],
                   acc);
    yhs[i] = acc;
  }
  __syncthreads();

  // Hermitian-weighted inverse W (real part), x . pw + bias, exact gelu
  float* ob = out + ((size_t)b * H + h0) * W * O;
  for (int i = threadIdx.x; i < th * W * O; i += blockDim.x) {
    const int o = i % O, w = (i / O) % W, hh = i / (O * W);
    float spec = 0.f;
    for (int v = 0; v < 2; ++v)
      for (int k = 0; k < K; ++k)
        spec = fmaf(yhs[((hh * 2 + v) * K + k) * O + o], vws[(v * K + k) * W + w], spec);
    float point = 0.f;
    const float* xr = xs + (hh * W + w) * C;
    for (int c = 0; c < C; ++c) point = fmaf(xr[c], pws[c * O + o], point);
    const float y = spec + point + bs[o];
    ob[i] = 0.5f * y * (1.f + erff(y * 0.70710678118654752f));
  }
}

static size_t sf_smem_partial(int W, int C, int K, int R) {
  return sizeof(float) * ((size_t)SF_TH * W * C + (size_t)W * 2 * K + 2 * SF_TH * 2 * R +
                          (size_t)SF_TH * 2 * K * C);
}

static size_t sf_smem_inverse(int W, int C, int O, int K, int R) {
  return sizeof(float) * ((size_t)2 * R * K * O + (size_t)2 * K * W + 2 * R * 2 * SF_TH +
                          (size_t)SF_TH * 2 * K * O + (size_t)SF_TH * W * C + (size_t)C * O + O);
}

// fw (W, 2, K), gh (2, H, 2, R), gi (2, R, 2, H), vw (2, K, W): the dft2
// factors; part (B, NT, 2, R, K, C) and yf (B, 2, R, K, O) are scratch.
SF_EXPORT int spectral_fused_forward(const float* x, const float* w1, const float* w2,
                                     const float* pw, const float* bias, const float* fw,
                                     const float* gh, const float* gi, const float* vw,
                                     float* part, float* yf, float* out, int B, int H, int W,
                                     int C, int O, int M1, int K, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int R = 2 * M1, NT = (H + SF_TH - 1) / SF_TH;
  const size_t s1 = sf_smem_partial(W, C, K, R), s2 = sizeof(float) * 2 * K * C,
               s3 = sf_smem_inverse(W, C, O, K, R);
  cudaError_t e = cudaFuncSetAttribute(sf_forward_partial_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)s1);
  if (e != cudaSuccess) return (int)e;
  e = cudaFuncSetAttribute(sf_mix_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)s2);
  if (e != cudaSuccess) return (int)e;
  e = cudaFuncSetAttribute(sf_inverse_out_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)s3);
  if (e != cudaSuccess) return (int)e;
  sf_forward_partial_kernel<<<dim3(NT, B), SF_THREADS, s1, st>>>(x, fw, gh, part, H, W, C, K, R);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  sf_mix_kernel<<<dim3(R, B), SF_THREADS, s2, st>>>(part, w1, w2, yf, NT, C, O, M1, K);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  sf_inverse_out_kernel<<<dim3(NT, B), SF_THREADS, s3, st>>>(yf, gi, vw, x, pw, bias, out, H, W,
                                                            C, O, K, R);
  return (int)cudaGetLastError();
}
