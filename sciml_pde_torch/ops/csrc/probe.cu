// Native-kernel probe on Hopper (sm_90a): out = x * 2 over one f32 block.
//
// Replaces the TPU kernel experiments/spectral_impl_bench.py::probe_pallas_native
// -> kern (B7), a pallas_call with interpret=False that shows whether native
// kernels compile and run on the backend at all.  Here it shows that nvcc
// built a library for this card, that ctypes bound it, and that a launch on
// PyTorch's stream runs and writes what it should.
//
// Each thread moves one 16-byte vector: one float4 load, * 2, one float4
// store, so every load of a block is in flight at once (a strided loop
// would make each thread's loads wait on its stores).  ceil(n / 1024)
// blocks of 256 threads, no loop; a thread whose four elements run past n,
// or every thread when x or out is not 16-byte aligned, takes its elements
// one by one.  Bound: bytes (n * 8 bytes read and written); at n = 1024 the
// launch latency is all there is.

#include <cuda_runtime.h>
#include <stdint.h>

#define PROBE_EXPORT extern "C" __attribute__((visibility("default")))

constexpr int PROBE_THREADS = 256;

__global__ void __launch_bounds__(PROBE_THREADS)
probe_kernel(const float* __restrict__ x, float* __restrict__ out, int n, int vec) {
  const long long i = ((long long)blockIdx.x * PROBE_THREADS + threadIdx.x) * 4;
  if (vec && i + 4 <= n) {
    float4 a = *reinterpret_cast<const float4*>(x + i);
    a.x *= 2.0f;
    a.y *= 2.0f;
    a.z *= 2.0f;
    a.w *= 2.0f;
    *reinterpret_cast<float4*>(out + i) = a;
    return;
  }
#pragma unroll
  for (int e = 0; e < 4; ++e)
    if (i + e < n) out[i + e] = x[i + e] * 2.0f;
}

PROBE_EXPORT int probe_double(const float* x, float* out, int n, void* stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  const int vec = ((uintptr_t)x | (uintptr_t)out) % 16 == 0;
  const unsigned blocks = (unsigned)((n + 4 * PROBE_THREADS - 1) / (4 * PROBE_THREADS));
  probe_kernel<<<blocks, PROBE_THREADS, 0, (cudaStream_t)stream>>>(x, out, n, vec);
  return (int)cudaGetLastError();
}
