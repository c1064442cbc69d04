// Native-kernel probe on Hopper (sm_90a): out = x * 2 over one f32 block.
//
// Replaces the TPU kernel experiments/spectral_impl_bench.py::probe_pallas_native
// -> kern (B7), a pallas_call with interpret=False that shows whether native
// kernels compile and run on the backend at all.  Here it shows that nvcc
// built a library for this card, that ctypes bound it, and that a launch on
// PyTorch's stream runs and writes what it should.
//
// One block of 256 threads walks the n elements with a stride of 256, so
// the (8, 128) probe block is 4 elements a thread.  Bound: bytes (n * 8
// bytes read and written); at n = 1024 the launch latency is all there is.

#include <cuda_runtime.h>

#define PROBE_EXPORT extern "C" __attribute__((visibility("default")))

__global__ void probe_kernel(const float* __restrict__ x, float* __restrict__ out, int n) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) out[i] = x[i] * 2.0f;
}

PROBE_EXPORT int probe_double(const float* x, float* out, int n, void* stream) {
  probe_kernel<<<1, 256, 0, (cudaStream_t)stream>>>(x, out, n);
  return (int)cudaGetLastError();
}
