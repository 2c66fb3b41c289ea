// E4, the kernel rung of the device health ladder: out = x + 1 over f32.
//
// Replaces the kernel of examples/wedge_probe.py:run_rung("pallas")
// (pallas_call :59, body k :56): f32 [256, 256] + 1, the smallest program
// of the ladder that goes through a hand-written kernel.
//
// What bounds it on the H100: bytes (4 read and 4 written an element; at
// [256, 256] the launch itself). Design: one thread an element, 256
// threads a block; nothing to stage.
#include <cuda_runtime.h>

namespace {

__global__ void add_one_kernel(const float* __restrict__ x,
                               float* __restrict__ out, long long n) {
  const long long i =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i < n) out[i] = __fadd_rn(x[i], 1.0f);
}

}  // namespace

extern "C" int tat_add_one(const void* x, void* out, long long n,
                           void* stream) {
  if (n < 1) return static_cast<int>(cudaErrorInvalidValue);
  const unsigned blocks = static_cast<unsigned>((n + 255) / 256);
  add_one_kernel<<<blocks, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(out), n);
  return static_cast<int>(cudaGetLastError());
}
