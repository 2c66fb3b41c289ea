// Fused int8 matmul for the 1x1 convs:
// out[M, N] = epilogue(x[M, K] @ w[N, K]^T [, residual[M, N]]).
//
// Replaces thingino_accel_tpu/ops/fused_kernels.py:matmul_int8_fused
// (Pallas body _mm_kernel), which keeps an int32 accumulator resident in
// VMEM across a sequential K grid axis and runs the epilogue before the
// one int8 HBM write.
//
// What bounds it on the H100: the serving 1x1 convs have K = 16..512 and
// N = 16..256 at M up to batch x 160 x 160 rows, so most are bound by
// device-memory bytes (one int8 read of x, one int8 write), not by MACs.
// Design: one block owns a 64 x 64 output tile and walks all of K in
// 32-byte chunks staged through shared memory, so the int32 accumulator
// never leaves registers (the TPU's VMEM scratch carry becomes a loop
// inside the block), and the epilogue runs in registers before a single
// int8 store. MACs are __dp4a (4 int8 products per instruction into
// int32): exact, and simple enough to be right first; tensor-core
// (mma.sync / wgmma) tiles are later work.
#include <cstdint>

#include <cuda_runtime.h>

#include "epilogue.cuh"

namespace {

template <bool VEC>
__global__ void __launch_bounds__(tat::kThreads)
    mm_int8_fused_kernel(const int8_t* __restrict__ x,
                         const int8_t* __restrict__ w,
                         const int* __restrict__ bias,
                         const float* __restrict__ cs,
                         const int8_t* __restrict__ res,
                         int8_t* __restrict__ out, long long M, int N, int K,
                         int act, float inv_out, float alpha,
                         float res_scale) {
  __shared__ int As[tat::kBM][tat::kBKW + 1];
  __shared__ int Bs[tat::kBN][tat::kBKW + 1];
  const long long m0 = static_cast<long long>(blockIdx.x) * tat::kBM;
  const int n0 = blockIdx.y * tat::kBN;
  // loader: word lw of rows lr and lr + 32 of each operand tile
  const int lw = threadIdx.x % tat::kBKW, lr = threadIdx.x / tat::kBKW;
  int acc[4][4] = {};
  for (int k0 = 0; k0 < K; k0 += tat::kBK) {
    const int k = k0 + 4 * lw;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = lr + 32 * h;
      As[r][lw] = tat::load_row_word<VEC>(x, m0 + r, M, K, K, k);
      Bs[r][lw] = tat::load_row_word<VEC>(w, n0 + r, N, K, K, k);
    }
    __syncthreads();
    tat::mma_tile(As, Bs, acc);
    __syncthreads();
  }
  tat::store_tile(acc, out, m0, n0, M, N, bias, cs, act, inv_out, alpha, res,
                  res_scale);
}

}  // namespace

extern "C" int tat_mm_int8_fused(const void* x, const void* w, const void* bias,
                                 const void* cs, const void* res, void* out,
                                 long long M, int N, int K, int act,
                                 float inv_out, float alpha, float res_scale,
                                 void* stream) {
  const dim3 grid(static_cast<unsigned>((M + tat::kBM - 1) / tat::kBM),
                  static_cast<unsigned>((N + tat::kBN - 1) / tat::kBN));
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* xp = static_cast<const int8_t*>(x);
  const auto* wp = static_cast<const int8_t*>(w);
  const auto* bp = static_cast<const int*>(bias);
  const auto* cp = static_cast<const float*>(cs);
  const auto* rp = static_cast<const int8_t*>(res);
  auto* op = static_cast<int8_t*>(out);
  if (K % 4 == 0 && tat::aligned4(x) && tat::aligned4(w))
    mm_int8_fused_kernel<true><<<grid, tat::kThreads, 0, s>>>(
        xp, wp, bp, cp, rp, op, M, N, K, act, inv_out, alpha, res_scale);
  else
    mm_int8_fused_kernel<false><<<grid, tat::kThreads, 0, s>>>(
        xp, wp, bp, cp, rp, op, M, N, K, act, inv_out, alpha, res_scale);
  return static_cast<int>(cudaGetLastError());
}
