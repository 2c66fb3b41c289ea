// The exact tier's int8 1x1 conv: a matmul ending in requant_exact
// (epilogue.cuh), one per-tensor combined scale, either RoundMode, RELU
// after the clamp.
//
// Replaces thingino_accel_tpu/ops/pallas_kernels.py matmul_int8_requant
// (Pallas body _mm_requant_kernel), kernel #9: tat_mm_int8_requant, x
// [M, K] @ w [N, K]^T -> int8 [M, N]. The exact tier's KxK convs, kernels
// #10 and #11, are conv_int8_requant_mma.cu.
//
// What bounds it on the H100: the bytes (K and N at most 512 in the
// models). Design: the 64 x 64 dp4a tile of epilogue.cuh (mma_tile),
// dp4a into int32 registers over K in 32-byte chunks staged through shared
// memory, then requant_exact and one int8 store. Tensor cores, TMA and
// tuning are later work.
#include <cstdint>

#include <cuda_runtime.h>

#include "epilogue.cuh"

namespace {

// requant_exact over the thread's 4x4 sub-tile and the one int8 write into
// the row-major [M, N] output, masked at the ragged edges.
__device__ __forceinline__ void store_tile_exact(
    const int (&acc)[4][4], int8_t* __restrict__ out, long long m0, int n0,
    long long M, int N, const int* __restrict__ bias, float cs,
    int round_mode, bool relu) {
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int n = n0 + tx + 16 * j;
    if (n >= N) continue;
    const int b = bias != nullptr ? bias[n] : 0;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const long long m = m0 + ty + 16 * i;
      if (m >= M) continue;
      out[m * N + n] = tat::requant_exact(acc[i][j], b, cs, round_mode, relu);
    }
  }
}

template <bool VEC>
__global__ void __launch_bounds__(tat::kThreads)
    mm_int8_requant_kernel(const int8_t* __restrict__ x,
                           const int8_t* __restrict__ w,
                           const int* __restrict__ bias,
                           int8_t* __restrict__ out, long long M, int N, int K,
                           float cs, int round_mode, bool relu) {
  __shared__ int As[tat::kBM][tat::kBKW + 1];
  __shared__ int Bs[tat::kBN][tat::kBKW + 1];
  const long long m0 = static_cast<long long>(blockIdx.x) * tat::kBM;
  const int n0 = blockIdx.y * tat::kBN;
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
  store_tile_exact(acc, out, m0, n0, M, N, bias, cs, round_mode, relu);
}

}  // namespace

extern "C" int tat_mm_int8_requant(const void* x, const void* w,
                                   const void* bias, void* out, long long M,
                                   int N, int K, float cs, int round_mode,
                                   int relu, void* stream) {
  const dim3 grid(static_cast<unsigned>((M + tat::kBM - 1) / tat::kBM),
                  static_cast<unsigned>((N + tat::kBN - 1) / tat::kBN));
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* xp = static_cast<const int8_t*>(x);
  const auto* wp = static_cast<const int8_t*>(w);
  const auto* bp = static_cast<const int*>(bias);
  auto* op = static_cast<int8_t*>(out);
  if (K % 4 == 0 && tat::aligned4(x) && tat::aligned4(w))
    mm_int8_requant_kernel<true><<<grid, tat::kThreads, 0, s>>>(
        xp, wp, bp, op, M, N, K, cs, round_mode, relu != 0);
  else
    mm_int8_requant_kernel<false><<<grid, tat::kThreads, 0, s>>>(
        xp, wp, bp, op, M, N, K, cs, round_mode, relu != 0);
  return static_cast<int>(cudaGetLastError());
}
