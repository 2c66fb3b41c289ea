// Shared pieces of the fused int8 conv kernels (mm_int8_fused.cu,
// conv_int8_fused.cu): the tile shape, the dp4a tile product and the
// requantize epilogue with the single int8 store.
//
// The epilogue reproduces thingino_accel_tpu/ops/fused_kernels.py
// _epilogue/_act_requant operation for operation:
//   int32 acc + int32 bias -> f32 -> x cs -> activation -> x inv_out
//   -> +-0.5 by sign -> trunc -> clamp [-128, 127]
//   -> (LEAKY_RELU only) alpha on the quantized value, truncated.
// Every multiply and add is an explicit round-to-nearest intrinsic, so
// nvcc cannot contract `scaled + 0.5` (or any other pair) into an FMA,
// which would move values that sit on a rounding tie.
#pragma once

#include <cstdint>

namespace tat {

enum Act : int { kActNone = 0, kActRelu = 1, kActLeakyRelu = 2, kActSilu = 3 };

// Block tile: kBM output rows (pixels) x kBN output channels, K walked in
// chunks of kBK int8 values (kBKW packed int32 words). 256 threads, each
// owning a 4x4 sub-tile at rows ty + 16*i and channels tx + 16*j.
constexpr int kThreads = 256;
constexpr int kBM = 64;
constexpr int kBN = 64;
constexpr int kBKW = 8;
constexpr int kBK = 4 * kBKW;

__device__ __forceinline__ int8_t epilogue(int acc, int bias, float cs, int act,
                                           float inv_out, float alpha) {
  float pre = __fmul_rn(__int2float_rn(acc + bias), cs);
  if (act == kActRelu) {
    pre = fmaxf(pre, 0.0f);
  } else if (act == kActSilu) {
    const float sig = __fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-pre)));
    pre = __fmul_rn(pre, sig);
  }
  const float scaled = __fmul_rn(pre, inv_out);
  const float shifted = __fadd_rn(scaled, scaled >= 0.0f ? 0.5f : -0.5f);
  float q = fminf(fmaxf(truncf(shifted), -128.0f), 127.0f);
  if (act == kActLeakyRelu) {
    const float neg = fmaxf(truncf(__fmul_rn(q, alpha)), -128.0f);
    q = q > 0.0f ? q : neg;
  }
  return static_cast<int8_t>(q);
}

// Four int8 values of row `row` of a row-major [rows, K] matrix starting
// at column k, packed little-endian into one word; zero past either edge.
// VEC: K % 4 == 0 and the base is 4-byte aligned, so one aligned load.
template <bool VEC>
__device__ __forceinline__ int load_row_word(const int8_t* __restrict__ p,
                                             long long row, long long rows,
                                             int K, int k) {
  if (row >= rows) return 0;
  const int8_t* r = p + row * K;
  if (VEC) return k < K ? *reinterpret_cast<const int*>(r + k) : 0;
  unsigned word = 0;
  for (int i = 0; i < 4 && k + i < K; ++i)
    word |= static_cast<unsigned>(static_cast<uint8_t>(r[k + i])) << (8 * i);
  return static_cast<int>(word);
}

// acc[i][j] += A[ty + 16i, :] . B[tx + 16j, :] over one K chunk. The row
// pitch of kBKW + 1 words keeps the 16 distinct B rows a half-warp reads
// on 16 distinct banks; the A rows are warp-wide broadcasts.
__device__ __forceinline__ void mma_tile(int (*As)[kBKW + 1],
                                         int (*Bs)[kBKW + 1],
                                         int (&acc)[4][4]) {
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int kw = 0; kw < kBKW; ++kw) {
    int a[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = As[ty + 16 * i][kw];
#pragma unroll
    for (int j = 0; j < 4; ++j) b[j] = Bs[tx + 16 * j][kw];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = __dp4a(a[i], b[j], acc[i][j]);
  }
}

// Epilogue over the thread's 4x4 sub-tile and the one int8 write into
// the row-major [M, N] output, masked at the ragged edges.
__device__ __forceinline__ void store_tile(const int (&acc)[4][4],
                                           int8_t* __restrict__ out,
                                           long long m0, int n0, long long M,
                                           int N, const int* __restrict__ bias,
                                           const float* __restrict__ cs,
                                           int act, float inv_out,
                                           float alpha) {
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int n = n0 + tx + 16 * j;
    if (n >= N) continue;
    const int b = bias != nullptr ? bias[n] : 0;
    const float c = cs[n];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const long long m = m0 + ty + 16 * i;
      if (m < M) out[m * N + n] = epilogue(acc[i][j], b, c, act, inv_out, alpha);
    }
  }
}

inline bool aligned4(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 3u) == 0;
}

}  // namespace tat
