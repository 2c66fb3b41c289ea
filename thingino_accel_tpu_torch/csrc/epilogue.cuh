// Shared pieces of the fused int8 conv kernels (mm_int8_fused.cu,
// conv_int8_fused.cu, mm_multi_int8_fused.cu, bneck_int8_fused.cu,
// sppf_int8_fused.cu, dw_int8_fused.cu) and of the exact tier's
// (requant_int8.cu): the tile shape, the dp4a tile product, the serving
// requantize epilogue with the single int8 store, and the exact tier's
// requantize (requant_exact).
//
// The epilogue reproduces thingino_accel_tpu/ops/fused_kernels.py
// _epilogue/_act_requant operation for operation:
//   int32 acc + int32 bias -> f32 -> x cs -> activation
//   -> [+ r * res_scale] -> x inv_out
//   -> +-0.5 by sign -> trunc -> clamp [-128, 127]
//   -> (LEAKY_RELU only) alpha on the quantized value, truncated.
// act_requant() is the tail from the f32 pre-activation on, the entry of
// the per-part-scale branch of the multi-part matmul. Every multiply and
// add is an explicit round-to-nearest intrinsic, so nvcc cannot contract
// `scaled + 0.5` (or any other pair) into an FMA, which would move values
// that sit on a rounding tie.
#pragma once

#include <cassert>
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
// bytes of the As/Bs tiles every kernel declares in static shared memory
constexpr int kStaticSmem = (kBM + kBN) * (kBKW + 1) * 4;

// The residual joins after the activation and before x inv_out; the
// wrappers refuse LEAKY_RELU with a residual (its alpha applies after
// quantization), and the assert states it here.
__device__ __forceinline__ int8_t act_requant(float pre, int act,
                                              float inv_out, float alpha,
                                              bool has_res, int r,
                                              float res_scale) {
  if (act == kActRelu) {
    pre = fmaxf(pre, 0.0f);
  } else if (act == kActSilu) {
    const float sig = __fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-pre)));
    pre = __fmul_rn(pre, sig);
  }
  if (has_res) {
    assert(act != kActLeakyRelu);
    pre = __fadd_rn(pre, __fmul_rn(__int2float_rn(r), res_scale));
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

enum RoundMode : int { kHalfAway = 0, kPlusHalfTrunc = 1 };

// The exact tier's requantize, the tail of thingino_accel_tpu/ops/
// pallas_kernels.py _mm_requant_kernel / _halo_kernel / _tapconv_kernel:
// int32 acc + bias -> f32 -> x cs (one per-tensor scale) -> + 0.5 away
// from zero (kHalfAway) or + 0.5 (kPlusHalfTrunc) -> trunc -> clamp
// [-128, 127] in f32 -> [max(q, 0)] -> int8. RELU comes AFTER the clamp,
// on the quantized value, unlike the serving epilogue's.
__device__ __forceinline__ int8_t requant_exact(int acc, int bias, float cs,
                                                int round_mode, bool relu) {
  const float scaled = __fmul_rn(__int2float_rn(acc + bias), cs);
  const float half =
      (round_mode == kPlusHalfTrunc || scaled >= 0.0f) ? 0.5f : -0.5f;
  float q = fminf(fmaxf(truncf(__fadd_rn(scaled, half)), -128.0f), 127.0f);
  if (relu) q = fmaxf(q, 0.0f);
  return static_cast<int8_t>(q);
}

__device__ __forceinline__ int8_t epilogue(int acc, int bias, float cs, int act,
                                           float inv_out, float alpha,
                                           bool has_res = false, int r = 0,
                                           float res_scale = 0.0f) {
  return act_requant(__fmul_rn(__int2float_rn(acc + bias), cs), act, inv_out,
                     alpha, has_res, r, res_scale);
}

// Four int8 values of row `row` of a row-major matrix with row stride ld
// and K columns, starting at column k, packed little-endian into one
// word; zero past either edge. VEC: K % 4 == 0, ld % 4 == 0 and the base
// is 4-byte aligned, so one aligned load.
template <bool VEC>
__device__ __forceinline__ int load_row_word(const int8_t* __restrict__ p,
                                             long long row, long long rows,
                                             long long ld, int K, int k) {
  if (row >= rows) return 0;
  const int8_t* r = p + row * ld;
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
// the row-major [M, N] output, masked at the ragged edges. `res`, when
// not null, is a row-major [M, N] int8 residual.
__device__ __forceinline__ void store_tile(
    const int (&acc)[4][4], int8_t* __restrict__ out, long long m0, int n0,
    long long M, int N, const int* __restrict__ bias,
    const float* __restrict__ cs, int act, float inv_out, float alpha,
    const int8_t* __restrict__ res = nullptr, float res_scale = 0.0f) {
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const bool has_res = res != nullptr;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int n = n0 + tx + 16 * j;
    if (n >= N) continue;
    const int b = bias != nullptr ? bias[n] : 0;
    const float c = cs[n];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const long long m = m0 + ty + 16 * i;
      if (m >= M) continue;
      const int r = has_res ? res[m * N + n] : 0;
      out[m * N + n] =
          epilogue(acc[i][j], b, c, act, inv_out, alpha, has_res, r, res_scale);
    }
  }
}

inline bool aligned4(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 3u) == 0;
}

}  // namespace tat
