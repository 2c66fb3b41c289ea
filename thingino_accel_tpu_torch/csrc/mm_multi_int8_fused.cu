// Fused int8 multi-part matmul: a 1x1 conv over a channel concat that is
// never materialized,
//   out[M, N] = epilogue(sum_i x_i[M, K_i] @ w_i[N, K_i]^T [, residual]),
// with up to kMaxParts parts (SPPF's concat has 4).
//
// Replaces thingino_accel_tpu/ops/fused_kernels.py:matmul_int8_fused_multi
// (Pallas body _mm_multi_kernel). Its two branches are kept:
// - equal part scales: one int32 accumulator over all parts, then the
//   ordinary epilogue (bias in int32, x cs);
// - different scales: each part's int32 product is converted to f32 and
//   scaled by its own s_i, the partials are summed in f32 in part order,
//   then `+ bias * bias_scale` and `x cs` (cs = w_scale [/ out_scale]),
//   then tat::act_requant. Each step is one round-to-nearest intrinsic,
//   as in the JAX order `dot_0*s_0 + dot_1*s_1 + ...`.
//
// What bounds it on the H100: the concat-consuming 1x1 convs of YOLOv5
// read K = 2 x 16..256 channels per pixel and write N = 32..512, so, as
// for the plain 1x1 matmul, the int8 reads and writes bound it, not the
// MACs. Design: the mm_int8_fused tile (one block per 64 x 64 output
// tile, dp4a into registers) walks the parts one after the other; a part
// is addressed by its own pointer and row strides, so the parts can be
// separate tensors and the weights column slices of one [N, sum K_i]
// matrix, and the concat never exists in device memory.
#include <cstdint>

#include <cuda_runtime.h>

#include "epilogue.cuh"

namespace {

constexpr int kMaxParts = 4;

struct Parts {
  const int8_t* x[kMaxParts];
  long long ldx[kMaxParts];
  const int8_t* w[kMaxParts];
  int ldw[kMaxParts];
  int K[kMaxParts];
  float s[kMaxParts];
  int n;
};

template <bool VEC>
__global__ void __launch_bounds__(tat::kThreads)
    mm_multi_int8_fused_kernel(Parts p, int same_scale,
                               const int* __restrict__ bias, float bias_scale,
                               const float* __restrict__ cs,
                               const int8_t* __restrict__ res,
                               int8_t* __restrict__ out, long long M, int N,
                               int act, float inv_out, float alpha,
                               float res_scale) {
  __shared__ int As[tat::kBM][tat::kBKW + 1];
  __shared__ int Bs[tat::kBN][tat::kBKW + 1];
  const long long m0 = static_cast<long long>(blockIdx.x) * tat::kBM;
  const int n0 = blockIdx.y * tat::kBN;
  const int lw = threadIdx.x % tat::kBKW, lr = threadIdx.x / tat::kBKW;
  int acc[4][4] = {};
  float accf[4][4] = {};
  for (int part = 0; part < p.n; ++part) {
    const int8_t* x = p.x[part];
    const int8_t* w = p.w[part];
    const long long ldx = p.ldx[part];
    const int ldw = p.ldw[part], K = p.K[part];
    for (int k0 = 0; k0 < K; k0 += tat::kBK) {
      const int k = k0 + 4 * lw;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = lr + 32 * h;
        As[r][lw] = tat::load_row_word<VEC>(x, m0 + r, M, ldx, K, k);
        Bs[r][lw] = tat::load_row_word<VEC>(w, n0 + r, N, ldw, K, k);
      }
      __syncthreads();
      tat::mma_tile(As, Bs, acc);
      __syncthreads();
    }
    if (!same_scale) {
      const float s = p.s[part];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float v = __fmul_rn(__int2float_rn(acc[i][j]), s);
          accf[i][j] = part == 0 ? v : __fadd_rn(accf[i][j], v);
          acc[i][j] = 0;
        }
    }
  }
  if (same_scale) {
    tat::store_tile(acc, out, m0, n0, M, N, bias, cs, act, inv_out, alpha,
                    res, res_scale);
    return;
  }
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const bool has_res = res != nullptr;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int n = n0 + tx + 16 * j;
    if (n >= N) continue;
    const float bf =
        __fmul_rn(__int2float_rn(bias != nullptr ? bias[n] : 0), bias_scale);
    const float c = cs[n];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const long long m = m0 + ty + 16 * i;
      if (m >= M) continue;
      const float pre = __fmul_rn(__fadd_rn(accf[i][j], bf), c);
      const int r = has_res ? res[m * N + n] : 0;
      out[m * N + n] =
          tat::act_requant(pre, act, inv_out, alpha, has_res, r, res_scale);
    }
  }
}

}  // namespace

extern "C" int tat_mm_multi_int8_fused(
    int n_parts, const void* const* xs, const long long* ldx,
    const void* const* ws, const int* ldw, const int* ks,
    const float* part_scales, int same_scale, const void* bias,
    float bias_scale, const void* cs, const void* res, void* out, long long M,
    int N, int act, float inv_out, float alpha, float res_scale,
    void* stream) {
  if (n_parts < 1 || n_parts > kMaxParts)
    return static_cast<int>(cudaErrorInvalidValue);
  Parts p = {};
  p.n = n_parts;
  bool vec = true;
  for (int i = 0; i < n_parts; ++i) {
    p.x[i] = static_cast<const int8_t*>(xs[i]);
    p.w[i] = static_cast<const int8_t*>(ws[i]);
    p.ldx[i] = ldx[i];
    p.ldw[i] = ldw[i];
    p.K[i] = ks[i];
    p.s[i] = part_scales[i];
    vec = vec && ks[i] % 4 == 0 && ldx[i] % 4 == 0 && ldw[i] % 4 == 0 &&
          tat::aligned4(xs[i]) && tat::aligned4(ws[i]);
  }
  const dim3 grid(static_cast<unsigned>((M + tat::kBM - 1) / tat::kBM),
                  static_cast<unsigned>((N + tat::kBN - 1) / tat::kBN));
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* bp = static_cast<const int*>(bias);
  const auto* cp = static_cast<const float*>(cs);
  const auto* rp = static_cast<const int8_t*>(res);
  auto* op = static_cast<int8_t*>(out);
  if (vec)
    mm_multi_int8_fused_kernel<true><<<grid, tat::kThreads, 0, s>>>(
        p, same_scale, bp, bias_scale, cp, rp, op, M, N, act, inv_out, alpha,
        res_scale);
  else
    mm_multi_int8_fused_kernel<false><<<grid, tat::kThreads, 0, s>>>(
        p, same_scale, bp, bias_scale, cp, rp, op, M, N, act, inv_out, alpha,
        res_scale);
  return static_cast<int>(cudaGetLastError());
}
