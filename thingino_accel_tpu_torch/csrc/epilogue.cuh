// The serving and exact requantize epilogues of the port's int8 kernels,
// every one of which runs its products on the tensor cores (mma.sync s8,
// mma_tile.cuh; the probes' and E2's wgmma, hopper_async.cuh) or, for #7
// dw_int8_fused.cu, per channel; none runs dp4a.
// The serving epilogue (epilogue / act_requant) is the one the serving
// kernels apply through epilogue_policy.cuh's ServingEpilogue: the 1x1 GEMM
// mm_int8_fused_mma.cu of #1 and #3, the KxK core conv_mma_core.cuh under
// conv_int8_fused_mma.cu of #2 and #5, and on the core's product the fused
// C3 bottleneck bneck_int8_fused.cu (#6, both of its stages) and the fused
// SPPF sppf_int8_fused.cu (#4); #7 applies it after its own per-channel
// products. The exact tier's requantize (requant_exact) is the one under
// mm_int8_fused_mma.cu (#9) and conv_int8_requant_mma.cu (#10, #11). The
// probes' tensor-core chains (chain_mma.cuh, megakernel_probe.cu) and E2
// (conv_int8_lagged.cu) take the serving epilogue too.
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

enum Act : int {
  kActNone = 0,
  kActRelu = 1,
  kActLeakyRelu = 2,
  kActSilu = 3,
  kActSiluFast = 4
};

// The serving kernels' product (TAT_SERVING_COMPUTE): mma.sync s8 with
// int32 sums, or the same int8 values through mma.sync bf16 with f32 sums
// (mma_tile.cuh mma_k32_bf16).
enum Compute : int { kComputeInt8 = 0, kComputeBf16 = 1 };

// The JAX _sigmoid_fast as it computes outside a kernel (the port's
// fused_kernels.sigmoid_fast): the [5/4] Pade tanh on y = x/2 clamped to
// +-3.6333, num / den a true division, each step rounded as the JAX
// expression rounds it.
__device__ __forceinline__ float sigmoid_fast(float x) {
  const float y = fminf(fmaxf(__fmul_rn(x, 0.5f), -3.6333f), 3.6333f);
  const float y2 = __fmul_rn(y, y);
  const float y4 = __fmul_rn(y2, y2);
  const float num =
      __fmul_rn(y, __fadd_rn(__fadd_rn(945.0f, __fmul_rn(105.0f, y2)), y4));
  const float den =
      __fadd_rn(__fadd_rn(945.0f, __fmul_rn(420.0f, y2)), __fmul_rn(15.0f, y4));
  return __fadd_rn(0.5f, __fmul_rn(0.5f, __fdiv_rn(num, den)));
}

// --- rcp.approx: the hardware's approximate reciprocal (MUFU.RCP) ------------
__device__ __forceinline__ float rcp_approx(float d) {
  float r;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(d));
  return r;
}
// --- end of rcp.approx -------------------------------------------------------

// 1 / d rounded to nearest, for the SILU's d = 1 + expf(-pre) >= 1: the
// approximate reciprocal and one fused Newton step (Markstein), with no
// branch, equal to __fdiv_rn(1.0f, d) for every float d in [1, 8.5e37)
// (tests/test_torch_gpu.py checks all of them on the card); 0 above,
// where 1 / d < 1.2e-38 and pre <= -87 make pre / d round to the same
// int8 as pre x 0 does, with or without a residual. The IEEE division's
// slow-path branch kept the compiler from interleaving outputs.
__device__ __forceinline__ float recip_rn(float d) {
  const float r = rcp_approx(d);
  const float e = __fmaf_rn(-d, r, 1.0f);
  return d < 8.5e37f ? __fmaf_rn(r, e, r) : 0.0f;
}

// The residual joins after the activation and before x inv_out; the
// wrappers refuse LEAKY_RELU with a residual (its alpha applies after
// quantization), and the assert states it here. kActSiluFast is compiled
// in only with kSiluFast (the probes' kernels, and the serving kernels'
// JAX-mode kernels: ServingModeEpilogue, #7's SILU_FAST ones); the other
// kernels take the default and their code stays as it was without it.
template <bool kSiluFast = false>
__device__ __forceinline__ int8_t act_requant(float pre, int act,
                                              float inv_out, float alpha,
                                              bool has_res, int r,
                                              float res_scale) {
  if (act == kActRelu) {
    pre = fmaxf(pre, 0.0f);
  } else if (act == kActSilu) {
    const float sig = recip_rn(__fadd_rn(1.0f, expf(-pre)));
    pre = __fmul_rn(pre, sig);
  }
  if constexpr (kSiluFast) {
    if (act == kActSiluFast) pre = __fmul_rn(pre, sigmoid_fast(pre));
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

template <bool kSiluFast = false>
__device__ __forceinline__ int8_t epilogue(int acc, int bias, float cs, int act,
                                           float inv_out, float alpha,
                                           bool has_res = false, int r = 0,
                                           float res_scale = 0.0f) {
  return act_requant<kSiluFast>(__fmul_rn(__int2float_rn(acc + bias), cs), act,
                                inv_out, alpha, has_res, r, res_scale);
}

}  // namespace tat
