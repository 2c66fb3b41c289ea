// The epilogue policies of the tensor-core kernels: what a lane keeps of
// one output channel (Col, loaded once a kernel), a table the block keeps
// in shared memory (kTableBytes of it, staged once a block by
// stage_table; 0: none) and the requantize of one int32 sum into int8
// (apply), on the fragments in registers:
//   - ExactEpilogue: requant_exact (epilogue.cuh; one per-tensor combined
//     scale, either RoundMode, RELU after the clamp), then the conv's
//     activation beyond RELU as a 256-entry int8 table (the activation of
//     an int8 value is a function of that value alone, so the table is
//     exact), the exact tier's #9 (mm_int8_fused_mma.cu) and #10 and #11
//     (conv_mma_core.cuh under conv_int8_requant_mma.cu);
//   - ServingEpilogue<ACT>: the serving epilogue (epilogue.cuh epilogue /
//     act_requant: per-channel cs, the act a template constant so that its
//     branches fold, a residual r x res_scale after the act), the serving
//     tier's KxK #2 and #5 (conv_mma_core.cuh under conv_int8_fused_mma.cu)
//     and 1x1 #1 and #3 (mm_int8_fused_mma.cu), and #4 and #6;
//   - ServingModeEpilogue<BF16>: the same with the act read at run time,
//     SILU_FAST among them, on the int32 sums of the s8 product or (BF16)
//     the f32 sums of the bf16 one: the JAX modes' kernels.
// Acc is the type of a policy's sums, which the product and the epilogue
// take.
// Each source that includes this header compiles its own copy (an
// anonymous namespace).
#pragma once

#include <cstdint>
#include <type_traits>

#include <cuda_runtime.h>

#include "epilogue.cuh"

// The measurement builds (no epilogue stores or no product: the split of
// the default kernels' time) compile none of the JAX modes' kernels; their
// entry points refuse a mode launch.
#if defined(TAT_GEMM_NO_STORE) || defined(TAT_GEMM_NO_PRODUCT) || \
    defined(TAT_CONV_REQUANT_NO_STORE) || defined(TAT_CONV_REQUANT_NO_PRODUCT)
#define TAT_MODE_KERNELS 0
#else
#define TAT_MODE_KERNELS 1
#endif

namespace {

// The exact tier's: requant_exact with one per-tensor cs, then the act's
// table (lut: 256 int8 values, entry q + 128 the act of q; null: none).
// Col: what a lane keeps of one of its output channels.
struct ExactEpilogue {
  using Acc = int;
  struct Params {
    float cs;
    int round_mode;
    bool relu;
    const int8_t* lut;
  };
  struct Col {
    int b;
  };
  static constexpr bool kResidual = false;
  static constexpr bool kBn16 = false;
  static constexpr int kTableBytes = 256;
  __device__ __forceinline__ static Col col(const int* __restrict__ bias,
                                            const Params&, int o, bool live) {
    return {live && bias != nullptr ? bias[o] : 0};
  }
  // the table into the block's shared memory, a byte a thread; visible
  // to the epilogue after the mainloop's first barrier
  __device__ __forceinline__ static void stage_table(const Params& p,
                                                     unsigned char* tab) {
    if (p.lut != nullptr)
      for (int i = threadIdx.x; i < kTableBytes; i += blockDim.x)
        tab[i] = static_cast<unsigned char>(p.lut[i]);
  }
  __device__ __forceinline__ static int8_t apply(int acc, const Col& c,
                                                 const Params& p, int,
                                                 const unsigned char* tab) {
    const int8_t q = tat::requant_exact(acc, c.b, p.cs, p.round_mode, p.relu);
    return p.lut != nullptr ? static_cast<int8_t>(tab[q + 128]) : q;
  }
};

// The serving tier's: per-channel cs, ACT, the residual (res null: none).
// vec_res: 16-byte residual copies (O % 16 == 0, res 16-byte aligned).
struct ServingParams {
  const float* cs;
  float inv_out, alpha;
  const int8_t* res;
  float res_scale;
  int vec_res;
};
template <int ACT>
struct ServingEpilogue {
  using Params = ServingParams;
  using Acc = int;
  static constexpr bool kSiluFast = false;
  struct Col {
    int b;
    float cs;
  };
  static constexpr bool kResidual = true;
  static constexpr bool kBn16 = true;
  static constexpr int kTableBytes = 0;
  __device__ __forceinline__ static Col col(const int* __restrict__ bias,
                                            const Params& p, int o,
                                            bool live) {
    return {live && bias != nullptr ? bias[o] : 0, live ? p.cs[o] : 0.0f};
  }
  __device__ __forceinline__ static void stage_table(const Params&,
                                                     unsigned char*) {}
  __device__ __forceinline__ static int8_t apply(int acc, const Col& c,
                                                 const Params& p, int r,
                                                 const unsigned char*) {
    return tat::epilogue(acc, c.b, c.cs, ACT, p.inv_out, p.alpha,
                         p.res != nullptr, r, p.res_scale);
  }
  // the per-part-scale branch of the multi-part 1x1 (#3): the parts' f32
  // sum, + bias x bias_scale (bf), x cs, then the act's tail
  __device__ __forceinline__ static int8_t apply_parts(float accf, float bf,
                                                       const Col& c,
                                                       const Params& p,
                                                       int r) {
    return tat::act_requant(__fmul_rn(__fadd_rn(accf, bf), c.cs), ACT,
                            p.inv_out, p.alpha, p.res != nullptr, r,
                            p.res_scale);
  }
};

// The JAX serving modes' (TAT_FAST_SILU, TAT_SERVING_COMPUTE=bf16): the
// serving epilogue with the act read at run time (SILU_FAST among them:
// act_requant<true>), one kernel for every act, so that the modes add a
// few instantiations and leave the ServingEpilogue<ACT> kernels as they
// were. BF16: the sums are the f32 sums of the bf16 product (mma_tile.cuh
// mma_k32_bf16) and the epilogue starts as the JAX _epilogue's f32
// branch, (acc + f32(bias)) x cs; else int32 sums and f32(acc + bias) x
// cs.
struct ServingModeParams : ServingParams {
  int act;
};
template <bool BF16>
struct ServingModeEpilogue {
  using Params = ServingModeParams;
  using Acc = std::conditional_t<BF16, float, int>;
  static constexpr bool kSiluFast = true;
  using Col = ServingEpilogue<tat::kActNone>::Col;
  static constexpr bool kResidual = true;
  static constexpr bool kBn16 = true;
  static constexpr int kTableBytes = 0;
  __device__ __forceinline__ static Col col(const int* __restrict__ bias,
                                            const Params& p, int o,
                                            bool live) {
    return ServingEpilogue<tat::kActNone>::col(bias, p, o, live);
  }
  __device__ __forceinline__ static void stage_table(const Params&,
                                                     unsigned char*) {}
  __device__ __forceinline__ static int8_t apply(Acc acc, const Col& c,
                                                 const Params& p, int r,
                                                 const unsigned char*) {
    float pre;
    if constexpr (BF16)
      pre = __fmul_rn(__fadd_rn(acc, __int2float_rn(c.b)), c.cs);
    else
      pre = __fmul_rn(__int2float_rn(acc + c.b), c.cs);
    return tat::act_requant<true>(pre, p.act, p.inv_out, p.alpha,
                                  p.res != nullptr, r, p.res_scale);
  }
  __device__ __forceinline__ static int8_t apply_parts(float accf, float bf,
                                                       const Col& c,
                                                       const Params& p,
                                                       int r) {
    return tat::act_requant<true>(__fmul_rn(__fadd_rn(accf, bf), c.cs),
                                  p.act, p.inv_out, p.alpha,
                                  p.res != nullptr, r, p.res_scale);
  }
};

// Does a serving launch of (act, compute) take a ServingModeEpilogue
// kernel? false for the default acts on the s8 product; err set for an
// act or product past the kernels'.
inline bool takes_mode(int act, int compute, cudaError_t& err) {
  err = cudaErrorInvalidValue;
  if (act < tat::kActNone || act > tat::kActSiluFast ||
      (compute != tat::kComputeInt8 && compute != tat::kComputeBf16))
    return false;
  err = cudaSuccess;
  return act == tat::kActSiluFast || compute == tat::kComputeBf16;
}

}  // namespace
