// The serving tier's fused int8 KxK conv on the tensor cores, NHWC x OHWI
// -> NHWC at a square stride s, dilation 1, top / left pads pt / pl, zeros
// outside the image:
//   out[n, oy, ox, o] = act_requant(
//       (sum_{ky,kx,c} x[n, oy s - pt + ky, ox s - pl + kx, c] w[o, ky, kx, c]
//        + bias[o]) cs[o], act, inv_out, alpha, [+ r[n, oy, ox, o] res_scale])
// act_requant is epilogue.cuh's, operation for operation: the act, then
// the residual, then x inv_out, +-0.5 by sign, trunc, clamp, and
// LEAKY_RELU's alpha on the quantized value (the wrappers refuse LEAKY_RELU
// with a residual).
//
// Replaces thingino_accel_tpu/ops/fused_kernels.py:
// - conv2d_int8_halo_fused (:544, call :619; also the "blockspec" call of
//   conv2d_int8_folded, :1131), kernel #2;
// - conv2d_int8_folded(pipeline="dma") (_halo_kernel_dma :817, call
//   :1069), kernel #5: the same function, its input slab of tile t + 1
//   copied into the other of two VMEM slots while tile t computes. That
//   ring is the core's slab mode here, so #2 and #5 are one kernel; the
//   wrappers keep a launch counter each, and refuse a residual on #5 as
//   JAX does. The TPU-only parts are left out: the W-phase fold into
//   channels (Mosaic has no strided slices) and the 128-lane channel
//   padding. The thin-channel stems (6x6/s2 on 3 channels, NanoDet's
//   3x3/s2 on 3), which the JAX package sends to an XLA bf16 conv, take
//   the core's im2col mode.
//
// The kernel is conv_mma_core.cuh's implicit-GEMM conv (mma.sync s8 from
// ldmatrix, a cp.async slab ring with resident weights, C-chunks, the
// im2col mode) with its ServingEpilogue<ACT>: the lane's per-channel cs
// loaded once a kernel beside its bias, ACT a template constant so that
// its branches fold, the residual copied into the staged output tile at
// the tile's last stage. No dp4a. The JAX modes take the core under
// ServingModeEpilogue<BF16> (epilogue_policy.cuh), the act at run time:
// SILU_FAST (the Pade sigmoid of TAT_FAST_SILU), and with BF16
// (TAT_SERVING_COMPUTE=bf16, the JAX compute="bf16") the same int8 values
// through mma.sync bf16 on f32 sums, the epilogue from (acc + f32(bias))
// x cs as the JAX _epilogue's f32 branch: equal to the s8 product while
// every partial sum stays below 2^24 in magnitude. Every multiply and add of the epilogue
// is an explicit round-to-nearest intrinsic and the SILU takes expf and
// __fdiv_rn (no fast-math), so the kernel equals its plain version on the
// card as the kernels it replaced did.
#include <cstdint>

#include <cuda_runtime.h>

#include "conv_mma_core.cuh"

namespace {

using ServingKernel = ConvKernel<ServingParams>;
using ModeKernel = ConvKernel<ServingModeParams>;

ServingKernel prepare_serving(int act, int mode, int tile_h, int tile_w,
                              int bn, int ck, int resident, ConvGeom& g,
                              cudaError_t& err) {
  switch (act) {
    case tat::kActNone:
      return prepare<ServingEpilogue<tat::kActNone>>(mode, tile_h, tile_w, bn,
                                                     ck, resident, g, err);
    case tat::kActRelu:
      return prepare<ServingEpilogue<tat::kActRelu>>(mode, tile_h, tile_w, bn,
                                                     ck, resident, g, err);
    case tat::kActLeakyRelu:
      return prepare<ServingEpilogue<tat::kActLeakyRelu>>(
          mode, tile_h, tile_w, bn, ck, resident, g, err);
    case tat::kActSilu:
      return prepare<ServingEpilogue<tat::kActSilu>>(mode, tile_h, tile_w, bn,
                                                     ck, resident, g, err);
    default:
      err = cudaErrorInvalidValue;
      return nullptr;
  }
}

// The kernel of the JAX modes (the act at run time) for the product
// `compute` (tat::Compute).
ModeKernel prepare_mode(int compute, int mode, int tile_h, int tile_w,
                        int bn, int ck, int resident, ConvGeom& g,
                        cudaError_t& err) {
#if TAT_MODE_KERNELS
  return compute == tat::kComputeBf16
             ? prepare<ServingModeEpilogue<true>>(mode, tile_h, tile_w, bn,
                                                  ck, resident, g, err)
             : prepare<ServingModeEpilogue<false>>(mode, tile_h, tile_w, bn,
                                                   ck, resident, g, err);
#else
  err = cudaErrorInvalidValue;
  return nullptr;
#endif
}

}  // namespace

// One launch: x NHWC [batch, H, W, C] and w OHWI [O, KH, KW, C] int8, bias
// [O] int32 or null, cs [O] f32, res NHWC [batch, OH, OW, O] int8 or null,
// out NHWC [batch, OH, OW, O] int8; the square stride, the top and left
// pads; the epilogue's act (tat::Act), inv_out, alpha and res_scale. The
// plan as tat_conv_int8_requant_mma's, bn also 16: mode 0
// slab (C % 32 == 0, x and w 16-byte aligned) or 1 im2col; tile_h x tile_w
// output pixels a tile, bn output channels a block, ck input channels a
// chunk, resident weights, tiles_per_block tiles a block; the product
// (tat::Compute: s8, or bf16 on f32 sums). Returns a cudaError_t;
// cudaErrorInvalidValue for a shape or plan it cannot run (LEAKY_RELU with
// a residual among them).
extern "C" int tat_conv_int8_fused_mma(
    const void* x, const void* w, const void* bias, const void* cs,
    const void* res, void* out, int batch, int H, int W, int C, int O,
    int KH, int KW, int stride, int pt, int pl, int OH, int OW, int act,
    float inv_out, float alpha, float res_scale, int mode, int tile_h,
    int tile_w, int bn, int ck, int resident, int tiles_per_block,
    int compute, void* stream) {
  if (batch < 1 || H < 1 || W < 1 || O < 1 || OH < 1 || OW < 1 ||
      tiles_per_block < 1 || cs == nullptr ||
      (res != nullptr && act == tat::kActLeakyRelu) ||
      (mode == kSlab && !(aligned16(x) && aligned16(w))))
    return static_cast<int>(cudaErrorInvalidValue);
  ConvGeom g = {};
  set_conv(g, C, KH, KW, stride, stride, 1, 1);
  cudaError_t err;
  const bool modal = takes_mode(act, compute, err);
  if (err != cudaSuccess) return static_cast<int>(err);
  const ServingParams ep = {
      static_cast<const float*>(cs), inv_out, alpha,
      static_cast<const int8_t*>(res), res_scale,
      O % 16 == 0 && aligned16(res)};
  // the kernel k, prepared, launched on its params p
  auto launch = [&](auto k, const auto& p) {
    if (k == nullptr) return static_cast<int>(err);
    const dim3 grid = set_run(g, batch, H, W, O, pt, pl, OH, OW,
                              tiles_per_block, x, out);
    k<<<grid, kThreads, static_cast<size_t>(g.smem),
        static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int8_t*>(x), static_cast<const int8_t*>(w),
        static_cast<const int*>(bias), static_cast<int8_t*>(out), g, p);
    return static_cast<int>(cudaGetLastError());
  };
  if (modal)
    return launch(prepare_mode(compute, mode, tile_h, tile_w, bn, ck,
                               resident, g, err),
                  ServingModeParams{ep, act});
  return launch(prepare_serving(act, mode, tile_h, tile_w, bn, ck, resident,
                                g, err),
                ep);
}

// The dynamic shared memory of a plan in bytes and the blocks of the act's
// and product's kernel an SM holds at once; cudaErrorInvalidValue for a
// plan the kernel cannot run.
extern "C" int tat_conv_int8_fused_mma_info(int act, int mode, int C, int KH,
                                            int KW, int stride, int tile_h,
                                            int tile_w, int bn, int ck,
                                            int resident, int compute,
                                            int* smem, int* blocks_per_sm) {
  ConvGeom g = {};
  set_conv(g, C, KH, KW, stride, stride, 1, 1);
  cudaError_t err;
  const bool modal = takes_mode(act, compute, err);
  if (err != cudaSuccess) return static_cast<int>(err);
  auto info = [&](auto k) {
    if (k == nullptr) return static_cast<int>(err);
    *smem = g.smem;
    return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks_per_sm, k, kThreads, static_cast<size_t>(g.smem)));
  };
  if (modal)
    return info(prepare_mode(compute, mode, tile_h, tile_w, bn, ck, resident,
                             g, err));
  return info(
      prepare_serving(act, mode, tile_h, tile_w, bn, ck, resident, g, err));
}
