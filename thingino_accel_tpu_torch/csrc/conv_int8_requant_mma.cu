// The exact tier's KxK int8 convs on the tensor cores: the implicit-GEMM
// conv of conv_mma_core.cuh (any stride (sh, sw), dilation (dh, dw) and
// top / left pads) with its ExactEpilogue, requant_exact (epilogue.cuh: one
// per-tensor combined scale, either RoundMode, the clamp, then RELU on the
// quantized value):
//   out[n, oy, ox, o] = requant_exact(sum_{ky,kx,c}
//       x[n, oy sh - pt + ky dh, ox sw - pl + kx dw, c] * w[o, ky, kx, c]
//       + bias[o])
// with zeros outside the image and exact int32 sums, then the conv's
// activation beyond RELU, where it has one, through its 256-entry table.
//
// Replaces thingino_accel_tpu/ops/pallas_kernels.py:
// - conv2d_int8_halo (:216, body _halo_kernel), kernel #10, stride and
//   dilation 1;
// - conv2d_int8 (:300) through _tapconv_call (:388, body _tapconv_kernel),
//   kernel #11, anything else. On the TPU #11 writes the KH KW shifted,
//   strided copies of the input to HBM and walks the taps as a grid axis;
//   here a tap is a shifted window of a slab in shared memory, so those
//   copies never exist. It computes what #11 computes, not how.
//
// What bounds them on the H100 (int8 operations over 1,979 TOP/s against
// bytes over 3.35 TB/s, the exact zoo yolov5s at batch 16): the 6x6/s2
// stem (C = 3, 1.1e10 operations, 72 MB) and the wide-image 3x3 convs
// (C <= 64) move bytes; the 3x3 convs from C = 128 on lean on the
// operations (1.5e10 each at stride 2, 7.6e9 at stride 1).
//
// The design (the slab ring, the im2col mode, the staged 16-byte store)
// is the core's; see conv_mma_core.cuh. How it answers the dp4a kernel it
// replaced: (1) the product is on the tensor cores; (2) copies overlap
// compute through the ring (slab mode); (3) each input pixel is fetched
// once a tile into the slab, not KH KW times, and the im2col rows are
// copied as runs or through a table, not with two divisions a word; (4)
// the stem's 3-channel gather reads contiguous slab rows, and its 32
// output channels fill its 32-wide block.
#include <cstdint>

#include <cuda_runtime.h>

#include "conv_mma_core.cuh"

// One launch: x NHWC [batch, H, W, C] and w OHWI [O, KH, KW, C] int8, bias
// [O] int32 or null, lut the activation's 256 int8 values (entry q + 128
// the act of q) or null, out NHWC [batch, OH, OW, O] int8; the conv's stride
// (sh, sw), dilation (dh, dw), top and left pads; requant_exact's cs,
// round_mode (RoundMode) and relu. The plan: mode 0 slab (C % 32 == 0, x
// and w 16-byte aligned, ck a multiple of 32 dividing C) or 1 im2col (any
// ck <= C); tile_h x tile_w output pixels a tile (64 or 128 of them,
// tile_w 8, 16 or 32), bn output channels a block (32 or 64), ck input
// channels a chunk, resident (the weights of all C loaded once a block:
// required when ck == C, and im2col mode takes it only then),
// tiles_per_block consecutive tiles of one image a block. Returns a
// cudaError_t; cudaErrorInvalidValue for a shape or plan it cannot run.
extern "C" int tat_conv_int8_requant_mma(
    const void* x, const void* w, const void* bias, const void* lut,
    void* out, int batch,
    int H, int W, int C, int O, int KH, int KW, int sh, int sw, int dh,
    int dw, int pt, int pl, int OH, int OW, float cs, int round_mode,
    int relu, int mode, int tile_h, int tile_w, int bn, int ck, int resident,
    int tiles_per_block, void* stream) {
  if (batch < 1 || H < 1 || W < 1 || O < 1 || OH < 1 || OW < 1 ||
      tiles_per_block < 1 ||
      (mode == kSlab && !(aligned16(x) && aligned16(w))))
    return static_cast<int>(cudaErrorInvalidValue);
  ConvGeom g = {};
  set_conv(g, C, KH, KW, sh, sw, dh, dw);
  cudaError_t err;
  const auto k = prepare<ExactEpilogue>(mode, tile_h, tile_w, bn, ck,
                                        resident, g, err);
  if (k == nullptr) return static_cast<int>(err);
  const dim3 grid =
      set_run(g, batch, H, W, O, pt, pl, OH, OW, tiles_per_block, x,
              out);
  const ExactEpilogue::Params ep = {cs, round_mode, relu != 0,
                                    static_cast<const int8_t*>(lut)};
  k<<<grid, kThreads, static_cast<size_t>(g.smem),
      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(x), static_cast<const int8_t*>(w),
      static_cast<const int*>(bias), static_cast<int8_t*>(out), g, ep);
  return static_cast<int>(cudaGetLastError());
}

// The dynamic shared memory of a plan in bytes (the kernel has no static
// shared memory) and the blocks of it an SM holds at once
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor); cudaErrorInvalidValue
// for a plan the kernel cannot run.
extern "C" int tat_conv_int8_requant_mma_info(
    int mode, int C, int KH, int KW, int sh, int sw, int dh, int dw,
    int tile_h, int tile_w, int bn, int ck, int resident, int* smem,
    int* blocks_per_sm) {
  ConvGeom g = {};
  set_conv(g, C, KH, KW, sh, sw, dh, dw);
  cudaError_t err;
  const auto k = prepare<ExactEpilogue>(mode, tile_h, tile_w, bn, ck,
                                        resident, g, err);
  if (k == nullptr) return static_cast<int>(err);
  *smem = g.smem;
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, k, kThreads, static_cast<size_t>(g.smem)));
}
