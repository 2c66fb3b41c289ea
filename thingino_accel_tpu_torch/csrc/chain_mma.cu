// E1, the chained-product ceiling probe: L chained [m, k] x [k, k]
// products over m * grid rows with the cheapest glue between them.
//
// Replaces examples/mxu_ceiling_probe.py:build (pallas_call :103; bodies
// _chain_kernel_int8 :47, _chain_kernel_bf16 :58, _chain_kernel_int4w :69,
// _chain_kernel_int8_in_bf16_dot :81), which held x and all L weights in
// VMEM and issued L chained MXU dots a grid cell.
//
// What bounds it on the H100: the tensor cores. 2 m k^2 L grid operations
// (1.1e11 at k = 512) against 2 m grid k bytes of x in and out: 1,979 int8
// TOP/s or 989 bf16 TFLOP/s is the limit, memory is not. Design
// (chain_mma.cuh): a block keeps its rows in shared memory for all L
// stages and streams the weights from L2 in N-chunks; the products are
// mma.sync tiles (m16n8k32 s8, m16n8k16 bf16), the simple first step; the
// full rate needs wgmma, later work. Four variants, one template each:
//   int8   s8 x s8, (acc >> 7) as int8
//   bf16   bf16 x bf16, f32 sums, bf16(acc / 128)
//   mixed  int8 storage, bf16 products, clip(acc / 128, +-127) truncated
//   int4w  int8 x int4 weights: PTX mma takes .s4 only with .s4 on both
//          sides, so w is stored wrapped to int4 (as JAX's astype(int4)
//          wraps) and packed two a byte, unpacked to s8 in shared memory
//          and multiplied at the s8 rate, on half the weight bytes.
#include <cstdint>

#include <cuda_runtime.h>

#include "chain_mma.cuh"

extern "C" int tat_chain_mma(int glue, const void* x, const void* w,
                             void* out, long long rows, int K, int L, int bm,
                             int bn, void* stream) {
  tat::RowChainArgs a{};
  a.x = static_cast<const unsigned char*>(x);
  a.w = static_cast<const unsigned char*>(w);
  a.out = static_cast<unsigned char*>(out);
  a.rows = rows;
  a.K = K;
  a.L = L;
  a.bm = bm;
  a.bn = bn;
  a.row_bytes = glue == tat::kGlueBf16 ? 2 * K : K;
  a.w_row_bytes = glue == tat::kGlueInt4w ? K / 2 : a.row_bytes;
  a.pitch = a.row_bytes + tat::kRowPad;
  const auto s = static_cast<cudaStream_t>(stream);
  switch (glue) {
    case tat::kGlueShift7:
      return tat::launch_row_chain<tat::kGlueShift7>(a, s);
    case tat::kGlueBf16:
      return tat::launch_row_chain<tat::kGlueBf16>(a, s);
    case tat::kGlueMixed:
      return tat::launch_row_chain<tat::kGlueMixed>(a, s);
    case tat::kGlueInt4w:
      return tat::launch_row_chain<tat::kGlueInt4w>(a, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
