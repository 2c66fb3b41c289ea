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
// TOP/s or 989 bf16 TFLOP/s is the limit, memory is not; with both
// operands read from shared memory, the shared memory's bandwidth at a
// narrow BN. Design (chain_mma.cuh): a block keeps its rows in shared
// memory for all L stages, as wgmma A operands, and streams the weights
// from L2 by TMA in N-chunks; the products are wgmma (s8 m64nNk32, bf16
// m64nNk16). Four variants, one template each:
//   int8   s8 x s8, (acc >> 7) as int8
//   bf16   bf16 x bf16, f32 sums, bf16(acc / 128)
//   mixed  int8 storage, bf16 products (bf16 copies of the rows and
//          weights in shared memory), clip(acc / 128, +-127) truncated
//   int4w  int8 x int4 weights: wgmma takes no s8 x s4 product, so w is
//          stored wrapped to int4 (as JAX's astype(int4) wraps) and packed
//          two a byte, unpacked to s8 in shared memory by the producer
//          warpgroup and multiplied at the s8 rate, on half the weight
//          bytes.
#include <cstdint>

#include <cuda_runtime.h>

#include "chain_mma.cuh"

namespace {

template <int G>
int run(const void* x, const void* w, void* out, long long rows, int K,
        int L, int bm, int bn, int wslots, cudaStream_t s) {
  return tat::launch_row_chain<G>(x, w, out, rows, K, L, bm, bn, wslots,
                                  tat::GlueArgs{nullptr, 0, 0.0f, 0.0f}, s);
}

template <int G>
int info(int K, int bm, int bn, int wslots, int* smem, int* blocks) {
  return tat::row_chain_info<G>(K, bm, bn, wslots, smem, blocks);
}

}  // namespace

// glue: tat::ChainGlue (kGlueShift7 int8, kGlueBf16, kGlueMixed,
// kGlueInt4w); x [rows, K] (bf16: 2 K bytes a row), w [L, K, K] (int4w:
// [L, K, K / 2] packed), out like x; the plan: bm rows a block (128, or 64
// for bf16 and mixed), bn columns a weight chunk, wslots chunks in flight.
extern "C" int tat_chain_mma(int glue, const void* x, const void* w,
                             void* out, long long rows, int K, int L, int bm,
                             int bn, int wslots, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  switch (glue) {
    case tat::kGlueShift7:
      return run<tat::kGlueShift7>(x, w, out, rows, K, L, bm, bn, wslots, s);
    case tat::kGlueBf16:
      return run<tat::kGlueBf16>(x, w, out, rows, K, L, bm, bn, wslots, s);
    case tat::kGlueMixed:
      return run<tat::kGlueMixed>(x, w, out, rows, K, L, bm, bn, wslots, s);
    case tat::kGlueInt4w:
      return run<tat::kGlueInt4w>(x, w, out, rows, K, L, bm, bn, wslots, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The dynamic shared memory of a plan and the blocks of it an SM holds;
// cudaErrorInvalidValue for a plan the kernel cannot run.
extern "C" int tat_chain_mma_info(int glue, int K, int bm, int bn,
                                  int wslots, int* smem, int* blocks) {
  switch (glue) {
    case tat::kGlueShift7:
      return info<tat::kGlueShift7>(K, bm, bn, wslots, smem, blocks);
    case tat::kGlueBf16:
      return info<tat::kGlueBf16>(K, bm, bn, wslots, smem, blocks);
    case tat::kGlueMixed:
      return info<tat::kGlueMixed>(K, bm, bn, wslots, smem, blocks);
    case tat::kGlueInt4w:
      return info<tat::kGlueInt4w>(K, bm, bn, wslots, smem, blocks);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
