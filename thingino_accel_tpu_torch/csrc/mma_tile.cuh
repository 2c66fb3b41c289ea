// Warp-level tensor-core tiles through mma.sync, with their fragments
// loaded from shared memory by ldmatrix: the tensor-core building blocks of
// the 1x1 GEMM mm_int8_fused_mma.cu, the KxK core conv_mma_core.cuh and the
// kernels on it, and the depthwise dw_int8_fused.cu; shared-memory
// addresses and cp.async for every kernel (hopper_async.cuh's wgmma kernels
// too).
//
// One MMA step covers 32 bytes of the reduction axis K: s8 x s8 -> s32, one
// mma.m16n8k32 (32 int8 values). A is a 16-row tile of 32-byte rows
// (row-major, K contiguous), B an 8-row tile of 32-byte rows holding one
// output column's K values a row (the .col operand). Both fragments follow
// the PTX ISA's tables: register r of lane (g = lane / 4, t = lane % 4)
// holds bytes 4t..4t+3 of row g + 8 (r & 1) at byte offset 16 (r >> 1),
// and the B fragment row g, bytes 4t.. at offset 16 r. C/D: register i of
// lane holds row g + 8 (i >> 1), column 2t + (i & 1).
//
// Rows are read through per-lane addresses, so a tile's rows may be any
// rows of a buffer (the 3x3 taps read shifted pixel windows this way).
// Buffers pad each row by 16 bytes: with a row pitch that is an odd
// multiple of 16 bytes modulo 128, the 8 rows an ldmatrix reads sit on
// distinct bank groups.
#pragma once

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace tat {

constexpr int kMmaStepBytes = 32;   // bytes of K per MMA step
constexpr int kRowPad = 16;         // bytes padded after each smem row

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// --- cp.async: an asynchronous global -> shared copy of 16 bytes that
// zero-fills past `src_bytes` (0 copies nothing and writes zeros). -------
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// every group but the newest N has landed (this thread's copies)
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// --- end of cp.async ------------------------------------------------------

// --- ldmatrix / mma.sync ---------------------------------------------------
// ldmatrix .x4: lane i gives the address of row i % 8 of 8x8 b16 matrix
// i / 8; register j of lane l receives 4 bytes of matrix j: row l / 4,
// bytes 4 (l % 4) .. + 3.
__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// .x2: lanes 0-15 give the addresses (the others' are not read)
__device__ __forceinline__ void ldsm_x2(unsigned (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_addr(p)));
}

// d += a (16x32 s8, row) * b (32x8 s8, col)
__device__ __forceinline__ void mma_s8(int (&d)[4], const unsigned (&a)[4],
                                       const unsigned (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// --- end of ldmatrix / mma.sync ---------------------------------------------

// 16 bytes from p[0], `bytes` of them (the rest zero), by byte loads: the
// byte path of a 16-byte copy where the source is off 16-byte alignment or
// short.
__device__ __forceinline__ uint4 load16_bytes(const int8_t* __restrict__ p,
                                              int bytes) {
  unsigned v[4] = {0, 0, 0, 0};
  for (int b = 0; b < bytes; ++b)
    v[b >> 2] |= static_cast<unsigned>(static_cast<uint8_t>(p[b]))
                 << (8 * (b & 3));
  return make_uint4(v[0], v[1], v[2], v[3]);
}

// The lane's row (0..15) and byte offset in a 16 x 32-byte A tile for
// ldsm_x4: matrices rows 0-7 / 8-15 at bytes 0-15, then at bytes 16-31.
__device__ __forceinline__ int a_lane_row(int lane) {
  return (lane & 7) + (lane & 8);
}
__device__ __forceinline__ int a_lane_byte(int lane) {
  return (lane >> 4) * 16;
}
// ... and in an 8 x 32-byte B tile for ldsm_x2: bytes 0-15, then 16-31.
__device__ __forceinline__ int b_lane_row(int lane) { return lane & 7; }
__device__ __forceinline__ int b_lane_byte(int lane) {
  return ((lane >> 3) & 1) * 16;
}

}  // namespace tat
