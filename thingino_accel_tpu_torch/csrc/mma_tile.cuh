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

// d += a (16x16 bf16, row) * b (16x8 bf16, col), f32 sums: register r of
// lane (g, t) holds A row g + 8 (r & 1), k 2t + 8 (r >> 1) and + 1 (the
// lower k in the low half), the B register r column g, k 2t + 8 r and + 1.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4],
                                         const unsigned (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// --- end of ldmatrix / mma.sync ---------------------------------------------

// The serving kernels' bf16 product (TAT_SERVING_COMPUTE=bf16): the int8
// values of the s8 fragments above, widened in registers, through two
// mma.sync m16n8k16 bf16 -> f32 a 32-byte K step. Every int8 value is exact
// in bf16, every product exact in f32, and every partial sum an exact
// integer while its magnitude stays below 2^24, so in that range the f32
// sums equal the int32 ones. The s8 register of lane (g, t) holds k 4t ..
// 4t + 3 (+ 16 in the second half of the step); its bytes 0, 1 become bf16
// k 2t, 2t + 1 and its bytes 2, 3 bf16 k 2t + 8, 2t + 9 of an m16n8k16
// step, in A and in B alike: the same permutation of k on both operands,
// which leaves every dot product as it is. The shared-memory layouts, the
// ldmatrix loads and the cp.async rings stay those of the s8 product.
//
// v's bytes 0, 1 as a bf16x2 register (lo) and bytes 2, 3 (hi), the lower
// byte in the low half. No conversion instruction: the f32 with bits
// 0x4B0000xx (xx = the byte ^ 0x80) is 2^23 + 128 + the value, from which
// 2^23 + 128 is subtracted exactly; a bf16 is the high half of an f32
// whose significand fits in 8 bits, as every int8 value's does.
__device__ __forceinline__ void widen_s8_bf16(unsigned v, unsigned& lo,
                                              unsigned& hi) {
  const unsigned u = v ^ 0x80808080u;
  unsigned f[4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
    f[j] = __float_as_uint(__fadd_rn(
        __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7650u + j)),
        -8388736.0f));
  lo = __byte_perm(f[0], f[1], 0x7632u);
  hi = __byte_perm(f[2], f[3], 0x7632u);
}

// An s8 B fragment's two registers as the four bf16 registers of the
// step's two m16n8k16 products (k 0-15, then 16-31); an s8 A fragment's
// four as the A registers of the two.
__device__ __forceinline__ void widen_b(const unsigned (&b)[2],
                                        unsigned (&w)[4]) {
  widen_s8_bf16(b[0], w[0], w[1]);
  widen_s8_bf16(b[1], w[2], w[3]);
}
__device__ __forceinline__ void widen_a(const unsigned (&a)[4],
                                        unsigned (&lo)[4],
                                        unsigned (&hi)[4]) {
  unsigned l0, h0, l1, h1, l2, h2, l3, h3;
  widen_s8_bf16(a[0], l0, h0);
  widen_s8_bf16(a[1], l1, h1);
  widen_s8_bf16(a[2], l2, h2);
  widen_s8_bf16(a[3], l3, h3);
  // bytes 0-15 of the step, then 16-31
  lo[0] = l0, lo[1] = l1, lo[2] = h0, lo[3] = h1;
  hi[0] = l2, hi[1] = l3, hi[2] = h2, hi[3] = h3;
}
// d += one 32-byte K step of an m16 x n8 tile from the widened fragments
__device__ __forceinline__ void mma_s8_as_bf16(float (&d)[4],
                                               const unsigned (&alo)[4],
                                               const unsigned (&ahi)[4],
                                               const unsigned (&bw)[4]) {
  const unsigned b0[2] = {bw[0], bw[1]}, b1[2] = {bw[2], bw[3]};
  mma_bf16(d, alo, b0);
  mma_bf16(d, ahi, b1);
}

// One 32-byte K step of the bf16 product on f32 sums: acc += A (MI m16
// tiles, rows at `at` + aoff) x B (NI n8 tiles, the lane's row at `bt`,
// tiles 16 rows apart in pairs; NI = 1: one .x2 load from lanes 0-15), the
// s8 fragments loaded as the s8 step loads them (the KxK core's and the
// GEMM's mma_k32), then widened; B once a step, each A once a step.
template <int MI, int NI>
__device__ __forceinline__ void mma_k32_bf16(float (&acc)[MI][NI][4],
                                             const unsigned char* at,
                                             const int (&aoff)[MI],
                                             const unsigned char* bt,
                                             int wpitch) {
  unsigned bw[NI][4];
  if constexpr (NI == 1) {
    unsigned b[2];
    ldsm_x2(b, bt);
    widen_b(b, bw[0]);
  } else {
#pragma unroll
    for (int j = 0; j < NI / 2; ++j) {
      unsigned r[4];
      ldsm_x4(r, bt + j * 16 * wpitch);
      const unsigned b0[2] = {r[0], r[1]}, b1[2] = {r[2], r[3]};
      widen_b(b0, bw[2 * j]);
      widen_b(b1, bw[2 * j + 1]);
    }
  }
#pragma unroll
  for (int mi = 0; mi < MI; ++mi) {
    unsigned afr[4], lo[4], hi[4];
    ldsm_x4(afr, at + aoff[mi]);
    widen_a(afr, lo, hi);
#pragma unroll
    for (int ni = 0; ni < NI; ++ni)
      mma_s8_as_bf16(acc[mi][ni], lo, hi, bw[ni]);
  }
}

// A sum as f32 (the per-part branch and the epilogue of the bf16 product
// take f32 sums as they come) and as bits (the no-store variants' sinks).
__device__ __forceinline__ float sum_f32(int v) { return __int2float_rn(v); }
__device__ __forceinline__ float sum_f32(float v) { return v; }
__device__ __forceinline__ int sum_bits(int v) { return v; }
__device__ __forceinline__ int sum_bits(float v) { return __float_as_int(v); }

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
