// L chained [rows, K] x [K, K] products on the tensor cores, rows
// independent: the body of the probe ports chain_mma.cu (E1) and the 1x1
// kinds of megakernel_probe.cu (E3).
//
// A block owns `bm` rows for all L stages. Its x rows stay in shared
// memory in two buffers that take turns (stage i reads one and writes the
// other), so no activation goes to device memory between stages. The
// weights, [L][N][K] (each output column's K values contiguous, the .col
// operand of mma.sync; int4w: two signed nibbles a byte, [L][N][K / 2]),
// stay in L2 (2 MB at K = 512, L = 8, of the H100's 50 MB) and are
// streamed per stage in N-chunks of `bn` columns through a two-slot
// cp.async ring: issue step t + 1, commit, wait for step t, barrier,
// compute, barrier. The TPU probe held x and all L weights in VMEM; a
// block here has 227 KB of shared memory, so the weights cannot stay.
// A stage's exit (the glue) runs on the accumulator fragment and writes
// the next stage's x in shared memory:
//   shift7   int8:  (acc >> 7) as int8 (arithmetic shift, the cast wraps)
//   int4w    int8:  (acc >> 5) as int8, on weights unpacked to s8 in
//                   shared memory (PTX mma has no s8 x s4 shape)
//   mixed    int8:  bf16 products of the int8 values, f32 sums (exact:
//                   |acc| < 2^24), clip(acc / 128, +-127), truncated
//   bf16     bf16:  bf16(acc / 128), round to nearest even
//   requant  int8:  the serving epilogue (epilogue.cuh) with a zero bias
//                   and per-column scale cs
// 256 threads: the block's m16 row tiles spread over min(8, bm / 16) warp
// rows, the chunk's n8 column tiles over the rest of the 8 warps.
#pragma once

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "epilogue.cuh"
#include "mma_tile.cuh"

namespace tat {

enum ChainGlue : int {
  kGlueShift7 = 0,
  kGlueBf16 = 1,
  kGlueMixed = 2,
  kGlueInt4w = 3,
  kGlueRequant = 4
};

constexpr int kChainThreads = 256;

template <int G>
__host__ __device__ constexpr int glue_mma() {
  return G == kGlueBf16 ? kMmaBf16 : (G == kGlueMixed ? kMmaMixed : kMmaS8);
}

struct GlueArgs {
  const float* cs;   // kGlueRequant: [K] per-column scale
  int act;
  float inv_out;
  float alpha;
};

// The stage exit of one accumulator value of column n, stored at dst.
template <int G>
__device__ __forceinline__ void glue_store(unsigned char* dst,
                                           typename MmaAcc<glue_mma<G>()>::type acc,
                                           int n, const GlueArgs& ga) {
  if constexpr (G == kGlueShift7) {
    *reinterpret_cast<int8_t*>(dst) = static_cast<int8_t>(acc >> 7);
  } else if constexpr (G == kGlueInt4w) {
    *reinterpret_cast<int8_t*>(dst) = static_cast<int8_t>(acc >> 5);
  } else if constexpr (G == kGlueMixed) {
    const float v = fminf(fmaxf(__fmul_rn(acc, 0.0078125f), -127.0f), 127.0f);
    *reinterpret_cast<int8_t*>(dst) = static_cast<int8_t>(__float2int_rz(v));
  } else if constexpr (G == kGlueBf16) {
    *reinterpret_cast<__nv_bfloat16*>(dst) =
        __float2bfloat16_rn(__fmul_rn(acc, 0.0078125f));
  } else {
    *reinterpret_cast<int8_t*>(dst) =
        epilogue<true>(acc, 0, ga.cs[n], ga.act, ga.inv_out, ga.alpha);
  }
}

struct RowChainArgs {
  const unsigned char* x;   // [rows][row_bytes]
  const unsigned char* w;   // [L][K][w_row_bytes]
  unsigned char* out;       // [rows][row_bytes]
  long long rows;
  int K, L, bm, bn;
  int row_bytes;     // K x the element's bytes
  int w_row_bytes;   // a weight row: row_bytes, or K / 2 packed (int4w)
  int pitch;         // shared-memory row pitch: row_bytes + kRowPad
  GlueArgs glue;
};

// bytes of shared memory the row chain takes: two x buffers, two weight
// slots (int4w: packed) and, for int4w, the unpacked s8 slab
template <int G>
inline long long row_chain_smem(const RowChainArgs& a) {
  const long long slot = G == kGlueInt4w
                             ? static_cast<long long>(a.bn) * a.w_row_bytes
                             : static_cast<long long>(a.bn) * a.pitch;
  return 2LL * a.bm * a.pitch + 2 * slot +
         (G == kGlueInt4w ? static_cast<long long>(a.bn) * a.pitch : 0);
}

namespace {

// s8 values of two signed nibbles a byte (the lower nibble first)
__device__ __forceinline__ void unpack_int4(const unsigned char* packed,
                                            unsigned char* s8, int rows,
                                            int packed_row, int pitch) {
  const int words = packed_row / 4;
  for (int i = threadIdx.x; i < rows * words; i += blockDim.x) {
    const int r = i / words, c = i - r * words;
    const unsigned v =
        *reinterpret_cast<const unsigned*>(packed + r * packed_row + 4 * c);
    unsigned lo = 0, hi = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const unsigned b = (v >> (8 * j)) & 0xffu;
      // each nibble to the top, then an arithmetic shift back: its sign
      const unsigned e = static_cast<unsigned>(static_cast<int>(b << 28) >> 28) & 0xffu;
      const unsigned o = static_cast<unsigned>(static_cast<int>(b << 24) >> 28) & 0xffu;
      const unsigned pair = e | (o << 8);   // k = 2j, 2j + 1 of the word
      if (j < 2)
        lo |= pair << (16 * j);
      else
        hi |= pair << (16 * (j - 2));
    }
    unsigned* d = reinterpret_cast<unsigned*>(s8 + r * pitch + 8 * c);
    d[0] = lo;
    d[1] = hi;
  }
}

template <int G, int NW, int MT>
__global__ void __launch_bounds__(kChainThreads)
    row_chain_kernel(RowChainArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int T = glue_mma<G>();
  constexpr int E = G == kGlueBf16 ? 2 : 1;   // bytes of an element
  using Acc = typename MmaAcc<T>::type;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int pitch = a.pitch;
  // x buffer i at smem + (i & 1) * xbytes, weight slot t at
  // ws0 + (t & 1) * wbytes (offsets, not pointer arrays: no local memory)
  const int xbytes = a.bm * pitch;
  const int slot_pitch = G == kGlueInt4w ? a.w_row_bytes : pitch;
  const int wbytes = a.bn * slot_pitch;
  unsigned char* const ws0 = smem + 2 * xbytes;
  unsigned char* const wu = ws0 + 2 * wbytes;   // int4w: the s8 slab
  const long long r0 = static_cast<long long>(blockIdx.x) * a.bm;

  // the block's x rows; rows past the end are zero and never stored
  const int xpr = a.row_bytes / 16;
  for (int i = tid; i < a.bm * xpr; i += blockDim.x) {
    const int r = i / xpr, c = i - r * xpr;
    const bool ok = r0 + r < a.rows;
    cp_async16(smem + r * pitch + 16 * c,
               ok ? a.x + (r0 + r) * a.row_bytes + 16 * c : a.x, ok ? 16 : 0);
  }
  const int nchunks = a.K / a.bn, steps = a.L * nchunks;
  const int wpr = a.w_row_bytes / 16;
  auto issue = [&](int t) {
    const int stage = t / nchunks, chunk = t - stage * nchunks;
    const unsigned char* src =
        a.w + (static_cast<long long>(stage) * a.K + chunk * a.bn) *
                  a.w_row_bytes;
    unsigned char* dst = ws0 + (t & 1) * wbytes;
    for (int i = tid; i < a.bn * wpr; i += blockDim.x) {
      const int r = i / wpr, c = i - r * wpr;
      cp_async16(dst + r * slot_pitch + 16 * c,
                 src + static_cast<long long>(r) * a.w_row_bytes + 16 * c, 16);
    }
  };
  issue(0);
  cp_async_commit();

  const int wm = a.bm / 16 < 8 ? a.bm / 16 : 8;   // warp rows
  const int warp_m = warp % wm, warp_n = warp / wm;
  const int ksteps = a.row_bytes / kMmaStepBytes;
  const int g = lane >> 2, q = lane & 3;
  for (int t = 0; t < steps; ++t) {
    if (t + 1 < steps) issue(t + 1);
    cp_async_commit();   // empty on the last step: keeps the count
    cp_async_wait<1>();
    __syncthreads();
    const unsigned char* wt = ws0 + (t & 1) * wbytes;
    if constexpr (G == kGlueInt4w) {
      unpack_int4(wt, wu, a.bn, a.w_row_bytes, pitch);
      __syncthreads();
      wt = wu;
    }
    const int stage = t / nchunks, chunk = t - stage * nchunks;
    const unsigned char* xin = smem + (stage & 1) * xbytes;
    unsigned char* xout = smem + ((stage + 1) & 1) * xbytes;
    Acc acc[MT][NW][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nw = 0; nw < NW; ++nw)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[mt][nw][i] = 0;
    for (int ks = 0; ks < ksteps; ++ks) {
      unsigned bfr[NW][2];
#pragma unroll
      for (int nw = 0; nw < NW; ++nw)
        ldsm_x2(bfr[nw], wt + ((warp_n * NW + nw) * 8 + b_lane_row(lane)) *
                                  pitch +
                             ks * kMmaStepBytes + b_lane_byte(lane));
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        unsigned afr[4];
        const int row = (warp_m + mt * wm) * 16 + a_lane_row(lane);
        ldsm_x4(afr, xin + row * pitch + ks * kMmaStepBytes + a_lane_byte(lane));
#pragma unroll
        for (int nw = 0; nw < NW; ++nw) mma_step<T>(acc[mt][nw], afr, bfr[nw]);
      }
    }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nw = 0; nw < NW; ++nw)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int row = (warp_m + mt * wm) * 16 + g + 8 * (i >> 1);
          const int n = chunk * a.bn + (warp_n * NW + nw) * 8 + 2 * q + (i & 1);
          glue_store<G>(xout + row * pitch + n * E, acc[mt][nw][i], n, a.glue);
        }
    __syncthreads();
  }
  const unsigned char* xf = smem + (a.L & 1) * xbytes;
  for (int i = tid; i < a.bm * xpr; i += blockDim.x) {
    const int r = i / xpr, c = i - r * xpr;
    if (r0 + r < a.rows)
      *reinterpret_cast<uint4*>(a.out + (r0 + r) * a.row_bytes + 16 * c) =
          *reinterpret_cast<const uint4*>(xf + r * pitch + 16 * c);
  }
}

}  // namespace

// Runs one row chain; returns a cudaError_t. Refuses (cudaErrorInvalidValue)
// what the kernel cannot run: K not a multiple of 32 or of bn, a block of
// other than 64, 128 or 256 rows, a chunk of other than 2, 4 or 8 n8 tiles
// a warp, an operand off 16 bytes, more shared memory than the device has.
template <int G>
inline int launch_row_chain(const RowChainArgs& a, cudaStream_t s) {
  const int wm = a.bm / 16 < 8 ? a.bm / 16 : 8, wn = 8 / (wm > 0 ? wm : 1);
  const int mt = wm > 0 ? a.bm / (16 * wm) : 0, nw = a.bn / (8 * wn);
  void (*kernel)(RowChainArgs) = nullptr;
  if (mt == 1 && nw == 2) kernel = row_chain_kernel<G, 2, 1>;
  if (mt == 1 && nw == 4) kernel = row_chain_kernel<G, 4, 1>;
  if (mt == 1 && nw == 8) kernel = row_chain_kernel<G, 8, 1>;
  if (mt == 2 && nw == 2) kernel = row_chain_kernel<G, 2, 2>;
  if (mt == 2 && nw == 4) kernel = row_chain_kernel<G, 4, 2>;
  if (mt == 2 && nw == 8) kernel = row_chain_kernel<G, 8, 2>;
  const bool aligned = ((reinterpret_cast<uintptr_t>(a.x) |
                         reinterpret_cast<uintptr_t>(a.w) |
                         reinterpret_cast<uintptr_t>(a.out)) & 15u) == 0;
  if (kernel == nullptr || (a.bm != 64 && a.bm != 128 && a.bm != 256) ||
      nw * 8 * wn != a.bn || a.K <= 0 || a.K % 32 != 0 || a.K % a.bn != 0 ||
      a.L < 1 || a.rows < 1 || a.pitch != a.row_bytes + kRowPad ||
      a.row_bytes % kMmaStepBytes != 0 || a.w_row_bytes % 16 != 0 ||
      !aligned)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long smem = row_chain_smem<G>(a);
  int dev = 0, max_smem = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&max_smem,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (smem > max_smem) return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const unsigned blocks = static_cast<unsigned>((a.rows + a.bm - 1) / a.bm);
  kernel<<<blocks, kChainThreads, static_cast<size_t>(smem), s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tat
