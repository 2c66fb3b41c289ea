// L chained [rows, K] x [K, K] products on Hopper's warpgroup MMA, rows
// independent: the body of the probe ports chain_mma.cu (E1) and the 1x1
// kinds of megakernel_probe.cu (E3).
//
// A block owns one or two m64 tiles of rows a consumer warpgroup (two
// consumers: 256 or 128 rows; one consumer of 64 where two buffers of 128
// bf16 rows do not fit, bf16 and mixed at K = 512) for all L stages: every
// weight chunk read from L2 serves all of them, and the L weights' L2
// traffic, not the tensor cores, bounds a block of 128 rows (measured).
// The rows stay in shared memory in two buffers that take turns (stage i
// reads one and writes the other), so no activation goes to device memory
// between stages. A buffer holds each 64-row tile in hopper_async.cuh's
// K-major no-swizzle layout: planes of 64 rows x 16 bytes (1 KB: LBO), 8
// rows 128 bytes apart (SBO), so a tile is a wgmma A operand as it
// stands. The x rows come in by TMA, a
// plane a box (rows past the end zero-filled, their outputs not stored).
// The weights, [L][N][K] (each output column's K values contiguous: the
// K-major B operand; int4w: two signed nibbles a byte, [L][N][K / 2]), stay
// in L2 (2 MB at K = 512, L = 8, of the H100's 50 MB) and come in by TMA a
// stage's N-chunk of BN columns at a time, planes of BN rows x 16 bytes
// (LBO 16 BN, SBO 128), through a ring of `wslots` slots that the
// consumers read in step (each chunk serves 128 rows); the wrapper tiles
// them in device memory as that image, once a weight tensor, so that TMA
// moves them in 128-byte rows (a 16-byte box row costs about two cycles
// an SM, measured). A producer
// warpgroup issues the loads (one thread) and, for int4w and mixed, all
// its 128 threads turn each TMA-loaded raw chunk into the operand type in
// its slot (int4w: nibbles to s8; mixed: int8 to bf16), then fence it for
// the async proxy. A consumer's chunk is one group of wgmma (m64 x BN a
// tile, s8 k32 or bf16 k16 steps); then its glue (the stage exit) runs on the
// accumulator fragment and writes the next stage's operand straight into
// the other buffer (the last stage: the output rows in device memory):
//   shift7   int8:  (acc >> 7) as int8 (arithmetic shift, the cast wraps)
//   int4w    int8:  (acc >> 5) as int8, s8 products on the unpacked
//                   weights (PTX has no s8 x s4 wgmma)
//   mixed    int8:  bf16 products of the int8 values (rows and weights as
//                   bf16 copies in shared memory), f32 sums (exact: |acc| <
//                   2^24), clip(acc / 128, +-127) truncated
//   bf16     bf16:  bf16(acc / 128), round to nearest even
//   requant  int8:  the serving epilogue (epilogue.cuh) with a zero bias
//                   and per-column scale cs (SILU_FAST compiled in)
// A stage's writes are fenced for the async proxy and the consumer's
// warpgroup meets at a named barrier before its next stage's wgmma reads
// them; each consumer reads only its own rows. Two consumers take turns
// on the tensor cores (named barriers, consumer 0 first each chunk), so
// that one's glue runs beside the other's product.
//
// Shared memory (row_chain_layout; ops/probe_kernels.py chain_smem mirrors
// it): the two buffers (2 x the block's rows), the operand weight
// slots, two raw slots (int4w, mixed), cs (requant), the barriers.
//
// Measurement builds (kxk_bench --what chainsplit; no wrapper loads them):
// -DTAT_CHAIN_NO_PRODUCT issues no wgmma, -DTAT_CHAIN_NO_GLUE writes no
// stage's rows (the sums XORed and kept alive).
#pragma once

#include <cstdint>

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "epilogue.cuh"
#include "hopper_async.cuh"

namespace tat {

enum ChainGlue : int {
  kGlueShift7 = 0,
  kGlueBf16 = 1,
  kGlueMixed = 2,
  kGlueInt4w = 3,
  kGlueRequant = 4
};

struct GlueArgs {
  const float* cs;   // kGlueRequant: [K] per-column scale
  int act;
  float inv_out;
  float alpha;
};

struct RowChainGeom {
  long long rows;
  int K, L, BN, wslots, cons, regions;   // regions: 64-row tiles a block
  int in_bytes;    // a row of x and out in device memory: K, 2 K (bf16)
  int op_bytes;    // a resident operand row: K, 2 K (bf16, mixed)
  int w_bytes;     // a weight row in device memory: op_bytes, K / 2 (int4w)
  int raw;         // weights converted in shared memory (int4w, mixed)
  int buf_bytes, unit_bytes, raw_bytes;   // 64 rows; an operand and a raw
                                          // chunk of BN weight rows
  int op_off, raw_off, cs_off, bar_off, smem;
};

using RowChainKernel = void (*)(const CUtensorMap, const CUtensorMap,
                                unsigned char*, RowChainGeom, GlueArgs);

namespace chain_detail {

constexpr int kWgThreads = 128;
constexpr int kRows = 64;          // a consumer's rows: one m64 operand
constexpr int kPlane = kRows * 16;
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;
constexpr int kBarProducer = 3;    // named barriers: consumer c is 1 + c
constexpr int kBarCs = 4;
constexpr int kBarTurn = 5;        // + consumer: its product may start

template <int G>
__host__ __device__ constexpr bool glue_bf16() {
  return G == kGlueBf16 || G == kGlueMixed;
}

// --- named barriers: bar.sync waits until `count` threads (whole warps)
// have reached barrier `id`. -------------------------------------------------
__device__ __forceinline__ void bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}
// --- end of named barriers -------------------------------------------------

inline void row_chain_layout(RowChainGeom& g, int glue) {
  const bool bf16 = glue == kGlueBf16;
  const bool op16 = bf16 || glue == kGlueMixed;
  g.in_bytes = bf16 ? 2 * g.K : g.K;
  g.op_bytes = op16 ? 2 * g.K : g.K;
  g.w_bytes = glue == kGlueInt4w ? g.K / 2 : (bf16 ? 2 * g.K : g.K);
  g.raw = glue == kGlueInt4w || glue == kGlueMixed;
  g.buf_bytes = kRows * g.op_bytes;
  g.unit_bytes = g.op_bytes * g.BN;
  g.raw_bytes = g.w_bytes * g.BN;
  g.op_off = 2 * g.regions * g.buf_bytes;
  g.raw_off = g.op_off + g.wslots * g.unit_bytes;
  g.cs_off = g.raw_off + (g.raw ? 2 * g.raw_bytes : 0);
  g.bar_off = g.cs_off + (glue == kGlueRequant ? 4 * g.K : 0);
  g.smem = g.bar_off + 8 * (g.cons + 2 * g.wslots + 2);
}

// the 16-byte raw row `i` of a chunk (plane i / BN, row i % BN) in the
// operand type: int4w's 32 nibbles to two s8 planes, mixed's 16 int8 to
// two bf16 planes
template <int G>
__device__ __forceinline__ void convert_row(const unsigned char* raw,
                                            unsigned char* op, int i,
                                            int BN) {
  const int plane = i / BN, n = i - plane * BN;
  const uint4 v = *reinterpret_cast<const uint4*>(raw + 16 * i);
  const unsigned w[4] = {v.x, v.y, v.z, v.w};
  unsigned o[8];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    if constexpr (G == kGlueInt4w) {   // 8 nibbles, lower first
      unsigned lo = 0, hi = 0;
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const unsigned byte = (w[q] >> (8 * b)) & 0xffu;
        const unsigned e =
            static_cast<unsigned>(static_cast<int>(byte << 28) >> 28) & 0xffu;
        const unsigned f =
            static_cast<unsigned>(static_cast<int>(byte << 24) >> 28) & 0xffu;
        const unsigned pair = e | f << 8;
        if (b < 2)
          lo |= pair << (16 * b);
        else
          hi |= pair << (16 * (b - 2));
      }
      o[2 * q] = lo;
      o[2 * q + 1] = hi;
    } else {   // 4 int8 to 4 bf16
#pragma unroll
      for (int b = 0; b < 2; ++b) {
        const int v0 = static_cast<int8_t>(w[q] >> (16 * b));
        const int v1 = static_cast<int8_t>(w[q] >> (16 * b + 8));
        const __nv_bfloat162 p = __floats2bfloat162_rn(
            static_cast<float>(v0), static_cast<float>(v1));
        unsigned u;
        memcpy(&u, &p, 4);
        o[2 * q + b] = u;
      }
    }
  }
  // o[0..3]: the first output plane's 16 bytes of row n, o[4..7] the next
  unsigned char* dst = op + (2 * plane) * 16 * BN + 16 * n;
  *reinterpret_cast<uint4*>(dst) = make_uint4(o[0], o[1], o[2], o[3]);
  *reinterpret_cast<uint4*>(dst + 16 * BN) = make_uint4(o[4], o[5], o[6], o[7]);
}

// The stage exit of one accumulator value of column n as the next stage's
// int8 value (the bf16 glue has its own path)
template <int G, class Acc>
__device__ __forceinline__ int glue_s8(Acc acc, int n, const float* cs_s,
                                       const GlueArgs& ga) {
  if constexpr (G == kGlueShift7) {
    return static_cast<int8_t>(acc >> 7);
  } else if constexpr (G == kGlueInt4w) {
    return static_cast<int8_t>(acc >> 5);
  } else if constexpr (G == kGlueMixed) {
    const float v = fminf(fmaxf(__fmul_rn(acc, 0.0078125f), -127.0f), 127.0f);
    return __float2int_rz(v);
  } else {
    return epilogue<true>(acc, 0, cs_s[n], ga.act, ga.inv_out, ga.alpha);
  }
}

template <int G, int BN, int CONS, int MT>
__global__ void __launch_bounds__(kWgThreads * (1 + CONS), 1)
    row_chain_wgmma_kernel(const __grid_constant__ CUtensorMap xmap,
                           const __grid_constant__ CUtensorMap wmap,
                           unsigned char* __restrict__ out, RowChainGeom g,
                           GlueArgs ga) {
  constexpr bool kOp16 = glue_bf16<G>();
  constexpr bool kRaw = G == kGlueInt4w || G == kGlueMixed;
  using M = WgmmaOf<BN, kOp16>;
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* xfull = reinterpret_cast<uint64_t*>(smem + g.bar_off);
  uint64_t* opfull = xfull + CONS;
  uint64_t* opempty = opfull + g.wslots;
  uint64_t* rawfull = opempty + g.wslots;
  const int tid = threadIdx.x;
  // the warpgroup, from lane 0: uniform to ptxas (else the consumers'
  // wgmma is serialised as if in a divergent path)
  const int wg = __shfl_sync(0xffffffffu, tid / kWgThreads, 0);
  constexpr int kRegions = CONS * MT;   // 64-row regions of a buffer
  const long long r0 = static_cast<long long>(blockIdx.x) * kRows * kRegions;
  const int nch = g.K / BN, units = g.L * nch;
  const int in_planes = g.in_bytes / 16, w_planes = g.w_bytes / 16;
  constexpr int kWBox = 1024;   // a weight TMA box: 8 rows of 128 bytes
  if (tid == 0) {
    for (int c = 0; c < CONS; ++c) mbar_init(xfull + c, 1);
    for (int s = 0; s < g.wslots; ++s) {
      mbar_init(opfull + s, kRaw ? kWgThreads : 1);
      mbar_init(opempty + s, kWgThreads * CONS);
    }
    mbar_init(rawfull, 1);
    mbar_init(rawfull + 1, 1);
    fence_barrier_init();
  }
  __syncthreads();

  if (wg == 0) {   // the producer
    if constexpr (CONS == 2) setmaxnreg_dec<kProducerRegs>();
    // weight chunk u (stage u / nch, columns (u % nch) BN ..), tiled in
    // device memory as its shared-memory image, by TMA in 128-byte rows
    auto load_unit = [&](int u, unsigned char* dst, uint64_t* bar) {
      const int bytes = g.w_bytes * BN, row = u * (bytes / 128);
      mbar_arrive_tx(bar, bytes);
      for (int j = 0; j < bytes / kWBox; ++j)
        tma_load_2d(dst + j * kWBox, &wmap, 0, row + j * (kWBox / 128), bar);
    };
    if (tid == 0) {
      for (int c = 0; c < CONS; ++c) {   // mixed: int8 rows to buffer 1
        mbar_arrive_tx(xfull + c, g.in_bytes * kRows * MT);
        for (int rg = c * MT; rg < (c + 1) * MT; ++rg) {
          unsigned char* dst =
              smem + ((G == kGlueMixed ? kRegions : 0) + rg) * g.buf_bytes;
          for (int j = 0; j < in_planes; ++j)
            tma_load_2d(dst + j * kPlane, &xmap, 16 * j,
                        static_cast<int>(r0) + kRows * rg, xfull + c);
        }
      }
    }
    if constexpr (!kRaw) {
      if (tid != 0) return;
      for (int u = 0; u < units; ++u) {
        const int s = u % g.wslots;
        mbar_wait(opempty + s, ((u / g.wslots) & 1) ^ 1);
        load_unit(u, smem + g.op_off + s * g.unit_bytes, opfull + s);
      }
      return;
    } else {
      unsigned char* raw0 = smem + g.raw_off;
      if (tid == 0) load_unit(0, raw0, rawfull);
      for (int u = 0; u < units; ++u) {
        // raw slot (u + 1) & 1 last held chunk u - 1, converted before the
        // barrier that closed the previous round
        if (tid == 0 && u + 1 < units)
          load_unit(u + 1, raw0 + ((u + 1) & 1) * g.raw_bytes,
                    rawfull + ((u + 1) & 1));
        const int s = u % g.wslots;
        mbar_wait(rawfull + (u & 1), (u >> 1) & 1);
        mbar_wait(opempty + s, ((u / g.wslots) & 1) ^ 1);
        for (int i = tid; i < w_planes * BN; i += kWgThreads)
          convert_row<G>(raw0 + (u & 1) * g.raw_bytes,
                         smem + g.op_off + s * g.unit_bytes, i, BN);
        fence_proxy_async();
        mbar_arrive(opfull + s);
        bar_sync(kBarProducer, kWgThreads);
      }
      return;
    }
  }

  if constexpr (CONS == 2) setmaxnreg_inc<kConsumerRegs>();
  const int c = wg - 1, t = tid - kWgThreads * wg;
  const int lane = t & 31, warp = t >> 5, tq = lane & 3;
  float* cs_s = reinterpret_cast<float*>(smem + g.cs_off);
  if constexpr (G == kGlueRequant) {
    for (int n = tid - kWgThreads; n < g.K; n += kWgThreads * CONS)
      cs_s[n] = ga.cs[n];
    bar_sync(kBarCs, kWgThreads * CONS);
  }
  mbar_wait(xfull + c, 0);
  if constexpr (G == kGlueMixed) {   // the int8 rows to bf16, buffer 0
    for (int i = t; i < in_planes * kRows * MT; i += kWgThreads) {
      const int rg = c * MT + i / (in_planes * kRows);
      const unsigned char* src = smem + (kRegions + rg) * g.buf_bytes;
      unsigned char* dst = smem + rg * g.buf_bytes;
      // raw plane p, row r of the region: 16 int8 to two bf16 planes
      const int ir = i % (in_planes * kRows);
      const int p = ir / kRows, r = ir - p * kRows;
      const uint4 v = *reinterpret_cast<const uint4*>(src + 16 * ir);
      const unsigned w[4] = {v.x, v.y, v.z, v.w};
      unsigned o[8];
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const int v0 = static_cast<int8_t>(w[q / 2] >> (16 * (q & 1)));
        const int v1 = static_cast<int8_t>(w[q / 2] >> (16 * (q & 1) + 8));
        const __nv_bfloat162 pr = __floats2bfloat162_rn(
            static_cast<float>(v0), static_cast<float>(v1));
        memcpy(&o[q], &pr, 4);
      }
      unsigned char* d0 = dst + 2 * p * kPlane + 16 * r;
      *reinterpret_cast<uint4*>(d0) = make_uint4(o[0], o[1], o[2], o[3]);
      *reinterpret_cast<uint4*>(d0 + kPlane) =
          make_uint4(o[4], o[5], o[6], o[7]);
    }
    fence_proxy_async();
    bar_sync(1 + c, kWgThreads);
  }
  const uint64_t b0 = gmma_desc(smem + g.op_off, 16 * BN, 128);
  typename M::Acc d[MT][BN / 2];   // the consumer's MT m64 tiles
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) d[m][i] = 0;
  // the lane's rows of its consumer's 64: g and g + 8 of its warp's 16
  const int row_a = 16 * warp + (lane >> 2);
  for (int st = 0; st < g.L; ++st) {
    const uint64_t a0 = gmma_desc(
        smem + ((st & 1) * kRegions + c * MT) * g.buf_bytes, kPlane, 128);
    unsigned char* next0 = smem + ((~st & 1) * kRegions + c * MT) *
                                      g.buf_bytes;
    const bool last = st == g.L - 1;
    for (int ch = 0; ch < nch; ++ch) {
      const int u = st * nch + ch, s = u % g.wslots;
      // two consumers take turns on the tensor cores, each chunk consumer
      // 0 first: one's glue runs beside the other's product
      if (CONS == 2 && (u > 0 || c == 1))
        bar_sync(kBarTurn + c, 2 * kWgThreads);
      mbar_wait(opfull + s, (u / g.wslots) & 1);
#pragma unroll
      for (int m = 0; m < MT; ++m) fence_acc(d[m]);
      wgmma_fence();
#ifndef TAT_CHAIN_NO_PRODUCT
      for (int ks = 0; ks < g.op_bytes / 32; ++ks)
#pragma unroll
        for (int m = 0; m < MT; ++m)   // the chunk's B serves MT tiles
          M::run(d[m], a0 + ((m * g.buf_bytes) >> 4) + 2 * ks * (kPlane >> 4),
                 b0 + (s * g.unit_bytes >> 4) + 2 * ks * BN, ks != 0);
#endif
      wgmma_commit();
      if (CONS == 2 && (c == 0 || u + 1 < units))
        bar_arrive(kBarTurn + 1 - c, 2 * kWgThreads);
      wgmma_wait<0>();
#pragma unroll
      for (int m = 0; m < MT; ++m) fence_acc(d[m]);
      mbar_arrive(opempty + s);
#ifdef TAT_CHAIN_NO_GLUE
      // the sums kept alive (ptxas drops a wgmma whose sums are dead)
      int live = 0;
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int i = 0; i < BN / 2; ++i) live ^= static_cast<int>(d[m][i]);
      if (live == 0x5eed1e55) out[r0] = static_cast<unsigned char>(u);
      continue;
#endif
      // the glue: the lane's rows g, g + 8 (h) of each tile m, its columns
      // 8 j + 2 tq, + 1
#pragma unroll
      for (int mh = 0; mh < 2 * MT; ++mh) {
        const int m = mh >> 1, h = mh & 1;
        unsigned char* next = next0 + m * g.buf_bytes;
        const int r = row_a + 8 * h;
        const long long grow = r0 + kRows * (c * MT + m) + r;
        unsigned char* orow = out + grow * g.in_bytes;
        const bool keep = grow < g.rows;
        if (G == kGlueBf16 || (G == kGlueMixed && !last)) {   // bf16 pairs
#pragma unroll
          for (int j = 0; j < BN / 8; ++j) {
            const int n = ch * BN + 8 * j + 2 * tq;
            __nv_bfloat162 p;
            if constexpr (G == kGlueBf16) {
              p = __floats2bfloat162_rn(
                  __fmul_rn(d[m][4 * j + 2 * h], 0.0078125f),
                  __fmul_rn(d[m][4 * j + 2 * h + 1], 0.0078125f));
            } else {
              p = __floats2bfloat162_rn(
                  static_cast<float>(
                      glue_s8<G>(d[m][4 * j + 2 * h], n, cs_s, ga)),
                  static_cast<float>(
                      glue_s8<G>(d[m][4 * j + 2 * h + 1], n + 1, cs_s, ga)));
            }
            if (!last)
              *reinterpret_cast<__nv_bfloat162*>(
                  next + n / 8 * kPlane + 16 * r + 2 * (n % 8)) = p;
            else if (keep)
              *reinterpret_cast<__nv_bfloat162*>(orow + 2 * n) = p;
          }
        } else {   // int8: the quad's pieces gathered, 8 bytes a lane
#pragma unroll
          for (int q = 0; q < BN / 32; ++q) {
            unsigned u[4];
#pragma unroll
            for (int jj = 0; jj < 4; ++jj) {
              const int j = 4 * q + jj, n = ch * BN + 8 * j + 2 * tq;
              const int v0 = glue_s8<G>(d[m][4 * j + 2 * h], n, cs_s, ga);
              const int v1 =
                  glue_s8<G>(d[m][4 * j + 2 * h + 1], n + 1, cs_s, ga);
              u[jj] = (v0 & 0xff) | (v1 & 0xff) << 8;
            }
            const uint2 v = quad_gather8(u, lane);
            const int n = ch * BN + 8 * (4 * q + tq);
            if (!last)
              *reinterpret_cast<uint2*>(next + n / 16 * kPlane + 16 * r +
                                        n % 16) = v;
            else if (keep)
              *reinterpret_cast<uint2*>(orow + n) = v;
          }
        }
      }
    }
    if (!last) {   // this stage's rows visible to the next stage's wgmma
      fence_proxy_async();
      bar_sync(1 + c, kWgThreads);
    }
  }
}

template <int G, int CONS, int MT>
inline RowChainKernel pick_bn(int bn) {
  if (bn == 32) return row_chain_wgmma_kernel<G, 32, CONS, MT>;
  if (bn == 64) return row_chain_wgmma_kernel<G, 64, CONS, MT>;
  if (bn == 128) return row_chain_wgmma_kernel<G, 128, CONS, MT>;
  return nullptr;
}

// bm 256: two consumers of two m64 tiles; 128: two of one; 64: one of one,
// only where bf16 rows need it (bf16, mixed)
template <int G>
inline RowChainKernel pick_chain(int bn, int bm) {
  if (bm == 256) return pick_bn<G, 2, 2>(bn);
  if (bm == 128) return pick_bn<G, 2, 1>(bn);
  if constexpr (glue_bf16<G>()) {
    if (bm == 64) return pick_bn<G, 1, 1>(bn);
  }
  return nullptr;
}

}  // namespace chain_detail

// The kernel of (glue, K, bm, bn, wslots) and its geometry, or null for a
// plan it cannot run: bm 128 (two consumers) or 64 (one, bf16 and mixed
// only), bn 32, 64 or 128 dividing K, K a multiple of 32, 2-4 weight slots,
// within the device's shared memory (the kernel opted into it).
template <int G>
inline RowChainKernel prepare_row_chain(int K, int bm, int bn, int wslots,
                                        RowChainGeom& g, cudaError_t& err) {
  err = cudaErrorInvalidValue;
  if (K < 32 || K % 32 != 0 || K % bn != 0 || wslots < 2 || wslots > 4 ||
      (G == kGlueInt4w ? K / 2 : K) * bn % 1024)
    return nullptr;
  const RowChainKernel k = chain_detail::pick_chain<G>(bn, bm);
  if (k == nullptr) return nullptr;
  g.K = K;
  g.BN = bn;
  g.wslots = wslots;
  g.regions = bm / 64;
  g.cons = bm > 64 ? 2 : 1;
  chain_detail::row_chain_layout(g, G);
  int dev = 0, max_smem = 0;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&max_smem,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return nullptr;
  if (g.smem > max_smem) {
    err = cudaErrorInvalidValue;
    return nullptr;
  }
  // the card's whole opt-in, not this plan's bytes: the attribute is the
  // kernel's, shared by every host thread, so a smaller plan opted in by
  // another thread between this opt-in and its launch would fail the launch
  err = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             max_smem);
  return err == cudaSuccess ? k : nullptr;
}

// Runs one row chain: x [rows][K] (bf16: [rows][2 K] bytes), w the weights
// [L][K][w row] (int4w packed) tiled as their shared-memory image,
// [L][K / bn][w row / 16][bn][16] bytes (ops/probe_kernels.py
// tile_weights), out like x, x, w and out 16-byte aligned; returns a
// cudaError_t, cudaErrorInvalidValue for what the kernel cannot run.
template <int G>
inline int launch_row_chain(const void* x, const void* w, void* out,
                            long long rows, int K, int L, int bm, int bn,
                            int wslots, GlueArgs ga, cudaStream_t s) {
  const bool aligned = ((reinterpret_cast<uintptr_t>(x) |
                         reinterpret_cast<uintptr_t>(w) |
                         reinterpret_cast<uintptr_t>(out)) & 15u) == 0;
  if (rows < 1 || rows > (1LL << 31) - 256 || L < 1 || !aligned ||
      (G == kGlueRequant && ga.cs == nullptr) || ga.act < kActNone ||
      ga.act > kActSiluFast)
    return static_cast<int>(cudaErrorInvalidValue);
  RowChainGeom g = {};
  cudaError_t err;
  const RowChainKernel k = prepare_row_chain<G>(K, bm, bn, wslots, g, err);
  if (k == nullptr) return static_cast<int>(err);
  g.rows = rows;
  g.L = L;
  CUtensorMap xmap, wmap;
  const uint64_t xdims[2] = {static_cast<uint64_t>(g.in_bytes),
                             static_cast<uint64_t>(rows)};
  const uint64_t xstrides[1] = {static_cast<uint64_t>(g.in_bytes)};
  const uint32_t xbox[2] = {16, chain_detail::kRows};
  // the tiled weights: [L][K / bn][w row / 16][bn][16] bytes, rows of 128
  const uint64_t wdims[2] = {128, static_cast<uint64_t>(L) * K * g.w_bytes /
                                      128};
  const uint64_t wstrides[1] = {128};
  const uint32_t wbox[2] = {128, 8};
  err = encode_s8_map(&xmap, x, 2, xdims, xstrides, xbox);
  if (err == cudaSuccess)
    err = encode_s8_map(&wmap, w, 2, wdims, wstrides, wbox);
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned blocks = static_cast<unsigned>((rows + bm - 1) / bm);
  k<<<blocks, chain_detail::kWgThreads * (1 + g.cons),
      static_cast<size_t>(g.smem), s>>>(xmap, wmap,
                                        static_cast<unsigned char*>(out), g,
                                        ga);
  return static_cast<int>(cudaGetLastError());
}

// The dynamic shared memory of a plan and the blocks of it an SM holds
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor).
template <int G>
inline int row_chain_info(int K, int bm, int bn, int wslots, int* smem,
                          int* blocks_per_sm) {
  RowChainGeom g = {};
  cudaError_t err;
  const RowChainKernel k = prepare_row_chain<G>(K, bm, bn, wslots, g, err);
  if (k == nullptr) return static_cast<int>(err);
  *smem = g.smem;
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, k, chain_detail::kWgThreads * (1 + g.cons),
      static_cast<size_t>(g.smem)));
}

}  // namespace tat
