// E3, the megakernel pricing probe: what the production requantize
// epilogue, the 3x3 taps and a whole C3 round cost at the chained-product
// ceiling of E1 (chain_mma.cu).
//
// Replaces examples/megakernel_probe.py:build (pallas_calls :205, :213,
// :236, :257; bodies _k_shift_1x1 :87, _k_requant_1x1 :96, _k_shift_3x3
// :122, _k_requant_3x3 :131, _k_bf16_3x3 :140, _k_c3_round :150). The
// requantize is epilogue.cuh's with a zero bias, a per-channel scale cs,
// inv_out 1/32 and alpha 0.01 (the probe's _requant :78).
//
//   tat_megakernel_1x1  the 1x1 kinds: L chained int8 products over the
//                       rows, >> 7 or the requantize (SILU, SILU_FAST,
//                       RELU) between them: chain_mma.cuh's row chain on
//                       wgmma, the rows resident in shared memory.
//   tat_megakernel_3x3  one stage of the valid-shrink 3x3 kinds, on
//                       Hopper's warpgroup MMA: NHWC [cells, e, e, K] ->
//                       [cells, e - 2, e - 2, K] as 9 shifted-window
//                       products of [pixels, K] x [K, K] (taps = 9), or the
//                       C3 round's 1x1 over the whole extent (taps = 1),
//                       with one of four epilogues: >> 7, the requantize,
//                       bf16(acc / 128) (bf16 rows), or the C3 round's SILU
//                       requantize plus res_scale x the residual
//                       res[1:e-1, 1:e-1] read from device memory.
// The wrapper (ops/probe_kernels.py megakernel_chain) launches it once a
// stage (twice for the C3 round: the 1x1, then the taps), in order on one
// stream, each stage's output in a scratch tensor that stays in L2 (at most
// 13 MB at K = 512 against the H100's 50 MB), so every output pixel is
// computed once: no halo is computed again.
//
// What bounds it on the H100: the products, 9 K^2 MACs an output pixel (the
// C3 round's 1x1 K^2 more), then the epilogues (a SILU an output element).
// The product is E2's (conv_int8_lagged.cu): an 8 x 8 output tile is one
// m64 wgmma operand; its slab (10 x 10 pixels for the taps, 8 x 8 for the
// 1x1) comes in by TMA as 16-byte planes, one plane 16 bytes of every pixel
// (kPlane apart: LBO), pixel rows SW x 16 bytes apart (SBO), so the window
// of tap (dy, dx), dy and dx in 0..2, is a descriptor (dy SW + dx) x 16
// bytes into the plane and needs no copy. Slabs past the input's extent are
// zero-filled by the tensor map and their outputs masked at the store
// (ragged extents such as 38 = 4 x 8 + 6). bf16 rows are bytes to the
// tensor maps and the descriptors: a k16 bf16 step reads the same 32 bytes
// of K as a k32 s8 step. TMA moves 16-byte box rows at about half a row a
// cycle an SM (measured), so the activations between stages are kept
// plane-major ([cells][row / 16][e][e][16]: a slab plane is SW rows of 16 SW
// bytes), only the first stage's input and the last's output are NHWC.
// The weights (K-major, the B operand: planes of BN rows x 16 bytes, LBO
// 16 BN, SBO 128) are tiled in device memory as that shared-memory image
// by the wrapper, once a weight tensor, and loaded by TMA in 128-byte rows:
//   - resident: all taps x K of the block's BN output channels, once a
//     block, where they fit (K = 256 at BN <= 64);
//   - streamed: a tap of a kc-byte chunk of K at a time through a ring of
//     `wslots` slots (K = 512, bf16), both consumer warpgroups in step on
//     the same slot (a round: two tiles, 128 rows a weight unit), each
//     tile's slab in chunks of kc bytes.
// 384 threads: a producer warpgroup (one thread issues the TMA loads,
// setmaxnreg gives its registers to the consumers) and two consumer
// warpgroups, each with its tile's m64 x BN sums in registers; the grid is
// persistent: grid.y the channel blocks, grid.x blocks walking the tiles
// blockIdx.x, + gridDim.x, ...; consumer c takes a block's tiles c, c + 2,
// ... A slab slot is full[s] (the producer's expect_tx and the TMA bytes)
// and empty[s] (its consumer's 128 threads once their wgmma completed).
//
// Shared memory (stage_layout, mirrored by ops/probe_kernels.py
// stage_smem): the weights (resident: taps x row bytes x BN; streamed:
// `wslots` units of kc x BN), `stages` slab slots of kc / 16 planes, cs (4
// BN bytes), the barriers.
#include <cstdint>

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "chain_mma.cuh"
#include "hopper_async.cuh"

namespace {

enum StageEp : int { kEpShift = 0, kEpRequant = 1, kEpBf16 = 2, kEpResidual = 3 };

constexpr int kTile = 8;                  // output pixels a tile: 8 x 8
constexpr int kWgThreads = 128;
constexpr int kThreads = 3 * kWgThreads;  // producer + two consumers
constexpr int kConsumers = 2 * kWgThreads;
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;
constexpr int kWBox = 1024;               // a weight TMA box: 8 rows of 128

// a slab's pixels a side (the taps' halo), and its 16-byte plane rounded
// up to 128 bytes
__host__ __device__ constexpr int slab_side(int taps) {
  return taps == 9 ? kTile + 2 : kTile;
}
__host__ __device__ constexpr int slab_plane(int taps) {
  return (slab_side(taps) * slab_side(taps) * 16 + 127) / 128 * 128;
}

// --- named barriers: bar.sync waits until `count` threads (whole warps)
// have reached barrier `id`. -------------------------------------------------
__device__ __forceinline__ void bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}
// --- end of named barriers -------------------------------------------------

constexpr int kBarInit = 1;   // cs staged (the consumers)

struct StageGeom {
  int e, eo, K, row_bytes;   // input extent, output extent, channels, bytes
  int xpm, rpm, opm;         // x, res, out plane-major (else NHWC)
  int taps, BN, kc, stages, resident, wslots;   // wslots: streamed units
  int wblock;                // a channel block's weights: taps x row x BN
  int planes, nchunks;       // kc / 16, row_bytes / kc
  int ntw, tiles_cell, tiles;
  int slot_bytes, wunit_bytes;
  int slab_off, cs_off, bar_off, smem;
};

// The shared-memory layout of one block (ops/probe_kernels.py stage_smem
// mirrors the total): the weights at 0, the slab slots, cs, the barriers.
void stage_layout(StageGeom& g) {
  g.planes = g.kc / 16;
  g.nchunks = g.row_bytes / g.kc;
  g.slot_bytes = g.planes * slab_plane(g.taps);
  g.wunit_bytes = g.kc * g.BN;
  g.wblock = g.taps * g.row_bytes * g.BN;
  g.slab_off = g.resident ? g.taps * g.row_bytes * g.BN
                          : g.wslots * g.wunit_bytes;
  g.cs_off = g.slab_off + g.stages * g.slot_bytes;
  g.bar_off = g.cs_off + 4 * g.BN;
  g.smem = g.bar_off + 8 * (2 * g.stages + (g.resident ? 1 : 2 * g.wslots));
}

// A pixel's byte 0 and the distance from its 16 bytes to its next 16: NHWC
// [cells][e][e][row] (16 bytes), or plane-major [cells][row / 16][e][e][16]
// (e^2 x 16 bytes), the layout of the activations between stages, whose
// slab planes are 16 SW-byte rows to TMA.
struct PixAt {
  long long base, pstride;
};
__device__ __forceinline__ PixAt pix_at(bool pm, int e, int row_bytes, int n,
                                        int y, int x) {
  if (pm)
    return {((static_cast<long long>(n) * (row_bytes / 16) * e + y) * e + x) *
                16,
            static_cast<long long>(e) * e * 16};
  return {((static_cast<long long>(n) * e + y) * e + x) * row_bytes, 16};
}
__device__ __forceinline__ long long byte_at(const PixAt& p, int b) {
  return p.base + (b >> 4) * p.pstride + (b & 15);
}

__device__ __forceinline__ void tile_at(const StageGeom& g, int k, int& n,
                                        int& oy0, int& ox0) {
  n = k / g.tiles_cell;
  const int t = k - n * g.tiles_cell;
  const int ty = t / g.ntw;
  oy0 = ty * kTile;
  ox0 = (t - ty * g.ntw) * kTile;
}

// The int8 epilogue of one tile's sums in registers, 8 bytes a lane and
// row: the lane's rows g and g + 8 of warp w, its two columns of each n8
// block, the quad's pieces gathered (tat::quad_gather8) so that each lane
// stores one n8 block of its row. ep(acc, col, r): the element's int8, r
// its residual (0 without one).
template <int BN, bool RES, class Ep>
__device__ __forceinline__ void store_s8(const int (&d)[BN / 2],
                                         const StageGeom& g, int n, int oy0,
                                         int ox0, int n0,
                                         const int8_t* __restrict__ res,
                                         unsigned char* __restrict__ out,
                                         Ep ep) {
  const int t = threadIdx.x % kWgThreads, lane = t & 31;
  const int tq = lane & 3;
  PixAt opix[2], rpix[2];
  bool ok[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int p = (t >> 5) * 16 + (lane >> 2) + 8 * h;   // tile pixel
    const int oy = oy0 + (p >> 3), ox = ox0 + (p & 7);
    ok[h] = oy < g.eo && ox < g.eo;
    opix[h] = pix_at(g.opm, g.eo, g.row_bytes, n, oy, ox);
    rpix[h] = pix_at(g.rpm, g.e, g.row_bytes, n, oy + 1, ox + 1);
  }
#pragma unroll
  for (int q = 0; q < BN / 32; ++q) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      unsigned u[4];   // the lane's 2 bytes of n8 blocks 4 q .. 4 q + 3
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int j = 4 * q + jj, col = 8 * j + 2 * tq;
        const int r0 = RES && ok[h] ? res[byte_at(rpix[h], n0 + col)] : 0;
        const int r1 = RES && ok[h] ? res[byte_at(rpix[h], n0 + col + 1)] : 0;
        const int8_t lo = ep(d[4 * j + 2 * h], col, r0);
        const int8_t hi = ep(d[4 * j + 2 * h + 1], col + 1, r1);
        u[jj] = static_cast<uint8_t>(lo) |
                static_cast<unsigned>(static_cast<uint8_t>(hi)) << 8;
      }
      const uint2 v = tat::quad_gather8(u, lane);
      if (ok[h])
        *reinterpret_cast<uint2*>(
            out + byte_at(opix[h], n0 + 8 * (4 * q + tq))) = v;
    }
  }
}

// bf16(acc / 128), round to nearest even: a bf16 pair (4 bytes) a lane, n8
// block and row
template <int BN>
__device__ __forceinline__ void store_bf16(const float (&d)[BN / 2],
                                           const StageGeom& g, int n,
                                           int oy0, int ox0, int n0,
                                           unsigned char* __restrict__ out) {
  const int t = threadIdx.x % kWgThreads, lane = t & 31;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int p = (t >> 5) * 16 + (lane >> 2) + 8 * h;
    const int oy = oy0 + (p >> 3), ox = ox0 + (p & 7);
    if (oy >= g.eo || ox >= g.eo) continue;
    const PixAt o = pix_at(g.opm, g.eo, g.row_bytes, n, oy, ox);
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(
          out + byte_at(o, 2 * (n0 + 8 * j + 2 * (lane & 3)))) =
          __floats2bfloat162_rn(__fmul_rn(d[4 * j + 2 * h], 0.0078125f),
                                __fmul_rn(d[4 * j + 2 * h + 1], 0.0078125f));
  }
}

template <int EP, int TAPS, int BN, bool RESIDENT>
__global__ void __launch_bounds__(kThreads, 1)
    stage_wgmma_kernel(const __grid_constant__ CUtensorMap xmap,
                       const __grid_constant__ CUtensorMap wmap,
                       const float* __restrict__ cs,
                       const int8_t* __restrict__ res,
                       unsigned char* __restrict__ out, StageGeom g, int act,
                       float inv_out, float alpha, float res_scale) {
  constexpr int SW = slab_side(TAPS);
  constexpr int kPlane = slab_plane(TAPS);
  constexpr bool kBf16 = EP == kEpBf16;
  // a round: the tiles whose products share the weight units (streamed:
  // both consumers' tiles; resident: one tile, the consumers apart)
  constexpr int kPer = RESIDENT ? 1 : 2;
  using M = tat::WgmmaOf<BN, kBf16>;
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + g.bar_off);
  uint64_t* empty = full + g.stages;
  uint64_t* wfull = empty + g.stages;   // resident: the weights' barrier
  uint64_t* wempty = wfull + g.wslots;
  const int tid = threadIdx.x;
  // the warpgroup, from lane 0: uniform to ptxas, which otherwise takes the
  // consumers' path as divergent and serialises their wgmma
  const int wg = __shfl_sync(0xffffffffu, tid / kWgThreads, 0);
  const int n0 = blockIdx.y * BN;
  const int first = blockIdx.x, step = gridDim.x;
  const int count = first < g.tiles ? (g.tiles - first + step - 1) / step : 0;
  // tiles walked, a stand-in after an odd count where a round is two
  const int walk = (count + kPer - 1) / kPer * kPer;
  const int row_planes = g.row_bytes / 16;
  if (tid == 0) {
    for (int s = 0; s < g.stages; ++s) {
      tat::mbar_init(full + s, 1);
      tat::mbar_init(empty + s, kWgThreads);
    }
    if (RESIDENT) {
      tat::mbar_init(wfull, 1);
    } else {
      for (int s = 0; s < g.wslots; ++s) {
        tat::mbar_init(wfull + s, 1);
        tat::mbar_init(wempty + s, kConsumers);
      }
    }
    tat::fence_barrier_init();
  }
  __syncthreads();

  if (wg == 0) {   // the producer
    tat::setmaxnreg_dec<kProducerRegs>();
    if (tid != 0) return;
    // the block's weights, tiled in device memory as their shared-memory
    // image: 128-byte TMA rows, kWBox bytes a box
    const int wrow0 = blockIdx.y * (g.wblock / 128);
    if (RESIDENT) {
      tat::mbar_arrive_tx(wfull, g.wblock);
      for (int j = 0; j < g.wblock / kWBox; ++j)
        tat::tma_load_2d(smem + j * kWBox, &wmap, 0, wrow0 + j * (kWBox / 128),
                         wfull);
    }
    for (int i0 = 0; i0 < walk; i0 += kPer) {
      for (int ch = 0; ch < g.nchunks; ++ch) {
        const int unit = i0 / kPer * g.nchunks + ch;
        for (int c = 0; c < kPer; ++c) {
          const int u = unit * kPer + c, s = u % g.stages;
          tat::mbar_wait(empty + s, ((u / g.stages) & 1) ^ 1);
          if (i0 + c >= count) {   // the stand-in: nothing to load
            tat::mbar_arrive(full + s);
            continue;
          }
          int n, oy0, ox0;
          tile_at(g, first + (i0 + c) * step, n, oy0, ox0);
          unsigned char* slot = smem + g.slab_off + s * g.slot_bytes;
          tat::mbar_arrive_tx(full + s, g.planes * SW * SW * 16);
          for (int j = 0; j < g.planes; ++j) {
            const int p = ch * g.planes + j;
            if (g.xpm)   // the plane's SW rows of 16 SW bytes
              tat::tma_load_4d(slot + j * kPlane, &xmap, 16 * ox0, oy0, p, n,
                               full + s);
            else         // its SW x SW pixels' 16 bytes
              tat::tma_load_4d(slot + j * kPlane, &xmap, 16 * p, ox0, oy0, n,
                               full + s);
          }
        }
        if (RESIDENT) continue;
        for (int tap = 0; tap < TAPS; ++tap) {
          const int u = unit * TAPS + tap, s = u % g.wslots;
          tat::mbar_wait(wempty + s, ((u / g.wslots) & 1) ^ 1);
          const int row = wrow0 + (tap * row_planes + ch * g.planes) * BN / 8;
          tat::mbar_arrive_tx(wfull + s, g.wunit_bytes);
          for (int j = 0; j < g.wunit_bytes / kWBox; ++j)
            tat::tma_load_2d(smem + s * g.wunit_bytes + j * kWBox, &wmap, 0,
                             row + j * (kWBox / 128), wfull + s);
        }
      }
    }
    return;
  }

  tat::setmaxnreg_inc<kConsumerRegs>();
  const int c = wg - 1;   // the consumer: tiles c, c + 2, ...
  float* cs_s = reinterpret_cast<float*>(smem + g.cs_off);
  for (int o = tid - kWgThreads; o < BN; o += kConsumers)
    cs_s[o] = cs != nullptr ? cs[n0 + o] : 0.0f;
  bar_sync(kBarInit, kConsumers);
  if (RESIDENT) tat::mbar_wait(wfull, 0);
  const uint64_t a0 = tat::gmma_desc(smem + g.slab_off, kPlane, SW * 16);
  const uint64_t b0 = tat::gmma_desc(smem, BN * 16, 128);
  typename M::Acc d[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) d[i] = 0;
  for (int i = c; i < walk; i += 2) {
    const int i0 = i - i % kPer;
    for (int ch = 0; ch < g.nchunks; ++ch) {
      const int unit = i0 / kPer * g.nchunks + ch;
      const int u = unit * kPer + i - i0, s = u % g.stages;
      tat::mbar_wait(full + s, (u / g.stages) & 1);
      const uint64_t a = a0 + (s * g.slot_bytes >> 4);
      // a stand-in's product runs on its slot's stale bytes and is
      // dropped: no branch around the wgmma
      if (RESIDENT) {
        tat::fence_acc(d);
        tat::wgmma_fence();
        for (int tap = 0; tap < TAPS; ++tap) {
          const int dy = tap / 3, dx = tap - 3 * dy;
          for (int ks = 0; ks < g.planes / 2; ++ks)
            M::run(d, a + dy * SW + dx + (2 * ks * kPlane >> 4),
                   b0 + (tap * row_planes + 2 * ks) * BN, (tap | ks) != 0);
        }
        tat::wgmma_commit();
        tat::wgmma_wait<0>();
        tat::fence_acc(d);
      } else {
        int prev = 0;
        for (int tap = 0; tap < TAPS; ++tap) {
          const int dy = tap / 3, dx = tap - 3 * dy;
          const int w = unit * TAPS + tap, ws = w % g.wslots;
          tat::mbar_wait(wfull + ws, (w / g.wslots) & 1);
          tat::fence_acc(d);
          tat::wgmma_fence();
          for (int ks = 0; ks < g.planes / 2; ++ks)
            M::run(d, a + dy * SW + dx + (2 * ks * kPlane >> 4),
                   b0 + ((ws * g.wunit_bytes) >> 4) + 2 * ks * BN,
                   (ch | tap | ks) != 0);
          tat::wgmma_commit();
          if (tap > 0) {   // the previous tap's unit is read: release it
            tat::wgmma_wait<1>();
            tat::mbar_arrive(wempty + prev);
          }
          prev = ws;
        }
        tat::wgmma_wait<0>();
        tat::fence_acc(d);
        tat::mbar_arrive(wempty + prev);
      }
      tat::mbar_arrive(empty + s);
    }
    if (i >= count) continue;
    int n, oy0, ox0;
    tile_at(g, first + i * step, n, oy0, ox0);
    if constexpr (kBf16) {
      store_bf16<BN>(d, g, n, oy0, ox0, n0, out);
    } else if constexpr (EP == kEpShift) {
      store_s8<BN, false>(d, g, n, oy0, ox0, n0, res, out,
                          [](int v, int, int) {
                            return static_cast<int8_t>(v >> 7);
                          });
    } else if constexpr (EP == kEpRequant) {
      store_s8<BN, false>(d, g, n, oy0, ox0, n0, res, out,
                          [&](int v, int col, int) {
                            return tat::epilogue(v, 0, cs_s[col], act,
                                                 inv_out, alpha);
                          });
    } else {   // the C3 round's SILU with the residual: the act a constant,
               // so that no assert (a call, which serialises the wgmma)
               // stays in the kernel
      store_s8<BN, true>(d, g, n, oy0, ox0, n0, res, out,
                         [&](int v, int col, int r) {
                           return tat::epilogue(v, 0, cs_s[col],
                                                tat::kActSilu, inv_out,
                                                alpha, true, r, res_scale);
                         });
    }
  }
}

using StageKernel = void (*)(const CUtensorMap, const CUtensorMap,
                             const float*, const int8_t*, unsigned char*,
                             StageGeom, int, float, float, float);

template <int EP, int TAPS, int BN>
StageKernel pick_res(bool resident) {
  return resident ? stage_wgmma_kernel<EP, TAPS, BN, true>
                  : stage_wgmma_kernel<EP, TAPS, BN, false>;
}

template <int EP, int TAPS>
StageKernel pick_bn(int bn, bool resident) {
  if (bn == 32) return pick_res<EP, TAPS, 32>(resident);
  if (bn == 64) return pick_res<EP, TAPS, 64>(resident);
  if (bn == 128) return pick_res<EP, TAPS, 128>(resident);
  return nullptr;
}

StageKernel pick(int ep, int taps, int bn, bool resident) {
  if (taps == 1) return ep == kEpRequant ? pick_bn<kEpRequant, 1>(bn, resident)
                                         : nullptr;
  if (taps != 9) return nullptr;
  switch (ep) {
    case kEpShift:
      return pick_bn<kEpShift, 9>(bn, resident);
    case kEpRequant:
      return pick_bn<kEpRequant, 9>(bn, resident);
    case kEpBf16:
      return pick_bn<kEpBf16, 9>(bn, resident);
    case kEpResidual:
      return pick_bn<kEpResidual, 9>(bn, resident);
    default:
      return nullptr;
  }
}

// The kernel of (ep, taps, K, plan) and its geometry, or null for a shape
// or plan it cannot run; opts the kernel into its shared memory.
StageKernel prepare(int ep, int taps, int K, int bn, int kc, int stages,
                    int resident, int wslots, StageGeom& g,
                    cudaError_t& err) {
  err = cudaErrorInvalidValue;
  const int row_bytes = ep == kEpBf16 ? 2 * K : K;
  if (K < 32 || K % bn != 0 || kc < 32 || kc % 32 != 0 ||
      row_bytes % kc != 0 || (resident && kc != row_bytes) || stages < 2 ||
      stages > 4 || (!resident && (wslots < 2 || wslots > 4)))
    return nullptr;
  const StageKernel k = pick(ep, taps, bn, resident != 0);
  if (k == nullptr) return nullptr;
  g.K = K;
  g.row_bytes = row_bytes;
  g.taps = taps;
  g.BN = bn;
  g.kc = kc;
  g.stages = stages;
  g.resident = resident != 0;
  g.wslots = resident ? 0 : wslots;
  stage_layout(g);
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

}  // namespace

// glue: tat::kGlueShift7 or tat::kGlueRequant (act, inv_out, alpha, cs
// [K]); x [rows, K], w [L, K, K], out [rows, K] int8; the plan as
// tat_chain_mma's (bm 128).
extern "C" int tat_megakernel_1x1(int glue, const void* x, const void* w,
                                  const void* cs, void* out, long long rows,
                                  int K, int L, int bm, int bn, int wslots,
                                  int act, float inv_out, float alpha,
                                  void* stream) {
  const tat::GlueArgs ga{static_cast<const float*>(cs), act, inv_out, alpha};
  const auto s = static_cast<cudaStream_t>(stream);
  if (glue == tat::kGlueShift7)
    return tat::launch_row_chain<tat::kGlueShift7>(x, w, out, rows, K, L, bm,
                                                   bn, wslots, ga, s);
  if (glue == tat::kGlueRequant)
    return tat::launch_row_chain<tat::kGlueRequant>(x, w, out, rows, K, L,
                                                    bm, bn, wslots, ga, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The dynamic shared memory of a 1x1 plan and the blocks of it an SM holds.
extern "C" int tat_megakernel_1x1_info(int glue, int K, int bm, int bn,
                                       int wslots, int* smem, int* blocks) {
  if (glue == tat::kGlueShift7)
    return tat::row_chain_info<tat::kGlueShift7>(K, bm, bn, wslots, smem,
                                                 blocks);
  if (glue == tat::kGlueRequant)
    return tat::row_chain_info<tat::kGlueRequant>(K, bm, bn, wslots, smem,
                                                  blocks);
  return static_cast<int>(cudaErrorInvalidValue);
}

// One stage: x [cells, e, e, K] (int8, or bf16 for ep 2), NHWC or, with
// xpm, plane-major [cells, row / 16, e, e, 16 bytes] (row: a pixel's
// bytes); w the stage's weights tiled as their shared-memory image,
// [K / bn, taps, row / 16, bn, 16 bytes] (ops/probe_kernels.py
// tile_weights; output channel n's K values contiguous in the untiled [taps,
// K, K], tap 3 dy + dx); cs [K] float32 (ep 1, 3); res [cells, e, e, K]
// int8 (ep 3; plane-major with rpm); out [cells, eo, eo, K] (plane-major
// with opm) with eo = e - 2 (taps 9) or e (taps 1, ep 1 only); x, w and
// out 16-byte aligned. ep: 0 >> 7, 1 the requantize with act, 2 bf16(acc /
// 128), 3 the requantize with SILU plus res_scale x res[1:e-1, 1:e-1]. The
// plan: bn output channels a block (32, 64 or 128, dividing K), kc bytes
// of K a slab chunk (resident: the whole row), `stages` slab slots (2-4),
// the weights resident or streamed through `wslots` slots (2-4), `blocks`
// persistent blocks a channel block (at most the tiles). Returns a cudaError_t; cudaErrorInvalidValue
// for a shape or plan it cannot run.
extern "C" int tat_megakernel_3x3(int ep, int taps, const void* x,
                                  const void* w, const void* cs,
                                  const void* res, void* out, int xpm,
                                  int rpm, int opm, int cells, int e, int K,
                                  int act, float inv_out, float alpha,
                                  float res_scale, int bn, int kc,
                                  int stages, int resident, int wslots,
                                  int blocks, void* stream) {
  const bool aligned = ((reinterpret_cast<uintptr_t>(x) |
                         reinterpret_cast<uintptr_t>(w) |
                         reinterpret_cast<uintptr_t>(out)) &
                        15u) == 0;
  const bool scaled = ep == kEpRequant || ep == kEpResidual;
  if (cells < 1 || e < (taps == 9 ? 3 : 1) || blocks < 1 || !aligned ||
      (scaled && cs == nullptr) ||
      (ep == kEpResidual && (res == nullptr || act != tat::kActSilu)) ||
      act < tat::kActNone || act > tat::kActSilu)
    return static_cast<int>(cudaErrorInvalidValue);
  StageGeom g = {};
  cudaError_t err;
  const StageKernel k =
      prepare(ep, taps, K, bn, kc, stages, resident, wslots, g, err);
  if (k == nullptr) return static_cast<int>(err);
  g.e = e;
  g.eo = taps == 9 ? e - 2 : e;
  g.xpm = xpm != 0;
  g.rpm = rpm != 0;
  g.opm = opm != 0;
  g.ntw = (g.eo + kTile - 1) / kTile;
  g.tiles_cell = g.ntw * g.ntw;
  const long long tiles = static_cast<long long>(cells) * g.tiles_cell;
  if (tiles > (1LL << 30)) return static_cast<int>(cudaErrorInvalidValue);
  g.tiles = static_cast<int>(tiles);
  const int side = slab_side(taps);
  CUtensorMap xmap, wmap;
  const uint64_t rb = static_cast<uint64_t>(g.row_bytes), ue = e;
  const uint64_t nc = static_cast<uint64_t>(cells), planes = rb / 16;
  const uint32_t us = static_cast<uint32_t>(side);
  // NHWC: a box is a plane's SW x SW pixels of 16 bytes; plane-major: its SW
  // rows of 16 SW bytes
  const uint64_t xdims_nhwc[4] = {rb, ue, ue, nc};
  const uint64_t xstrides_nhwc[3] = {rb, rb * ue, rb * ue * ue};
  const uint32_t xbox_nhwc[4] = {16, us, us, 1};
  const uint64_t xdims_pm[4] = {16 * ue, ue, planes, nc};
  const uint64_t xstrides_pm[3] = {16 * ue, 16 * ue * ue,
                                   16 * ue * ue * planes};
  const uint32_t xbox_pm[4] = {16 * us, us, 1, 1};
  const uint64_t* xdims = g.xpm ? xdims_pm : xdims_nhwc;
  const uint64_t* xstrides = g.xpm ? xstrides_pm : xstrides_nhwc;
  const uint32_t* xbox = g.xpm ? xbox_pm : xbox_nhwc;
  // the tiled weights: [K / bn][taps][row / 16][bn][16] bytes, rows of 128
  const uint64_t wdims[2] = {128, static_cast<uint64_t>(taps) * K * rb / 128};
  const uint64_t wstrides[1] = {128};
  const uint32_t wbox[2] = {128, kWBox / 128};
  err = tat::encode_s8_map(&xmap, x, 4, xdims, xstrides, xbox);
  if (err == cudaSuccess)
    err = tat::encode_s8_map(&wmap, w, 2, wdims, wstrides, wbox);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int gx = blocks < g.tiles ? blocks : g.tiles;
  const dim3 grid(static_cast<unsigned>(gx), static_cast<unsigned>(K / bn));
  k<<<grid, kThreads, static_cast<size_t>(g.smem),
      static_cast<cudaStream_t>(stream)>>>(
      xmap, wmap, static_cast<const float*>(cs),
      static_cast<const int8_t*>(res), static_cast<unsigned char*>(out), g,
      act, inv_out, alpha, res_scale);
  return static_cast<int>(cudaGetLastError());
}

// The dynamic shared memory of a plan in bytes and the blocks of it an SM
// holds at once (cudaOccupancyMaxActiveBlocksPerMultiprocessor);
// cudaErrorInvalidValue for a plan the kernel cannot run.
extern "C" int tat_megakernel_3x3_info(int ep, int taps, int K, int bn,
                                       int kc, int stages, int resident,
                                       int wslots, int* smem,
                                       int* blocks_per_sm) {
  StageGeom g = {};
  cudaError_t err;
  const StageKernel k =
      prepare(ep, taps, K, bn, kc, stages, resident, wslots, g, err);
  if (k == nullptr) return static_cast<int>(err);
  *smem = g.smem;
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, k, kThreads, static_cast<size_t>(g.smem)));
}
