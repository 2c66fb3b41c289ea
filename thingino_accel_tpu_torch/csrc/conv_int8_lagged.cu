// E2, the lagged-epilogue conv: an int8 3x3 / stride 1 / pad 1 conv,
// NHWC x OHWI -> NHWC, with the serving epilogue (bias, per-channel cs,
// NONE / RELU / LEAKY_RELU / SILU, requantize) on the tensor cores:
// out[n, y, x, o] = epilogue(sum_{dy,dx,c} x[n, y+dy-1, x+dx-1, c]
//                                          * w[o, dy, dx, c])
// with zeros outside the image. It computes what conv_int8_fused_mma.cu
// (#2 and #5) computes, bit for bit (int32 sums, the same epilogue.cuh),
// for C % 32 == 0 and O % 8 == 0 at any H and W.
//
// Replaces examples/pipeline_experiment.py:lagged (Pallas body _kernel
// :44, pallas_call :92). There a grid cell ti runs tile ti's nine tap
// dots into slot ti % 2 of a two-slot int32 VMEM accumulator and applies
// the requantize epilogue to slot (ti + 1) % 2, tile ti - 1, so that the
// TPU can overlap the VPU epilogue with the MXU dots; one more cell drains
// the last tile. Here the lag is a split of the block's warps:
//   - kProductWarps product warps run tile t's product with mma.sync s8
//     m16n8k32 (mma_tile.cuh) into registers, then store them into slot
//     t % 2 of a two-slot int32 accumulator in shared memory;
//   - kEpilogueWarps epilogue warps meanwhile read slot (t - 1) % 2, apply
//     the epilogue and store int8 NHWC; after the last product they drain
//     the last tile (the TPU's n_tiles + 1-th cell). They are as many as
//     the product warps: the SILU chain (expf, an IEEE division) runs
//     latency-bound, and 4 of them took 2.3x a tile's product (PERF.md).
//   The hand-off is by named barriers, never __syncthreads: FULL[s] (the
//   product warps bar.arrive, the epilogue warps bar.sync) and EMPTY[s]
//   (the other way round), each counting all kThreads threads; the product
//   warps' own slab ring waits at kBarProduct among themselves alone.
// LAG = 0 is the control: the same grid, threads and shared memory, but
// the product warps apply the epilogue to their own registers after each
// tile, as #5 does, and the epilogue warps leave at once; only the overlap
// differs. In both modes the act is a template constant of the epilogue
// loop (NONE, RELU, LEAKY_RELU, SILU; the wrapper refuses SILU_FAST).
//
// What bounds it on the H100: the product, 9 C MACs an output element (E2:
// 2.4e11 operations against 210 MB moved). The block owns (image, a run of
// tpb consecutive TH x TW pixel tiles of it in row-major order, BN output
// channels). Its BN x 9C weights stay resident in shared memory, loaded
// once, as E2's w_ref block stays in VMEM. Each tile's halo'd input slab,
// (TH + 2) x (TW + 2) pixels x C, comes in through a two-slot cp.async
// ring as #5 stages it: tile t + 1's copies fly while tile t is computed;
// out-of-image bytes are zero-filled by a source size of 0. A rows are
// output pixels: a tap's shifted window of the slab is read through
// per-lane ldmatrix row addresses (worked out once a kernel), B rows are
// the OHWI weight's output channels, whose 9C values are contiguous (the
// .col operand). 8 product warps tile the TP x BN block 4 x 2 with MI m16
// by NI n8 tiles each (TP = 64 MI, BN = 16 NI).
//
// Shared memory (the host's lagged_layout, mirrored by ops/probe_kernels.py
// lagged_smem): two slab slots of SH x SW pixels at a pitch of C + 16
// bytes, the weights at 9C + 16 bytes a channel (both odd multiples of 16:
// the 8 rows of an ldmatrix fall on distinct bank groups), two accumulator
// slots of TP pixels at BN + 8 words (the C fragments' 8-byte stores of a
// half-warp cover all 32 banks).
#include <cstdint>

#include <cuda_runtime.h>

#include "epilogue.cuh"
#include "mma_tile.cuh"

namespace {

constexpr int kProductWarps = 8;
constexpr int kEpilogueWarps = 8;
constexpr int kProductThreads = 32 * kProductWarps;
constexpr int kEpilogueThreads = 32 * kEpilogueWarps;
constexpr int kThreads = kProductThreads + kEpilogueThreads;
constexpr int kAccPad = 8;   // int32 words after each accumulator row

// named barrier ids (0 is __syncthreads', which this kernel never uses)
constexpr int kBarProduct = 1;
constexpr int kBarFull = 2;    // + slot
constexpr int kBarEmpty = 4;   // + slot

// --- named barriers: bar.sync waits until `count` threads (whole warps)
// have reached barrier `id` by bar.sync or bar.arrive; bar.arrive does not
// wait. Both order the shared-memory accesses before them. -----------------
__device__ __forceinline__ void bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}
// --- end of named barriers -------------------------------------------------

struct LagGeom {
  int H, W, C, O;
  int TH, TW, lg_tw;    // tile; TW = 1 << lg_tw
  int BN;               // output channels a block
  int SW;               // slab columns, TW + 2 (rows: TH + 2)
  int pitch;            // slab bytes a pixel, C + 16
  int wpitch;           // weight bytes an output channel, 9C + 16
  int apitch;           // accumulator words a pixel, BN + kAccPad
  int ntw, tiles_img, tpb, nchunk;
  int slab_bytes, w_off, acc_off, acc_bytes, smem;
};

// The shared-memory layout of one block (ops/probe_kernels.py lagged_smem
// mirrors the total).
void lagged_layout(LagGeom& g) {
  g.SW = g.TW + 2;
  g.pitch = g.C + tat::kRowPad;
  g.wpitch = 9 * g.C + tat::kRowPad;
  g.apitch = g.BN + kAccPad;
  g.slab_bytes = (g.TH + 2) * g.SW * g.pitch;
  g.w_off = 2 * g.slab_bytes;
  g.acc_off = g.w_off + g.BN * g.wpitch;
  g.acc_bytes = g.TH * g.TW * g.apitch * 4;
  g.smem = g.acc_off + 2 * g.acc_bytes;
}

__device__ __forceinline__ void tile_origin(const LagGeom& g, int tile,
                                            int& oy0, int& ox0) {
  const int trow = tile / g.ntw;
  oy0 = trow * g.TH;
  ox0 = (tile - trow * g.ntw) * g.TW;
}

// The halo'd slab of `tile` into `slot`: (TH + 2) x SW pixels of C bytes,
// 16 bytes a copy, zeros outside the image. Product threads only.
__device__ void issue_slab(const int8_t* __restrict__ x, unsigned char* slot,
                           const LagGeom& g, int n, int tile) {
  int oy0, ox0;
  tile_origin(g, tile, oy0, ox0);
  const int upp = g.C / 16;   // copies a pixel
  const int units = (g.TH + 2) * g.SW * upp;
  const long long img = static_cast<long long>(n) * g.H;
  for (int u = threadIdx.x; u < units; u += kProductThreads) {
    const int pix = u / upp, cu = u - pix * upp;
    const int r = pix / g.SW, col = pix - r * g.SW;
    const int iy = oy0 - 1 + r, ix = ox0 - 1 + col;
    const bool ok = iy >= 0 && iy < g.H && ix >= 0 && ix < g.W;
    const int8_t* src = ok ? x + ((img + iy) * g.W + ix) * g.C + 16 * cu : x;
    tat::cp_async16(slot + pix * g.pitch + 16 * cu, src, ok ? 16 : 0);
  }
}

// The epilogue warps (LAG = 1): thread et takes channel quad et % (BN / 4)
// of every (kEpilogueThreads / (BN / 4))-th pixel of a tile, reads its
// four sums with one 16-byte load and writes its four int8 with one
// 4-byte store. ACT is a constant, so the epilogue's act branches fold.
template <int BN, int ACT>
__device__ void drain_tiles(const LagGeom& g, const unsigned char* smem,
                            int n, int t0, int tiles, int n0,
                            const int* __restrict__ bias,
                            const float* __restrict__ cs, float inv_out,
                            float alpha, int8_t* __restrict__ out) {
  constexpr int kQuads = BN / 4;
  constexpr int kStep = kEpilogueThreads / kQuads;   // pixels a pass
  const int et = threadIdx.x - kProductThreads;
  const int q = et % kQuads;
  const int o = n0 + 4 * q;
  const bool live = o < g.O;   // O % 8 == 0: a quad is whole or outside
  int b[4];
  float c[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    b[j] = live && bias != nullptr ? bias[o + j] : 0;
    c[j] = live ? cs[o + j] : 0.0f;
  }
  const int tp = g.TH * g.TW;
  for (int i = 0; i < tiles; ++i) {
    const int s = i & 1;
    bar_sync(kBarFull + s, kThreads);   // tile i's sums are in slot s
    const int* acc =
        reinterpret_cast<const int*>(smem + g.acc_off + s * g.acc_bytes);
    int oy0, ox0;
    tile_origin(g, t0 + i, oy0, ox0);
#pragma unroll 4
    for (int p = et / kQuads; p < tp; p += kStep) {
      const int oy = oy0 + (p >> g.lg_tw), ox = ox0 + (p & (g.TW - 1));
      const int4 v =
          *reinterpret_cast<const int4*>(acc + p * g.apitch + 4 * q);
      if (!live || oy >= g.H || ox >= g.W) continue;
      const unsigned packed =
          static_cast<uint8_t>(tat::epilogue(v.x, b[0], c[0], ACT, inv_out,
                                             alpha)) |
          static_cast<unsigned>(static_cast<uint8_t>(tat::epilogue(
              v.y, b[1], c[1], ACT, inv_out, alpha))) << 8 |
          static_cast<unsigned>(static_cast<uint8_t>(tat::epilogue(
              v.z, b[2], c[2], ACT, inv_out, alpha))) << 16 |
          static_cast<unsigned>(static_cast<uint8_t>(tat::epilogue(
              v.w, b[3], c[3], ACT, inv_out, alpha))) << 24;
      *reinterpret_cast<unsigned*>(
          out + ((static_cast<long long>(n) * g.H + oy) * g.W + ox) * g.O +
          o) = packed;
    }
    if (i + 2 < tiles) bar_arrive(kBarEmpty + s, kThreads);   // slot s free
  }
}

// LAG = 0: the epilogue on a product warp's own sums of one tile, each
// int8 stored where it lands (as #5 stores). ACT as in drain_tiles.
template <int ACT, int MI, int NI>
__device__ __forceinline__ void store_sums(
    const int (&acc)[MI][NI][4], const LagGeom& g, int n, int oy0, int ox0,
    int ocol0, const int (&epy)[MI][2], const int (&epx)[MI][2],
    const int (&eb)[NI][2], const float (&ec)[NI][2], float inv_out,
    float alpha, int8_t* __restrict__ out) {
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int oy = oy0 + epy[mi][h], ox = ox0 + epx[mi][h];
      if (oy >= g.H || ox >= g.W) continue;
      int8_t* orow =
          out + ((static_cast<long long>(n) * g.H + oy) * g.W + ox) * g.O;
#pragma unroll
      for (int ni = 0; ni < NI; ++ni)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int o = ocol0 + ni * 8 + e;
          if (o < g.O)
            orow[o] = tat::epilogue(acc[mi][ni][2 * h + e], eb[ni][e],
                                    ec[ni][e], ACT, inv_out, alpha);
        }
    }
}

// LAG: 1 the epilogue warps drain the product's slots a tile behind, 0 the
// product warps apply it to their registers. MI m16 and NI n8 tiles a
// product warp (TP = 64 MI pixels, BN = 16 NI channels a block).
template <int LAG, int MI, int NI>
__global__ void __launch_bounds__(kThreads, 1)
    conv_int8_lagged_kernel(const int8_t* __restrict__ x,
                            const int8_t* __restrict__ w,
                            const int* __restrict__ bias,
                            const float* __restrict__ cs,
                            int8_t* __restrict__ out, LagGeom g, int act,
                            float inv_out, float alpha) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int BN = 16 * NI;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int n = blockIdx.x / g.nchunk;
  const int t0 = (blockIdx.x - n * g.nchunk) * g.tpb;
  const int rest = g.tiles_img - t0;
  const int tiles = rest < g.tpb ? rest : g.tpb;
  const int n0 = blockIdx.y * BN;
  if (warp >= kProductWarps) {
    if constexpr (LAG == 1) {
      if (act == tat::kActRelu)
        drain_tiles<BN, tat::kActRelu>(g, smem, n, t0, tiles, n0, bias, cs,
                                       inv_out, alpha, out);
      else if (act == tat::kActLeakyRelu)
        drain_tiles<BN, tat::kActLeakyRelu>(g, smem, n, t0, tiles, n0, bias,
                                            cs, inv_out, alpha, out);
      else if (act == tat::kActSilu)
        drain_tiles<BN, tat::kActSilu>(g, smem, n, t0, tiles, n0, bias, cs,
                                       inv_out, alpha, out);
      else
        drain_tiles<BN, tat::kActNone>(g, smem, n, t0, tiles, n0, bias, cs,
                                       inv_out, alpha, out);
    }
    return;
  }

  // group 0: the block's weights, BN rows of 9C bytes (rows past O zero),
  // and the first tile's slab
  const int wunits = 9 * g.C / 16;
  for (int u = tid; u < BN * wunits; u += kProductThreads) {
    const int r = u / wunits, cu = u - r * wunits;
    const bool ok = n0 + r < g.O;
    const int8_t* src =
        ok ? w + static_cast<long long>(n0 + r) * 9 * g.C + 16 * cu : w;
    tat::cp_async16(smem + g.w_off + r * g.wpitch + 16 * cu, src,
                    ok ? 16 : 0);
  }
  issue_slab(x, smem, g, n, t0);
  tat::cp_async_commit();

  // the warp's place in the block: pixels 16 MI wm .., channels 8 NI wn ..
  const int wm = warp & 3, wn = warp >> 2;
  const int gq = lane >> 2, tq = lane & 3;
  // the lane's ldmatrix rows: the slab pixel of its A row in each m16 tile
  // (tap (0, 0)), and its B row for .x4 loads of two n8 tiles: matrices
  // (tile 0, bytes 0-15), (tile 0, 16-31), (tile 1, 0-15), (tile 1, 16-31)
  int aoff[MI];
#pragma unroll
  for (int mi = 0; mi < MI; ++mi) {
    const int p = (wm * MI + mi) * 16 + tat::a_lane_row(lane);
    aoff[mi] = ((p >> g.lg_tw) * g.SW + (p & (g.TW - 1))) * g.pitch +
               tat::a_lane_byte(lane);
  }
  const unsigned char* wrow =
      smem + g.w_off +
      (wn * 8 * NI + (lane & 7) + 8 * (lane >> 4)) * g.wpitch +
      ((lane >> 3) & 1) * 16;
  // LAG = 0: the lane's channels' bias and cs, its rows' pixels
  int eb[NI][2];
  float ec[NI][2];
  int epy[MI][2], epx[MI][2];
  if constexpr (LAG == 0) {
#pragma unroll
    for (int ni = 0; ni < NI; ++ni)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int o = n0 + wn * 8 * NI + ni * 8 + 2 * tq + e;
        eb[ni][e] = o < g.O && bias != nullptr ? bias[o] : 0;
        ec[ni][e] = o < g.O ? cs[o] : 0.0f;
      }
#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int p = (wm * MI + mi) * 16 + gq + 8 * h;
        epy[mi][h] = p >> g.lg_tw;
        epx[mi][h] = p & (g.TW - 1);
      }
  }

  const int ksteps = g.C / tat::kMmaStepBytes;
  for (int i = 0; i < tiles; ++i) {
    if (i + 1 < tiles)
      issue_slab(x, smem + ((i + 1) & 1) * g.slab_bytes, g, n, t0 + i + 1);
    tat::cp_async_commit();   // empty on the last tile: keeps the count
    tat::cp_async_wait<1>();  // tile i's slab (and the weights) landed
    bar_sync(kBarProduct, kProductThreads);
    const unsigned char* slab = smem + (i & 1) * g.slab_bytes;
    int acc[MI][NI][4];
#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
#pragma unroll
      for (int ni = 0; ni < NI; ++ni)
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[mi][ni][r] = 0;
    for (int tap = 0; tap < 9; ++tap) {
      const int dy = tap / 3, dx = tap - 3 * dy;
      const unsigned char* at = slab + (dy * g.SW + dx) * g.pitch;
      const unsigned char* bt = wrow + tap * g.C;
      for (int ks = 0; ks < ksteps; ++ks) {
        const int kb = ks * tat::kMmaStepBytes;
        unsigned bfr[NI][2];
#pragma unroll
        for (int j = 0; j < NI / 2; ++j) {
          unsigned r[4];
          tat::ldsm_x4(r, bt + j * 16 * g.wpitch + kb);
          bfr[2 * j][0] = r[0];
          bfr[2 * j][1] = r[1];
          bfr[2 * j + 1][0] = r[2];
          bfr[2 * j + 1][1] = r[3];
        }
#pragma unroll
        for (int mi = 0; mi < MI; ++mi) {
          unsigned afr[4];
          tat::ldsm_x4(afr, at + aoff[mi] + kb);
#pragma unroll
          for (int ni = 0; ni < NI; ++ni)
            tat::mma_s8(acc[mi][ni], afr, bfr[ni]);
        }
      }
    }
    // every product warp has read slot i & 1: the next iteration refills it
    bar_sync(kBarProduct, kProductThreads);
    if constexpr (LAG == 0) {
      int oy0, ox0;
      tile_origin(g, t0 + i, oy0, ox0);
      const int ocol0 = n0 + wn * 8 * NI + 2 * tq;
      if (act == tat::kActRelu)
        store_sums<tat::kActRelu>(acc, g, n, oy0, ox0, ocol0, epy, epx, eb,
                                  ec, inv_out, alpha, out);
      else if (act == tat::kActLeakyRelu)
        store_sums<tat::kActLeakyRelu>(acc, g, n, oy0, ox0, ocol0, epy, epx,
                                       eb, ec, inv_out, alpha, out);
      else if (act == tat::kActSilu)
        store_sums<tat::kActSilu>(acc, g, n, oy0, ox0, ocol0, epy, epx, eb,
                                  ec, inv_out, alpha, out);
      else
        store_sums<tat::kActNone>(acc, g, n, oy0, ox0, ocol0, epy, epx, eb,
                                  ec, inv_out, alpha, out);
    } else {
      const int s = i & 1;
      if (i >= 2) bar_sync(kBarEmpty + s, kThreads);   // tile i - 2 drained
      int* slot = reinterpret_cast<int*>(smem + g.acc_off + s * g.acc_bytes);
#pragma unroll
      for (int mi = 0; mi < MI; ++mi)
#pragma unroll
        for (int ni = 0; ni < NI; ++ni) {
          const int row = (wm * MI + mi) * 16 + gq;
          const int col = wn * 8 * NI + ni * 8 + 2 * tq;
          *reinterpret_cast<int2*>(slot + row * g.apitch + col) =
              make_int2(acc[mi][ni][0], acc[mi][ni][1]);
          *reinterpret_cast<int2*>(slot + (row + 8) * g.apitch + col) =
              make_int2(acc[mi][ni][2], acc[mi][ni][3]);
        }
      bar_arrive(kBarFull + s, kThreads);
    }
  }
}

using LagKernel = void (*)(const int8_t*, const int8_t*, const int*,
                           const float*, int8_t*, LagGeom, int, float, float);

template <int LAG>
LagKernel pick(int mi, int ni) {
  if (mi == 1 && ni == 2) return conv_int8_lagged_kernel<LAG, 1, 2>;
  if (mi == 1 && ni == 4) return conv_int8_lagged_kernel<LAG, 1, 4>;
  if (mi == 2 && ni == 2) return conv_int8_lagged_kernel<LAG, 2, 2>;
  if (mi == 2 && ni == 4) return conv_int8_lagged_kernel<LAG, 2, 4>;
  return nullptr;
}

// The kernel of (lag, C, tile, bn) and its geometry, or null for a shape
// or plan the kernel cannot run; opts the kernel into its shared memory.
LagKernel prepare(int lag, int C, int tile_h, int tile_w, int bn, LagGeom& g,
                  cudaError_t& err) {
  err = cudaErrorInvalidValue;
  int lg = 0;
  while (lg < 6 && (1 << lg) != tile_w) ++lg;
  const int tp = tile_h * tile_w;
  if (C < 32 || C % 32 != 0 || lg == 6 || tile_w < 8 || tile_h < 1 ||
      (tp != 64 && tp != 128) || (bn != 32 && bn != 64) ||
      (lag != 0 && lag != 1))
    return nullptr;
  g.C = C;
  g.TH = tile_h;
  g.TW = tile_w;
  g.lg_tw = lg;
  g.BN = bn;
  lagged_layout(g);
  const LagKernel k = lag ? pick<1>(tp / 64, bn / 16) : pick<0>(tp / 64,
                                                                bn / 16);
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
  err = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             g.smem);
  return err == cudaSuccess ? k : nullptr;
}

}  // namespace

// One launch: x NHWC [batch, H, W, C] and w OHWI [O, 3, 3, C] int8 (16-byte
// aligned), bias [O] int32 or null, cs [O] float32, out NHWC [batch, H, W,
// O] int8; the plan: tile_h x tile_w output pixels a tile (64 or 128 of
// them, tile_w 8, 16 or 32), bn output channels a block (32 or 64),
// tiles_per_block consecutive tiles of one image a block. Returns a
// cudaError_t; cudaErrorInvalidValue for a shape or plan it cannot run.
extern "C" int tat_conv_int8_lagged(int lag, const void* x, const void* w,
                                    const void* bias, const void* cs,
                                    void* out, int batch, int H, int W,
                                    int C, int O, int act, float inv_out,
                                    float alpha, int tile_h, int tile_w,
                                    int bn, int tiles_per_block,
                                    void* stream) {
  const bool aligned =
      ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(w)) &
       15u) == 0 && (reinterpret_cast<uintptr_t>(out) & 3u) == 0;
  if (batch < 1 || H < 1 || W < 1 || O < 8 || O % 8 != 0 ||
      tiles_per_block < 1 || !aligned || cs == nullptr || act < 0 ||
      act > tat::kActSilu)
    return static_cast<int>(cudaErrorInvalidValue);
  LagGeom g = {};
  cudaError_t err;
  const LagKernel k = prepare(lag, C, tile_h, tile_w, bn, g, err);
  if (k == nullptr) return static_cast<int>(err);
  g.H = H;
  g.W = W;
  g.O = O;
  g.ntw = (W + tile_w - 1) / tile_w;
  g.tiles_img = (H + tile_h - 1) / tile_h * g.ntw;
  g.tpb = tiles_per_block < g.tiles_img ? tiles_per_block : g.tiles_img;
  g.nchunk = (g.tiles_img + g.tpb - 1) / g.tpb;
  const dim3 grid(static_cast<unsigned>(batch) * g.nchunk,
                  static_cast<unsigned>((O + bn - 1) / bn));
  k<<<grid, kThreads, static_cast<size_t>(g.smem),
      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(x), static_cast<const int8_t*>(w),
      static_cast<const int*>(bias), static_cast<const float*>(cs),
      static_cast<int8_t*>(out), g, act, inv_out, alpha);
  return static_cast<int>(cudaGetLastError());
}

// The dynamic shared memory of a plan in bytes and the blocks of it an SM
// holds at once (cudaOccupancyMaxActiveBlocksPerMultiprocessor), for the
// kernel of `lag`; cudaErrorInvalidValue for a plan the kernel cannot run.
extern "C" int tat_conv_int8_lagged_info(int lag, int C, int tile_h,
                                         int tile_w, int bn, int* smem,
                                         int* blocks_per_sm) {
  LagGeom g = {};
  cudaError_t err;
  const LagKernel k = prepare(lag, C, tile_h, tile_w, bn, g, err);
  if (k == nullptr) return static_cast<int>(err);
  *smem = g.smem;
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, k, kThreads, static_cast<size_t>(g.smem)));
}
