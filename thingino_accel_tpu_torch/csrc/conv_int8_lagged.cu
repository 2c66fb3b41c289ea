// E2, the lagged-epilogue conv: an int8 3x3 / stride 1 / pad 1 conv,
// NHWC x OHWI -> NHWC, with the serving epilogue (bias, per-channel cs,
// NONE / RELU / LEAKY_RELU / SILU, requantize) on Hopper's warpgroup MMA:
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
// TPU can overlap the VPU epilogue with the MXU dots. Here the two slots
// are two consumer warpgroups, each with its tile's sums in registers:
//   - LAG = 1, ordered ping-pong: warpgroup c runs the product of its tile
//     t (wgmma.mma_async, both operands from shared memory), hands the
//     tensor cores to the other warpgroup (named barriers kBarTurn + c),
//     and applies the epilogue to tile t while the other warpgroup's
//     product of tile t + 1 runs; no int32 round trip through shared
//     memory;
//   - LAG = 0, the control: the same threads and shared memory, but both
//     warpgroups run their products, then their epilogues, in lockstep
//     (kBarStep between), so that no epilogue overlaps a product.
// A producer warpgroup (one thread issues, setmaxnreg gives its registers
// to the consumers) keeps a ring of `stages` slab slots full by TMA: each
// 8 x 8 tile's halo'd 10 x 10 pixel slab comes in as C / 16 boxes of 16
// channels, one a 16-channel plane, the out-of-image pixels zero-filled by
// the tensor map (the halo costs nothing). Slot s is full[s] (the
// producer's expect_tx and the TMA bytes) and empty[s] (the consuming
// warpgroup's 128 threads after their wgmma has completed).
//
// What bounds it on the H100: the product, 9 C MACs an output element (E2:
// 2.4e11 operations against 210 MB moved). The slab planes make each
// tap's window a K-major wgmma operand with no copy: the tile's 64 pixels
// are 8 rows of 8, a core matrix each (16 bytes of channels of 8
// consecutive pixels), the next row SW x 16 bytes on (SBO), the next 16
// channels a plane on (LBO); the window of tap (dy, dx) starts (dy SW +
// dx) x 16 bytes into the plane. The block's BN x 9C weights are
// resident, loaded once by TMA as 9C / 16 planes of BN x 16 bytes (rows
// past O zero-filled), so B is K-major with LBO = 16 BN, SBO = 128. A tile
// is 9 C / 32 wgmma m64nBNk32 into 64 x BN int32 sums. The grid is
// persistent: grid.y the channel blocks, grid.x blocks walking the tiles
// blockIdx.x, + gridDim.x, ...; a block's tiles alternate between its two
// consumer warpgroups. The epilogue reads bias and cs from shared memory
// and stores 8 bytes a lane: the 4 lanes of a quad trade their 2-byte
// pieces (two shuffles) so that each holds one n8 block of its row.
//
// Shared memory (the host's lagged_layout, mirrored by ops/probe_kernels.py
// lagged_smem): the weights (9 C BN bytes), `stages` slab slots of C / 16
// planes at kPlane bytes, bias and cs (8 BN bytes), the barriers.
#include <cstdint>

#include <cuda.h>
#include <cuda_runtime.h>

#include "epilogue.cuh"
#include "hopper_async.cuh"

namespace {

constexpr int kTile = 8;                // output pixels a tile: 8 x 8
constexpr int kSW = kTile + 2;          // slab rows and columns
constexpr int kSlabPix = kSW * kSW;
constexpr int kPlane = 1664;            // 16 bytes of kSlabPix pixels, to 128
constexpr int kWgThreads = 128;
constexpr int kThreads = 3 * kWgThreads;   // producer + two consumers
constexpr int kConsumers = 2 * kWgThreads;
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;

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

// named barrier ids among the consumers (0 is __syncthreads')
constexpr int kBarTurn = 1;   // + consumer: its product may start (LAG 1)
constexpr int kBarStep = 3;   // the round's products / epilogues (LAG 0)
constexpr int kBarInit = 4;   // bias and cs staged

struct LagGeom {
  int H, W, C, O, BN, stages;
  int ntw, tiles_img, tiles;   // tiles across, an image, in all
  int slot_bytes;              // C / 16 planes
  int slab_off, col_off, bar_off, smem;
};

// The shared-memory layout of one block (ops/probe_kernels.py lagged_smem
// mirrors the total): weights at 0 (a multiple of 9216 bytes), the slots,
// bias and cs, the barriers.
void lagged_layout(LagGeom& g) {
  g.slot_bytes = g.C / 16 * kPlane;
  g.slab_off = 9 * g.C * g.BN;
  g.col_off = g.slab_off + g.stages * g.slot_bytes;
  g.bar_off = g.col_off + 8 * g.BN;
  g.smem = g.bar_off + 8 * (2 * g.stages + 1);
}

__device__ __forceinline__ void tile_at(const LagGeom& g, int k, int& n,
                                        int& oy0, int& ox0) {
  n = k / g.tiles_img;
  const int t = k - n * g.tiles_img;
  const int ty = t / g.ntw;
  oy0 = ty * kTile;
  ox0 = (t - ty * g.ntw) * kTile;
}

// One tile's product into d: 9 taps x C / 32 steps, issued as one group
// (product_wait waits for it). a0: the slot's descriptor, b0: the
// weights'.
template <int BN>
__device__ __forceinline__ void product_issue(int (&d)[BN / 2], uint64_t a0,
                                              uint64_t b0, int C) {
  tat::fence_acc(d);
  tat::wgmma_fence();
#ifndef TAT_LAGGED_NO_PRODUCT
  const int ksteps = C / 32;
  for (int tap = 0; tap < 9; ++tap) {
    const int dy = tap / 3, dx = tap - 3 * dy;
    const uint64_t a = a0 + ((dy * kSW + dx) * 16 >> 4);
    const uint64_t b = b0 + (tap * (C / 16) * BN * 16 >> 4);
    for (int ks = 0; ks < ksteps; ++ks)
      tat::Wgmma<BN>::run(d, a + (2 * ks * kPlane >> 4),
                          b + (2 * ks * BN * 16 >> 4), (tap | ks) != 0);
  }
#endif
  tat::wgmma_commit();
}
template <int BN>
__device__ __forceinline__ void product_wait(int (&d)[BN / 2]) {
  tat::wgmma_wait<0>();
  tat::fence_acc(d);
}

// The epilogue of one tile's sums in registers, 8 bytes a lane and row:
// the lane's rows g and g + 8 of warp w, its two columns of each n8 block
// (their bias and cs read once for both rows).
template <int BN, int ACT>
__device__ __forceinline__ void store_tile(const int (&d)[BN / 2],
                                           const LagGeom& g, int n, int oy0,
                                           int ox0, int n0, const int* bias_s,
                                           const float* cs_s, float inv_out,
                                           float alpha,
                                           int8_t* __restrict__ out) {
  const int t = threadIdx.x % kWgThreads, lane = t & 31;
  const int tq = lane & 3;
  int8_t* orow[2];
  bool ok[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int p = (t >> 5) * 16 + (lane >> 2) + 8 * h;   // tile pixel
    const int oy = oy0 + (p >> 3), ox = ox0 + (p & 7);
    ok[h] = oy < g.H && ox < g.W;
    orow[h] = out +
              ((static_cast<long long>(n) * g.H + oy) * g.W + ox) * g.O + n0;
  }
#pragma unroll
  for (int q = 0; q < BN / 32; ++q) {
    int2 b2[4];
    float2 c2[4];
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const int col = 8 * (4 * q + jj) + 2 * tq;
      b2[jj] = *reinterpret_cast<const int2*>(bias_s + col);
      c2[jj] = *reinterpret_cast<const float2*>(cs_s + col);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      unsigned u[4];   // the lane's 2 bytes of n8 blocks 4 q .. 4 q + 3
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int j = 4 * q + jj;
        const int8_t lo = tat::epilogue(d[4 * j + 2 * h], b2[jj].x, c2[jj].x,
                                        ACT, inv_out, alpha);
        const int8_t hi = tat::epilogue(d[4 * j + 2 * h + 1], b2[jj].y,
                                        c2[jj].y, ACT, inv_out, alpha);
        u[jj] = static_cast<uint8_t>(lo) |
                static_cast<unsigned>(static_cast<uint8_t>(hi)) << 8;
      }
      // the quad's 4 x 4 pieces transposed: lane tq ends with block
      // 4 q + tq, the pieces of lanes 0..3 in order
      const uint2 v = tat::quad_gather8(u, lane);
      const int blk = 4 * q + tq;
      if (ok[h] && n0 + 8 * blk < g.O)
        *reinterpret_cast<uint2*>(orow[h] + 8 * blk) = v;
    }
  }
}

template <int LAG, int BN, int ACT>
__global__ void __launch_bounds__(kThreads, 1)
    conv_lagged_wgmma_kernel(const __grid_constant__ CUtensorMap xmap,
                             const __grid_constant__ CUtensorMap wmap,
                             const int* __restrict__ bias,
                             const float* __restrict__ cs,
                             int8_t* __restrict__ out, LagGeom g,
                             float inv_out, float alpha) {
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + g.bar_off);
  uint64_t* empty = full + g.stages;
  uint64_t* wbar = empty + g.stages;
  const int tid = threadIdx.x;
  // the warpgroup, from lane 0: uniform to ptxas, which otherwise takes the
  // consumers' path as divergent and serialises their wgmma
  const int wg = __shfl_sync(0xffffffffu, tid / kWgThreads, 0);
  const int n0 = blockIdx.y * BN;
  const int first = blockIdx.x, step = gridDim.x;
  const int count = first < g.tiles ? (g.tiles - first + step - 1) / step : 0;
  const int planes = g.C / 16;
  if (tid == 0) {
    for (int s = 0; s < g.stages; ++s) {
      tat::mbar_init(full + s, 1);
      tat::mbar_init(empty + s, kWgThreads);
    }
    tat::mbar_init(wbar, 1);
    tat::fence_barrier_init();
  }
  __syncthreads();

  if (wg == 0) {   // the producer
    tat::setmaxnreg_dec<kProducerRegs>();
    if (tid != 0) return;
    tat::mbar_arrive_tx(wbar, 9 * g.C * BN);
    for (int j = 0; j < 9 * planes; ++j)
      tat::tma_load_2d(smem + j * BN * 16, &wmap, 16 * j, n0, wbar);
    for (int i = 0; i < count; ++i) {
      const int s = i % g.stages, k = i / g.stages;
      tat::mbar_wait(empty + s, (k & 1) ^ 1);   // use k - 1 released
      int n, oy0, ox0;
      tile_at(g, first + i * step, n, oy0, ox0);
      unsigned char* slot = smem + g.slab_off + s * g.slot_bytes;
#ifndef TAT_LAGGED_NO_LOAD
      tat::mbar_arrive_tx(full + s, planes * kSlabPix * 16);
      for (int j = 0; j < planes; ++j)
        tat::tma_load_4d(slot + j * kPlane, &xmap, 16 * j, ox0 - 1, oy0 - 1,
                         n, full + s);
#else
      (void)slot;
      tat::mbar_arrive(full + s);
#endif
    }
    return;
  }

  tat::setmaxnreg_inc<kConsumerRegs>();
  const int c = wg - 1;   // the consumer: tiles c, c + 2, ...
  int* bias_s = reinterpret_cast<int*>(smem + g.col_off);
  float* cs_s = reinterpret_cast<float*>(bias_s + BN);
  for (int o = tid - kWgThreads; o < BN; o += kConsumers) {
    const bool live = n0 + o < g.O;
    bias_s[o] = live && bias != nullptr ? bias[n0 + o] : 0;
    cs_s[o] = live ? cs[n0 + o] : 0.0f;
  }
  bar_sync(kBarInit, kConsumers);
  tat::mbar_wait(wbar, 0);
  const uint64_t a0 = tat::gmma_desc(smem + g.slab_off, kPlane, kSW * 16);
  const uint64_t b0 = tat::gmma_desc(smem, BN * 16, 128);
  int d[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) d[i] = 0;
  for (int i = c; i < count; i += 2) {
    const int s = i % g.stages, k = i / g.stages;
    const bool pair = (i | 1) < count;   // LAG 0: both consumers this round
#ifdef TAT_LAGGED_NO_TURN
    constexpr bool kTurn = false;
#else
    constexpr bool kTurn = LAG == 1;
#endif
    if (kTurn && i > 0) bar_sync(kBarTurn + c, kConsumers);
    tat::mbar_wait(full + s, k & 1);
    product_issue<BN>(d, a0 + (s * g.slot_bytes >> 4), b0, g.C);
#ifndef TAT_LAGGED_TURN_AFTER_WAIT
    // LAG 1: the other consumer's wgmma queue behind this one's
    if (kTurn && i + 1 < count) bar_arrive(kBarTurn + 1 - c, kConsumers);
    product_wait<BN>(d);
#else
    product_wait<BN>(d);
    if (kTurn && i + 1 < count) bar_arrive(kBarTurn + 1 - c, kConsumers);
#endif
    tat::mbar_arrive(empty + s);
    if (LAG == 0 && pair) bar_sync(kBarStep, kConsumers);
    int n, oy0, ox0;
    tile_at(g, first + i * step, n, oy0, ox0);
#ifndef TAT_LAGGED_NO_STORE
    store_tile<BN, ACT>(d, g, n, oy0, ox0, n0, bias_s, cs_s, inv_out, alpha,
                        out);
#else
    // the sums kept alive (ptxas drops a wgmma whose sums are dead)
    int live = 0;
#pragma unroll
    for (int r = 0; r < BN / 2; ++r) live ^= d[r];
    if (live == 0x5eed1e55) out[n] = static_cast<int8_t>(oy0 + ox0);
#endif
    if (LAG == 0 && pair) bar_sync(kBarStep, kConsumers);
  }
}

using LagKernel = void (*)(const CUtensorMap, const CUtensorMap, const int*,
                           const float*, int8_t*, LagGeom, float, float);

template <int LAG, int BN>
LagKernel pick_act(int act) {
  if (act == tat::kActRelu) return conv_lagged_wgmma_kernel<LAG, BN, 1>;
  if (act == tat::kActLeakyRelu) return conv_lagged_wgmma_kernel<LAG, BN, 2>;
  if (act == tat::kActSilu) return conv_lagged_wgmma_kernel<LAG, BN, 3>;
  return conv_lagged_wgmma_kernel<LAG, BN, 0>;
}

template <int LAG>
LagKernel pick(int bn, int act) {
  if (bn == 32) return pick_act<LAG, 32>(act);
  if (bn == 64) return pick_act<LAG, 64>(act);
  return pick_act<LAG, 128>(act);
}

// The kernel of (lag, C, bn, stages, act) and its geometry, or null for a
// shape or plan the kernel cannot run; opts the kernel into its shared
// memory.
LagKernel prepare(int lag, int C, int bn, int stages, int act, LagGeom& g,
                  cudaError_t& err) {
  err = cudaErrorInvalidValue;
  if (C < 32 || C % 32 != 0 || (bn != 32 && bn != 64 && bn != 128) ||
      stages < 2 || stages > 4 || (lag != 0 && lag != 1) || act < 0 ||
      act > tat::kActSilu)
    return nullptr;
  g.C = C;
  g.BN = bn;
  g.stages = stages;
  lagged_layout(g);
  const LagKernel k = lag ? pick<1>(bn, act) : pick<0>(bn, act);
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
// O] int8 (16-byte aligned); the plan: bn output channels a block (32, 64
// or 128), `stages` slab slots (2-4), `blocks` persistent blocks a channel
// block (at most the tiles). Returns a cudaError_t; cudaErrorInvalidValue
// for a shape or plan it cannot run.
extern "C" int tat_conv_int8_lagged(int lag, const void* x, const void* w,
                                    const void* bias, const void* cs,
                                    void* out, int batch, int H, int W,
                                    int C, int O, int act, float inv_out,
                                    float alpha, int bn, int stages,
                                    int blocks, void* stream) {
  const bool aligned = ((reinterpret_cast<uintptr_t>(x) |
                         reinterpret_cast<uintptr_t>(w) |
                         reinterpret_cast<uintptr_t>(out)) &
                        15u) == 0;
  if (batch < 1 || H < 1 || W < 1 || O < 8 || O % 8 != 0 || blocks < 1 ||
      !aligned || cs == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  LagGeom g = {};
  cudaError_t err;
  const LagKernel k = prepare(lag, C, bn, stages, act, g, err);
  if (k == nullptr) return static_cast<int>(err);
  g.H = H;
  g.W = W;
  g.O = O;
  g.ntw = (W + kTile - 1) / kTile;
  g.tiles_img = (H + kTile - 1) / kTile * g.ntw;
  const long long tiles = static_cast<long long>(batch) * g.tiles_img;
  if (tiles > (1LL << 30)) return static_cast<int>(cudaErrorInvalidValue);
  g.tiles = static_cast<int>(tiles);
  CUtensorMap xmap, wmap;
  const uint64_t xdims[4] = {static_cast<uint64_t>(C),
                             static_cast<uint64_t>(W),
                             static_cast<uint64_t>(H),
                             static_cast<uint64_t>(batch)};
  const uint64_t xstrides[3] = {static_cast<uint64_t>(C),
                                static_cast<uint64_t>(W) * C,
                                static_cast<uint64_t>(H) * W * C};
  const uint32_t xbox[4] = {16, kSW, kSW, 1};
  const uint64_t wdims[2] = {static_cast<uint64_t>(9) * C,
                             static_cast<uint64_t>(O)};
  const uint64_t wstrides[1] = {static_cast<uint64_t>(9) * C};
  const uint32_t wbox[2] = {16, static_cast<uint32_t>(bn)};
  err = tat::encode_s8_map(&xmap, x, 4, xdims, xstrides, xbox);
  if (err == cudaSuccess)
    err = tat::encode_s8_map(&wmap, w, 2, wdims, wstrides, wbox);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int gx = blocks < g.tiles ? blocks : g.tiles;
  const dim3 grid(static_cast<unsigned>(gx),
                  static_cast<unsigned>((O + bn - 1) / bn));
  k<<<grid, kThreads, static_cast<size_t>(g.smem),
      static_cast<cudaStream_t>(stream)>>>(
      xmap, wmap, static_cast<const int*>(bias),
      static_cast<const float*>(cs), static_cast<int8_t*>(out), g, inv_out,
      alpha);
  return static_cast<int>(cudaGetLastError());
}

// The dynamic shared memory of a plan in bytes and the blocks of it an SM
// holds at once (cudaOccupancyMaxActiveBlocksPerMultiprocessor), for the
// kernel of `lag` (at SILU); cudaErrorInvalidValue for a plan the kernel
// cannot run.
extern "C" int tat_conv_int8_lagged_info(int lag, int C, int bn, int stages,
                                         int* smem, int* blocks_per_sm) {
  LagGeom g = {};
  cudaError_t err;
  const LagKernel k = prepare(lag, C, bn, stages, tat::kActSilu, g, err);
  if (k == nullptr) return static_cast<int>(err);
  *smem = g.smem;
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, k, kThreads, static_cast<size_t>(g.smem)));
}
