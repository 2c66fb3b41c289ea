// The fused C3 bottleneck on the tensor cores, NHWC int8:
//   m   = epilogue1(x[N, H, W, C] @ w1[CM, C]^T)                (1x1)
//   out = epilogue2(conv_KxK/1(m, w2 OHWI [O, K, K, CM]) [, + x])
// with SAME zero padding of m (K odd), the intermediate m never in device
// memory. Both epilogues are epilogue.cuh's serving epilogue (per-channel
// cs, the act, the shortcut r x res_scale after epilogue2's act).
//
// Replaces thingino_accel_tpu/ops/fused_kernels.py:bottleneck_int8_fused
// (:1241, call :1344; Pallas body _bneck_kernel :1186), which computes the
// 1x1 over a row tile plus its K-1 halo rows in VMEM, masks positions
// outside the image to the quantized zero (not epilogue1(bias): the KxK conv
// pads m with zeros), runs the KxK taps on the live value and adds the
// shortcut from the same x slab. The W fold and the 128-lane padding are
// TPU layout and are left out.
//
// What bounds it on the H100: the pair's MACs are about K^2 + 1 times those
// of the 1x1 alone, a few hundred int8 operations a byte of x, and at the
// paths' C = CM = O = 32..256 the SILU epilogues (about 40 instructions an
// element, twice an output pixel) weigh as much as the products. Without
// the fusion m makes a round trip through device memory; with it, one x
// read and one out write a pixel. Design, on the KxK core of
// conv_mma_core.cuh (its warp tiling, slab-mode tap loop, mma_k32 product
// step and staged store_tile; no dp4a):
//   - a block owns BN output channels and a run of TH x TW output tiles
//     (consecutive in (image, tile column, tile row) order: a run walks down
//     columns of tiles and may cross columns and images);
//     8 warps tile the TP = TH TW pixels x BN channels 4 x 2 with MI m16 x
//     NI n8 mma.sync s8 tiles each (TP = 64 MI, BN = 16 NI);
//   - w1 (all CM rows) is resident in shared memory, loaded once a run, and
//     so are the block's BN rows of w2 (K K CMp + 16 bytes a row, each tap's
//     CM bytes at tap x CMp) where they fit; at a wide CM they are streamed
//     instead, a tap's BN rows (CMp + 16 bytes each) at a time through a
//     two-slot cp.async ring, so that the block holds all O channels (no
//     recompute of stage 1) or two blocks share an SM. C and CM are
//     zero-filled up to multiples of 32 (Cp, CMp), so every shape runs the
//     one product (no im2col mode);
//   - the tile's halo'd x slab, (TH + K - 1) x (TW + K - 1) pixels x Cp at a
//     pitch of Cp + 16, comes in by 16-byte cp.async copies (zeros outside
//     the image and past C; byte loads where C % 16 != 0 or x is off
//     16-byte alignment; the core's slab-mode copies need C % 32 == 0 and
//     aligned x);
//   - stage 1: the 1x1 as mma.sync over the slab's pixels (items of 16
//     pixels x 32 channels over the warps, the core's mma_k32), epilogue1 on
//     the fragments, m written as int8 into the m slab at the core's slab
//     layout (pitch CMp + 16), zeros at out-of-image positions. Where the
//     run's previous tile is the one above, its bottom K - 1 rows of m are
//     copied to the top and only the other TH rows are computed. The blocks
//     of one tile's O / BN channel blocks each recompute it: stage 1 is about
//     1 / K^2 of the MACs, and the planner (ops/fused_kernels.py bneck_plan)
//     weighs that recompute against larger blocks;
//   - the shortcut's bytes are copied from the x slab's centre into the
//     staged output tile, and the next tile's x slab then comes in while
//     stage 2 runs;
//   - stage 2: the core's slab-mode product (slab_taps) over the m slab
//     (per-lane ldmatrix row addresses, a tap adding a uniform pitch, w2
//     resident or its tap's slice from the ring),
//     then the core's store_tile: epilogue2 (ServingEpilogue<ACT2>) on the
//     fragments, reading the staged shortcut, the tile out 16 bytes a
//     thread.
// ACT2 is a template constant (EP2 = ServingEpilogue<ACT2>); ACT1 is SILU
// (the paths' act) or read at run time (kAnyAct), so every pair of acts
// runs without compiling each pair. The JAX modes take EP2 =
// ServingModeEpilogue<BF16> and kAnyAct: both acts at run time, SILU_FAST
// (TAT_FAST_SILU) among them; with BF16 (TAT_SERVING_COMPUTE=bf16) both
// stages' products are the bf16 product of the same int8 values on f32
// sums (mma_tile.cuh mma_k32_bf16) and both epilogues start from (sum +
// f32(bias)) x cs, as the JAX kernel's f32 branch: equal to the s8
// products while every partial sum stays below 2^24 in magnitude.
// Every multiply and add of an epilogue is an explicit round-to-nearest
// intrinsic (epilogue.cuh).
//
// Shared memory (bneck_layout, mirrored by ops/fused_kernels.py
// bneck_layout), all dynamic: the x slab, the m slab, w1 (CMp rows of Cp +
// 16), w2 (BN rows of K K CMp + 16, or the ring's two slots of BN rows of
// CMp + 16), CMp stage-1 columns (bias, cs), the staged output tile (TP
// pixels of BN + 16). Every ldmatrix pitch is an odd multiple of 16 bytes.
#include <cstdint>
#include <type_traits>

#include <cuda_runtime.h>

#include "conv_mma_core.cuh"

namespace {

constexpr int kAnyAct = -1;   // stage 1's act read at run time

// what stage 1 keeps of one channel of m
struct Col1 {
  int b;
  float cs;
};

struct BneckGeom {
  int H, W, C, CM, O, K, hh;       // hh = (K - 1) / 2
  int BN, resident;                // w2 resident, or streamed a tap a slice
  int Cp, CMp;                     // C, CM rounded up to 32
  int SW, halo;                    // slab columns; slab pixels (SH SW)
  int xpitch, mpitch, w2pitch;     // Cp + 16, CMp + 16, w2's row pitch
  int m_off, w1_off, w2_off, col_off, out_off, smem;
  int tiles, tpb, nth;             // batch x tiles an image, tiles a run,
                                   // tile rows an image
  int vec_x, vec_w1, vec_w2;       // 16-byte copies of x, w1, w2
  int act1;
  float inv1, alpha1;
  FastDiv by_sw, by_tiles, by_nth;   // slab pixel -> row; tile -> image;
                                     // tile -> tile column
  ConvGeom out;   // store_tile's: TH, TW, lg_tw, ntw, tiles_img, O, OH, OW
};

// An image's tiles are walked down each column of tiles (column-major), so
// that consecutive tiles of a run share K - 1 rows of m. Tile index ct of
// an image -> its row-major index (tile_origin's and store_tile's) and its
// tile row.
__device__ __forceinline__ int row_major(const BneckGeom& g, int ct,
                                         int& trow) {
  const int tcol = quot(g.by_nth, ct);
  trow = ct - tcol * g.nth;
  return trow * g.out.ntw + tcol;
}

// The shared-memory layout of one block (ops/fused_kernels.py bneck_layout
// mirrors it); g's C, CM, K, BN, resident and out.TH, out.TW set.
void bneck_layout(BneckGeom& g) {
  const int sh = g.out.TH + g.K - 1;
  g.SW = g.out.TW + g.K - 1;
  g.halo = sh * g.SW;
  g.Cp = round_up(g.C, tat::kMmaStepBytes);
  g.CMp = round_up(g.CM, tat::kMmaStepBytes);
  g.xpitch = g.Cp + tat::kRowPad;
  g.mpitch = g.CMp + tat::kRowPad;
  // resident: BN rows of all K K taps; streamed: two slots of one tap's
  // BN rows
  g.w2pitch = (g.resident ? g.K * g.K * g.CMp : g.CMp) + tat::kRowPad;
  g.m_off = g.halo * g.xpitch;
  g.w1_off = g.m_off + g.halo * g.mpitch;
  g.w2_off = g.w1_off + g.CMp * g.xpitch;
  g.col_off = g.w2_off + (g.resident ? 1 : 2) * g.BN * g.w2pitch;
  g.out_off = g.col_off + g.CMp * static_cast<int>(sizeof(Col1));
  g.smem = g.out_off + g.out.TH * g.out.TW * (g.BN + kOutPad);
  g.by_sw = fast_div(g.SW);
}

// The halo'd x slab of global tile T (image T / tiles_img): Cp bytes a
// pixel at xpitch, zeros outside the image and past C; 16-byte cp.async
// copies (g.vec_x) or byte loads.
__device__ void load_x_slab(const BneckGeom& g, const int8_t* __restrict__ x,
                            unsigned char* xs, int T) {
  const int n = quot(g.by_tiles, T);
  int trow, oy0, ox0;
  tile_origin(g.out, row_major(g, T - n * g.out.tiles_img, trow), oy0, ox0);
  const int iy0 = oy0 - g.hh, ix0 = ox0 - g.hh;
  const int upp = g.Cp / 16;   // 16-byte units a pixel
  const long long img = static_cast<long long>(n) * g.H;
  for (int u = threadIdx.x; u < g.halo * upp; u += kThreads) {
    const int r = u / upp, c = 16 * (u - r * upp);
    const int hy = quot(g.by_sw, r);
    const int iy = iy0 + hy, ix = ix0 + r - hy * g.SW;
    const int left = g.C - c;
    const int bytes = iy < 0 || iy >= g.H || ix < 0 || ix >= g.W || left <= 0
                          ? 0
                          : (left < 16 ? left : 16);
    const int8_t* src = bytes > 0 ? x + ((img + iy) * g.W + ix) * g.C + c : x;
    unsigned char* dst = xs + r * g.xpitch + c;
    if (g.vec_x)
      tat::cp_async16(dst, src, bytes);
    else
      *reinterpret_cast<uint4*>(dst) = tat::load16_bytes(src, bytes);
  }
}

// Stage 1 of tile `tile` (row-major) of image n: m = epilogue1(x slab @
// w1^T) over the slab's pixels from r_begin on (the rows before it carried
// from the tile above) into the m slab, 0 at pixels outside the image and
// at channels past CM. A warp's item is one m16 tile of slab pixels (rows
// past the slab read its last pixel and are not written) x 8 NI1 channels:
// 32 where CM is wide (fewer B fragment loads an MMA), 16 where it is
// narrow, so that its few items still spread over the warps. Where the
// channel groups divide the 8 warps, a warp's items all take one group,
// and the lane keeps its channels' bias and cs in registers.
// epilogue1 of one sum (int32, or f32 from the bf16 product): the act, with
// SILU_FAST compiled in where kSiluFast (the modes' kernels)
template <bool kSiluFast, class Acc>
__device__ __forceinline__ int8_t epilogue1(Acc acc, const Col1& col, int act,
                                            float inv1, float alpha1) {
  if constexpr (std::is_same<Acc, float>::value)
    return tat::act_requant<kSiluFast>(
        __fmul_rn(__fadd_rn(acc, __int2float_rn(col.b)), col.cs), act, inv1,
        alpha1, false, 0, 0.0f);
  else
    return tat::epilogue<kSiluFast>(acc, col.b, col.cs, act, inv1, alpha1);
}

template <int ACT1, int NI1, class EP>
__device__ void stage1(const BneckGeom& g, const unsigned char* xs,
                       const unsigned char* w1s, const Col1* cols1,
                       unsigned char* ms, int n, int tile, int r_begin) {
  constexpr int kCh = 8 * NI1;   // channels an item
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gq = lane >> 2, tq = lane & 3;
  int oy0, ox0;
  tile_origin(g.out, tile, oy0, ox0);
  const int iy0 = oy0 - g.hh, ix0 = ox0 - g.hh;
  const int act = ACT1 == kAnyAct ? g.act1 : ACT1;
  const int nq = g.CMp / kCh;
  const int items = (g.halo - r_begin + 15) / 16 * nq;
  const int brow = ((lane & 7) + 8 * (lane >> 4)) * g.xpitch +
                   ((lane >> 3) & 1) * 16;
  const bool fixed = 8 % nq == 0;   // the warp's channel group is fixed
  Col1 lc[NI1][2];
#pragma unroll
  for (int ni = 0; ni < NI1; ++ni)
#pragma unroll
    for (int e = 0; e < 2; ++e)
      lc[ni][e] = cols1[kCh * (warp % nq) + ni * 8 + 2 * tq + e];
  for (int item = warp; item < items; item += kThreads / 32) {
    const int mt = item / nq, c0 = kCh * (item - mt * nq);
    const int ra = r_begin + 16 * mt + tat::a_lane_row(lane);
    const int aoff[1] = {(ra < g.halo ? ra : g.halo - 1) * g.xpitch +
                         tat::a_lane_byte(lane)};
    typename EP::Acc acc[1][NI1][4] = {};
    const unsigned char* bt = w1s + c0 * g.xpitch + brow;
    for (int kb = 0; kb < g.Cp; kb += tat::kMmaStepBytes)
      if constexpr (kProduct)
        mma_k32<1, NI1>(acc, xs + kb, aoff, bt + kb, g.xpitch);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = r_begin + 16 * mt + gq + 8 * h;
      if (r >= g.halo) continue;
      const int hy = quot(g.by_sw, r);
      const int iy = iy0 + hy, ix = ix0 + r - hy * g.SW;
      const bool inside = iy >= 0 && iy < g.H && ix >= 0 && ix < g.W;
#pragma unroll
      for (int ni = 0; ni < NI1; ++ni) {
        const int c = c0 + ni * 8 + 2 * tq;
        unsigned q[2] = {0, 0};
#pragma unroll
        for (int e = 0; e < 2; ++e)
          if (inside && c + e < g.CM) {
            const Col1 col = fixed ? lc[ni][e] : cols1[c + e];
            q[e] = static_cast<uint8_t>(epilogue1<EP::kSiluFast>(
                acc[0][ni][2 * h + e], col, act, g.inv1, g.alpha1));
          }
        *reinterpret_cast<uint16_t*>(ms + r * g.mpitch + c) =
            static_cast<uint16_t>(q[0] | q[1] << 8);
      }
    }
  }
}

// The K - 1 bottom rows of the m slab, the next tile's top rows where it
// is the tile below in the same column of tiles (TH >= K - 1, so the rows
// copied and the rows written do not meet).
__device__ void carry_rows(const BneckGeom& g, unsigned char* ms) {
  const int bytes = (g.K - 1) * g.SW * g.mpitch;
  const unsigned char* src = ms + g.out.TH * g.SW * g.mpitch;
  for (int u = 16 * threadIdx.x; u < bytes; u += 16 * kThreads)
    *reinterpret_cast<uint4*>(ms + u) =
        *reinterpret_cast<const uint4*>(src + u);
}

// The shortcut of the tile's TP pixels and channels n0 .. n0 + BN, from the
// x slab's centre into the staged output tile (16 bytes a copy; zeros past
// O), where store_tile's lanes read it.
template <int TP, int BN>
__device__ void stage_shortcut(const BneckGeom& g, const unsigned char* xs,
                               unsigned char* staged, int n0) {
  constexpr int upp = BN / 16;
  const int live = g.O - n0 < BN ? g.O - n0 : BN;
  for (int u = threadIdx.x; u < TP * upp; u += kThreads) {
    const int p = u / upp, c = 16 * (u - p * upp);
    const int r = ((p >> g.out.lg_tw) + g.hh) * g.SW + (p & (g.out.TW - 1)) +
                  g.hh;
    *reinterpret_cast<uint4*>(staged + p * (BN + kOutPad) + c) =
        c < live ? *reinterpret_cast<const uint4*>(xs + r * g.xpitch + n0 + c)
                 : make_uint4(0, 0, 0, 0);
  }
}

template <int MI, int NI, int ACT1, class EP2>
__global__ void __launch_bounds__(kThreads, MI * NI >= 8 ? 1 : 2)
    bneck_mma_kernel(const int8_t* __restrict__ x,
                     const int8_t* __restrict__ w1,
                     const int* __restrict__ b1, const float* __restrict__ cs1,
                     const int8_t* __restrict__ w2,
                     const int* __restrict__ b2, int8_t* __restrict__ out,
                     BneckGeom g, typename EP2::Params ep2) {
  using Acc = typename EP2::Acc;
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int BN = 16 * NI, TP = 64 * MI;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = warp & 3, wn = warp >> 2, tq = lane & 3;
  const int n0 = blockIdx.y * BN;
  const int t0 = blockIdx.x * g.tpb;
  const int tiles = g.tiles - t0 < g.tpb ? g.tiles - t0 : g.tpb;
  unsigned char* xs = smem;
  unsigned char* ms = smem + g.m_off;
  unsigned char* w1s = smem + g.w1_off;
  unsigned char* w2s = smem + g.w2_off;
  auto* cols1 = reinterpret_cast<Col1*>(smem + g.col_off);
  unsigned char* staged = smem + g.out_off;

  // the lane's stage-2 A rows (its pixel of each m16 tile at tap (0, 0) of
  // the m slab), its B row for .x4 loads of two n8 tiles, its channels
  int aoff[MI];
#pragma unroll
  for (int mi = 0; mi < MI; ++mi) {
    const int p = (wm * MI + mi) * 16 + tat::a_lane_row(lane);
    aoff[mi] = ((p >> g.out.lg_tw) * g.SW + (p & (g.out.TW - 1))) * g.mpitch +
               tat::a_lane_byte(lane);
  }
  const int brow = (wn * 8 * NI + (lane & 7) + 8 * (lane >> 4)) * g.w2pitch +
                   ((lane >> 3) & 1) * 16;
  typename EP2::Col cols[NI][2];
#pragma unroll
  for (int ni = 0; ni < NI; ++ni)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int o = n0 + wn * 8 * NI + ni * 8 + 2 * tq + e;
      cols[ni][e] = EP2::col(b2, ep2, o, o < g.O);
    }

  // group 0: the resident weights, stage 1's columns and tile t0's x slab
  const int taps = g.K * g.K;
  const int8_t* w2b = w2 + static_cast<long long>(n0) * taps * g.CM;
  load_weight_rows(w1, w1s, g.CMp, g.CM, 1, g.C, g.Cp, g.xpitch, g.C,
                   g.vec_w1);
  if (g.resident)
    load_weight_rows(w2b, w2s, BN, g.O - n0, taps, g.CM, g.CMp, g.w2pitch,
                     static_cast<long long>(taps) * g.CM, g.vec_w2);
  for (int c = tid; c < g.CMp; c += kThreads)
    cols1[c] = c < g.CM ? Col1{b1 != nullptr ? b1[c] : 0, cs1[c]}
                        : Col1{0, 0.0f};
  load_x_slab(g, x, xs, t0);
  tat::cp_async_commit();
  // a streamed w2's slice of tap j into slot j & 1
  auto w2_slice = [&](int j) {
    load_weight_rows(w2b + j * g.CM, w2s + (j & 1) * BN * g.w2pitch, BN,
                     g.O - n0, 1, g.CM, g.CMp, g.w2pitch,
                     static_cast<long long>(taps) * g.CM, g.vec_w2);
  };
  for (int t = 0; t < tiles; ++t) {
    tat::cp_async_wait<0>();   // this tile's x slab (and the weights)
    __syncthreads();           // ... for every thread; m, w2, staged free
    if (!g.resident) {         // tap 0's slice flies during stage 1
      w2_slice(0);
      tat::cp_async_commit();
    }
    const int T = t0 + t;
    const int n = quot(g.by_tiles, T);
    int trow;
    const int tile = row_major(g, T - n * g.out.tiles_img, trow);
    // the tile above in this run left its bottom rows of m at the top
    const bool carried = t > 0 && trow > 0 && g.out.TH >= g.K - 1;
    const int r_begin = carried ? (g.K - 1) * g.SW : 0;
    if (g.CMp <= 64)
      stage1<ACT1, 2, EP2>(g, xs, w1s, cols1, ms, n, tile, r_begin);
    else
      stage1<ACT1, 4, EP2>(g, xs, w1s, cols1, ms, n, tile, r_begin);
    if (ep2.res != nullptr) stage_shortcut<TP, BN>(g, xs, staged, n0);
    __syncthreads();   // m and the shortcut visible; the x slab is read
    const bool more = t + 1 < tiles;
    if (g.resident) {
      if (more) load_x_slab(g, x, xs, T + 1);
      tat::cp_async_commit();
    }
    Acc acc[MI][NI][4] = {};
    // w2 resident (tap j's rows at j CMp) or a two-slot ring of taps
    slab_taps<MI, NI>(
        acc, ms, aoff, g.K, g.K, 1, 1, g.SW, g.mpitch, g.CMp, w2s + brow,
        g.resident ? g.CMp : BN * g.w2pitch, g.resident ? 0 : 2, g.w2pitch,
        [&](int tap) {
          if (g.resident) return;
          tat::cp_async_wait<0>();   // tap's slice landed
          __syncthreads();           // ... for every thread; the other
          if (tap + 1 < taps) w2_slice(tap + 1);   // slot is read
          // the next x slab beside tap 1's slice
          if (tap == 0 && more) load_x_slab(g, x, xs, T + 1);
          tat::cp_async_commit();
        });
    if constexpr (kStore)
      store_tile<MI, NI, EP2, false>(acc, cols, g.out, staged, nullptr, n,
                                     tile, n0, ep2, out);
    else
      sink_tile<MI, NI>(acc, out), __syncthreads();
    // every thread's reads of m ended at store_tile's barrier
    if (more && trow + 1 < g.nth && g.out.TH >= g.K - 1) carry_rows(g, ms);
  }
}

template <class P>
using BneckKernel = void (*)(const int8_t*, const int8_t*, const int*,
                             const float*, const int8_t*, const int*, int8_t*,
                             BneckGeom, P);

template <int ACT1, class EP2>
BneckKernel<typename EP2::Params> pick_tile(int mi, int ni) {
  if (mi == 1 && ni == 2) return bneck_mma_kernel<1, 2, ACT1, EP2>;
  if (mi == 2 && ni == 2) return bneck_mma_kernel<2, 2, ACT1, EP2>;
  if (mi == 1 && ni == 4) return bneck_mma_kernel<1, 4, ACT1, EP2>;
  if (mi == 2 && ni == 4) return bneck_mma_kernel<2, 4, ACT1, EP2>;
  if (mi == 1 && ni == 8) return bneck_mma_kernel<1, 8, ACT1, EP2>;
  return nullptr;
}

template <int ACT1>
BneckKernel<ServingParams> pick_act2(int act2, int mi, int ni) {
  switch (act2) {
    case tat::kActNone:
      return pick_tile<ACT1, ServingEpilogue<tat::kActNone>>(mi, ni);
    case tat::kActRelu:
      return pick_tile<ACT1, ServingEpilogue<tat::kActRelu>>(mi, ni);
    case tat::kActLeakyRelu:
      return pick_tile<ACT1, ServingEpilogue<tat::kActLeakyRelu>>(mi, ni);
    case tat::kActSilu:
      return pick_tile<ACT1, ServingEpilogue<tat::kActSilu>>(mi, ni);
    default:
      return nullptr;
  }
}

BneckKernel<ServingParams> pick_acts(int act1, int act2, int mi, int ni) {
  return act1 == tat::kActSilu ? pick_act2<tat::kActSilu>(act2, mi, ni)
                               : pick_act2<kAnyAct>(act2, mi, ni);
}

// The kernel of the JAX modes (both acts at run time) for the product
// `compute` (tat::Compute).
BneckKernel<ServingModeParams> pick_mode(int compute, int mi, int ni) {
  return compute == tat::kComputeBf16
             ? pick_tile<kAnyAct, ServingModeEpilogue<true>>(mi, ni)
             : pick_tile<kAnyAct, ServingModeEpilogue<false>>(mi, ni);
}

// Kernel k of a plan and its layout in g (whose C, CM, K are set), or
// null (err set) for a plan or act1 it cannot run; opts k into its shared
// memory.
template <class K>
K prepare_bneck(K k, int act1, int tile_h, int tile_w, int bn, int resident,
                BneckGeom& g, cudaError_t& err) {
  err = cudaErrorInvalidValue;
  int lg = 0;
  while (lg < 6 && (1 << lg) != tile_w) ++lg;
  const int tp = tile_h * tile_w;
  if (lg == 6 || tile_w < 8 || tile_h < 1 || (tp != 64 && tp != 128) ||
      (bn != 32 && bn != 64 && bn != 128) || g.C < 1 || g.CM < 1 ||
      g.K < 1 || g.K % 2 == 0 || act1 < 0 || act1 > tat::kActSiluFast ||
      k == nullptr)
    return nullptr;
  g.BN = bn;
  g.resident = resident != 0;
  g.out.TH = tile_h;
  g.out.TW = tile_w;
  g.out.lg_tw = lg;
  g.hh = (g.K - 1) / 2;
  bneck_layout(g);
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
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(k,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  return err == cudaSuccess ? k : nullptr;
}

}  // namespace

// One launch: x NHWC [batch, H, W, C], w1 [CM, C], w2 OHWI [O, K, K, CM]
// int8; b1 [CM], b2 [O] int32 or null; cs1 [CM], cs2 [O] f32; out NHWC
// [batch, H, W, O] int8; each epilogue's act (tat::Act), inv_out and alpha;
// shortcut (needs C == O, not with LEAKY_RELU) and its res_scale. The plan:
// tile_h x tile_w output pixels a tile (64 or 128, tile_w a power of two >=
// 8), bn output channels a block (32, 64, or 128 with 64 pixels), their w2
// resident or streamed a tap at a time, tiles_per_block consecutive tiles a
// block; the products (tat::Compute: s8, or bf16 on f32 sums). Returns a
// cudaError_t; cudaErrorInvalidValue for a shape or plan it cannot run.
extern "C" int tat_bneck_int8_fused(
    const void* x, const void* w1, const void* b1, const void* cs1,
    const void* w2, const void* b2, const void* cs2, void* out, int batch,
    int H, int W, int C, int CM, int O, int K, int act1, float inv1,
    float alpha1, int act2, float inv2, float alpha2, int shortcut,
    float res_scale, int tile_h, int tile_w, int bn, int resident,
    int tiles_per_block, int compute, void* stream) {
  if (batch < 1 || H < 1 || W < 1 || O < 1 || tiles_per_block < 1 ||
      cs1 == nullptr || cs2 == nullptr ||
      (shortcut && (C != O || act2 == tat::kActLeakyRelu)))
    return static_cast<int>(cudaErrorInvalidValue);
  BneckGeom g = {};
  g.C = C;
  g.CM = CM;
  g.K = K;
  cudaError_t err;
  const bool modal =
      takes_mode(act2, compute, err) || act1 == tat::kActSiluFast;
  if (err != cudaSuccess) return static_cast<int>(err);
  const ServingParams ep2 = {static_cast<const float*>(cs2), inv2, alpha2,
                             shortcut ? static_cast<const int8_t*>(x)
                                      : nullptr,
                             res_scale, 0};
  // kernel k, prepared, launched on its params p
  auto launch = [&](auto k, const auto& p) {
    if (prepare_bneck(k, act1, tile_h, tile_w, bn, resident, g, err) ==
        nullptr)
      return static_cast<int>(err);
    g.H = H;
    g.W = W;
    g.O = O;
    g.act1 = act1;
    g.inv1 = inv1;
    g.alpha1 = alpha1;
    g.vec_x = C % 16 == 0 && aligned16(x);
    g.vec_w1 = C % 16 == 0 && aligned16(w1);
    g.vec_w2 = CM % 16 == 0 && aligned16(w2);
    g.out.O = O;
    g.out.OH = H;
    g.out.OW = W;
    g.out.vec_out = O % 16 == 0 && aligned16(out);
    g.out.ntw = (W + tile_w - 1) / tile_w;
    g.nth = (H + tile_h - 1) / tile_h;
    g.out.tiles_img = g.nth * g.out.ntw;
    g.by_tiles = fast_div(g.out.tiles_img);
    g.by_nth = fast_div(g.nth);
    g.tiles = batch * g.out.tiles_img;
    g.tpb = tiles_per_block < g.tiles ? tiles_per_block : g.tiles;
    const dim3 grid(static_cast<unsigned>((g.tiles + g.tpb - 1) / g.tpb),
                    static_cast<unsigned>((O + bn - 1) / bn));
    k<<<grid, kThreads, static_cast<size_t>(g.smem),
        static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int8_t*>(x), static_cast<const int8_t*>(w1),
        static_cast<const int*>(b1), static_cast<const float*>(cs1),
        static_cast<const int8_t*>(w2), static_cast<const int*>(b2),
        static_cast<int8_t*>(out), g, p);
    return static_cast<int>(cudaGetLastError());
  };
  const int tp = tile_h * tile_w;
  if (modal)
    return launch(pick_mode(compute, tp / 64, bn / 16),
                  ServingModeParams{ep2, act2});
  return launch(pick_acts(act1, act2, tp / 64, bn / 16), ep2);
}

// The dynamic shared memory of a plan in bytes and the blocks of the acts'
// and product's kernel an SM holds at once; cudaErrorInvalidValue for a
// plan the kernel cannot run.
extern "C" int tat_bneck_int8_fused_info(int act1, int act2, int C, int CM,
                                         int K, int tile_h, int tile_w, int bn,
                                         int resident, int compute, int* smem,
                                         int* blocks_per_sm) {
  BneckGeom g = {};
  g.C = C;
  g.CM = CM;
  g.K = K;
  cudaError_t err;
  const bool modal =
      takes_mode(act2, compute, err) || act1 == tat::kActSiluFast;
  if (err != cudaSuccess) return static_cast<int>(err);
  auto info = [&](auto k) {
    if (prepare_bneck(k, act1, tile_h, tile_w, bn, resident, g, err) ==
        nullptr)
      return static_cast<int>(err);
    *smem = g.smem;
    return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks_per_sm, k, kThreads, static_cast<size_t>(g.smem)));
  };
  const int tp = tile_h * tile_w;
  if (modal) return info(pick_mode(compute, tp / 64, bn / 16));
  return info(pick_acts(act1, act2, tp / 64, bn / 16));
}
