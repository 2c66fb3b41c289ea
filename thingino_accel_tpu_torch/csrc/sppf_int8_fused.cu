// The fused SPPF tail on the tensor cores, NHWC int8:
//   m1 = maxpool_kxk/1(y), m2 = maxpool(m1), m3 = maxpool(m2)  (pad -128)
//   out[N, H, W, O] = epilogue(concat(y, m1, m2, m3) @ w[O, 4C]^T)
//
// Replaces thingino_accel_tpu/ops/fused_kernels.py:sppf_int8_fused (:698,
// call :738; Pallas body _sppf_kernel :653), which keeps the pool pyramid
// of a whole image in VMEM, pools in int32 (Mosaic has no int8 vector max)
// and sums four part-dots into one int32 accumulator before the epilogue
// (the pools keep the scale, so this is the multi-part 1x1's equal-scale
// product with K = 4C). Padding with -128 equals clipping the window to
// the image, since no int8 value is below it; a max of int8 values is the
// same in any width.
//
// What bounds it on the H100: SPPF runs on the smallest map (20 x 20 x 256
// -> 512 for yolov5s at 640); its bytes are one read of y and one write of
// out, its MACs those of a 1x1 with K = 4C, a few hundred operations a
// byte. The pools are cheap once, but a tile of pixels needs the pyramid
// over its rows and 3 (k - 1) / 2 halo rows each side, nearly the whole
// image at 20 x 20, so the design builds it once a tile and runs every
// output channel off it. On the KxK core of conv_mma_core.cuh (its warp
// tiling, mma_k32 product step and staged store_tile; no dp4a):
//   - a block owns a run of tiles of TP consecutive pixels of one image
//     (row-major; a run may cross images) and all of the output
//     channels, so the pyramid is built once a tile; 8 warps tile TP x BN 4 x 2 with MI m16 x NI n8 mma.sync s8 tiles
//     each (TP = 64 MI, BN = 16 NI);
//   - the pyramid, C walked in chunks of CK channels: the tile's rows of y
//     and their halo (full rows, CK bytes a pixel at a pitch of CK + 16,
//     zeros past C) come in by 16-byte cp.async copies while the previous
//     chunk pools (byte loads where C % 16 != 0 or y is off 16-byte
//     alignment). Level L (1..3) is a row pass (max over columns col +- pk
//     of level L - 1, over the rows it holds valid) into an int16 buffer,
//     then a column pass (max over rows +- pk, over the rows level L must
//     hold: the tile's rows +- (3 - L) pk) back to int8. Each pass holds
//     sign-extended int16 pairs (prmt) and takes maxima three at a time
//     with Hopper's DPX __vimax3_s16x2 (one instruction a pair of
//     channels; the int8 __vmaxs4 is emulated by several);
//   - each level's CK bytes of the tile's pixels go into the A tile, TP
//     rows of 4 Cp + 16 bytes (Cp: C rounded up to CK; the level-major
//     order of concat's columns), resident for the whole GEMM;
//   - the GEMM: for each BN block of the output channels, w's rows come
//     through a four-slot cp.async ring of KC-byte K slices, the product
//     is the core's mma_k32 over the resident A, one int32 sum over all
//     four levels as the JAX kernel's, then the core's store_tile
//     (ServingEpilogue<ACT> on the fragments, the tile staged and written
//     16 bytes a thread). The next tile's first rows of y come in beside
//     the ring. The JAX modes take ServingModeEpilogue<BF16> (the act at
//     run time, SILU_FAST among them); with BF16 (TAT_SERVING_COMPUTE=
//     bf16) the same int8 values go through the bf16 product into one f32
//     sum over the four levels, where the JAX kernel adds four f32 part
//     sums: the two may round differently once a sum passes 2^24.
// Every multiply and add of the epilogue is an explicit round-to-nearest
// intrinsic (epilogue.cuh).
//
// Shared memory (sppf_layout, mirrored by ops/fused_kernels.py
// sppf_layout), all dynamic: y, two levels (S rows x W pixels x (CK + 16)
// bytes; S: the rows a tile and its halo span at most) and the row pass's
// int16 (S x W x 2 CK), the A tile, the ring (4 x BN rows of KC + 16), the
// staged output tile (TP pixels of BN + 16). Every ldmatrix pitch is an
// odd multiple of 16 bytes.
#include <cstdint>

#include <cuda_runtime.h>

#include "conv_mma_core.cuh"

namespace {

constexpr int kRing = 4;   // slots of the weights' ring: three in flight

struct SppfGeom {
  int H, W, HW, C, O, pk;        // pk = (k - 1) / 2
  int BN, CK, lg_upp, nck, Cp;   // chunk bytes, log2(CK / 16), chunks
  int KC, kst;                   // ring slice bytes, slices a BN block
  int S, P;                      // staged rows at most, CK + 16
  int lv_bytes, tmp_bytes;       // a staged int8 level, the int16 buffer
  int apitch, bpitch;            // 4 Cp + 16, KC + 16
  int tmp_off, l1_off, l2_off, a_off, ring_off, out_off, smem;
  int tiles, tpb;                // batch x tiles an image, tiles a run
  int nblk;                      // BN blocks of O
  int vec_y, vec_w;              // 16-byte copies of y, w
  FastDiv by_w, by_tiles;        // pixel -> row; tile -> image
  ConvGeom out;   // store_tile's: TH 1, TW = TP, OH 1, OW = H W, tiles_img
};

// The shared-memory layout of one block (ops/fused_kernels.py sppf_layout
// mirrors it); g's H, W, C, pk, BN, CK and out.TW (TP) set.
void sppf_layout(SppfGeom& g) {
  const int span = (g.out.TW + g.W - 2) / g.W + 1;   // rows a tile spans
  g.S = span + 6 * g.pk < g.H ? span + 6 * g.pk : g.H;
  g.P = g.CK + tat::kRowPad;
  g.nck = (g.C + g.CK - 1) / g.CK;
  g.Cp = g.nck * g.CK;
  g.KC = g.Cp % 128 == 0 ? 128 : (g.Cp % 64 == 0 ? 64 : 32);
  g.kst = 4 * g.Cp / g.KC;
  g.lv_bytes = g.S * g.W * g.P;
  g.tmp_bytes = g.S * g.W * 2 * g.CK;
  g.apitch = 4 * g.Cp + tat::kRowPad;
  g.bpitch = g.KC + tat::kRowPad;
  g.tmp_off = g.lv_bytes;
  g.l1_off = g.tmp_off + g.tmp_bytes;
  g.l2_off = g.l1_off + g.lv_bytes;
  g.a_off = g.l2_off + g.lv_bytes;
  g.ring_off = g.a_off + g.out.TW * g.apitch;
  g.out_off = g.ring_off + kRing * g.BN * g.bpitch;
  g.smem = g.out_off + g.out.TW * (g.BN + kOutPad);
  g.lg_upp = 0;
  while ((16 << g.lg_upp) < g.CK) ++g.lg_upp;
}

// --- prmt: a byte permute (a selector nibble with bit 3 set replicates the
// sign of the byte it picks) -------------------------------------------------
__device__ __forceinline__ unsigned prmt(unsigned a, unsigned b,
                                         unsigned sel) {
  unsigned d;
  asm("prmt.b32 %0, %1, %2, %3;" : "=r"(d) : "r"(a), "r"(b), "r"(sel));
  return d;
}
// --- end of prmt -------------------------------------------------------------

// 16 int8 channels as eight sign-extended int16 pairs, and back (the values
// stay in the int8 range, so their low bytes are the int8 values)
__device__ __forceinline__ void widen(uint4 v, unsigned (&m)[8]) {
  const unsigned w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[2 * i] = prmt(w[i], 0, 0x9180);       // bytes 0, 1
    m[2 * i + 1] = prmt(w[i], 0, 0xB3A2);   // bytes 2, 3
  }
}
__device__ __forceinline__ uint4 narrow(const unsigned (&m)[8]) {
  return make_uint4(prmt(m[0], m[1], 0x6420), prmt(m[2], m[3], 0x6420),
                    prmt(m[4], m[5], 0x6420), prmt(m[6], m[7], 0x6420));
}

// The image rows [lo, hi] a tile's level L must hold (L = 0: the staged
// rows): its own rows and (3 - L) pk more each side, within the image.
struct Rows {
  int lo, hi;
};
__device__ __forceinline__ Rows level_rows(const SppfGeom& g, Rows t,
                                           int level) {
  const int d = (3 - level) * g.pk;
  return {t.lo - d > 0 ? t.lo - d : 0, t.hi + d < g.H - 1 ? t.hi + d : g.H - 1};
}

// The first and last image rows of tile `tile` of an image.
__device__ __forceinline__ Rows tile_rows(const SppfGeom& g, int tile) {
  const int p0 = tile * g.out.TW;
  const int last = p0 + g.out.TW - 1 < g.HW - 1 ? p0 + g.out.TW - 1
                                                : g.HW - 1;
  return {quot(g.by_w, p0), quot(g.by_w, last)};
}

// The staged rows of y for global tile T and chunk c0 into ybuf: CK bytes a
// pixel at pitch P, zeros past C; 16-byte cp.async copies (g.vec_y) or byte
// loads.
__device__ void load_y(const SppfGeom& g, const int8_t* __restrict__ y,
                       unsigned char* ybuf, int T, int c0) {
  const int n = quot(g.by_tiles, T);
  const Rows s = level_rows(g, tile_rows(g, T - n * g.out.tiles_img), 0);
  const int8_t* base =
      y + (static_cast<long long>(n) * g.HW + s.lo * g.W) * g.C + c0;
  const int upp = 1 << g.lg_upp, units = (s.hi - s.lo + 1) * g.W * upp;
  for (int u = threadIdx.x; u < units; u += kThreads) {
    const int pix = u >> g.lg_upp, c = 16 * (u & (upp - 1));
    const int left = g.C - c0 - c;
    const int bytes = left <= 0 ? 0 : (left < 16 ? left : 16);
    const int8_t* src = bytes > 0 ? base + pix * g.C + c : y;
    unsigned char* dst = ybuf + pix * g.P + c;
    if (g.vec_y)
      tat::cp_async16(dst, src, bytes);
    else
      *reinterpret_cast<uint4*>(dst) = tat::load16_bytes(src, bytes);
  }
}

// The row pass of a level over image rows r (buffers start at image row
// s_lo): the max over columns col +- pk, clipped to the image, of the int8
// src into the int16 tmp, 16 channels an item.
__device__ void row_pass(const SppfGeom& g, const unsigned char* src,
                         unsigned char* tmp, int s_lo, Rows r) {
  const int upp = 1 << g.lg_upp;
  const int units = (r.hi - r.lo + 1) * g.W * upp;
  const int first = (r.lo - s_lo) * g.W;   // staged pixel of row r.lo
  for (int u = threadIdx.x; u < units; u += kThreads) {
    const int pix = u >> g.lg_upp, cu = u & (upp - 1);
    const int col = pix - quot(g.by_w, pix) * g.W;
    const unsigned char* p = src + (first + pix) * g.P + 16 * cu;
    const uint4 v = *reinterpret_cast<const uint4*>(p);
    unsigned m[8];
    widen(v, m);
    for (int d = 1; d <= g.pk; ++d) {
      unsigned a[8], b[8];
      widen(col - d >= 0 ? *reinterpret_cast<const uint4*>(p - d * g.P) : v,
            a);
      widen(col + d < g.W ? *reinterpret_cast<const uint4*>(p + d * g.P) : v,
            b);
#pragma unroll
      for (int j = 0; j < 8; ++j) m[j] = __vimax3_s16x2(m[j], a[j], b[j]);
    }
    uint4* t = reinterpret_cast<uint4*>(tmp + (first + pix) * 2 * g.CK +
                                        32 * cu);
    t[0] = make_uint4(m[0], m[1], m[2], m[3]);
    t[1] = make_uint4(m[4], m[5], m[6], m[7]);
  }
}

// The column pass of a level over image rows r: the max over rows +- pk,
// clipped to the image, of the int16 tmp into the int8 level dst.
__device__ void col_pass(const SppfGeom& g, const unsigned char* tmp,
                         unsigned char* dst, int s_lo, Rows r) {
  const int upp = 1 << g.lg_upp;
  const int units = (r.hi - r.lo + 1) * g.W * upp;
  const int first = (r.lo - s_lo) * g.W;
  const int step = g.W * 2 * g.CK;   // int16 bytes a row
  for (int u = threadIdx.x; u < units; u += kThreads) {
    const int pix = u >> g.lg_upp, cu = u & (upp - 1);
    const int iy = r.lo + quot(g.by_w, pix);
    const uint4* p = reinterpret_cast<const uint4*>(
        tmp + (first + pix) * 2 * g.CK + 32 * cu);
    uint4 lo = p[0], hi = p[1];
    unsigned m[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
    for (int d = 1; d <= g.pk; ++d) {
      const uint4* a = iy - d >= 0 ? p - d * step / 16 : p;
      const uint4* b = iy + d < g.H ? p + d * step / 16 : p;
      const uint4 a0 = a[0], a1 = a[1], b0 = b[0], b1 = b[1];
      const unsigned av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const unsigned bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int j = 0; j < 8; ++j) m[j] = __vimax3_s16x2(m[j], av[j], bv[j]);
    }
    *reinterpret_cast<uint4*>(dst + (first + pix) * g.P + 16 * cu) =
        narrow(m);
  }
}

// A level's CK bytes of the tile's TP pixels (past the image: its last
// pixel, never stored) into the A tile at column `col`.
__device__ void to_a(const SppfGeom& g, const unsigned char* level,
                     unsigned char* a, int s_lo, int p0, int col) {
  const int upp = 1 << g.lg_upp;
  for (int u = threadIdx.x; u < g.out.TW * upp; u += kThreads) {
    const int i = u >> g.lg_upp, c = 16 * (u & (upp - 1));
    const int q = p0 + i < g.HW ? p0 + i : g.HW - 1;
    *reinterpret_cast<uint4*>(a + i * g.apitch + col + c) =
        *reinterpret_cast<const uint4*>(level + (q - s_lo * g.W) * g.P + c);
  }
}

// Ring slice s (its BN block s / kst, its K slice s % kst of A's columns):
// BN rows of KC bytes of w, zeros past C within a level and past O.
__device__ void load_b(const SppfGeom& g, const int8_t* __restrict__ w,
                       unsigned char* slot, int s) {
  const int blk = s / g.kst, k0 = (s - blk * g.kst) * g.KC;
  const int level = k0 / g.Cp, c0 = k0 - level * g.Cp;
  const int n0 = blk * g.BN;
  const int width = g.C - c0 < g.KC ? g.C - c0 : g.KC;
  const int8_t* src =
      w + static_cast<long long>(n0) * 4 * g.C + level * g.C + c0;
  load_weight_rows(src, slot, g.BN, g.O - n0, 1, width > 0 ? width : 0,
                   g.KC, g.bpitch, 4LL * g.C, g.vec_w);
}

template <int MI, int NI, class EP>
__global__ void __launch_bounds__(kThreads, 1)
    sppf_mma_kernel(const int8_t* __restrict__ y,
                    const int8_t* __restrict__ w,
                    const int* __restrict__ bias, int8_t* __restrict__ out,
                    SppfGeom g, typename EP::Params ep) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int BN = 16 * NI;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = warp & 3, wn = warp >> 2, tq = lane & 3;
  const int t0 = blockIdx.x * g.tpb;
  const int tiles = g.tiles - t0 < g.tpb ? g.tiles - t0 : g.tpb;
  const int slices = g.nblk * g.kst;
  unsigned char* ybuf = smem;
  unsigned char* tmp = smem + g.tmp_off;
  unsigned char* lv[2] = {smem + g.l1_off, smem + g.l2_off};
  unsigned char* a = smem + g.a_off;
  unsigned char* ring = smem + g.ring_off;
  unsigned char* staged = smem + g.out_off;

  // the lane's ldmatrix A rows in the A tile, its B row in a ring slot
  int aoff[MI];
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
    aoff[mi] = ((wm * MI + mi) * 16 + tat::a_lane_row(lane)) * g.apitch +
               tat::a_lane_byte(lane);
  const int brow = (wn * 8 * NI + (lane & 7) + 8 * (lane >> 4)) * g.bpitch +
                   ((lane >> 3) & 1) * 16;

  load_y(g, y, ybuf, t0, 0);
  tat::cp_async_commit();
  for (int t = 0; t < tiles; ++t) {
    const int T = t0 + t;
    const int n = quot(g.by_tiles, T), tile = T - n * g.out.tiles_img;
    const Rows own = tile_rows(g, tile);
    const int s_lo = level_rows(g, own, 0).lo, p0 = tile * g.out.TW;
    // the pyramid, a chunk of C at a time, into the A tile
    for (int chunk = 0; chunk < g.nck; ++chunk) {
      const int c0 = chunk * g.CK;
      tat::cp_async_wait<0>();   // this chunk's rows of y
      __syncthreads();           // ... for every thread; tmp, levels free
      to_a(g, ybuf, a, s_lo, p0, c0);
      const unsigned char* src = ybuf;
      for (int level = 1; level <= 3; ++level) {
        row_pass(g, src, tmp, s_lo, level_rows(g, own, level - 1));
        __syncthreads();   // tmp written; src read
        if (level == 1) {   // y is read: the next chunk's rows come in, or
                            // after the last one the ring's first slices
          if (chunk + 1 < g.nck) {
            load_y(g, y, ybuf, T, c0 + g.CK);
            tat::cp_async_commit();
          } else {
            for (int s = 0; s < kRing - 1; ++s) {
              if (s < slices)
                load_b(g, w, ring + s * g.BN * g.bpitch, s);
              tat::cp_async_commit();
            }
          }
        }
        unsigned char* dst = lv[(level - 1) & 1];
        col_pass(g, tmp, dst, s_lo, level_rows(g, own, level));
        __syncthreads();   // the level written; tmp read
        to_a(g, dst, a, s_lo, p0, level * g.Cp + c0);
        src = dst;
      }
    }
    // the GEMM over the resident A, w through the ring, a BN block at a
    // time
    typename EP::Acc acc[MI][NI][4];
    typename EP::Col cols[NI][2];
    for (int s = 0; s < slices; ++s) {
      tat::cp_async_wait<kRing - 2>();   // slice s landed
      __syncthreads();   // ... for every thread; slot s - 1 is read
      const int next = s + kRing - 1;
      if (next < slices)
        load_b(g, w, ring + (next % kRing) * g.BN * g.bpitch, next);
      if (s == 0 && t + 1 < tiles)   // the next tile's first rows of y
        load_y(g, y, ybuf, T + 1, 0);
      tat::cp_async_commit();
      const int blk = s / g.kst, ks = s - blk * g.kst;
      const int n0 = blk * BN;
      if (ks == 0) {
#pragma unroll
        for (int mi = 0; mi < MI; ++mi)
#pragma unroll
          for (int ni = 0; ni < NI; ++ni)
#pragma unroll
            for (int r = 0; r < 4; ++r) acc[mi][ni][r] = 0;
#pragma unroll
        for (int ni = 0; ni < NI; ++ni)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int o = n0 + wn * 8 * NI + ni * 8 + 2 * tq + e;
            cols[ni][e] = EP::col(bias, ep, o, o < g.O);
          }
      }
      const unsigned char* bt = ring + (s % kRing) * g.BN * g.bpitch + brow;
      const unsigned char* at = a + ks * g.KC;
      for (int kb = 0; kb < g.KC; kb += tat::kMmaStepBytes)
        if constexpr (kProduct)
          mma_k32<MI, NI>(acc, at + kb, aoff, bt + kb, g.bpitch);
      if (ks == g.kst - 1) {
        if constexpr (kStore)
          store_tile<MI, NI, EP>(acc, cols, g.out, staged, nullptr, n, tile,
                                 n0, ep, out);
        else
          sink_tile<MI, NI>(acc, out);
      }
    }
    tat::cp_async_wait<0>();   // no slice in flight past the tile
    __syncthreads();           // the A tile and the ring are read
  }
}

template <class P>
using SppfKernel = void (*)(const int8_t*, const int8_t*, const int*,
                            int8_t*, SppfGeom, P);

template <class EP>
SppfKernel<typename EP::Params> pick_tile(int mi, int ni) {
  if (mi == 1 && ni == 2) return sppf_mma_kernel<1, 2, EP>;
  if (mi == 2 && ni == 2) return sppf_mma_kernel<2, 2, EP>;
  if (mi == 1 && ni == 4) return sppf_mma_kernel<1, 4, EP>;
  if (mi == 2 && ni == 4) return sppf_mma_kernel<2, 4, EP>;
  if (mi == 1 && ni == 8) return sppf_mma_kernel<1, 8, EP>;
  return nullptr;
}

SppfKernel<ServingParams> pick_act(int act, int mi, int ni) {
  switch (act) {
    case tat::kActNone:
      return pick_tile<ServingEpilogue<tat::kActNone>>(mi, ni);
    case tat::kActRelu:
      return pick_tile<ServingEpilogue<tat::kActRelu>>(mi, ni);
    case tat::kActLeakyRelu:
      return pick_tile<ServingEpilogue<tat::kActLeakyRelu>>(mi, ni);
    case tat::kActSilu:
      return pick_tile<ServingEpilogue<tat::kActSilu>>(mi, ni);
    default:
      return nullptr;
  }
}

// The kernel of the JAX modes (the act at run time) for the product
// `compute` (tat::Compute).
SppfKernel<ServingModeParams> pick_mode(int compute, int mi, int ni) {
  return compute == tat::kComputeBf16
             ? pick_tile<ServingModeEpilogue<true>>(mi, ni)
             : pick_tile<ServingModeEpilogue<false>>(mi, ni);
}

// Kernel k of a plan and its layout in g (its shape set), or null (err
// set) for a plan it cannot run; opts k into its shared memory.
template <class K>
K prepare_sppf(K k, int bm, int bn, int ck, SppfGeom& g, cudaError_t& err) {
  err = cudaErrorInvalidValue;
  if ((bm != 64 && bm != 128) || (bn != 32 && bn != 64 && bn != 128) ||
      (ck != 32 && ck != 64 && ck != 128) || k == nullptr)
    return nullptr;
  g.BN = bn;
  g.CK = ck;
  g.out.TH = 1;
  g.out.TW = bm;
  g.out.lg_tw = bm == 64 ? 6 : 7;
  sppf_layout(g);
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

// false for a shape the kernel cannot run
bool set_shape(SppfGeom& g, int H, int W, int C, int k) {
  if (H < 1 || W < 1 || C < 1 || k < 1 || k % 2 == 0) return false;
  g.H = H;
  g.W = W;
  g.HW = H * W;
  g.C = C;
  g.pk = (k - 1) / 2;
  g.by_w = fast_div(W);
  return true;
}

}  // namespace

// One launch: y NHWC [batch, H, W, C] and w [O, 4C] int8 (columns: y's,
// then m1's, m2's, m3's), bias [O] int32 or null, cs [O] f32, out NHWC
// [batch, H, W, O] int8; the pools' k (odd); the epilogue's act (tat::Act),
// inv_out and alpha. The plan: bm consecutive pixels a tile (64, 128), bn
// output channels a GEMM block (32, 64, or 128 with 64 pixels), ck
// channels a pyramid chunk (32, 64, 128), tiles_per_block tiles a block
// (each over all O, its BN blocks in turn); the product (tat::Compute: s8,
// or bf16 on f32 sums). Returns a cudaError_t; cudaErrorInvalidValue for a
// shape or plan it cannot run.
extern "C" int tat_sppf_int8_fused(const void* y, const void* w,
                                   const void* bias, const void* cs, void* out,
                                   int batch, int H, int W, int C, int O, int k,
                                   int act, float inv_out, float alpha, int bm,
                                   int bn, int ck, int tiles_per_block,
                                   int compute, void* stream) {
  SppfGeom g = {};
  if (batch < 1 || O < 1 || tiles_per_block < 1 ||
      cs == nullptr || !set_shape(g, H, W, C, k))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err;
  const bool modal = takes_mode(act, compute, err);
  if (err != cudaSuccess) return static_cast<int>(err);
  const ServingParams ep = {static_cast<const float*>(cs), inv_out, alpha,
                            nullptr, 0.0f, 0};
  // kernel kern, prepared, launched on its params p
  auto launch = [&](auto kern, const auto& p) {
    if (prepare_sppf(kern, bm, bn, ck, g, err) == nullptr)
      return static_cast<int>(err);
    g.O = O;
    g.vec_y = C % 16 == 0 && aligned16(y);
    g.vec_w = C % 16 == 0 && aligned16(w);
    g.out.O = O;
    g.out.OH = 1;
    g.out.OW = g.HW;
    g.out.ntw = g.out.tiles_img = (g.HW + bm - 1) / bm;
    g.out.vec_out = O % 16 == 0 && aligned16(out);
    g.by_tiles = fast_div(g.out.tiles_img);
    g.tiles = batch * g.out.tiles_img;
    g.tpb = tiles_per_block < g.tiles ? tiles_per_block : g.tiles;
    g.nblk = (O + bn - 1) / bn;
    const dim3 grid(static_cast<unsigned>((g.tiles + g.tpb - 1) / g.tpb));
    kern<<<grid, kThreads, static_cast<size_t>(g.smem),
           static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int8_t*>(y), static_cast<const int8_t*>(w),
        static_cast<const int*>(bias), static_cast<int8_t*>(out), g, p);
    return static_cast<int>(cudaGetLastError());
  };
  if (modal)
    return launch(pick_mode(compute, bm / 64, bn / 16),
                  ServingModeParams{ep, act});
  return launch(pick_act(act, bm / 64, bn / 16), ep);
}

// The dynamic shared memory of a plan in bytes and the blocks of the act's
// and product's kernel an SM holds at once; cudaErrorInvalidValue for a
// plan the kernel cannot run.
extern "C" int tat_sppf_int8_fused_info(int act, int H, int W, int C, int k,
                                        int bm, int bn, int ck, int compute,
                                        int* smem, int* blocks_per_sm) {
  SppfGeom g = {};
  if (!set_shape(g, H, W, C, k)) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err;
  const bool modal = takes_mode(act, compute, err);
  if (err != cudaSuccess) return static_cast<int>(err);
  auto info = [&](auto kern) {
    if (prepare_sppf(kern, bm, bn, ck, g, err) == nullptr)
      return static_cast<int>(err);
    *smem = g.smem;
    return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks_per_sm, kern, kThreads, static_cast<size_t>(g.smem)));
  };
  if (modal) return info(pick_mode(compute, bm / 64, bn / 16));
  return info(pick_act(act, bm / 64, bn / 16));
}
