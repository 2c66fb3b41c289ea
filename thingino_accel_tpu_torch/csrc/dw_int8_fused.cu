// Fused int8 depthwise conv at stride 1, NHWC x [KH, KW, C] -> NHWC:
// out[n, oy, ox, c] = epilogue(sum_{ky,kx} x[n, oy-pt+ky, ox-pl+kx, c]
//                                          * w[ky, kx, c])
// with zero (the quantized zero) outside the image, at any KH x KW, for
// every declared output row and column (only the top and left pads place
// the window).
//
// Replaces thingino_accel_tpu/ops/fused_kernels.py:depthwise_conv2d_int8_fused
// (:1397, call :1456; Pallas body _dw_kernel), kernel #7, which stages a
// halo'd row slab in VMEM and runs each tap as a VPU multiply-add over
// 128-lane channel rows. It computes what that kernel computes, not how:
// the 128-lane channel padding and the VMEM row tiles are the TPU's.
//
// What bounds it on the H100: there is no contraction (2 KH KW int ops
// an output byte), so device-memory bytes: each input and output byte
// once (2 x 2.46 MB at NanoDet-320's 16x40x40x96, 1.5 us at 3.35 TB/s).
// The design reads each input byte from device memory about once and each
// from shared memory KW times, and keeps everything else in registers:
//   - a block owns (image n, a tile of TH output rows, a slab of 16 G
//     channels); it copies the tile's halo, (TH + KH - 1) rows x (OW + KW
//     - 1) columns x 16 G bytes, into shared memory with 16-byte cp.async
//     copies (zero-filled by a source size of 0 outside the image and past
//     C), and the slab's KH KW weight rows beside it;
//   - G x TW threads (TW = min(OW, 256 / G) columns): thread (column j,
//     group g) walks the columns j, j + TW, ..., each down the tile's TH
//     rows with a KH x KW window of its 16 channels' 16-byte taps in
//     registers: a new output row loads one halo row of KW taps (KW
//     16-byte shared loads), the window slides by a row; neighbouring
//     threads read neighbouring 16 bytes of one halo row;
//   - the weights wait in shared memory as sign-extended int32, read 16
//     bytes (4 channels) at a time where a tap uses them: kept as bytes,
//     nvcc turns each byte product into an IDP.4A on one byte lane, and
//     this kernel is to hold no dp4a; held in registers as int32 (144 of
//     them), they spill. The bias and cs wait there too, for the
//     epilogue;
//   - the exact int32 sums of 16 channels, the shared epilogue
//     (epilogue.cuh: explicit _rn steps), then one 16-byte store a pixel
//     (bytes where C % 16 != 0 or the output is off 16-byte alignment);
//   - KH x KW is a template constant for 3x3 (every depthwise conv of
//     NanoDet-320); other sizes take a kernel that reads each tap from
//     shared memory;
//   - the act is a run-time argument, SILU_FAST (the Pade sigmoid of
//     TAT_FAST_SILU) in kernels of its own, so that the other acts' code
//     stays as it is without it.
// Operands off 16-byte alignment, or C % 16 != 0, take byte loads into the
// same shared layout. The products are per channel: two int32 operands
// and an IMAD each.
//
// Shared memory (dw_layout; ops/fused_kernels.py dw_smem mirrors it), all
// dynamic: the halo at 16 G bytes a pixel, KH KW weight rows of 16 G
// int32 (in each row, quarter k of every group's 16 channels side by
// side, so that a warp's 16-byte weight loads hit distinct banks), then
// the slab's 16 G int32 biases and 16 G f32 scales.
#include <cstdint>

#include <cuda_runtime.h>

#include "epilogue.cuh"
#include "mma_tile.cuh"

namespace {

constexpr int kMaxThreads = 256;
constexpr int kMaxGroups = 16;   // 256 channels a block at most

struct DwGeom {
  int H, W, C, KH, KW, pt, pl, OH, OW;
  int TH, G;             // the plan: output rows a tile, channel groups
  int CB;                // 16 G: bytes of a halo pixel
  int SH, SW;            // halo rows and columns
  int TW;                // columns a pass of the block's threads
  int row_tiles, slabs;  // tiles an image, channel slabs
  int w_off, b_off, cs_off, smem;
  int vec_x, vec_w, vec_out;
};

inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

void dw_layout(DwGeom& g) {
  g.CB = 16 * g.G;
  g.SH = g.TH + g.KH - 1;
  g.SW = g.OW + g.KW - 1;
  g.TW = g.OW < kMaxThreads / g.G ? g.OW : kMaxThreads / g.G;
  g.w_off = g.SH * g.SW * g.CB;
  g.b_off = g.w_off + 4 * g.KH * g.KW * g.CB;
  g.cs_off = g.b_off + 4 * g.CB;
  g.smem = g.cs_off + 4 * g.CB;
}

// The tile's halo, the slab's weight rows and its channels' bias and cs
// into shared memory; thread (column j0, group grp) copies its group's 16
// bytes of the columns j0, j0 + TW, ... of each halo row and of the taps
// j0, j0 + TW, ...: 16 bytes a copy (cp.async where aligned, else byte
// loads), zeros outside the image and past C; committed as one cp.async
// group.
__device__ void load_halo(const int8_t* __restrict__ x,
                          const int8_t* __restrict__ w,
                          const int* __restrict__ bias,
                          const float* __restrict__ cs, const DwGeom& g,
                          int n, int oy0, int c0, int grp, int j0,
                          unsigned char* smem) {
  const int c = c0 + 16 * grp, left = g.C - c;
  const int cbytes = left <= 0 ? 0 : (left < 16 ? left : 16);
  unsigned char* dst0 = smem + 16 * grp;   // the group's bytes of a pixel
  for (int r = 0; r < g.SH; ++r) {
    const int iy = oy0 - g.pt + r;
    const bool row = iy >= 0 && iy < g.H;
    const int8_t* src_row =
        x + (static_cast<long long>(n) * g.H + (row ? iy : 0)) * g.W * g.C + c;
    for (int col = j0; col < g.SW; col += g.TW) {
      const int ix = col - g.pl;
      const int bytes = row && ix >= 0 && ix < g.W ? cbytes : 0;
      const int8_t* src =
          bytes > 0 ? src_row + static_cast<long long>(ix) * g.C : x;
      unsigned char* dst = dst0 + (r * g.SW + col) * g.CB;
      if (g.vec_x)
        tat::cp_async16(dst, src, bytes);
      else
        *reinterpret_cast<uint4*>(dst) = tat::load16_bytes(src, bytes);
    }
  }
  for (int tap = j0; tap < g.KH * g.KW; tap += g.TW) {
    const int8_t* src = w + static_cast<long long>(tap) * g.C + c;
    const uint4 v = g.vec_w && cbytes == 16
                        ? *reinterpret_cast<const uint4*>(src)
                        : tat::load16_bytes(src, cbytes);
    const unsigned vs[4] = {v.x, v.y, v.z, v.w};
    int4* dst = reinterpret_cast<int4*>(smem + g.w_off) + 4 * g.G * tap +
                grp;
#pragma unroll
    for (int k = 0; k < 4; ++k)
      dst[k * g.G] = make_int4(static_cast<int8_t>(vs[k]),
                         static_cast<int8_t>(vs[k] >> 8),
                         static_cast<int8_t>(vs[k] >> 16),
                         static_cast<int8_t>(vs[k] >> 24));
  }
  if (j0 == 0) {
    int* b = reinterpret_cast<int*>(smem + g.b_off) + 16 * grp;
    float* s = reinterpret_cast<float*>(smem + g.cs_off) + 16 * grp;
    for (int j = 0; j < 16; ++j) {
      b[j] = j < left && bias != nullptr ? bias[c + j] : 0;
      s[j] = j < left ? cs[c + j] : 0.0f;
    }
  }
  tat::cp_async_commit();
}

// --- ld.shared: 4 int32 of shared memory, loaded where they are used
// (volatile: nvcc would otherwise hoist every tap's weights out of the row
// loop into registers, and spill) ----------------------------------------
__device__ __forceinline__ int4 lds_s32x4(const int* p) {
  int4 v;
  asm volatile("ld.volatile.shared.v4.s32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(tat::smem_addr(p)));
  return v;
}
// --- end of ld.shared -----------------------------------------------------

// acc[j] += x byte j (signed) x the weight of channel j: 4 int32 at w + k
// kstride for channels 4k .. 4k + 3.
__device__ __forceinline__ void mac16(int (&acc)[16], const uint4& xv,
                                      const int* w, int kstride) {
  const unsigned xs[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int4 wq = lds_s32x4(w + k * kstride);
    const int ws[4] = {wq.x, wq.y, wq.z, wq.w};
#pragma unroll
    for (int b = 0; b < 4; ++b)
      acc[4 * k + b] +=
          static_cast<int>(static_cast<int8_t>(xs[k] >> (8 * b))) * ws[b];
  }
}

// The epilogue on the 16 sums of one pixel (its channels' bias and cs
// from shared memory, 16 of each at b and s) and its store: 16 bytes where
// vec, else the live channels' bytes.
template <bool kSiluFast>
__device__ __forceinline__ void store_pixel(const int (&acc)[16],
                                            const int* b, const float* s,
                                            int act, float inv_out,
                                            float alpha, int live, bool vec,
                                            int8_t* __restrict__ dst) {
  unsigned v[4] = {0, 0, 0, 0};
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int4 bq = reinterpret_cast<const int4*>(b)[q];
    const float4 sq = reinterpret_cast<const float4*>(s)[q];
    const int bj[4] = {bq.x, bq.y, bq.z, bq.w};
    const float sj[4] = {sq.x, sq.y, sq.z, sq.w};
#pragma unroll
    for (int j = 0; j < 4; ++j)
      v[q] |= static_cast<unsigned>(
                  static_cast<uint8_t>(tat::epilogue<kSiluFast>(
                      acc[4 * q + j], bj[j], sj[j], act, inv_out, alpha)))
              << (8 * j);
  }
  if (vec) {
    *reinterpret_cast<uint4*>(dst) = make_uint4(v[0], v[1], v[2], v[3]);
  } else {
    for (int j = 0; j < live; ++j)
      dst[j] = static_cast<int8_t>(v[j >> 2] >> (8 * (j & 3)));
  }
}

// KH, KW > 0: the taps a template constant, a sliding window of them in
// registers (128 registers a thread: two blocks of 256 an SM); 0: any
// size, each tap read from shared memory. SILU_FAST: the epilogue also
// has the act SILU_FAST.
template <int KH, int KW, bool SILU_FAST>
__global__ void __launch_bounds__(kMaxThreads, 2)
    dw_int8_fused_kernel(const int8_t* __restrict__ x,
                         const int8_t* __restrict__ w,
                         const int* __restrict__ bias,
                         const float* __restrict__ cs,
                         int8_t* __restrict__ out, DwGeom g, int act,
                         float inv_out, float alpha) {
  extern __shared__ __align__(16) unsigned char smem[];
  int blk = blockIdx.x;
  const int slab = blk % g.slabs;
  blk /= g.slabs;
  const int rt = blk % g.row_tiles, n = blk / g.row_tiles;
  const int oy0 = rt * g.TH, c0 = slab * g.CB;
  const int grp = threadIdx.x % g.G, j0 = threadIdx.x / g.G;
  const int c = c0 + 16 * grp;
  const int live = g.C - c < 16 ? g.C - c : 16;
  load_halo(x, w, bias, cs, g, n, oy0, c0, grp, j0, smem);
  const int* b = reinterpret_cast<const int*>(smem + g.b_off) + 16 * grp;
  const float* s = reinterpret_cast<const float*>(smem + g.cs_off) + 16 * grp;
  tat::cp_async_wait<0>();
  __syncthreads();
  if (live <= 0) return;   // past C; no barrier follows

  const int rows = g.OH - oy0 < g.TH ? g.OH - oy0 : g.TH;
  const int rpitch = g.SW * g.CB;   // bytes of a halo row
  // the group's weights: 4 int32 (channels 4k ..) at wsm + tap CB + k ks
  const int* wsm = reinterpret_cast<const int*>(smem + g.w_off) + 4 * grp;
  const int ks = 4 * g.G;
  const bool vec = g.vec_out && live == 16;
  if constexpr (KH > 0) {
    for (int ox = j0; ox < g.OW; ox += g.TW) {
      const unsigned char* col = smem + ox * g.CB + 16 * grp;
      int8_t* dst =
          out + ((static_cast<long long>(n) * g.OH + oy0) * g.OW + ox) * g.C +
          c;
      uint4 win[KH][KW];
#pragma unroll
      for (int ky = 0; ky < KH - 1; ++ky)
#pragma unroll
        for (int kx = 0; kx < KW; ++kx)
          win[ky + 1][kx] = *reinterpret_cast<const uint4*>(
              col + ky * rpitch + kx * g.CB);
      for (int r = 0; r < rows; ++r) {
#pragma unroll
        for (int ky = 0; ky < KH - 1; ++ky)
#pragma unroll
          for (int kx = 0; kx < KW; ++kx) win[ky][kx] = win[ky + 1][kx];
#pragma unroll
        for (int kx = 0; kx < KW; ++kx)
          win[KH - 1][kx] = *reinterpret_cast<const uint4*>(
              col + (r + KH - 1) * rpitch + kx * g.CB);
        int acc[16] = {};
#pragma unroll
        for (int ky = 0; ky < KH; ++ky)
#pragma unroll
          for (int kx = 0; kx < KW; ++kx)
            mac16(acc, win[ky][kx], wsm + (ky * KW + kx) * g.CB, ks);
        store_pixel<SILU_FAST>(acc, b, s, act, inv_out, alpha, live, vec,
                               dst + static_cast<long long>(r) * g.OW * g.C);
      }
    }
  } else {
    for (int ox = j0; ox < g.OW; ox += g.TW) {
      const unsigned char* col = smem + ox * g.CB + 16 * grp;
      int8_t* dst =
          out + ((static_cast<long long>(n) * g.OH + oy0) * g.OW + ox) * g.C +
          c;
      for (int r = 0; r < rows; ++r) {
        int acc[16] = {};
        for (int ky = 0; ky < g.KH; ++ky)
          for (int kx = 0; kx < g.KW; ++kx)
            mac16(acc,
                  *reinterpret_cast<const uint4*>(col + (r + ky) * rpitch +
                                                  kx * g.CB),
                  wsm + (ky * g.KW + kx) * g.CB, ks);
        store_pixel<SILU_FAST>(acc, b, s, act, inv_out, alpha, live, vec,
                               dst + static_cast<long long>(r) * g.OW * g.C);
      }
    }
  }
}

using DwKernel = void (*)(const int8_t*, const int8_t*, const int*,
                          const float*, int8_t*, DwGeom, int, float, float);

// The kernel of a plan (with SILU_FAST where silu_fast) and its layout in g
// (its conv set), or null for a plan it cannot run; opts the kernel into
// its shared memory.
DwKernel prepare(int tile_h, int groups, bool silu_fast, DwGeom& g,
                 cudaError_t& err) {
  err = cudaErrorInvalidValue;
  if (tile_h < 1 || groups < 1 || groups > kMaxGroups || g.KH < 1 ||
      g.KW < 1 || g.OW < 1 || g.C < 1)
    return nullptr;
  g.TH = tile_h;
  g.G = groups;
  dw_layout(g);
  const bool k3 = g.KH == 3 && g.KW == 3;
  const DwKernel k =
      silu_fast ? (k3 ? dw_int8_fused_kernel<3, 3, true>
                      : dw_int8_fused_kernel<0, 0, true>)
                : (k3 ? dw_int8_fused_kernel<3, 3, false>
                      : dw_int8_fused_kernel<0, 0, false>);
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

void set_conv(DwGeom& g, int C, int KH, int KW, int OW) {
  g.C = C;
  g.KH = KH;
  g.KW = KW;
  g.OW = OW;
}

}  // namespace

// One launch: x NHWC [batch, H, W, C] int8, w [KH, KW, C] int8, bias [C]
// int32 or null, cs [C] f32, out NHWC [batch, OH, OW, C] int8; the top and
// left pads; the epilogue's act (tat::Act), inv_out and alpha. The plan:
// tile_h output rows a block, groups x 16 channels a block (1..16).
// Returns a cudaError_t; cudaErrorInvalidValue for a shape or plan it
// cannot run.
extern "C" int tat_dw_int8_fused(const void* x, const void* w,
                                 const void* bias, const void* cs, void* out,
                                 int batch, int H, int W, int C, int KH,
                                 int KW, int pt, int pl, int OH, int OW,
                                 int act, float inv_out, float alpha,
                                 int tile_h, int groups, void* stream) {
  if (batch < 1 || H < 1 || W < 1 || OH < 1 || cs == nullptr || act < 0 ||
      act > tat::kActSiluFast)
    return static_cast<int>(cudaErrorInvalidValue);
  DwGeom g = {};
  set_conv(g, C, KH, KW, OW);
  cudaError_t err;
  const DwKernel k = prepare(tile_h, groups, act == tat::kActSiluFast, g, err);
  if (k == nullptr) return static_cast<int>(err);
  g.H = H;
  g.W = W;
  g.pt = pt;
  g.pl = pl;
  g.OH = OH;
  g.row_tiles = (OH + tile_h - 1) / tile_h;
  g.slabs = ((C + 15) / 16 + groups - 1) / groups;
  g.vec_x = C % 16 == 0 && aligned16(x);
  g.vec_w = C % 16 == 0 && aligned16(w);
  g.vec_out = C % 16 == 0 && aligned16(out);
  const long long blocks =
      static_cast<long long>(batch) * g.row_tiles * g.slabs;
  if (blocks >= (1LL << 31)) return static_cast<int>(cudaErrorInvalidValue);
  k<<<static_cast<unsigned>(blocks), g.G * g.TW, static_cast<size_t>(g.smem),
      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(x), static_cast<const int8_t*>(w),
      static_cast<const int*>(bias), static_cast<const float*>(cs),
      static_cast<int8_t*>(out), g, act, inv_out, alpha);
  return static_cast<int>(cudaGetLastError());
}

// The dynamic shared memory of a plan in bytes and the blocks of its kernel
// (the one of every act but SILU_FAST) an SM holds at once;
// cudaErrorInvalidValue for a plan it cannot run.
extern "C" int tat_dw_int8_fused_info(int C, int KH, int KW, int OW,
                                      int tile_h, int groups, int* smem,
                                      int* blocks_per_sm) {
  DwGeom g = {};
  set_conv(g, C, KH, KW, OW);
  cudaError_t err;
  const DwKernel k = prepare(tile_h, groups, false, g, err);
  if (k == nullptr) return static_cast<int>(err);
  *smem = g.smem;
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, k, g.G * g.TW, static_cast<size_t>(g.smem)));
}
