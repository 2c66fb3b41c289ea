// The port's tensor-core KxK int8 conv: an NHWC x OHWI implicit-GEMM conv
// at any stride (sh, sw), dilation (dh, dw) and top / left pads, zeros
// outside the image, exact int32 sums:
//   acc[n, oy, ox, o] = sum_{ky,kx,c}
//       x[n, oy sh - pt + ky dh, ox sw - pl + kx dw, c] * w[o, ky, kx, c]
// then an epilogue policy on the fragments and one int8 store:
//   - ExactEpilogue (epilogue_policy.cuh): the exact tier's #10 and #11
//     (conv_int8_requant_mma.cu), the conv's activation a 256-byte table
//     staged in shared memory once a block;
//   - ServingEpilogue<ACT> (epilogue_policy.cuh): the serving tier's #2
//     and #5 (conv_int8_fused_mma.cu), with the residual r[n, oy, ox, o];
//   - ServingModeEpilogue<BF16>: the same for the JAX modes, the act at
//     run time; with BF16 the sums are f32 from the bf16 product of the
//     same int8 values (mma_tile.cuh mma_k32_bf16), equal to the int32
//     ones while below 2^24 in magnitude.
// The policy's Acc is the type of the sums.
// Each source that includes this header compiles its own copy (an
// anonymous namespace), so a kernel's code depends only on its policy.
//
// Design. A block owns (image n, a run of tpb TH x TW output tiles in
// row-major order, BN output channels); its 8 warps tile the TP = TH TW
// pixels x BN channels 4 x 2 with MI m16 x NI n8 mma.sync s8 tiles each
// (TP = 64 MI, BN = 16 NI). The product is mma.sync m16n8k32 from
// ldmatrix fragments (mma_tile.cuh), never dp4a. Two modes:
//   - slab (C % 32 == 0, x and w 16-byte aligned): each tile's input slab,
//     ((TH - 1) sh + (KH - 1) dh + 1) x ((TW - 1) sw + (KW - 1) dw + 1)
//     pixels x CK bytes at a pitch of CK + 16, comes in through a two-slot
//     cp.async ring: stage s + 1's copies fly while stage s computes, and
//     bytes outside the image are zero-filled by a source size of 0. A
//     rows are output pixels: the lane's ldmatrix row address of its pixel
//     (oy sh, ox sw) is worked out once a kernel, and a tap (ky, kx) adds
//     the uniform (ky dh SW + kx dw) pitch, so stride and dilation cost
//     nothing in the K loop, and each input byte crosses device memory once
//     a tile. B rows are the OHWI weights of the block's BN channels (KH KW
//     CK bytes a channel, the .col operand) at a pitch of KH KW CK + 16.
//     The weights are resident for the whole run of tiles, loaded once,
//     where they fit. Where the slab of all C beside them does not (3x3/s2
//     256 -> 512: two 9 x 33 pixel slots of 272 B and 32 resident rows of
//     2,320 B make 236 KB), the cover is C-chunks: C is walked in CK-byte
//     chunks, the int32 sums stay in registers across them, and each ring
//     stage carries the slab of one (tile, chunk), the weights staying
//     resident; only where they do not fit either does the stage also
//     carry the chunk's weight slice.
//   - im2col (any other C, or an operand off 16-byte alignment; the 6x6/s2
//     stem with C = 3): the block stages the tile's input slab of CK
//     channels with byte loads (a slab row is one contiguous run of NHWC
//     bytes; inside the image and with all C, no per-byte bounds), then
//     builds each output pixel's KH KW CK bytes, padded to a multiple of 32
//     (108 -> 128 for the stem; the weights' padding is zero), into a
//     shared-memory A row, and runs the same mma.sync loop over it as over
//     a 1x1. At dilation 1 a row is KH runs of KW CK slab bytes, copied 2
//     bytes (else 1) a step by threads that keep their step; otherwise a k
//     table made once a kernel gives each byte's slab offset. Weights are
//     staged the same way, once a block when C is one chunk. Where the
//     slab fits kPrefetch bytes a thread, the next stage's slab loads are
//     issued into registers before this stage's A build, product and
//     epilogue, so their latency is hidden.
// BN follows O: 64 or 32, and 16 (NI = 1) where a policy allows it.
//
// Epilogue: the policy on the C fragments in registers (lane (g, t) holds
// rows g and g + 8 of an m16 tile, columns 2t and 2t + 1 of an n8 tile;
// its channels' bias, and the serving cs, are loaded once a kernel), the
// int8 tile staged in shared memory at BN + 16 bytes a pixel, then written
// 16 bytes a thread along each pixel's BN bytes (at an O off 16 or an
// unaligned output, the widest stores that fit: 8, 4 or 1 bytes), the
// ragged edges masked. A residual joins before the
// quantization, so it must be in hand at the fragments: at the tile's last
// stage the block copies the tile's residual (TP pixels x BN bytes, NHWC)
// into the staged-output buffer, by cp.async where the residual is 16-byte
// aligned and O % 16 == 0 (ragged edges zero-filled by a source size of
// 0), else byte by byte; each lane reads its two bytes there and
// overwrites them with its result before the store pass.
//
// Shared memory (conv_layout, mirrored by ops/fused_kernels.py
// conv_layout), all dynamic, no static bytes: slab mode two stages (the
// slab, then the chunk's weights unless resident), the resident weights,
// the output tile; im2col mode the slab, the A tile, the weights, three k
// tables and the output tile; then the policy's table (kTableBytes).
// Every pitch of an ldmatrix operand is an odd multiple of 16 bytes, so
// the 8 rows of an ldmatrix at stride 1 fall on distinct bank groups (at
// stride 2 two rows share one).
//
// Built with -DTAT_CONV_REQUANT_NO_STORE the epilogue stores nothing and
// no residual is read (the sums are folded into one value that is kept
// live), with -DTAT_CONV_REQUANT_NO_PRODUCT no ldmatrix or mma.sync runs:
// variants compiled only to measure the shares of the epilogue and the
// product, for either policy; no wrapper loads them.
#pragma once

#include <cstdint>
#include <type_traits>

#include <cuda_runtime.h>

#include "epilogue.cuh"
#include "epilogue_policy.cuh"
#include "mma_tile.cuh"

namespace {

constexpr int kThreads = 256;    // 8 warps: 4 along the pixels, 2 along BN
constexpr int kPrefetch = 12;    // im2col: slab bytes a thread prefetches
constexpr int kOutPad = 16;      // bytes after each staged output pixel
// measurement variants: no epilogue stores, no product (ldmatrix and
// mma.sync)
#ifdef TAT_CONV_REQUANT_NO_STORE
constexpr bool kStore = false;
#else
constexpr bool kStore = true;
#endif
#ifdef TAT_CONV_REQUANT_NO_PRODUCT
constexpr bool kProduct = false;
#else
constexpr bool kProduct = true;
#endif

enum Mode : int { kSlab = 0, kIm2col = 1 };

// blocks an SM the registers must allow (__launch_bounds__): slab mode 2
// (128 registers a thread), im2col mode 3 (85), latency-bound
constexpr int min_blocks(int mode) { return mode == kSlab ? 2 : 3; }

// n / d for 0 <= n < 2^31 by a multiply and a shift: m = ceil(2^(32+s) /
// d) - 2^32, s = ceil(log2 d) (Granlund and Montgomery)
struct FastDiv {
  unsigned d, m, s;
};
FastDiv fast_div(int d) {
  FastDiv f{static_cast<unsigned>(d), 0, 0};
  while ((1ull << f.s) < f.d) ++f.s;
  f.m = static_cast<unsigned>(((1ull << (32 + f.s)) + f.d - 1) / f.d -
                              (1ull << 32));
  return f;
}
__device__ __forceinline__ int quot(const FastDiv& f, int n) {
  const unsigned u = static_cast<unsigned>(n);
  return static_cast<int>((__umulhi(u, f.m) + u) >> f.s);
}

struct ConvGeom {
  int H, W, C, O, KH, KW, sh, sw, dh, dw, pt, pl, OH, OW;
  int mode, TH, TW, lg_tw, BN, CK, nck;   // the plan; nck = C chunks
  int SH, SW;      // slab rows and columns
  int pitch;       // slab mode: slab bytes a pixel, CK + 16
  int kc;          // im2col: K bytes a chunk, KH KW CK rounded up to 32
  int wpitch;      // weight bytes a channel: KH KW CK + 16 (slab), kc + 16
  int resident;    // the weights are loaded once a block (all C)
  int vec_out;     // 16-byte output stores (O % 16 == 0, out aligned)
  int vec_slab;    // im2col: 16-byte slab copies (C, CK % 16 == 0, x aligned)
  int ntw, tiles_img, tpb, nchunk;
  int slab_bytes, stage_bytes, a_off, w_off, ktab_off, out_off, tab_off;
  int smem;
  FastDiv by_row, by_ck, by_words, by_kc;   // im2col's index divisions
  // im2col with dw == 1: a pixel's A row is KH runs of KW CK slab bytes,
  // copied run_unit (16, 8, 4, 2 or 1) bytes a step by fixed threads,
  // run_units steps a pixel (0: no run copy, the k table builds the row)
  int run_unit, run_units;
};

constexpr int round_up(int v, int m) { return (v + m - 1) / m * m; }

// The shared-memory layout of one block (ops/fused_kernels.py conv_layout
// mirrors it); g.resident set by the plan; table_bytes: the policy's table
// after the output tile.
void conv_layout(ConvGeom& g, int table_bytes) {
  g.SH = (g.TH - 1) * g.sh + (g.KH - 1) * g.dh + 1;
  g.SW = (g.TW - 1) * g.sw + (g.KW - 1) * g.dw + 1;
  g.nck = (g.C + g.CK - 1) / g.CK;
  const int tp = g.TH * g.TW;
  if (g.mode == kSlab) {
    g.pitch = g.CK + tat::kRowPad;
    g.wpitch = g.KH * g.KW * (g.resident ? g.C : g.CK) + tat::kRowPad;
    g.slab_bytes = g.SH * g.SW * g.pitch;
    g.stage_bytes = g.slab_bytes + (g.resident ? 0 : g.BN * g.wpitch);
    g.w_off = 2 * g.stage_bytes;   // the resident weights
    g.out_off = g.w_off + (g.resident ? g.BN * g.wpitch : 0);
  } else {
    g.kc = round_up(g.KH * g.KW * g.CK, tat::kMmaStepBytes);
    g.wpitch = g.kc + tat::kRowPad;
    g.slab_bytes = round_up(g.SH * g.SW * g.CK, 16);
    g.a_off = g.slab_bytes;
    g.w_off = g.a_off + tp * g.wpitch;
    g.ktab_off = g.w_off + g.BN * g.wpitch;
    g.out_off = g.ktab_off + 3 * 4 * g.kc;
    g.by_row = fast_div(g.SW * g.CK);
    g.by_ck = fast_div(g.CK);
    g.by_words = fast_div(g.kc / 4);
    g.by_kc = fast_div(g.kc);
    // the widest step that keeps every run's slab and A offsets aligned
    const int run = g.KW * g.CK;
    g.run_unit = 16;
    while (g.run_unit > 1 && (run % g.run_unit != 0 ||
                              g.sw * g.CK % g.run_unit != 0 ||
                              g.SW * g.CK % g.run_unit != 0))
      g.run_unit /= 2;
    g.run_units = g.KH * run / g.run_unit;
    if (g.dw != 1 || g.run_units > kThreads) g.run_units = 0;
  }
  g.tab_off = g.out_off + tp * (g.BN + kOutPad);
  g.smem = g.tab_off + table_bytes;
}

__device__ __forceinline__ void tile_origin(const ConvGeom& g, int tile,
                                            int& oy0, int& ox0) {
  const int trow = tile / g.ntw;
  oy0 = trow * g.TH;
  ox0 = (tile - trow * g.ntw) * g.TW;
}

// --- slab mode: the ring's copies, 16 bytes each ---------------------------

// BN weight rows of channels c0 .. c0 + width: KH KW taps of width bytes
// a row (rows past O zero).
__device__ void issue_weights(const int8_t* __restrict__ w,
                              unsigned char* dst, const ConvGeom& g, int n0,
                              int c0, int width) {
  const int upt = width / 16;                // copies a tap
  const int upr = g.KH * g.KW * upt;         // copies a row
  const long long taps = static_cast<long long>(g.KH) * g.KW;
  for (int u = threadIdx.x; u < g.BN * upr; u += kThreads) {
    const int r = u / upr, rem = u - r * upr;
    const int tap = rem / upt, cu = rem - tap * upt;
    const bool ok = n0 + r < g.O;
    const int8_t* src =
        ok ? w + ((n0 + r) * taps + tap) * g.C + c0 + 16 * cu : w;
    tat::cp_async16(dst + r * g.wpitch + tap * width + 16 * cu, src,
                    ok ? 16 : 0);
  }
}

// The slab of (tile, chunk) into `slot`, then its weight slice unless the
// weights are resident; zeros outside the image.
__device__ void issue_stage(const int8_t* __restrict__ x,
                            const int8_t* __restrict__ w, unsigned char* slot,
                            const ConvGeom& g, int n, int tile, int chunk,
                            int n0) {
  int oy0, ox0;
  tile_origin(g, tile, oy0, ox0);
  const int iy0 = oy0 * g.sh - g.pt, ix0 = ox0 * g.sw - g.pl;
  const int c0 = chunk * g.CK;
  const int upp = g.CK / 16;   // copies a pixel
  const int units = g.SH * g.SW * upp;
  const long long img = static_cast<long long>(n) * g.H;
  for (int u = threadIdx.x; u < units; u += kThreads) {
    const int pix = u / upp, cu = u - pix * upp;
    const int r = pix / g.SW, col = pix - r * g.SW;
    const int iy = iy0 + r, ix = ix0 + col;
    const bool ok = iy >= 0 && iy < g.H && ix >= 0 && ix < g.W;
    const int8_t* src =
        ok ? x + ((img + iy) * g.W + ix) * g.C + c0 + 16 * cu : x;
    tat::cp_async16(slot + pix * g.pitch + 16 * cu, src, ok ? 16 : 0);
  }
  if (!g.resident) issue_weights(w, slot + g.slab_bytes, g, n0, c0, g.CK);
}

// --- im2col mode: synchronous byte loads ----------------------------------

// Slab byte u = threadIdx.x + e kThreads of (tile, chunk c0) for e <
// N: zero outside the image and at channels past C. All N loads are
// issued before any is used, so their latencies overlap.
template <int N>
__device__ __forceinline__ void fetch_slab(const int8_t* __restrict__ x,
                                           const ConvGeom& g, int n, int tile,
                                           int c0, int u0,
                                           unsigned char (&v)[N]) {
  int oy0, ox0;
  tile_origin(g, tile, oy0, ox0);
  const int iy0 = oy0 * g.sh - g.pt, ix0 = ox0 * g.sw - g.pl;
  const int total = g.SH * g.SW * g.CK;
  const long long img = static_cast<long long>(n) * g.H;
  if (g.CK == g.C && iy0 >= 0 && iy0 + g.SH <= g.H && ix0 >= 0 &&
      ix0 + g.SW <= g.W) {
    // inside the image, all C: slab row r is x's bytes from (iy0 + r, ix0)
    const int8_t* base = x + ((img + iy0) * g.W + ix0) * g.C;
    const int skip = (g.W - g.SW) * g.C;   // x bytes between slab rows
#pragma unroll
    for (int e = 0; e < N; ++e) {
      const int u = u0 + e * kThreads;
      v[e] = u < total ? static_cast<unsigned char>(
                             base[u + quot(g.by_row, u) * skip])
                       : 0;
    }
    return;
  }
#pragma unroll
  for (int e = 0; e < N; ++e) {
    const int u = u0 + e * kThreads;
    const int r = quot(g.by_row, u), b = u - r * g.SW * g.CK;
    const int col = quot(g.by_ck, b), c = b - col * g.CK;
    const int iy = iy0 + r, ix = ix0 + col;
    const bool ok = u < total && iy >= 0 && iy < g.H && ix >= 0 &&
                    ix < g.W && c0 + c < g.C;
    v[e] = ok ? static_cast<unsigned char>(
                    x[((img + iy) * g.W + ix) * g.C + c0 + c])
              : 0;
  }
}

template <int N>
__device__ __forceinline__ void put_slab(unsigned char* slab,
                                         const ConvGeom& g, int u0,
                                         const unsigned char (&v)[N]) {
  const int total = g.SH * g.SW * g.CK;
#pragma unroll
  for (int e = 0; e < N; ++e)
    if (u0 + e * kThreads < total) slab[u0 + e * kThreads] = v[e];
}

// g.vec_slab: the slab of (tile, chunk c0) at CK bytes a pixel by 16-byte
// cp.async copies, zeros outside the image and past C; then a commit.
__device__ void issue_slab_im2col(const int8_t* __restrict__ x,
                                  unsigned char* slab, const ConvGeom& g,
                                  int n, int tile, int c0) {
  int oy0, ox0;
  tile_origin(g, tile, oy0, ox0);
  const int iy0 = oy0 * g.sh - g.pt, ix0 = ox0 * g.sw - g.pl;
  const int upp = g.CK / 16;   // copies a pixel
  const int units = g.SH * g.SW * upp;
  const long long img = static_cast<long long>(n) * g.H;
  for (int u = threadIdx.x; u < units; u += kThreads) {
    const int pix = u / upp, c = 16 * (u - pix * upp);
    const int r = pix / g.SW, col = pix - r * g.SW;
    const int iy = iy0 + r, ix = ix0 + col;
    const bool ok = iy >= 0 && iy < g.H && ix >= 0 && ix < g.W &&
                    c0 + c < g.C;
    const int8_t* src = ok ? x + ((img + iy) * g.W + ix) * g.C + c0 + c : x;
    tat::cp_async16(slab + pix * g.CK + c, src, ok ? 16 : 0);
  }
  tat::cp_async_commit();
}

// The whole slab of (tile, chunk c0), kPrefetch bytes a thread a pass.
__device__ void load_slab_bytes(const int8_t* __restrict__ x,
                                unsigned char* slab, const ConvGeom& g, int n,
                                int tile, int c0) {
  const int total = g.SH * g.SW * g.CK;
  for (int u0 = threadIdx.x; u0 < total; u0 += kPrefetch * kThreads) {
    unsigned char v[kPrefetch];
    fetch_slab(x, g, n, tile, c0, u0, v);
    put_slab(slab, g, u0, v);
  }
}

// BN weight rows of chunk c0 in the A tile's k order (zeros past K, past C
// and for rows past O).
__device__ void load_weights_bytes(const int8_t* __restrict__ w,
                                   unsigned char* dst, const ConvGeom& g,
                                   const int* ktw, const int* ktc, int n0,
                                   int c0) {
  const long long K = static_cast<long long>(g.KH) * g.KW * g.C;
  const int total = g.BN * g.kc;
  for (int u0 = threadIdx.x; u0 < total; u0 += kPrefetch * kThreads) {
    unsigned char v[kPrefetch];
#pragma unroll
    for (int e = 0; e < kPrefetch; ++e) {
      const int u = u0 + e * kThreads;
      const int r = quot(g.by_kc, u), k = u - r * g.kc;
      const bool ok = u < total && n0 + r < g.O && ktw[k] >= 0 &&
                      c0 + ktc[k] < g.C;
      v[e] = ok ? static_cast<unsigned char>(w[(n0 + r) * K + ktw[k] + c0])
                : 0;
    }
#pragma unroll
    for (int e = 0; e < kPrefetch; ++e) {
      const int u = u0 + e * kThreads;
      const int r = quot(g.by_kc, u);
      if (u < total) dst[r * g.wpitch + u - r * g.kc] = v[e];
    }
  }
}

// The A tile: TP rows of kc bytes from the slab, one 4-byte word a step.
template <int TP>
__device__ void build_a(const unsigned char* slab, unsigned char* a,
                        const ConvGeom& g, const int* ktx) {
  const int wpr = g.kc / 4;   // words a row
  for (int u = threadIdx.x; u < TP * wpr; u += kThreads) {
    const int p = quot(g.by_words, u), k = 4 * (u - p * wpr);
    const unsigned char* px =
        slab + ((p >> g.lg_tw) * g.sh * g.SW + (p & (g.TW - 1)) * g.sw) *
                   g.CK;
    unsigned word = 0;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int off = ktx[k + e];
      if (off >= 0) word |= static_cast<unsigned>(px[off]) << (8 * e);
    }
    *reinterpret_cast<unsigned*>(a + p * g.wpitch + k) = word;
  }
}

// The A tile by runs (g.run_units > 0), U = g.run_unit bytes a step:
// thread t copies step t % run_units of every (kThreads / run_units)-th
// pixel from t / run_units on. The K padding of the rows is left as it
// is: the weights' padding is zero.
template <int TP, int U>
__device__ void build_a_runs_of(const unsigned char* slab, unsigned char* a,
                                const ConvGeom& g) {
  using Word = typename std::conditional<
      U == 16, uint4,
      typename std::conditional<
          U == 8, uint2,
          typename std::conditional<
              U == 4, unsigned,
              typename std::conditional<U == 2, uint16_t,
                                        unsigned char>::type>::type>::type>::
      type;
  const int groups = kThreads / g.run_units;
  if (threadIdx.x >= groups * g.run_units) return;
  const int q = threadIdx.x % g.run_units;
  const int per_ky = g.KW * g.CK / U;
  const int ky = q / per_ky, j = (q - ky * per_ky) * U;
  const int soff = ky * g.dh * g.SW * g.CK + j;   // in the pixel's window
  const int aoff = ky * g.KW * g.CK + j;          // in the A row
  for (int p = threadIdx.x / g.run_units; p < TP; p += groups) {
    const unsigned char* src =
        slab + ((p >> g.lg_tw) * g.sh * g.SW + (p & (g.TW - 1)) * g.sw) *
                   g.CK + soff;
    *reinterpret_cast<Word*>(a + p * g.wpitch + aoff) =
        *reinterpret_cast<const Word*>(src);
  }
}

template <int TP>
__device__ void build_a_runs(const unsigned char* slab, unsigned char* a,
                             const ConvGeom& g) {
  switch (g.run_unit) {
    case 16:
      return build_a_runs_of<TP, 16>(slab, a, g);
    case 8:
      return build_a_runs_of<TP, 8>(slab, a, g);
    case 4:
      return build_a_runs_of<TP, 4>(slab, a, g);
    case 2:
      return build_a_runs_of<TP, 2>(slab, a, g);
    default:
      return build_a_runs_of<TP, 1>(slab, a, g);
  }
}

// --- resident weights of the fused kernels on the core ---------------------

// `rows` weight rows of `taps` taps (or parts) of `width` bytes each (rows
// past `live` and bytes past `width` zero) into dst: row r's tap t at
// r pitch + t padded, from src + r ld + t width; padded a multiple of 16 >=
// width. 16-byte cp.async copies (vec: width and ld multiples of 16, src
// 16-byte aligned), else byte loads. The fused C3 bottleneck
// (bneck_int8_fused.cu) and SPPF (sppf_int8_fused.cu) load their weights
// with it.
__device__ void load_weight_rows(const int8_t* __restrict__ src,
                                 unsigned char* dst, int rows, int live,
                                 int taps, int width, int padded, int pitch,
                                 long long ld, bool vec) {
  const int upt = padded / 16;   // 16-byte units a tap
  for (int u = threadIdx.x; u < rows * taps * upt; u += kThreads) {
    const int rt = u / upt, c = 16 * (u - rt * upt);
    const int r = rt / taps, t = rt - r * taps;
    const int left = width - c;
    const int bytes = r >= live || left <= 0 ? 0 : (left < 16 ? left : 16);
    const int8_t* s = bytes > 0 ? src + r * ld + t * width + c : src;
    unsigned char* d = dst + r * pitch + t * padded + c;
    if (vec)
      tat::cp_async16(d, s, bytes);
    else
      *reinterpret_cast<uint4*>(d) = tat::load16_bytes(s, bytes);
  }
}

// --- the residual ----------------------------------------------------------

// The residual bytes of (tile, channels n0 .. n0 + BN) into the staged
// output tile, its pitch BN + kOutPad: 16-byte cp.async copies, zeros past
// the image and past O (p.vec_res), else byte loads; then a commit, so
// that cp_async_wait<0> and a barrier make them visible.
template <int BN>
__device__ void load_residual(const ServingParams& p, unsigned char* staged,
                              const ConvGeom& g, int n, int tile, int n0) {
  const int tp = g.TH * g.TW;
  int oy0, ox0;
  tile_origin(g, tile, oy0, ox0);
  const int live = g.O - n0 < BN ? g.O - n0 : BN;
  const long long img = static_cast<long long>(n) * g.OH;
  if (p.vec_res) {
    constexpr int upp = BN / 16;   // copies a pixel
    for (int u = threadIdx.x; u < tp * upp; u += kThreads) {
      const int q = u / upp, c = 16 * (u - q * upp);
      const int oy = oy0 + (q >> g.lg_tw), ox = ox0 + (q & (g.TW - 1));
      const bool ok = oy < g.OH && ox < g.OW && c < live;
      const int8_t* src =
          ok ? p.res + ((img + oy) * g.OW + ox) * g.O + n0 + c : p.res;
      tat::cp_async16(staged + q * (BN + kOutPad) + c, src, ok ? 16 : 0);
    }
  } else {
    for (int u = threadIdx.x; u < tp * BN; u += kThreads) {
      const int q = u / BN, c = u - q * BN;
      const int oy = oy0 + (q >> g.lg_tw), ox = ox0 + (q & (g.TW - 1));
      const bool ok = oy < g.OH && ox < g.OW && c < live;
      staged[q * (BN + kOutPad) + c] =
          ok ? static_cast<unsigned char>(
                   p.res[((img + oy) * g.OW + ox) * g.O + n0 + c])
             : 0;
    }
  }
  tat::cp_async_commit();
}

// The tile's residual, issued at its last stage, after the barrier that
// ends the previous tile's store pass (the staged buffer is free).
template <class EP, int BN>
__device__ __forceinline__ void start_residual(const typename EP::Params& p,
                                               unsigned char* staged,
                                               const ConvGeom& g, int n,
                                               int tile, int n0) {
  if constexpr (EP::kResidual && kStore) {
    if (p.res != nullptr) load_residual<BN>(p, staged, g, n, tile, n0);
  }
}

// --- the product ---------------------------------------------------------

// One 32-byte K step: acc += A (MI m16 tiles, rows at `at` + aoff) x B (NI
// n8 tiles, the lane's row at `bt`, tiles 16 rows apart in pairs; NI = 1:
// one .x2 load from lanes 0-15).
template <int MI, int NI>
__device__ __forceinline__ void mma_k32(int (&acc)[MI][NI][4],
                                        const unsigned char* at,
                                        const int (&aoff)[MI],
                                        const unsigned char* bt, int wpitch) {
  unsigned bfr[NI][2];
  if constexpr (NI == 1) {
    tat::ldsm_x2(bfr[0], bt);
  } else {
#pragma unroll
    for (int j = 0; j < NI / 2; ++j) {
      unsigned r[4];
      tat::ldsm_x4(r, bt + j * 16 * wpitch);
      bfr[2 * j][0] = r[0];
      bfr[2 * j][1] = r[1];
      bfr[2 * j + 1][0] = r[2];
      bfr[2 * j + 1][1] = r[3];
    }
  }
#pragma unroll
  for (int mi = 0; mi < MI; ++mi) {
    unsigned afr[4];
    tat::ldsm_x4(afr, at + aoff[mi]);
#pragma unroll
    for (int ni = 0; ni < NI; ++ni) tat::mma_s8(acc[mi][ni], afr, bfr[ni]);
  }
}
// ... on f32 sums: the bf16 product (TAT_SERVING_COMPUTE=bf16)
template <int MI, int NI>
__device__ __forceinline__ void mma_k32(float (&acc)[MI][NI][4],
                                        const unsigned char* at,
                                        const int (&aoff)[MI],
                                        const unsigned char* bt, int wpitch) {
  tat::mma_k32_bf16<MI, NI>(acc, at, aoff, bt, wpitch);
}

// The slab mode's product of one chunk: for each tap (ky, kx) of KH x KW,
// acc += the ck bytes of the lane's slab pixels (rows at `slab` + aoff,
// tap (0, 0); a tap adds the uniform (ky dh SW + kx dw) pitch) times the
// tap's B rows (the lane's row at w + tap wtap, or w + (tap % ring) wtap
// through a ring of `ring` slots; wpitch apart). wait(tap) runs before a
// tap's product (a ring's wait for its slot). The core's slab mode and the
// fused C3 bottleneck's stage 2 over its m slab (bneck_int8_fused.cu) run
// it.
template <int MI, int NI, class Wait, class Acc>
__device__ __forceinline__ void slab_taps(
    Acc (&acc)[MI][NI][4], const unsigned char* slab, const int (&aoff)[MI],
    int KH, int KW, int dh, int dw, int SW, int pitch, int ck,
    const unsigned char* w, int wtap, int ring, int wpitch, Wait&& wait) {
  int tap = 0;
  for (int ky = 0; ky < KH; ++ky) {
    const unsigned char* arow = slab + ky * dh * SW * pitch;
    for (int kx = 0; kx < KW; ++kx, ++tap) {
      const unsigned char* at = arow + kx * dw * pitch;
      wait(tap);
      const unsigned char* bt = w + (ring > 0 ? tap % ring : tap) * wtap;
      for (int kb = 0; kb < ck; kb += tat::kMmaStepBytes)
        if constexpr (kProduct)
          mma_k32<MI, NI>(acc, at + kb, aoff, bt + kb, wpitch);
    }
  }
}

// --- the epilogue --------------------------------------------------------

// The policy on the fragments into the staged int8 tile (TP pixels at BN +
// kOutPad bytes; with a residual, each lane's two bytes there are its
// residual, read before they are overwritten), then each pixel's channels
// out, 16 bytes a thread. WAIT_RES: the residual is still in flight
// (load_residual's copies; a wait and a barrier make it visible); false: the
// caller staged it and a barrier since made it visible (the fused C3
// bottleneck copies it from its input slab, bneck_int8_fused.cu). The tile's
// geometry is g's TH x TW tiles of an OH x OW output (TH = 1, TW = TP and
// OW = H W give TP consecutive pixels of a row-major image, as the fused
// SPPF, sppf_int8_fused.cu, stores them).
template <int MI, int NI, class EP, bool WAIT_RES = true>
__device__ void store_tile(const typename EP::Acc (&acc)[MI][NI][4],
                           const typename EP::Col (&cols)[NI][2],
                           const ConvGeom& g, unsigned char* staged,
                           const unsigned char* tab, int n, int tile, int n0,
                           const typename EP::Params& ep,
                           int8_t* __restrict__ out) {
  constexpr int BN = 16 * NI, TP = 64 * MI, kPitch = BN + kOutPad;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp & 3, wn = warp >> 2;
  const int gq = lane >> 2, tq = lane & 3;
  bool res = false;
  if constexpr (EP::kResidual) {
    res = ep.res != nullptr;
    if (WAIT_RES && res) {
      tat::cp_async_wait<0>();   // the tile's residual landed
      __syncthreads();
    }
  }
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = (wm * MI + mi) * 16 + gq + 8 * h;
#pragma unroll
      for (int ni = 0; ni < NI; ++ni) {
        const int col = wn * 8 * NI + ni * 8 + 2 * tq;
        uint16_t* dst = reinterpret_cast<uint16_t*>(staged + row * kPitch +
                                                    col);
        int r0 = 0, r1 = 0;
        if (res) {
          const unsigned v = *dst;
          r0 = static_cast<int8_t>(v & 0xffu);
          r1 = static_cast<int8_t>(v >> 8);
        }
        const unsigned q0 = static_cast<uint8_t>(
            EP::apply(acc[mi][ni][2 * h], cols[ni][0], ep, r0, tab));
        const unsigned q1 = static_cast<uint8_t>(
            EP::apply(acc[mi][ni][2 * h + 1], cols[ni][1], ep, r1, tab));
        *dst = static_cast<uint16_t>(q0 | q1 << 8);
      }
    }
  __syncthreads();
  int oy0, ox0;
  tile_origin(g, tile, oy0, ox0);
  const int live = g.O - n0 < BN ? g.O - n0 : BN;   // channels of the block
  for (int u = threadIdx.x; u < TP * NI; u += kThreads) {
    const int p = u / NI, c = 16 * (u - p * NI);   // NI 16-byte units a pixel
    const int oy = oy0 + (p >> g.lg_tw), ox = ox0 + (p & (g.TW - 1));
    if (oy >= g.OH || ox >= g.OW || c >= live) continue;
    int8_t* dst =
        out + ((static_cast<long long>(n) * g.OH + oy) * g.OW + ox) * g.O +
        n0 + c;
    const unsigned char* src = staged + p * kPitch + c;
    if (g.vec_out && c + 16 <= live) {
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
    } else {   // the widest stores the address and the length allow
      const int m = live - c < 16 ? live - c : 16;
      const unsigned al = static_cast<unsigned>(
                              reinterpret_cast<uintptr_t>(dst)) | m;
      if ((al & 7u) == 0) {
        for (int b = 0; b < m; b += 8)
          *reinterpret_cast<uint2*>(dst + b) =
              *reinterpret_cast<const uint2*>(src + b);
      } else if ((al & 3u) == 0) {
        for (int b = 0; b < m; b += 4)
          *reinterpret_cast<unsigned*>(dst + b) =
              *reinterpret_cast<const unsigned*>(src + b);
      } else {
        for (int b = 0; b < m; ++b) dst[b] = static_cast<int8_t>(src[b]);
      }
    }
  }
}

// The no-store variant's epilogue: the sums folded into one value that is
// stored only if it takes one given value, so the product is kept.
template <int MI, int NI, class Acc>
__device__ __forceinline__ void sink_tile(const Acc (&acc)[MI][NI][4],
                                          int8_t* __restrict__ out) {
  int f = 0;
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int ni = 0; ni < NI; ++ni)
#pragma unroll
      for (int r = 0; r < 4; ++r) f ^= tat::sum_bits(acc[mi][ni][r]) * (r + 1);
  if (f == 0x5a5a5a5a) out[0] = 1;
}

// --- the kernel ------------------------------------------------------------

template <int MODE, int MI, int NI, class EP>
__global__ void __launch_bounds__(kThreads, min_blocks(MODE))
    conv_mma_kernel(const int8_t* __restrict__ x,
                    const int8_t* __restrict__ w,
                    const int* __restrict__ bias, int8_t* __restrict__ out,
                    ConvGeom g, typename EP::Params ep) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int BN = 16 * NI, TP = 64 * MI;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int n = blockIdx.x / g.nchunk;
  const int t0 = (blockIdx.x - n * g.nchunk) * g.tpb;
  const int rest = g.tiles_img - t0;
  const int tiles = rest < g.tpb ? rest : g.tpb;
  const int stages = tiles * g.nck;
  const int n0 = blockIdx.y * BN;
  const int wm = warp & 3, wn = warp >> 2, tq = lane & 3;

  // the lane's ldmatrix A rows: its pixel of each m16 tile, at tap (0, 0)
  // of the slab (slab mode) or in the A tile (im2col mode)
  int aoff[MI];
#pragma unroll
  for (int mi = 0; mi < MI; ++mi) {
    const int p = (wm * MI + mi) * 16 + tat::a_lane_row(lane);
    aoff[mi] = (MODE == kSlab
                    ? ((p >> g.lg_tw) * g.sh * g.SW + (p & (g.TW - 1)) * g.sw) *
                          g.pitch
                    : p * g.wpitch) +
               tat::a_lane_byte(lane);
  }
  // ... and its B row for .x4 loads of two n8 tiles: matrices (tile 0,
  // bytes 0-15), (tile 0, 16-31), (tile 1, 0-15), (tile 1, 16-31)
  const int brow = (wn * 8 * NI + (lane & 7) + 8 * (lane >> 4)) * g.wpitch +
                   ((lane >> 3) & 1) * 16;
  // what the lane's channels take into the epilogue
  typename EP::Col cols[NI][2];
#pragma unroll
  for (int ni = 0; ni < NI; ++ni)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int o = n0 + wn * 8 * NI + ni * 8 + 2 * tq + e;
      cols[ni][e] = EP::col(bias, ep, o, o < g.O);
    }
  unsigned char* staged = smem + g.out_off;
  unsigned char* tab = smem + g.tab_off;
  EP::stage_table(ep, tab);

  typename EP::Acc acc[MI][NI][4];
  if constexpr (MODE == kSlab) {
    // group 0: the resident weights and stage 0
    if (g.resident) issue_weights(w, smem + g.w_off, g, n0, 0, g.C);
    issue_stage(x, w, smem, g, n, t0, 0, n0);
    tat::cp_async_commit();
    int tile = t0, chunk = 0;   // of stage s
    for (int s = 0; s < stages; ++s) {
      if (s + 1 < stages) {
        const bool wrap = chunk + 1 == g.nck;
        issue_stage(x, w, smem + ((s + 1) & 1) * g.stage_bytes, g, n,
                    wrap ? tile + 1 : tile, wrap ? 0 : chunk + 1, n0);
      }
      tat::cp_async_commit();    // empty on the last stage: keeps the count
      tat::cp_async_wait<1>();   // stage s (and the weights) landed
      __syncthreads();
      if (chunk + 1 == g.nck)
        start_residual<EP, BN>(ep, staged, g, n, tile, n0);
      const unsigned char* slot = smem + (s & 1) * g.stage_bytes;
      // the chunk's weights: in the resident rows of all C, or the slice
      // the stage carries
      const unsigned char* wl =
          g.resident ? smem + g.w_off + brow + chunk * g.CK
                     : slot + g.slab_bytes + brow;
      const int wtap = g.resident ? g.C : g.CK;   // B bytes a tap
      if (chunk == 0) {
#pragma unroll
        for (int mi = 0; mi < MI; ++mi)
#pragma unroll
          for (int ni = 0; ni < NI; ++ni)
#pragma unroll
            for (int r = 0; r < 4; ++r) acc[mi][ni][r] = 0;
      }
      slab_taps<MI, NI>(acc, slot, aoff, g.KH, g.KW, g.dh, g.dw, g.SW,
                        g.pitch, g.CK, wl, wtap, 0, g.wpitch, [](int) {});
      __syncthreads();   // slot s & 1 is read: the next stage refills it
      if (++chunk == g.nck) {
        if constexpr (kStore)
          store_tile<MI, NI, EP>(acc, cols, g, staged, tab, n, tile, n0,
                                 ep, out);
        else
          sink_tile<MI, NI>(acc, out);
        chunk = 0;
        ++tile;
      }
    }
  } else {
    // the k tables: slab offset of k's tap and channel, its weight offset
    // in an OHWI row less the chunk's first channel, its channel; -1 past
    // KH KW CK
    int* ktx = reinterpret_cast<int*>(smem + g.ktab_off);
    int* ktw = ktx + g.kc;
    int* ktc = ktw + g.kc;
    const int kk = g.KH * g.KW * g.CK;
    for (int k = tid; k < g.kc; k += kThreads) {
      if (k < kk) {
        const int tap = k / g.CK, c = k - tap * g.CK;
        const int ky = tap / g.KW, kx = tap - ky * g.KW;
        ktx[k] = (ky * g.dh * g.SW + kx * g.dw) * g.CK + c;
        ktw[k] = tap * g.C + c;
        ktc[k] = c;
      } else {
        ktx[k] = ktw[k] = ktc[k] = -1;
      }
    }
    unsigned char* slab = smem;
    unsigned char* a = smem + g.a_off;
    unsigned char* b = smem + g.w_off;
    // the slab: 16-byte copies issued a stage ahead (vec_slab), else byte
    // loads, prefetched into registers a stage ahead where they fit
    const bool prefetch =
        !g.vec_slab && g.SH * g.SW * g.CK <= kPrefetch * kThreads;
    unsigned char pv[kPrefetch];
    if (g.vec_slab)
      issue_slab_im2col(x, slab, g, n, t0, 0);
    else if (prefetch)
      fetch_slab(x, g, n, t0, 0, tid, pv);
    int tile = t0, chunk = 0;
    for (int s = 0; s < stages; ++s) {
      if (g.vec_slab) tat::cp_async_wait<0>();   // this stage's slab
      __syncthreads();   // the last stage's slab, A and B are read
      if (chunk + 1 == g.nck)
        start_residual<EP, BN>(ep, staged, g, n, tile, n0);
      if (!g.vec_slab) {
        if (prefetch) {
          put_slab(slab, g, tid, pv);
          if (s + 1 < stages) {   // the next stage's loads fly meanwhile
            const bool wrap = chunk + 1 == g.nck;
            fetch_slab(x, g, n, wrap ? tile + 1 : tile,
                       (wrap ? 0 : chunk + 1) * g.CK, tid, pv);
          }
        } else {
          load_slab_bytes(x, slab, g, n, tile, chunk * g.CK);
        }
      }
      if (!g.resident || s == 0)
        load_weights_bytes(w, b, g, ktw, ktc, n0, chunk * g.CK);
      __syncthreads();
      if (g.run_units > 0)
        build_a_runs<TP>(slab, a, g);
      else
        build_a<TP>(slab, a, g, ktx);
      __syncthreads();
      if (g.vec_slab && s + 1 < stages) {   // the slab is free: the next
        const bool wrap = chunk + 1 == g.nck;   // stage's copies fly now
        issue_slab_im2col(x, slab, g, n, wrap ? tile + 1 : tile,
                          (wrap ? 0 : chunk + 1) * g.CK);
      }
      if (chunk == 0) {
#pragma unroll
        for (int mi = 0; mi < MI; ++mi)
#pragma unroll
          for (int ni = 0; ni < NI; ++ni)
#pragma unroll
            for (int r = 0; r < 4; ++r) acc[mi][ni][r] = 0;
      }
      for (int kb = 0; kb < g.kc; kb += tat::kMmaStepBytes)
        if constexpr (kProduct)
          mma_k32<MI, NI>(acc, a + kb, aoff, b + brow + kb, g.wpitch);
      if (++chunk == g.nck) {
        if constexpr (kStore)
          store_tile<MI, NI, EP>(acc, cols, g, staged, tab, n, tile, n0,
                                 ep, out);
        else
          sink_tile<MI, NI>(acc, out);
        chunk = 0;
        ++tile;
      }
    }
  }
}

template <class P>
using ConvKernel = void (*)(const int8_t*, const int8_t*, const int*, int8_t*,
                            ConvGeom, P);

template <int MODE, class EP>
ConvKernel<typename EP::Params> pick(int mi, int ni) {
  if constexpr (EP::kBn16) {
    if (mi == 1 && ni == 1) return conv_mma_kernel<MODE, 1, 1, EP>;
    if (mi == 2 && ni == 1) return conv_mma_kernel<MODE, 2, 1, EP>;
  }
  if (mi == 1 && ni == 2) return conv_mma_kernel<MODE, 1, 2, EP>;
  if (mi == 1 && ni == 4) return conv_mma_kernel<MODE, 1, 4, EP>;
  if (mi == 2 && ni == 2) return conv_mma_kernel<MODE, 2, 2, EP>;
  if (mi == 2 && ni == 4) return conv_mma_kernel<MODE, 2, 4, EP>;
  return nullptr;
}

// The kernel of a plan and its layout in g (whose C, KH, KW, sh, sw, dh,
// dw are set), or null for a plan the kernel cannot run; opts the kernel
// into its shared memory.
template <class EP>
ConvKernel<typename EP::Params> prepare(int mode, int tile_h, int tile_w,
                                        int bn, int ck, int resident,
                                        ConvGeom& g, cudaError_t& err) {
  err = cudaErrorInvalidValue;
  int lg = 0;
  while (lg < 6 && (1 << lg) != tile_w) ++lg;
  const int tp = tile_h * tile_w;
  if (lg == 6 || tile_w < 8 || tile_h < 1 || (tp != 64 && tp != 128) ||
      (bn != 32 && bn != 64 && !(EP::kBn16 && bn == 16)) || g.C < 1 ||
      g.KH < 1 || g.KW < 1 || g.sh < 1 || g.sw < 1 || g.dh < 1 ||
      g.dw < 1 || ck < 1 || ck > g.C || (ck == g.C && !resident) ||
      (mode == kIm2col && (resident != 0) != (ck == g.C)))
    return nullptr;
  if (mode == kSlab) {
    if (g.C % 32 != 0 || ck % 32 != 0 || g.C % ck != 0) return nullptr;
  } else if (mode != kIm2col) {
    return nullptr;
  }
  g.mode = mode;
  g.TH = tile_h;
  g.TW = tile_w;
  g.lg_tw = lg;
  g.BN = bn;
  g.CK = ck;
  g.resident = resident != 0;
  conv_layout(g, EP::kTableBytes);
  const ConvKernel<typename EP::Params> k =
      mode == kSlab ? pick<kSlab, EP>(tp / 64, bn / 16)
                    : pick<kIm2col, EP>(tp / 64, bn / 16);
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
  if (err == cudaSuccess)   // the most shared memory an SM can give blocks
    err = cudaFuncSetAttribute(k,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  return err == cudaSuccess ? k : nullptr;
}

void set_conv(ConvGeom& g, int C, int KH, int KW, int sh, int sw, int dh,
              int dw) {
  g.C = C;
  g.KH = KH;
  g.KW = KW;
  g.sh = sh;
  g.sw = sw;
  g.dh = dh;
  g.dw = dw;
}

inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

// The run geometry of a prepared g; the grid of its blocks.
dim3 set_run(ConvGeom& g, int batch, int H, int W, int O, int pt, int pl,
             int OH, int OW, int tiles_per_block, const void* x,
             const void* out) {
  g.H = H;
  g.W = W;
  g.O = O;
  g.pt = pt;
  g.pl = pl;
  g.OH = OH;
  g.OW = OW;
  g.vec_out = O % 16 == 0 && aligned16(out);
  g.vec_slab = g.mode == kIm2col && g.C % 16 == 0 && g.CK % 16 == 0 &&
               aligned16(x);
  g.ntw = (OW + g.TW - 1) / g.TW;
  g.tiles_img = (OH + g.TH - 1) / g.TH * g.ntw;
  g.tpb = tiles_per_block < g.tiles_img ? tiles_per_block : g.tiles_img;
  g.nchunk = (g.tiles_img + g.tpb - 1) / g.tpb;
  return dim3(static_cast<unsigned>(batch) * g.nchunk,
              static_cast<unsigned>((O + g.BN - 1) / g.BN));
}


}  // namespace
