// The exact tier's KxK int8 convs on the tensor cores: an NHWC x OHWI
// implicit-GEMM conv at any stride (sh, sw), dilation (dh, dw) and top /
// left pads, ending in requant_exact (epilogue.cuh: one per-tensor
// combined scale, either RoundMode, the clamp, then RELU on the quantized
// value):
//   out[n, oy, ox, o] = requant_exact(sum_{ky,kx,c}
//       x[n, oy sh - pt + ky dh, ox sw - pl + kx dw, c] * w[o, ky, kx, c]
//       + bias[o])
// with zeros outside the image and exact int32 sums.
//
// Replaces thingino_accel_tpu/ops/pallas_kernels.py:
// - conv2d_int8_halo (:216, body _halo_kernel), kernel #10, stride and
//   dilation 1;
// - conv2d_int8 (:300) through _tapconv_call (:388, body _tapconv_kernel),
//   kernel #11, anything else. On the TPU #11 writes the KH KW shifted,
//   strided copies of the input to HBM and walks the taps as a grid axis;
//   here a tap is a shifted window of a slab in shared memory, so those
//   copies never exist. It computes what #11 computes, not how.
//
// What bounds them on the H100 (int8 operations over 1,979 TOP/s against
// bytes over 3.35 TB/s, the exact zoo yolov5s at batch 16): the 6x6/s2
// stem (C = 3, 1.1e10 operations, 72 MB) and the wide-image 3x3 convs
// (C <= 64) move bytes; the 3x3 convs from C = 128 on lean on the
// operations (1.5e10 each at stride 2, 7.6e9 at stride 1).
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
//     epilogue, so their latency is hidden. BN follows O: 32 for the stem,
//     so no half-empty tile remains.
// Epilogue: requant_exact on the C fragments in registers (lane (g, t)
// holds rows g and g + 8 of an m16 tile, columns 2t and 2t + 1 of an n8
// tile), the int8 tile staged in shared memory at BN + 16 bytes a pixel,
// then written 16 bytes a thread along each pixel's BN bytes (bytes at a
// ragged O or an unaligned output), the ragged edges masked.
//
// How this answers the dp4a kernel it replaces: (1) the product is on the
// tensor cores; (2) copies overlap compute through the ring (slab mode);
// (3) each input pixel is fetched once a tile into the slab, not KH KW
// times, and the im2col rows are copied as runs or through a table, not
// with two divisions a word; (4) the stem's 3-channel gather reads
// contiguous slab rows, and its 32 output channels fill its 32-wide block.
//
// Shared memory (conv_layout, mirrored by ops/requant_kernels.py
// conv_requant_smem), all dynamic, no static bytes: slab mode two stages
// (the slab, then the chunk's weights unless resident), the resident
// weights, the output tile; im2col mode the slab, the A tile, the weights,
// three k tables and the output tile. Every pitch of an ldmatrix operand is
// an odd multiple of 16 bytes, so the 8 rows of an ldmatrix at stride 1
// fall on distinct bank groups (at stride 2 two rows share one).
//
// Built with -DTAT_CONV_REQUANT_NO_STORE the epilogue stores nothing (the
// sums are folded into one value that is kept live), with
// -DTAT_CONV_REQUANT_NO_PRODUCT no ldmatrix or mma.sync runs: variants
// compiled only to measure the shares of the epilogue and the product; no
// wrapper loads them.
#include <cstdint>

#include <cuda_runtime.h>

#include "epilogue.cuh"
#include "mma_tile.cuh"

namespace {

constexpr int kThreads = 256;    // 8 warps: 4 along the pixels, 2 along BN
constexpr int kPrefetch = 12;    // im2col: slab bytes a thread prefetches
constexpr int kOutPad = 16;      // bytes after each staged output pixel
// measurement variants, compiled only by chip_smoke.py: no epilogue
// stores, no product (ldmatrix and mma.sync)
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
  int ntw, tiles_img, tpb, nchunk;
  int slab_bytes, stage_bytes, a_off, w_off, ktab_off, out_off, smem;
  FastDiv by_row, by_ck, by_words, by_kc;   // im2col's index divisions
  // im2col with dw == 1: a pixel's A row is KH runs of KW CK slab bytes,
  // copied run_unit (1 or 2) bytes a step by fixed threads, run_units
  // steps a pixel (0: no run copy, the k table builds the row)
  int run_unit, run_units;
};

constexpr int round_up(int v, int m) { return (v + m - 1) / m * m; }

// The shared-memory layout of one block (ops/requant_kernels.py
// conv_requant_smem mirrors the total); g.resident set by the plan.
void conv_layout(ConvGeom& g) {
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
    const int run = g.KW * g.CK;
    g.run_unit = run % 2 == 0 && g.sw * g.CK % 2 == 0 && g.SW * g.CK % 2 == 0
                     ? 2 : 1;
    g.run_units = g.KH * run / g.run_unit;
    if (g.dw != 1 || g.run_units > kThreads) g.run_units = 0;
  }
  g.smem = g.out_off + tp * (g.BN + kOutPad);
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

// The A tile by runs (g.run_units > 0): thread t copies step t %
// run_units of every (kThreads / run_units)-th pixel from t / run_units
// on. The K padding of the rows is left as it is: the weights' padding is
// zero.
template <int TP>
__device__ void build_a_runs(const unsigned char* slab, unsigned char* a,
                             const ConvGeom& g) {
  const int groups = kThreads / g.run_units;
  if (threadIdx.x >= groups * g.run_units) return;
  const int q = threadIdx.x % g.run_units;
  const int per_ky = g.KW * g.CK / g.run_unit;
  const int ky = q / per_ky, j = (q - ky * per_ky) * g.run_unit;
  const int soff = ky * g.dh * g.SW * g.CK + j;   // in the pixel's window
  const int aoff = ky * g.KW * g.CK + j;          // in the A row
  for (int p = threadIdx.x / g.run_units; p < TP; p += groups) {
    const unsigned char* src =
        slab + ((p >> g.lg_tw) * g.sh * g.SW + (p & (g.TW - 1)) * g.sw) *
                   g.CK + soff;
    unsigned char* dst = a + p * g.wpitch + aoff;
    if (g.run_unit == 2)
      *reinterpret_cast<uint16_t*>(dst) =
          *reinterpret_cast<const uint16_t*>(src);
    else
      *dst = *src;
  }
}

// --- the product ---------------------------------------------------------

// One 32-byte K step: acc += A (MI m16 tiles, rows at `at` + aoff) x B (NI
// n8 tiles, the lane's row at `bt`, tiles 16 rows apart in pairs).
template <int MI, int NI>
__device__ __forceinline__ void mma_k32(int (&acc)[MI][NI][4],
                                        const unsigned char* at,
                                        const int (&aoff)[MI],
                                        const unsigned char* bt, int wpitch) {
  unsigned bfr[NI][2];
#pragma unroll
  for (int j = 0; j < NI / 2; ++j) {
    unsigned r[4];
    tat::ldsm_x4(r, bt + j * 16 * wpitch);
    bfr[2 * j][0] = r[0];
    bfr[2 * j][1] = r[1];
    bfr[2 * j + 1][0] = r[2];
    bfr[2 * j + 1][1] = r[3];
  }
#pragma unroll
  for (int mi = 0; mi < MI; ++mi) {
    unsigned afr[4];
    tat::ldsm_x4(afr, at + aoff[mi]);
#pragma unroll
    for (int ni = 0; ni < NI; ++ni) tat::mma_s8(acc[mi][ni], afr, bfr[ni]);
  }
}

// --- the epilogue --------------------------------------------------------

// requant_exact on the fragments into the staged int8 tile (TP pixels at
// BN + kOutPad bytes), then each pixel's channels out, 16 bytes a thread.
template <int MI, int NI>
__device__ void store_tile(const int (&acc)[MI][NI][4],
                           const int (&eb)[NI][2], const ConvGeom& g,
                           unsigned char* staged, int n, int tile, int n0,
                           float cs, int round_mode, bool relu,
                           int8_t* __restrict__ out) {
  constexpr int BN = 16 * NI, TP = 64 * MI, kPitch = BN + kOutPad;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp & 3, wn = warp >> 2;
  const int gq = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = (wm * MI + mi) * 16 + gq + 8 * h;
#pragma unroll
      for (int ni = 0; ni < NI; ++ni) {
        const int col = wn * 8 * NI + ni * 8 + 2 * tq;
        const unsigned q0 = static_cast<uint8_t>(tat::requant_exact(
            acc[mi][ni][2 * h], eb[ni][0], cs, round_mode, relu));
        const unsigned q1 = static_cast<uint8_t>(tat::requant_exact(
            acc[mi][ni][2 * h + 1], eb[ni][1], cs, round_mode, relu));
        *reinterpret_cast<uint16_t*>(staged + row * kPitch + col) =
            static_cast<uint16_t>(q0 | q1 << 8);
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
    } else {
      const int m = live - c < 16 ? live - c : 16;
      for (int b = 0; b < m; ++b) dst[b] = static_cast<int8_t>(src[b]);
    }
  }
}

// The no-store variant's epilogue: the sums folded into one value that is
// stored only if it takes one given value, so the product is kept.
template <int MI, int NI>
__device__ __forceinline__ void sink_tile(const int (&acc)[MI][NI][4],
                                          int8_t* __restrict__ out) {
  int f = 0;
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int ni = 0; ni < NI; ++ni)
#pragma unroll
      for (int r = 0; r < 4; ++r) f ^= acc[mi][ni][r] * (r + 1);
  if (f == 0x5a5a5a5a) out[0] = 1;
}

// --- the kernel ------------------------------------------------------------

template <int MODE, int MI, int NI>
__global__ void __launch_bounds__(kThreads, min_blocks(MODE))
    conv_requant_mma_kernel(const int8_t* __restrict__ x,
                            const int8_t* __restrict__ w,
                            const int* __restrict__ bias,
                            int8_t* __restrict__ out, ConvGeom g, float cs,
                            int round_mode, bool relu) {
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
  // the lane's channels' bias
  int eb[NI][2];
#pragma unroll
  for (int ni = 0; ni < NI; ++ni)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int o = n0 + wn * 8 * NI + ni * 8 + 2 * tq + e;
      eb[ni][e] = o < g.O && bias != nullptr ? bias[o] : 0;
    }
  unsigned char* staged = smem + g.out_off;

  int acc[MI][NI][4];
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
      int tap = 0;
      for (int ky = 0; ky < g.KH; ++ky) {
        const unsigned char* arow = slot + ky * g.dh * g.SW * g.pitch;
        for (int kx = 0; kx < g.KW; ++kx, ++tap) {
          const unsigned char* at = arow + kx * g.dw * g.pitch;
          const unsigned char* bt = wl + tap * wtap;
          for (int kb = 0; kb < g.CK; kb += tat::kMmaStepBytes)
            if constexpr (kProduct)
              mma_k32<MI, NI>(acc, at + kb, aoff, bt + kb, g.wpitch);
        }
      }
      __syncthreads();   // slot s & 1 is read: the next stage refills it
      if (++chunk == g.nck) {
        if constexpr (kStore)
          store_tile<MI, NI>(acc, eb, g, staged, n, tile, n0, cs, round_mode,
                             relu, out);
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
    const bool prefetch = g.SH * g.SW * g.CK <= kPrefetch * kThreads;
    unsigned char pv[kPrefetch];
    if (prefetch) fetch_slab(x, g, n, t0, 0, tid, pv);
    int tile = t0, chunk = 0;
    for (int s = 0; s < stages; ++s) {
      __syncthreads();   // the last stage's slab, A and B are read
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
      if (!g.resident || s == 0)
        load_weights_bytes(w, b, g, ktw, ktc, n0, chunk * g.CK);
      __syncthreads();
      if (g.run_units > 0)
        build_a_runs<TP>(slab, a, g);
      else
        build_a<TP>(slab, a, g, ktx);
      __syncthreads();
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
          store_tile<MI, NI>(acc, eb, g, staged, n, tile, n0, cs, round_mode,
                             relu, out);
        else
          sink_tile<MI, NI>(acc, out);
        chunk = 0;
        ++tile;
      }
    }
  }
}

using ConvKernel = void (*)(const int8_t*, const int8_t*, const int*, int8_t*,
                            ConvGeom, float, int, bool);

template <int MODE>
ConvKernel pick(int mi, int ni) {
  if (mi == 1 && ni == 2) return conv_requant_mma_kernel<MODE, 1, 2>;
  if (mi == 1 && ni == 4) return conv_requant_mma_kernel<MODE, 1, 4>;
  if (mi == 2 && ni == 2) return conv_requant_mma_kernel<MODE, 2, 2>;
  if (mi == 2 && ni == 4) return conv_requant_mma_kernel<MODE, 2, 4>;
  return nullptr;
}

// The kernel of a plan and its layout in g (whose C, KH, KW, sh, sw, dh,
// dw are set), or null for a plan the kernel cannot run; opts the kernel
// into its shared memory.
ConvKernel prepare(int mode, int tile_h, int tile_w, int bn, int ck,
                   int resident, ConvGeom& g, cudaError_t& err) {
  err = cudaErrorInvalidValue;
  int lg = 0;
  while (lg < 6 && (1 << lg) != tile_w) ++lg;
  const int tp = tile_h * tile_w;
  if (lg == 6 || tile_w < 8 || tile_h < 1 || (tp != 64 && tp != 128) ||
      (bn != 32 && bn != 64) || g.C < 1 || g.KH < 1 || g.KW < 1 ||
      g.sh < 1 || g.sw < 1 || g.dh < 1 || g.dw < 1 || ck < 1 || ck > g.C ||
      (ck == g.C && !resident) ||
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
  conv_layout(g);
  const ConvKernel k =
      mode == kSlab ? pick<kSlab>(tp / 64, bn / 16) : pick<kIm2col>(tp / 64,
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

}  // namespace

// One launch: x NHWC [batch, H, W, C] and w OHWI [O, KH, KW, C] int8, bias
// [O] int32 or null, out NHWC [batch, OH, OW, O] int8; the conv's stride
// (sh, sw), dilation (dh, dw), top and left pads; requant_exact's cs,
// round_mode (RoundMode) and relu. The plan: mode 0 slab (C % 32 == 0, x
// and w 16-byte aligned, ck a multiple of 32 dividing C) or 1 im2col (any
// ck <= C); tile_h x tile_w output pixels a tile (64 or 128 of them,
// tile_w 8, 16 or 32), bn output channels a block (32 or 64), ck input
// channels a chunk, resident (the weights of all C loaded once a block:
// required when ck == C, and im2col mode takes it only then),
// tiles_per_block consecutive tiles of one image a block. Returns a cudaError_t; cudaErrorInvalidValue for a shape or plan
// it cannot run.
extern "C" int tat_conv_int8_requant_mma(
    const void* x, const void* w, const void* bias, void* out, int batch,
    int H, int W, int C, int O, int KH, int KW, int sh, int sw, int dh,
    int dw, int pt, int pl, int OH, int OW, float cs, int round_mode,
    int relu, int mode, int tile_h, int tile_w, int bn, int ck, int resident,
    int tiles_per_block, void* stream) {
  const bool aligned16 =
      ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(w)) &
       15u) == 0;
  if (batch < 1 || H < 1 || W < 1 || O < 1 || OH < 1 || OW < 1 ||
      tiles_per_block < 1 || (mode == kSlab && !aligned16))
    return static_cast<int>(cudaErrorInvalidValue);
  ConvGeom g = {};
  set_conv(g, C, KH, KW, sh, sw, dh, dw);
  cudaError_t err;
  const ConvKernel k =
      prepare(mode, tile_h, tile_w, bn, ck, resident, g, err);
  if (k == nullptr) return static_cast<int>(err);
  g.H = H;
  g.W = W;
  g.O = O;
  g.pt = pt;
  g.pl = pl;
  g.OH = OH;
  g.OW = OW;
  g.vec_out = O % 16 == 0 && (reinterpret_cast<uintptr_t>(out) & 15u) == 0;
  g.ntw = (OW + tile_w - 1) / tile_w;
  g.tiles_img = (OH + tile_h - 1) / tile_h * g.ntw;
  g.tpb = tiles_per_block < g.tiles_img ? tiles_per_block : g.tiles_img;
  g.nchunk = (g.tiles_img + g.tpb - 1) / g.tpb;
  const dim3 grid(static_cast<unsigned>(batch) * g.nchunk,
                  static_cast<unsigned>((O + bn - 1) / bn));
  k<<<grid, kThreads, static_cast<size_t>(g.smem),
      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(x), static_cast<const int8_t*>(w),
      static_cast<const int*>(bias), static_cast<int8_t*>(out), g, cs,
      round_mode, relu != 0);
  return static_cast<int>(cudaGetLastError());
}

// The dynamic shared memory of a plan in bytes (the kernel has no static
// shared memory) and the blocks of it an SM holds at once
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor); cudaErrorInvalidValue
// for a plan the kernel cannot run.
extern "C" int tat_conv_int8_requant_mma_info(
    int mode, int C, int KH, int KW, int sh, int sw, int dh, int dw,
    int tile_h, int tile_w, int bn, int ck, int resident, int* smem,
    int* blocks_per_sm) {
  ConvGeom g = {};
  set_conv(g, C, KH, KW, sh, sw, dh, dw);
  cudaError_t err;
  const ConvKernel k =
      prepare(mode, tile_h, tile_w, bn, ck, resident, g, err);
  if (k == nullptr) return static_cast<int>(err);
  *smem = g.smem;
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, k, kThreads, static_cast<size_t>(g.smem)));
}
