// Fused int8 KxK conv at any square stride with the input slab of each
// output tile staged in shared memory through a two-slot cp.async ring,
// NHWC x OHWI -> NHWC:
// out[n, oy, ox, o] = epilogue(sum_{ky,kx,c} x[n, oy*s-pt+ky, ox*s-pl+kx, c]
//                                            * w[o, ky, kx, c])
// with zero padding outside the image and no residual.
//
// Replaces thingino_accel_tpu/ops/fused_kernels.py:conv2d_int8_folded with
// pipeline="dma" (Pallas body _halo_kernel_dma): one grid cell per (image,
// output-channel block) walks the image's row tiles and copies the halo'd
// input slab of tile t+1 into the other of two VMEM slots while tile t is
// computed. It computes what conv_int8_fused.cu (#2) computes; only the
// loads differ, so the two kernels are an A/B of the loads on this card.
//
// What bounds it on the H100: the stride-1 3x3 convs at 64..256 channels
// lean on the MAC rate (dp4a here, not the tensor cores); #2 gathers every
// im2col word from global memory, each input pixel K*K times through
// L1/L2. Design:
//   - A block owns (image, a run of `tpc` consecutive output tiles of that
//     image in row-major order, 64 output channels). A tile is TH x TW
//     output pixels (TH * TW <= 64, the rows of the dp4a tile); its slab is
//     ((TH-1)*s + KH) input rows x ((TW-1)*s + KW) columns x a chunk of CK
//     channels. A stage is one (tile, channel chunk); the block walks its
//     stages and, while it computes stage t, the copies of stage t+1 are in
//     flight into the other slot: issue t+1, commit, wait_group 1 (stage t
//     landed), __syncthreads, compute, __syncthreads (no warp still reads
//     the slot that iteration t+1 refills).
//   - Positions outside the image are zero: cp.async with a source size of
//     0 zero-fills the destination (no padded copy of the input).
//   - Loads: 16-byte copies when C % 16 == 0 (and CK % 16 == 0, the base
//     16-byte aligned), 4-byte copies when C % 4 == 0, and for other C (the
//     6x6/s2 stem on 3 channels) each slab row is copied as the aligned
//     4-byte words that cover its in-image run, with per-row offsets kept
//     beside the slot; the stage's im2col words are then gathered once from
//     the slab into a [64][K/4] tile (out-of-image bytes masked there).
//   - Weights: where they fit, the block's 64 x K weight tile is loaded
//     once and stays in shared memory across the tile loop, as the TPU
//     keeps w_ref's block in VMEM, and only the slab is chunked; otherwise
//     each stage streams its chunk's 64 x KH*KW*CK weights through the same
//     ring. Stored as
//     [K word][64 channels] with a pitch of 65 words: the 16 channels a
//     half-warp reads sit on 16 banks.
//   - The product is #2's: __dp4a into a 4x4 int32 sub-tile per thread,
//     then the shared epilogue (epilogue.cuh) and one int8 store.
// The host picks TH x TW, CK and the tiles per block
// (ops/fused_kernels.py:dma_plan) and lays out the shared memory
// (ops/fused_kernels.py:dma_layout, the one copy of the layout) and passes
// both in; shared memory above 48 KB in all (static + dynamic) is opted
// into per launch.
#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

#include "epilogue.cuh"

namespace {

constexpr int kBsPitch = tat::kBN + 1;   // words per K-word row of weights
constexpr int kRowInvalid = INT_MIN;     // byte path: slab row not copied

struct DmaGeom {
  int H, W, C, O, KH, KW, s, pt, pl, OH, OW;
  int K;                 // KH * KW * C
  int TH, TW;            // output tile
  int rows_in, cols_in;  // slab extent
  int CK, nck;           // channel chunk and chunks per tile
  int wres;              // weights resident (else streamed per stage)
  int CKp;               // word paths: slab bytes per pixel
  int RP;                // byte path: slab bytes per row
  int ntw, tiles_img, tpc, nchunk;
  int slot_bytes;        // bytes of one ring slot
  int rowadj_off;        // byte path: row table in a slot
  int wslot_off;         // streamed weights in a slot
  int res_off;           // resident weights
  int ktab_off;          // byte path: (ky, kx, kx*C + c) of each k
  int at_off;            // byte path: the stage's im2col tile
  int smem;              // dynamic shared memory in all
};

// --- cp.async: an asynchronous global -> shared copy that zero-fills the
// bytes past `src_bytes` (0 copies nothing and writes zeros). ------------
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int src_bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// every group but the newest has landed (this thread's copies)
__device__ __forceinline__ void cp_async_wait_prev() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}
// --- end of cp.async ------------------------------------------------------

template <int VW>
__device__ __forceinline__ void cp_async_vec(void* dst, const void* src,
                                             int src_bytes) {
  if (VW == 16)
    cp_async16(dst, src, src_bytes);
  else
    cp_async4(dst, src, src_bytes);
}

__device__ __forceinline__ void tile_origin(const DmaGeom& g, int tile,
                                            int& oy0, int& ox0) {
  const int trow = tile / g.ntw;
  oy0 = trow * g.TH;
  ox0 = (tile - trow * g.ntw) * g.TW;
}

// Word paths: the slab of (tile, chunk cc) into `slot` as [rows_in]
// [cols_in][CKp] bytes, and with several chunks the chunk's weights as
// [KH*KW*CK/4][kBsPitch] words.
template <int VW>
__device__ void issue_stage(const int8_t* __restrict__ x,
                            const int8_t* __restrict__ w, char* slot,
                            const DmaGeom& g, int n, int n0, int tile,
                            int cc) {
  int oy0, ox0;
  tile_origin(g, tile, oy0, ox0);
  const int iy0 = oy0 * g.s - g.pt, ix0 = ox0 * g.s - g.pl;
  const int c0 = cc * g.CK;
  const int upp = g.CK / VW;   // copies per pixel
  const int units = g.rows_in * g.cols_in * upp;
  const long long img = static_cast<long long>(n) * g.H;
  for (int u = threadIdx.x; u < units; u += tat::kThreads) {
    const int pix = u / upp, cu = u - pix * upp;
    const int r = pix / g.cols_in, col = pix - r * g.cols_in;
    const int iy = iy0 + r, ix = ix0 + col, c = c0 + cu * VW;
    const bool ok = iy >= 0 && iy < g.H && ix >= 0 && ix < g.W && c < g.C;
    const int8_t* src = ok ? x + ((img + iy) * g.W + ix) * g.C + c : x;
    cp_async_vec<VW>(slot + pix * g.CKp + cu * VW, src, ok ? VW : 0);
  }
  if (!g.wres) {
    int* bs = reinterpret_cast<int*>(slot + g.wslot_off);
    const int ckw = g.CK / 4, taps = g.KH * g.KW;
    const int words = taps * ckw * tat::kBN;
    for (int u = threadIdx.x; u < words; u += tat::kThreads) {
      const int q = u % ckw, rest = u / ckw;
      const int o = rest % tat::kBN, tap = rest / tat::kBN;
      const int c = c0 + 4 * q;
      const bool ok = n0 + o < g.O && c < g.C;
      const int8_t* src =
          ok ? w + (static_cast<long long>(n0 + o) * taps + tap) * g.C + c
             : w;
      cp_async4(bs + (tap * ckw + q) * kBsPitch + o, src, ok ? 4 : 0);
    }
  }
}

// Byte path (C % 4 != 0, one chunk): each slab row's in-image run
// x[n, iy, ixa:ixb, :] is contiguous; copy the aligned words that cover it.
// rowadj[r] maps (ix, c) of row r to slot byte rowadj[r] + ix*C + c.
__device__ void issue_stage_bytes(const int8_t* __restrict__ x, char* slot,
                                  const DmaGeom& g, int n, int tile) {
  int oy0, ox0;
  tile_origin(g, tile, oy0, ox0);
  const int iy0 = oy0 * g.s - g.pt, ix0 = ox0 * g.s - g.pl;
  const int ixa = max(ix0, 0), ixb = min(ix0 + g.cols_in, g.W);
  int* rowadj = reinterpret_cast<int*>(slot + g.rowadj_off);
  const int nw = g.RP / 4;
  for (int u = threadIdx.x; u < g.rows_in * nw; u += tat::kThreads) {
    const int r = u / nw, t = u - r * nw;
    const int iy = iy0 + r;
    const bool row_ok = iy >= 0 && iy < g.H && ixa < ixb;
    const long long ga =
        ((static_cast<long long>(n) * g.H + iy) * g.W + ixa) * g.C;
    if (t == 0)
      rowadj[r] = row_ok ? r * g.RP - ixa * g.C + static_cast<int>(ga & 3)
                         : kRowInvalid;
    if (!row_ok) continue;
    const long long gb = ga + static_cast<long long>(ixb - ixa) * g.C;
    const long long gw = (ga & ~3LL) + 4LL * t;
    if (gw >= gb) continue;
    cp_async4(slot + r * g.RP + 4 * t, x + gw,
              static_cast<int>(gb - gw < 4 ? gb - gw : 4));
  }
}

// acc += slab words x weight words over one stage (word paths): qn words
// a tap (fewer than CK/4 in a ragged last chunk). aoff[i]: the slab word of
// tap (0, 0) of the thread's pixel i; bs: the chunk's first weight row of
// tap (0, 0), tap_rows K-word rows on to the next tap.
__device__ __forceinline__ void product_words(const int* __restrict__ slab,
                                              const int* __restrict__ bs,
                                              int tap_rows, int qn,
                                              const DmaGeom& g,
                                              const int (&aoff)[4],
                                              int (&acc)[4][4]) {
  const int tx = threadIdx.x % 16;
  const int pw = g.CKp / 4;
  const int* bt = bs + tx;
  for (int ky = 0; ky < g.KH; ++ky) {
    for (int kx = 0; kx < g.KW; ++kx) {
      const int* at = slab + (ky * g.cols_in + kx) * pw;
#pragma unroll 4
      for (int q = 0; q < qn; ++q) {
        int a[4], b[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = at[aoff[i] + q];
#pragma unroll
        for (int j = 0; j < 4; ++j) b[j] = bt[q * kBsPitch + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            acc[i][j] = __dp4a(a[i], b[j], acc[i][j]);
      }
      bt += tap_rows * kBsPitch;
    }
  }
}

// Byte path: the stage's im2col tile, [64 pixels][K/4 words + 1], built
// from the slab through the row table (K in (ky, kx, c) order, 4 k a
// word), each word by one thread as #2 gathers it, so that the 16 threads
// sharing a pixel in the product read it and do not each gather it.
__device__ __forceinline__ void build_a_tile(const int8_t* __restrict__ slab,
                                             const int* __restrict__ rowadj,
                                             const int* __restrict__ ktab,
                                             int* __restrict__ at,
                                             const DmaGeom& g, int ix0) {
  const int kwords = (g.K + 3) / 4, pitch = kwords + 1;
  for (int u = threadIdx.x; u < tat::kBM * kwords; u += tat::kThreads) {
    const int p = u / kwords, q = u - p * kwords;
    unsigned word = 0;
    if (p < g.TH * g.TW) {
      const int py = p / g.TW, px = p - py * g.TW;
      const int prow = py * g.s, pcol = ix0 + px * g.s;
      for (int e = 0; e < 4; ++e) {
        const int k = 4 * q + e;
        if (k >= g.K) break;
        const int t = ktab[k];
        const int ky = t & 0xff, kx = (t >> 8) & 0xff, kxc = t >> 16;
        const int adj = rowadj[prow + ky];
        const int ix = pcol + kx;
        if (adj == kRowInvalid || ix < 0 || ix >= g.W) continue;
        const int8_t v = slab[adj + pcol * g.C + kxc];
        word |= static_cast<unsigned>(static_cast<uint8_t>(v)) << (8 * e);
      }
    }
    at[p * pitch + q] = static_cast<int>(word);
  }
}

// acc += the im2col tile x the resident weights (byte path).
__device__ __forceinline__ void product_a_tile(const int* __restrict__ at,
                                               const int* __restrict__ bs,
                                               const DmaGeom& g,
                                               int (&acc)[4][4]) {
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int kwords = (g.K + 3) / 4, pitch = kwords + 1;
  for (int q = 0; q < kwords; ++q) {
    int a[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = at[(ty + 16 * i) * pitch + q];
#pragma unroll
    for (int j = 0; j < 4; ++j) b[j] = bs[q * kBsPitch + tx + 16 * j];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = __dp4a(a[i], b[j], acc[i][j]);
  }
}

// The epilogue over the thread's 4x4 sub-tile of one output tile and the
// one int8 write into NHWC [N, OH, OW, O], masked at the ragged edges.
__device__ __forceinline__ void store_tile(
    int (&acc)[4][4], const DmaGeom& g, int n, int n0, int oy0, int ox0,
    const int (&py)[4], const int (&px)[4], const bool (&pv)[4],
    const int* __restrict__ bias, const float* __restrict__ cs, int act,
    float inv_out, float alpha, int8_t* __restrict__ out) {
  const int tx = threadIdx.x % 16;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int o = n0 + tx + 16 * j;
    if (o >= g.O) continue;
    const int b = bias != nullptr ? bias[o] : 0;
    const float c = cs[o];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int oy = oy0 + py[i], ox = ox0 + px[i];
      if (!pv[i] || oy >= g.OH || ox >= g.OW) continue;
      out[((static_cast<long long>(n) * g.OH + oy) * g.OW + ox) * g.O + o] =
          tat::epilogue(acc[i][j], b, c, act, inv_out, alpha);
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0;
}

// VW: bytes per copy, 16 or 4 (word paths) or 1 (byte path).
template <int VW>
__global__ void __launch_bounds__(tat::kThreads)
    conv_int8_dma_kernel(const int8_t* __restrict__ x,
                         const int8_t* __restrict__ w,
                         const int* __restrict__ bias,
                         const float* __restrict__ cs,
                         int8_t* __restrict__ out, DmaGeom g, int act,
                         float inv_out, float alpha, int wvec) {
  extern __shared__ __align__(16) char smem[];
  const int n = blockIdx.x / g.nchunk;
  const int t0 = (blockIdx.x - n * g.nchunk) * g.tpc;
  const int t1 = min(t0 + g.tpc, g.tiles_img);
  const int n0 = blockIdx.y * tat::kBN;
  const int stages = (t1 - t0) * g.nck;

  // the first stage's copies go out before anything else
  if (VW == 1)
    issue_stage_bytes(x, smem, g, n, t0);
  else
    issue_stage<VW>(x, w, smem, g, n, n0, t0, 0);
  cp_async_commit();

  // resident weights: [K word][kBsPitch], loaded once
  int* res_bs = reinterpret_cast<int*>(smem + g.res_off);
  if (g.wres) {
    const int kwords = (g.K + 3) / 4;
    for (int u = threadIdx.x; u < kwords * tat::kBN; u += tat::kThreads) {
      const int q = u % kwords, o = u / kwords;
      res_bs[q * kBsPitch + o] =
          wvec ? tat::load_row_word<true>(w, n0 + o, g.O, g.K, g.K, 4 * q)
               : tat::load_row_word<false>(w, n0 + o, g.O, g.K, g.K, 4 * q);
    }
  }
  int* ktab = reinterpret_cast<int*>(smem + g.ktab_off);
  if (VW == 1) {
    for (int k = threadIdx.x; k < g.K; k += tat::kThreads) {
      const int tap = k / g.C, c = k - tap * g.C;
      const int ky = tap / g.KW, kx = tap - ky * g.KW;
      ktab[k] = ky | (kx << 8) | ((kx * g.C + c) << 16);
    }
  }

  // the thread's 4 pixels of a tile (rows ty + 16i of the dp4a tile)
  const int ty = threadIdx.x / 16;
  int py[4], px[4], aoff[4];
  bool pv[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int p = ty + 16 * i;
    pv[i] = p < g.TH * g.TW;
    py[i] = pv[i] ? p / g.TW : 0;
    px[i] = pv[i] ? p - py[i] * g.TW : 0;
    aoff[i] = (py[i] * g.s * g.cols_in + px[i] * g.s) * (g.CKp / 4);
  }

  int acc[4][4] = {};
  for (int st = 0; st < stages; ++st) {
    const int tile = t0 + st / g.nck, cc = st - (st / g.nck) * g.nck;
    if (st + 1 < stages) {
      const int nt = t0 + (st + 1) / g.nck, ncc = (st + 1) % g.nck;
      char* nxt = smem + ((st + 1) & 1) * g.slot_bytes;
      if (VW == 1)
        issue_stage_bytes(x, nxt, g, n, nt);
      else
        issue_stage<VW>(x, w, nxt, g, n, n0, nt, ncc);
    }
    cp_async_commit();   // an empty group on the last stage keeps the count
    cp_async_wait_prev();
    __syncthreads();

    const char* slot = smem + (st & 1) * g.slot_bytes;
    int oy0, ox0;
    tile_origin(g, tile, oy0, ox0);
    if (VW == 1) {
      int* at = reinterpret_cast<int*>(smem + g.at_off);
      build_a_tile(reinterpret_cast<const int8_t*>(slot),
                   reinterpret_cast<const int*>(slot + g.rowadj_off), ktab,
                   at, g, ox0 * g.s - g.pl);
      __syncthreads();
      product_a_tile(at, res_bs, g, acc);
    } else {
      const int c0 = cc * g.CK;
      const int qn = min(g.CK, g.C - c0) / 4;
      if (g.wres)
        product_words(reinterpret_cast<const int*>(slot),
                      res_bs + (c0 / 4) * kBsPitch, g.C / 4, qn, g, aoff,
                      acc);
      else
        product_words(reinterpret_cast<const int*>(slot),
                      reinterpret_cast<const int*>(slot + g.wslot_off),
                      g.CK / 4, qn, g, aoff, acc);
    }
    if (cc == g.nck - 1)
      store_tile(acc, g, n, n0, oy0, ox0, py, px, pv, bias, cs, act, inv_out,
                 alpha, out);
    __syncthreads();   // the slot the next iteration refills is read out
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

template <int VW>
int launch(const DmaGeom& g, dim3 grid, cudaStream_t s, const int8_t* x,
           const int8_t* w, const int* bias, const float* cs, int8_t* out,
           int act, float inv_out, float alpha, int wvec) {
  auto* kernel = conv_int8_dma_kernel<VW>;
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  int dev = 0, max_smem = 0;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&max_smem,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long total = static_cast<long long>(attr.sharedSizeBytes) + g.smem;
  if (total > max_smem) return static_cast<int>(cudaErrorInvalidValue);
  if (total > 48 * 1024) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, g.smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<grid, tat::kThreads, g.smem, s>>>(x, w, bias, cs, out, g, act,
                                             inv_out, alpha, wvec);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// tile_h x tile_w output pixels a tile (<= 64), ck channels a chunk,
// the weights resident or streamed with each chunk, tiles_per_block
// consecutive tiles of one image a block; then the shared-memory layout
// (vw, the slab's pixel and row pitch, the offsets and the total, as
// ops/fused_kernels.py:dma_layout computes them). Returns a cudaError_t;
// cudaErrorInvalidValue for a plan or layout the kernel cannot run.
extern "C" int tat_conv_int8_dma(
    const void* x, const void* w, const void* bias, const void* cs, void* out,
    int batch, int H, int W, int C, int O, int KH, int KW, int stride, int pt,
    int pl, int OH, int OW, int act, float inv_out, float alpha, int tile_h,
    int tile_w, int ck, int resident, int tiles_per_block, int vw,
    int pix_bytes, int row_bytes, int rowadj_off, int wslot_off,
    int slot_bytes, int res_off, int ktab_off, int at_off, int smem,
    void* stream) {
  const int bad = static_cast<int>(cudaErrorInvalidValue);
  if (tile_h < 1 || tile_w < 1 || tile_h * tile_w > tat::kBM || ck < 1 ||
      ck > C || tiles_per_block < 1 || stride < 1 ||
      !tat::aligned4(x) || !tat::aligned4(w))
    return bad;
  const int nck = (C + ck - 1) / ck;
  // the copy width must suit C, the chunk and the input's alignment, and
  // the layout must keep every copy's destination aligned to its width
  const bool word_ok = (vw == 16 || vw == 4) && C % vw == 0 &&
                       ck % vw == 0 && pix_bytes >= ck &&
                       pix_bytes % vw == 0 && (vw == 4 || aligned16(x));
  const bool byte_ok = vw == 1 && nck == 1 && resident && KH <= 255 &&
                       KW <= 255 && KW * C < 32768;
  if (!(word_ok || byte_ok) || slot_bytes % 16 || wslot_off % 4 ||
      res_off % 16 || ktab_off % 4 || at_off % 4 || rowadj_off % 4)
    return bad;
  DmaGeom g = {};
  g.H = H;
  g.W = W;
  g.C = C;
  g.O = O;
  g.KH = KH;
  g.KW = KW;
  g.s = stride;
  g.pt = pt;
  g.pl = pl;
  g.OH = OH;
  g.OW = OW;
  g.K = KH * KW * C;
  g.TH = tile_h;
  g.TW = tile_w;
  g.rows_in = (tile_h - 1) * stride + KH;
  g.cols_in = (tile_w - 1) * stride + KW;
  g.CK = ck;
  g.nck = nck;
  g.wres = resident;
  g.CKp = pix_bytes;
  g.RP = row_bytes;
  g.rowadj_off = rowadj_off;
  g.wslot_off = wslot_off;
  g.slot_bytes = slot_bytes;
  g.res_off = res_off;
  g.ktab_off = ktab_off;
  g.at_off = at_off;
  g.smem = smem;
  g.ntw = (OW + tile_w - 1) / tile_w;
  g.tiles_img = (OH + tile_h - 1) / tile_h * g.ntw;
  g.tpc = tiles_per_block;
  g.nchunk = (g.tiles_img + g.tpc - 1) / g.tpc;
  const dim3 grid(static_cast<unsigned>(batch * g.nchunk),
                  static_cast<unsigned>((O + tat::kBN - 1) / tat::kBN));
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* xp = static_cast<const int8_t*>(x);
  const auto* wp = static_cast<const int8_t*>(w);
  const auto* bp = static_cast<const int*>(bias);
  const auto* cp = static_cast<const float*>(cs);
  auto* op = static_cast<int8_t*>(out);
  const int wvec = g.K % 4 == 0;   // w is 4-byte aligned (checked above)
  if (vw == 16)
    return launch<16>(g, grid, s, xp, wp, bp, cp, op, act, inv_out, alpha,
                      wvec);
  if (vw == 4)
    return launch<4>(g, grid, s, xp, wp, bp, cp, op, act, inv_out, alpha,
                     wvec);
  return launch<1>(g, grid, s, xp, wp, bp, cp, op, act, inv_out, alpha, wvec);
}
