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
//                       RELU) between them: chain_mma.cuh's row chain.
//   tat_megakernel_3x3  the valid-shrink 3x3 kinds on (cells, H + 2L,
//                       H + 2L, K) tiles: stage i maps extent e = H +
//                       2(L - i) to e - 2, as 9 shifted-window products of
//                       [pixels, K] x [K, K]; the C3 round runs a 1x1 over
//                       the whole extent, requantizes it (SILU), then the
//                       taps, and adds the residual x[1:e-1, 1:e-1] at
//                       res_scale 0.5 in the SILU epilogue.
//
// What bounds it on the H100: its K loop of ldmatrix and mma.sync (9 k^2
// operations a pixel, the block's m16 tiles spread over 8 warps), then the
// weight copies. A cell is 40 x 40 x K bytes, 400 KB at K = 256, and a
// block has 227 KB of shared memory, so a block takes a th x tw sub-tile
// of the cell's H x H output and holds its (th + 2L) x (tw + 2L) input
// region: the halo is computed again by each neighbour (the probe module
// reports the operations issued beside the probe's own count). The
// region's stages take turns in two buffers (the C3 round's requantized
// 1x1 output in a third); no activation leaves shared memory between
// stages. The weights stay in L2 and stream one tap of one N-chunk a step
// through a cp.async ring of kSlots slots, so a slab has two steps to
// land; the accumulators of a chunk stay in registers across its 9 taps.
// The products are mma.sync tiles, whose rows are read through per-lane
// ldmatrix addresses, so a tap's shifted window needs no copy: each lane
// works its row's address out once a step, outside the K loop.
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "chain_mma.cuh"

namespace {

enum SpatialKind : int { kShift3 = 0, kRequant3 = 1, kBf16Taps = 2, kC3 = 3 };

constexpr int kSlots = 3;   // weight slabs in flight (ops/probe_kernels.py)

struct SpatialArgs {
  const unsigned char* x;    // [cells][H + 2L][H + 2L][row_bytes]
  const unsigned char* w1;   // C3: [L][K][row_bytes] (output column rows)
  const unsigned char* w3;   // [L][9][K][row_bytes], tap = 3 dy + dx
  unsigned char* out;        // [cells][H][H][row_bytes]
  const float* cs;           // [K]
  int cells, H, L, K;
  int th, tw, bn;            // sub-tile, output columns a weight slab
  int row_bytes, pitch;      // a pixel's bytes; its smem pitch (+ pad)
  int act;
  float inv_out, alpha, res_scale;
  int off_b, off_m, off_w;   // smem: buffer B, the C3 1x1 output, slots
};

// MT: m16 tiles a warp at most; NI: the chunk's n8 tiles (bn / 8). Both are
// compile-time so that the K loop is straight-line code: its fragment loads
// and products schedule together, which branches around them prevent.
template <int KIND, int MT, int NI>
__global__ void __launch_bounds__(tat::kChainThreads)
    spatial_chain_kernel(SpatialArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr bool kC3Round = KIND == kC3;
  constexpr int T = KIND == kBf16Taps ? tat::kMmaBf16 : tat::kMmaS8;
  constexpr int E = KIND == kBf16Taps ? 2 : 1;
  using Acc = typename tat::MmaAcc<T>::type;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, q = lane & 3;
  const int pitch = a.pitch;
  // region buffer i at smem + (i & 1) * off_b, weight slot t at
  // ws0 + (t % kSlots) * wbytes (offsets, not pointer arrays: no local
  // memory)
  unsigned char* const mbuf = smem + a.off_m;
  unsigned char* const ws0 = smem + a.off_w;
  const int wbytes = a.bn * pitch;
  const int tiles_x = a.H / a.tw, tiles = (a.H / a.th) * tiles_x;
  const int cell = blockIdx.x / tiles, tile = blockIdx.x - cell * tiles;
  const int oy0 = (tile / tiles_x) * a.th, ox0 = (tile % tiles_x) * a.tw;
  const int e0 = a.H + 2 * a.L;
  const int eh0 = a.th + 2 * a.L, ew0 = a.tw + 2 * a.L;
  const int xpr = a.row_bytes / 16;

  // the stage-0 input region (always inside the cell)
  for (int i = tid; i < eh0 * ew0 * xpr; i += blockDim.x) {
    const int p = i / xpr, c = i - p * xpr;
    const int py = p / ew0, px = p - py * ew0;
    const unsigned char* src =
        a.x + ((static_cast<long long>(cell) * e0 + oy0 + py) * e0 + ox0 +
               px) * a.row_bytes + 16 * c;
    tat::cp_async16(smem + p * pitch + 16 * c, src, 16);
  }
  // steps: per stage [C3: the 1x1's chunks] then chunk x 9 taps
  const int nchunks = a.K / a.bn;
  const int n1 = kC3Round ? nchunks : 0, per = n1 + 9 * nchunks;
  const int steps = a.L * per;
  auto decode = [&](int t, int& stage, bool& one, int& chunk, int& tap) {
    stage = t / per;
    int r = t - stage * per;
    one = r < n1;
    if (one) {
      chunk = r;
      tap = 0;
    } else {
      r -= n1;
      chunk = r / 9;
      tap = r - 9 * chunk;
    }
  };
  auto issue = [&](int t) {
    int stage, chunk, tap;
    bool one;
    decode(t, stage, one, chunk, tap);
    const unsigned char* src =
        one ? a.w1 + (static_cast<long long>(stage) * a.K + chunk * a.bn) *
                         a.row_bytes
            : a.w3 + ((static_cast<long long>(stage) * 9 + tap) * a.K +
                      chunk * a.bn) * a.row_bytes;
    for (int i = tid; i < a.bn * xpr; i += blockDim.x) {
      const int r = i / xpr, c = i - r * xpr;
      tat::cp_async16(ws0 + (t % kSlots) * wbytes + r * pitch + 16 * c,
                      src + static_cast<long long>(r) * a.row_bytes + 16 * c,
                      16);
    }
  };
  for (int t = 0; t < kSlots - 1; ++t) {   // the region joins group 0
    if (t < steps) issue(t);
    tat::cp_async_commit();
  }

  const int ksteps = a.row_bytes / tat::kMmaStepBytes;
  Acc acc[MT][NI][4];
  for (int t = 0; t < steps; ++t) {
    // slot (t - 1) % kSlots was last read in step t - 1, before its
    // closing barrier
    if (t + kSlots - 1 < steps) issue(t + kSlots - 1);
    tat::cp_async_commit();   // empty near the end: keeps the count
    tat::cp_async_wait<kSlots - 1>();
    __syncthreads();
    int stage, chunk, tap;
    bool one;
    decode(t, stage, one, chunk, tap);
    const int eh = a.th + 2 * (a.L - stage), ew = a.tw + 2 * (a.L - stage);
    const unsigned char* xin = smem + (stage & 1) * a.off_b;
    unsigned char* xout = smem + ((stage + 1) & 1) * a.off_b;
    const unsigned char* src = (kC3Round && !one) ? mbuf : xin;
    const int ow = one ? ew : ew - 2;
    const int rows = one ? eh * ew : (eh - 2) * (ew - 2);
    const int shift = one ? 0 : (tap / 3) * ew + tap % 3;
    // the warp's m16 tiles this step: tiles warp, warp + 8, ... below rows
    const int mtiles = (rows + 15) / 16;
    const int mine = mtiles > warp ? (mtiles - warp + 7) / 8 : 0;
    const int jn = mine < MT ? mine : MT;
    if (one || tap == 0) {
#pragma unroll
      for (int j = 0; j < MT; ++j)
#pragma unroll
        for (int ni = 0; ni < NI; ++ni)
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[j][ni][i] = 0;
    }
    const unsigned char* wt = ws0 + (t % kSlots) * wbytes;
    // the lane's ldmatrix rows: its B row, and the pixel of its A row in
    // each of the warp's m16 tiles, the tap's shift included
    const unsigned char* brow =
        wt + tat::b_lane_row(lane) * pitch + tat::b_lane_byte(lane);
    int aoff[MT];
#pragma unroll
    for (int j = 0; j < MT; ++j) {
      int r = (warp + 8 * j) * 16 + tat::a_lane_row(lane);
      if (r >= rows) r = 0;   // a valid row; its sums are dropped
      aoff[j] = ((r / ow) * ew + r % ow + shift) * pitch +
                tat::a_lane_byte(lane);
    }
    for (int ks = 0; ks < ksteps; ++ks) {
      const int kb = ks * tat::kMmaStepBytes;
      unsigned bfr[NI][2];
#pragma unroll
      for (int ni = 0; ni < NI; ++ni)
        tat::ldsm_x2(bfr[ni], brow + ni * 8 * pitch + kb);
#pragma unroll
      for (int j = 0; j < MT; ++j) {
        if (j >= jn) break;   // uniform in the warp
        unsigned afr[4];
        tat::ldsm_x4(afr, src + aoff[j] + kb);
#pragma unroll
        for (int ni = 0; ni < NI; ++ni)
          tat::mma_step<T>(acc[j][ni], afr, bfr[ni]);
      }
    }
    if (one || tap == 8) {
#pragma unroll
      for (int j = 0; j < MT; ++j) {
        if (j >= jn) break;
        const int mt = warp + 8 * j;
#pragma unroll
        for (int ni = 0; ni < NI; ++ni) {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int r = mt * 16 + g + 8 * (i >> 1);
            if (r >= rows) continue;
            const int n = chunk * a.bn + ni * 8 + 2 * q + (i & 1);
            const Acc v = acc[j][ni][i];
            if constexpr (kC3Round) {
              if (one) {   // the round's 1x1, requantized with SILU
                mbuf[r * pitch + n] = static_cast<unsigned char>(
                    tat::epilogue(v, 0, a.cs[n], tat::kActSilu, a.inv_out,
                                  a.alpha));
                continue;
              }
            }
            unsigned char* dst = xout + r * pitch + n * E;
            if constexpr (KIND == kShift3) {
              *reinterpret_cast<int8_t*>(dst) = static_cast<int8_t>(v >> 7);
            } else if constexpr (KIND == kRequant3) {
              *reinterpret_cast<int8_t*>(dst) =
                  tat::epilogue<true>(v, 0, a.cs[n], a.act, a.inv_out,
                                      a.alpha);
            } else if constexpr (KIND == kBf16Taps) {
              *reinterpret_cast<__nv_bfloat16*>(dst) =
                  __float2bfloat16_rn(__fmul_rn(v, 0.0078125f));
            } else {
              const int oy = r / ow, ox = r - oy * ow;
              const int res = static_cast<int8_t>(
                  xin[((oy + 1) * ew + ox + 1) * pitch + n]);
              *reinterpret_cast<int8_t*>(dst) =
                  tat::epilogue(v, 0, a.cs[n], tat::kActSilu, a.inv_out,
                                a.alpha, true, res, a.res_scale);
            }
          }
        }
      }
    }
    __syncthreads();
  }
  const unsigned char* xf = smem + (a.L & 1) * a.off_b;
  for (int i = tid; i < a.th * a.tw * xpr; i += blockDim.x) {
    const int p = i / xpr, c = i - p * xpr;
    const int py = p / a.tw, px = p - py * a.tw;
    *reinterpret_cast<uint4*>(
        a.out + ((static_cast<long long>(cell) * a.H + oy0 + py) * a.H + ox0 +
                 px) * a.row_bytes + 16 * c) =
        *reinterpret_cast<const uint4*>(xf + p * pitch + 16 * c);
  }
}

template <int KIND, int MT>
void (*spatial_kernel(int bn))(SpatialArgs) {
  if (bn == 8) return spatial_chain_kernel<KIND, MT, 1>;
  if (bn == 16) return spatial_chain_kernel<KIND, MT, 2>;
  if (bn == 32) return spatial_chain_kernel<KIND, MT, 4>;
  return nullptr;
}

template <int KIND>
int launch_spatial(SpatialArgs a, cudaStream_t s) {
  const int eh0 = a.th + 2 * a.L, ew0 = a.tw + 2 * a.L;
  const long long region = static_cast<long long>(eh0) * ew0;
  const long long rows0 = KIND == kC3 ? region : (eh0 - 2LL) * (ew0 - 2);
  void (*kernel)(SpatialArgs) = nullptr;   // null: no such shape
  if (rows0 <= 128) kernel = spatial_kernel<KIND, 1>(a.bn);
  else if (rows0 <= 256) kernel = spatial_kernel<KIND, 2>(a.bn);
  else if (rows0 <= 512) kernel = spatial_kernel<KIND, 4>(a.bn);
  const bool aligned =
      ((reinterpret_cast<uintptr_t>(a.x) | reinterpret_cast<uintptr_t>(a.w3) |
        reinterpret_cast<uintptr_t>(a.w1) |
        reinterpret_cast<uintptr_t>(a.out)) & 15u) == 0;
  if (kernel == nullptr || a.th < 1 || a.tw < 1 || a.L < 1 || a.cells < 1 ||
      a.H % a.th != 0 || a.H % a.tw != 0 || a.K % a.bn != 0 ||
      a.row_bytes % tat::kMmaStepBytes != 0 ||
      a.pitch != a.row_bytes + tat::kRowPad || !aligned ||
      (KIND == kC3 && a.w1 == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  a.off_b = static_cast<int>(region * a.pitch);
  a.off_m = a.off_b + (eh0 - 2) * (ew0 - 2) * a.pitch;
  a.off_w = a.off_m + (KIND == kC3 ? static_cast<int>(region * a.pitch) : 0);
  const long long smem = a.off_w + static_cast<long long>(kSlots) * a.bn *
                                       a.pitch;
  int dev = 0, max_smem = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&max_smem,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (smem > max_smem) return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const unsigned blocks =
      static_cast<unsigned>(a.cells) * (a.H / a.th) * (a.H / a.tw);
  kernel<<<blocks, tat::kChainThreads, static_cast<size_t>(smem), s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// glue: tat::kGlueShift7 or tat::kGlueRequant (act, inv_out, alpha)
extern "C" int tat_megakernel_1x1(int glue, const void* x, const void* w,
                                  const void* cs, void* out, long long rows,
                                  int K, int L, int bm, int bn, int act,
                                  float inv_out, float alpha, void* stream) {
  tat::RowChainArgs a{};
  a.x = static_cast<const unsigned char*>(x);
  a.w = static_cast<const unsigned char*>(w);
  a.out = static_cast<unsigned char*>(out);
  a.rows = rows;
  a.K = K;
  a.L = L;
  a.bm = bm;
  a.bn = bn;
  a.row_bytes = K;
  a.w_row_bytes = K;
  a.pitch = K + tat::kRowPad;
  a.glue = {static_cast<const float*>(cs), act, inv_out, alpha};
  const auto s = static_cast<cudaStream_t>(stream);
  if (glue == tat::kGlueShift7)
    return tat::launch_row_chain<tat::kGlueShift7>(a, s);
  if (glue == tat::kGlueRequant && cs != nullptr)
    return tat::launch_row_chain<tat::kGlueRequant>(a, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// kind: 0 i8-shift-3x3, 1 i8-rq-*-3x3 (act), 2 bf16-3x3, 3 i8-c3-round
extern "C" int tat_megakernel_3x3(int kind, const void* x, const void* w1,
                                  const void* w3, const void* cs, void* out,
                                  int cells, int H, int L, int K, int th,
                                  int tw, int bn, int act, float inv_out,
                                  float alpha, float res_scale, void* stream) {
  SpatialArgs a{};
  a.x = static_cast<const unsigned char*>(x);
  a.w1 = static_cast<const unsigned char*>(w1);
  a.w3 = static_cast<const unsigned char*>(w3);
  a.out = static_cast<unsigned char*>(out);
  a.cs = static_cast<const float*>(cs);
  a.cells = cells;
  a.H = H;
  a.L = L;
  a.K = K;
  a.th = th;
  a.tw = tw;
  a.bn = bn;
  a.row_bytes = kind == kBf16Taps ? 2 * K : K;
  a.pitch = a.row_bytes + tat::kRowPad;
  a.act = act;
  a.inv_out = inv_out;
  a.alpha = alpha;
  a.res_scale = res_scale;
  const auto s = static_cast<cudaStream_t>(stream);
  if ((kind == kRequant3 || kind == kC3) && cs == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (kind) {
    case kShift3:
      return launch_spatial<kShift3>(a, s);
    case kRequant3:
      return launch_spatial<kRequant3>(a, s);
    case kBf16Taps:
      return launch_spatial<kBf16Taps>(a, s);
    case kC3:
      return launch_spatial<kC3>(a, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
