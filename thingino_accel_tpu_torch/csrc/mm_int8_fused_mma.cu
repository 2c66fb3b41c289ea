// The int8 1x1 conv on the tensor cores, under either epilogue policy of
// epilogue_policy.cuh.
//
// The serving tier's fused 1x1 conv, over 1 to 4 K-parts that are never
// concatenated:
//   out[M, N] = epilogue(sum_i x_i[M, K_i] w_i[N, K_i]^T [, res[M, N]])
// with either of the two scale branches of the multi-part matmul:
//   - equal scales: one int32 sum over all parts, then ServingEpilogue's
//     apply (epilogue.cuh epilogue: + bias in int32, x cs, the act, [+ r x
//     res_scale], x inv_out, round half away, clamp; LEAKY_RELU's alpha on
//     the quantized value);
//   - per-part scales: at each part's end its int32 sum to f32, x s_i,
//     added in part order (part 0 assigned, not added to 0.0f), then
//     apply_parts: + bias x bias_scale, x cs, the act's tail.
// Every multiply and add is an explicit round-to-nearest intrinsic.
//
// The exact tier's 1x1 conv, one part, no residual, under ExactEpilogue:
//   out[M, N] = lut[requant_exact(x[M, K] w[N, K]^T + bias) + 128]
// (one per-tensor combined scale, either RoundMode, RELU after the clamp,
// then the conv's activation beyond RELU as a 256-entry table staged in
// shared memory once a block; no table: none).
//
// Replaces thingino_accel_tpu/ops/fused_kernels.py:
//   - matmul_int8_fused (:241, call :289; Pallas body _mm_kernel), #1, the
//     one-part case;
//   - matmul_int8_fused_multi (:361, call :466; _mm_multi_kernel :321), #3;
// and thingino_accel_tpu/ops/pallas_kernels.py matmul_int8_requant (:120,
// call :156; Pallas body _mm_requant_kernel), #9, the exact entry. Each
// wrapper launches this one kernel and keeps a launch counter of its own.
//
// What bounds it on the H100: K <= 512 and N <= 255 on the serving paths
// (K <= 1024, N <= 512 on the exact zoo yolov5s at 640, N a multiple of
// BN or the heads' 255), so a few hundred int8 operations a byte at most:
// device-memory bytes,
// not MACs (the tensor cores' int8 rate is 1,979 TOP/s, the memory's
// 3.35 TB/s). So the design reads each x byte once and writes each output
// byte once, 16 bytes a thread, with loads in flight:
//   - a block owns BN output channels (16, 32, 64 or 128) with all of
//     their weights (sum_i K_i, each part padded to 32 bytes) resident in
//     shared memory, loaded once, and walks a run of BM-row tiles of M
//     (BM 64 or 128); the blocks of one run's BN blocks are neighbours in
//     the grid, so where N > BN their x rows meet in L2;
//   - the A rows come through a ring of `stages` cp.async stages of 16-byte
//     copies, stage s + stages - 1's copies in flight while stage s
//     computes; a stage is one (tile, part, chunk of KC bytes); the parts
//     are K-segments with their own base pointers and row strides, and a
//     part whose K is off 32 is zero-filled up to 32 by a source size
//     below 16 (K_i = 16 on the real yolov5n);
//   - the same kernel's byte path (operands off 16-byte alignment or a
//     row stride off 16) fills the same stages with byte loads;
//   - the product is mma.sync m16n8k32 s8 from ldmatrix (mma_tile.cuh),
//     8 warps tiling BM x BN 4 x 2 with MI m16 x NI n8 tiles each (BM = 64
//     MI, BN = 16 NI). No dp4a;
//   - the epilogue runs on the C fragments in registers; each channel's
//     bias and cs (and bias x bias_scale) are loaded once a kernel into
//     shared memory; the int8 tile is staged in shared memory and written
//     16 bytes a thread along each row's BN bytes (where N % 16 != 0, the
//     N = 255 heads, or the output is unaligned: aligned 4-byte words
//     built by funnel shifts and bytes at the row's ends, one item a
//     thread);
//   - a residual is cp.async-ed (16 bytes where N % 16 == 0 and it is
//     16-byte aligned, else byte by byte) into the staged tile at the
//     tile's last stage; each lane reads its two bytes there before it
//     overwrites them with its result.
// ACT is a template constant and so is the scale branch; the exact
// policy's RoundMode, RELU and table are run-time parameters.
//
// Built with -DTAT_GEMM_NO_STORE the epilogue stores nothing and no
// residual is read (the sums are folded into one value that is kept live),
// with -DTAT_GEMM_NO_PRODUCT no ldmatrix or mma.sync runs: variants
// compiled only to measure the shares of the epilogue and the product; no
// wrapper loads them.
//
// Shared memory (mm_layout, its total mirrored by ops/fused_kernels.py
// mm_smem),
// all dynamic: the ring (stages x BM rows at KC + 16 bytes), the weights
// (BN rows at Kp + 16 bytes, Kp = sum of the padded K_i), the staged
// output tile (BM rows at BN + 16 bytes), then BN columns of the policy's
// Col (bias and cs: 8 bytes, the exact policy's bias: 4), BN floats of
// bias x bias_scale and the policy's table (the exact policy's 256
// bytes). Every ldmatrix pitch is an odd multiple of 16 bytes.
#include <cstdint>

#include <cuda_runtime.h>

#include "epilogue.cuh"
#include "epilogue_policy.cuh"
#include "mma_tile.cuh"

namespace {

constexpr int kThreads = 256;   // 8 warps: 4 along M, 2 along BN
constexpr int kMaxParts = 4;
constexpr int kOutPad = 16;     // bytes after each staged output row
// measurement variants: no epilogue stores, no product
#ifdef TAT_GEMM_NO_STORE
constexpr bool kStore = false;
#else
constexpr bool kStore = true;
#endif
#ifdef TAT_GEMM_NO_PRODUCT
constexpr bool kProduct = false;
#else
constexpr bool kProduct = true;
#endif

// blocks an SM the registers must allow (__launch_bounds__): 2 (128
// registers a thread), 1 for the largest tile (MI 2 x NI 8)
constexpr int mm_min_blocks(int mi, int ni) { return mi * ni >= 16 ? 1 : 2; }

struct MmGeom {
  const int8_t* x[kMaxParts];
  long long ldx[kMaxParts];
  const int8_t* w[kMaxParts];
  int ldw[kMaxParts];
  int K[kMaxParts];      // the part's K
  int kpad[kMaxParts];   // K rounded up to 32
  int koff[kMaxParts];   // its first byte in a resident weight row
  float s[kMaxParts];    // its scale (per-part branch)
  int parts;
  long long M;
  int N, BM, BN, KC, stages;
  int Kp;                // sum of kpad
  int apitch, wpitch;    // KC + 16, Kp + 16
  int slot_bytes, w_off, out_off, col_off, bf_off, tab_off, smem;
  int spt;               // stages a tile
  int tiles, tpb, nbn;   // M tiles, tiles a block, BN blocks
  int vec_a, vec_w, vec_out;
};

constexpr int round_up(int v, int m) { return (v + m - 1) / m * m; }

// The shared-memory layout of one block (ops/fused_kernels.py mm_smem
// mirrors its total); g.parts, K, BM, BN, KC and stages set; col_bytes and
// table_bytes the policy's.
void mm_layout(MmGeom& g, int col_bytes, int table_bytes) {
  g.Kp = 0;
  g.spt = 0;
  for (int i = 0; i < g.parts; ++i) {
    g.kpad[i] = round_up(g.K[i], tat::kMmaStepBytes);
    g.koff[i] = g.Kp;
    g.Kp += g.kpad[i];
    g.spt += (g.kpad[i] + g.KC - 1) / g.KC;
  }
  g.apitch = g.KC + tat::kRowPad;
  g.wpitch = g.Kp + tat::kRowPad;
  g.slot_bytes = g.BM * g.apitch;
  g.w_off = g.stages * g.slot_bytes;
  g.out_off = g.w_off + g.BN * g.wpitch;
  g.col_off = g.out_off + g.BM * (g.BN + kOutPad);
  g.bf_off = g.col_off + g.BN * col_bytes;
  g.tab_off = g.bf_off + g.BN * 4;
  g.smem = g.tab_off + table_bytes;
}

inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

// where stage s of a run stands: its tile (of the run), part and first K
// byte of the part
struct Cursor {
  int tile, part, k0;
};

__device__ __forceinline__ void advance(Cursor& c, const MmGeom& g) {
  c.k0 += g.KC;
  if (c.k0 >= g.kpad[c.part]) {
    c.k0 = 0;
    if (++c.part == g.parts) {
      c.part = 0;
      ++c.tile;
    }
  }
}

// The BN weight rows of every part into the resident rows (zeros past K_i
// and past N).
__device__ void load_weights(const MmGeom& g, unsigned char* wsm, int n0) {
  for (int p = 0; p < g.parts; ++p) {
    const int upr = g.kpad[p] / 16;   // 16-byte units a row
    for (int u = threadIdx.x; u < g.BN * upr; u += kThreads) {
      const int r = u / upr, k = 16 * (u - r * upr);
      const bool live = n0 + r < g.N;
      const int left = g.K[p] - k;
      const int bytes = !live || left <= 0 ? 0 : (left < 16 ? left : 16);
      const int8_t* src =
          bytes > 0 ? g.w[p] + static_cast<long long>(n0 + r) * g.ldw[p] + k
                    : g.w[p];
      unsigned char* dst = wsm + r * g.wpitch + g.koff[p] + k;
      if (g.vec_w)
        tat::cp_async16(dst, src, bytes);
      else
        *reinterpret_cast<uint4*>(dst) = tat::load16_bytes(src, bytes);
    }
  }
}

// Stage c (of the run starting at tile t0) into `slot`: BM rows of the
// part's bytes [k0, k0 + min(KC, kpad - k0)), zeros past K_i and past M.
__device__ void issue_stage(const MmGeom& g, unsigned char* slot, int t0,
                            const Cursor& c) {
  const int p = c.part;
  const int width = g.kpad[p] - c.k0 < g.KC ? g.kpad[p] - c.k0 : g.KC;
  const int upr = width / 16;
  const long long m0 = static_cast<long long>(t0 + c.tile) * g.BM;
  const int8_t* x = g.x[p];
  for (int u = threadIdx.x; u < g.BM * upr; u += kThreads) {
    const int r = u / upr, k = c.k0 + 16 * (u - r * upr);
    const long long m = m0 + r;
    const int left = g.K[p] - k;
    const int bytes = m >= g.M || left <= 0 ? 0 : (left < 16 ? left : 16);
    const int8_t* src = bytes > 0 ? x + m * g.ldx[p] + k : x;
    unsigned char* dst = slot + r * g.apitch + (k - c.k0);
    if (g.vec_a)
      tat::cp_async16(dst, src, bytes);
    else
      *reinterpret_cast<uint4*>(dst) = tat::load16_bytes(src, bytes);
  }
}

// The tile's residual (BM rows x BN bytes from column n0) into the staged
// output tile, 16-byte cp.async copies where p.vec_res (zeros past M and
// N), else byte loads; then a commit, so that cp_async_wait<0> and a
// barrier make them visible.
template <int BN>
__device__ void load_residual(const MmGeom& g, const ServingParams& p,
                              unsigned char* staged, long long m0, int n0) {
  const int live = g.N - n0 < BN ? g.N - n0 : BN;
  if (p.vec_res) {
    constexpr int upr = BN / 16;
    for (int u = threadIdx.x; u < g.BM * upr; u += kThreads) {
      const int r = u / upr, c = 16 * (u - r * upr);
      const bool ok = m0 + r < g.M && c < live;
      const int8_t* src = ok ? p.res + (m0 + r) * g.N + n0 + c : p.res;
      tat::cp_async16(staged + r * (BN + kOutPad) + c, src, ok ? 16 : 0);
    }
  } else {
    for (int u = threadIdx.x; u < g.BM * BN; u += kThreads) {
      const int r = u / BN, c = u - r * BN;
      const bool ok = m0 + r < g.M && c < live;
      staged[r * (BN + kOutPad) + c] =
          ok ? static_cast<unsigned char>(p.res[(m0 + r) * g.N + n0 + c]) : 0;
    }
  }
  tat::cp_async_commit();
}

// One 32-byte K step: acc += A (MI m16 tiles at `at` + aoff) x B (NI n8
// tiles, the lane's row at `bt`, tiles 16 rows apart in pairs; NI = 1: one
// .x2 load from lanes 0-15).
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

// The staged tile's rows out where they are off 16 bytes (N % 16 != 0, the
// N = 255 heads) or the output is unaligned: a row's live bytes as aligned
// 4-byte words, each built from two staged words by a funnel shift, and
// single bytes at its two ends; one item (the head bytes, a word, the
// tail bytes) a thread, consecutive threads on consecutive words of a row,
// so no thread loops over a length of its own.
template <int BM, int BN>
__device__ void store_rows_unaligned(const MmGeom& g,
                                     const unsigned char* staged,
                                     long long m0, int n0,
                                     int8_t* __restrict__ out) {
  constexpr int kPitch = BN + kOutPad, kItems = BN / 4 + 2;
  const int live = g.N - n0 < BN ? g.N - n0 : BN;
  for (int u = threadIdx.x; u < BM * kItems; u += kThreads) {
    const int r = u / kItems, q = u - r * kItems;
    if (m0 + r >= g.M) continue;
    int8_t* dst = out + (m0 + r) * g.N + n0;
    const unsigned char* src = staged + r * kPitch;
    const int head0 = static_cast<int>(
        (4u - (static_cast<unsigned>(reinterpret_cast<uintptr_t>(dst)) & 3u)) &
        3u);
    const int head = head0 < live ? head0 : live;
    const int words = (live - head) / 4;
    if (q == 0) {
      for (int b = 0; b < head; ++b) dst[b] = static_cast<int8_t>(src[b]);
    } else if (q <= words) {
      const int o = head + 4 * (q - 1);
      const unsigned* w = reinterpret_cast<const unsigned*>(src + (o & ~3));
      *reinterpret_cast<unsigned*>(dst + o) =
          __funnelshift_r(w[0], w[1], 8 * (o & 3));
    } else if (q == words + 1) {
      for (int b = head + 4 * words; b < live; ++b)
        dst[b] = static_cast<int8_t>(src[b]);
    }
  }
}

// The policy on the fragments (int32 sums, or the per-part f32 sums) into
// the staged int8 tile (with a residual, each lane's two bytes there are
// its residual, read before they are overwritten), then each row's
// channels out. The lane's channels are read from shared memory before
// the first staged store, so no load waits behind a store.
template <int MI, int NI, bool PER_PART, class EP>
__device__ void store_tile(const MmGeom& g, const int (&acc)[MI][NI][4],
                           const float (&accf)[MI][NI][4],
                           const typename EP::Col* cols, const float* bf,
                           unsigned char* staged, const unsigned char* tab,
                           long long m0, int n0,
                           const typename EP::Params& ep,
                           int8_t* __restrict__ out) {
  constexpr int BN = 16 * NI, BM = 64 * MI, kPitch = BN + kOutPad;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp & 3, wn = warp >> 2;
  const int gq = lane >> 2, tq = lane & 3;
  typename EP::Col c[NI][2];
  float b[NI][2];
#pragma unroll
  for (int ni = 0; ni < NI; ++ni)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int col = wn * 8 * NI + ni * 8 + 2 * tq + e;
      c[ni][e] = cols[col];
      b[ni][e] = PER_PART ? bf[col] : 0.0f;
    }
  bool res = false;
  if constexpr (EP::kResidual) {
    res = ep.res != nullptr;
    if (res) {
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
        uint16_t* dst = reinterpret_cast<uint16_t*>(
            staged + row * kPitch + wn * 8 * NI + ni * 8 + 2 * tq);
        int r0 = 0, r1 = 0;
        if (res) {
          const unsigned v = *dst;
          r0 = static_cast<int8_t>(v & 0xffu);
          r1 = static_cast<int8_t>(v >> 8);
        }
        unsigned q0, q1;
        if constexpr (PER_PART) {
          q0 = static_cast<uint8_t>(EP::apply_parts(
              accf[mi][ni][2 * h], b[ni][0], c[ni][0], ep, r0));
          q1 = static_cast<uint8_t>(EP::apply_parts(
              accf[mi][ni][2 * h + 1], b[ni][1], c[ni][1], ep, r1));
        } else {
          q0 = static_cast<uint8_t>(
              EP::apply(acc[mi][ni][2 * h], c[ni][0], ep, r0, tab));
          q1 = static_cast<uint8_t>(
              EP::apply(acc[mi][ni][2 * h + 1], c[ni][1], ep, r1, tab));
        }
        *dst = static_cast<uint16_t>(q0 | q1 << 8);
      }
    }
  __syncthreads();
  if (!g.vec_out) {
    store_rows_unaligned<BM, BN>(g, staged, m0, n0, out);
    return;
  }
  const int live = g.N - n0 < BN ? g.N - n0 : BN;   // channels of the block
  for (int u = threadIdx.x; u < BM * NI; u += kThreads) {
    const int r = u / NI, c = 16 * (u - r * NI);   // NI 16-byte units a row
    if (m0 + r < g.M && c < live)
      *reinterpret_cast<uint4*>(out + (m0 + r) * g.N + n0 + c) =
          *reinterpret_cast<const uint4*>(staged + r * kPitch + c);
  }
}

// The no-store variant's epilogue: the sums folded into one value that is
// stored only if it takes one given value, so the product is kept.
template <int MI, int NI>
__device__ __forceinline__ void sink_tile(const int (&acc)[MI][NI][4],
                                          const float (&accf)[MI][NI][4],
                                          int8_t* __restrict__ out) {
  int f = 0;
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int ni = 0; ni < NI; ++ni)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        f ^= acc[mi][ni][r] * (r + 1) + __float_as_int(accf[mi][ni][r]);
  if (f == 0x5a5a5a5a) out[0] = 1;
}

template <int MI, int NI, bool PER_PART, class EP>
__global__ void __launch_bounds__(kThreads, mm_min_blocks(MI, NI))
    mm_mma_kernel(MmGeom g, const int* __restrict__ bias, float bias_scale,
                  typename EP::Params ep, int8_t* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int BN = 16 * NI;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int run = blockIdx.x / g.nbn;
  const int n0 = (blockIdx.x - run * g.nbn) * BN;
  const int t0 = run * g.tpb;
  const int tiles = g.tiles - t0 < g.tpb ? g.tiles - t0 : g.tpb;
  const int total = tiles * g.spt;
  const int wm = warp & 3, wn = warp >> 2;
  unsigned char* wsm = smem + g.w_off;
  unsigned char* staged = smem + g.out_off;
  auto* cols = reinterpret_cast<typename EP::Col*>(smem + g.col_off);
  float* bf = reinterpret_cast<float*>(smem + g.bf_off);
  unsigned char* tab = smem + g.tab_off;
  EP::stage_table(ep, tab);

  // the block's channels, once (visible after the loop's first barrier)
  for (int c = tid; c < BN; c += kThreads) {
    const int o = n0 + c;
    cols[c] = EP::col(bias, ep, o, o < g.N);
    bf[c] = PER_PART ? __fmul_rn(__int2float_rn(cols[c].b), bias_scale)
                     : 0.0f;
  }
  // the lane's ldmatrix A rows in a slot, and its B row for .x4 loads of
  // two n8 tiles: (tile 0, bytes 0-15), (0, 16-31), (1, 0-15), (1, 16-31)
  int aoff[MI];
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
    aoff[mi] = ((wm * MI + mi) * 16 + tat::a_lane_row(lane)) * g.apitch +
               tat::a_lane_byte(lane);
  const int brow = (wn * 8 * NI + (lane & 7) + 8 * (lane >> 4)) * g.wpitch +
                   ((lane >> 3) & 1) * 16;

  // group 0: the resident weights and stage 0; then the ring's other
  // stages but one, a group each (empty past the run)
  load_weights(g, wsm, n0);
  Cursor ahead = {0, 0, 0};
  for (int s = 0; s < g.stages - 1; ++s) {
    if (s < total) {
      issue_stage(g, smem + s * g.slot_bytes, t0, ahead);
      advance(ahead, g);
    }
    tat::cp_async_commit();
  }
  int acc[MI][NI][4];
  float accf[MI][NI][4] = {};
  Cursor cur = {0, 0, 0};
  for (int s = 0; s < total; ++s) {
    switch (g.stages) {   // stage s landed
      case 2: tat::cp_async_wait<0>(); break;
      case 3: tat::cp_async_wait<1>(); break;
      default: tat::cp_async_wait<2>(); break;
    }
    __syncthreads();   // ... for every thread; slot (s - 1) is read
    const bool part_end = cur.k0 + g.KC >= g.kpad[cur.part];
    const bool tile_end = part_end && cur.part == g.parts - 1;
    const long long m0 = static_cast<long long>(t0 + cur.tile) * g.BM;
    if constexpr (EP::kResidual && kStore) {
      if (tile_end && ep.res != nullptr)
        load_residual<BN>(g, ep, staged, m0, n0);
    }
    const int next = s + g.stages - 1;
    if (next < total) {
      issue_stage(g, smem + (next % g.stages) * g.slot_bytes, t0, ahead);
      advance(ahead, g);
    }
    tat::cp_async_commit();   // empty past the run: keeps the count
    if (cur.k0 == 0 && (cur.part == 0 || PER_PART)) {
#pragma unroll
      for (int mi = 0; mi < MI; ++mi)
#pragma unroll
        for (int ni = 0; ni < NI; ++ni)
#pragma unroll
          for (int r = 0; r < 4; ++r) acc[mi][ni][r] = 0;
    }
    const unsigned char* slot = smem + (s % g.stages) * g.slot_bytes;
    const unsigned char* wl = wsm + brow + g.koff[cur.part] + cur.k0;
    const int width =
        g.kpad[cur.part] - cur.k0 < g.KC ? g.kpad[cur.part] - cur.k0 : g.KC;
    for (int kb = 0; kb < width; kb += tat::kMmaStepBytes)
      if constexpr (kProduct)
        mma_k32<MI, NI>(acc, slot + kb, aoff, wl + kb, g.wpitch);
    if constexpr (PER_PART) {
      if (part_end) {
        const float sc = g.s[cur.part];
#pragma unroll
        for (int mi = 0; mi < MI; ++mi)
#pragma unroll
          for (int ni = 0; ni < NI; ++ni)
#pragma unroll
            for (int r = 0; r < 4; ++r) {
              const float v = __fmul_rn(__int2float_rn(acc[mi][ni][r]), sc);
              accf[mi][ni][r] =
                  cur.part == 0 ? v : __fadd_rn(accf[mi][ni][r], v);
            }
      }
    }
    if (tile_end) {
      if constexpr (kStore)
        store_tile<MI, NI, PER_PART, EP>(g, acc, accf, cols, bf, staged, tab,
                                         m0, n0, ep, out);
      else
        sink_tile<MI, NI>(acc, accf, out);
    }
    advance(cur, g);
  }
}


template <class EP>
using MmKernel = void (*)(MmGeom, const int*, float, typename EP::Params,
                          int8_t*);

template <bool PER_PART, class EP>
MmKernel<EP> pick_tile(int mi, int ni) {
  if (mi == 1 && ni == 1) return mm_mma_kernel<1, 1, PER_PART, EP>;
  if (mi == 2 && ni == 1) return mm_mma_kernel<2, 1, PER_PART, EP>;
  if (mi == 1 && ni == 2) return mm_mma_kernel<1, 2, PER_PART, EP>;
  if (mi == 2 && ni == 2) return mm_mma_kernel<2, 2, PER_PART, EP>;
  if (mi == 1 && ni == 4) return mm_mma_kernel<1, 4, PER_PART, EP>;
  if (mi == 2 && ni == 4) return mm_mma_kernel<2, 4, PER_PART, EP>;
  if (mi == 1 && ni == 8) return mm_mma_kernel<1, 8, PER_PART, EP>;
  // MI 2 x NI 8 holds 64 int32 sums a thread; the per-part branch's f32
  // sums beside them would spill
  if (mi == 2 && ni == 8 && !PER_PART)
    return mm_mma_kernel<2, 8, PER_PART, EP>;
  return nullptr;
}

template <int ACT>
MmKernel<ServingEpilogue<ACT>> pick(int per_part, int mi, int ni) {
  return per_part ? pick_tile<true, ServingEpilogue<ACT>>(mi, ni)
                  : pick_tile<false, ServingEpilogue<ACT>>(mi, ni);
}

// The plan's layout in g (whose parts and K are set) under the policy EP;
// false for a plan the kernel cannot run.
template <class EP>
bool plan_layout(int bm, int bn, int kc, int stages, MmGeom& g) {
  if (g.parts < 1 || g.parts > kMaxParts || (bm != 64 && bm != 128) ||
      (bn != 16 && bn != 32 && bn != 64 && bn != 128) || kc < 32 ||
      kc % 32 != 0 || stages < 2 || stages > 4)
    return false;
  for (int i = 0; i < g.parts; ++i)
    if (g.K[i] < 1) return false;
  g.BM = bm;
  g.BN = bn;
  g.KC = kc;
  g.stages = stages;
  mm_layout(g, sizeof(typename EP::Col), EP::kTableBytes);
  return true;
}

// k opted into g.smem of shared memory, or null (err set) where the card
// cannot give it.
template <class K>
K opt_in(K k, const MmGeom& g, cudaError_t& err) {
  err = cudaErrorInvalidValue;
  if (k == nullptr) return nullptr;
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

// The serving kernel of a plan and its layout in g (whose parts and K are
// set), or null for a plan or act it cannot run; opts the kernel into its
// shared memory.
MmKernel<ServingEpilogue<tat::kActNone>> prepare(int act, int per_part,
                                                 int bm, int bn, int kc,
                                                 int stages, MmGeom& g,
                                                 cudaError_t& err) {
  using ServingKernel = MmKernel<ServingEpilogue<tat::kActNone>>;
  err = cudaErrorInvalidValue;
  // every act's layout is the same (Col, no table)
  if (!plan_layout<ServingEpilogue<tat::kActNone>>(bm, bn, kc, stages, g))
    return nullptr;
  ServingKernel k = nullptr;
  switch (act) {
    case tat::kActNone:
      k = pick<tat::kActNone>(per_part, bm / 64, bn / 16);
      break;
    case tat::kActRelu:
      k = pick<tat::kActRelu>(per_part, bm / 64, bn / 16);
      break;
    case tat::kActLeakyRelu:
      k = pick<tat::kActLeakyRelu>(per_part, bm / 64, bn / 16);
      break;
    case tat::kActSilu:
      k = pick<tat::kActSilu>(per_part, bm / 64, bn / 16);
      break;
    default:   // SILU_FAST is compiled only into the probes' kernels
      return nullptr;
  }
  return opt_in(k, g, err);
}

// The exact kernel of a plan (one part of K) and its layout in g, as
// prepare.
MmKernel<ExactEpilogue> prepare_exact(int K, int bm, int bn, int kc,
                                      int stages, MmGeom& g,
                                      cudaError_t& err) {
  err = cudaErrorInvalidValue;
  g.parts = 1;
  g.K[0] = K;
  if (!plan_layout<ExactEpilogue>(bm, bn, kc, stages, g)) return nullptr;
  return opt_in(pick_tile<false, ExactEpilogue>(bm / 64, bn / 16), g, err);
}

void set_parts(MmGeom& g, int n_parts, const int* ks) {
  g.parts = n_parts;
  for (int i = 0; i < kMaxParts; ++i) g.K[i] = i < n_parts ? ks[i] : 0;
}

// The run geometry of a prepared g (operands set); the number of blocks.
unsigned set_run(MmGeom& g, long long M, int N, int tiles_per_block,
                 const void* out) {
  g.M = M;
  g.N = N;
  g.vec_out = N % 16 == 0 && aligned16(out);
  const long long tiles = (M + g.BM - 1) / g.BM;
  g.tiles = static_cast<int>(tiles);
  g.tpb = tiles_per_block < g.tiles ? tiles_per_block : g.tiles;
  g.nbn = (N + g.BN - 1) / g.BN;
  const long long runs = (tiles + g.tpb - 1) / g.tpb;
  return static_cast<unsigned>(runs * g.nbn);
}

template <class K>
int occupancy(K k, const MmGeom& g, int* smem, int* blocks_per_sm) {
  *smem = g.smem;
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, k, kThreads, static_cast<size_t>(g.smem)));
}

}  // namespace

// One launch: n_parts (1..4) parts, part i x_i [M, K_i] int8 at row stride
// ldx[i] and w_i [N, K_i] int8 at row stride ldw[i] (bytes; e.g. column
// slices of one [N, sum K_i] matrix), its f32 scale part_scales[i] (read
// only where same_scale is 0); bias [N] int32 or null, in units of
// bias_scale x the weight scale in the per-part branch; cs [N] f32; res
// [M, N] int8 or null; out [M, N] int8; the epilogue's act (tat::Act, not
// SILU_FAST), inv_out, alpha and res_scale. The plan: bm rows a tile (64,
// 128), bn channels a block (16, 32, 64, 128), kc bytes a stage (a
// multiple of 32), a ring of `stages` (2..4), tiles_per_block tiles a
// block. Returns a cudaError_t; cudaErrorInvalidValue for a shape or plan
// it cannot run (LEAKY_RELU with a residual among them).
extern "C" int tat_mm_int8_fused_mma(
    int n_parts, const void* const* xs, const long long* ldx,
    const void* const* ws, const int* ldw, const int* ks,
    const float* part_scales, int same_scale, const void* bias,
    float bias_scale, const void* cs, const void* res, void* out, long long M,
    int N, int act, float inv_out, float alpha, float res_scale, int bm,
    int bn, int kc, int stages, int tiles_per_block, void* stream) {
  if (n_parts < 1 || n_parts > kMaxParts || M < 1 || N < 1 ||
      tiles_per_block < 1 || cs == nullptr ||
      (res != nullptr && act == tat::kActLeakyRelu))
    return static_cast<int>(cudaErrorInvalidValue);
  MmGeom g = {};
  set_parts(g, n_parts, ks);
  cudaError_t err;
  const auto k = prepare(act, same_scale ? 0 : 1, bm, bn, kc, stages, g, err);
  if (k == nullptr) return static_cast<int>(err);
  g.vec_a = g.vec_w = 1;
  for (int i = 0; i < n_parts; ++i) {
    g.x[i] = static_cast<const int8_t*>(xs[i]);
    g.w[i] = static_cast<const int8_t*>(ws[i]);
    g.ldx[i] = ldx[i];
    g.ldw[i] = ldw[i];
    g.s[i] = part_scales[i];
    g.vec_a = g.vec_a && aligned16(xs[i]) && ldx[i] % 16 == 0;
    g.vec_w = g.vec_w && aligned16(ws[i]) && ldw[i] % 16 == 0;
  }
  const unsigned blocks = set_run(g, M, N, tiles_per_block, out);
  const ServingParams ep = {
      static_cast<const float*>(cs), inv_out, alpha,
      static_cast<const int8_t*>(res), res_scale,
      N % 16 == 0 && aligned16(res)};
  k<<<blocks, kThreads, static_cast<size_t>(g.smem),
      static_cast<cudaStream_t>(stream)>>>(
      g, static_cast<const int*>(bias), bias_scale, ep,
      static_cast<int8_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

// The dynamic shared memory of a plan in bytes and the blocks of its kernel
// an SM holds at once; cudaErrorInvalidValue for a plan the kernel cannot
// run.
extern "C" int tat_mm_int8_fused_mma_info(int n_parts, const int* ks,
                                          int same_scale, int act, int bm,
                                          int bn, int kc, int stages,
                                          int* smem, int* blocks_per_sm) {
  if (n_parts < 1 || n_parts > kMaxParts)
    return static_cast<int>(cudaErrorInvalidValue);
  MmGeom g = {};
  set_parts(g, n_parts, ks);
  cudaError_t err;
  const auto k = prepare(act, same_scale ? 0 : 1, bm, bn, kc, stages, g, err);
  if (k == nullptr) return static_cast<int>(err);
  return occupancy(k, g, smem, blocks_per_sm);
}

// The exact tier's #9, one launch: x [M, K] int8 and w [N, K] int8, both
// row-major and contiguous; bias [N] int32 or null; lut the activation's
// 256 int8 values (entry q + 128 the act of q) or null; out [M, N] int8;
// requant_exact's cs, round_mode (RoundMode) and relu. The plan as
// tat_mm_int8_fused_mma's. Returns a cudaError_t; cudaErrorInvalidValue
// for a shape or plan it cannot run.
extern "C" int tat_mm_int8_requant_mma(
    const void* x, const void* w, const void* bias, const void* lut,
    void* out, long long M, int N, int K, float cs, int round_mode, int relu,
    int bm, int bn, int kc, int stages, int tiles_per_block, void* stream) {
  if (M < 1 || N < 1 || K < 1 || tiles_per_block < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  MmGeom g = {};
  cudaError_t err;
  const auto k = prepare_exact(K, bm, bn, kc, stages, g, err);
  if (k == nullptr) return static_cast<int>(err);
  g.x[0] = static_cast<const int8_t*>(x);
  g.w[0] = static_cast<const int8_t*>(w);
  g.ldx[0] = K;
  g.ldw[0] = K;
  g.s[0] = 1.0f;
  g.vec_a = aligned16(x) && K % 16 == 0;
  g.vec_w = aligned16(w) && K % 16 == 0;
  const unsigned blocks = set_run(g, M, N, tiles_per_block, out);
  const ExactEpilogue::Params ep = {cs, round_mode, relu != 0,
                                    static_cast<const int8_t*>(lut)};
  k<<<blocks, kThreads, static_cast<size_t>(g.smem),
      static_cast<cudaStream_t>(stream)>>>(
      g, static_cast<const int*>(bias), 1.0f, ep, static_cast<int8_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

// The dynamic shared memory of an exact plan (K bytes a row) in bytes and
// the blocks of its kernel an SM holds at once; cudaErrorInvalidValue for a
// plan the kernel cannot run.
extern "C" int tat_mm_int8_requant_mma_info(int K, int bm, int bn, int kc,
                                            int stages, int* smem,
                                            int* blocks_per_sm) {
  MmGeom g = {};
  cudaError_t err;
  const auto k = prepare_exact(K, bm, bn, kc, stages, g, err);
  if (k == nullptr) return static_cast<int>(err);
  return occupancy(k, g, smem, blocks_per_sm);
}
