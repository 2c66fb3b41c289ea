// YOLO head decode of every pyramid level in one launch: raw head rows
// [B*H*W, A*(5+NC)] (int8 with a dequant scale, f32, or bf16) of up to
// kMaxLevels levels -> boxes f32 [B, N, 4] (cx, cy, w, h), conf f32 [B, N]
// and class int32 [B, N], N = sum over levels of H*W*A, ordered (level,
// gy, gx, anchor) within each image: the outputs of decode_and_parse,
// written straight into the concatenated arrays.
//
//   xy   = (sigmoid(t_xy * scale) * 2 - 0.5 + grid) * stride
//   wh   = (sigmoid(t_wh * scale) * 2)^2 * anchor
//   conf = sigmoid(t_obj * scale) * sigmoid(best_logit * scale)
//   class = the first index attaining the max class logit
//
// Replaces thingino_accel_tpu/ops/decode_kernel.py:decode_level_pallas
// (Pallas body _decode_rows_kernel), one launch per level over row tiles
// whose height must divide the row count. Here any row count is taken, so
// no level falls back to another decode; for f32 heads a NaN logit wins
// the class max as it does in jnp.argmax (the first NaN), where the Pallas
// kernel returned num_classes for an all-NaN row.
//
// What bounds it on the H100: bytes. It reads each head byte once and
// writes 24 bytes per (cell, anchor) unit: at the real yolov5n's heads at
// batch 16, 34.3 MB in and 9.7 MB out. Design: a block owns a run of up to
// kThreads consecutive units of one level of one image (grid.x the runs of
// every level, grid.y the image: no unit searches for its level) and
// stages the run's bytes, which are contiguous, into shared memory with
// 16-byte cp.async copies over the 16-byte-aligned range around them
// (the head may be a view at any byte offset: the staged range is aligned
// inside the kernel, and clipped at the head's end). One thread decodes
// one unit. For int8 heads sigmoid(t * scale) takes only 256 values a
// level: the block builds them as a table in shared memory with the
// expression the plain version rounds (sigmoid_rn of __fmul_rn), so the
// five box/objectness sigmoids and the class one are lookups; the class
// maximum is a __vmaxs4 over the unit's 4-byte words (realigned by funnel
// shifts) and its first index the first word whose __vcmpeq4 with the
// maximum is non-zero. f32 and bf16 heads keep sigmoid_rn and the
// NaN-aware first-max order (a NaN wins, the first NaN first); a bf16
// value becomes f32 by __bfloat162float, which is exact. bf16 heads are
// the fast tier's (the JAX fast tier hands decode_level_pallas its bf16
// heads); a 170-byte unit (NC 80) is as unaligned as an f32 one, and the
// staged range is aligned as for int8. A box is one 16-byte store, conf
// and class coalesced 4-byte stores. A unit too large to stage (more than
// kStageBytes: int8 NC above about 32 K, bf16 above 16 K, f32 above 8 K)
// is decoded by the whole block, its class logits read from device memory
// in strides of kThreads and reduced through shuffles and shared memory.
// The float steps are __fmul_rn/__fadd_rn/__fdiv_rn in the reference's
// order with full-precision expf, so nvcc cannot contract them into FMAs.
#include <climits>
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "mma_tile.cuh"

namespace {

constexpr int kMaxLevels = 4;
constexpr int kMaxAnchors = 8;
constexpr int kThreads = 128;           // units a staged run at most
constexpr int kStageBytes = 32768;      // a run's staged bytes at most
constexpr int kSlack = 48;              // alignment and word over-reads
constexpr int kTableBytes = 256 * 4;    // the int8 sigmoid table
constexpr unsigned kFull = 0xffffffffu;

struct DecodeArgs {
  const void* feat[kMaxLevels];
  long long bytes[kMaxLevels];   // a head's bytes, all images
  int units[kMaxLevels];         // H W A: one image's units of a level
  int run_off[kMaxLevels + 1];   // the first run (blockIdx.x) of a level
  int out_off[kMaxLevels];       // a level's first unit in an image's N
  int W[kMaxLevels];
  float stride[kMaxLevels], scale[kMaxLevels];
  float anchor[kMaxLevels][kMaxAnchors][2];
  int levels, A, NC, per_image;
  int run;   // units a block; 0: one unit, decoded by the whole block
};

__device__ __forceinline__ float sigmoid_rn(float v) {
  return __fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-v)));
}

// Element i of a head row as f32: int8 (before its scale), f32, bf16.
__device__ __forceinline__ float head_value(const int8_t* p, int i) {
  return __int2float_rn(p[i]);
}
__device__ __forceinline__ float head_value(const float* p, int i) {
  return p[i];
}
__device__ __forceinline__ float head_value(const __nv_bfloat16* p, int i) {
  return __bfloat162float(p[i]);
}

// (v, i) comes before (bv, bi) in the class order: NaN above every number,
// then larger values, ties to the lower index.
__device__ __forceinline__ bool first_max(float v, int i, float bv, int bi) {
  const bool vn = isnan(v), bn = isnan(bv);
  if (vn || bn) return vn && (!bn || i < bi);
  return v > bv || (v == bv && i < bi);
}

// The maximum of the int8 logits p[0..n) (p at any byte of shared memory)
// and the first index attaining it, four bytes at a time.
__device__ __forceinline__ void class_max_s8(const unsigned char* p, int n,
                                             int& best, int& index) {
  const unsigned* w = reinterpret_cast<const unsigned*>(
      reinterpret_cast<uintptr_t>(p) & ~uintptr_t(3));
  const unsigned sh = 8 * (reinterpret_cast<uintptr_t>(p) & 3);
  const int nw = n >> 2, rem = n & 3;
  // the last partial word, its missing bytes -128: they come after every
  // real byte, so they never win the first index
  const unsigned keep = rem ? (1u << (8 * rem)) - 1 : 0u;
  const unsigned last =
      (__funnelshift_r(w[nw], w[nw + 1], sh) & keep) | (0x80808080u & ~keep);
  unsigned m4 = last;
  for (int k = 0; k < nw; ++k)
    m4 = __vmaxs4(m4, __funnelshift_r(w[k], w[k + 1], sh));
  const int m = max(max(static_cast<int>(static_cast<int8_t>(m4)),
                        static_cast<int>(static_cast<int8_t>(m4 >> 8))),
                    max(static_cast<int>(static_cast<int8_t>(m4 >> 16)),
                        static_cast<int>(static_cast<int8_t>(m4 >> 24))));
  const unsigned mb = (static_cast<unsigned>(m) & 0xffu) * 0x01010101u;
  int k = 0;
  unsigned hit = 0;
  for (; k < nw; ++k) {
    hit = __vcmpeq4(__funnelshift_r(w[k], w[k + 1], sh), mb);
    if (hit) break;
  }
  if (!hit) hit = __vcmpeq4(last, mb);
  best = m;
  index = 4 * k + (__ffs(hit) - 1) / 8;
}

// The box of a unit from its four sigmoids, conf from obj and the class's.
__device__ __forceinline__ void write_unit(const DecodeArgs& a, int l,
                                           int local, long long o,
                                           const float (&s)[5], float cls_sig,
                                           int ci, float* __restrict__ boxes,
                                           float* __restrict__ conf,
                                           int* __restrict__ cls) {
  const int cell = local / a.A, an = local - cell * a.A;
  const int gy = cell / a.W[l], gx = cell - gy * a.W[l];
  float v[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    v[k] = __fmul_rn(s[k], 2.0f);
    if (k < 2)
      v[k] = __fmul_rn(__fadd_rn(__fadd_rn(v[k], -0.5f),
                                 __int2float_rn(k == 0 ? gx : gy)),
                       a.stride[l]);
    else
      v[k] = __fmul_rn(__fmul_rn(v[k], v[k]), a.anchor[l][an][k - 2]);
  }
  *reinterpret_cast<float4*>(boxes + 4 * o) = make_float4(v[0], v[1], v[2],
                                                          v[3]);
  conf[o] = __fmul_rn(s[4], cls_sig);
  cls[o] = ci;
}

// T: int8_t, float or __nv_bfloat16, the heads' element type
template <typename T>
__global__ void __launch_bounds__(kThreads)
    decode_fused_kernel(DecodeArgs a, float* __restrict__ boxes,
                        float* __restrict__ conf, int* __restrict__ cls) {
  constexpr bool I8 = sizeof(T) == 1;
  extern __shared__ __align__(16) unsigned char smem[];
  int l = 0;   // the block's level
  while (static_cast<int>(blockIdx.x) >= a.run_off[l + 1]) ++l;
  const int tid = threadIdx.x;
  const long long b = blockIdx.y;
  const int ub = (5 + a.NC) * static_cast<int>(sizeof(T));   // a unit
  const float sc = a.scale[l];
  const auto* head = static_cast<const unsigned char*>(a.feat[l]);
  float* tab = reinterpret_cast<float*>(smem);   // int8: sigmoid(i * sc)

  if (a.run == 0) {   // one unit, the whole block
    const int local = blockIdx.x - a.run_off[l];
    const unsigned char* p = head + (b * a.units[l] + local) * ub;
    const long long o = b * a.per_image + a.out_off[l] + local;
    int* red = reinterpret_cast<int*>(smem);
    float best;
    int ci;
    if (I8) {
      const int8_t* q = reinterpret_cast<const int8_t*>(p) + 5;
      int key = INT_MIN;   // logit * 65536 + 65535 - index: the first max
      for (int c = tid; c < a.NC; c += kThreads)
        key = max(key, static_cast<int>(q[c]) * 65536 + (65535 - c));
      key = __reduce_max_sync(kFull, key);
      if ((tid & 31) == 0) red[tid >> 5] = key;
      __syncthreads();
      if (tid != 0) return;
      for (int wi = 1; wi < kThreads / 32; ++wi) key = max(key, red[wi]);
      best = __int2float_rn(key >> 16);
      ci = 65535 - (key & 0xffff);
    } else {
      const T* q = reinterpret_cast<const T*>(p) + 5;
      float bv = -__int_as_float(0x7f800000);   // -inf
      int bi = INT_MAX;
      for (int c = tid; c < a.NC; c += kThreads) {
        const float v = head_value(q, c);
        if (first_max(v, c, bv, bi)) bv = v, bi = c;
      }
#pragma unroll
      for (int s = 16; s > 0; s >>= 1) {
        const float ov = __shfl_xor_sync(kFull, bv, s);
        const int oi = __shfl_xor_sync(kFull, bi, s);
        if (first_max(ov, oi, bv, bi)) bv = ov, bi = oi;
      }
      float* rv = reinterpret_cast<float*>(red + kThreads / 32);
      if ((tid & 31) == 0) red[tid >> 5] = bi, rv[tid >> 5] = bv;
      __syncthreads();
      if (tid != 0) return;
      for (int wi = 1; wi < kThreads / 32; ++wi)
        if (first_max(rv[wi], red[wi], bv, bi)) bv = rv[wi], bi = red[wi];
      best = bv;
      ci = bi;
    }
    float s[5];
#pragma unroll
    for (int k = 0; k < 5; ++k)
      s[k] = sigmoid_rn(__fmul_rn(head_value(reinterpret_cast<const T*>(p), k),
                                  sc));
    write_unit(a, l, local, o, s, sigmoid_rn(__fmul_rn(best, sc)), ci, boxes,
               conf, cls);
    return;
  }

  // a run of units, staged
  const int r0 = (blockIdx.x - a.run_off[l]) * a.run;
  const int nu = min(a.run, a.units[l] - r0);
  const uintptr_t base = reinterpret_cast<uintptr_t>(head);
  const uintptr_t start = base + (b * a.units[l] + r0) * ub;
  const uintptr_t end = start + static_cast<long long>(nu) * ub;
  const uintptr_t hend = base + a.bytes[l];
  const uintptr_t s16 = start & ~uintptr_t(15);
  unsigned char* stage = smem + (I8 ? kTableBytes : 0);
  const int chunks = static_cast<int>((end - s16 + 15) / 16);
  for (int k = tid; k < chunks; k += kThreads) {
    const uintptr_t src = s16 + 16 * static_cast<uintptr_t>(k);
    const long long left = static_cast<long long>(hend - src);
    tat::cp_async16(stage + 16 * k, reinterpret_cast<const void*>(src),
                    left < 16 ? static_cast<int>(left) : 16);
  }
  tat::cp_async_commit();
  if (I8)
    for (int i = tid; i < 256; i += kThreads)
      tab[i] = sigmoid_rn(__fmul_rn(__int2float_rn(i - 128), sc));
  tat::cp_async_wait<0>();
  __syncthreads();
  if (tid >= nu) return;
  const unsigned char* p = stage + (start - s16) + tid * ub;
  const int local = r0 + tid;
  const long long o = b * a.per_image + a.out_off[l] + local;
  float s[5], cls_sig;
  int ci;
  if (I8) {
    int best;
    class_max_s8(p + 5, a.NC, best, ci);
#pragma unroll
    for (int k = 0; k < 5; ++k)
      s[k] = tab[static_cast<int>(reinterpret_cast<const int8_t*>(p)[k]) +
                 128];
    cls_sig = tab[best + 128];
  } else {
    const T* f = reinterpret_cast<const T*>(p);
    float bv = -__int_as_float(0x7f800000);   // -inf
    int bi = INT_MAX;
    for (int c = 0; c < a.NC; ++c) {
      const float v = head_value(f, 5 + c);
      if (first_max(v, c, bv, bi)) bv = v, bi = c;
    }
    ci = bi;
#pragma unroll
    for (int k = 0; k < 5; ++k)
      s[k] = sigmoid_rn(__fmul_rn(head_value(f, k), sc));
    cls_sig = sigmoid_rn(__fmul_rn(bv, sc));
  }
  write_unit(a, l, local, o, s, cls_sig, ci, boxes, conf, cls);
}

}  // namespace

// feats/H/W/strides/scales: one entry per level; anchors: levels * A * 2
// floats (w, h). scales hold 1.0 for a head without one. elem: the heads'
// type, 0 f32, 1 int8, 2 bf16. f32 heads must be 4-byte aligned, bf16
// heads 2-byte; int8 heads may start at any byte. boxes 16-byte aligned.
extern "C" int tat_decode_fused(int levels, const void* const* feats,
                                const int* H, const int* W,
                                const float* strides, const float* scales,
                                const float* anchors, int batch, int A, int NC,
                                int elem, void* boxes, void* conf, void* cls,
                                void* stream) {
  if (levels < 1 || levels > kMaxLevels || A < 1 || A > kMaxAnchors ||
      NC < 1 || NC > 65535 || batch < 0 || batch > 65535 || elem < 0 ||
      elem > 2 || (reinterpret_cast<uintptr_t>(boxes) & 15u) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int esize = elem == 0 ? 4 : elem;   // bytes an element
  const int ub = (5 + NC) * esize;
  DecodeArgs a;
  a.levels = levels;
  a.A = A;
  a.NC = NC;
  a.run = (kStageBytes - kSlack) / ub;
  if (a.run > kThreads) a.run = kThreads;
  long long per_image = 0, runs = 0;
  for (int l = 0; l < levels; ++l) {
    if ((reinterpret_cast<uintptr_t>(feats[l]) & (esize - 1)) != 0)
      return static_cast<int>(cudaErrorInvalidValue);
    const long long units = static_cast<long long>(H[l]) * W[l] * A;
    a.feat[l] = feats[l];
    a.units[l] = static_cast<int>(units);
    a.bytes[l] = units * batch * ub;
    a.out_off[l] = static_cast<int>(per_image);
    a.run_off[l] = static_cast<int>(runs);
    a.W[l] = W[l];
    a.stride[l] = strides[l];
    a.scale[l] = scales[l];
    for (int j = 0; j < A; ++j) {
      a.anchor[l][j][0] = anchors[(l * A + j) * 2];
      a.anchor[l][j][1] = anchors[(l * A + j) * 2 + 1];
    }
    per_image += units;
    runs += a.run ? (units + a.run - 1) / a.run : units;
    if (per_image > INT_MAX || runs > INT_MAX)
      return static_cast<int>(cudaErrorInvalidValue);
  }
  for (int l = levels; l <= kMaxLevels; ++l) a.run_off[l] = static_cast<int>(runs);
  a.per_image = static_cast<int>(per_image);
  if (per_image == 0 || batch == 0) return 0;
  const int smem = a.run ? (elem == 1 ? kTableBytes : 0) + a.run * ub + kSlack
                         : 8 * kThreads / 32;
  const dim3 grid(static_cast<unsigned>(runs), static_cast<unsigned>(batch));
  const auto s = static_cast<cudaStream_t>(stream);
  auto* bp = static_cast<float*>(boxes);
  auto* cp = static_cast<float*>(conf);
  auto* kp = static_cast<int*>(cls);
  if (elem == 1)
    decode_fused_kernel<int8_t><<<grid, kThreads, smem, s>>>(a, bp, cp, kp);
  else if (elem == 2)
    decode_fused_kernel<__nv_bfloat16><<<grid, kThreads, smem, s>>>(a, bp, cp,
                                                                     kp);
  else
    decode_fused_kernel<float><<<grid, kThreads, smem, s>>>(a, bp, cp, kp);
  return static_cast<int>(cudaGetLastError());
}
