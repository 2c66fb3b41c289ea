// YOLO head decode of every pyramid level in one launch: raw head rows
// [B*H*W, A*(5+NC)] (int8 with a dequant scale, or f32) of up to
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
// whose height must divide the row count. Here any row count is taken (the
// last warp's units are masked by the loop bound), so no level falls back
// to another decode; for f32 heads a NaN logit wins the class max as it
// does in jnp.argmax (the first NaN), where the Pallas kernel returned
// num_classes for an all-NaN row.
//
// What bounds it on the H100: it reads each head byte once and writes 24
// bytes per (cell, anchor), but a warp per unit issues many instructions
// for few bytes, so the instruction rate bounds it; the first version's
// three 64-bit index divisions per unit made it instruction-bound
// (PERF.md), so the image is blockIdx.y and the per-image index math is
// 32-bit. Design: one warp per (image, level, cell, anchor) unit; the
// lanes stride over the unit's class logits (coalesced), reduce
// (logit, index) to the first maximum with one __reduce_max_sync on a
// packed int key for int8 heads (logit * 65536 + 65535 - index: the same
// order as the JAX package's int16 packing, for any class count below
// 65536) or a shuffle tree with a NaN-aware order for f32; lanes 0-4 take
// the five box/objectness logits and lanes 0-3 write the box. The float
// steps are __fmul_rn/__fadd_rn/__fdiv_rn in the reference's order with
// full-precision expf, so nvcc cannot contract them into FMAs.
#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kMaxLevels = 4;
constexpr int kMaxAnchors = 8;
constexpr unsigned kFull = 0xffffffffu;

struct DecodeArgs {
  const void* feat[kMaxLevels];
  int off[kMaxLevels + 1];  // per-image unit offset of each level
  int H[kMaxLevels], W[kMaxLevels];
  float stride[kMaxLevels], scale[kMaxLevels];
  float anchor[kMaxLevels][kMaxAnchors][2];
  int levels, A, NC;
};

__device__ __forceinline__ float sigmoid_rn(float v) {
  return __fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-v)));
}

// (v, i) comes before (bv, bi) in the class order: NaN above every number,
// then larger values, ties to the lower index.
__device__ __forceinline__ bool first_max(float v, int i, float bv, int bi) {
  const bool vn = isnan(v), bn = isnan(bv);
  if (vn || bn) return vn && (!bn || i < bi);
  return v > bv || (v == bv && i < bi);
}

template <bool I8>
__device__ __forceinline__ float logit(const void* p, long long k) {
  if (I8) return __int2float_rn(static_cast<const int8_t*>(p)[k]);
  return static_cast<const float*>(p)[k];
}

template <bool I8>
__global__ void __launch_bounds__(256)
    decode_fused_kernel(DecodeArgs a, float* __restrict__ boxes,
                        float* __restrict__ conf, int* __restrict__ cls) {
  const int lane = threadIdx.x & 31;
  const int per_image = a.off[a.levels];
  const int warps = gridDim.x * (blockDim.x / 32);
  const int blk = 5 + a.NC;
  const long long b = blockIdx.y;
  for (int r = (blockIdx.x * blockDim.x + threadIdx.x) / 32; r < per_image;
       r += warps) {
    int l = 0;
    while (r >= a.off[l + 1]) ++l;
    const int local = r - a.off[l];
    const int cell = local / a.A;
    const int an = local - cell * a.A;
    const int gy = cell / a.W[l];
    const int gx = cell - gy * a.W[l];
    const long long base =
        (b * a.H[l] * a.W[l] + cell) * (a.A * blk) + an * blk;
    const long long u = b * per_image + r;  // output index
    const void* feat = a.feat[l];
    const float sc = a.scale[l];

    // best class logit and its first index
    float best;
    int ci;
    if (I8) {
      const int8_t* p = static_cast<const int8_t*>(feat) + base + 5;
      int key = INT_MIN;
      for (int c = lane; c < a.NC; c += 32)
        key = max(key, static_cast<int>(p[c]) * 65536 + (65535 - c));
      key = __reduce_max_sync(kFull, key);
      best = __int2float_rn(key >> 16);
      ci = 65535 - (key & 0xffff);
    } else {
      const float* p = static_cast<const float*>(feat) + base + 5;
      float bv = -__int_as_float(0x7f800000);  // -inf
      int bi = INT_MAX;
      for (int c = lane; c < a.NC; c += 32)
        if (first_max(p[c], c, bv, bi)) bv = p[c], bi = c;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        const float ov = __shfl_xor_sync(kFull, bv, o);
        const int oi = __shfl_xor_sync(kFull, bi, o);
        if (first_max(ov, oi, bv, bi)) bv = ov, bi = oi;
      }
      best = bv;
      ci = bi;
    }

    // the five box/objectness logits, one per lane
    float s = 0.0f;
    if (lane < 5) s = sigmoid_rn(__fmul_rn(logit<I8>(feat, base + lane), sc));
    const float obj = __shfl_sync(kFull, s, 4);
    if (lane < 4) {
      float v = __fmul_rn(s, 2.0f);
      if (lane < 2) {
        v = __fadd_rn(__fadd_rn(v, -0.5f),
                      __int2float_rn(lane == 0 ? gx : gy));
        v = __fmul_rn(v, a.stride[l]);
      } else {
        v = __fmul_rn(__fmul_rn(v, v), a.anchor[l][an][lane - 2]);
      }
      boxes[4 * u + lane] = v;
    }
    if (lane == 0) {
      conf[u] = __fmul_rn(obj, sigmoid_rn(__fmul_rn(best, sc)));
      cls[u] = ci;
    }
  }
}

}  // namespace

// feats/H/W/strides/scales: one entry per level; anchors: levels * A * 2
// floats (w, h). scales hold 1.0 for a head without one.
extern "C" int tat_decode_fused(int levels, const void* const* feats,
                                const int* H, const int* W,
                                const float* strides, const float* scales,
                                const float* anchors, int batch, int A, int NC,
                                int is_int8, void* boxes, void* conf, void* cls,
                                void* stream) {
  if (levels < 1 || levels > kMaxLevels || A < 1 || A > kMaxAnchors ||
      NC < 1 || NC > 65535 || batch < 0 || batch > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  DecodeArgs a;
  a.levels = levels;
  a.A = A;
  a.NC = NC;
  a.off[0] = 0;
  for (int l = 0; l < levels; ++l) {
    a.feat[l] = feats[l];
    a.H[l] = H[l];
    a.W[l] = W[l];
    a.stride[l] = strides[l];
    a.scale[l] = scales[l];
    for (int j = 0; j < A; ++j) {
      a.anchor[l][j][0] = anchors[(l * A + j) * 2];
      a.anchor[l][j][1] = anchors[(l * A + j) * 2 + 1];
    }
    const long long off = a.off[l] + static_cast<long long>(H[l]) * W[l] * A;
    if (off > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
    a.off[l + 1] = static_cast<int>(off);
  }
  for (int l = levels; l < kMaxLevels; ++l) a.off[l + 1] = a.off[l];
  if (a.off[levels] == 0 || batch == 0) return 0;
  const int threads = 256;  // 8 warps, one unit each per step
  long long blocks = (a.off[levels] + threads / 32 - 1) / (threads / 32);
  if (blocks > (1LL << 20)) blocks = 1LL << 20;
  const dim3 grid(static_cast<unsigned>(blocks), static_cast<unsigned>(batch));
  const auto s = static_cast<cudaStream_t>(stream);
  auto* bp = static_cast<float*>(boxes);
  auto* cp = static_cast<float*>(conf);
  auto* kp = static_cast<int*>(cls);
  if (is_int8)
    decode_fused_kernel<true><<<grid, threads, 0, s>>>(a, bp, cp, kp);
  else
    decode_fused_kernel<false><<<grid, threads, 0, s>>>(a, bp, cp, kp);
  return static_cast<int>(cudaGetLastError());
}
