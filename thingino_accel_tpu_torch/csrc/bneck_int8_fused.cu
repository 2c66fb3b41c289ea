// Fused C3 bottleneck, NHWC int8:
//   m   = epilogue1(x[N, H, W, C] @ w1[CM, C]^T)                (1x1)
//   out = epilogue2(conv_KxK/1(m, w2 OHWI [O, K, K, CM]) [, + x])
// with SAME zero padding of m, K odd, the intermediate m never in device
// memory.
//
// Replaces thingino_accel_tpu/ops/fused_kernels.py:bottleneck_int8_fused
// (Pallas body _bneck_kernel), which computes the 1x1 over a row tile plus
// its K-1 halo rows in VMEM, masks positions outside the image to the
// quantized zero (not epilogue(bias): the KxK conv pads m with zeros),
// runs the KxK taps on the live value and adds the shortcut from the same
// x slab. The W fold and the 128-lane padding are TPU layout and are left
// out.
//
// What bounds it on the H100: the pair's MACs are 9x those of the 1x1, and
// without the fusion m makes a round trip through device memory (write,
// then read once per tap row); with it, one x read and one out write per
// pixel. Design: one block per (image, tile of TH output rows, 64 output
// channels). Stage 1 runs the 1x1 as dp4a tiles over the in-image rows of
// the halo'd tile (contiguous rows of x) and writes m as int8 into dynamic
// shared memory ((TH + K - 1) x W x CM bytes); the blocks of one row tile
// each recompute it, since stage 2 needs all CM channels and the 1x1 is
// the cheap half. Stage 2 is an implicit GEMM over the taps whose A words
// are gathered from shared memory; rows and columns outside the image
// read as 0, the quantized zero. The shortcut reads x at the output pixel
// in the second epilogue. TH is chosen by the wrapper
// (fused_kernels.bneck_tile_rows).
#include <cstdint>

#include <cuda_runtime.h>

#include "epilogue.cuh"

namespace {

struct BneckGeom {
  int H, W, C, CM, O, K, TH;
};

// One im2col word of stage 2: 4 consecutive k (ordered ky, kx, cm) of the
// output pixel at (tile row oy, column ox), read from m in shared memory;
// 0 outside the image. `sm` holds image rows [r0 - hh, r0 + TH + hh).
template <bool VEC>
__device__ __forceinline__ int gather_m(const int8_t* __restrict__ sm,
                                        const BneckGeom& g, int r0, bool ok,
                                        int oy, int ox, int k, int K2) {
  if (!ok) return 0;
  const int hh = (g.K - 1) / 2;
  if (VEC) {
    if (k >= K2) return 0;
    const int tap = k / g.CM, c = k - tap * g.CM;
    const int ky = tap / g.K, kx = tap - ky * g.K;
    const int iy = r0 + oy + ky - hh, ix = ox + kx - hh;
    if (iy < 0 || iy >= g.H || ix < 0 || ix >= g.W) return 0;
    const int srow = iy - (r0 - hh);
    return *reinterpret_cast<const int*>(
        sm + (static_cast<long long>(srow) * g.W + ix) * g.CM + c);
  }
  unsigned word = 0;
  for (int i = 0; i < 4 && k + i < K2; ++i) {
    const int kk = k + i;
    const int tap = kk / g.CM, c = kk - tap * g.CM;
    const int ky = tap / g.K, kx = tap - ky * g.K;
    const int iy = r0 + oy + ky - hh, ix = ox + kx - hh;
    if (iy < 0 || iy >= g.H || ix < 0 || ix >= g.W) continue;
    const int srow = iy - (r0 - hh);
    const int8_t v = sm[(static_cast<long long>(srow) * g.W + ix) * g.CM + c];
    word |= static_cast<unsigned>(static_cast<uint8_t>(v)) << (8 * i);
  }
  return static_cast<int>(word);
}

template <bool VEC>
__global__ void __launch_bounds__(tat::kThreads)
    bneck_int8_fused_kernel(const int8_t* __restrict__ x,
                            const int8_t* __restrict__ w1,
                            const int* __restrict__ b1,
                            const float* __restrict__ cs1,
                            const int8_t* __restrict__ w2,
                            const int* __restrict__ b2,
                            const float* __restrict__ cs2,
                            int8_t* __restrict__ out, BneckGeom g, int act1,
                            float inv1, float alpha1, int act2, float inv2,
                            float alpha2, int shortcut, float res_scale) {
  extern __shared__ __align__(16) int8_t sm[];
  __shared__ int As[tat::kBM][tat::kBKW + 1];
  __shared__ int Bs[tat::kBN][tat::kBKW + 1];
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int lw = threadIdx.x % tat::kBKW, lr = threadIdx.x / tat::kBKW;
  const long long img = blockIdx.y;
  const int r0 = blockIdx.x * g.TH;
  const int hh = (g.K - 1) / 2;
  const long long img_px = img * g.H * g.W;

  // stage 1: m over the in-image rows [lo, hi) of the halo'd tile
  const int lo = max(0, r0 - hh), hi = min(g.H, r0 + g.TH + hh);
  const int8_t* xs = x + (img_px + static_cast<long long>(lo) * g.W) * g.C;
  const long long M1 = static_cast<long long>(hi - lo) * g.W;
  const long long sm_base = static_cast<long long>(lo - (r0 - hh)) * g.W;
  for (long long m0 = 0; m0 < M1; m0 += tat::kBM) {
    for (int n0 = 0; n0 < g.CM; n0 += tat::kBN) {
      int acc[4][4] = {};
      for (int k0 = 0; k0 < g.C; k0 += tat::kBK) {
        const int k = k0 + 4 * lw;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = lr + 32 * h;
          As[r][lw] = tat::load_row_word<VEC>(xs, m0 + r, M1, g.C, g.C, k);
          Bs[r][lw] = tat::load_row_word<VEC>(w1, n0 + r, g.CM, g.C, g.C, k);
        }
        __syncthreads();
        tat::mma_tile(As, Bs, acc);
        __syncthreads();
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = n0 + tx + 16 * j;
        if (n >= g.CM) continue;
        const int b = b1 != nullptr ? b1[n] : 0;
        const float c = cs1[n];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const long long p = m0 + ty + 16 * i;
          if (p < M1)
            sm[(sm_base + p) * g.CM + n] =
                tat::epilogue(acc[i][j], b, c, act1, inv1, alpha1);
        }
      }
    }
  }
  __syncthreads();

  // stage 2: the KxK taps over m, output rows [r0, r0 + rows), output
  // channels [n0, n0 + 64)
  const int n0 = blockIdx.z * tat::kBN;
  const int rows = min(g.TH, g.H - r0);
  const long long M2 = static_cast<long long>(rows) * g.W;
  const int K2 = g.K * g.K * g.CM;
  const long long out_px = img_px + static_cast<long long>(r0) * g.W;
  int8_t* out_t = out + out_px * g.O;
  const int8_t* res_t = shortcut ? x + out_px * g.C : nullptr;
  for (long long m0 = 0; m0 < M2; m0 += tat::kBM) {
    bool ok[2];
    int oy[2], ox[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long long q = m0 + lr + 32 * h;
      ok[h] = q < M2;
      oy[h] = ok[h] ? static_cast<int>(q / g.W) : 0;
      ox[h] = ok[h] ? static_cast<int>(q - static_cast<long long>(oy[h]) * g.W)
                    : 0;
    }
    int acc[4][4] = {};
    for (int k0 = 0; k0 < K2; k0 += tat::kBK) {
      const int k = k0 + 4 * lw;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = lr + 32 * h;
        As[r][lw] = gather_m<VEC>(sm, g, r0, ok[h], oy[h], ox[h], k, K2);
        Bs[r][lw] = tat::load_row_word<VEC>(w2, n0 + r, g.O, K2, K2, k);
      }
      __syncthreads();
      tat::mma_tile(As, Bs, acc);
      __syncthreads();
    }
    tat::store_tile(acc, out_t, m0, n0, M2, g.O, b2, cs2, act2, inv2, alpha2,
                    res_t, res_scale);
  }
}

template <bool VEC>
int launch(const dim3& grid, size_t smem, cudaStream_t s, const int8_t* x,
           const int8_t* w1, const int* b1, const float* cs1, const int8_t* w2,
           const int* b2, const float* cs2, int8_t* out, const BneckGeom& g,
           int act1, float inv1, float alpha1, int act2, float inv2,
           float alpha2, int shortcut, float res_scale) {
  // above 48 KB of shared memory in all (the static tiles included) a
  // kernel must opt in to the larger dynamic size
  if (smem + tat::kStaticSmem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        bneck_int8_fused_kernel<VEC>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  bneck_int8_fused_kernel<VEC><<<grid, tat::kThreads, smem, s>>>(
      x, w1, b1, cs1, w2, b2, cs2, out, g, act1, inv1, alpha1, act2, inv2,
      alpha2, shortcut, res_scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int tat_bneck_int8_fused(
    const void* x, const void* w1, const void* b1, const void* cs1,
    const void* w2, const void* b2, const void* cs2, void* out, int batch,
    int H, int W, int C, int CM, int O, int K, int TH, int act1, float inv1,
    float alpha1, int act2, float inv2, float alpha2, int shortcut,
    float res_scale, void* stream) {
  if (TH < 1 || K % 2 == 0 || (shortcut && C != O))
    return static_cast<int>(cudaErrorInvalidValue);
  BneckGeom g;
  g.H = H;
  g.W = W;
  g.C = C;
  g.CM = CM;
  g.O = O;
  g.K = K;
  g.TH = TH;
  const size_t smem =
      static_cast<size_t>(TH + K - 1) * static_cast<size_t>(W) * CM;
  const dim3 grid(static_cast<unsigned>((H + TH - 1) / TH),
                  static_cast<unsigned>(batch),
                  static_cast<unsigned>((O + tat::kBN - 1) / tat::kBN));
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* xp = static_cast<const int8_t*>(x);
  const auto* w1p = static_cast<const int8_t*>(w1);
  const auto* b1p = static_cast<const int*>(b1);
  const auto* c1p = static_cast<const float*>(cs1);
  const auto* w2p = static_cast<const int8_t*>(w2);
  const auto* b2p = static_cast<const int*>(b2);
  const auto* c2p = static_cast<const float*>(cs2);
  auto* op = static_cast<int8_t*>(out);
  if (C % 4 == 0 && CM % 4 == 0 && tat::aligned4(x) && tat::aligned4(w1) &&
      tat::aligned4(w2))
    return launch<true>(grid, smem, s, xp, w1p, b1p, c1p, w2p, b2p, c2p, op,
                        g, act1, inv1, alpha1, act2, inv2, alpha2, shortcut,
                        res_scale);
  return launch<false>(grid, smem, s, xp, w1p, b1p, c1p, w2p, b2p, c2p, op, g,
                       act1, inv1, alpha1, act2, inv2, alpha2, shortcut,
                       res_scale);
}
