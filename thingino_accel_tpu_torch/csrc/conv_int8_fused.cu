// Fused int8 KxK conv at any square stride, NHWC x OHWI -> NHWC:
// out[n, oy, ox, o] = epilogue(sum_{ky,kx,c} x[n, oy*s-pt+ky, ox*s-pl+kx, c]
//                                            * w[o, ky, kx, c])
// with zero padding outside the image.
//
// Replaces thingino_accel_tpu/ops/fused_kernels.py:conv2d_int8_halo_fused
// (Pallas body _halo_kernel), which stages a halo'd row slab in VMEM and
// sums KxK shifted sub-matmuls into one accumulator. The TPU-only parts
// are left out: the W-phase fold into channels (Mosaic has no strided
// slices) and the 128-lane channel padding. Here the conv also carries the
// thin-channel stem (6x6/s2 on 3 channels), which the JAX package sends
// to an XLA bf16 conv instead.
//
// What bounds it on the H100: the 3x3 convs read each input pixel K*K
// times; the stride-1 ones at 64..256 channels do ~9x more MACs per byte
// than the 1x1s and lean on the MAC rate, the C=3 stem is bound by its
// strided byte gathers. Design: an implicit GEMM with M = batch*OH*OW
// output pixels, N = O channels and K = KH*KW*C ordered (ky, kx, c) to
// match the NHWC input and the OHWI weights. Each thread decodes its two
// im2col rows once, then gathers 4 channels of one tap per word (one
// aligned 4-byte load when C % 4 == 0; the repeated reads of a pixel by
// neighbouring taps hit L1/L2). Accumulation is __dp4a into int32 in
// registers, then the shared epilogue and one int8 store.
#include <cstdint>

#include <cuda_runtime.h>

#include "epilogue.cuh"

namespace {

struct ConvGeom {
  long long M;  // batch * OH * OW
  int N;        // output channels
  int K;        // KH * KW * C
  int H, W, C, KW, stride, pt, pl, OH, OW;
};

// One im2col word: 4 consecutive k of output pixel row (img_base, iy0,
// ix0); zero outside the image or past K. VEC: C % 4 == 0, so the 4
// values share one tap and are adjacent in memory.
template <bool VEC>
__device__ __forceinline__ int gather_word(const int8_t* __restrict__ x,
                                           const ConvGeom& g, bool row_ok,
                                           long long img_base, int iy0,
                                           int ix0, int k) {
  if (!row_ok) return 0;
  if (VEC) {
    if (k >= g.K) return 0;
    const int tap = k / g.C, c = k - tap * g.C;
    const int ky = tap / g.KW, kx = tap - ky * g.KW;
    const int iy = iy0 + ky, ix = ix0 + kx;
    if (iy < 0 || iy >= g.H || ix < 0 || ix >= g.W) return 0;
    return *reinterpret_cast<const int*>(
        x + img_base + (static_cast<long long>(iy) * g.W + ix) * g.C + c);
  }
  unsigned word = 0;
  for (int i = 0; i < 4 && k + i < g.K; ++i) {
    const int kk = k + i;
    const int tap = kk / g.C, c = kk - tap * g.C;
    const int ky = tap / g.KW, kx = tap - ky * g.KW;
    const int iy = iy0 + ky, ix = ix0 + kx;
    if (iy < 0 || iy >= g.H || ix < 0 || ix >= g.W) continue;
    const int8_t v =
        x[img_base + (static_cast<long long>(iy) * g.W + ix) * g.C + c];
    word |= static_cast<unsigned>(static_cast<uint8_t>(v)) << (8 * i);
  }
  return static_cast<int>(word);
}

template <bool VEC>
__global__ void __launch_bounds__(tat::kThreads)
    conv_int8_fused_kernel(const int8_t* __restrict__ x,
                           const int8_t* __restrict__ w,
                           const int* __restrict__ bias,
                           const float* __restrict__ cs,
                           int8_t* __restrict__ out, ConvGeom g, int act,
                           float inv_out, float alpha) {
  __shared__ int As[tat::kBM][tat::kBKW + 1];
  __shared__ int Bs[tat::kBN][tat::kBKW + 1];
  const long long m0 = static_cast<long long>(blockIdx.x) * tat::kBM;
  const int n0 = blockIdx.y * tat::kBN;
  const int lw = threadIdx.x % tat::kBKW, lr = threadIdx.x / tat::kBKW;

  // the two output pixels this thread gathers for, fixed across K
  bool ok[2];
  long long base[2];
  int iy0[2], ix0[2];
  const long long ohw = static_cast<long long>(g.OH) * g.OW;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const long long m = m0 + lr + 32 * h;
    ok[h] = m < g.M;
    const long long img = ok[h] ? m / ohw : 0;
    const int rem = static_cast<int>(ok[h] ? m - img * ohw : 0);
    const int oy = rem / g.OW, ox = rem - oy * g.OW;
    base[h] = img * g.H * g.W * g.C;
    iy0[h] = oy * g.stride - g.pt;
    ix0[h] = ox * g.stride - g.pl;
  }

  int acc[4][4] = {};
  for (int k0 = 0; k0 < g.K; k0 += tat::kBK) {
    const int k = k0 + 4 * lw;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = lr + 32 * h;
      As[r][lw] = gather_word<VEC>(x, g, ok[h], base[h], iy0[h], ix0[h], k);
      Bs[r][lw] = tat::load_row_word<VEC>(w, n0 + r, g.N, g.K, k);
    }
    __syncthreads();
    tat::mma_tile(As, Bs, acc);
    __syncthreads();
  }
  tat::store_tile(acc, out, m0, n0, g.M, g.N, bias, cs, act, inv_out, alpha);
}

}  // namespace

extern "C" int tat_conv_int8_fused(const void* x, const void* w,
                                   const void* bias, const void* cs, void* out,
                                   int batch, int H, int W, int C, int O,
                                   int KH, int KW, int stride, int pt, int pl,
                                   int OH, int OW, int act, float inv_out,
                                   float alpha, void* stream) {
  ConvGeom g;
  g.M = static_cast<long long>(batch) * OH * OW;
  g.N = O;
  g.K = KH * KW * C;
  g.H = H;
  g.W = W;
  g.C = C;
  g.KW = KW;
  g.stride = stride;
  g.pt = pt;
  g.pl = pl;
  g.OH = OH;
  g.OW = OW;
  const dim3 grid(static_cast<unsigned>((g.M + tat::kBM - 1) / tat::kBM),
                  static_cast<unsigned>((O + tat::kBN - 1) / tat::kBN));
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* xp = static_cast<const int8_t*>(x);
  const auto* wp = static_cast<const int8_t*>(w);
  const auto* bp = static_cast<const int*>(bias);
  const auto* cp = static_cast<const float*>(cs);
  auto* op = static_cast<int8_t*>(out);
  if (C % 4 == 0 && tat::aligned4(x) && tat::aligned4(w))
    conv_int8_fused_kernel<true><<<grid, tat::kThreads, 0, s>>>(
        xp, wp, bp, cp, op, g, act, inv_out, alpha);
  else
    conv_int8_fused_kernel<false><<<grid, tat::kThreads, 0, s>>>(
        xp, wp, bp, cp, op, g, act, inv_out, alpha);
  return static_cast<int>(cudaGetLastError());
}
