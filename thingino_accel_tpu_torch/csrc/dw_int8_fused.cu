// Fused int8 depthwise conv at stride 1, NHWC x [KH, KW, C] -> NHWC:
// out[n, oy, ox, c] = epilogue(sum_{ky,kx} x[n, oy-pt+ky, ox-pl+kx, c]
//                                          * w[ky, kx, c])
// with zero (the quantized zero) outside the image.
//
// Replaces thingino_accel_tpu/ops/fused_kernels.py:depthwise_conv2d_int8_fused
// (Pallas body _dw_kernel), which stages a halo'd row slab in VMEM and runs
// each tap as a VPU multiply-add over 128-lane channel rows. The TPU-only
// parts are left out: the 128-lane channel padding and the row-tile
// heights chosen for VMEM.
//
// What bounds it on the H100: there is no contraction, so it is 2*KH*KW
// int ops per output byte over an int8 input read once from memory (the
// neighbouring taps' re-reads hit L1/L2): memory bound, far from the MAC
// rate. Design: one thread per (image, output pixel, 4-channel group),
// consecutive threads on consecutive channel groups, so a warp's loads of
// one tap are one contiguous run of the NHWC row; the image is blockIdx.y,
// so a thread's index math is 32-bit. Word path (C % 4 == 0,
// 4-byte aligned pointers): one char4 load of x and of w per tap and one
// char4 store; byte path otherwise. Accumulation is exact int32; the shared
// epilogue (epilogue.cuh) then requantizes each channel.
#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

#include "epilogue.cuh"

namespace {

struct DwGeom {
  int H, W, C, KH, KW, pt, pl, OH, OW;
  int groups;        // ceil(C / 4)
};

template <bool VEC>
__global__ void __launch_bounds__(256)
    dw_int8_fused_kernel(const int8_t* __restrict__ x,
                         const int8_t* __restrict__ w,
                         const int* __restrict__ bias,
                         const float* __restrict__ cs,
                         int8_t* __restrict__ out, DwGeom g, int act,
                         float inv_out, float alpha) {
  const int per_image = g.OH * g.OW * g.groups;
  const long long n = blockIdx.y;
  const int8_t* xn = x + n * g.H * g.W * g.C;
  int8_t* on = out + n * g.OH * g.OW * g.C;
  for (int idx = blockIdx.x * blockDim.x + threadIdx.x; idx < per_image;
       idx += gridDim.x * blockDim.x) {
    const int m = idx / g.groups;  // output pixel within the image
    const int c0 = 4 * (idx - m * g.groups);
    const int oy = m / g.OW, ox = m - oy * g.OW;
    const int nc = min(4, g.C - c0);

    int acc[4] = {0, 0, 0, 0};
    for (int ky = 0; ky < g.KH; ++ky) {
      const int iy = oy - g.pt + ky;
      if (iy < 0 || iy >= g.H) continue;
      for (int kx = 0; kx < g.KW; ++kx) {
        const int ix = ox - g.pl + kx;
        if (ix < 0 || ix >= g.W) continue;
        const int8_t* px = xn + (iy * g.W + ix) * g.C + c0;
        const int8_t* pw = w + (ky * g.KW + kx) * g.C + c0;
        if (VEC) {
          const char4 xv = *reinterpret_cast<const char4*>(px);
          const char4 wv = *reinterpret_cast<const char4*>(pw);
          acc[0] += static_cast<int>(xv.x) * wv.x;
          acc[1] += static_cast<int>(xv.y) * wv.y;
          acc[2] += static_cast<int>(xv.z) * wv.z;
          acc[3] += static_cast<int>(xv.w) * wv.w;
        } else {
          for (int j = 0; j < nc; ++j)
            acc[j] += static_cast<int>(px[j]) * pw[j];
        }
      }
    }

    int8_t q[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = c0 + j;
      q[j] = j < nc ? tat::epilogue(acc[j], bias != nullptr ? bias[c] : 0,
                                    cs[c], act, inv_out, alpha)
                    : int8_t{0};
    }
    int8_t* po = on + m * g.C + c0;
    if (VEC) {
      *reinterpret_cast<char4*>(po) = make_char4(q[0], q[1], q[2], q[3]);
    } else {
      for (int j = 0; j < nc; ++j) po[j] = q[j];
    }
  }
}

}  // namespace

extern "C" int tat_dw_int8_fused(const void* x, const void* w,
                                 const void* bias, const void* cs, void* out,
                                 int batch, int H, int W, int C, int KH,
                                 int KW, int pt, int pl, int OH, int OW,
                                 int act, float inv_out, float alpha,
                                 void* stream) {
  DwGeom g;
  g.H = H;
  g.W = W;
  g.C = C;
  g.KH = KH;
  g.KW = KW;
  g.pt = pt;
  g.pl = pl;
  g.OH = OH;
  g.OW = OW;
  g.groups = (C + 3) / 4;
  const long long per_image = static_cast<long long>(OH) * OW * g.groups;
  if (4 * per_image > INT_MAX || static_cast<long long>(H) * W * C > INT_MAX ||
      batch > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const int threads = 256;
  const long long blocks = (per_image + threads - 1) / threads;
  const dim3 grid(static_cast<unsigned>(blocks < (1LL << 30) ? blocks
                                                             : (1LL << 30)),
                  static_cast<unsigned>(batch));
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* xp = static_cast<const int8_t*>(x);
  const auto* wp = static_cast<const int8_t*>(w);
  const auto* bp = static_cast<const int*>(bias);
  const auto* cp = static_cast<const float*>(cs);
  auto* op = static_cast<int8_t*>(out);
  if (C % 4 == 0 && tat::aligned4(x) && tat::aligned4(w) && tat::aligned4(out))
    dw_int8_fused_kernel<true><<<grid, threads, 0, s>>>(
        xp, wp, bp, cp, op, g, act, inv_out, alpha);
  else
    dw_int8_fused_kernel<false><<<grid, threads, 0, s>>>(
        xp, wp, bp, cp, op, g, act, inv_out, alpha);
  return static_cast<int>(cudaGetLastError());
}
