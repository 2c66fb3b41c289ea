// The exact tier's int8 convs: a matmul and an NHWC implicit-GEMM conv,
// each ending in requant_exact (epilogue.cuh), one per-tensor combined
// scale, either RoundMode, RELU after the clamp.
//
// Replaces thingino_accel_tpu/ops/pallas_kernels.py:
// - matmul_int8_requant (Pallas body _mm_requant_kernel), kernel #9:
//   tat_mm_int8_requant, x [M, K] @ w [N, K]^T -> int8 [M, N];
// - conv2d_int8_halo (body _halo_kernel), kernel #10: tat_conv_int8_requant
//   at unit stride and dilation (the UNIT instantiation);
// - conv2d_int8's tap path, _tapconv_call (body _tapconv_kernel), kernel
//   #11: tat_conv_int8_requant at any stride (sh, sw) and dilation
//   (dh, dw), asymmetric pads included. On the TPU #11 first writes the
//   K*K shifted, strided copies of the input to HBM as a [T, M, C] stack
//   and walks the taps as a grid axis; here each thread gathers its
//   im2col words straight from the NHWC input, so that stack never exists.
//   It computes what #11 computes, not how.
//
// What bounds them on the H100: the same as the serving kernels they copy
// (mm_int8_fused.cu, conv_int8_fused.cu): the 1x1 convs move bytes (K and
// N at most 512), the 3x3 ones lean on the dp4a MAC rate, the 6x6/s2 stem
// on its 3-channel byte gathers. Design: the serving kernels' 64 x 64
// tile, dp4a into int32 registers over K in 32-byte chunks staged through
// shared memory, then requant_exact and one int8 store. Tensor cores
// (wgmma), TMA and tuning are later work.
#include <cstdint>

#include <cuda_runtime.h>

#include "epilogue.cuh"

namespace {

// requant_exact over the thread's 4x4 sub-tile and the one int8 write into
// the row-major [M, N] output, masked at the ragged edges.
__device__ __forceinline__ void store_tile_exact(
    const int (&acc)[4][4], int8_t* __restrict__ out, long long m0, int n0,
    long long M, int N, const int* __restrict__ bias, float cs,
    int round_mode, bool relu) {
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int n = n0 + tx + 16 * j;
    if (n >= N) continue;
    const int b = bias != nullptr ? bias[n] : 0;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const long long m = m0 + ty + 16 * i;
      if (m >= M) continue;
      out[m * N + n] = tat::requant_exact(acc[i][j], b, cs, round_mode, relu);
    }
  }
}

template <bool VEC>
__global__ void __launch_bounds__(tat::kThreads)
    mm_int8_requant_kernel(const int8_t* __restrict__ x,
                           const int8_t* __restrict__ w,
                           const int* __restrict__ bias,
                           int8_t* __restrict__ out, long long M, int N, int K,
                           float cs, int round_mode, bool relu) {
  __shared__ int As[tat::kBM][tat::kBKW + 1];
  __shared__ int Bs[tat::kBN][tat::kBKW + 1];
  const long long m0 = static_cast<long long>(blockIdx.x) * tat::kBM;
  const int n0 = blockIdx.y * tat::kBN;
  const int lw = threadIdx.x % tat::kBKW, lr = threadIdx.x / tat::kBKW;
  int acc[4][4] = {};
  for (int k0 = 0; k0 < K; k0 += tat::kBK) {
    const int k = k0 + 4 * lw;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = lr + 32 * h;
      As[r][lw] = tat::load_row_word<VEC>(x, m0 + r, M, K, K, k);
      Bs[r][lw] = tat::load_row_word<VEC>(w, n0 + r, N, K, K, k);
    }
    __syncthreads();
    tat::mma_tile(As, Bs, acc);
    __syncthreads();
  }
  store_tile_exact(acc, out, m0, n0, M, N, bias, cs, round_mode, relu);
}

struct Geom {
  long long M;  // batch * OH * OW
  int N;        // output channels
  int K;        // KH * KW * C, ordered (ky, kx, c) like the OHWI weights
  int H, W, C, KW, sh, sw, dh, dw, pt, pl, OH, OW;
};

// One im2col word: 4 consecutive k of the output pixel whose window starts
// at (iy0, ix0) of image img_base; zero outside the image or past K. VEC:
// C % 4 == 0, so the 4 values share one tap and are adjacent in memory.
// UNIT: stride and dilation 1 (kernel #10), the tap offsets need no
// multiply.
template <bool VEC, bool UNIT>
__device__ __forceinline__ int gather_word(const int8_t* __restrict__ x,
                                           const Geom& g, bool row_ok,
                                           long long img_base, int iy0,
                                           int ix0, int k) {
  if (!row_ok) return 0;
  if (VEC) {
    if (k >= g.K) return 0;
    const int tap = k / g.C, c = k - tap * g.C;
    const int ky = tap / g.KW, kx = tap - ky * g.KW;
    const int iy = iy0 + (UNIT ? ky : ky * g.dh);
    const int ix = ix0 + (UNIT ? kx : kx * g.dw);
    if (iy < 0 || iy >= g.H || ix < 0 || ix >= g.W) return 0;
    return *reinterpret_cast<const int*>(
        x + img_base + (static_cast<long long>(iy) * g.W + ix) * g.C + c);
  }
  unsigned word = 0;
  for (int i = 0; i < 4 && k + i < g.K; ++i) {
    const int kk = k + i;
    const int tap = kk / g.C, c = kk - tap * g.C;
    const int ky = tap / g.KW, kx = tap - ky * g.KW;
    const int iy = iy0 + (UNIT ? ky : ky * g.dh);
    const int ix = ix0 + (UNIT ? kx : kx * g.dw);
    if (iy < 0 || iy >= g.H || ix < 0 || ix >= g.W) continue;
    const int8_t v =
        x[img_base + (static_cast<long long>(iy) * g.W + ix) * g.C + c];
    word |= static_cast<unsigned>(static_cast<uint8_t>(v)) << (8 * i);
  }
  return static_cast<int>(word);
}

template <bool VEC, bool UNIT>
__global__ void __launch_bounds__(tat::kThreads)
    conv_int8_requant_kernel(const int8_t* __restrict__ x,
                             const int8_t* __restrict__ w,
                             const int* __restrict__ bias,
                             int8_t* __restrict__ out, Geom g, float cs,
                             int round_mode, bool relu) {
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
    iy0[h] = (UNIT ? oy : oy * g.sh) - g.pt;
    ix0[h] = (UNIT ? ox : ox * g.sw) - g.pl;
  }

  int acc[4][4] = {};
  for (int k0 = 0; k0 < g.K; k0 += tat::kBK) {
    const int k = k0 + 4 * lw;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = lr + 32 * h;
      As[r][lw] =
          gather_word<VEC, UNIT>(x, g, ok[h], base[h], iy0[h], ix0[h], k);
      Bs[r][lw] = tat::load_row_word<VEC>(w, n0 + r, g.N, g.K, g.K, k);
    }
    __syncthreads();
    tat::mma_tile(As, Bs, acc);
    __syncthreads();
  }
  store_tile_exact(acc, out, m0, n0, g.M, g.N, bias, cs, round_mode, relu);
}

template <bool VEC>
void launch_conv(const dim3& grid, cudaStream_t s, const int8_t* x,
                 const int8_t* w, const int* bias, int8_t* out, const Geom& g,
                 float cs, int round_mode, bool relu) {
  if (g.sh == 1 && g.sw == 1 && g.dh == 1 && g.dw == 1)
    conv_int8_requant_kernel<VEC, true><<<grid, tat::kThreads, 0, s>>>(
        x, w, bias, out, g, cs, round_mode, relu);
  else
    conv_int8_requant_kernel<VEC, false><<<grid, tat::kThreads, 0, s>>>(
        x, w, bias, out, g, cs, round_mode, relu);
}

}  // namespace

extern "C" int tat_mm_int8_requant(const void* x, const void* w,
                                   const void* bias, void* out, long long M,
                                   int N, int K, float cs, int round_mode,
                                   int relu, void* stream) {
  const dim3 grid(static_cast<unsigned>((M + tat::kBM - 1) / tat::kBM),
                  static_cast<unsigned>((N + tat::kBN - 1) / tat::kBN));
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* xp = static_cast<const int8_t*>(x);
  const auto* wp = static_cast<const int8_t*>(w);
  const auto* bp = static_cast<const int*>(bias);
  auto* op = static_cast<int8_t*>(out);
  if (K % 4 == 0 && tat::aligned4(x) && tat::aligned4(w))
    mm_int8_requant_kernel<true><<<grid, tat::kThreads, 0, s>>>(
        xp, wp, bp, op, M, N, K, cs, round_mode, relu != 0);
  else
    mm_int8_requant_kernel<false><<<grid, tat::kThreads, 0, s>>>(
        xp, wp, bp, op, M, N, K, cs, round_mode, relu != 0);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int tat_conv_int8_requant(const void* x, const void* w,
                                     const void* bias, void* out, int batch,
                                     int H, int W, int C, int O, int KH,
                                     int KW, int sh, int sw, int dh, int dw,
                                     int pt, int pl, int OH, int OW, float cs,
                                     int round_mode, int relu, void* stream) {
  Geom g;
  g.M = static_cast<long long>(batch) * OH * OW;
  g.N = O;
  g.K = KH * KW * C;
  g.H = H;
  g.W = W;
  g.C = C;
  g.KW = KW;
  g.sh = sh;
  g.sw = sw;
  g.dh = dh;
  g.dw = dw;
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
  auto* op = static_cast<int8_t*>(out);
  if (C % 4 == 0 && tat::aligned4(x) && tat::aligned4(w))
    launch_conv<true>(grid, s, xp, wp, bp, op, g, cs, round_mode, relu != 0);
  else
    launch_conv<false>(grid, s, xp, wp, bp, op, g, cs, round_mode, relu != 0);
  return static_cast<int>(cudaGetLastError());
}
