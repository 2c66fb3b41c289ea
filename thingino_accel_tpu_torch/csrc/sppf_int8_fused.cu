// Fused SPPF tail, NHWC int8:
//   m1 = maxpool_kxk/1(y), m2 = maxpool(m1), m3 = maxpool(m2)  (pad -128)
//   out[N, H, W, O] = epilogue(concat(y, m1, m2, m3) @ w[O, 4C]^T)
//
// Replaces thingino_accel_tpu/ops/fused_kernels.py:sppf_int8_fused (Pallas
// body _sppf_kernel), which keeps the pool pyramid of a whole image in
// VMEM, pools in int32 (Mosaic has no int8 vector max) and sums four
// part-dots into one int32 accumulator before the epilogue. Here the
// pools stay int8: __vmaxs4 takes the signed max of four packed int8
// lanes, and a max of int8 values is the same in any width. Padding with
// -128 equals clipping the window to the image, since no int8 value is
// below it.
//
// What bounds it on the H100: SPPF runs on the smallest map (20 x 20 x
// 256 -> 512 for yolov5s at 640). Its MACs are those of a 1x1 with K = 4C;
// the pools are a few vector max per byte; the bytes are one read of y and
// one write of out. Design: one block per (64-pixel tile of one image,
// 64 output channels). For each chunk of 32 channels the block stages the
// tile's rows plus 3 * (k - 1) / 2 halo rows of y in shared memory, runs
// each pool level as a separable row pass and column pass, and after each
// level runs the dp4a tile product of that level's 32 channels with the
// matching 32 columns of w. Rows near the staged edge that are not the
// image's edge come out wrong and are never read: level i is read only
// (3 - i) * (k - 1) / 2 rows inside the staged window.
#include <cstdint>

#include <cuda_runtime.h>

#include "epilogue.cuh"

namespace {

struct SppfGeom {
  int H, W, C, O, k, tiles;
};

// word of channels [c, c + 4) of pixel `px` of one image [H*W, C]; bytes
// at or past C are 0 (their weights are 0 too)
template <bool VEC>
__device__ __forceinline__ unsigned load_px_word(const int8_t* __restrict__ x,
                                                 long long px, int C, int c) {
  const int8_t* r = x + px * C;
  if (VEC) return c < C ? *reinterpret_cast<const unsigned*>(r + c) : 0u;
  unsigned word = 0;
  for (int i = 0; i < 4 && c + i < C; ++i)
    word |= static_cast<unsigned>(static_cast<uint8_t>(r[c + i])) << (8 * i);
  return word;
}

// word of w[n, level * C + c .. + 4), zero past C within the level
template <bool VEC>
__device__ __forceinline__ int load_w_word(const int8_t* __restrict__ w,
                                           int n, int O, int C, int level,
                                           int c) {
  if (n >= O) return 0;
  const int8_t* r = w + static_cast<long long>(n) * 4 * C + level * C;
  if (VEC) return c < C ? *reinterpret_cast<const int*>(r + c) : 0;
  unsigned word = 0;
  for (int i = 0; i < 4 && c + i < C; ++i)
    word |= static_cast<unsigned>(static_cast<uint8_t>(r[c + i])) << (8 * i);
  return static_cast<int>(word);
}

template <bool VEC>
__global__ void __launch_bounds__(tat::kThreads)
    sppf_int8_fused_kernel(const int8_t* __restrict__ x,
                           const int8_t* __restrict__ w,
                           const int* __restrict__ bias,
                           const float* __restrict__ cs,
                           int8_t* __restrict__ out, SppfGeom g, int act,
                           float inv_out, float alpha) {
  extern __shared__ __align__(16) unsigned smw[];
  __shared__ int As[tat::kBM][tat::kBKW + 1];
  __shared__ int Bs[tat::kBN][tat::kBKW + 1];
  const int lw = threadIdx.x % tat::kBKW, lr = threadIdx.x / tat::kBKW;
  const long long img = blockIdx.x / g.tiles;
  const int tile = blockIdx.x % g.tiles;
  const int HW = g.H * g.W;
  const int p0 = tile * tat::kBM;
  const int npx = min(tat::kBM, HW - p0);
  const int n0 = blockIdx.y * tat::kBN;
  const int pk = (g.k - 1) / 2;
  const int r_lo = p0 / g.W, r_hi = (p0 + npx - 1) / g.W;
  const int s_lo = max(0, r_lo - 3 * pk), s_hi = min(g.H - 1, r_hi + 3 * pk);
  const int S = s_hi - s_lo + 1;
  const int plane = S * g.W * tat::kBKW;   // words of one staged level
  unsigned* buf0 = smw;
  unsigned* buf1 = smw + plane;
  unsigned* tmp = smw + 2 * plane;
  const int8_t* xi = x + img * HW * g.C;

  int acc[4][4] = {};
  for (int c0 = 0; c0 < g.C; c0 += tat::kBK) {
    for (int e = threadIdx.x; e < plane; e += tat::kThreads) {
      const int wd = e % tat::kBKW, pix = e / tat::kBKW;
      buf0[e] = load_px_word<VEC>(
          xi, static_cast<long long>(s_lo) * g.W + pix, g.C, c0 + 4 * wd);
    }
    __syncthreads();
    unsigned* cur = buf0;
    unsigned* nxt = buf1;
    for (int level = 0; level < 4; ++level) {
      if (level > 0) {
        // row pass: tmp = max over columns [col - pk, col + pk] of cur
        for (int e = threadIdx.x; e < plane; e += tat::kThreads) {
          const int col = (e / tat::kBKW) % g.W;
          unsigned v = cur[e];
          for (int d = 1; d <= pk; ++d) {
            if (col - d >= 0) v = __vmaxs4(v, cur[e - d * tat::kBKW]);
            if (col + d < g.W) v = __vmaxs4(v, cur[e + d * tat::kBKW]);
          }
          tmp[e] = v;
        }
        __syncthreads();
        // column pass: nxt = max over staged rows [row - pk, row + pk]
        const int row_words = g.W * tat::kBKW;
        for (int e = threadIdx.x; e < plane; e += tat::kThreads) {
          const int row = e / row_words;
          unsigned v = tmp[e];
          for (int d = 1; d <= pk; ++d) {
            if (row - d >= 0) v = __vmaxs4(v, tmp[e - d * row_words]);
            if (row + d < S) v = __vmaxs4(v, tmp[e + d * row_words]);
          }
          nxt[e] = v;
        }
        __syncthreads();
        unsigned* t = cur;
        cur = nxt;
        nxt = t;
      }
      // this level's 32 channels x the matching columns of w
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = lr + 32 * h;
        int a = 0;
        if (r < npx) {
          const int q = p0 + r;
          const int srow = q / g.W - s_lo, col = q % g.W;
          a = static_cast<int>(cur[(srow * g.W + col) * tat::kBKW + lw]);
        }
        As[r][lw] = a;
        Bs[r][lw] = load_w_word<VEC>(w, n0 + r, g.O, g.C, level, c0 + 4 * lw);
      }
      __syncthreads();
      tat::mma_tile(As, Bs, acc);
      __syncthreads();
    }
  }
  tat::store_tile(acc, out + (img * HW + p0) * g.O, 0, n0, npx, g.O, bias, cs,
                  act, inv_out, alpha);
}

template <bool VEC>
int launch(const dim3& grid, size_t smem, cudaStream_t s, const int8_t* x,
           const int8_t* w, const int* bias, const float* cs, int8_t* out,
           const SppfGeom& g, int act, float inv_out, float alpha) {
  // above 48 KB of shared memory in all (the static tiles included) a
  // kernel must opt in to the larger dynamic size
  if (smem + tat::kStaticSmem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        sppf_int8_fused_kernel<VEC>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  sppf_int8_fused_kernel<VEC><<<grid, tat::kThreads, smem, s>>>(
      x, w, bias, cs, out, g, act, inv_out, alpha);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int tat_sppf_int8_fused(const void* x, const void* w,
                                   const void* bias, const void* cs, void* out,
                                   int batch, int H, int W, int C, int O, int k,
                                   int act, float inv_out, float alpha,
                                   void* stream) {
  if (k % 2 == 0 || k < 1) return static_cast<int>(cudaErrorInvalidValue);
  SppfGeom g;
  g.H = H;
  g.W = W;
  g.C = C;
  g.O = O;
  g.k = k;
  g.tiles = (H * W + tat::kBM - 1) / tat::kBM;
  // staged rows: the rows a 64-pixel tile can span, plus the halo
  const int span = (tat::kBM + W - 2) / W + 1;
  const int S = span + 3 * (k - 1) < H ? span + 3 * (k - 1) : H;
  const size_t smem = 3 * static_cast<size_t>(S) * W * tat::kBKW * 4;
  const dim3 grid(static_cast<unsigned>(batch * g.tiles),
                  static_cast<unsigned>((O + tat::kBN - 1) / tat::kBN));
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* xp = static_cast<const int8_t*>(x);
  const auto* wp = static_cast<const int8_t*>(w);
  const auto* bp = static_cast<const int*>(bias);
  const auto* cp = static_cast<const float*>(cs);
  auto* op = static_cast<int8_t*>(out);
  if (C % 4 == 0 && tat::aligned4(x) && tat::aligned4(w))
    return launch<true>(grid, smem, s, xp, wp, bp, cp, op, g, act, inv_out,
                        alpha);
  return launch<false>(grid, smem, s, xp, wp, bp, cp, op, g, act, inv_out,
                       alpha);
}
