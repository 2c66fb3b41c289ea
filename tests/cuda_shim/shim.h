// A CPU stand-in for the CUDA runtime, enough to compile the port's
// tensor-core kernels (chain_mma.cu, megakernel_probe.cu, add_one.cu,
// conv_int8_lagged.cu, conv_int8_requant_mma.cu, conv_int8_fused_mma.cu,
// mm_int8_fused_mma.cu, dw_int8_fused.cu, bneck_int8_fused.cu,
// sppf_int8_fused.cu, decode_fused.cu) with g++ and run
// them on host memory: each block's threads are std::threads meeting at a
// std::barrier (__syncthreads), blocks run one after another, the dynamic
// shared memory is one static buffer. tests/test_torch_cuda_shim.py
// rewrites the sources for it (see there) and force-includes this file.
//
// The tensor-core and copy instructions are emulated from the PTX ISA's
// definitions, not from the kernels' use of them:
//   - cp.async copies are queued per thread and run only at the
//     cp.async.wait_group that covers their group (a missing wait shows);
//     one off its alignment aborts, as the card faults;
//   - ldmatrix .x4/.x2: lane i gives the address of row i % 8 of matrix
//     i / 8; lane l receives, of matrix j, the 4 bytes at row l / 4,
//     bytes 4 (l % 4) ..;
//   - mma.sync m16n8k32 s8 gathers the whole A, B and C of the warp from
//     every lane's fragment by the PTX fragment tables, multiplies, and
//     hands each lane its D elements by the same tables; mma.sync
//     m16n8k16 bf16 with f32 sums likewise, each output's 16 products
//     summed exactly and added to its f32 sum with one rounding;
//   - wgmma.mma_async s8 m64nNk32 and bf16 m64nNk16 with f32 sums
//     (hopper_async.cuh) is queued per thread like cp.async and runs at
//     the wgmma.wait_group that covers its group: the warpgroup's 128
//     threads meet, one of them reads A and B from shared memory through
//     their descriptors (start, LBO, SBO; a swizzled layout aborts: no
//     kernel uses one) and hands each thread its D elements by the ISA's
//     table (row 16 w + g + 8 h, column 8 j + 2 t + e for register 4 j +
//     2 h + e); a bf16 step's 16 products are summed exactly and added to
//     the f32 sum with one rounding;
//   - an mbarrier is a phase counter with its arrival count and
//     transaction bytes; a TMA load is queued on its mbarrier and copied
//     (zeros outside the tensor) when a thread first waits on that
//     barrier, so a missing wait reads stale bytes; cuTensorMapEncodeTiled
//     is a stand-in that keeps the map's fields; setmaxnreg and the fences
//     do nothing.
// Warp collectives (shuffles, __reduce_max_sync) meet at a per-warp
// std::barrier. Named barriers (bar.sync / bar.arrive with a thread count)
// are one std::barrier of that count per id and block: bar.arrive arrives
// without waiting.
#pragma once

#include <algorithm>
#include <barrier>
#include <chrono>
#include <cmath>
#include <cstddef>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <deque>
#include <map>
#include <memory>
#include <mutex>
#include <thread>
#include <vector>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __align__(x) alignas(x)
#define __grid_constant__

struct dim3 {
  unsigned x, y, z;
  dim3(unsigned x_ = 1, unsigned y_ = 1, unsigned z_ = 1) : x(x_), y(y_), z(z_) {}
};
struct uint4 {
  unsigned x, y, z, w;
};
struct alignas(8) uint2 {
  unsigned x, y;
};
struct alignas(8) int2 {
  int x, y;
};
struct alignas(16) int4 {
  int x, y, z, w;
};
struct alignas(16) float4 {
  float x, y, z, w;
};
struct alignas(8) float2 {
  float x, y;
};
inline int2 make_int2(int x, int y) { return int2{x, y}; }
inline int4 make_int4(int x, int y, int z, int w) {
  return int4{x, y, z, w};
}
inline uint4 make_uint4(unsigned x, unsigned y, unsigned z, unsigned w) {
  return uint4{x, y, z, w};
}
inline uint2 make_uint2(unsigned x, unsigned y) { return uint2{x, y}; }
inline float4 make_float4(float x, float y, float z, float w) {
  return float4{x, y, z, w};
}

inline thread_local dim3 threadIdx, blockIdx, blockDim, gridDim;

enum cudaError_t { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
// a tensor map: what cuTensorMapEncodeTiled was given (int8 elements)
struct CUtensorMap {
  const unsigned char* base;
  int rank;
  uint64_t dims[5], strides[5];
  uint32_t box[5];
};
enum cudaDeviceAttr { cudaDevAttrMaxSharedMemoryPerBlockOptin = 97 };
enum cudaFuncAttribute {
  cudaFuncAttributeMaxDynamicSharedMemorySize = 8,
  cudaFuncAttributePreferredSharedMemoryCarveout = 9
};
enum cudaSharedCarveout { cudaSharedmemCarveoutMaxShared = 100 };
using cudaStream_t = void*;

constexpr int kShimSmemOptin = 232448;   // an H100's opt-in limit
alignas(128) inline unsigned char shim_smem[kShimSmemOptin];
inline std::barrier<>* shim_block_bar = nullptr;
inline std::barrier<>* shim_warp_bar[32];
inline std::barrier<>* shim_wg_bar[8];

inline cudaError_t cudaGetLastError() { return cudaSuccess; }
inline cudaError_t cudaGetDevice(int* d) {
  *d = 0;
  return cudaSuccess;
}
inline cudaError_t cudaDeviceGetAttribute(int* v, cudaDeviceAttr, int) {
  *v = kShimSmemOptin;
  return cudaSuccess;
}
template <class F>
inline cudaError_t cudaFuncSetAttribute(F, cudaFuncAttribute, int v) {
  return v <= kShimSmemOptin ? cudaSuccess : cudaErrorInvalidValue;
}
// an H100 SM: 228 KB of shared memory, 1 KB of it kept for each block
template <class F>
inline cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(
    int* n, F, int, size_t smem) {
  *n = static_cast<int>(233472 / (smem + 1024));
  return cudaSuccess;
}

inline void __syncthreads() { shim_block_bar->arrive_and_wait(); }

// --- named barriers, made at first use in a block -------------------------
inline std::mutex shim_named_mu;
inline std::unique_ptr<std::barrier<>> shim_named[16];
inline std::barrier<>& shim_named_bar(int id, int count) {
  std::lock_guard<std::mutex> lock(shim_named_mu);
  if (!shim_named[id]) shim_named[id].reset(new std::barrier<>(count));
  return *shim_named[id];
}
inline void shim_bar_sync(int id, int count) {
  shim_named_bar(id, count).arrive_and_wait();
}
inline void shim_bar_arrive(int id, int count) {
  (void)shim_named_bar(id, count).arrive();
}
inline size_t __cvta_generic_to_shared(const void* p) {
  return static_cast<size_t>(static_cast<const unsigned char*>(p) - shim_smem);
}

inline float __fmul_rn(float a, float b) { return a * b; }
inline float __fadd_rn(float a, float b) { return a + b; }
inline float __fdiv_rn(float a, float b) { return a / b; }
inline float __int2float_rn(int v) { return static_cast<float>(v); }
inline int __float2int_rz(float v) { return static_cast<int>(v); }
inline unsigned __funnelshift_r(unsigned lo, unsigned hi, unsigned s) {
  return static_cast<unsigned>(
      ((static_cast<uint64_t>(hi) << 32) | lo) >> (s & 31));
}
inline float __fmaf_rn(float a, float b, float c) { return std::fma(a, b, c); }
inline int __float_as_int(float v) {
  int i;
  std::memcpy(&i, &v, 4);
  return i;
}
inline unsigned __umulhi(unsigned a, unsigned b) {
  return static_cast<unsigned>((static_cast<uint64_t>(a) * b) >> 32);
}
// Hopper's DPX three-way max of two signed int16 lanes (sppf_int8_fused.cu's
// pools)
inline unsigned __vimax3_s16x2(unsigned a, unsigned b, unsigned c) {
  unsigned r = 0;
  for (int i = 0; i < 2; ++i) {
    const int16_t x = static_cast<int16_t>(a >> (16 * i));
    const int16_t y = static_cast<int16_t>(b >> (16 * i));
    const int16_t z = static_cast<int16_t>(c >> (16 * i));
    const int16_t m = std::max(x, std::max(y, z));
    r |= static_cast<unsigned>(static_cast<uint16_t>(m)) << (16 * i);
  }
  return r;
}

// per-byte signed max and equality (0xff where equal) of four int8 lanes
inline unsigned __vmaxs4(unsigned a, unsigned b) {
  unsigned r = 0;
  for (int i = 0; i < 4; ++i) {
    const int8_t x = static_cast<int8_t>(a >> (8 * i));
    const int8_t y = static_cast<int8_t>(b >> (8 * i));
    r |= static_cast<unsigned>(static_cast<uint8_t>(std::max(x, y)))
         << (8 * i);
  }
  return r;
}
inline unsigned __vcmpeq4(unsigned a, unsigned b) {
  unsigned r = 0;
  for (int i = 0; i < 4; ++i)
    if (((a >> (8 * i)) & 0xffu) == ((b >> (8 * i)) & 0xffu))
      r |= 0xffu << (8 * i);
  return r;
}
using std::isnan;
inline int max(int a, int b) { return a > b ? a : b; }
inline int min(int a, int b) { return a < b ? a : b; }
inline int __ffs(unsigned v) { return v == 0 ? 0 : __builtin_ctz(v) + 1; }
inline float __int_as_float(int i) {
  float f;
  std::memcpy(&f, &i, 4);
  return f;
}
inline float __uint_as_float(unsigned i) {
  float f;
  std::memcpy(&f, &i, 4);
  return f;
}
inline unsigned __float_as_uint(float v) {
  unsigned i;
  std::memcpy(&i, &v, 4);
  return i;
}
// prmt's default mode: byte i of the result is byte (s >> 4 i) & 7 of
// {y, x} (x bytes 0-3, y bytes 4-7)
inline unsigned __byte_perm(unsigned x, unsigned y, unsigned s) {
  const uint64_t v = (static_cast<uint64_t>(y) << 32) | x;
  unsigned d = 0;
  for (int i = 0; i < 4; ++i)
    d |= static_cast<unsigned>((v >> (8 * ((s >> (4 * i)) & 7u))) & 0xffu)
         << (8 * i);
  return d;
}

// bf16: round to nearest even from float
struct __nv_bfloat16 {
  uint16_t bits;
};
struct __nv_bfloat162 {
  __nv_bfloat16 x, y;
};
inline __nv_bfloat16 __float2bfloat16_rn(float f) {
  uint32_t u;
  std::memcpy(&u, &f, 4);
  u += 0x7fffu + ((u >> 16) & 1u);
  return __nv_bfloat16{static_cast<uint16_t>(u >> 16)};
}
inline float shim_bf16_to_float(uint16_t b) {
  const uint32_t u = static_cast<uint32_t>(b) << 16;
  float f;
  std::memcpy(&f, &u, 4);
  return f;
}
inline float __bfloat162float(__nv_bfloat16 b) {
  return shim_bf16_to_float(b.bits);
}
inline __nv_bfloat162 __floats2bfloat162_rn(float lo, float hi) {
  return __nv_bfloat162{__float2bfloat16_rn(lo), __float2bfloat16_rn(hi)};
}

// --- cp.async, queued per thread ------------------------------------------
struct ShimCopy {
  void* dst;
  const void* src;
  int bytes, src_bytes;
};
inline thread_local std::vector<ShimCopy> shim_open;
inline thread_local std::deque<std::vector<ShimCopy>> shim_groups;
inline void shim_run(const std::vector<ShimCopy>& g) {
  for (const ShimCopy& c : g) {
    std::memset(c.dst, 0, c.bytes);
    std::memcpy(c.dst, c.src, c.src_bytes);
  }
}
inline void shim_cp_async(void* dst, const void* src, int bytes,
                          int src_bytes) {
  // the card faults on a 16-byte copy off 16-byte alignment
  if (((reinterpret_cast<uintptr_t>(dst) | reinterpret_cast<uintptr_t>(src)) &
       (bytes - 1)) != 0) {
    std::fprintf(stderr, "shim: cp.async of %d bytes off alignment\n", bytes);
    std::abort();
  }
  shim_open.push_back({dst, src, bytes, src_bytes});
}
inline void shim_commit() {
  shim_groups.push_back(std::move(shim_open));
  shim_open.clear();
}
inline void shim_wait_group(size_t keep) {
  while (shim_groups.size() > keep) {
    shim_run(shim_groups.front());
    shim_groups.pop_front();
  }
}

// --- warp collectives ------------------------------------------------------
struct ShimWarp {
  const void* addr[32];
  unsigned a[32][4], b[32][2];
  int ci[32][4];
  float cf[32][4];
  uint32_t v[32];
};
inline ShimWarp shim_warps[32];
inline void shim_warp_sync() {
  shim_warp_bar[threadIdx.x / 32]->arrive_and_wait();
}

// shuffles and reduces of 4-byte values (every lane of the warp takes part)
template <class T>
inline T shim_shfl_from(T v, int src_of_lane_mask, bool xor_mode) {
  static_assert(sizeof(T) == 4, "4-byte shuffles only");
  const int lane = threadIdx.x % 32;
  ShimWarp& w = shim_warps[threadIdx.x / 32];
  std::memcpy(&w.v[lane], &v, 4);
  shim_warp_sync();
  const int src = (xor_mode ? lane ^ src_of_lane_mask : src_of_lane_mask) & 31;
  T r;
  std::memcpy(&r, &w.v[src], 4);
  shim_warp_sync();
  return r;
}
template <class T>
inline T __shfl_xor_sync(unsigned, T v, int lane_mask) {
  return shim_shfl_from(v, lane_mask, true);
}
template <class T>
inline T __shfl_sync(unsigned, T v, int src) {
  return shim_shfl_from(v, src, false);
}
inline int __reduce_max_sync(unsigned, int v) {
  const int lane = threadIdx.x % 32;
  ShimWarp& w = shim_warps[threadIdx.x / 32];
  std::memcpy(&w.v[lane], &v, 4);
  shim_warp_sync();
  int m = static_cast<int>(w.v[0]);
  for (int i = 1; i < 32; ++i) m = std::max(m, static_cast<int>(w.v[i]));
  shim_warp_sync();
  return m;
}

inline void shim_ldsm(unsigned* r, int nmat, const void* p) {
  const int lane = threadIdx.x % 32;
  ShimWarp& w = shim_warps[threadIdx.x / 32];
  w.addr[lane] = p;
  shim_warp_sync();
  for (int j = 0; j < nmat; ++j) {
    const auto* row =
        static_cast<const unsigned char*>(w.addr[8 * j + lane / 4]);
    std::memcpy(&r[j], row + 4 * (lane % 4), 4);
  }
  shim_warp_sync();
}

// s8 m16n8k32: A a_i (i < 16) in register i / 4, byte i % 4
inline void shim_mma_s8(int* d, const unsigned* a, const unsigned* b) {
  const int lane = threadIdx.x % 32;
  ShimWarp& w = shim_warps[threadIdx.x / 32];
  for (int i = 0; i < 4; ++i) w.a[lane][i] = a[i], w.ci[lane][i] = d[i];
  for (int i = 0; i < 2; ++i) w.b[lane][i] = b[i];
  shim_warp_sync();
  int A[16][32], B[32][8], C[16][8];
  for (int l = 0; l < 32; ++l) {
    const int g = l / 4, t = l % 4;
    for (int i = 0; i < 16; ++i) {
      const int row = (i < 4 || (i >= 8 && i < 12)) ? g : g + 8;
      const int col = t * 4 + (i & 3) + (i >= 8 ? 16 : 0);
      A[row][col] = static_cast<int8_t>(w.a[l][i / 4] >> (8 * (i % 4)));
    }
    for (int i = 0; i < 8; ++i) {
      const int row = t * 4 + (i & 3) + (i >= 4 ? 16 : 0);
      B[row][g] = static_cast<int8_t>(w.b[l][i / 4] >> (8 * (i % 4)));
    }
    for (int i = 0; i < 4; ++i) C[g + (i >= 2 ? 8 : 0)][t * 2 + (i & 1)] = w.ci[l][i];
  }
  const int g = lane / 4, t = lane % 4;
  int out[4];
  for (int i = 0; i < 4; ++i) {
    const int row = g + (i >= 2 ? 8 : 0), col = t * 2 + (i & 1);
    int s = C[row][col];
    for (int k = 0; k < 32; ++k) s += A[row][k] * B[k][col];
    out[i] = s;
  }
  shim_warp_sync();
  for (int i = 0; i < 4; ++i) d[i] = out[i];
}

// bf16 m16n8k16 with f32 sums: A element i (i < 8) in register i / 2, half
// i % 2 (the low half the lower k): row g + 8 ((i / 2) & 1), k 2t + (i &
// 1) + 8 (i >= 4); B element i (i < 4) in register i / 2: k 2t + (i & 1) +
// 8 (i >= 2), column g; each output's 16 products summed exactly (in
// double: bf16 products have 16 significant bits) and added to its f32 sum
// with one rounding
inline void shim_mma_bf16(float* d, const unsigned* a, const unsigned* b) {
  const int lane = threadIdx.x % 32;
  ShimWarp& w = shim_warps[threadIdx.x / 32];
  for (int i = 0; i < 4; ++i) w.a[lane][i] = a[i], w.cf[lane][i] = d[i];
  for (int i = 0; i < 2; ++i) w.b[lane][i] = b[i];
  shim_warp_sync();
  double A[16][16], B[16][8];
  float C[16][8];
  for (int l = 0; l < 32; ++l) {
    const int g = l / 4, t = l % 4;
    for (int i = 0; i < 8; ++i) {
      const int row = g + 8 * ((i / 2) & 1), k = 2 * t + (i & 1) + 8 * (i >= 4);
      A[row][k] = shim_bf16_to_float(
          static_cast<uint16_t>(w.a[l][i / 2] >> (16 * (i % 2))));
    }
    for (int i = 0; i < 4; ++i) {
      const int k = 2 * t + (i & 1) + 8 * (i >= 2);
      B[k][g] = shim_bf16_to_float(
          static_cast<uint16_t>(w.b[l][i / 2] >> (16 * (i % 2))));
    }
    for (int i = 0; i < 4; ++i)
      C[g + (i >= 2 ? 8 : 0)][t * 2 + (i & 1)] = w.cf[l][i];
  }
  const int g = lane / 4, t = lane % 4;
  float out[4];
  for (int i = 0; i < 4; ++i) {
    const int row = g + (i >= 2 ? 8 : 0), col = t * 2 + (i & 1);
    double s = 0.0;
    for (int k = 0; k < 16; ++k) s += A[row][k] * B[k][col];
    out[i] = static_cast<float>(static_cast<double>(C[row][col]) + s);
  }
  shim_warp_sync();
  for (int i = 0; i < 4; ++i) d[i] = out[i];
}

// --- wgmma s8 m64nNk32 and bf16 m64nNk16, queued per thread, run at the
// covering wait -----------------------------------------------------------
struct ShimGmma {
  void* d;   // int[n / 2] (s8) or float[n / 2] (bf16)
  int n;
  uint64_t a, b;
  int scale_d;
  bool bf16;
};
inline thread_local std::vector<ShimGmma> shim_gmma_open;
inline thread_local std::deque<std::vector<ShimGmma>> shim_gmma_groups;
inline void* shim_wg_d[8][128];
inline void shim_wg_sync() { shim_wg_bar[threadIdx.x / 128]->arrive_and_wait(); }

// the shared-memory offset of byte kb of row `row` of a K-major operand of
// no swizzle
inline size_t shim_desc_at(uint64_t desc, int row, int kb) {
  if (desc >> 62) {
    std::fprintf(stderr, "shim: a swizzled wgmma operand is not emulated\n");
    std::abort();
  }
  const size_t start = (desc & 0x3FFFu) << 4;
  const size_t lbo = ((desc >> 16) & 0x3FFFu) << 4;
  const size_t sbo = ((desc >> 32) & 0x3FFFu) << 4;
  return start + (row / 8) * sbo + (row % 8) * 16 + (kb / 16) * lbo + kb % 16;
}
inline int shim_desc_s8(uint64_t desc, int row, int k) {
  return static_cast<int8_t>(shim_smem[shim_desc_at(desc, row, k)]);
}
inline double shim_desc_bf16(uint64_t desc, int row, int k) {
  uint16_t v;
  std::memcpy(&v, shim_smem + shim_desc_at(desc, row, 2 * k), 2);
  return shim_bf16_to_float(v);
}
inline void shim_gmma_run(const ShimGmma& op) {
  const int t = threadIdx.x % 128, wg = threadIdx.x / 128;
  shim_wg_d[wg][t] = op.d;
  shim_wg_sync();
  if (t == 0) {
    std::vector<double> P(64 * op.n);
    for (int m = 0; m < 64; ++m)
      for (int n = 0; n < op.n; ++n) {
        double s = 0;
        if (op.bf16) {   // 16 bf16 products, summed exactly, one rounding
          for (int k = 0; k < 16; ++k)
            s += shim_desc_bf16(op.a, m, k) * shim_desc_bf16(op.b, n, k);
        } else {
          for (int k = 0; k < 32; ++k)
            s += shim_desc_s8(op.a, m, k) * shim_desc_s8(op.b, n, k);
        }
        P[m * op.n + n] = s;
      }
    for (int th = 0; th < 128; ++th)
      for (int i = 0; i < op.n / 2; ++i) {
        const int lane = th % 32;
        const int m = 16 * (th / 32) + lane / 4 + 8 * ((i / 2) % 2);
        const int n = 8 * (i / 4) + 2 * (lane % 4) + (i % 2);
        if (op.bf16) {
          float& d = static_cast<float*>(shim_wg_d[wg][th])[i];
          d = static_cast<float>((op.scale_d ? d : 0.0) + P[m * op.n + n]);
        } else {
          int& d = static_cast<int*>(shim_wg_d[wg][th])[i];
          d = (op.scale_d ? d : 0) + static_cast<int>(P[m * op.n + n]);
        }
      }
  }
  shim_wg_sync();
}
inline void shim_wgmma_s8(int* d, int n, uint64_t a, uint64_t b, int sd) {
  shim_gmma_open.push_back({d, n, a, b, sd, false});
}
inline void shim_wgmma_bf16(float* d, int n, uint64_t a, uint64_t b, int sd) {
  shim_gmma_open.push_back({d, n, a, b, sd, true});
}
inline void shim_wgmma_commit() {
  shim_gmma_groups.push_back(std::move(shim_gmma_open));
  shim_gmma_open.clear();
}
inline void shim_wgmma_wait(size_t keep) {
  while (shim_gmma_groups.size() > keep) {
    for (const ShimGmma& op : shim_gmma_groups.front()) shim_gmma_run(op);
    shim_gmma_groups.pop_front();
  }
}

// --- mbarriers and TMA loads ------------------------------------------------
struct ShimTma {
  unsigned char* dst;
  CUtensorMap map;
  int c[5];
};
struct ShimMbar {
  int count = 0, pending = 0;
  long long tx = 0;
  unsigned phase = 0;
  std::vector<ShimTma> copies;
};
inline std::mutex shim_mbar_mu;
inline std::map<size_t, ShimMbar> shim_mbars;
inline ShimMbar& shim_mbar(const void* bar) {
  return shim_mbars[__cvta_generic_to_shared(bar)];
}
inline void shim_mbar_settle(ShimMbar& m) {
  if (m.pending == 0 && m.tx == 0) {
    ++m.phase;
    m.pending = m.count;
  }
}
inline void shim_mbar_init(void* bar, int count) {
  std::lock_guard<std::mutex> lock(shim_mbar_mu);
  ShimMbar& m = shim_mbar(bar);
  m = ShimMbar();
  m.count = m.pending = count;
}
inline void shim_mbar_arrive(void* bar, int tx_bytes) {
  std::lock_guard<std::mutex> lock(shim_mbar_mu);
  ShimMbar& m = shim_mbar(bar);
  m.tx += tx_bytes;
  --m.pending;
  shim_mbar_settle(m);
}
inline void shim_cu_tensor_map(CUtensorMap* map, const void* base, int rank,
                               const uint64_t* dims, const uint64_t* strides,
                               const uint32_t* box) {
  map->base = static_cast<const unsigned char*>(base);
  map->rank = rank;
  for (int i = 0; i < rank; ++i) {
    map->dims[i] = dims[i];
    map->box[i] = box[i];
    map->strides[i] = i + 1 < rank ? strides[i] : 0;
  }
}
inline void shim_tma_load(void* dst, const CUtensorMap* map, const int* c,
                          void* bar) {
  std::lock_guard<std::mutex> lock(shim_mbar_mu);
  ShimTma t{static_cast<unsigned char*>(dst), *map, {0, 0, 0, 0, 0}};
  for (int i = 0; i < map->rank; ++i) t.c[i] = c[i];
  shim_mbar(bar).copies.push_back(t);
}
// the box, innermost dimension first, packed at dst; returns its bytes
inline long long shim_tma_run(const ShimTma& t) {
  const CUtensorMap& m = t.map;
  long long total = 1;
  for (int i = 0; i < m.rank; ++i) total *= m.box[i];
  for (long long e = 0; e < total; ++e) {
    long long rest = e, src = 0;
    bool in = true;
    for (int i = 0; i < m.rank; ++i) {
      const long long g = t.c[i] + rest % m.box[i];
      rest /= m.box[i];
      in = in && g >= 0 && g < static_cast<long long>(m.dims[i]);
      src += i == 0 ? g : g * static_cast<long long>(m.strides[i - 1]);
    }
    t.dst[e] = in ? m.base[src] : 0;
  }
  return total;
}
inline void shim_mbar_wait(void* bar, int parity) {
  const auto t0 = std::chrono::steady_clock::now();
  for (;;) {
    {
      std::lock_guard<std::mutex> lock(shim_mbar_mu);
      ShimMbar& m = shim_mbar(bar);
      for (const ShimTma& t : m.copies) m.tx -= shim_tma_run(t);
      if (!m.copies.empty()) shim_mbar_settle(m);
      m.copies.clear();
      if (static_cast<int>(m.phase & 1u) != parity) return;
    }
    if (std::chrono::steady_clock::now() - t0 > std::chrono::seconds(60)) {
      std::fprintf(stderr, "shim: an mbarrier wait never ended\n");
      std::abort();
    }
    std::this_thread::yield();
  }
}

// --- the launch ------------------------------------------------------------
template <class... P, class... A>
void shim_launch(void (*kernel)(P...), dim3 grid, dim3 block, size_t smem,
                 cudaStream_t, A... args) {
  const unsigned nt = block.x * block.y * block.z;
  for (unsigned bz = 0; bz < grid.z; ++bz)
    for (unsigned by = 0; by < grid.y; ++by)
      for (unsigned bx = 0; bx < grid.x; ++bx) {
        std::barrier<> bar(nt);
        std::vector<std::unique_ptr<std::barrier<>>> warps;
        for (unsigned wi = 0; wi < (nt + 31) / 32; ++wi) {
          warps.emplace_back(new std::barrier<>(
              std::min<unsigned>(32, nt - 32 * wi)));
          shim_warp_bar[wi] = warps.back().get();
        }
        std::vector<std::unique_ptr<std::barrier<>>> wgs;
        for (unsigned g = 0; g < (nt + 127) / 128; ++g) {
          wgs.emplace_back(new std::barrier<>(
              std::min<unsigned>(128, nt - 128 * g)));
          shim_wg_bar[g] = wgs.back().get();
        }
        shim_block_bar = &bar;
        for (auto& b : shim_named) b.reset();
        shim_mbars.clear();
        std::memset(shim_smem, 0xA5, smem);   // no stale zeros to lean on
        std::vector<std::thread> ts;
        for (unsigned t = 0; t < nt; ++t)
          ts.emplace_back([&, t] {
            threadIdx = dim3(t % block.x, (t / block.x) % block.y,
                             t / (block.x * block.y));
            blockIdx = dim3(bx, by, bz);
            blockDim = block;
            gridDim = grid;
            kernel(args...);
            shim_wait_group(0);
          });
        for (auto& th : ts) th.join();
      }
}
