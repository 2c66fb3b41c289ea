// A CPU stand-in for the CUDA runtime, enough to compile the port's
// tensor-core kernels (chain_mma.cu, megakernel_probe.cu, add_one.cu,
// conv_int8_lagged.cu, conv_int8_requant_mma.cu, conv_int8_fused_mma.cu,
// mm_int8_fused_mma.cu, dw_int8_fused.cu, bneck_int8_fused.cu,
// sppf_int8_fused.cu) with g++ and run
// them on host memory: each block's threads are std::threads meeting at a
// std::barrier (__syncthreads), blocks run one after another, the dynamic
// shared memory is one static buffer. tests/test_torch_cuda_shim.py
// rewrites the sources for it (see there) and force-includes this file.
//
// The tensor-core and copy instructions are emulated from the PTX ISA's
// definitions, not from the kernels' use of them:
//   - cp.async copies are queued per thread and run only at the
//     cp.async.wait_group that covers their group (a missing wait shows);
//   - ldmatrix .x4/.x2: lane i gives the address of row i % 8 of matrix
//     i / 8; lane l receives, of matrix j, the 4 bytes at row l / 4,
//     bytes 4 (l % 4) ..;
//   - mma.sync m16n8k32 s8 and m16n8k16 bf16 gather the whole A, B and C
//     of the warp from every lane's fragment by the PTX fragment tables,
//     multiply, and hand each lane its D elements by the same tables.
// Warp collectives meet at a per-warp std::barrier. Named barriers
// (bar.sync / bar.arrive with a thread count) are one std::barrier of that
// count per id and block: bar.arrive arrives without waiting.
#pragma once

#include <algorithm>
#include <barrier>
#include <cmath>
#include <cstddef>
#include <cstdint>
#include <cstring>
#include <deque>
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
inline int2 make_int2(int x, int y) { return int2{x, y}; }
inline int4 make_int4(int x, int y, int z, int w) {
  return int4{x, y, z, w};
}
inline uint4 make_uint4(unsigned x, unsigned y, unsigned z, unsigned w) {
  return uint4{x, y, z, w};
}

inline thread_local dim3 threadIdx, blockIdx, blockDim, gridDim;

enum cudaError_t { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
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
};
inline ShimWarp shim_warps[32];
inline void shim_warp_sync() {
  shim_warp_bar[threadIdx.x / 32]->arrive_and_wait();
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

// bf16 m16n8k16: A a_i (i < 8) in register i / 2, half i % 2
inline void shim_mma_bf16(float* d, const unsigned* a, const unsigned* b) {
  const int lane = threadIdx.x % 32;
  ShimWarp& w = shim_warps[threadIdx.x / 32];
  for (int i = 0; i < 4; ++i) w.a[lane][i] = a[i], w.cf[lane][i] = d[i];
  for (int i = 0; i < 2; ++i) w.b[lane][i] = b[i];
  shim_warp_sync();
  float A[16][16], B[16][8], C[16][8];
  for (int l = 0; l < 32; ++l) {
    const int g = l / 4, t = l % 4;
    for (int i = 0; i < 8; ++i) {
      const int row = (i < 2 || (i >= 4 && i < 6)) ? g : g + 8;
      const int col = t * 2 + (i & 1) + (i >= 4 ? 8 : 0);
      A[row][col] = shim_bf16_to_float(
          static_cast<uint16_t>(w.a[l][i / 2] >> (16 * (i % 2))));
    }
    for (int i = 0; i < 4; ++i) {
      const int row = t * 2 + (i & 1) + (i >= 2 ? 8 : 0);
      B[row][g] = shim_bf16_to_float(
          static_cast<uint16_t>(w.b[l][i / 2] >> (16 * (i % 2))));
    }
    for (int i = 0; i < 4; ++i) C[g + (i >= 2 ? 8 : 0)][t * 2 + (i & 1)] = w.cf[l][i];
  }
  const int g = lane / 4, t = lane % 4;
  float out[4];
  for (int i = 0; i < 4; ++i) {
    const int row = g + (i >= 2 ? 8 : 0), col = t * 2 + (i & 1);
    double s = C[row][col];
    for (int k = 0; k < 16; ++k) s += static_cast<double>(A[row][k]) * B[k][col];
    out[i] = static_cast<float>(s);
  }
  shim_warp_sync();
  for (int i = 0; i < 4; ++i) d[i] = out[i];
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
        shim_block_bar = &bar;
        for (auto& b : shim_named) b.reset();
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
