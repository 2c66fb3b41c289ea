// The greedy NMS fixpoint on the device: up [B, K, K] bool, the strictly
// upper-triangular "i suppresses j" relation of each frame's score-sorted
// pool -> keep [B, K] bool, the fixpoint of
//
//   keep[j] = !any_i(up[i][j] && keep[i]),   keep = all true at first,
//
// stepped until no element changes, at most K steps.
//
// Replaces no TPU kernel. The JAX package runs this loop as a
// lax.while_loop (thingino_accel_tpu/models/yolo.py:854-877, vmapped over
// the frames) that XLA keeps on the device; the port's plain version steps
// the batch from the host and reads back whether anything changed after
// every step, a host sync a step. A loop whose trip count depends on the
// data cannot sit in a CUDA graph, and a fixed K-step unroll would put K
// steps of [B, K, K] tensor ops in every replay; this kernel runs the
// whole loop in one launch and never returns to the host.
//
// What bounds it on the H100: neither bytes nor operations (K * K bytes a
// frame read once, a few thousand bit operations a step) but the serial
// steps, each a pass over shared memory and two block barriers. Design:
// one block a frame, one thread a pool entry j (the block rounded up to
// whole warps, at most 1024). The frame's relation is read once, column j
// by thread j (a warp reads 32 neighbouring bytes of a row), into shared
// memory as bits, word w of column j at col[w * K + j] (bit t: row 32 w +
// t), so a step's reads are conflict free: K * ceil(K / 32) words, 2 KB at
// K = 128 and 8 KB at K = 256. keep is ceil(K / 32) words beside it, word
// w written by warp w from a __ballot_sync of its threads' new bits; each
// warp compares its word with the old one and __syncthreads_or ends the
// loop when no warp saw a change. Pure boolean logic: the result is the
// plain version's bit for bit.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxK = 1024;

__global__ void nms_fixpoint_kernel(const uint8_t* __restrict__ up,
                                    uint8_t* __restrict__ keep, int K) {
  extern __shared__ uint32_t smem[];
  const int words = (K + 31) / 32;
  uint32_t* col = smem;                 // [words][K]
  uint32_t* kw = smem + words * K;      // [words] the keep bits
  const int j = threadIdx.x;
  const int lane = j & 31;
  const int warp = j >> 5;
  const uint8_t* f = up + static_cast<size_t>(blockIdx.x) * K * K;
  if (j < K) {
    for (int w = 0; w < words; ++w) {
      const int i0 = w * 32;
      const int n = min(32, K - i0);
      uint32_t bits = 0;
      for (int t = 0; t < n; ++t)
        bits |= static_cast<uint32_t>(f[static_cast<size_t>(i0 + t) * K + j]
                                      != 0) << t;
      col[w * K + j] = bits;
    }
  }
  if (lane == 0) {   // every entry kept at first, no bit past K
    const int rest = K - warp * 32;
    kw[warp] = rest >= 32 ? 0xffffffffu : (1u << rest) - 1u;
  }
  __syncthreads();
  for (int step = 0; step < K; ++step) {
    uint32_t hit = 0;
    if (j < K)
      for (int w = 0; w < words; ++w) hit |= col[w * K + j] & kw[w];
    const uint32_t word = __ballot_sync(0xffffffffu, j < K && hit == 0);
    const bool changed = word != kw[warp];
    __syncthreads();   // every warp has read the old keep bits
    if (lane == 0) kw[warp] = word;
    if (!__syncthreads_or(changed)) break;
  }
  if (j < K)
    keep[static_cast<size_t>(blockIdx.x) * K + j] =
        static_cast<uint8_t>((kw[warp] >> lane) & 1u);
}

}  // namespace

// up: B * K * K bytes (0 or 1), keep: B * K bytes, both contiguous.
extern "C" int tat_nms_fixpoint(const void* up, void* keep, int batch, int K,
                                void* stream) {
  if (batch < 0 || K < 0 || K > kMaxK)
    return static_cast<int>(cudaErrorInvalidValue);
  if (batch == 0 || K == 0) return 0;
  const int words = (K + 31) / 32;
  const int smem = (words * K + words) * static_cast<int>(sizeof(uint32_t));
  if (smem > 48 * 1024) {
    // the card's whole opt-in, as every launcher of the package (a setting
    // of the kernel that every host thread shares)
    int dev = 0, max_smem = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(
          &max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err == cudaSuccess && smem > max_smem) err = cudaErrorInvalidValue;
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(nms_fixpoint_kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 max_smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  nms_fixpoint_kernel<<<batch, words * 32, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(up), static_cast<uint8_t*>(keep), K);
  return static_cast<int>(cudaGetLastError());
}
