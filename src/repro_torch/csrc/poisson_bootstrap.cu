// Poisson-bootstrap moment sums for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/poisson_bootstrap/
// kernel.py::_kernel (launched by poisson_bootstrap_moments_lanes).  For
// every group g and replicate b it computes
//
//     M[g, b, p] = sum_j feats_p(x[g, j], mask[g, j]) * Poisson1(hash3(seed_g, j, b))
//
// with feats = [m, m x, m x^2, m x^3, m x^4] and j the ABSOLUTE slot index.
// The (n x B) weight matrix is never stored: each thread regenerates its
// column from the counter hash (murmur3 finalizer + inverse-CDF Poisson(1)
// ladder, identical to kernels/prng.py) in registers.
//
// What bounds it on this card: integer ALU work.  Each (slot, replicate)
// pair costs about 30 integer operations (hash, shift, ladder compares and
// selects) against 5 multiply-adds, while the data moved is two floats per
// slot, so the kernel sits far right of the memory roofline; its bound is
// pairs * ops / (SMs * 64 INT32 lanes * clock).
//
// What the design does about it:
//  * only masked-in slots are hashed: a chunk whose mask is all zero skips
//    the loop, and masked-out slots skip the hash, so the work tracks the
//    live window of each group, not the width bucket it rides in;
//  * inactive groups (active[g] == 0) return at once and read as zeros;
//  * one block per (group, 128-replicate tile, 256-slot chunk) gives
//    G * ceil(B/128) * ceil(n/256) blocks, enough to fill 132 SMs even when
//    G * ceil(B/128) alone would not;
//  * the chunk's features are built once into shared memory and read as
//    broadcasts by the whole warp.
//
// Determinism: no atomics.  Each thread adds its chunk's products one slot
// at a time in ascending order, with separately rounded multiplies and adds
// (__fmul_rn/__fadd_rn: no contraction to FMA), and a second kernel adds the
// chunk partials in ascending chunk order.  This is the plain PyTorch
// version's order (kernels/poisson_bootstrap/ref.py), so the two agree bit
// for bit, and widening the slice only appends exact zeros.
//
// Built by kernels/poisson_bootstrap/ops.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// and called through ctypes (plain C entry point pb_launch below).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kChunk = 256;    // slots per chunk (ref.CHUNK)
constexpr int kTileB = 128;    // replicates per block, one per thread
constexpr int kMoments = 5;

__device__ __forceinline__ uint32_t mix32(uint32_t h) {
  h ^= h >> 16;
  h *= 0x7FEB352Du;
  h ^= h >> 15;
  h *= 0x846CA68Bu;
  h ^= h >> 16;
  return h;
}

// Inverse-CDF Poisson(1) draw from the top 24 bits, compared as f32 against
// the f32-rounded CDF ladder (the float literals round as np.float32 does).
__device__ __forceinline__ float poisson1(uint32_t h) {
  const float u = __fmul_rn(static_cast<float>(h >> 8), 5.9604644775390625e-08f);
  int w = (u >= static_cast<float>(0.36787944117144233))
        + (u >= static_cast<float>(0.7357588823428847))
        + (u >= static_cast<float>(0.9196986029286058))
        + (u >= static_cast<float>(0.9810118431238462))
        + (u >= static_cast<float>(0.9963401531726563))
        + (u >= static_cast<float>(0.9994058151824183))
        + (u >= static_cast<float>(0.9999167588507119))
        + (u >= static_cast<float>(0.9999897508033253))
        + (u >= static_cast<float>(0.9999988747974149))
        + (u >= static_cast<float>(0.9999998885745217));
  return static_cast<float>(w);
}

__global__ void __launch_bounds__(kTileB)
pb_chunk_kernel(const float* __restrict__ x, long long x_row,
                const float* __restrict__ mask, long long m_row,
                const long long* __restrict__ seeds,
                const int* __restrict__ active,
                float* __restrict__ partial, int n, int B, int n_chunks) {
  const int chunk = blockIdx.x;
  const int g = blockIdx.z;
  if (active[g] == 0) return;            // uniform over the block
  __shared__ float f[kMoments][kChunk];
  __shared__ int live;
  const int j0 = chunk * kChunk;
  if (threadIdx.x == 0) live = 0;
  __syncthreads();
  const float* xg = x + static_cast<long long>(g) * x_row;
  const float* mg = mask + static_cast<long long>(g) * m_row;
  for (int jj = threadIdx.x; jj < kChunk; jj += blockDim.x) {
    const int j = j0 + jj;
    float xv = 0.f, mv = 0.f;
    if (j < n) {
      xv = xg[j];
      mv = mg[j];
    }
    const float x2 = __fmul_rn(xv, xv);
    const float mx2 = __fmul_rn(mv, x2);
    f[0][jj] = mv;
    f[1][jj] = __fmul_rn(mv, xv);
    f[2][jj] = mx2;
    f[3][jj] = __fmul_rn(mx2, xv);
    f[4][jj] = __fmul_rn(mx2, x2);
    if (mv != 0.f) live = 1;             // every writer stores the same 1
  }
  __syncthreads();
  const int b = blockIdx.y * kTileB + threadIdx.x;
  if (b >= B) return;
  float acc[kMoments] = {0.f, 0.f, 0.f, 0.f, 0.f};
  if (live) {
    const uint32_t seed = static_cast<uint32_t>(seeds[g]);
    const uint32_t sc = (static_cast<uint32_t>(b) * 0x85EBCA77u) ^
                        (seed * 0xC2B2AE3Du);
    for (int jj = 0; jj < kChunk; ++jj) {
      // A zero mask zeroes every feature: adding its products changes no
      // bit (the sums never hold -0), so the hash is skipped.  The branch
      // is uniform across the warp (the slot is shared).
      if (f[0][jj] == 0.f) continue;
      const uint32_t row = static_cast<uint32_t>(j0 + jj);
      const float w = poisson1(mix32((row * 0x9E3779B1u) ^ sc));
#pragma unroll
      for (int p = 0; p < kMoments; ++p)
        acc[p] = __fadd_rn(acc[p], __fmul_rn(w, f[p][jj]));
    }
  }
  float* dst = partial +
      (static_cast<long long>(g) * n_chunks + chunk) * kMoments * B + b;
#pragma unroll
  for (int p = 0; p < kMoments; ++p) dst[static_cast<long long>(p) * B] = acc[p];
}

__global__ void pb_reduce_kernel(const float* __restrict__ partial,
                                 const int* __restrict__ active,
                                 float* __restrict__ out, int B,
                                 int n_chunks) {
  const int g = blockIdx.y;
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  float s[kMoments] = {0.f, 0.f, 0.f, 0.f, 0.f};
  if (active[g] != 0) {
    const float* src = partial + static_cast<long long>(g) * n_chunks * kMoments * B + b;
    for (int c = 0; c < n_chunks; ++c) {
#pragma unroll
      for (int p = 0; p < kMoments; ++p)
        s[p] = __fadd_rn(s[p], src[(static_cast<long long>(c) * kMoments + p) * B]);
    }
  }
  float* o = out + (static_cast<long long>(g) * B + b) * kMoments;
#pragma unroll
  for (int p = 0; p < kMoments; ++p) o[p] = s[p];
}

}  // namespace

// x, mask: (G, n) f32 rows at the given row strides (unit slot stride);
// seeds: (G,) int64 holding uint32 patterns; active: (G,) int32;
// partial: (G, ceil(n/256), 5, B) f32 scratch; out: (G, B, 5) f32.
// Returns cudaGetLastError() after both launches (0 on success).
extern "C" int pb_launch(const float* x, long long x_row, const float* mask,
                         long long m_row, const long long* seeds,
                         const int* active, float* partial, float* out, int G,
                         int n, int B, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n_chunks = (n + kChunk - 1) / kChunk;
  const dim3 grid1(n_chunks, (B + kTileB - 1) / kTileB, G);
  pb_chunk_kernel<<<grid1, kTileB, 0, s>>>(x, x_row, mask, m_row, seeds, active,
                                           partial, n, B, n_chunks);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid2((B + kTileB - 1) / kTileB, G);
  pb_reduce_kernel<<<grid2, kTileB, 0, s>>>(partial, active, out, B, n_chunks);
  return static_cast<int>(cudaGetLastError());
}
