// Segment kernels for Hopper (sm_90a): the grouped-block bootstrap and the
// exact GROUP BY aggregate.
//
// 1. Segment bootstrap (seg_boot_*).  Replaces the Pallas TPU kernel
//    src/repro/kernels/segment_agg/kernel.py::_boot_kernel (launched by
//    segment_boot_call).  Over one PACKED stream of lane windows it computes,
//    for every lane g and replicate b,
//
//        M[g, b, p] = sum_{j in lane g} feats_p(x_j, mask_j) * Poisson1(hash3(seed_j, slot_j, b))
//
//    with feats = [m, m x, m x^2] and slot_j the element's ABSOLUTE buffer
//    slot.  The TPU contracted a one-hot lane matrix on its matrix unit; here
//    it is a segmented reduction: each lane's elements are a contiguous,
//    slot-ascending run of the stream (the wrapper passes the lane offsets),
//    so nothing is one-hot and the partial sums are kept per (lane, chunk),
//    not per (stream chunk, lane), and do not grow with the lane count.
//
//    What bounds it on this card: integer ALU work, as in
//    poisson_bootstrap.cu: about 30 integer operations (hash, shifts, the
//    inverse-CDF ladder) per (valid element, replicate) against 3
//    multiply-adds, with 20 bytes read per element.  Bound = valid elements
//    * B * 30 / (132 SMs * 64 INT32 lanes * SM clock).
//
//    What the design does about it: one block per (lane, 128-replicate tile,
//    256-slot chunk); chunk c of lane g holds the lane's elements with slot
//    in [256c, 256c + 256), found by a binary search over the lane's
//    ascending slots, so an empty chunk costs one search and a store of
//    zeros.  Elements with mask 0 skip the hash.  The chunk's features,
//    slots and seeds are staged in shared memory and read as broadcasts by
//    the whole warp.
//
//    Order: within a chunk, products are added one element at a time in
//    stream order with __fmul_rn/__fadd_rn (no FMA contraction); a second
//    kernel adds a lane's chunk partials in ascending chunk order.  No
//    atomics.  This is poisson_bootstrap.cu's order for the same slots, so a
//    block lane's sums equal its solo run's bit for bit, and the plain
//    version (kernels/segment_agg/ref.py) matches the kernel bit for bit.
//
// 2. Exact aggregate (seg_agg_*).  Replaces src/repro/kernels/segment_agg/
//    kernel.py::_kernel (launched by segment_agg_call): per group g,
//    count/sum/sumsq/sum3/sum4 of mask-weighted powers of x, and min/max of
//    x over elements with mask > 0.
//
//    What bounds it on this card: bytes.  It reads gid, x and mask, 12 bytes
//    per element, and does ~15 flops on them.  Bound = 12 n / 3.35 TB/s.
//
//    What the design does about it: one pass, powers formed in registers
//    (no (8, n) feature array as the TPU built), any m in one launch (grid.y
//    tiles the groups, kGroupTile per block).  Each block takes a tile of
//    kAggTile elements; thread t adds its elements t, t + 128, ... (loads
//    coalesced across the warp) into its own column of per-group sums in
//    shared memory, so no two threads touch one address and there are no
//    atomics.  The 128 columns fold in a fixed order (lane l adds columns l,
//    l + 32, l + 64, l + 96, then the warp's xor butterfly); a second kernel
//    folds the tiles the same way.  Min and max are exact in any order.
//
// Built by kernels/segment_agg/ops.py (through kernels/nvcc.py) with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// and called through ctypes (plain C entry points at the end).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kChunk = 256;        // slots per summation chunk (ref.CHUNK)
constexpr int kTileB = 128;        // replicates per block, one per thread
constexpr int kTileN = 256;        // stream elements staged at once
constexpr int kMoments = 3;
constexpr int kAggThreads = 128;   // ref.AGG_THREADS
constexpr int kAggPerThread = 256; // ref.AGG_PER_THREAD
constexpr long long kAggTile = static_cast<long long>(kAggThreads) * kAggPerThread;
constexpr int kGroupTile = 12;     // groups per aggregate block: 7*12*128*4 B < 48 KB
constexpr int kStats = 5;          // count, sum, sumsq, sum3, sum4
constexpr int kOut = kStats + 2;   // + min, max
constexpr float kBig = 3.0e38f;
constexpr unsigned kFull = 0xFFFFFFFFu;

__device__ __forceinline__ uint32_t mix32(uint32_t h) {
  h ^= h >> 16;
  h *= 0x7FEB352Du;
  h ^= h >> 15;
  h *= 0x846CA68Bu;
  h ^= h >> 16;
  return h;
}

// Inverse-CDF Poisson(1) draw from the top 24 bits, compared as f32 against
// the f32-rounded CDF ladder (identical to poisson_bootstrap.cu).
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

// First index in [lo, hi) whose slot is >= v (slots ascending there).
__device__ long long lower_bound(const int* __restrict__ slot, long long lo,
                                 long long hi, long long v) {
  while (lo < hi) {
    const long long mid = lo + (hi - lo) / 2;
    if (static_cast<long long>(slot[mid]) < v) lo = mid + 1; else hi = mid;
  }
  return lo;
}

__global__ void __launch_bounds__(kTileB)
seg_boot_chunk_kernel(const float* __restrict__ x,
                      const float* __restrict__ mask,
                      const int* __restrict__ slot,
                      const long long* __restrict__ seed,
                      const long long* __restrict__ lane_off,
                      float* __restrict__ partial, int B, int n_chunks) {
  const int chunk = blockIdx.x;
  const int g = blockIdx.z;
  __shared__ long long range[2];
  __shared__ float f[kMoments][kTileN];
  __shared__ uint32_t sl[kTileN];
  __shared__ uint32_t sd[kTileN];
  if (threadIdx.x == 0) {
    const long long end = lane_off[g + 1];
    const long long lo = lower_bound(slot, lane_off[g], end,
                                     static_cast<long long>(chunk) * kChunk);
    range[0] = lo;
    range[1] = lower_bound(slot, lo, end,
                           static_cast<long long>(chunk + 1) * kChunk);
  }
  __syncthreads();
  const long long lo = range[0], hi = range[1];
  const int b = blockIdx.y * kTileB + threadIdx.x;
  const uint32_t sc = static_cast<uint32_t>(b) * 0x85EBCA77u;
  float acc[kMoments] = {0.f, 0.f, 0.f};
  for (long long t0 = lo; t0 < hi; t0 += kTileN) {
    const int cnt = static_cast<int>(hi - t0 < kTileN ? hi - t0 : kTileN);
    for (int jj = threadIdx.x; jj < cnt; jj += blockDim.x) {
      const long long j = t0 + jj;
      const float xv = x[j];
      const float mv = mask[j];
      const bool live = mv > 0.f;
      f[0][jj] = live ? mv : 0.f;
      f[1][jj] = live ? __fmul_rn(mv, xv) : 0.f;
      f[2][jj] = live ? __fmul_rn(mv, __fmul_rn(xv, xv)) : 0.f;
      sl[jj] = static_cast<uint32_t>(slot[j]);
      sd[jj] = static_cast<uint32_t>(seed[j]) * 0xC2B2AE3Du;
    }
    __syncthreads();
    if (b < B) {
      for (int jj = 0; jj < cnt; ++jj) {
        // A masked-out element adds exact zeros (the sums never hold -0),
        // so its hash is skipped.  The branch is uniform across the warp.
        if (f[0][jj] == 0.f) continue;
        const float w = poisson1(mix32((sl[jj] * 0x9E3779B1u) ^ sc ^ sd[jj]));
#pragma unroll
        for (int p = 0; p < kMoments; ++p)
          acc[p] = __fadd_rn(acc[p], __fmul_rn(w, f[p][jj]));
      }
    }
    __syncthreads();
  }
  if (b >= B) return;
  float* dst = partial +
      (static_cast<long long>(g) * n_chunks + chunk) * kMoments * B + b;
#pragma unroll
  for (int p = 0; p < kMoments; ++p) dst[static_cast<long long>(p) * B] = acc[p];
}

__global__ void seg_boot_reduce_kernel(const float* __restrict__ partial,
                                       float* __restrict__ out, int B,
                                       int n_chunks) {
  const int g = blockIdx.y;
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  float s[kMoments] = {0.f, 0.f, 0.f};
  const float* src = partial + static_cast<long long>(g) * n_chunks * kMoments * B + b;
  for (int c = 0; c < n_chunks; ++c) {
#pragma unroll
    for (int p = 0; p < kMoments; ++p)
      s[p] = __fadd_rn(s[p], src[(static_cast<long long>(c) * kMoments + p) * B]);
  }
  float* o = out + (static_cast<long long>(g) * B + b) * kMoments;
#pragma unroll
  for (int p = 0; p < kMoments; ++p) o[p] = s[p];
}

// Warp-wide fold of v: xor butterfly, the halving tree of ref._halving.
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int h = 16; h > 0; h >>= 1) v = __fadd_rn(v, __shfl_xor_sync(kFull, v, h));
  return v;
}
__device__ __forceinline__ float warp_min(float v) {
#pragma unroll
  for (int h = 16; h > 0; h >>= 1) v = fminf(v, __shfl_xor_sync(kFull, v, h));
  return v;
}
__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int h = 16; h > 0; h >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, h));
  return v;
}

// Shared memory rows (each kAggThreads floats, one column per thread):
// sums of stat s, group g at row s * mt + g; min of g at kStats * mt + g;
// max of g at (kStats + 1) * mt + g.
__global__ void __launch_bounds__(kAggThreads)
seg_agg_tile_kernel(const int* __restrict__ gid, const float* __restrict__ x,
                    const float* __restrict__ mask, long long n, int m,
                    float* __restrict__ tiles) {
  extern __shared__ float sm[];
  const int g0 = blockIdx.y * kGroupTile;
  const int mt = m - g0 < kGroupTile ? m - g0 : kGroupTile;
  const int t = threadIdx.x;
  for (int r = 0; r < kOut * mt; ++r)
    sm[r * kAggThreads + t] = r < kStats * mt ? 0.f
                            : (r < (kStats + 1) * mt ? kBig : -kBig);
  const long long base = static_cast<long long>(blockIdx.x) * kAggTile;
  for (int k = 0; k < kAggPerThread; ++k) {
    const long long i = base + static_cast<long long>(k) * kAggThreads + t;
    if (i >= n) break;
    const int gl = gid[i] - g0;
    if (gl < 0 || gl >= mt) continue;     // another tile's group, or none
    const float w = mask[i];
    if (w == 0.f) continue;               // adds exact zeros; not live
    const float xv = x[i];
    const float x2 = __fmul_rn(xv, xv);
    const float wx2 = __fmul_rn(w, x2);
    const float f[kStats] = {w, __fmul_rn(w, xv), wx2, __fmul_rn(wx2, xv),
                             __fmul_rn(wx2, x2)};
#pragma unroll
    for (int s = 0; s < kStats; ++s) {
      float* a = &sm[(s * mt + gl) * kAggThreads + t];
      *a = __fadd_rn(*a, f[s]);
    }
    if (w > 0.f) {
      float* a = &sm[(kStats * mt + gl) * kAggThreads + t];
      *a = fminf(*a, xv);
      a = &sm[((kStats + 1) * mt + gl) * kAggThreads + t];
      *a = fmaxf(*a, xv);
    }
  }
  __syncthreads();
  const int lane = t % 32;
  for (int r = t / 32; r < kOut * mt; r += kAggThreads / 32) {
    const float* col = sm + static_cast<long long>(r) * kAggThreads;
    float v;
    int stat, g;
    if (r < kStats * mt) {
      stat = r / mt;
      g = r % mt;
      v = 0.f;
#pragma unroll
      for (int j = 0; j < kAggThreads / 32; ++j) v = __fadd_rn(v, col[j * 32 + lane]);
      v = warp_sum(v);
    } else if (r < (kStats + 1) * mt) {
      stat = kStats;
      g = r - kStats * mt;
      v = col[lane];
#pragma unroll
      for (int j = 1; j < kAggThreads / 32; ++j) v = fminf(v, col[j * 32 + lane]);
      v = warp_min(v);
    } else {
      stat = kStats + 1;
      g = r - (kStats + 1) * mt;
      v = col[lane];
#pragma unroll
      for (int j = 1; j < kAggThreads / 32; ++j) v = fmaxf(v, col[j * 32 + lane]);
      v = warp_max(v);
    }
    if (lane == 0)
      tiles[(static_cast<long long>(blockIdx.x) * m + g0 + g) * kOut + stat] = v;
  }
}

// One warp per (group, stat): lane l folds tiles l, l + 32, ... in order,
// then the butterfly.  out is (kOut, m).
__global__ void seg_agg_final_kernel(const float* __restrict__ tiles,
                                     long long nb, int m,
                                     float* __restrict__ out) {
  const int row = blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= m * kOut) return;            // uniform over the warp
  const int g = row / kOut, stat = row % kOut;
  float v = stat < kStats ? 0.f : (stat == kStats ? kBig : -kBig);
  for (long long b = lane; b < nb; b += 32) {
    const float u = tiles[(b * m + g) * kOut + stat];
    v = stat < kStats ? __fadd_rn(v, u) : (stat == kStats ? fminf(v, u) : fmaxf(v, u));
  }
  v = stat < kStats ? warp_sum(v) : (stat == kStats ? warp_min(v) : warp_max(v));
  if (lane == 0) out[static_cast<long long>(stat) * m + g] = v;
}

}  // namespace

// x, mask: (L,) f32; slot: (L,) int32 ascending within each lane; seed: (L,)
// int64 holding uint32 patterns; lane_off: (q + 1,) int64, lane g owning
// [lane_off[g], lane_off[g + 1]); every slot < n_chunks * 256; partial:
// (q, n_chunks, 3, B) f32 scratch; out: (q, B, 3) f32.  Returns
// cudaGetLastError() after both launches (0 on success).
extern "C" int seg_boot_launch(const float* x, const float* mask,
                               const int* slot, const long long* seed,
                               const long long* lane_off, float* partial,
                               float* out, int q, int B, int n_chunks,
                               void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid1(n_chunks, (B + kTileB - 1) / kTileB, q);
  seg_boot_chunk_kernel<<<grid1, kTileB, 0, s>>>(x, mask, slot, seed, lane_off,
                                                 partial, B, n_chunks);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid2((B + kTileB - 1) / kTileB, q);
  seg_boot_reduce_kernel<<<grid2, kTileB, 0, s>>>(partial, out, B, n_chunks);
  return static_cast<int>(cudaGetLastError());
}

// gid: (n,) int32; x, mask: (n,) f32; tiles: (max(1, ceil(n / 32768)), m, 7)
// f32 scratch; out: (7, m) f32 rows count, sum, sumsq, sum3, sum4, min, max.
// Returns cudaGetLastError() after both launches (0 on success).
extern "C" int seg_agg_launch(const int* gid, const float* x, const float* mask,
                              long long n, int m, float* tiles, float* out,
                              void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  long long nb = (n + kAggTile - 1) / kAggTile;
  if (nb == 0) nb = 1;
  const int mt = m < kGroupTile ? m : kGroupTile;
  const dim3 grid1(static_cast<unsigned>(nb), (m + kGroupTile - 1) / kGroupTile);
  const size_t smem = static_cast<size_t>(kOut) * mt * kAggThreads * sizeof(float);
  seg_agg_tile_kernel<<<grid1, kAggThreads, smem, s>>>(gid, x, mask, n, m, tiles);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int warps = kAggThreads / 32;
  const int blocks = (m * kOut + warps - 1) / warps;
  seg_agg_final_kernel<<<blocks, kAggThreads, 0, s>>>(tiles, nb, m, out);
  return static_cast<int>(cudaGetLastError());
}
