// The device core shared by the two bootstrap kernels for Hopper (sm_90a):
// poisson_bootstrap.cu (replaces src/repro/kernels/poisson_bootstrap/
// kernel.py::_kernel) and the segment bootstrap of segment_agg.cu (replaces
// src/repro/kernels/segment_agg/kernel.py::_boot_kernel).
//
// Both compute, per group (or lane) g and replicate b,
//
//     M[g, b, p] = sum_j feat_p(j) * Poisson1(hash3(seed_j, slot_j, b))
//
// with slot_j an ABSOLUTE buffer slot, cut into 256-slot chunks.  The order
// of the sums is a contract between the two kernels and their plain
// versions (kernels/*/ref.py): a chunk's products are added one element at
// a time in stream order from 0 with __fmul_rn/__fadd_rn (no contraction),
// and a group's chunk partials in ascending chunk order from 0.  A grouped
// block's lane therefore equals its solo run bit for bit.
//
// What bounds both: instruction issue, not bytes.  Each (element,
// replicate) pair costs a hash, a Poisson(1) draw and one multiply and one
// add per moment, while an element moves 8-20 bytes for 300 replicates.
// What this core does about it:
//
//  * A chunk is staged once per block in shared memory: per element a key
//    premix(slot * 0x9E3779B1 ^ seed * 0xC2B2AE3D) and the features, zeroed
//    for a masked element, which then adds exact +0 (no sum holds -0) and
//    needs no branch.  The first xor-shift of the murmur3 finalizer is
//    linear over xor, so it is done once per element (premix) and once per
//    replicate, not once per pair: a pair costs one xor, two multiplies,
//    two xor-shifts and the ladder.
//  * The ladder without an int->float convert: the hash's top 24 bits v,
//    OR-ed under the exponent of 2^23, read as the float g(v) = 2^23 + v
//    (v < 2^23) or 2v (v >= 2^23), a strictly increasing map onto exact
//    floats.  u = v * 2^-24 >= c_k exactly when v >= K_k = ceil(c_k * 2^24)
//    (c_k the f32 CDF), i.e. when g(v) > g(K_k - 1), and each indicator is
//    one saturated subtract sat(g(v) - g(K_k - 1)) in {0, 1} on the 128-lane
//    FP32 pipe; the weight is their sum (kernels/prng.poisson1_from_bits is
//    the same arithmetic; the draws are the reference's).  The last five
//    steps are 0 unless v >= K_5 (probability 5.9e-4), so they run in a
//    warp-uniform branch, taken when any of the warp's 8 x 32 draws needs
//    them (about one iteration in seven).
//  * Eight elements' draws in flight per thread (independent hashes), then
//    their products added in order.
//  * The fold in the same kernel: each (group, replicate tile) has an int32
//    arrival counter; the block that arrives last adds the group's live
//    chunk partials in ascending order, eight chunks' loads in flight at a
//    time, writes the output and resets the counter to 0, so repeated
//    calls and CUDA-graph replays find it zeroed.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace boot {

constexpr int kChunk = 256;      // slots per summation chunk (ref.CHUNK)
constexpr int kUnroll = 8;       // elements whose draws are in flight at once
constexpr int kMaxWarps = 16;    // replicate warps per block, at most
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ uint32_t premix(uint32_t v) { return v ^ (v >> 16); }

// The staged key of an element at absolute slot `slot` under `seed`.
__device__ __forceinline__ uint32_t element_key(uint32_t slot, uint32_t seed) {
  return premix((slot * 0x9E3779B1u) ^ (seed * 0xC2B2AE3Du));
}

// The per-thread key of replicate b.
__device__ __forceinline__ uint32_t replicate_key(uint32_t b) {
  return premix(b * 0x85EBCA77u);
}

// The rest of mix32 on premix(key) ^ premix(rep), and the hash's top 24
// bits v = (h ^ h >> 16) >> 8 under 2^23's exponent: the float g(v).
__device__ __forceinline__ float hash_g(uint32_t h) {
  h *= 0x7FEB352Du;
  h ^= h >> 15;
  h *= 0x846CA68Bu;
  return __uint_as_float(((h >> 8) ^ (h >> 24)) | 0x4B000000u);
}

// sat(f - g(K - 1)): 1 when v >= K, else 0.
__device__ __forceinline__ float step(float f, float g) {
  return __saturatef(__fsub_rn(f, g));
}

// g(K_k - 1) for K = [6171993, 12343986, 15429982, 16458648, 16715814 |
// 16767247, 16775819, 16777044, 16777197, 16777214]: the weight is the
// head's five steps plus the tail's five, and the tail is 0 unless
// v >= K_5 (probability 5.9e-4 a draw).
constexpr float kTail = 33534492.0f;    // g(K_5 - 1)

__device__ __forceinline__ float ladder_head(float f) {
  return ((step(f, 14560600.0f) + step(f, 24687970.0f)) +
          (step(f, 30859962.0f) + step(f, 32917294.0f))) +
         step(f, 33431626.0f);
}

__device__ __forceinline__ float ladder_tail(float f) {
  return ((step(f, kTail) + step(f, 33551636.0f)) +
          (step(f, 33554086.0f) + step(f, 33554392.0f))) +
         step(f, 33554426.0f);
}

// acc[p] += w_j * feat[p][j] for j in [j0, j1) in order (multiples of
// kUnroll, 16-byte aligned shared arrays of kChunk entries per moment).
// The tail of the ladder runs only when a draw of the warp's kUnroll x 32
// needs it (about one iteration in seven); the sums are small integers, so
// the weight is the same in any order.  Every lane of the warp calls it.
template <int NM>
__device__ __forceinline__ void chunk_sums(const uint32_t* __restrict__ key,
                                           const float* __restrict__ feat,
                                           int j0, int j1, uint32_t rep,
                                           float (&acc)[NM]) {
#pragma unroll 1
  for (int j = j0; j < j1; j += kUnroll) {
    float w[kUnroll], top = 0.f;
#pragma unroll
    for (int h = 0; h < kUnroll; h += 4) {
      const uint4 k = *reinterpret_cast<const uint4*>(key + j + h);
      const float f[4] = {hash_g(k.x ^ rep), hash_g(k.y ^ rep),
                          hash_g(k.z ^ rep), hash_g(k.w ^ rep)};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        w[h + i] = ladder_head(f[i]);
        top = fmaxf(top, f[i]);
      }
    }
    if (__any_sync(kFull, top > kTail)) {   // rare: hash the keys again
#pragma unroll
      for (int h = 0; h < kUnroll; h += 4) {
        const uint4 k = *reinterpret_cast<const uint4*>(key + j + h);
        w[h + 0] += ladder_tail(hash_g(k.x ^ rep));
        w[h + 1] += ladder_tail(hash_g(k.y ^ rep));
        w[h + 2] += ladder_tail(hash_g(k.z ^ rep));
        w[h + 3] += ladder_tail(hash_g(k.w ^ rep));
      }
    }
#pragma unroll
    for (int h = 0; h < kUnroll; h += 4) {
      float4 fv[NM];
#pragma unroll
      for (int p = 0; p < NM; ++p)
        fv[p] = *reinterpret_cast<const float4*>(feat + p * kChunk + j + h);
#pragma unroll
      for (int p = 0; p < NM; ++p) acc[p] = __fadd_rn(acc[p], __fmul_rn(w[h + 0], fv[p].x));
#pragma unroll
      for (int p = 0; p < NM; ++p) acc[p] = __fadd_rn(acc[p], __fmul_rn(w[h + 1], fv[p].y));
#pragma unroll
      for (int p = 0; p < NM; ++p) acc[p] = __fadd_rn(acc[p], __fmul_rn(w[h + 2], fv[p].z));
#pragma unroll
      for (int p = 0; p < NM; ++p) acc[p] = __fadd_rn(acc[p], __fmul_rn(w[h + 3], fv[p].w));
    }
  }
}

// Stage-time bookkeeping of the live elements: each thread widens [lo, hi)
// over its own live indices; live_range folds them over the block into
// [j0, j1) rounded out to kUnroll (j0 >= j1: no live element).  w_lo/w_hi
// hold one entry per warp.  Ends with a barrier.
__device__ __forceinline__ void live_range(int lo, int hi, int* w_lo, int* w_hi,
                                           int& j0, int& j1) {
  const int warp = threadIdx.x >> 5, nw = blockDim.x >> 5;
  lo = __reduce_min_sync(kFull, lo);
  hi = __reduce_max_sync(kFull, hi);
  if ((threadIdx.x & 31) == 0) {
    w_lo[warp] = lo;
    w_hi[warp] = hi;
  }
  __syncthreads();
  lo = kChunk;
  hi = 0;
  for (int i = 0; i < nw; ++i) {
    lo = min(lo, w_lo[i]);
    hi = max(hi, w_hi[i]);
  }
  j0 = lo & ~(kUnroll - 1);
  j1 = (hi + kUnroll - 1) & ~(kUnroll - 1);
}

// First index in [lo, hi) whose a[] >= v (a ascending there), hi if none:
// the whole warp searches, 32 probes a step.  Every lane returns the same.
__device__ __forceinline__ int warp_lower_bound(const int* a, int lo, int hi,
                                                long long v) {
  const int lane = threadIdx.x & 31;
  while (hi - lo > 32) {
    const int step = (hi - lo + 31) >> 5;
    const long long idx = lo + static_cast<long long>(lane + 1) * step - 1;
    const bool ge = idx >= hi || a[idx] >= v;
    const unsigned m = __ballot_sync(kFull, ge);
    if (!m) return hi;
    const int k = __ffs(m) - 1;
    const int nhi = static_cast<int>(min(static_cast<long long>(hi),
                                         lo + static_cast<long long>(k + 1) * step - 1));
    lo += k * step;
    hi = nhi;
  }
  const bool ge = lo + lane < hi && a[lo + lane] >= v;
  const unsigned m = __ballot_sync(kFull, ge);
  return m ? lo + __ffs(m) - 1 : hi;
}

// After a block computed `acc` for unit u of a group: write the partial (if
// live) and the unit's live flag, count the block on the group's counter,
// and, in the block that arrives last (the n-th), add the group's units
// first, first + step, ... (n of them) in that order, live ones only, into
// out_g[b * NM + p] for b < B, then reset the counter.  tb = blockDim.x
// replicates a unit; part holds NM * tb floats a unit.  Every thread of the
// block calls it.
template <int NM>
__device__ void finish_unit(const float (&acc)[NM], bool live, long long u,
                            float* __restrict__ part, int* __restrict__ flag,
                            int* __restrict__ counter, int n, long long first,
                            long long step, float* __restrict__ out_g, int b,
                            int B, int* s_last) {
  const int tid = threadIdx.x, tb = blockDim.x, lane = tid & 31;
  if (live) {
    float* dst = part + u * NM * tb + tid;
#pragma unroll
    for (int p = 0; p < NM; ++p) dst[p * tb] = acc[p];
  }
  // The block's writes are ordered before thread 0's fence by the barrier;
  // the fence makes them visible before the count (release), and the last
  // block's fence after the count orders its reads after it (acquire).
  __syncthreads();
  if (tid == 0) {
    flag[u] = live;
    __threadfence();
    const bool last = atomicAdd(counter, 1) == n - 1;
    if (last) {
      *counter = 0;                     // zero for the next call or replay
      __threadfence();
    }
    *s_last = last;
  }
  __syncthreads();
  if (!*s_last) return;
  // The fold is a chain of n dependent adds a value, bound by the latency
  // of its loads: units are read in batches of 8 whose loads are all in
  // flight before the adds.
  float s[NM];
#pragma unroll
  for (int p = 0; p < NM; ++p) s[p] = 0.f;
  const float* col = part + first * NM * tb + tid;
  const long long ustep = step * NM * tb;
  unsigned m = 0;
#pragma unroll 1
  for (int k0 = 0; k0 < n; k0 += 8) {
    if ((k0 & 31) == 0) {               // live flags of the next 32 units
      const int k = k0 + lane;
      m = __ballot_sync(kFull, k < n && flag[first + k * step] != 0);
    }
    const unsigned sub = (m >> (k0 & 31)) & 0xffu;
    if (!sub) continue;
    float v[8][NM];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const float* src = col + (k0 + e) * ustep;
#pragma unroll
      for (int p = 0; p < NM; ++p) v[e][p] = (sub >> e) & 1u ? src[p * tb] : 0.f;
    }
#pragma unroll
    for (int e = 0; e < 8; ++e)         // + exact 0 for a dead unit
#pragma unroll
      for (int p = 0; p < NM; ++p) s[p] = __fadd_rn(s[p], v[e][p]);
  }
  if (b < B) {
#pragma unroll
    for (int p = 0; p < NM; ++p) out_g[static_cast<long long>(b) * NM + p] = s[p];
  }
}

}  // namespace boot
