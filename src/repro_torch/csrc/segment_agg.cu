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
//    slot-ascending run of the stream (the wrapper passes the lane offsets).
//
//    What bounds it on this card: instruction issue, as in
//    poisson_bootstrap.cu (26 instructions a (valid element, replicate)
//    pair in the draw loop's SASS, 15 of them FP32, against 20 bytes read
//    an element).  The per-pair work is the shared core's
//    (bootstrap_core.cuh).  At the grouped serve's shapes (9 lanes of
//    1000-2000 elements) a call is short: the plan, the staging and the
//    fold, a round trip or two each, weigh as much as the draws.
//
//    What the design does about it:
//     * Only chunks that hold work get a block.  A work item is one (lane,
//       absolute 256-slot chunk) inside the lane's span, from its first to
//       its last slot; every block reads the q + 1 offsets and the lanes'
//       first and last slots and lays the items out in shared memory (an
//       exclusive prefix over the lanes), so a call is one kernel.  Above
//       kPlanLanes lanes a one-block plan kernel writes the same plan to
//       scratch first (two kernels).  A unit is an (item, replicate tile);
//       the grid is fixed by L, q, n_slots, B and the SM count (a CUDA
//       graph can hold the call) and the blocks stride over the units.
//       ops.seg_plan / ops.seg_grid are the same arithmetic in Python.
//     * A lane with contiguous slots (last - first = count - 1, every lane
//       of the grouped tick) finds an item's element range by arithmetic,
//       checked against the four boundary slots while the chunk is staged
//       (repeated slots fail the check); any other lane searches, 32 probes
//       a step over the whole warp.
//     * The fold in the same kernel: the block that arrives last on the
//       (lane, tile) counter adds the lane's live item partials in
//       ascending chunk order -- only the lane's span -- and writes the
//       output.  A lane with no item reads zeros.
//
//    Order: within a chunk, products are added one element at a time in
//    stream order with __fmul_rn/__fadd_rn; a lane's chunk partials in
//    ascending chunk order.  This is poisson_bootstrap.cu's order for the
//    same slots, so a block lane's sums equal its solo run's bit for bit,
//    and the plain version (kernels/segment_agg/ref.py) matches the kernel
//    bit for bit.
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

#include "bootstrap_core.cuh"

namespace {

using boot::kChunk;                // slots per summation chunk (ref.CHUNK)
constexpr int kMoments = 3;
constexpr int kPlanLanes = 512;    // lanes planned in shared memory (ops.PLAN_LANES)
constexpr int kStagePer = kChunk / 32;  // elements a thread stages, at most
constexpr int kAggThreads = 128;   // ref.AGG_THREADS
constexpr int kAggPerThread = 256; // ref.AGG_PER_THREAD
constexpr long long kAggTile = static_cast<long long>(kAggThreads) * kAggPerThread;
constexpr int kGroupTile = 12;     // groups per aggregate block: 7*12*128*4 B < 48 KB
constexpr int kStats = 5;          // count, sum, sumsq, sum3, sum4
constexpr int kOut = kStats + 2;   // + min, max
constexpr float kBig = 3.0e38f;
constexpr unsigned kFull = 0xFFFFFFFFu;

// Chunk of slot s, clamped to the stream's [0, n_chunks).
__device__ __forceinline__ int chunk_of(int s, int n_chunks) {
  return min(max(s >> 8, 0), n_chunks - 1);
}

// Items of a lane owning [a, e) with first and last slots s0, s1.
__device__ __forceinline__ int lane_items(int a, int e, int s0, int s1,
                                          int n_chunks) {
  return a < e ? max(0, chunk_of(s1, n_chunks) - chunk_of(s0, n_chunks) + 1)
               : 0;
}

// The plan: la[g] = lane_off[g] (g <= q), ls0/ls1[g] the lane's first and
// last slot, base[g] the exclusive prefix of the lanes' item counts, base[q]
// their total.  Thread t takes a contiguous run of lanes.  Every thread of
// the block calls it; it ends with a barrier.
__device__ void build_plan(const long long* __restrict__ lane_off,
                           const int* __restrict__ slot, int q, int n_chunks,
                           int* la, int* ls0, int* ls1, int* base,
                           int* s_warp) {
  const int tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nw = nt >> 5;
  const int per = (q + nt - 1) / nt;
  const int g0 = min(q, tid * per), g1 = min(q, g0 + per);
  int sum = 0;
  for (int g = g0; g < g1; ++g) {
    const int a = static_cast<int>(lane_off[g]);
    const int e = static_cast<int>(lane_off[g + 1]);
    int s0 = 0, s1 = 0;
    if (a < e) {
      s0 = slot[a];
      s1 = slot[e - 1];
    }
    la[g] = a;
    ls0[g] = s0;
    ls1[g] = s1;
    if (g == q - 1) la[q] = e;
    sum += lane_items(a, e, s0, s1, n_chunks);
  }
  int incl = sum;                        // inclusive scan over the warp
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int v = __shfl_up_sync(kFull, incl, d);
    if (lane >= d) incl += v;
  }
  if (lane == 31) s_warp[warp] = incl;
  __syncthreads();
  if (warp == 0) {                       // exclusive scan of the warp totals
    const int v = lane < nw ? s_warp[lane] : 0;
    int inc = v;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int u = __shfl_up_sync(kFull, inc, d);
      if (lane >= d) inc += u;
    }
    if (lane < nw) s_warp[lane] = inc - v;
  }
  __syncthreads();
  int run = s_warp[warp] + incl - sum;
  for (int g = g0; g < g1; ++g) {
    base[g] = run;
    run += lane_items(la[g], la[g + 1], ls0[g], ls1[g], n_chunks);
  }
  if (g0 < g1 && g1 == q) base[q] = run;
  __syncthreads();
}

__global__ void __launch_bounds__(1024)
seg_plan_kernel(const long long* __restrict__ lane_off,
                const int* __restrict__ slot, int q, int n_chunks,
                int* __restrict__ plan) {
  __shared__ int s_warp[32];
  build_plan(lane_off, slot, q, n_chunks, plan, plan + q + 1,
             plan + 2 * q + 1, plan + 3 * q + 1, s_warp);
}

// plan: NULL (the block plans in dynamic shared memory, q <= kPlanLanes)
// or the seg_plan_kernel's output.
__global__ void __launch_bounds__(boot::kMaxWarps * 32)
seg_boot_kernel(const float* __restrict__ x, const float* __restrict__ mask,
                const int* __restrict__ slot,
                const long long* __restrict__ seed,
                const long long* __restrict__ lane_off, const int* plan,
                float* __restrict__ part, int* __restrict__ flag,
                int* __restrict__ counter, float* __restrict__ out, int q,
                int B, int n_chunks, int n_tiles) {
  extern __shared__ int s_plan[];
  __shared__ __align__(16) uint32_t s_key[kChunk];
  __shared__ __align__(16) float s_feat[kMoments * kChunk];
  __shared__ int s_wlo[boot::kMaxWarps], s_whi[boot::kMaxWarps];
  __shared__ int s_warp[32], s_last, s_bad;
  const int tid = threadIdx.x, tb = blockDim.x;
  const int* p = plan;
  if (p == nullptr) {
    build_plan(lane_off, slot, q, n_chunks, s_plan, s_plan + q + 1,
               s_plan + 2 * q + 1, s_plan + 3 * q + 1, s_warp);
    p = s_plan;
  }
  const int* la = p;
  const int* ls0 = p + q + 1;
  const int* ls1 = p + 2 * q + 1;
  const int* base = p + 3 * q + 1;
  for (int g = blockIdx.x; g < q; g += gridDim.x) {   // lanes with no item
    if (base[g + 1] == base[g]) {
      float* o = out + static_cast<long long>(g) * B * kMoments;
      for (int i = tid; i < B * kMoments; i += tb) o[i] = 0.f;
    }
  }
  const long long units = static_cast<long long>(base[q]) * n_tiles;
  for (long long u = blockIdx.x; u < units; u += gridDim.x) {
    const int i = static_cast<int>(u / n_tiles);
    const int t = static_cast<int>(u - static_cast<long long>(i) * n_tiles);
    const int g = boot::warp_lower_bound(base, 0, q + 1, i + 1LL) - 1;
    const int a = la[g], e = la[g + 1], s0 = ls0[g], s1 = ls1[g];
    const int c = chunk_of(s0, n_chunks) + (i - base[g]);
    const long long c_lo = static_cast<long long>(c) * kChunk;
    const long long c_hi = c_lo + kChunk;
    bool verify = s1 - s0 == e - a - 1;  // contiguous: range by arithmetic
    int lo, hi;
    if (verify) {
      lo = a + static_cast<int>(max(c_lo, static_cast<long long>(s0)) - s0);
      hi = a + static_cast<int>(min(c_hi, s1 + 1LL) - s0);
    } else {
      lo = boot::warp_lower_bound(slot, a, e, c_lo);
      hi = boot::warp_lower_bound(slot, lo, e, c_hi);
    }
    const int b = t * tb + tid;
    const uint32_t rep = boot::replicate_key(static_cast<uint32_t>(b));
    const bool draws = t * tb + (tid & ~31) < B;  // whole warps past B do not
    float acc[kMoments] = {0.f, 0.f, 0.f};
    bool live = false;
    // Rounds of at most kChunk elements: more than one only where slots
    // repeat (a searched range).
    for (int r0 = lo; r0 < hi;) {
      const int nr = min(kChunk, hi - r0);
      int llo = kChunk, lhi = 0;
      // Every load of the round first (and the boundary slots of an
      // arithmetic range), then the keys and features.
      float xv[kStagePer], mv[kStagePer];
      int sv[kStagePer];
      long long ev[kStagePer];
#pragma unroll
      for (int i = 0; i < kStagePer; ++i) {
        const int jj = tid + i * tb;
        if (jj < nr) {
          const int j = r0 + jj;
          xv[i] = x[j];
          mv[i] = mask[j];
          sv[i] = slot[j];
          ev[i] = seed[j];
        }
      }
      bool bad = false;
      if (verify && tid == 0)
        bad = !((lo == a || slot[lo - 1] < c_lo) && slot[lo] >= c_lo &&
                slot[hi - 1] < c_hi && (hi == e || slot[hi] >= c_hi));
#pragma unroll
      for (int i = 0; i < kStagePer; ++i) {
        const int jj = tid + i * tb;
        if (jj >= kChunk) break;
        uint32_t key = 0;
        float f0 = 0.f, f1 = 0.f, f2 = 0.f;
        if (jj < nr) {
          key = boot::element_key(static_cast<uint32_t>(sv[i]),
                                  static_cast<uint32_t>(ev[i]));
          if (mv[i] > 0.f) {
            f0 = mv[i];
            f1 = __fmul_rn(mv[i], xv[i]);
            f2 = __fmul_rn(mv[i], __fmul_rn(xv[i], xv[i]));
            llo = min(llo, jj);
            lhi = jj + 1;
          }
        }
        s_key[jj] = key;
        s_feat[jj] = f0;
        s_feat[kChunk + jj] = f1;
        s_feat[2 * kChunk + jj] = f2;
      }
      if (verify && tid == 0) s_bad = bad;
      int j0, j1;
      boot::live_range(llo, lhi, s_wlo, s_whi, j0, j1);
      if (verify) {
        verify = false;
        if (s_bad) {                     // repeated slots: search instead
          lo = boot::warp_lower_bound(slot, a, e, c_lo);
          hi = boot::warp_lower_bound(slot, lo, e, c_hi);
          r0 = lo;
          __syncthreads();
          continue;
        }
      }
      if (j0 < j1) {
        live = true;
        if (draws) boot::chunk_sums<kMoments>(s_key, s_feat, j0, j1, rep, acc);
      }
      __syncthreads();                   // before the next round's staging
      r0 += nr;
    }
    const int n_items = base[g + 1] - base[g];
    boot::finish_unit<kMoments>(
        acc, live, u, part, flag, counter + static_cast<long long>(g) * n_tiles + t,
        n_items, static_cast<long long>(base[g]) * n_tiles + t, n_tiles,
        out + static_cast<long long>(g) * B * kMoments, b, B, &s_last);
  }
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
// [lane_off[g], lane_off[g + 1]); every slot in [0, n_chunks * 256).  plan:
// (4q + 2,) int32 scratch, used when q > kPlanLanes (NULL allowed
// otherwise); part: q * n_chunks * tiles * 3 * 32 * warps f32 scratch;
// flag: q * n_chunks * tiles int32 scratch; counter: q * tiles int32 zeros,
// left zero by the call; out: (q, B, 3) f32.  blocks, warps, tiles are
// ops.seg_grid's; warps * tiles * 32 >= B.  Returns cudaGetLastError()
// after the launches (0 on success).
extern "C" int seg_boot_launch(const float* x, const float* mask,
                               const int* slot, const long long* seed,
                               const long long* lane_off, int* plan,
                               float* part, int* flag, int* counter,
                               float* out, int q, int B, int n_chunks,
                               int blocks, int warps, int tiles,
                               void* stream) {
  if (q < 1 || n_chunks < 1 || blocks < 1 || warps < 1 ||
      warps > boot::kMaxWarps || tiles < 1 ||
      static_cast<long long>(warps) * 32 * tiles < B ||
      (q > kPlanLanes && plan == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  size_t smem = 0;
  if (q > kPlanLanes) {
    seg_plan_kernel<<<1, 1024, 0, s>>>(lane_off, slot, q, n_chunks, plan);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  } else {
    plan = nullptr;
    smem = static_cast<size_t>(4 * q + 2) * sizeof(int);
  }
  seg_boot_kernel<<<blocks, warps * 32, smem, s>>>(
      x, mask, slot, seed, lane_off, plan, part, flag, counter, out, q, B,
      n_chunks, tiles);
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
