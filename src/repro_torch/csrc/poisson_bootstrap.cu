// Poisson-bootstrap moment sums for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/poisson_bootstrap/
// kernel.py::_kernel (launched by poisson_bootstrap_moments_lanes).  For
// every group g and replicate b it computes
//
//     M[g, b, p] = sum_j feats_p(x[g, j], mask[g, j]) * Poisson1(hash3(seed_g, j, b))
//
// with feats = [m, m x, m x^2, m x^3, m x^4] and j the ABSOLUTE slot index.
// The TPU built each (tn x tb) weight tile in VMEM and contracted it on its
// matrix unit; here the (n x B) weight matrix is never stored: each thread
// draws its replicate's weights in registers (bootstrap_core.cuh).
//
// What bounds it on this card: instruction issue.  A (slot, replicate) pair
// is a hash, a draw and five multiplies and adds: 31 instructions in the
// SASS of the draw loop (8.5 integer, 19 FP32, 3.25 loads and control; the
// ladder's rare tail apart), one issue slot each, while a slot moves 8
// bytes for 300 replicates.
//
// What the design does about it (the shared core does the per-pair work):
//  * one block per (256-slot chunk, replicate tile, group), the bucket's
//    dense grid; a replicate tile is 32 replicates a warp, ceil(B / 32)
//    warps split into tiles of at most 8 warps, as few as still fill the
//    card (B = 300: two tiles of five warps); the chunk is staged once a
//    block, and at most 64 registers keep six such blocks on an SM;
//  * a gated group (active[g] == 0) returns at once and its chunk-0 blocks
//    write its zeros; a chunk with no live slot writes only its flag, and
//    the draws of a live chunk run over its first to last live slot;
//  * every load of a chunk's staging is in flight before the first use;
//  * the fold in the same launch: the block that arrives last on the
//    (group, tile) counter adds the live chunk partials in ascending chunk
//    order and writes the output.  One kernel a call; no conversion of the
//    gate (bool or int32, read through its strides).
//
// Determinism: the sums take the order of the plain PyTorch version
// (kernels/poisson_bootstrap/ref.py) -- each chunk's products added one slot
// at a time in ascending order with separately rounded multiplies and adds,
// then the chunk partials in ascending chunk order -- so the two agree bit
// for bit, widening the slice only appends exact zeros, and repeated calls
// agree.  No atomics touch data.
//
// Built by kernels/poisson_bootstrap/ops.py (through kernels/nvcc.py) with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// and called through ctypes (plain C entry point pb_launch below).

#include <cuda_runtime.h>
#include <stdint.h>

#include "bootstrap_core.cuh"

namespace {

constexpr int kMoments = 5;
constexpr int kStagePer = 4;       // elements a thread loads before their use
using boot::kChunk;

__device__ __forceinline__ bool group_active(const void* act, int kind,
                                             int inner, long long s_outer,
                                             long long s_inner, int g) {
  if (kind == 0) return true;
  const long long i = (g / inner) * s_outer + (g % inner) * s_inner;
  return kind == 1 ? static_cast<const uint8_t*>(act)[i] != 0
                   : static_cast<const int*>(act)[i] != 0;
}

// At most 64 registers: six blocks of five warps (B = 300) an SM.
__global__ void __launch_bounds__(boot::kMaxWarps * 32, 2)
pb_kernel(const float* __restrict__ x, long long x_row,
          const float* __restrict__ mask, long long m_row,
          const long long* __restrict__ seeds, const void* act, int act_kind,
          int act_inner, long long act_s0, long long act_s1,
          float* __restrict__ part, int* __restrict__ flag,
          int* __restrict__ counter, float* __restrict__ out, int n, int B) {
  __shared__ __align__(16) uint32_t s_key[kChunk];
  __shared__ __align__(16) float s_feat[kMoments * kChunk];
  __shared__ int s_wlo[boot::kMaxWarps], s_whi[boot::kMaxWarps], s_last;
  const int c = blockIdx.x, t = blockIdx.y, g = blockIdx.z;
  const int n_chunks = gridDim.x, n_tiles = gridDim.y;
  const int tid = threadIdx.x, tb = blockDim.x;
  const int b = t * tb + tid;
  float* out_g = out + static_cast<long long>(g) * B * kMoments;
  if (!group_active(act, act_kind, act_inner, act_s0, act_s1, g)) {
    if (c == 0 && b < B) {               // uniform over the block
#pragma unroll
      for (int p = 0; p < kMoments; ++p) out_g[static_cast<long long>(b) * kMoments + p] = 0.f;
    }
    return;
  }
  // Stage the chunk: keys and features, zero where the mask is.
  const float* xg = x + static_cast<long long>(g) * x_row;
  const float* mg = mask + static_cast<long long>(g) * m_row;
  const uint32_t seed = static_cast<uint32_t>(seeds[g]);
  const int j0 = c * kChunk;
  int lo = kChunk, hi = 0;
  for (int j00 = 0; j00 < kChunk; j00 += kStagePer * tb) {
    float xv[kStagePer], mv[kStagePer];
#pragma unroll
    for (int i = 0; i < kStagePer; ++i) {  // every load first
      const int jj = j00 + tid + i * tb, j = j0 + jj;
      const bool in = jj < kChunk && j < n;
      xv[i] = in ? xg[j] : 0.f;
      mv[i] = in ? mg[j] : 0.f;
    }
#pragma unroll
    for (int i = 0; i < kStagePer; ++i) {
      const int jj = j00 + tid + i * tb;
      if (jj >= kChunk) break;
      float f[kMoments] = {0.f, 0.f, 0.f, 0.f, 0.f};
      if (mv[i] != 0.f) {
        const float x2 = __fmul_rn(xv[i], xv[i]);
        const float mx2 = __fmul_rn(mv[i], x2);
        f[0] = mv[i];
        f[1] = __fmul_rn(mv[i], xv[i]);
        f[2] = mx2;
        f[3] = __fmul_rn(mx2, xv[i]);
        f[4] = __fmul_rn(mx2, x2);
        lo = min(lo, jj);
        hi = jj + 1;
      }
      s_key[jj] = boot::element_key(static_cast<uint32_t>(j0 + jj), seed);
#pragma unroll
      for (int p = 0; p < kMoments; ++p) s_feat[p * kChunk + jj] = f[p];
    }
  }
  int a0, a1;
  boot::live_range(lo, hi, s_wlo, s_whi, a0, a1);
  float acc[kMoments] = {0.f, 0.f, 0.f, 0.f, 0.f};
  if (t * tb + (tid & ~31) < B)          // whole warps past B draw nothing
    boot::chunk_sums<kMoments>(s_key, s_feat, a0, a1,
                               boot::replicate_key(static_cast<uint32_t>(b)), acc);
  const long long first = static_cast<long long>(g) * n_chunks * n_tiles + t;
  boot::finish_unit<kMoments>(acc, a0 < a1, first + static_cast<long long>(c) * n_tiles,
                              part, flag, counter + g * n_tiles + t, n_chunks,
                              first, n_tiles, out_g, b, B, &s_last);
}

}  // namespace

// x, mask: (G, n) f32 rows at the given row strides (unit slot stride);
// seeds: (G,) int64 holding uint32 patterns; act: NULL (every group active)
// or the gate read as element (g / inner) * s0 + (g % inner) * s1 of bool
// (act_kind 1) or int32 (act_kind 2) data; part: G * ceil(n/256) * tiles *
// 5 * 32 * warps f32 scratch, flag: G * ceil(n/256) * tiles int32 scratch,
// counter: G * tiles int32 zeros, left zero by the call; out: (G, B, 5)
// f32.  warps * tiles * 32 >= B, warps <= 16.  Returns the CUDA error of
// the launch (0 on success).
extern "C" int pb_launch(const float* x, long long x_row, const float* mask,
                         long long m_row, const long long* seeds,
                         const void* act, int act_kind, int act_inner,
                         long long act_s0, long long act_s1, float* part,
                         int* flag, int* counter, float* out, int G, int n,
                         int B, int warps, int tiles, void* stream) {
  if (warps < 1 || warps > boot::kMaxWarps || tiles < 1 ||
      static_cast<long long>(warps) * 32 * tiles < B || act_inner < 1 ||
      act_kind < 0 || act_kind > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((n + kChunk - 1) / kChunk, tiles, G);
  pb_kernel<<<grid, warps * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      x, x_row, mask, m_row, seeds, act, act_kind, act_inner, act_s0, act_s1,
      part, flag, counter, out, n, B);
  return static_cast<int>(cudaGetLastError());
}
