// Flash-decoding single-token GQA attention for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/decode_attention/kernel.py
// (_kernel, launched by decode_attention_call): one new query token per
// sequence attends over its KV cache with an online-softmax carry (m, l, acc)
// in f32, never forming the score matrix in device memory.
//
// What it computes.  For batch row b and KV head h, the G query heads
// q[b, h*G + g, :] attend over positions [lo[b], hi[b]) of k[b, :, h, :] and
// v[b, :, h, :], with hi[b] = min(kv_len[b], S) and, under a sliding window
// of W positions, lo[b] = min(max(0, kv_len[b] - W), hi[b]) (else 0): the
// reference's decode mask kj <= length, kj > length - W with kv_len =
// length + 1.  Scores are f32 dot products times `scale`; the result is
// acc / max(l, 1e-30) written in the dtype of q (f32 or bf16), so an empty
// range reads zeros.  A position outside [lo, hi) is never read.  Head
// dimensions 32, 64, 120 and 128.  On request the kernel also writes each
// query head's log-sum-exp of its scores, m + log(l) in f32 (-1e30 for an
// empty range), so that the outputs of a cache split over positions -- one
// call a part, as each rank of a mesh holds its part -- merge into the
// whole cache's (the caller merges them).  The plain PyTorch version beside
// it is src/repro_torch/kernels/decode_attention/ref.py.
//
// What bounds it.  Bytes: every valid K and V row is read once and the G
// query heads of a KV head share each read, about one multiply-add per byte.
// At the serving shape (8 rows x 2 KV heads x d = 128, bf16, lengths of a few
// hundred) a call moves ~5 MB, 1.5 us at the card's memory rate; a full
// 2048-position cache moves 16.8 MB, 5 us.  Below that what a call costs is
// latency: the launch, dependent round trips to memory (the lengths, then
// K and V, then the splits' partials), barriers and dependent tensor-core
// chains inside a tile.  The design cuts each of them it can.
//
// Design.
//  * One launch a call, merged in its last block.  The grid is fixed by
//    (B, Hkv, S_max, SM count): about two blocks per SM, so it can be
//    captured in a CUDA graph and never reads the lengths on the host.
//    A pair (row, KV head) with one split writes its output.  Otherwise each
//    split writes (m, l, acc), one thread fences and counts the block on the
//    pair's arrival counter, and the block that arrives last merges the
//    pair's splits in ascending split order -- the same sum whichever block
//    merges, so repeated calls agree bit for bit -- writes the output and
//    resets the counter to 0 for the next call or graph replay.  No atomics
//    touch data.
//  * Splits balanced by the lengths on the device.  Every block reads the B
//    lengths, forms each row's range [lo, hi) and computes the same
//    partition of the ranges: the smallest chunk of whole TILE-row tiles for
//    which the splits of all pairs, ceil((hi - lo) / chunk) each (one for an
//    empty range), fit the grid; split s of a row covers
//    [lo + s * chunk, min(lo + (s + 1) * chunk, hi)); a prefix over the rows
//    gives each block its (row, head, split), and blocks past the work exit
//    at once.  32 candidate chunks are counted at once, so this costs two
//    barriers.  ops.partition is the same arithmetic in Python.
//  * All loads in flight before the first wait: q (16-byte copies) and
//    every K/V tile of the block's split up to the ring's depth, cp.async
//    16-byte copies into a ring in dynamic shared memory, one commit group a
//    tile, read through the cache's own strides (no padded or transposed
//    copy); rows past the length are zero-filled without a read.  The last
//    block stages all its pair's partials in the ring the same way.
//  * bf16 on the tensor cores (mma.sync m16n8k16, bf16 in, f32 accumulate;
//    bf16 products are exact in f32), the G query heads padded to the 16
//    rows of A.  Scores: warp w takes positions 8w .. 8w + 7 of a 64-row
//    tile; the softmax works on the fragments in registers and exchanges
//    only per-warp maxima and sums.  A head dimension that is not a
//    multiple of 16 (120) takes a last k-step of 8, its upper half zeroed
//    in both fragments; the shared rows keep D + 8 elements, so the cache
//    is neither padded nor copied.  P.V keeps P in f32, as the reference
//    does: each weight is stored as three bf16 parts whose sum is exactly
//    the f32 weight (8 significant bits each), and P.V is three products
//    into separate accumulators, summed at the end.  f32 stays on the CUDA
//    cores (one warp a head for the softmax, four weights a shared load).
//
// 256 threads a block.  Shared rows carry 16 bytes of padding so that the
// row reads of the score pass, the ldmatrix reads and the q fragments hit
// distinct banks.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxG = 16;
constexpr int kMaxB = 1024;
constexpr int kRingBytes = 80 * 1024;   // K/V ring budget of one block
constexpr float kNegInf = -1.0e30f;
constexpr unsigned kFull = 0xffffffffu;

template <typename T> struct TileRows;
template <> struct TileRows<float> { static constexpr int value = 32; };
template <> struct TileRows<__nv_bfloat16> { static constexpr int value = 64; };

constexpr int clampi(int x, int lo, int hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

template <typename T, int D> struct Cfg {
  static constexpr int TILE = TileRows<T>::value;
  static constexpr int VEC = 16 / sizeof(T);       // elements per 16 bytes
  static constexpr int ROW_VECS = D / VEC;         // 16-byte copies per row
  static constexpr int LD = D + VEC;               // padded shared row
  static constexpr int QLD = D + VEC;              // padded q row
  static constexpr int PSTR = TILE + 4;            // padded score row
  static constexpr int TILE_ELEMS = TILE * LD;     // one of K or V
  static constexpr int STAGE_BYTES = 2 * TILE_ELEMS * (int)sizeof(T);
  static constexpr int STAGES = clampi(kRingBytes / STAGE_BYTES, 2, 4);
  static constexpr int RING_BYTES = STAGES * STAGE_BYTES;
  // f32 P.V on the CUDA cores: a thread owns two adjacent columns of GPT
  // heads, GSTEP heads side by side (with D = 120 the last kThreads % PAIRS
  // threads own no column).
  static constexpr int PAIRS = D / 2;
  static constexpr int GSTEP = kThreads / PAIRS;
  static constexpr int GPT = (kMaxG + GSTEP - 1) / GSTEP;
  // bf16 P.V on the tensor cores: P in three bf16 parts of 16 padded rows
  // of PLD; warp w owns the n8 column tiles w, w + kWarps, ...
  static constexpr int PLD = TILE + 8;
  static constexpr int PSPLIT_BYTES =
      std::is_same<T, __nv_bfloat16>::value ? 3 * kMaxG * PLD * 2 : 0;
  static constexpr int NT = D / 8;
  static constexpr int WT = (NT + kWarps - 1) / kWarps;
  static constexpr int COPIES = TILE * ROW_VECS;   // 16-byte copies a tile
  static_assert(D % 8 == 0 && D <= 128 && PAIRS <= kThreads, "head dim");
  static_assert(TILE % 16 == 0, "P.V roles");
};

__host__ __device__ constexpr size_t round16(size_t x) {
  return (x + 15) / 16 * 16;
}

// Dynamic shared memory: the K/V ring, q, the tile's scores (f32), P's
// bf16 parts (bf16), the rows' range sizes and starts.  The merge reuses the
// ring and the scores.
template <typename T, int D>
__host__ __device__ constexpr size_t q_offset() {
  return Cfg<T, D>::RING_BYTES;
}
template <typename T, int D>
__host__ __device__ constexpr size_t p_offset(int G) {
  return q_offset<T, D>() + (size_t)G * Cfg<T, D>::QLD * sizeof(T);
}
template <typename T, int D>
__host__ __device__ constexpr size_t psplit_offset(int G) {
  return p_offset<T, D>(G) +
         (size_t)G * Cfg<T, D>::PSTR * sizeof(float);
}
template <typename T, int D>
__host__ __device__ constexpr size_t len_offset(int G) {
  return psplit_offset<T, D>(G) + Cfg<T, D>::PSPLIT_BYTES;
}
template <typename T, int D>
__host__ __device__ constexpr size_t smem_bytes(int B, int G) {
  return len_offset<T, D>(G) + 2 * round16((size_t)B * sizeof(int));
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(kFull, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

// Sum over the block; every thread gets it.  `red` holds kWarps values.
__device__ long long block_sum(long long x, long long* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  __syncthreads();                       // red is free from an earlier call
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = x;
  __syncthreads();
  long long s = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) s += red[w];
  return s;
}

__device__ __forceinline__ int cdiv(int a, int b) { return (a + b - 1) / b; }

// 16-byte global -> shared copy, in flight until waited for; `valid` false
// zero-fills the destination without reading the source.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// d += a . b for a 16x16 bf16 A (row major), 16x8 bf16 B (column major).
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two adjacent f32 weights, each as the sum of three bf16 parts (hi, mid,
// lo: 8 significant bits each, so the sum is the f32 value exactly), at p,
// p + part and p + 2 * part.
__device__ __forceinline__ void store_split(__nv_bfloat16* p, int part,
                                            float x, float y) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  const float rx = x - hf.x, ry = y - hf.y;
  const __nv_bfloat162 m = __floats2bfloat162_rn(rx, ry);
  const float2 mf = __bfloat1622float2(m);
  *reinterpret_cast<__nv_bfloat162*>(p) = h;
  *reinterpret_cast<__nv_bfloat162*>(p + part) = m;
  *reinterpret_cast<__nv_bfloat162*>(p + 2 * part) =
      __floats2bfloat162_rn(rx - mf.x, ry - mf.y);
}

// The four 8x8 b16 matrices at the rows given by lanes 0-7, 8-15, 16-23,
// 24-31: an A fragment of m16n8k16 from a row-major tile.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}
// Two 8x8 b16 matrices (rows from lanes 0-7, 8-15), transposed: the B
// fragment of m16n8k16 from a row-major k x n tile.
__device__ __forceinline__ void ldsm_x2_trans(uint32_t& r0, uint32_t& r1,
                                              const void* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r0), "=r"(r1)
               : "r"(s));
}

__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ void store2(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float x, float y) {
  // round to nearest even, as torch's cast
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}

// Warp 0 of a block: the row whose splits hold block `blk`, by a prefix over
// rows of Hkv * splits(row) with splits(row) = max(1, ceil(len / chunk)).
// Writes info[0..3] = chunk, row (-1 past the work), the row's first block,
// its splits.
__device__ void locate(const int* len_s, int B, int Hkv, int chunk, int blk,
                       int lane, int* info) {
  int base = 0, row = -1, first = 0, ns = 0;
  for (int b0 = 0; b0 < B; b0 += 32) {
    const int b = b0 + lane;
    const int n = b < B ? Hkv * max(1, cdiv(len_s[b], chunk)) : 0;
    int incl = n;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(kFull, incl, o);
      if (lane >= o) incl += y;
    }
    const unsigned hit = __ballot_sync(
        kFull, n > 0 && blk >= base + incl - n && blk < base + incl);
    if (hit) {
      const int src = __ffs(hit) - 1;
      row = b0 + src;
      first = __shfl_sync(kFull, base + incl - n, src);
      ns = __shfl_sync(kFull, n, src) / Hkv;
      break;
    }
    base += __shfl_sync(kFull, incl, 31);
  }
  if (lane == 0) {
    info[0] = chunk;
    info[1] = row;
    info[2] = first;
    info[3] = ns;
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 2)
decode_attn_kernel(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, const void* __restrict__ kv_len,
                   int len_kind, int fixed_len, int window,
                   T* __restrict__ out, float* __restrict__ lse,
                   float* __restrict__ m_part, float* __restrict__ l_part,
                   float* __restrict__ acc_part, int* __restrict__ arrivals,
                   int B, int S, int Hkv, int G, long long k_sb,
                   long long k_ss, long long k_sh, long long v_sb,
                   long long v_ss, long long v_sh, float scale) {
  using C = Cfg<T, D>;
  constexpr int TILE = C::TILE, VEC = C::VEC, ROW_VECS = C::ROW_VECS;
  constexpr int LD = C::LD, PSTR = C::PSTR, STAGES = C::STAGES;
  constexpr bool kBf16 = std::is_same<T, __nv_bfloat16>::value;
  static_assert(kBf16 ? TILE == 8 * kWarps : TILE == 32,
                "bf16: one n8 slice per warp; f32: one position per lane");

  extern __shared__ __align__(16) unsigned char smem[];
  T* ring = reinterpret_cast<T*>(smem);
  T* q_s = reinterpret_cast<T*>(smem + q_offset<T, D>());
  float* p_s = reinterpret_cast<float*>(smem + p_offset<T, D>(G));
  __nv_bfloat16* ps_s =                  // P's three bf16 parts (bf16 only)
      reinterpret_cast<__nv_bfloat16*>(smem + psplit_offset<T, D>(G));
  int* len_s = reinterpret_cast<int*>(smem + len_offset<T, D>(G));
  int* lo_s = len_s + round16((size_t)B * sizeof(int)) / sizeof(int);
  __shared__ float m_s[kMaxG], l_s[kMaxG], alpha_s[kMaxG];
  __shared__ float wmax_s[kWarps][16], wsum_s[kWarps][16];  // bf16 softmax
  __shared__ int cand_s[kWarps][32];
  __shared__ long long red_s[kWarps];
  __shared__ int info_s[4];              // chunk, row, first block, splits
  __shared__ int last_s;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int blk = blockIdx.x, n_blocks = gridDim.x;
  if (tid < kMaxG) {
    m_s[tid] = kNegInf;
    l_s[tid] = 0.f;
  }

  // -- 1. the ranges and the partition (ops.partition), two barriers ------
  // len_s[b] is the size of row b's range [lo_s[b], lo_s[b] + len_s[b]).
  // The chunk is the smallest t in [1, t_hi] tiles for which
  // Hkv * sum_b max(1, ceil(len_b / (t * TILE))) splits fit the grid; t_hi
  // (one split a pair) always fits, since the grid has >= B * Hkv blocks.
  // Warp w loads the lengths of rows w, w + kWarps, ... and counts them for
  // the 32 candidates t = lane + 1 at once.
  const int t_hi = cdiv(S, TILE);
  {
    int c = 0;
    for (int b = warp; b < B; b += kWarps) {
      long long L = fixed_len;
      if (len_kind == 1) L = static_cast<const int*>(kv_len)[b];
      if (len_kind == 2) L = static_cast<const long long*>(kv_len)[b];
      if (L < 0) L = 0;
      const int hi = static_cast<int>(L > S ? S : L);
      long long lo_w = window > 0 ? L - window : 0;
      const int lo = static_cast<int>(lo_w < 0 ? 0 : (lo_w > hi ? hi : lo_w));
      const int len = hi - lo;
      if (lane == 0) {
        len_s[b] = len;
        lo_s[b] = lo;
      }
      c += max(1, cdiv(len, (lane + 1) * TILE));
    }
    cand_s[warp][lane] = c;
  }
  __syncthreads();
  if (warp == 0) {
    long long c = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) c += cand_s[w][lane];
    const unsigned m = __ballot_sync(
        kFull, lane < t_hi && (long long)Hkv * c <= n_blocks);
    if (m) locate(len_s, B, Hkv, (__ffs(m)) * TILE, blk, lane, info_s);
    else if (lane == 0) info_s[0] = -1;
  }
  __syncthreads();
  if (info_s[0] < 0) {                   // past the candidates: bisect
    int lo_t = 33, hi_t = t_hi;
    while (lo_t < hi_t) {
      const int mid = (lo_t + hi_t) / 2;
      long long c = 0;
      for (int b = tid; b < B; b += kThreads) c += max(1, cdiv(len_s[b], mid * TILE));
      if ((long long)Hkv * block_sum(c, red_s) <= n_blocks) hi_t = mid;
      else lo_t = mid + 1;
    }
    __syncthreads();                     // every thread has read info_s[0]
    if (warp == 0) locate(len_s, B, Hkv, lo_t * TILE, blk, lane, info_s);
    __syncthreads();
  }
  const int chunk = info_s[0];
  const int b = info_s[1];
  if (b < 0) return;                     // past the work
  const int ns = info_s[3];
  const int local = blk - info_s[2];
  const int h = local / ns, split = local - h * ns;
  const int lo = lo_s[b] + split * chunk;
  const int rows = max(0, min(split * chunk + chunk, len_s[b]) - split * chunk);
  const int n_tiles = cdiv(rows, TILE);
  const long long bh = (long long)b * Hkv + h;

  // -- 2. q and every tile the ring holds, in flight at once --------------
  const T* kb = k + b * k_sb + h * k_sh + lo * k_ss;
  const T* vb = v + b * v_sb + h * v_sh + lo * v_ss;
  auto fetch = [&](int tile) {
    T* ks = ring + (tile % STAGES) * 2 * C::TILE_ELEMS;
    T* vs = ks + C::TILE_ELEMS;
#pragma unroll
    for (int j = 0; j < (C::COPIES + kThreads - 1) / kThreads; ++j) {
      const int i = tid + j * kThreads;
      if (C::COPIES % kThreads != 0 && i >= C::COPIES) break;
      const int r = i / ROW_VECS, e = (i % ROW_VECS) * VEC;
      const int t = tile * TILE + r;
      const bool ok = t < rows;
      const long long tt = ok ? t : 0;
      cp_async16(ks + r * LD + e, kb + tt * k_ss + e, ok);
      cp_async16(vs + r * LD + e, vb + tt * v_ss + e, ok);
    }
  };
  if (n_tiles > 0) {
    const T* qb = q + bh * G * D;
    for (int i = tid; i < G * ROW_VECS; i += kThreads)
      cp_async16(q_s + i / ROW_VECS * C::QLD + i % ROW_VECS * VEC,
                 qb + i * VEC, true);
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      if (s < n_tiles) fetch(s);
      cp_async_commit();
    }
  }

  const int grp = lane >> 2, tig = lane & 3;
  // f32: acc[j] holds columns c2, c2 + 1 of head g0 + j * GSTEP; the carry
  // (m, l) per head is in m_s, l_s.
  const int g0 = tid < C::PAIRS * C::GSTEP ? tid / C::PAIRS : kMaxG;
  const int c2 = 2 * (tid % C::PAIRS);
  float acc[kBf16 ? 1 : C::GPT][2];
  // bf16: o[t][part] is the m16n8 product tile of P's part (heads grp,
  // grp + 8; columns (warp + t * kWarps) * 8 + 2 * tig, + 1), one chain of
  // products per part, summed at the end; every thread carries (m, l) of
  // heads grp (lo) and grp + 8 (hi) in registers.
  float o[kBf16 ? C::WT : 1][3][4];
  float m_lo = kNegInf, m_hi = kNegInf, l_lo = 0.f, l_hi = 0.f;
  if constexpr (kBf16) {
#pragma unroll
    for (int t = 0; t < C::WT; ++t)
#pragma unroll
      for (int part = 0; part < 3; ++part)
        o[t][part][0] = o[t][part][1] = o[t][part][2] = o[t][part][3] = 0.f;
  } else {
#pragma unroll
    for (int j = 0; j < C::GPT; ++j) acc[j][0] = acc[j][1] = 0.f;
  }

  for (int i = 0; i < n_tiles; ++i) {
    cp_async_wait<STAGES - 1>();         // tile i (and q) landed
    __syncthreads();
    const T* ks = ring + (i % STAGES) * 2 * C::TILE_ELEMS;
    const T* vs = ks + C::TILE_ELEMS;
    const int valid = min(TILE, rows - i * TILE);
    if constexpr (kBf16) {
      // Scores: warp w takes positions 8w .. 8w + 7 of the tile for all 16
      // (padded) heads; the softmax runs on the fragments in registers,
      // with one exchange of per-warp maxima and one of per-warp sums.
      float c[4] = {0.f, 0.f, 0.f, 0.f};
      const T* qr = q_s + grp * C::QLD + tig * 2;
      const T* kr = ks + (warp * 8 + grp) * LD + tig * 2;
#pragma unroll
      for (int kk = 0; kk < (D + 15) / 16; ++kk) {
        const bool full = (kk + 1) * 16 <= D;    // else k 8..15 are zero
        const uint32_t qa[4] = {
            grp < G ? ld32(qr + kk * 16) : 0u,
            grp + 8 < G ? ld32(qr + 8 * C::QLD + kk * 16) : 0u,
            full && grp < G ? ld32(qr + kk * 16 + 8) : 0u,
            full && grp + 8 < G ? ld32(qr + 8 * C::QLD + kk * 16 + 8) : 0u};
        mma_bf16(c, qa, ld32(kr + kk * 16),
                 full ? ld32(kr + kk * 16 + 8) : 0u);
      }
      const int col = warp * 8 + tig * 2;
      const bool v0 = col < valid, v1 = col + 1 < valid;
      c[0] = v0 ? c[0] * scale : kNegInf;
      c[1] = v1 ? c[1] * scale : kNegInf;
      c[2] = v0 ? c[2] * scale : kNegInf;
      c[3] = v1 ? c[3] * scale : kNegInf;
      float mx_lo = fmaxf(c[0], c[1]), mx_hi = fmaxf(c[2], c[3]);
#pragma unroll
      for (int sh = 1; sh < 4; sh <<= 1) {
        mx_lo = fmaxf(mx_lo, __shfl_xor_sync(kFull, mx_lo, sh));
        mx_hi = fmaxf(mx_hi, __shfl_xor_sync(kFull, mx_hi, sh));
      }
      if (tig == 0) {
        wmax_s[warp][grp] = mx_lo;
        wmax_s[warp][grp + 8] = mx_hi;
      }
      __syncthreads();
      float t_lo = m_lo, t_hi = m_hi;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        t_lo = fmaxf(t_lo, wmax_s[w][grp]);
        t_hi = fmaxf(t_hi, wmax_s[w][grp + 8]);
      }
      const float p0 = v0 ? expf(c[0] - t_lo) : 0.f;
      const float p1 = v1 ? expf(c[1] - t_lo) : 0.f;
      const float p2 = v0 ? expf(c[2] - t_hi) : 0.f;
      const float p3 = v1 ? expf(c[3] - t_hi) : 0.f;
      // P in three bf16 parts whose sum is the f32 weight exactly.
      store_split(ps_s + grp * C::PLD + col, kMaxG * C::PLD, p0, p1);
      store_split(ps_s + (grp + 8) * C::PLD + col, kMaxG * C::PLD, p2, p3);
      float s_lo = p0 + p1, s_hi = p2 + p3;
#pragma unroll
      for (int sh = 1; sh < 4; sh <<= 1) {
        s_lo += __shfl_xor_sync(kFull, s_lo, sh);
        s_hi += __shfl_xor_sync(kFull, s_hi, sh);
      }
      if (tig == 0) {
        wsum_s[warp][grp] = s_lo;
        wsum_s[warp][grp + 8] = s_hi;
      }
      const float a_lo = expf(m_lo - t_lo), a_hi = expf(m_hi - t_hi);
      m_lo = t_lo;
      m_hi = t_hi;
      __syncthreads();
      s_lo = s_hi = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        s_lo += wsum_s[w][grp];
        s_hi += wsum_s[w][grp + 8];
      }
      l_lo = a_lo * l_lo + s_lo;
      l_hi = a_hi * l_hi + s_hi;
      // o = alpha * o + P . V on the tensor cores, P's three parts each
      if (warp < C::NT) {
#pragma unroll
        for (int t = 0; t < C::WT; ++t)
#pragma unroll
          for (int part = 0; part < 3; ++part) {
            o[t][part][0] *= a_lo;
            o[t][part][1] *= a_lo;
            o[t][part][2] *= a_hi;
            o[t][part][3] *= a_hi;
          }
#pragma unroll
        for (int kk = 0; kk < TILE / 16; ++kk) {
          uint32_t a[3][4];
#pragma unroll
          for (int part = 0; part < 3; ++part)
            ldsm_x4(a[part], ps_s + (part * kMaxG + (lane & 15)) * C::PLD +
                                 kk * 16 + (lane >> 4) * 8);
#pragma unroll
          for (int t = 0; t < C::WT; ++t) {
            const int nt = warp + t * kWarps;
            if (nt < C::NT) {
              uint32_t b0, b1;
              ldsm_x2_trans(b0, b1, vs + (kk * 16 + (lane & 15)) * LD + nt * 8);
#pragma unroll
              for (int part = 0; part < 3; ++part)
                mma_bf16(o[t][part], a[part], b0, b1);
            }
          }
        }
      }
    } else {
      // f32 scores on the CUDA cores -> p_s[g * PSTR + r]
      const int r = tid % TILE;
      const float* kr = ks + r * LD;
      for (int g = tid / TILE; g < G; g += kThreads / TILE) {
        const float* qg = q_s + g * C::QLD;
        float s = 0.f;
#pragma unroll
        for (int e = 0; e < D; e += 4) {
          const float4 kk = *reinterpret_cast<const float4*>(kr + e);
          const float4 qq = *reinterpret_cast<const float4*>(qg + e);
          s = fmaf(qq.x, kk.x, s);
          s = fmaf(qq.y, kk.y, s);
          s = fmaf(qq.z, kk.z, s);
          s = fmaf(qq.w, kk.w, s);
        }
        p_s[g * PSTR + r] = r < valid ? s * scale : kNegInf;
      }
      __syncthreads();
      // online softmax: one warp per head
      for (int g = warp; g < G; g += kWarps) {
        const int r = lane;              // TILE == 32
        const float x = p_s[g * PSTR + r];
        const float m_old = m_s[g];
        const float m_new = fmaxf(m_old, warp_max(x));
        const float p = r < valid ? expf(x - m_new) : 0.f;
        p_s[g * PSTR + r] = p;
        const float sum = warp_sum(p);
        if (lane == 0) {
          const float alpha = expf(m_old - m_new);
          alpha_s[g] = alpha;
          l_s[g] = alpha * l_s[g] + sum;
          m_s[g] = m_new;
        }
      }
      __syncthreads();
      // acc = alpha * acc + P . V; rows past `valid` are zeros with weight 0
#pragma unroll
      for (int j = 0; j < C::GPT; ++j) {
        const int g = g0 + j * C::GSTEP;
        if (g < G) {
          acc[j][0] *= alpha_s[g];
          acc[j][1] *= alpha_s[g];
        }
      }
#pragma unroll 2
      for (int r = 0; r < TILE; r += 4) {
        float2 vv[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) vv[u] = load2(vs + (r + u) * LD + c2);
#pragma unroll
        for (int j = 0; j < C::GPT; ++j) {
          const int g = g0 + j * C::GSTEP;
          if (g < G) {
            const float4 p =
                *reinterpret_cast<const float4*>(p_s + g * PSTR + r);
            acc[j][0] = fmaf(p.x, vv[0].x, acc[j][0]);
            acc[j][1] = fmaf(p.x, vv[0].y, acc[j][1]);
            acc[j][0] = fmaf(p.y, vv[1].x, acc[j][0]);
            acc[j][1] = fmaf(p.y, vv[1].y, acc[j][1]);
            acc[j][0] = fmaf(p.z, vv[2].x, acc[j][0]);
            acc[j][1] = fmaf(p.z, vv[2].y, acc[j][1]);
            acc[j][0] = fmaf(p.w, vv[3].x, acc[j][0]);
            acc[j][1] = fmaf(p.w, vv[3].y, acc[j][1]);
          }
        }
      }
    }
    if (i + 1 < n_tiles) {
      __syncthreads();                   // the stage and P are free again
      if (i + STAGES < n_tiles) fetch(i + STAGES);
      cp_async_commit();
    }
  }

  // -- 3. one split: the output; else the partial, and the last merges ----
  // put(g, c, x, y, m, l) for each pair of columns c, c + 1 of head g this
  // thread holds, with the head's carry.
  auto each = [&](auto put) {
    if constexpr (kBf16) {
#pragma unroll
      for (int t = 0; t < C::WT; ++t) {
        const int nt = warp + t * kWarps, c = nt * 8 + 2 * tig;
        float x[4];
#pragma unroll
        for (int e = 0; e < 4; ++e)
          x[e] = (o[t][0][e] + o[t][1][e]) + o[t][2][e];
        if (nt < C::NT) {
          if (grp < G) put(grp, c, x[0], x[1], m_lo, l_lo);
          if (grp + 8 < G) put(grp + 8, c, x[2], x[3], m_hi, l_hi);
        }
      }
    } else {
#pragma unroll
      for (int j = 0; j < C::GPT; ++j) {
        const int g = g0 + j * C::GSTEP;
        if (g < G) put(g, c2, acc[j][0], acc[j][1], m_s[g], l_s[g]);
      }
    }
  };
  if (ns == 1) {
    each([&](int g, int c, float x, float y, float m, float l) {
      if (lse != nullptr && c == 0)        // one thread a head
        lse[bh * G + g] = l > 0.f ? m + logf(l) : kNegInf;
      l = fmaxf(l, 1e-30f);
      store2(out + (bh * G + g) * D + c, x / l, y / l);
    });
    return;
  }
  const long long pb = (long long)blk * G;
  each([&](int g, int c, float x, float y, float m, float l) {
    store2(acc_part + (pb + g) * D + c, x, y);
    if (c == 0) {                        // one thread a head
      m_part[pb + g] = m;
      l_part[pb + g] = l;
    }
  });
  // The block's writes are ordered before thread 0's fence by the barrier;
  // the fence makes them visible before the count (release), and the last
  // block's fence after the count orders its reads after it (acquire).
  __syncthreads();
  if (tid == 0) {
    __threadfence();
    const bool last = atomicAdd(arrivals + bh, 1) == ns - 1;
    if (last) {
      arrivals[bh] = 0;                  // zero for the next call or replay
      __threadfence();
    }
    last_s = last;
  }
  __syncthreads();
  if (!last_s) return;
  // The last block: stage the pair's partials in the idle ring a group of
  // splits at a time, every copy in flight at once.  Each split's weight
  // exp(m_s - M) against the group's max M is computed once per head; each
  // thread sums its columns of GPT heads over the splits in ascending order
  // and folds the group into its running (M, L, A).
  const long long first = blk - split;   // the block of split 0
  const int group = max(1, min(C::RING_BYTES / (G * D * 4), TILE / 2));
  float* acc_s = reinterpret_cast<float*>(smem);
  float* w_s = p_s;                      // m, then weights, of the group
  float* l_s2 = p_s + group * G;         // l of the group
  float* gmax_s = alpha_s;               // the group's max per head
  float M[C::GPT], L[C::GPT], A[C::GPT][2];
#pragma unroll
  for (int j = 0; j < C::GPT; ++j) {
    M[j] = kNegInf;
    L[j] = A[j][0] = A[j][1] = 0.f;
  }
  for (int s0 = 0; s0 < ns; s0 += group) {
    const int n = min(group, ns - s0);
    const long long at = (first + s0) * G;
    for (int i = tid; i < n * G * (D / 4); i += kThreads)
      cp_async16(acc_s + i * 4, acc_part + at * D + i * 4, true);
    cp_async_commit();
    for (int i = tid; i < n * G; i += kThreads) {
      w_s[i] = __ldcg(m_part + at + i);
      l_s2[i] = __ldcg(l_part + at + i);
    }
    __syncthreads();
    for (int g = warp; g < G; g += kWarps) {
      float mx = kNegInf;
      for (int s = lane; s < n; s += 32) mx = fmaxf(mx, w_s[s * G + g]);
      mx = warp_max(mx);
      if (lane == 0) gmax_s[g] = mx;
    }
    __syncthreads();
    for (int i = tid; i < n * G; i += kThreads)
      w_s[i] = expf(w_s[i] - gmax_s[i % G]);
    cp_async_wait<0>();
    __syncthreads();
#pragma unroll
    for (int j = 0; j < C::GPT; ++j) {
      const int g = g0 + j * C::GSTEP;
      if (g >= G) continue;
      float sl = 0.f, s0x = 0.f, s0y = 0.f;
#pragma unroll 8
      for (int s = 0; s < n; ++s) {
        const float w = w_s[s * G + g];
        const float2 a = load2(acc_s + (s * G + g) * D + c2);
        sl = fmaf(w, l_s2[s * G + g], sl);
        s0x = fmaf(w, a.x, s0x);
        s0y = fmaf(w, a.y, s0y);
      }
      const float Mg = gmax_s[g];
      const float Mn = fmaxf(M[j], Mg);
      const float al = expf(M[j] - Mn), bl = expf(Mg - Mn);
      L[j] = L[j] * al + sl * bl;
      A[j][0] = A[j][0] * al + s0x * bl;
      A[j][1] = A[j][1] * al + s0y * bl;
      M[j] = Mn;
    }
    __syncthreads();                     // the ring is free for the next group
  }
#pragma unroll
  for (int j = 0; j < C::GPT; ++j) {
    const int g = g0 + j * C::GSTEP;
    if (g < G) {
      if (lse != nullptr && c2 == 0)
        lse[bh * G + g] = L[j] > 0.f ? M[j] + logf(L[j]) : kNegInf;
      const float l = fmaxf(L[j], 1e-30f);
      store2(out + (bh * G + g) * D + c2, A[j][0] / l, A[j][1] / l);
    }
  }
}

template <typename T, int D>
int prepare() {
  return static_cast<int>(cudaFuncSetAttribute(
      decode_attn_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem_bytes<T, D>(kMaxB, kMaxG))));
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const void* kv_len,
           int len_kind, int fixed_len, int window, void* out, float* lse,
           float* part,
           int* arrivals, int n_blocks, int B, int S, int Hkv, int G,
           long long k_sb, long long k_ss, long long k_sh, long long v_sb,
           long long v_ss, long long v_sh, float scale, cudaStream_t st) {
  const long long n = (long long)n_blocks * G;
  decode_attn_kernel<T, D><<<n_blocks, kThreads, smem_bytes<T, D>(B, G), st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), kv_len, len_kind, fixed_len, window,
      static_cast<T*>(out), lse, part + n * D, part + n * D + n, part,
      arrivals, B, S, Hkv, G, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_d(int D, const void* q, const void* k, const void* v,
             const void* kv_len, int len_kind, int fixed_len, int window,
             void* out, float* lse, float* part, int* arrivals, int n_blocks,
             int B, int S, int Hkv, int G, long long k_sb, long long k_ss,
             long long k_sh,
             long long v_sb, long long v_ss, long long v_sh, float scale,
             cudaStream_t st) {
#define DA_CASE(DD)                                                          \
  case DD:                                                                   \
    return launch<T, DD>(q, k, v, kv_len, len_kind, fixed_len, window, out,  \
                         lse, part, arrivals, n_blocks, B, S, Hkv, G, k_sb,  \
                         k_ss, k_sh, v_sb, v_ss, v_sh, scale, st);
  switch (D) {
    DA_CASE(32)
    DA_CASE(64)
    DA_CASE(120)
    DA_CASE(128)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef DA_CASE
}

}  // namespace

// Raise the dynamic shared-memory limit of every instantiation on the
// current device (once per device, before the first launch and outside any
// graph capture).  Returns the first CUDA error (0 = ok).
extern "C" int da_prepare() {
  const int rcs[] = {prepare<float, 32>(),          prepare<float, 64>(),
                     prepare<float, 120>(),         prepare<float, 128>(),
                     prepare<__nv_bfloat16, 32>(),  prepare<__nv_bfloat16, 64>(),
                     prepare<__nv_bfloat16, 120>(),
                     prepare<__nv_bfloat16, 128>()};
  for (int rc : rcs)
    if (rc != 0) return rc;
  return 0;
}

// Plain C entry point (bound through ctypes).  q (B, Hkv*G, D) contiguous,
// D in {32, 64, 120, 128}; k/v element strides over (batch, position, KV
// head), unit stride over D, every row 16-byte aligned.  Lengths: len_kind 0
// takes fixed_len for every row, 1 reads kv_len as (B,) int32, 2 as (B,)
// int64; each row attends over [lo, hi) with hi = min(max(kv_len, 0), S)
// and lo = min(max(kv_len - window, 0), hi) for window > 0, else 0.  out
// like q; lse, when not null, (B, Hkv*G) f32 log-sum-exps.  part holds
// n_blocks*G*(D+2) floats, 16-byte aligned (acc, then m, then l, of each
// block's split); arrivals B*Hkv int32 zeros, left zero
// by the call.
// n_blocks is ops.grid_blocks(B, Hkv, S, n_sm, tile); B <= 1024, G <= 16.
// Returns the CUDA error of the launch (0 = ok).
extern "C" int da_launch(const void* q, const void* k, const void* v,
                         const void* kv_len, int len_kind, int fixed_len,
                         int window, void* out, void* lse, void* part,
                         void* arrivals, int n_blocks, int B, int S,
                         int Hkv, int G, int D,
                         long long k_sb, long long k_ss, long long k_sh,
                         long long v_sb, long long v_ss, long long v_sh,
                         float scale, int is_bf16, void* stream) {
  if (G < 1 || G > kMaxG || B < 1 || B > kMaxB || S < 1 || Hkv < 1 ||
      len_kind < 0 || len_kind > 2 || n_blocks < B * Hkv || window < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  float* p = static_cast<float*>(part);
  float* ls = static_cast<float*>(lse);
  int* arr = static_cast<int*>(arrivals);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch_d<__nv_bfloat16>(D, q, k, v, kv_len, len_kind, fixed_len,
                                   window, out, ls, p, arr, n_blocks, B, S,
                                   Hkv, G, k_sb, k_ss, k_sh, v_sb, v_ss,
                                   v_sh, scale, st);
  return launch_d<float>(D, q, k, v, kv_len, len_kind, fixed_len, window, out,
                         ls, p, arr, n_blocks, B, S, Hkv, G, k_sb, k_ss, k_sh,
                         v_sb, v_ss, v_sh, scale, st);
}
