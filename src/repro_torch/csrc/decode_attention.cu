// Flash-decoding single-token GQA attention for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/decode_attention/kernel.py
// (_kernel, launched by decode_attention_call): one new query token per
// sequence attends over its KV cache with an online-softmax carry (m, l, acc)
// in f32, never forming the score matrix in device memory.
//
// What it computes.  For batch row b and KV head h, the G query heads
// q[b, h*G + g, :] attend over positions [0, kv_len[b]) of k[b, :, h, :] and
// v[b, :, h, :].  Scores are f32 dot products times `scale`; the result is
// acc / max(l, 1e-30) written in the dtype of q (f32 or bf16).  A position at
// or past kv_len[b] is never read.  The plain PyTorch version beside it is
// src/repro_torch/kernels/decode_attention/ref.py.
//
// What bounds it.  Bytes: every valid K and V row is read once (the G query
// heads of a KV head share each read), about one multiply-add per byte, so
// at the serving shape (8 rows x 2 KV heads x d = 128, lengths of a few
// hundred) the whole launch moves a few MB and sits near its launch latency.
//
// Design.  The TPU ran a sequential grid over KV chunks with the carry in
// VMEM scratch.  Blocks on the card run in no order, so the grid is
// (KV split, KV head, batch row): each block streams its own slice of
// `chunk` positions, loads its G query rows once, stages TILE K and V rows at
// a time in shared memory with 16-byte loads (rows read through the cache's
// own strides: no padded or transposed copy of the cache), and exits early
// past kv_len[b], which it reads itself.  With one split the block writes the
// output; otherwise it writes its (m, l, acc) and a second small kernel
// merges the splits in ascending order: deterministic, no atomics.  The
// number of splits comes from the cache length and the grid size (the
// wrapper), never from the lengths' values.
//
// Thread roles per tile (128 threads): scores -- thread (row r, heads
// g = tid / TILE + j * (128 / TILE)) dots q_g with K row r; softmax -- one
// warp per head updates (m, l) and turns scores into weights; P.V -- thread
// (column c = tid % d, heads g = tid / d + j * (128 / d)) keeps its acc in
// registers.  Shared rows carry 16 bytes of padding so the 16-byte row reads
// of the score pass hit distinct banks.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kMaxG = 16;
constexpr float kNegInf = -1.0e30f;

template <typename T> struct Tile;
template <> struct Tile<float> { static constexpr int kRows = 32; };
template <> struct Tile<__nv_bfloat16> { static constexpr int kRows = 64; };

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);  // round to nearest even, as torch's cast
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
decode_attn_kernel(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, const int* __restrict__ kv_len,
                   T* __restrict__ out, float* __restrict__ m_part,
                   float* __restrict__ l_part, float* __restrict__ acc_part,
                   int S, int Hkv, int G, long long k_sb, long long k_ss,
                   long long k_sh, long long v_sb, long long v_ss,
                   long long v_sh, int chunk, float scale) {
  constexpr int TILE = Tile<T>::kRows;
  constexpr int VEC = 16 / sizeof(T);       // elements per 16-byte load
  constexpr int ROW_VECS = D / VEC;         // 16-byte loads per row
  constexpr int LD = D + VEC;               // padded shared row
  constexpr int GSTEP = kThreads / D;       // heads interleave in P.V
  constexpr int GPT = kMaxG / GSTEP;        // acc registers per thread
  static_assert(kThreads % TILE == 0 && kThreads % D == 0, "roles");
  static_assert(TILE * ROW_VECS % kThreads == 0, "whole staging rounds");

  __shared__ __align__(16) T k_s[TILE * LD];
  __shared__ __align__(16) T v_s[TILE * LD];
  __shared__ float q_s[kMaxG * D];
  __shared__ float p_s[kMaxG * TILE];
  __shared__ float m_s[kMaxG], l_s[kMaxG], alpha_s[kMaxG];

  const int split = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x;
  const int len = max(0, min(kv_len[b], S));
  const int lo = split * chunk;
  const int hi = min(lo + chunk, len);

  const T* qb = q + ((long long)b * Hkv + h) * G * D;
  for (int i = tid; i < G * D; i += kThreads) q_s[i] = to_f(qb[i]);
  if (tid < kMaxG) {
    m_s[tid] = kNegInf;
    l_s[tid] = 0.f;
  }
  const int c = tid % D, g0 = tid / D;
  float acc[GPT];
#pragma unroll
  for (int i = 0; i < GPT; ++i) acc[i] = 0.f;
  __syncthreads();

  const T* kb = k + b * k_sb + h * k_sh;
  const T* vb = v + b * v_sb + h * v_sh;
  for (int t0 = lo; t0 < hi; t0 += TILE) {
    const int rows = min(TILE, hi - t0);
    // Stage rows [t0, t0 + rows) of K and V; zero the rest of the tile so
    // no stale value meets a zero weight.
#pragma unroll
    for (int j = 0; j < TILE * ROW_VECS / kThreads; ++j) {
      const int i = tid + j * kThreads;
      const int r = i / ROW_VECS, e = (i % ROW_VECS) * VEC;
      uint4 kr = make_uint4(0u, 0u, 0u, 0u), vr = kr;
      if (r < rows) {
        const long long t = t0 + r;
        kr = *reinterpret_cast<const uint4*>(kb + t * k_ss + e);
        vr = *reinterpret_cast<const uint4*>(vb + t * v_ss + e);
      }
      *reinterpret_cast<uint4*>(&k_s[r * LD + e]) = kr;
      *reinterpret_cast<uint4*>(&v_s[r * LD + e]) = vr;
    }
    __syncthreads();
    {  // scores
      const int r = tid % TILE;
      for (int g = tid / TILE; g < G; g += kThreads / TILE) {
        const float* qg = q_s + g * D;
        float s = 0.f;
#pragma unroll
        for (int e = 0; e < D; e += VEC) {
          const uint4 raw = *reinterpret_cast<const uint4*>(&k_s[r * LD + e]);
          const T* kk = reinterpret_cast<const T*>(&raw);
#pragma unroll
          for (int j = 0; j < VEC; ++j) s = fmaf(qg[e + j], to_f(kk[j]), s);
        }
        p_s[g * TILE + r] = r < rows ? s * scale : kNegInf;
      }
    }
    __syncthreads();
    {  // online softmax: one warp per head
      const int warp = tid / 32, lane = tid % 32;
      for (int g = warp; g < G; g += kThreads / 32) {
        float mx = kNegInf;
        for (int r = lane; r < TILE; r += 32) mx = fmaxf(mx, p_s[g * TILE + r]);
        mx = warp_max(mx);
        const float m_old = m_s[g];
        const float m_new = fmaxf(m_old, mx);
        float sum = 0.f;
        for (int r = lane; r < TILE; r += 32) {
          const float p = r < rows ? expf(p_s[g * TILE + r] - m_new) : 0.f;
          p_s[g * TILE + r] = p;
          sum += p;
        }
        sum = warp_sum(sum);
        if (lane == 0) {
          const float alpha = expf(m_old - m_new);
          alpha_s[g] = alpha;
          l_s[g] = alpha * l_s[g] + sum;
          m_s[g] = m_new;
        }
      }
    }
    __syncthreads();
    {  // acc = alpha * acc + P . V
#pragma unroll
      for (int i = 0; i < GPT; ++i) {
        const int g = g0 + i * GSTEP;
        if (g < G) acc[i] *= alpha_s[g];
      }
      for (int r = 0; r < rows; ++r) {
        const float vv = to_f(v_s[r * LD + c]);
#pragma unroll
        for (int i = 0; i < GPT; ++i) {
          const int g = g0 + i * GSTEP;
          if (g < G) acc[i] = fmaf(p_s[g * TILE + r], vv, acc[i]);
        }
      }
    }
    __syncthreads();
  }

  const long long bh = (long long)b * Hkv + h;
  if (gridDim.x == 1) {
#pragma unroll
    for (int i = 0; i < GPT; ++i) {
      const int g = g0 + i * GSTEP;
      if (g < G) store(out + (bh * G + g) * D + c, acc[i] / fmaxf(l_s[g], 1e-30f));
    }
    return;
  }
  const long long base = (bh * gridDim.x + split) * G;
#pragma unroll
  for (int i = 0; i < GPT; ++i) {
    const int g = g0 + i * GSTEP;
    if (g < G) acc_part[(base + g) * D + c] = acc[i];
  }
  if (tid < G) {
    m_part[base + tid] = m_s[tid];
    l_part[base + tid] = l_s[tid];
  }
}

// Merge the splits of one (row, KV head) in ascending split order.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
decode_attn_merge(const float* __restrict__ m_part,
                  const float* __restrict__ l_part,
                  const float* __restrict__ acc_part, T* __restrict__ out,
                  int n_split, int G) {
  constexpr int GSTEP = kThreads / D;
  const long long bh = blockIdx.x;
  const int c = threadIdx.x % D;
  const long long base = bh * n_split * G;
  for (int g = threadIdx.x / D; g < G; g += GSTEP) {
    float M = kNegInf;
    for (int s = 0; s < n_split; ++s) M = fmaxf(M, m_part[base + s * G + g]);
    float L = 0.f, A = 0.f;
    for (int s = 0; s < n_split; ++s) {
      const long long i = base + s * G + g;
      const float w = expf(m_part[i] - M);
      L += w * l_part[i];
      A += w * acc_part[i * D + c];
    }
    store(out + (bh * G + g) * D + c, A / fmaxf(L, 1e-30f));
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const int* kv_len,
           void* out, float* m_part, float* l_part, float* acc_part, int B,
           int S, int Hkv, int G, long long k_sb, long long k_ss,
           long long k_sh, long long v_sb, long long v_ss, long long v_sh,
           int n_split, int chunk, float scale, cudaStream_t st) {
  const dim3 grid(n_split, Hkv, B);
  decode_attn_kernel<T, D><<<grid, kThreads, 0, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), kv_len, static_cast<T*>(out), m_part, l_part,
      acc_part, S, Hkv, G, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, chunk, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || n_split == 1) return static_cast<int>(err);
  decode_attn_merge<T, D><<<B * Hkv, kThreads, 0, st>>>(
      m_part, l_part, acc_part, static_cast<T*>(out), n_split, G);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_d(int D, const void* q, const void* k, const void* v,
             const int* kv_len, void* out, float* m_part, float* l_part,
             float* acc_part, int B, int S, int Hkv, int G, long long k_sb,
             long long k_ss, long long k_sh, long long v_sb, long long v_ss,
             long long v_sh, int n_split, int chunk, float scale,
             cudaStream_t st) {
#define DA_CASE(DD)                                                          \
  case DD:                                                                   \
    return launch<T, DD>(q, k, v, kv_len, out, m_part, l_part, acc_part, B,  \
                         S, Hkv, G, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh,      \
                         n_split, chunk, scale, st);
  switch (D) {
    DA_CASE(32)
    DA_CASE(64)
    DA_CASE(128)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef DA_CASE
}

}  // namespace

// Plain C entry point (bound through ctypes).  q (B, Hkv*G, D) contiguous;
// k/v element strides over (batch, position, KV head), unit stride over D,
// every row 16-byte aligned; kv_len (B,) int32; out like q.  With
// n_split > 1 the partial buffers hold B*Hkv*n_split*G (m, l) and that
// times D (acc) floats.  Returns the CUDA error of the launches (0 = ok).
extern "C" int da_launch(const void* q, const void* k, const void* v,
                         const void* kv_len, void* out, void* m_part,
                         void* l_part, void* acc_part, int B, int S, int Hkv,
                         int G, int D, long long k_sb, long long k_ss,
                         long long k_sh, long long v_sb, long long v_ss,
                         long long v_sh, int n_split, int chunk, float scale,
                         int is_bf16, void* stream) {
  if (G < 1 || G > kMaxG || n_split < 1 || chunk < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int* lens = static_cast<const int*>(kv_len);
  float* mp = static_cast<float*>(m_part);
  float* lp = static_cast<float*>(l_part);
  float* ap = static_cast<float*>(acc_part);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch_d<__nv_bfloat16>(D, q, k, v, lens, out, mp, lp, ap, B, S,
                                   Hkv, G, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh,
                                   n_split, chunk, scale, st);
  return launch_d<float>(D, q, k, v, lens, out, mp, lp, ap, B, S, Hkv, G,
                         k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, n_split, chunk,
                         scale, st);
}
