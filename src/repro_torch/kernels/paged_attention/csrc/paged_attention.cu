// Streaming-softmax attention straight from the paged KV pool (sm_90a).
//
// Replaces: src/repro/kernels/paged_attention/kernel.py ::
// paged_attention_kernel, both modes — single-query decode (key position
// < lens[b]) and causal suffix prefill (row r of a tile sits at absolute
// position lens[b] + r % q_len; keys at or before it are visible).
//
// What bounds it on an H100: decode reads every live K/V position of every
// slot once per step (2 * kv_len * KVH * hd * itemsize bytes) against
// ~4 * kv_len * H * hd flops, so HBM bytes bound it (floor: bytes /
// 3.35 TB/s).  Prefill over S suffix rows reuses each K/V position S times
// and becomes compute bound once S passes a few hundred.
//
// Design: one 128-thread block per (row tile, KV head, slot).  The block
// reads its slot's fill and block-table row from device memory (no host
// sync) and walks only live keys — [0, lens[b]) in decode, up to the tile's
// last row position in causal mode — KC keys at a time.  Each step gathers
// the KC keys' pool blocks through the table (keys past the end read as
// zero), converts K/V to float32 in shared memory with 16-byte loads, and
// updates running max m, denominator l and the float32 accumulator held
// in registers, with the reference's m_safe/alpha guards for fully masked
// rows and p rounded to the pool dtype before the PV product.  GQA is
// native: the G query heads of a KV head are rows of the same tile, so K/V
// is read once per KV head.  The plain FMA loops do not use the tensor
// cores and a decode block covers one slot's whole fill; split-K
// (flash-decoding) and wgmma tiles are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

// p.astype(v.dtype) of the reference: round to the pool dtype, back to f32
template <typename T> __device__ __forceinline__ float round_to(float v);
template <> __device__ __forceinline__ float round_to<float>(float v) { return v; }
template <> __device__ __forceinline__ float round_to<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

// 16 bytes of T -> floats
template <typename T, int VEC>
__device__ __forceinline__ void load_vec(const T* __restrict__ src, float (&dst)[VEC]) {
  const uint4 w = *reinterpret_cast<const uint4*>(src);
  const T* e = reinterpret_cast<const T*>(&w);
#pragma unroll
  for (int i = 0; i < VEC; ++i) dst[i] = to_f(e[i]);
}

template <typename T, int D, int RT, int KC>
__global__ void __launch_bounds__(THREADS)
paged_attention_kernel(const T* __restrict__ q,          // [B, KVH, R, D] pool dtype
                       const T* __restrict__ k_pool,     // [NB, KVH, BS, D]
                       const T* __restrict__ v_pool,     // [NB, KVH, BS, D]
                       const int32_t* __restrict__ table,  // [B, W]
                       const int32_t* __restrict__ lens,   // [B]
                       float* __restrict__ out,            // [B, KVH, R, D]
                       int KVH, int R, int BS, int W, int q_len, int causal,
                       float scale, float softcap) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int NACC = (RT * D + THREADS - 1) / THREADS;
  static_assert(D % VEC == 0, "head dim must be whole 16-byte vectors");
  __shared__ float qs[RT][D];
  __shared__ float ks[KC][D + 1];  // +1: the score loop reads down columns
  __shared__ float vs[KC][D];
  __shared__ float ps[RT][KC + 1];
  __shared__ float m_s[RT], l_s[RT], a_s[RT];
  __shared__ int pg[KC];

  const int tid = threadIdx.x;
  const int r0 = blockIdx.x * RT, h = blockIdx.y, b = blockIdx.z;
  const int n = lens[b];
  int n_keys;
  if (causal) {
    const int r_last = min(r0 + RT, R) - 1;
    const int i_hi = (r0 / q_len != r_last / q_len) ? q_len - 1 : r_last % q_len;
    n_keys = n + i_hi + 1;
  } else {
    n_keys = n;
  }
  n_keys = max(0, min(n_keys, W * BS));
  const size_t row_base = ((size_t)b * KVH + h) * R;

  for (int e = tid; e < RT * D; e += THREADS) {
    const int r = e / D, d = e % D;
    qs[r][d] = (r0 + r < R) ? to_f(q[(row_base + r0 + r) * D + d]) : 0.f;
  }
  if (tid < RT) {
    m_s[tid] = NEG_INF;
    l_s[tid] = 0.f;
  }
  float acc[NACC];
#pragma unroll
  for (int i = 0; i < NACC; ++i) acc[i] = 0.f;
  __syncthreads();

  for (int base = 0; base < n_keys; base += KC) {
    if (tid < KC) {
      const int kp = base + tid;
      pg[tid] = kp < n_keys ? table[(size_t)b * W + kp / BS] : 0;
    }
    __syncthreads();
    for (int c = tid; c < KC * (D / VEC); c += THREADS) {
      const int j = c / (D / VEC), dv = (c % (D / VEC)) * VEC;
      const int kp = base + j;
      float kf[VEC], vf[VEC];
      if (kp < n_keys) {
        const size_t off = (((size_t)pg[j] * KVH + h) * BS + kp % BS) * D + dv;
        load_vec<T, VEC>(k_pool + off, kf);
        load_vec<T, VEC>(v_pool + off, vf);
      } else {
#pragma unroll
        for (int i = 0; i < VEC; ++i) kf[i] = vf[i] = 0.f;
      }
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        ks[j][dv + i] = kf[i];
        vs[j][dv + i] = vf[i];
      }
    }
    __syncthreads();
    for (int e = tid; e < RT * KC; e += THREADS) {
      const int r = e / KC, j = e % KC;
      const int kp = base + j;
      const bool valid = (r0 + r < R) && kp < n_keys &&
                         (causal ? kp <= n + (r0 + r) % q_len : kp < n);
      float s = 0.f;
#pragma unroll 16
      for (int d = 0; d < D; ++d) s += qs[r][d] * ks[j][d];
      s *= scale;
      if (softcap > 0.f) s = tanhf(s / softcap) * softcap;
      ps[r][j] = valid ? s : NEG_INF;
    }
    __syncthreads();
    if (tid < RT) {
      const int r = tid;
      const float m_prev = m_s[r];
      float mx = m_prev;
      for (int j = 0; j < KC; ++j) mx = fmaxf(mx, ps[r][j]);
      // guard fully-masked rows exactly as the reference kernel does
      const float m_safe = mx <= NEG_INF / 2 ? 0.f : mx;
      const float alpha = m_prev <= NEG_INF / 2 ? 0.f : expf(m_prev - m_safe);
      float lsum = 0.f;
      for (int j = 0; j < KC; ++j) {
        const float s = ps[r][j];
        const float p = s > NEG_INF / 2 ? expf(s - m_safe) : 0.f;
        lsum += p;
        ps[r][j] = round_to<T>(p);
      }
      l_s[r] = alpha * l_s[r] + lsum;
      m_s[r] = mx;
      a_s[r] = alpha;
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < NACC; ++i) {
      const int e = tid + i * THREADS;
      if (e < RT * D) {
        const int r = e / D, d = e % D;
        float sum = 0.f;
        for (int j = 0; j < KC; ++j) sum += ps[r][j] * vs[j][d];
        acc[i] = a_s[r] * acc[i] + sum;
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < NACC; ++i) {
    const int e = tid + i * THREADS;
    if (e < RT * D) {
      const int r = e / D, d = e % D;
      if (r0 + r < R) out[(row_base + r0 + r) * D + d] = acc[i] / fmaxf(l_s[r], 1e-30f);
    }
  }
}

template <typename T, int D, int RT, int KC>
void launch(const void* q, const void* kp, const void* vp, const int32_t* table,
            const int32_t* lens, float* out, int B, int KVH, int R, int BS, int W,
            int q_len, int causal, float scale, float softcap, cudaStream_t s) {
  dim3 grid((R + RT - 1) / RT, KVH, B);
  paged_attention_kernel<T, D, RT, KC><<<grid, THREADS, 0, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(kp), static_cast<const T*>(vp),
      table, lens, out, KVH, R, BS, W, q_len, causal, scale, softcap);
}

// Row tiles: 1 (decode, G = 1), 8 (decode with GQA) or 32 rows (prefill).
template <typename T, int D>
void launch_rows(const void* q, const void* kp, const void* vp, const int32_t* table,
                 const int32_t* lens, float* out, int B, int KVH, int R, int BS, int W,
                 int q_len, int causal, float scale, float softcap, cudaStream_t s) {
  if (R == 1)
    launch<T, D, 1, 64>(q, kp, vp, table, lens, out, B, KVH, R, BS, W, q_len, causal,
                        scale, softcap, s);
  else if (R <= 8)
    launch<T, D, 8, 64>(q, kp, vp, table, lens, out, B, KVH, R, BS, W, q_len, causal,
                        scale, softcap, s);
  else
    launch<T, D, 32, 32>(q, kp, vp, table, lens, out, B, KVH, R, BS, W, q_len, causal,
                         scale, softcap, s);
}

}  // namespace

// q [B,KVH,R,D] in pool dtype; pools [NB,KVH,BS,D]; table [B,W] int32;
// lens [B] int32 (kv_len in decode, suffix start when causal); out
// [B,KVH,R,D] float32, already divided by the softmax denominator.
extern "C" int paged_attention_launch(const void* q, const void* kp, const void* vp,
                                      const void* table, const void* lens, void* out,
                                      int B, int KVH, int R, int D, int BS, int W,
                                      int q_len, int causal, float scale, float softcap,
                                      int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int32_t* tb = static_cast<const int32_t*>(table);
  const int32_t* ln = static_cast<const int32_t*>(lens);
  float* o = static_cast<float*>(out);
  if (D == 64 && is_bf16)
    launch_rows<__nv_bfloat16, 64>(q, kp, vp, tb, ln, o, B, KVH, R, BS, W, q_len, causal,
                                   scale, softcap, s);
  else if (D == 64)
    launch_rows<float, 64>(q, kp, vp, tb, ln, o, B, KVH, R, BS, W, q_len, causal, scale,
                           softcap, s);
  else if (D == 16 && is_bf16)
    launch_rows<__nv_bfloat16, 16>(q, kp, vp, tb, ln, o, B, KVH, R, BS, W, q_len, causal,
                                   scale, softcap, s);
  else if (D == 16)
    launch_rows<float, 16>(q, kp, vp, tb, ln, o, B, KVH, R, BS, W, q_len, causal, scale,
                           softcap, s);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
