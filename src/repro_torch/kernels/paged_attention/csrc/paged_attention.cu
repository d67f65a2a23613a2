// Single-query decode straight from the paged KV pool (sm_90a).
//
// Replaces: src/repro/kernels/paged_attention/kernel.py ::
// paged_attention_kernel, its decode mode (causal=False: key position <
// lens[b]) over float32/bf16 pools and over int8 pools (the kernel's
// quantized branch, kernel.py:96-98: float32 queries, each streamed K/V
// element dequantized as float(k) * k_scale[h], the reference's float32
// product).  Its causal suffix prefill has kernels of its own,
// paged_prefill.cu, and dense_attention_kernel (kernel.py:212) has
// dense_decode.cu, split over the cache.
//
// What bounds it on an H100: decode reads every live K/V position of every
// slot once per step (2 * kv_len * KVH * hd * itemsize bytes: 1 byte an
// element in an int8 pool, half of bf16) against ~4 * kv_len * H * hd
// flops, so HBM bytes bound it (floor: bytes / 3.35 TB/s).
//
// Design: one 128-thread block per (row tile, KV head, slot).  The block
// reads its slot's fill and block-table row from device memory (no host
// sync) and walks only live keys, [0, lens[b]), KC keys at a time.  Each step gathers
// the KC keys' pool blocks through the table (keys past the end read as
// zero), converts K/V to float32 in shared memory with 16-byte loads, and
// updates running max m, denominator l and the float32 accumulator held
// in registers, with the reference's m_safe/alpha guards for fully masked
// rows and p rounded to V's compute dtype before the PV product (bf16 for
// a bf16 pool; float32, so no rounding, for float32 and int8 pools: the
// reference rounds p to the dequantized v's float32).  The query type TQ
// and the pool type TKV are separate template parameters: an int8 pool
// loads 16 codes per 16-byte vector and scales them by the KV head's
// float32 scale on the way into shared memory.  GQA is
// native: the G query heads of a KV head are rows of the same tile, so K/V
// is read once per KV head.  The tiles live in dynamic shared memory
// (Smem below): at head dim 256 they take 130-149 KB, past the 48 KB a
// static allocation may hold, so the launch raises the kernel's limit
// first.  Instantiated for head dims 16, 64, 128 and 256.  The plain FMA
// loops do not use the tensor cores and a block covers one slot's whole
// fill; split-K (flash-decoding) is later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int THREADS = 128;
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f(int8_t v) { return static_cast<float>(v); }

// p.astype(v.dtype) of the reference, v as the kernel computes with it:
// a bf16 pool rounds p to bf16; float32 and (dequantized) int8 pools keep it
template <typename TKV> __device__ __forceinline__ float round_p(float v) { return v; }
template <> __device__ __forceinline__ float round_p<__nv_bfloat16>(float v) {
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

// Dynamic shared memory of one block, in floats: q rows, K (+1 column: the
// score loop reads down columns), V, scores, then the running max,
// denominator and rescale of each row, then the KC page ids (ints).
template <int D, int RT, int KC>
struct Smem {
  static constexpr int QS = 0, KS = QS + RT * D, VS = KS + KC * (D + 1), PS = VS + KC * D,
                       MS = PS + RT * (KC + 1), LS = MS + RT, AS = LS + RT, PG = AS + RT;
  static constexpr size_t bytes = PG * sizeof(float) + KC * sizeof(int);
};

template <typename TQ, typename TKV, int D, int RT, int KC>
__global__ void __launch_bounds__(THREADS)
paged_attention_kernel(const TQ* __restrict__ q,          // [B, KVH, R, D]
                       const TKV* __restrict__ k_pool,    // [NB, KVH, BS, D]
                       const TKV* __restrict__ v_pool,    // [NB, KVH, BS, D]
                       const int32_t* __restrict__ table,  // [B, W]
                       const int32_t* __restrict__ lens,   // [B]
                       const float* __restrict__ k_scale,  // [KVH] (int8 pools)
                       const float* __restrict__ v_scale,  // [KVH] (int8 pools)
                       float* __restrict__ out,            // [B, KVH, R, D]
                       int KVH, int R, int BS, int W, float scale, float softcap) {
  constexpr bool QUANT = std::is_same<TKV, int8_t>::value;
  constexpr int VEC = 16 / sizeof(TKV);
  constexpr int NACC = (RT * D + THREADS - 1) / THREADS;
  static_assert(D % VEC == 0, "head dim must be whole 16-byte vectors");
  using L = Smem<D, RT, KC>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* const sm = reinterpret_cast<float*>(smem_raw);
  float(*const qs)[D] = reinterpret_cast<float(*)[D]>(sm + L::QS);
  float(*const ks)[D + 1] = reinterpret_cast<float(*)[D + 1]>(sm + L::KS);
  float(*const vs)[D] = reinterpret_cast<float(*)[D]>(sm + L::VS);
  float(*const ps)[KC + 1] = reinterpret_cast<float(*)[KC + 1]>(sm + L::PS);
  float* const m_s = sm + L::MS;
  float* const l_s = sm + L::LS;
  float* const a_s = sm + L::AS;
  int* const pg = reinterpret_cast<int*>(sm + L::PG);

  const int tid = threadIdx.x;
  const int r0 = blockIdx.x * RT, h = blockIdx.y, b = blockIdx.z;
  const int n_keys = max(0, min(lens[b], W * BS));
  const size_t row_base = ((size_t)b * KVH + h) * R;
  float k_sc = 1.f, v_sc = 1.f;
  if constexpr (QUANT) {
    k_sc = k_scale[h];
    v_sc = v_scale[h];
  }

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
        load_vec<TKV, VEC>(k_pool + off, kf);
        load_vec<TKV, VEC>(v_pool + off, vf);
        if constexpr (QUANT) {
#pragma unroll
          for (int i = 0; i < VEC; ++i) {
            kf[i] *= k_sc;
            vf[i] *= v_sc;
          }
        }
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
      const bool valid = (r0 + r < R) && kp < n_keys;
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
        ps[r][j] = round_p<TKV>(p);
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

struct Args {
  const void *q, *kp, *vp;
  const int32_t *table, *lens;
  const float *k_scale, *v_scale;
  float* out;
  int B, KVH, R, BS, W;
  float scale, softcap;
};

template <typename TQ, typename TKV, int D, int RT, int KC>
cudaError_t launch(const Args& a, cudaStream_t s) {
  constexpr size_t smem = Smem<D, RT, KC>::bytes;
  static_assert(smem <= 232448, "tiles exceed the 227 KB a block may use");
  auto* kern = paged_attention_kernel<TQ, TKV, D, RT, KC>;
  if (smem > 48 * 1024) {  // past the default limit: ask for it (per device, cheap)
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  dim3 grid((a.R + RT - 1) / RT, a.KVH, a.B);
  kern<<<grid, THREADS, smem, s>>>(
      static_cast<const TQ*>(a.q), static_cast<const TKV*>(a.kp),
      static_cast<const TKV*>(a.vp), a.table, a.lens, a.k_scale, a.v_scale, a.out, a.KVH,
      a.R, a.BS, a.W, a.scale, a.softcap);
  return cudaSuccess;
}

// Row tiles of the G query heads of a KV head: 1 (G = 1), 8 or 16 (16
// holds the 10 query heads of a recurrentgemma KV head with 6 rows idle,
// not 22); more than 16 take several 16-row tiles.
template <typename TQ, typename TKV, int D>
cudaError_t launch_rows(const Args& a, cudaStream_t s) {
  if (a.R == 1) return launch<TQ, TKV, D, 1, 64>(a, s);
  if (a.R <= 8) return launch<TQ, TKV, D, 8, 64>(a, s);
  return launch<TQ, TKV, D, 16, 64>(a, s);
}

// dtype code: 0 float32 pool and queries, 1 bf16 pool and queries,
// 2 int8 pool with float32 queries and per-KV-head scales
template <int D>
cudaError_t launch_dtype(const Args& a, int dtype, cudaStream_t s) {
  switch (dtype) {
    case 0:
      return launch_rows<float, float, D>(a, s);
    case 1:
      return launch_rows<__nv_bfloat16, __nv_bfloat16, D>(a, s);
    case 2:
      if (a.k_scale == nullptr || a.v_scale == nullptr) return cudaErrorInvalidValue;
      return launch_rows<float, int8_t, D>(a, s);
    default:
      return cudaErrorInvalidValue;
  }
}

// the head dims the kernel is instantiated for (_build.py HEAD_DIMS)
cudaError_t launch_head_dim(const Args& a, int D, int dtype, cudaStream_t s) {
  switch (D) {
    case 16:
      return launch_dtype<16>(a, dtype, s);
    case 64:
      return launch_dtype<64>(a, dtype, s);
    case 128:
      return launch_dtype<128>(a, dtype, s);
    case 256:
      return launch_dtype<256>(a, dtype, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// q [B,KVH,R,D] (R = G query heads; the pool dtype, float32 for an int8
// pool); pools [NB,KVH,BS,D]; table [B,W] int32; lens [B] int32 (each
// slot's kv_len); k_scale/v_scale [KVH] float32 for an int8 pool, null
// otherwise; out [B,KVH,R,D] float32, already divided by the softmax
// denominator.  dtype: 0 float32, 1 bf16, 2 int8 (see launch_dtype).
extern "C" int paged_attention_launch(const void* q, const void* kp, const void* vp,
                                      const void* table, const void* lens,
                                      const void* k_scale, const void* v_scale, void* out,
                                      int B, int KVH, int R, int D, int BS, int W,
                                      float scale, float softcap, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Args a{q, kp, vp, static_cast<const int32_t*>(table),
               static_cast<const int32_t*>(lens), static_cast<const float*>(k_scale),
               static_cast<const float*>(v_scale), static_cast<float*>(out),
               B, KVH, R, BS, W, scale, softcap};
  const cudaError_t e = launch_head_dim(a, D, dtype, s);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}
