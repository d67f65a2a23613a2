// Single-query decode over dense per-slot caches, split over the cache
// (flash-decoding) (sm_90a).
//
// Replaces: src/repro/kernels/paged_attention/kernel.py ::
// dense_attention_kernel — the length-masked streaming-softmax decode over
// k/v [B, KVH, S, hd] (keys at positions >= kv_len[b] invisible, kv_len 0
// gives zeros), softcap tanh(s/c)*c before the mask, the fully-masked-row
// guards (m_safe, alpha), p rounded to the cache dtype before the PV
// product, the output divided by max(l, 1e-30).  The reference carries
// (o, m, l) through a sequential grid and returns that triple; here each
// split of the cache produces its own triple and a second kernel merges
// them.
//
// What bounds it on an H100: a step reads every live K/V position of every
// (slot, KV head) once, 2 * kv_len * hd * itemsize bytes, against ~4 *
// kv_len * G * hd flops, so HBM bytes bound it (floor: bytes / 3.35 TB/s).
// What held the earlier design back was parallelism, not bytes: one block
// per (slot, KV head) walked the whole fill, 8 blocks on 132 SMs for
// recurrentgemma (8 slots x 1 KV head), with serial per-thread loops.
//
// Design:
// * Grid (splits x row tiles, KVH, B).  The host picks `splits` from B *
//   KVH, the cache length S and the SM count (ops.dense_split_plan: about
//   two blocks per SM) and never reads kv_len.  Each block reads kv_len[b]
//   and takes its share of [0, kv_len): the live keys are cut into
//   `splits` ranges of whole CK-key chunks, so a ring filled to 270 of
//   2048 positions splits its 270 keys, not its 2048.  A block whose range
//   is empty writes m = -1e30, l = 0 (its o is never read) and exits.
// * 128 threads.  Warps own keys: a key is read by LPK lanes, each lane
//   holding 16-byte slices of hd (DL floats), and its dots with the G query
//   rows (kept in shared memory as float32) reduce by warp shuffles.  Each
//   K/V row is read once per KV head: the G query heads of a KV head are
//   rows of one block (up to 16; more rows take more row tiles).
// * K/V chunks of CK keys come through a ring of cp.async copies (3 to 8
//   stages, about 32 KB; zero-filled past the block's range), so the next
//   chunks are in flight while one is computed.  A key's dots with the
//   rows reduce by halving the rows at each shuffle step (each lane keeps
//   one half, its partner the other).  Scores go to shared memory; after
//   one barrier every thread reads the chunk's scores of each row and
//   applies the running-max update of the split with the reference's
//   m_safe/alpha guards (every thread holds the same m), then adds p * v
//   for its own keys, p rounded to bf16 for a bf16 cache against that
//   running max, as each reference tile rounds it; p = 2^(x log2(e) - m
//   log2(e)) on ex2.approx.  The partial sums of the key owners are added
//   in a fixed order at the end (warp shuffles, then the warps' sums
//   through shared memory): no atomics, the same bits every run.  The loops
//   run over every row of the tile (rows past G have zero queries) so that
//   nothing in them branches.
// * The scores stay on FMAs at every G: a split holds a few chunks, the
//   step is bound by latency and bytes, not by flops.  With 16-row tiles
//   (G up to 16) a thread keeps 16 rows x 8 accumulators: ptxas gives the
//   hd-256 bf16 instantiation 255 registers and no spill, two blocks an SM.
// * Merge (dense_merge_kernel, one block per query row, the splits taken in
//   parallel): M = max m_i over non-empty splits, o = sum e^(m_i - M) o_i /
//   max(sum e^(m_i - M) l_i, 1e-30), zeros when every split is empty
//   (kv_len 0), written once in the query's dtype (bf16 round to nearest
//   even).  It runs at every split count, one split included, so the
//   output has one path.
// Instantiated for head dims 16, 64, 128, 256, float32 and bf16 caches,
// and row tiles of 1, 4 and 16 query rows.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "../../common/hopper.cuh"

namespace {

using hopper::cp_async16;
using hopper::cp_async_commit;
using hopper::cp_async_wait;
using hopper::ex2;  // relative error 2^-22; denormal results flush to zero
using hopper::smem_u32;

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int CK = 16;  // keys per chunk: the unit the splits are cut in (ops.DENSE_CHUNK)
constexpr int SSW = CK + 4;  // a score row in shared memory: whole 16-byte vectors
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

// p.astype(v.dtype) of the reference: a bf16 cache rounds p to bf16
template <typename T> __device__ __forceinline__ float round_p(float v) { return v; }
template <> __device__ __forceinline__ float round_p<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

template <typename T, int D>
struct Geom {
  static constexpr int VEC = 16 / sizeof(T);          // elements per 16-byte vector
  static constexpr int NVEC = D / VEC;                // vectors per row
  static constexpr int LPK = NVEC < 32 ? NVEC : 32;   // lanes per key
  static constexpr int NV = NVEC / LPK;               // vectors per lane
  static constexpr int DL = NV * VEC;                 // elements per lane
  static constexpr int KPW = 32 / LPK;                // keys a warp reads at once
  static constexpr int NSLOT = WARPS * KPW;           // key slots of the block
  static constexpr int PASSES = (CK + NSLOT - 1) / NSLOT;
  static constexpr int STAGE = 2 * CK * D * sizeof(T);  // bytes of a chunk's K and V
  // ring stages: about 32 KB of chunks in flight, 3 to 8 of them
  static constexpr int STAGES = 32768 / STAGE < 3 ? 3 : (32768 / STAGE > 8 ? 8 : 32768 / STAGE);
  static_assert(D % VEC == 0 && NVEC % LPK == 0, "head dim must be whole 16-byte vectors");
  static_assert(CK % KPW == 0, "a warp's key slots lie wholly inside or outside a chunk");
};

// Dynamic shared memory, in bytes: the K/V ring and the query rows as
// float32, which the warps' partial sums reuse at the end; the chunk's
// scores; the warps' partial denominators.
template <typename T, int D, int GT>
struct Smem {
  using G = Geom<T, D>;
  static constexpr size_t RING = 0, QS = G::STAGES * G::STAGE,
                          SUMS = WARPS * GT * D * sizeof(float),
                          SS = QS + GT * D * sizeof(float) > SUMS ? QS + GT * D * sizeof(float)
                                                                  : SUMS,
                          LS = SS + GT * SSW * sizeof(float),
                          bytes = LS + WARPS * GT * sizeof(float);
};

// Sums v[0, N) over the lane groups of a key (lane offsets OFF, OFF/2, ..,
// 1), scattering rows as it halves them: each step a lane keeps one half of
// its rows and sends the other to its partner, so N rows over L lanes take
// N - 1 + log2(L / N) shuffles, not N log2(L).  On return v[0, max(N / L,
// 1)) holds the totals of rows base, base + 1, ...
// (The array goes by reference with its size, not by pointer: a pointer
// sends it to local memory.)
template <int N, int OFF, int M>
__device__ __forceinline__ void reduce_rows(float (&v)[M], int lane, int& base) {
  if constexpr (OFF > 0) {
    if constexpr (N == 1) {
      v[0] += __shfl_xor_sync(FULL, v[0], OFF);
    } else {
      const bool up = lane & OFF;
#pragma unroll
      for (int i = 0; i < N / 2; ++i) {
        const float keep = up ? v[i + N / 2] : v[i], send = up ? v[i] : v[i + N / 2];
        v[i] = keep + __shfl_xor_sync(FULL, send, OFF);
      }
      if (up) base += N / 2;
    }
    reduce_rows<(N > 1 ? N / 2 : 1), OFF / 2>(v, lane, base);
  }
}

// Element index d of lane slice (vector nv, element e): lane sl of a key's
// LPK lanes holds vectors sl, sl + LPK, ...
template <typename T, int D>
__device__ __forceinline__ int dim_of(int sl, int nv, int e) {
  using G = Geom<T, D>;
  return (nv * G::LPK + sl) * G::VEC + e;
}

template <typename T, int D>
__device__ __forceinline__ void load_slice(const T* row, int sl, float (&f)[Geom<T, D>::DL]) {
  using G = Geom<T, D>;
#pragma unroll
  for (int nv = 0; nv < G::NV; ++nv) {
    const uint4 w = *reinterpret_cast<const uint4*>(row + dim_of<T, D>(sl, nv, 0));
    const T* e = reinterpret_cast<const T*>(&w);
#pragma unroll
    for (int i = 0; i < G::VEC; ++i) f[nv * G::VEC + i] = to_f(e[i]);
  }
}

template <typename T, int D, int GT>
__global__ void __launch_bounds__(THREADS)
dense_split_kernel(const T* __restrict__ q,        // [B, KVH, G, D]
                   const T* __restrict__ k,        // [B, KVH, S, D]
                   const T* __restrict__ v,        // [B, KVH, S, D]
                   const int32_t* __restrict__ lens,  // [B]
                   float* __restrict__ o_part,     // [B, KVH, G, splits, D]
                   float* __restrict__ m_part,     // [B, KVH, G, splits]
                   float* __restrict__ l_part,     // [B, KVH, G, splits]
                   int KVH, int G, int S, int splits, float scale, float softcap) {
  using Gm = Geom<T, D>;
  using L = Smem<T, D, GT>;
  constexpr int DL = Gm::DL, STAGES = Gm::STAGES;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* const ring = reinterpret_cast<T*>(smem_raw + L::RING);
  float(*const qs)[D] = reinterpret_cast<float(*)[D]>(smem_raw + L::QS);
  float(*const sums)[GT][D] = reinterpret_cast<float(*)[GT][D]>(smem_raw);
  float(*const ss)[SSW] = reinterpret_cast<float(*)[SSW]>(smem_raw + L::SS);
  float(*const ls)[GT] = reinterpret_cast<float(*)[GT]>(smem_raw + L::LS);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int split = blockIdx.x % splits, g0 = (blockIdx.x / splits) * GT;
  const int h = blockIdx.y, b = blockIdx.z;
  const int GR = min(GT, G - g0);  // query rows of this tile
  const size_t row0 = ((size_t)b * KVH + h) * G + g0;

  // this split's keys: whole CK-key chunks of the live range [0, n)
  const int n = max(0, min(lens[b], S));
  const int per = ((n + CK - 1) / CK + splits - 1) / splits;
  const int lo = split * per * CK, hi = min(n, lo + per * CK);
  if (lo >= hi) {
    if (tid < GR) {
      m_part[(row0 + tid) * splits + split] = NEG_INF;
      l_part[(row0 + tid) * splits + split] = 0.f;
    }
    return;
  }
  const int n_chunks = (hi - lo + CK - 1) / CK;
  const size_t kv0 = ((size_t)b * KVH + h) * S;

  // the tile's query rows as float32, 16-byte loads all in flight at once
#pragma unroll
  for (int c = tid; c < GT * Gm::NVEC; c += THREADS) {
    const int g = c / Gm::NVEC, dv = (c % Gm::NVEC) * Gm::VEC;
    float f[Gm::VEC];
    if (g < GR) {
      const uint4 w = *reinterpret_cast<const uint4*>(q + (row0 + g) * D + dv);
      const T* e = reinterpret_cast<const T*>(&w);
#pragma unroll
      for (int i = 0; i < Gm::VEC; ++i) f[i] = to_f(e[i]);
    } else {
#pragma unroll
      for (int i = 0; i < Gm::VEC; ++i) f[i] = 0.f;
    }
#pragma unroll
    for (int i = 0; i < Gm::VEC; i += 4)
      *reinterpret_cast<float4*>(&qs[g][dv + i]) = make_float4(f[i], f[i + 1], f[i + 2], f[i + 3]);
  }

  auto issue = [&](int c) {  // chunk c of this split into its ring stage
    if (c < n_chunks) {
      T* const st = ring + (c % STAGES) * 2 * CK * D;
      for (int p = tid; p < 2 * CK * Gm::NVEC; p += THREADS) {
        const int which = p / (CK * Gm::NVEC), r = p % (CK * Gm::NVEC);
        const int j = r / Gm::NVEC, dv = (r % Gm::NVEC) * Gm::VEC;
        const int kp = lo + c * CK + j;
        const bool ok = kp < hi;
        const T* src = (which ? v : k) + (kv0 + (ok ? kp : lo)) * D + dv;
        cp_async16(smem_u32(st + (which * CK + j) * D + dv), src, ok);
      }
    }
    cp_async_commit();  // empty groups keep the count uniform
  };
#pragma unroll
  for (int c = 0; c < STAGES - 1; ++c) issue(c);

  const int grp = lane / Gm::LPK, sl = lane % Gm::LPK;
  const int slot = warp * Gm::KPW + grp;  // this lane's key slot in a chunk
  float m[GT], l[GT], o[GT][DL];
#pragma unroll
  for (int g = 0; g < GT; ++g) {
    m[g] = NEG_INF;
    l[g] = 0.f;
#pragma unroll
    for (int i = 0; i < DL; ++i) o[g][i] = 0.f;
  }

  for (int c = 0; c < n_chunks; ++c) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // chunk c landed for every thread; chunk c-1's readers are done
    issue(c + STAGES - 1);
    const T* const kst = ring + (c % STAGES) * 2 * CK * D;
    const T* const vst = kst + CK * D;
    const int base = lo + c * CK;

    // scores of this lane's keys against every row of the tile (rows past
    // G have zero queries: computing them keeps the loops free of branches)
#pragma unroll
    for (int i = 0; i < Gm::PASSES; ++i) {
      const int j = slot + i * Gm::NSLOT;
      float kf[DL], dot[GT];
      load_slice<T, D>(kst + min(j, CK - 1) * D, sl, kf);
#pragma unroll
      for (int g = 0; g < GT; ++g) {
        dot[g] = 0.f;
#pragma unroll
        for (int nv = 0; nv < Gm::NV; ++nv) {
#pragma unroll
          for (int e = 0; e < Gm::VEC; e += 4) {
            const float4 qv =
                *reinterpret_cast<const float4*>(&qs[g][dim_of<T, D>(sl, nv, e)]);
            dot[g] += qv.x * kf[nv * Gm::VEC + e] + qv.y * kf[nv * Gm::VEC + e + 1] +
                      qv.z * kf[nv * Gm::VEC + e + 2] + qv.w * kf[nv * Gm::VEC + e + 3];
          }
        }
      }
      int r = 0;  // this lane ends with the totals of rows r, r + 1, ...
      reduce_rows<GT, Gm::LPK / 2>(dot, lane, r);
      constexpr int HELD = GT / Gm::LPK > 1 ? GT / Gm::LPK : 1;
      if (j < CK) {
#pragma unroll
        for (int t = 0; t < HELD; ++t) {
          float x = dot[t] * scale;
          if (softcap > 0.f) x = tanhf(x / softcap) * softcap;
          ss[r + t][j] = base + j < hi ? x : NEG_INF;  // lanes holding a row agree
        }
      }
    }
    __syncthreads();  // the chunk's scores are in shared memory

    // the split's running max of each row (every thread computes the same);
    // e^(x - m) is taken as 2^(x log2(e) - m log2(e))
    float m_l2[GT];
#pragma unroll
    for (int g = 0; g < GT; ++g) {
      float mx = m[g];
#pragma unroll
      for (int j = 0; j < CK; j += 4) {
        const float4 sv = *reinterpret_cast<const float4*>(&ss[g][j]);
        mx = fmaxf(fmaxf(mx, sv.x), fmaxf(sv.y, fmaxf(sv.z, sv.w)));
      }
      // guard fully-masked rows exactly as the reference kernel does
      const float m_safe = mx <= NEG_INF / 2 ? 0.f : mx;
      const float alpha = m[g] <= NEG_INF / 2 ? 0.f : ex2((m[g] - m_safe) * LOG2E);
      m[g] = mx;
      m_l2[g] = m_safe * LOG2E;
      l[g] *= alpha;
#pragma unroll
      for (int e = 0; e < DL; ++e) o[g][e] *= alpha;
    }
    // then p * v for this lane's keys
#pragma unroll
    for (int i = 0; i < Gm::PASSES; ++i) {
      const int j = slot + i * Gm::NSLOT;
      float vf[DL];
      load_slice<T, D>(vst + min(j, CK - 1) * D, sl, vf);
#pragma unroll
      for (int g = 0; g < GT; ++g) {
        const float sv = ss[g][min(j, CK - 1)];
        const float p = j < CK && sv > NEG_INF / 2 ? ex2(fmaf(sv, LOG2E, -m_l2[g])) : 0.f;
        l[g] += p;  // the denominator sums the unrounded p
        const float pr = round_p<T>(p);
#pragma unroll
        for (int e = 0; e < DL; ++e) o[g][e] += pr * vf[e];
      }
    }
  }
  cp_async_wait<0>();

  // sum the key owners: the KPW key groups of a warp by shuffles, then the
  // warps' sums through shared memory in a fixed order
#pragma unroll
  for (int off = Gm::LPK; off < 32; off <<= 1) {
#pragma unroll
    for (int g = 0; g < GT; ++g) {
      l[g] += __shfl_xor_sync(FULL, l[g], off);
#pragma unroll
      for (int e = 0; e < DL; ++e) o[g][e] += __shfl_xor_sync(FULL, o[g][e], off);
    }
  }
  __syncthreads();  // every thread is done with the ring and qs: they take the sums
  if (grp == 0) {
#pragma unroll
    for (int g = 0; g < GT; ++g) {
#pragma unroll
      for (int nv = 0; nv < Gm::NV; ++nv)
#pragma unroll
        for (int e = 0; e < Gm::VEC; e += 4)
          *reinterpret_cast<float4*>(&sums[warp][g][dim_of<T, D>(sl, nv, e)]) =
              make_float4(o[g][nv * Gm::VEC + e], o[g][nv * Gm::VEC + e + 1],
                          o[g][nv * Gm::VEC + e + 2], o[g][nv * Gm::VEC + e + 3]);
      if (sl == 0) ls[warp][g] = l[g];
    }
  }
  __syncthreads();

  for (int e = tid; e < GR * D; e += THREADS) {
    const int g = e / D, d = e % D;
    float acc = sums[0][g][d], den = ls[0][g];
#pragma unroll
    for (int w = 1; w < WARPS; ++w) {
      acc += sums[w][g][d];
      den += ls[w][g];
    }
    o_part[((row0 + g) * splits + split) * D + d] = acc;
    if (d == 0) l_part[(row0 + g) * splits + split] = den;
  }
#pragma unroll
  for (int g = 0; g < GT; ++g)
    if (tid == g && g < GR) m_part[(row0 + g) * splits + split] = m[g];
}

// One block per query row: the splits' (o, m, l) -> the normalized output.
// The splits' weights e^(m_i - M) are taken in parallel, then each thread
// sums a 4-column slice of o over every (THREADS / (D / 4))-th split, its
// loads unrolled so several are in flight, and the slices' partial sums are
// added in a fixed order.  Dynamic shared memory: the splits' weights.
__device__ __forceinline__ float block_reduce(float v, bool is_max, float* red) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float o = __shfl_xor_sync(0xffffffffu, v, off);
    v = is_max ? fmaxf(v, o) : v + o;
  }
  if (lane == 0) red[warp] = v;
  __syncthreads();
  v = red[0];
#pragma unroll
  for (int w = 1; w < WARPS; ++w) v = is_max ? fmaxf(v, red[w]) : v + red[w];
  __syncthreads();  // red is reused
  return v;
}

template <typename TO>
__global__ void __launch_bounds__(THREADS)
dense_merge_kernel(const float* __restrict__ o_part, const float* __restrict__ m_part,
                   const float* __restrict__ l_part, TO* __restrict__ out, int D,
                   int splits) {
  extern __shared__ float wts[];  // [splits]
  __shared__ float red[WARPS];
  __shared__ float4 acc_s[THREADS];
  const int tid = threadIdx.x;
  const size_t row = blockIdx.x;
  const float* mr = m_part + row * splits;
  const float* lr = l_part + row * splits;
  float mx = NEG_INF;
  for (int i = tid; i < splits; i += THREADS) mx = fmaxf(mx, mr[i]);
  mx = block_reduce(mx, true, red);
  float lsum = 0.f;
  for (int i = tid; i < splits; i += THREADS) {
    const float w = mr[i] > NEG_INF / 2 ? expf(mr[i] - mx) : 0.f;  // empty splits weigh 0
    wts[i] = w;
    lsum += w * lr[i];
  }
  lsum = block_reduce(lsum, false, red);  // its barrier also publishes wts
  const int nc4 = D / 4, groups = THREADS / nc4, c4 = tid % nc4, sg = tid / nc4;
  const float4* o4 = reinterpret_cast<const float4*>(o_part) + row * splits * nc4 + c4;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  if (sg < groups) {
#pragma unroll 4
    for (int i = sg; i < splits; i += groups) {
      const float w = wts[i];
      if (w != 0.f) {  // an empty split's o was never written
        const float4 v = o4[(size_t)i * nc4];
        acc.x += w * v.x;
        acc.y += w * v.y;
        acc.z += w * v.z;
        acc.w += w * v.w;
      }
    }
  }
  acc_s[tid] = acc;
  __syncthreads();
  if (tid < nc4) {
    float4 a = acc_s[tid];
    for (int gi = 1; gi < groups; ++gi) {
      const float4 b = acc_s[gi * nc4 + tid];
      a.x += b.x;
      a.y += b.y;
      a.z += b.z;
      a.w += b.w;
    }
    const float den = fmaxf(lsum, 1e-30f);  // divided, as the reference divides
    TO* o = out + row * D + 4 * tid;
    store(o, a.x / den);
    store(o + 1, a.y / den);
    store(o + 2, a.z / den);
    store(o + 3, a.w / den);
  }
}

struct Args {
  const void *q, *k, *v;
  const int32_t* lens;
  float *o_part, *m_part, *l_part;
  int B, KVH, G, S, splits;
  float scale, softcap;
};

template <typename T, int D, int GT>
cudaError_t launch(const Args& a, cudaStream_t s) {
  constexpr size_t smem = Smem<T, D, GT>::bytes;
  static_assert(smem <= 232448, "tiles exceed the 227 KB a block may use");
  auto* kern = dense_split_kernel<T, D, GT>;
  if (smem > 48 * 1024) {  // past the default limit: ask for it (per device, cheap)
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  const int row_tiles = (a.G + GT - 1) / GT;
  dim3 grid(a.splits * row_tiles, a.KVH, a.B);
  kern<<<grid, THREADS, smem, s>>>(static_cast<const T*>(a.q), static_cast<const T*>(a.k),
                                   static_cast<const T*>(a.v), a.lens, a.o_part, a.m_part,
                                   a.l_part, a.KVH, a.G, a.S, a.splits, a.scale, a.softcap);
  return cudaSuccess;
}

// One instantiation of the split kernel: cache dtype, head dim, row tile.
template <typename T, int D_, int GT_>
struct Tile {
  using type = T;
  static constexpr int D = D_, GT = GT_;
};

// Calls f(Tile<T, D, GT>{}) for the instantiation that serves head dim D
// with G query rows per KV head, row tiles of 1 (G = 1), 4 (GQA up to 4)
// or 16 query rows (recurrentgemma's 10); returns `none` for a head dim it
// is not built for.  The launch and the shared-memory query both take it.
template <typename T, int D, typename R, typename F>
R with_rows(int G, F&& f) {
  if (G == 1) return f(Tile<T, D, 1>{});
  if (G <= 4) return f(Tile<T, D, 4>{});
  return f(Tile<T, D, 16>{});
}

template <typename T, typename R, typename F>
R with_tile(int D, int G, R none, F&& f) {
  switch (D) {  // the head dims the kernel is instantiated for (_build.py HEAD_DIMS)
    case 16:
      return with_rows<T, 16, R>(G, f);
    case 64:
      return with_rows<T, 64, R>(G, f);
    case 128:
      return with_rows<T, 128, R>(G, f);
    case 256:
      return with_rows<T, 256, R>(G, f);
    default:
      return none;
  }
}

template <typename T>
cudaError_t launch_tile(const Args& a, int D, cudaStream_t s) {
  return with_tile<T>(D, a.G, cudaErrorInvalidValue, [&](auto t) {
    using Tl = decltype(t);
    return launch<typename Tl::type, Tl::D, Tl::GT>(a, s);
  });
}

template <typename T>
int smem_of(int D, int G) {
  return with_tile<T>(D, G, 0, [](auto t) {
    using Tl = decltype(t);
    return static_cast<int>(Smem<typename Tl::type, Tl::D, Tl::GT>::bytes);
  });
}

}  // namespace

// q [B,KVH,G,D] and caches k/v [B,KVH,S,D] of one dtype (0 float32, 1
// bf16), contiguous with 16-byte aligned starts; lens [B] int32 = kv_len;
// splits >= 1 ranges per (slot, KV head); o_part [B,KVH,G,splits,D],
// m_part and l_part [B,KVH,G,splits] float32 scratch; out [B,KVH,G,D] in
// out_dtype (0 float32, 1 bf16).  Launches the split kernel, then the
// merge.  Returns a cudaError_t.
extern "C" int dense_attention_launch(const void* q, const void* k, const void* v,
                                      const void* lens, void* o_part, void* m_part,
                                      void* l_part, void* out, int B, int KVH, int G, int D,
                                      int S, int splits, float scale, float softcap,
                                      int dtype, int out_dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || B > 65535 || KVH <= 0 || KVH > 65535 || G <= 0 || S <= 0 || splits <= 0 ||
      (out_dtype != 0 && out_dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{q, k, v, static_cast<const int32_t*>(lens), static_cast<float*>(o_part),
               static_cast<float*>(m_part), static_cast<float*>(l_part), B, KVH, G, S,
               splits, scale, softcap};
  cudaError_t e;
  if (dtype == 0)
    e = launch_tile<float>(a, D, s);
  else if (dtype == 1)
    e = launch_tile<__nv_bfloat16>(a, D, s);
  else
    e = cudaErrorInvalidValue;
  if (e != cudaSuccess) return static_cast<int>(e);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const unsigned rows = static_cast<unsigned>(B) * KVH * G;
  const size_t wbytes = static_cast<size_t>(splits) * sizeof(float);
  if (out_dtype == 1)
    dense_merge_kernel<__nv_bfloat16><<<rows, THREADS, wbytes, s>>>(
        a.o_part, a.m_part, a.l_part, static_cast<__nv_bfloat16*>(out), D, splits);
  else
    dense_merge_kernel<float><<<rows, THREADS, wbytes, s>>>(a.o_part, a.m_part, a.l_part,
                                                            static_cast<float*>(out), D, splits);
  return static_cast<int>(cudaGetLastError());
}

// Dynamic shared memory of the split kernel at head dim D, cache dtype
// (0 float32, 1 bf16) and G query rows per KV head; 0 for a shape it is
// not built for.
extern "C" int dense_attention_smem_bytes(int D, int dtype, int G) {
  if (G <= 0) return 0;
  return static_cast<int>(dtype == 0 ? smem_of<float>(D, G)
                                     : (dtype == 1 ? smem_of<__nv_bfloat16>(D, G) : 0));
}
