// Single-query decode split over the keys (flash-decoding), over dense
// per-slot caches and over the paged KV pool through its block table
// (sm_90a).
//
// Replaces: src/repro/kernels/paged_attention/kernel.py ::
// dense_attention_kernel (kernel.py:212), the length-masked streaming-
// softmax decode over k/v [B, KVH, S, hd], and paged_attention_kernel
// (kernel.py:146) in its decode mode (causal=False), the same softmax over
// keys read through table [B, W] from pools [NB, KVH, BS, hd] of float32,
// bf16 or int8 codes (its quantized branch, kernel.py:96-98: float32
// queries, codes scaled by the KV head's k_scale / v_scale).  Both: keys at
// positions >= kv_len[b] invisible, kv_len 0 gives zeros, softcap
// tanh(s/c)*c before the mask, the fully-masked-row guards (m_safe, alpha),
// p rounded to the cache dtype before the PV product (bf16 for a bf16
// cache; float32 and int8 pools keep it, as the reference rounds it to the
// dequantized float32 v), the output divided by max(l, 1e-30).  The
// reference carries (o, m, l) through a sequential grid and returns that
// triple; here each split of the keys produces its own triple and a second
// kernel merges them.  The causal mode of paged_attention_kernel has its
// own kernels (paged_prefill.cu).
//
// What bounds it on an H100: a step reads every live K/V position of every
// (slot, KV head) once, 2 * kv_len * hd * itemsize bytes (1 byte a code in
// an int8 pool), against ~4 * kv_len * G * hd flops, so HBM bytes bound it
// (floor: bytes / 3.35 TB/s).  What holds such a kernel back is
// parallelism and latency, not bytes: one block per (slot, KV head)
// walking the whole fill leaves most SMs idle and its loads in one chain.
//
// Design:
// * Grid (splits x row tiles, KVH, B).  The host picks `splits` from B *
//   KVH, the key capacity S (a dense cache's length, or W * BS for the
//   pool) and the SM count (ops.decode_split_plan: about two blocks per SM)
//   and never reads kv_len.  Each block reads kv_len[b] and takes its share
//   of [0, kv_len): the live keys are cut into `splits` ranges of whole
//   CK-key chunks, so a ring filled to 270 of 2048 positions splits its 270
//   keys, not its 2048.  A block whose range is empty writes m = -1e30,
//   l = 0 (its o is never read) and exits.
// * Where a key lives is the one thing the layouts do not share (KeyWalk,
//   the kernel's Layout argument): row kv0 + kp of the slot's cache, or row
//   kp % BS of pool block table[b, kp / BS].  A paged block first copies
//   its split's slice of the slot's table row, the entries of blocks
//   lo / BS to (hi - 1) / BS (at most ceil((hi - lo) / BS) + 1; lo is a
//   multiple of CK, not of BS), into shared memory, behind one barrier.
//   Each thread owns one key row of every chunk (TPK threads a row, 16-byte
//   copies along it) and walks its (block, row) CK rows on per chunk by
//   subtraction, so a copy takes its block id from shared memory and no
//   copy divides by BS.  Entries at scratch block 0 are read as written.
// * 128 threads.  Warps own keys: a key is read by LPK lanes, each lane
//   holding slices of hd (DL values: 16-byte vectors of float32 or bf16, 8
//   int8 codes), and its dots with the G query rows (kept in shared memory
//   as float32) reduce by warp shuffles.  Each K/V row is read once per KV
//   head: the G query heads of a KV head are rows of one block (up to 16;
//   more rows take more row tiles).
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
// * int8 pools: the ring copies codes in 16-byte pieces, and a lane reads 8
//   codes at a time, so a key takes 8 lanes at hd 64 as a bf16 key does (16
//   codes a lane would give 4 lanes a key and 32 key slots against a 16-key
//   chunk: half the block idle).  Scores and outputs are dequantized once
//   each, not once per code, in this order: s = (q . codes) * (k_scale *
//   scale), and o = (sum p * codes) * v_scale before the partial is
//   written.  The reference scales each code first; the two differ by
//   float32 rounding only.
// * The scores stay on FMAs at every G: a split holds a few chunks, the
//   step is bound by latency and bytes, not by flops.
// * Merge (decode_merge_kernel, one block per query row, the splits taken
//   in parallel): M = max m_i over non-empty splits, o = sum e^(m_i - M)
//   o_i / max(sum e^(m_i - M) l_i, 1e-30), zeros when every split is empty
//   (kv_len 0), written once in the caller's query dtype (bf16 round to
//   nearest even).  It runs at every split count, one split included, so
//   the output has one path.
// Instantiated for head dims 16, 64, 128, 256, row tiles of 1, 4 and 16
// query rows, float32 and bf16 caches and pools, and int8 pools.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "../../common/hopper.cuh"

namespace {

using hopper::cp_async16;
using hopper::cp_async_commit;
using hopper::cp_async_wait;
using hopper::ex2;  // relative error 2^-22; denormal results flush to zero
using hopper::smem_u32;

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int CK = 16;  // keys per chunk: the unit the splits are cut in (ops.DECODE_CHUNK)
constexpr int TPK = THREADS / CK;  // threads copying one key row of a chunk
constexpr int SSW = CK + 4;  // a score row in shared memory: whole 16-byte vectors
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr unsigned FULL = 0xffffffffu;

// the kernels' Layout argument: where a key's row lives
struct Dense {};  // row kv0 + kp of the (slot, KV head)'s cache
struct Paged {};  // row kp % BS of pool block table[b, kp / BS]

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f(int8_t v) { return static_cast<float>(v); }

// p.astype(v.dtype) of the reference: a bf16 cache rounds p to bf16
template <typename T> __device__ __forceinline__ float round_p(float v) { return v; }
template <> __device__ __forceinline__ float round_p<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

// the register type of one lane vector
template <int BYTES> struct Raw;
template <> struct Raw<16> { using type = uint4; };
template <> struct Raw<8> { using type = uint2; };

template <typename T, int D>
struct Geom {
  // elements a lane reads at once: 16 bytes of float32 or bf16, 8 int8 codes
  static constexpr int VEC = 16 / sizeof(T) < 8 ? 16 / sizeof(T) : 8;
  static constexpr int NVEC = D / VEC;                // vectors per row
  static constexpr int LPK = NVEC < 32 ? NVEC : 32;   // lanes per key
  static constexpr int NV = NVEC / LPK;               // vectors per lane
  static constexpr int DL = NV * VEC;                 // elements per lane
  static constexpr int KPW = 32 / LPK;                // keys a warp reads at once
  static constexpr int NSLOT = WARPS * KPW;           // key slots of the block
  static constexpr int PASSES = (CK + NSLOT - 1) / NSLOT;
  // the ring's 16-byte copies: CPR to a row, up to CPT by each of its TPK threads
  static constexpr int CVEC = 16 / sizeof(T);
  static constexpr int CPR = D / CVEC;
  static constexpr int CPT = (CPR + TPK - 1) / TPK;
  static constexpr int STAGE = 2 * CK * D * sizeof(T);  // bytes of a chunk's K and V
  // ring stages: about 32 KB of chunks in flight, 3 to 8 of them
  static constexpr int STAGES = 32768 / STAGE < 3 ? 3 : (32768 / STAGE > 8 ? 8 : 32768 / STAGE);
  static_assert(D % CVEC == 0 && NVEC % LPK == 0, "head dim must be whole 16-byte vectors");
  static_assert(CK % KPW == 0, "a warp's key slots lie wholly inside or outside a chunk");
};

// Dynamic shared memory, in bytes: the K/V ring and the query rows as
// float32, which the warps' partial sums reuse at the end; the chunk's
// scores; the warps' partial denominators; then, for the paged layout, the
// split's table slice (its length known at launch only).
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

struct Args {
  const void *q, *k, *v;
  const int32_t *lens, *table;  // table [B, W]: the paged layout only
  const float *k_scale, *v_scale;  // [KVH]: int8 pools only
  float *o_part, *m_part, *l_part;
  int B, KVH, G, S, BS, W, splits;
  float scale, softcap;
};

// Entries of a paged split's table slice: at most ceil(span / BS) + 1 for
// the longest split's span of keys (the per-block count is (hi - 1) / BS -
// lo / BS + 1).
int table_slice(const Args& a) {
  const int per = ((a.S + CK - 1) / CK + a.splits - 1) / a.splits;
  return (per * CK + a.BS - 1) / a.BS + 1;
}

// The row, in rows of hd elements from the cache's or pool's start, of
// this thread's key in the current chunk; next() steps it CK keys on.
template <typename Layout> struct KeyWalk;

template <> struct KeyWalk<Dense> {
  size_t kv0;  // row 0 of the (slot, KV head)'s cache
  int kp, lo;
  __device__ KeyWalk(const Args& a, int b, int h, int lo_, int j, const int*)
      : kv0(((size_t)b * a.KVH + h) * a.S), kp(lo_ + j), lo(lo_) {}
  __device__ size_t row(bool ok) const { return kv0 + (ok ? kp : lo); }
  __device__ void next() { kp += CK; }
};

template <> struct KeyWalk<Paged> {
  const int* tbl;  // the split's table slice, from block lo / BS on
  int kvh, h, bs, blk, r;  // the key is row r of pool block tbl[blk]
  __device__ KeyWalk(const Args& a, int, int h_, int lo, int j, const int* tbl_s)
      : tbl(tbl_s), kvh(a.KVH), h(h_), bs(a.BS) {
    const int t = lo % bs + j;  // once a block: the copies never divide
    blk = t / bs;
    r = t - blk * bs;
  }
  // past the split's range (nothing is read) it points at the pool's start
  __device__ size_t row(bool ok) const {
    const int e = tbl[ok ? blk : 0];
    return ok ? ((size_t)e * kvh + h) * bs + r : 0;
  }
  __device__ void next() {
    r += CK;
    while (r >= bs) {
      r -= bs;
      ++blk;
    }
  }
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
  using W = typename Raw<G::VEC * sizeof(T)>::type;
#pragma unroll
  for (int nv = 0; nv < G::NV; ++nv) {
    const W w = *reinterpret_cast<const W*>(row + dim_of<T, D>(sl, nv, 0));
    const T* e = reinterpret_cast<const T*>(&w);
#pragma unroll
    for (int i = 0; i < G::VEC; ++i) f[nv * G::VEC + i] = to_f(e[i]);
  }
}

// q [B, KVH, G, D] in TQ; K/V [B, KVH, S, D] (Dense) or pools
// [NB, KVH, BS, D] (Paged) in TKV; o_part [B, KVH, G, splits, D], m_part
// and l_part [B, KVH, G, splits].
template <typename TQ, typename TKV, int D, int GT, typename Layout>
__global__ void __launch_bounds__(THREADS) decode_split_kernel(const Args a) {
  constexpr bool PAGED = std::is_same<Layout, Paged>::value;
  constexpr bool QUANT = std::is_same<TKV, int8_t>::value;
  using Gm = Geom<TKV, D>;
  using L = Smem<TKV, D, GT>;
  constexpr int DL = Gm::DL, STAGES = Gm::STAGES, QVEC = 16 / sizeof(TQ);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  TKV* const ring = reinterpret_cast<TKV*>(smem_raw + L::RING);
  float(*const qs)[D] = reinterpret_cast<float(*)[D]>(smem_raw + L::QS);
  float(*const sums)[GT][D] = reinterpret_cast<float(*)[GT][D]>(smem_raw);
  float(*const ss)[SSW] = reinterpret_cast<float(*)[SSW]>(smem_raw + L::SS);
  float(*const ls)[GT] = reinterpret_cast<float(*)[GT]>(smem_raw + L::LS);
  int* const tbl_s = reinterpret_cast<int*>(smem_raw + L::bytes);
  const TQ* const q = static_cast<const TQ*>(a.q);
  const TKV* const k = static_cast<const TKV*>(a.k);
  const TKV* const v = static_cast<const TKV*>(a.v);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, splits = a.splits;
  const int split = blockIdx.x % splits, g0 = (blockIdx.x / splits) * GT;
  const int h = blockIdx.y, b = blockIdx.z;
  const int GR = min(GT, a.G - g0);  // query rows of this tile
  const size_t row0 = ((size_t)b * a.KVH + h) * a.G + g0;

  // this split's keys: whole CK-key chunks of the live range [0, n)
  const int n = max(0, min(a.lens[b], a.S));
  const int per = ((n + CK - 1) / CK + splits - 1) / splits;
  const int lo = split * per * CK, hi = min(n, lo + per * CK);
  if (lo >= hi) {
    if (tid < GR) {
      a.m_part[(row0 + tid) * splits + split] = NEG_INF;
      a.l_part[(row0 + tid) * splits + split] = 0.f;
    }
    return;
  }
  const int n_chunks = (hi - lo + CK - 1) / CK;
  // scores are (q . k) * qk_scale: the int8 pool's k_scale folds in here
  float qk_scale = a.scale;
  if constexpr (QUANT) qk_scale = a.k_scale[h] * a.scale;

  if constexpr (PAGED) {  // the split's table slice, read once
    const int b0 = lo / a.BS, nt = (hi - 1) / a.BS - b0 + 1;
    const int32_t* trow = a.table + (size_t)b * a.W + b0;
    for (int t = tid; t < nt; t += THREADS) tbl_s[t] = trow[t];
  }

  // the tile's query rows as float32, 16-byte loads all in flight at once
#pragma unroll
  for (int c = tid; c < GT * (D / QVEC); c += THREADS) {
    const int g = c / (D / QVEC), dv = (c % (D / QVEC)) * QVEC;
    float f[QVEC];
    if (g < GR) {
      const uint4 w = *reinterpret_cast<const uint4*>(q + (row0 + g) * D + dv);
      const TQ* e = reinterpret_cast<const TQ*>(&w);
#pragma unroll
      for (int i = 0; i < QVEC; ++i) f[i] = to_f(e[i]);
    } else {
#pragma unroll
      for (int i = 0; i < QVEC; ++i) f[i] = 0.f;
    }
#pragma unroll
    for (int i = 0; i < QVEC; i += 4)
      *reinterpret_cast<float4*>(&qs[g][dv + i]) = make_float4(f[i], f[i + 1], f[i + 2], f[i + 3]);
  }
  if constexpr (PAGED) __syncthreads();  // the table slice is in shared memory

  // this thread copies key row jc of each chunk, pieces cc, cc + TPK, ...
  const int jc = tid / TPK, cc = tid % TPK;
  KeyWalk<Layout> walk(a, b, h, lo, jc, tbl_s);
  auto issue = [&](int c) {  // chunk c of this split into its ring stage
    if (c < n_chunks) {
      TKV* const st = ring + (c % STAGES) * 2 * CK * D;
      const bool ok = lo + c * CK + jc < hi;
      const size_t off = walk.row(ok) * D;
#pragma unroll
      for (int i = 0; i < Gm::CPT; ++i) {
        const int dv = (cc + i * TPK) * Gm::CVEC;
        if (Gm::CPR % TPK == 0 || dv < D) {
          cp_async16(smem_u32(st + jc * D + dv), k + off + dv, ok);
          cp_async16(smem_u32(st + (CK + jc) * D + dv), v + off + dv, ok);
        }
      }
      walk.next();
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
    const TKV* const kst = ring + (c % STAGES) * 2 * CK * D;
    const TKV* const vst = kst + CK * D;
    const int base = lo + c * CK;

    // scores of this lane's keys against every row of the tile (rows past
    // G have zero queries: computing them keeps the loops free of branches)
#pragma unroll
    for (int i = 0; i < Gm::PASSES; ++i) {
      const int j = slot + i * Gm::NSLOT;
      float kf[DL], dot[GT];
      load_slice<TKV, D>(kst + min(j, CK - 1) * D, sl, kf);
#pragma unroll
      for (int g = 0; g < GT; ++g) {
        dot[g] = 0.f;
#pragma unroll
        for (int nv = 0; nv < Gm::NV; ++nv) {
#pragma unroll
          for (int e = 0; e < Gm::VEC; e += 4) {
            const float4 qv =
                *reinterpret_cast<const float4*>(&qs[g][dim_of<TKV, D>(sl, nv, e)]);
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
          float x = dot[t] * qk_scale;
          if (a.softcap > 0.f) x = tanhf(x / a.softcap) * a.softcap;
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
      load_slice<TKV, D>(vst + min(j, CK - 1) * D, sl, vf);
#pragma unroll
      for (int g = 0; g < GT; ++g) {
        const float sv = ss[g][min(j, CK - 1)];
        const float p = j < CK && sv > NEG_INF / 2 ? ex2(fmaf(sv, LOG2E, -m_l2[g])) : 0.f;
        l[g] += p;  // the denominator sums the unrounded p
        const float pr = round_p<TKV>(p);
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
          *reinterpret_cast<float4*>(&sums[warp][g][dim_of<TKV, D>(sl, nv, e)]) =
              make_float4(o[g][nv * Gm::VEC + e], o[g][nv * Gm::VEC + e + 1],
                          o[g][nv * Gm::VEC + e + 2], o[g][nv * Gm::VEC + e + 3]);
      if (sl == 0) ls[warp][g] = l[g];
    }
  }
  __syncthreads();

  float v_sc = 1.f;  // the int8 pool's v_scale, once per output
  if constexpr (QUANT) v_sc = a.v_scale[h];
  for (int e = tid; e < GR * D; e += THREADS) {
    const int g = e / D, d = e % D;
    float acc = sums[0][g][d], den = ls[0][g];
#pragma unroll
    for (int w = 1; w < WARPS; ++w) {
      acc += sums[w][g][d];
      den += ls[w][g];
    }
    if constexpr (QUANT) acc *= v_sc;
    a.o_part[((row0 + g) * splits + split) * D + d] = acc;
    if (d == 0) a.l_part[(row0 + g) * splits + split] = den;
  }
#pragma unroll
  for (int g = 0; g < GT; ++g)
    if (tid == g && g < GR) a.m_part[(row0 + g) * splits + split] = m[g];
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

// Layout only names the kernel (a profile tells the two layouts apart).
template <typename TO, typename Layout>
__global__ void __launch_bounds__(THREADS)
decode_merge_kernel(const float* __restrict__ o_part, const float* __restrict__ m_part,
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

// Dynamic shared memory of one split block: the tiles, and for the paged
// layout the table slice.
template <typename TKV, int D, int GT, typename Layout>
size_t smem_bytes(const Args& a) {
  size_t bytes = Smem<TKV, D, GT>::bytes;
  if (std::is_same<Layout, Paged>::value) bytes += table_slice(a) * sizeof(int);
  return bytes;
}

template <typename TKV, int D, int GT, typename Layout>
cudaError_t launch(const Args& a, cudaStream_t s) {
  // an int8 pool takes float32 queries; a float cache or pool, its own dtype
  using TQ = typename std::conditional<std::is_same<TKV, int8_t>::value, float, TKV>::type;
  static_assert(Smem<TKV, D, GT>::bytes <= 232448, "tiles exceed the 227 KB a block may use");
  const size_t smem = smem_bytes<TKV, D, GT, Layout>(a);
  if (smem > 232448) return cudaErrorInvalidValue;  // a table slice too long for one block
  auto* kern = decode_split_kernel<TQ, TKV, D, GT, Layout>;
  if (smem > 48 * 1024) {  // past the default limit: ask for it (per device, cheap)
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  const int row_tiles = (a.G + GT - 1) / GT;
  dim3 grid(a.splits * row_tiles, a.KVH, a.B);
  kern<<<grid, THREADS, smem, s>>>(a);
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

template <typename T, typename Layout>
cudaError_t launch_tile(const Args& a, int D, cudaStream_t s) {
  return with_tile<T>(D, a.G, cudaErrorInvalidValue, [&](auto t) {
    using Tl = decltype(t);
    return launch<typename Tl::type, Tl::D, Tl::GT, Layout>(a, s);
  });
}

// dtype: 0 float32, 1 bf16 (queries in the cache dtype), 2 int8 pool
// (float32 queries, per-KV-head scales; the paged layout only)
template <typename Layout>
cudaError_t launch_split(const Args& a, int D, int dtype, cudaStream_t s) {
  switch (dtype) {
    case 0:
      return launch_tile<float, Layout>(a, D, s);
    case 1:
      return launch_tile<__nv_bfloat16, Layout>(a, D, s);
    case 2:
      if constexpr (std::is_same<Layout, Paged>::value)
        if (a.k_scale != nullptr && a.v_scale != nullptr)
          return launch_tile<int8_t, Paged>(a, D, s);
      return cudaErrorInvalidValue;
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename Layout>
cudaError_t launch_decode(const Args& a, void* out, int D, int dtype, int out_dtype,
                          cudaStream_t s) {
  cudaError_t e = launch_split<Layout>(a, D, dtype, s);
  if (e != cudaSuccess) return e;
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const unsigned rows = static_cast<unsigned>(a.B) * a.KVH * a.G;
  const size_t wbytes = static_cast<size_t>(a.splits) * sizeof(float);
  if (out_dtype == 1)
    decode_merge_kernel<__nv_bfloat16, Layout><<<rows, THREADS, wbytes, s>>>(
        a.o_part, a.m_part, a.l_part, static_cast<__nv_bfloat16*>(out), D, a.splits);
  else
    decode_merge_kernel<float, Layout><<<rows, THREADS, wbytes, s>>>(
        a.o_part, a.m_part, a.l_part, static_cast<float*>(out), D, a.splits);
  return cudaGetLastError();
}

}  // namespace

// q [B,KVH,G,D] (the cache dtype; float32 for an int8 pool); lens [B] int32
// = kv_len; either dense caches k/v [B,KVH,S,D] (table null) or pools
// k/v [NB,KVH,BS,D] read through table [B,W] int32 (S = W * BS, the
// table's capacity), all contiguous with 16-byte aligned starts;
// k_scale/v_scale [KVH] float32 for an int8 pool (dtype 2), null
// otherwise; splits >= 1 ranges per (slot, KV head); o_part
// [B,KVH,G,splits,D], m_part and l_part [B,KVH,G,splits] float32 scratch;
// out [B,KVH,G,D] in out_dtype (0 float32, 1 bf16).  Launches the split
// kernel, then the merge.  Returns a cudaError_t.
extern "C" int decode_launch(const void* q, const void* k, const void* v, const void* lens,
                             const void* table, const void* k_scale, const void* v_scale,
                             void* o_part, void* m_part, void* l_part, void* out, int B,
                             int KVH, int G, int D, int S, int BS, int W, int splits,
                             float scale, float softcap, int dtype, int out_dtype,
                             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool paged = table != nullptr;
  if (B <= 0 || B > 65535 || KVH <= 0 || KVH > 65535 || G <= 0 || S <= 0 || splits <= 0 ||
      (out_dtype != 0 && out_dtype != 1) ||
      (paged && (BS <= 0 || W <= 0 || static_cast<long long>(W) * BS != S)))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{q,
               k,
               v,
               static_cast<const int32_t*>(lens),
               static_cast<const int32_t*>(table),
               static_cast<const float*>(k_scale),
               static_cast<const float*>(v_scale),
               static_cast<float*>(o_part),
               static_cast<float*>(m_part),
               static_cast<float*>(l_part),
               B, KVH, G, S, BS, W, splits, scale, softcap};
  const cudaError_t e = paged ? launch_decode<Paged>(a, out, D, dtype, out_dtype, s)
                              : launch_decode<Dense>(a, out, D, dtype, out_dtype, s);
  return static_cast<int>(e);
}

// Dynamic shared memory of the split kernel's tiles at head dim D, cache
// dtype (0 float32, 1 bf16, 2 int8) and G query rows per KV head, without
// the paged layout's table slice; 0 for a shape it is not built for.
extern "C" int decode_smem_bytes(int D, int dtype, int G) {
  if (G <= 0) return 0;
  auto tiles = [&](auto t) {
    using Tl = decltype(t);
    return static_cast<int>(Smem<typename Tl::type, Tl::D, Tl::GT>::bytes);
  };
  switch (dtype) {
    case 0:
      return with_tile<float>(D, G, 0, tiles);
    case 1:
      return with_tile<__nv_bfloat16>(D, G, 0, tiles);
    case 2:
      return with_tile<int8_t>(D, G, 0, tiles);
    default:
      return 0;
  }
}
