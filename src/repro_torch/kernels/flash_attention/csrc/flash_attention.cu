// Streaming-softmax (flash) attention over full sequences (sm_90a).
//
// Replaces: src/repro/kernels/flash_attention/kernel.py ::
// flash_attention_kernel — causal attention plus a sliding window
// (q_pos - k_pos < window), logit softcap tanh(s/c)*c before the mask, GQA
// folded over the query axis (row r of a (batch, KV head) pair is query
// position r % q_len), the fully-masked-row guard (m_safe), p rounded to
// V's dtype before the PV product, and the output divided by max(l, 1e-30).
//
// What bounds it on an H100: over S positions a causal pass does ~2 * S^2
// * D multiply-adds per query head against 4 * S * D elements of q, k, v
// and o, so past a few dozen positions operations, not HBM bytes, bound
// it: bf16 on the tensor cores (989 TFLOP/s), float32 on the CUDA cores
// (67 TFLOP/s).
//
// Design: in both kernels one block per (64-row query tile, batch x KV
// head).  The TPU kernel carries m, l and the accumulator in output blocks
// that its sequential grid revisits; here the block loops over key tiles,
// keeping the running max m, denominator l and float32 accumulator of its
// rows in registers.  Key tiles wholly above the diagonal or wholly outside
// the window of every row of the tile are never visited: the block walks
// keys [max(0, pos_lo - window + 1), pos_hi + 1) of its rows' position
// range.
//
// bf16, for Hopper's tensor cores and copy engine:
// * One consumer warpgroup owns the 64 rows.  S = Q K^T and O += P V are
//   both wgmma.mma_async m64n64k16 (bf16 in, float32 out, as the
//   reference's dot_general with a float32 result): Q and K are K-major
//   operands in shared memory, P stays in registers as the A operand of the
//   PV product (the S accumulator's layout is the A fragment's), and V is
//   read as an MN-major B operand straight from its row-major tile.  O over
//   head dim D is D/64 accumulators of 64 x 64.
// * K/V tiles of 64 keys come by TMA (cp.async.bulk.tensor) into a ring of
//   3 stages (2 at head dims 128 and 256), in the 128-byte swizzled layout
//   wgmma reads, each head-dim chunk of 64 columns one box; a full and an
//   empty mbarrier per stage.  A producer warp, one lane of it, keeps the
//   ring's loads in flight while the consumers compute; keys and rows past
//   the tensor's end arrive as zeros.  The three tensor maps are encoded
//   per call (cuTensorMapEncodeTiled through the runtime's driver entry
//   point, no link against libcuda): they hold the tensors' addresses,
//   which change from call to call in the serving loop, and encoding is
//   host work with no device call, so a cache keyed by address would
//   rarely hit.
// * Only tiles that straddle the diagonal, the window edge, the key end or
//   a GQA fold boundary run masked_logit; the others take no mask, and
//   without a softcap they keep the raw dots, the scale riding on the max
//   and on the exponent's FMA.  p = e^(x - m) is 2^(x log2(e) - m log2(e)):
//   one FMA and ex2.approx per score, where the accurate expf is a longer
//   instruction sequence.  O is rescaled only when a row max of the warp
//   moved.
// * Head dim 256: the accumulator is 128 floats a thread.  The block is one
//   consumer warpgroup and one producer warp (160 threads) with one block
//   per SM at that head dim (its tiles take 161 KB of shared memory), so
//   the launch bounds already let the consumers use up to 255 registers
//   (ptxas: 199, no spill); setmaxnreg moves registers between the
//   warpgroups of one block and has nothing to move here.  Head dim 16 runs
//   as one 64-column chunk whose extra columns TMA fills with zeros.
//
// float32 keeps float32 products on the CUDA cores (the tensor cores'
// float32 modes round to TF32): Q staged transposed in shared memory,
// 32-key tiles, 4 x 4 register tiles of FMA dot products, p through shared
// memory (F32Smem: 140 KB at head dim 256, dynamic shared memory).  It
// serves the reduced float32 models.
//
// Instantiated for head dims 16, 64, 128 and 256.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "../../common/hopper.cuh"

namespace {

using namespace hopper;

constexpr int THREADS = 128;  // float32 kernel
constexpr int RT = 64;  // query rows per block
constexpr float NEG_INF = -1e30f;

// Query positions [pos_lo, pos_hi] of the rows of the tile starting at row
// r0 (all of [0, q_len) when the tile spans a head boundary).
__device__ __forceinline__ void tile_positions(int r0, int R, int q_len, int& pos_lo,
                                               int& pos_hi) {
  const int r_last = min(r0 + RT, R) - 1;
  pos_lo = r0 % q_len;
  pos_hi = r_last % q_len;
  if (r0 / q_len != r_last / q_len) {  // the tile spans a head boundary
    pos_lo = 0;
    pos_hi = q_len - 1;
  }
}

// Keys [k_lo, k_hi) that some row of the tile starting at row r0 may see.
__device__ __forceinline__ void key_range(int r0, int R, int Sk, int q_len, int causal,
                                          int window, int& k_lo, int& k_hi) {
  int pos_lo, pos_hi;
  tile_positions(r0, R, q_len, pos_lo, pos_hi);
  k_hi = causal ? min(Sk, pos_hi + 1) : Sk;
  k_lo = window > 0 ? max(0, pos_lo - window + 1) : 0;
}

// The reference's mask and logit transform of one score.
__device__ __forceinline__ float masked_logit(float dot, bool row_ok, int pos, int kp,
                                              int k_hi, int causal, int window, float scale,
                                              float softcap) {
  const bool ok = row_ok && kp < k_hi && (!causal || kp <= pos) &&
                  (window <= 0 || pos - kp < window);
  float x = dot * scale;
  if (softcap > 0.f) x = tanhf(x / softcap) * softcap;
  return ok ? x : NEG_INF;
}

// ---------------------------------------------------------------- float32
constexpr int KC = 32;      // keys per tile
constexpr int TX = KC / 4;  // threads across a tile's keys (4 keys each)
constexpr int TY = RT / 4;  // threads down the rows (4 rows each)
static_assert(TX * TY == THREADS, "4 x 4 score tiles cover the block");

// Dynamic shared memory of the float32 kernel, in floats: Q transposed, K
// transposed, V, p (+1 column: the PV loop reads 4 rows at one key).
template <int D>
struct F32Smem {
  static constexpr int QT = 0, KT = QT + D * RT, VS = KT + D * KC, PS = VS + KC * D;
  static constexpr size_t bytes = (PS + RT * (KC + 1)) * sizeof(float);
};

template <int D>
__global__ void __launch_bounds__(THREADS)
flash_attention_f32_kernel(const float* __restrict__ q,  // [BH, R, D]
                           const float* __restrict__ k,  // [BH, Sk, D]
                           const float* __restrict__ v,  // [BH, Sk, D]
                           float* __restrict__ out,      // [BH, R, D]
                           int R, int Sk, int q_len, int causal, int window, float scale,
                           float softcap) {
  constexpr int VEC = 4;      // floats per 16-byte load
  constexpr int DC = D / TX;  // output columns per thread
  static_assert(D % VEC == 0 && D % TX == 0, "head dim must split into vectors and lanes");
  using L = F32Smem<D>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* const sm = reinterpret_cast<float*>(smem_raw);
  float(*const qT)[RT] = reinterpret_cast<float(*)[RT]>(sm + L::QT);
  float(*const kT)[KC] = reinterpret_cast<float(*)[KC]>(sm + L::KT);
  float(*const vs)[D] = reinterpret_cast<float(*)[D]>(sm + L::VS);
  float(*const ps)[KC + 1] = reinterpret_cast<float(*)[KC + 1]>(sm + L::PS);

  const int tid = threadIdx.x;
  const int tx = tid % TX, ty = tid / TX;
  const int r0 = blockIdx.x * RT;
  const size_t bh = blockIdx.y;
  const float* qb = q + bh * R * D;
  const float* kb = k + bh * Sk * D;
  const float* vb = v + bh * Sk * D;
  int k_lo, k_hi;
  key_range(r0, R, Sk, q_len, causal, window, k_lo, k_hi);

  for (int c = tid; c < RT * (D / VEC); c += THREADS) {
    const int r = c % RT, dv = (c / RT) * VEC;
    float4 f = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + r < R) f = *reinterpret_cast<const float4*>(qb + (size_t)(r0 + r) * D + dv);
    qT[dv][r] = f.x;
    qT[dv + 1][r] = f.y;
    qT[dv + 2][r] = f.z;
    qT[dv + 3][r] = f.w;
  }

  int pos[4];
  bool row_ok[4];
  float m[4], l[4], acc[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = r0 + ty * 4 + i;
    row_ok[i] = r < R;
    pos[i] = row_ok[i] ? r % q_len : 0;
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;
  }

  for (int base = k_lo; base < k_hi; base += KC) {
    __syncthreads();  // the previous tile's readers are done
    for (int c = tid; c < KC * (D / VEC); c += THREADS) {
      const int j = c % KC, dv = (c / KC) * VEC;
      const int kp = base + j;
      float4 kf = make_float4(0.f, 0.f, 0.f, 0.f), vf = kf;
      if (kp < k_hi) {
        kf = *reinterpret_cast<const float4*>(kb + (size_t)kp * D + dv);
        vf = *reinterpret_cast<const float4*>(vb + (size_t)kp * D + dv);
      }
      kT[dv][j] = kf.x;
      kT[dv + 1][j] = kf.y;
      kT[dv + 2][j] = kf.z;
      kT[dv + 3][j] = kf.w;
      *reinterpret_cast<float4*>(&vs[j][dv]) = vf;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) s[i][jj] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      const float4 qa = *reinterpret_cast<const float4*>(&qT[d][ty * 4]);
      const float4 ka = *reinterpret_cast<const float4*>(&kT[d][tx * 4]);
      const float qv[4] = {qa.x, qa.y, qa.z, qa.w};
      const float kv[4] = {ka.x, ka.y, ka.z, ka.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) s[i][jj] += qv[i] * kv[jj];
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = NEG_INF;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        s[i][jj] = masked_logit(s[i][jj], row_ok[i], pos[i], base + tx * 4 + jj, k_hi,
                                causal, window, scale, softcap);
        mx = fmaxf(mx, s[i][jj]);
      }
      // the row's 8 owner threads are neighbouring lanes of one warp
#pragma unroll
      for (int o = 1; o < TX; o <<= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(m[i], mx);
      // guard fully-masked rows exactly as the reference kernel does
      const float m_safe = m_new <= NEG_INF / 2 ? 0.f : m_new;
      const float alpha = m[i] <= NEG_INF / 2 ? 0.f : expf(m[i] - m_safe);
      float lsum = 0.f;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const float p = s[i][jj] > NEG_INF / 2 ? expf(s[i][jj] - m_safe) : 0.f;
        lsum += p;
        ps[ty * 4 + i][tx * 4 + jj] = p;  // float32 V: p is not rounded
      }
#pragma unroll
      for (int o = 1; o < TX; o <<= 1) lsum += __shfl_xor_sync(0xffffffffu, lsum, o);
      l[i] = alpha * l[i] + lsum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int j = 0; j < KC; ++j) {
      float pv[4], vv[DC];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = ps[ty * 4 + i][j];
#pragma unroll
      for (int c = 0; c < DC; ++c) vv[c] = vs[j][tx * DC + c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < DC; ++c) acc[i][c] += pv[i] * vv[c];
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (!row_ok[i]) continue;
    const float denom = fmaxf(l[i], 1e-30f);
    float* o = out + (bh * R + r0 + ty * 4 + i) * D + tx * DC;
#pragma unroll
    for (int c = 0; c < DC; ++c) o[c] = acc[i][c] / denom;
  }
}

// ------------------------------------------------------------------- bf16
using bf16 = __nv_bfloat16;
constexpr int BN = 64;                          // keys per K/V tile
constexpr int CONSUMERS = 128;                  // one warpgroup: the tile's 64 rows, 16 a warp
constexpr int BF16_THREADS = CONSUMERS + 32;    // and one producer warp
constexpr int CHUNK = 64;                       // head-dim columns of one 128-byte swizzle atom
constexpr uint32_t TILE_BYTES = 64 * CHUNK * 2;  // a 64-row x 64-column bf16 tile
constexpr float LOG2E = 1.4426950408889634f;
static_assert(RT == 64 && BN == 64, "one m64n64 wgmma per k-step covers a score tile");

// Shared memory of the bf16 kernel, in bytes from a 1024-byte aligned base
// (the 128-byte swizzle repeats every 8 rows of 128 bytes): Q's head-dim
// chunks, then STAGES ring stages of K's chunks and V's chunks, then the
// mbarriers (full[STAGES], empty[STAGES], q).  Head dim 16 is held as one
// 64-column chunk whose columns past 16 TMA fills with zeros.
template <int D>
struct Bf16Cfg {
  static constexpr int NCH = (D + CHUNK - 1) / CHUNK;
  static constexpr int STAGES = D <= 64 ? 3 : 2;
  static constexpr int MIN_BLOCKS = D <= 64 ? 3 : (D <= 128 ? 2 : 1);  // per SM
  static constexpr uint32_t Q_BYTES = NCH * TILE_BYTES;
  static constexpr uint32_t STAGE_BYTES = 2 * NCH * TILE_BYTES;
  static constexpr uint32_t BAR = Q_BYTES + STAGES * STAGE_BYTES;
  static constexpr size_t bytes = 1024 + BAR + (2 * STAGES + 1) * 8;  // + base alignment
};

template <int D>
__global__ void __launch_bounds__(BF16_THREADS, Bf16Cfg<D>::MIN_BLOCKS)
flash_attention_bf16_kernel(const __grid_constant__ CUtensorMap map_q,  // [BH, R, D]
                            const __grid_constant__ CUtensorMap map_k,  // [BH, Sk, D]
                            const __grid_constant__ CUtensorMap map_v,  // [BH, Sk, D]
                            bf16* __restrict__ out,                     // [BH, R, D]
                            int R, int Sk, int q_len, int causal, int window, float scale,
                            float softcap) {
  using C = Bf16Cfg<D>;
  constexpr int NCH = C::NCH, STAGES = C::STAGES;
  extern __shared__ __align__(1024) unsigned char bf16_smem[];
  const uint32_t base = (smem_u32(bf16_smem) + 1023u) & ~1023u;
  const uint32_t q_s = base, ring = base + C::Q_BYTES, bars = base + C::BAR;
  const uint32_t q_bar = bars + 16 * STAGES;
  auto full = [&](int st) { return bars + 8 * st; };
  auto empty = [&](int st) { return bars + 8 * (STAGES + st); };

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int r0 = blockIdx.x * RT, bh = blockIdx.y;
  int k_lo, k_hi, pos_lo, pos_hi;
  key_range(r0, R, Sk, q_len, causal, window, k_lo, k_hi);
  tile_positions(r0, R, q_len, pos_lo, pos_hi);
  const int n_tiles = k_hi > k_lo ? (k_hi - k_lo + BN - 1) / BN : 0;

  if (tid == 0) {
    for (int st = 0; st < STAGES; ++st) {
      mbar_init(full(st), 1);
      mbar_init(empty(st), CONSUMERS);
    }
    mbar_init(q_bar, 1);
    mbar_fence_init();
  }
  __syncthreads();

  if (warp == CONSUMERS / 32) {  // producer: one lane keeps the ring's loads in flight
    if (lane == 0) {
      mbar_expect_tx(q_bar, C::Q_BYTES);
      for (int c = 0; c < NCH; ++c)
        tma_load_3d(q_s + c * TILE_BYTES, &map_q, c * CHUNK, r0, bh, q_bar);
      for (int t = 0; t < n_tiles; ++t) {
        const int st = t % STAGES;
        if (t >= STAGES) mbar_wait(empty(st), ((t / STAGES) - 1) & 1);
        mbar_expect_tx(full(st), C::STAGE_BYTES);
        const uint32_t ks = ring + st * C::STAGE_BYTES, vs = ks + NCH * TILE_BYTES;
        const int kb = k_lo + t * BN;  // rows past Sk arrive as zeros
        for (int c = 0; c < NCH; ++c) {
          tma_load_3d(ks + c * TILE_BYTES, &map_k, c * CHUNK, kb, bh, full(st));
          tma_load_3d(vs + c * TILE_BYTES, &map_v, c * CHUNK, kb, bh, full(st));
        }
      }
    }
    return;
  }

  // consumers: accumulator row gid (+ 8) of warp `warp`'s 16 rows
  const int gid = lane / 4, tig = lane % 4;
  int row[2], pos[2];
  bool row_ok[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    row[h] = r0 + warp * 16 + gid + 8 * h;
    row_ok[h] = row[h] < R;
    pos[h] = row_ok[h] ? row[h] % q_len : 0;
  }
  float o[NCH][32], m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int c = 0; c < NCH; ++c)
#pragma unroll
    for (int i = 0; i < 32; ++i) o[c][i] = 0.f;

  mbar_wait(q_bar, 0);
  for (int t = 0; t < n_tiles; ++t) {
    const int st = t % STAGES;
    const uint32_t ks = ring + st * C::STAGE_BYTES, vs = ks + NCH * TILE_BYTES;
    mbar_wait(full(st), (t / STAGES) & 1);

    // S = Q K^T over the (padded) head dim, 16 columns a k-step
    float s[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < NCH * 4; ++kk) {
      const uint32_t off = (kk / 4) * TILE_BYTES + (kk % 4) * 32;
      wgmma_ss(s, smem_desc(q_s + off), smem_desc(ks + off));
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);

    // s[4j + e]: row gid + 8 (e / 2), key 8j + 2 tig + (e % 2) of the tile.
    // A tile wholly inside the causal, window and key bounds of every row
    // takes no mask.
    const int kb = k_lo + t * BN;
    const bool whole = kb + BN <= k_hi && (!causal || kb + BN - 1 <= pos_lo) &&
                       (window <= 0 || pos_hi - kb < window);
    // (the branch stays outside the loops: inside them the compiler
    // predicates both paths for every score).  Without a softcap a whole
    // tile keeps the raw dots: the scale rides on the max and on the exp's
    // FMA (a positive factor commutes with the max, rounding included).
    float raw = 1.f;  // what takes s to logits: scale for raw dots
    if (whole) {
      if (softcap > 0.f) {
#pragma unroll
        for (int i = 0; i < 32; ++i) s[i] = tanhf(s[i] * scale / softcap) * softcap;
      } else {
        raw = scale;
      }
    } else {
#pragma unroll
      for (int i = 0; i < 32; ++i)
        s[i] = masked_logit(s[i], row_ok[(i % 4) / 2], pos[(i % 4) / 2],
                            kb + (i / 4) * 8 + tig * 2 + (i & 1), k_hi, causal, window, scale,
                            softcap);
    }
    float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int i = 0; i < 32; ++i) mx[(i % 4) / 2] = fmaxf(mx[(i % 4) / 2], s[i]);
    // e^(x - m) as 2^(x log2(e) - m log2(e)): one FMA and the hardware's
    // exp2 (ex2.approx, relative error 2^-22) per score
    float m_l2[2], alpha[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      // a row's 4 owner threads are neighbouring lanes
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      const float m_new = fmaxf(m[h], mx[h] * raw);
      // guard fully-masked rows exactly as the reference kernel does
      const float m_safe = m_new <= NEG_INF / 2 ? 0.f : m_new;
      alpha[h] = m[h] <= NEG_INF / 2 ? 0.f : ex2((m[h] - m_safe) * LOG2E);
      m_l2[h] = m_safe * LOG2E;
      m[h] = m_new;
    }
    float lsum[2] = {0.f, 0.f};
    uint32_t pf[BN / 8][2];  // p rounded to bf16 (V's dtype): row gid, row gid + 8
    const float to_l2 = raw * LOG2E;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      float p[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        // a masked score (-1e30) gives exactly 0: ex2 of -1.4e30 underflows
        p[e] = ex2(fmaf(s[4 * j + e], to_l2, -m_l2[e / 2]));
        lsum[e / 2] += p[e];  // the denominator sums the unrounded p
      }
      pf[j][0] = pack_bf16(p[0], p[1]);
      pf[j][1] = pack_bf16(p[2], p[3]);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      lsum[h] += __shfl_xor_sync(0xffffffffu, lsum[h], 1);
      lsum[h] += __shfl_xor_sync(0xffffffffu, lsum[h], 2);
      l[h] = alpha[h] * l[h] + lsum[h];
    }
    if (__any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f)) {  // a max moved
#pragma unroll
      for (int c = 0; c < NCH; ++c)
#pragma unroll
        for (int i = 0; i < 32; ++i) o[c][i] *= alpha[(i % 4) / 2];
    }

    // O += P V: the score tiles of keys 16kc .. 16kc + 15 are the A fragment
    wgmma_fence();
#pragma unroll
    for (int c = 0; c < NCH; ++c) {
#pragma unroll
      for (int kc = 0; kc < BN / 16; ++kc) {
        const uint32_t a[4] = {pf[2 * kc][0], pf[2 * kc][1], pf[2 * kc + 1][0],
                               pf[2 * kc + 1][1]};
        wgmma_rs(o[c], a, smem_desc(vs + c * TILE_BYTES + kc * 16 * 128));
      }
    }
    wgmma_commit();
    wgmma_wait_all();
#pragma unroll
    for (int c = 0; c < NCH; ++c) fence_regs(o[c]);
    mbar_arrive(empty(st));  // this stage's K and V have been read
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (!row_ok[h]) continue;
    const float denom = fmaxf(l[h], 1e-30f);
    bf16* orow = out + ((size_t)bh * R + row[h]) * D;
#pragma unroll
    for (int c = 0; c < NCH; ++c)
#pragma unroll
      for (int j = 0; j < CHUNK / 8; ++j) {
        const int col = c * CHUNK + j * 8 + tig * 2;
        if (col < D)
          *reinterpret_cast<uint32_t*>(orow + col) =
              pack_bf16(o[c][4 * j + 2 * h] / denom, o[c][4 * j + 2 * h + 1] / denom);
      }
  }
}

// TMA map of a contiguous bf16 [planes, rows, D] tensor, read in boxes of 64
// columns x 64 rows, 128-byte swizzled; coordinates past the tensor read as
// zeros.  Returns 0 or 10000 + the CUresult.
int encode_map(CUtensorMap* map, const void* ptr, int D, int rows, int planes) {
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(planes)};
  const cuuint32_t box[3] = {CHUNK, 64, 1};
  return encode_swizzled_map(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, 3, ptr, dims, box);
}

template <typename T, int D>
constexpr size_t smem_bytes() {
  if constexpr (std::is_same<T, float>::value)
    return F32Smem<D>::bytes;
  else
    return Bf16Cfg<D>::bytes;
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* out, int BH, int R, int Sk,
           int q_len, int causal, int window, float scale, float softcap, cudaStream_t s) {
  constexpr size_t smem = smem_bytes<T, D>();
  static_assert(smem <= 232448, "tiles exceed the 227 KB a block may use");
  dim3 grid((R + RT - 1) / RT, BH);
  if constexpr (std::is_same<T, float>::value) {
    auto* kern = flash_attention_f32_kernel<D>;
    if (smem > 48 * 1024) {  // past the default limit: ask for it (per device, cheap)
      const cudaError_t e = cudaFuncSetAttribute(
          kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
      if (e != cudaSuccess) return static_cast<int>(e);
    }
    kern<<<grid, THREADS, smem, s>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(out), R, Sk, q_len, causal, window,
        scale, softcap);
  } else {
    // the maps hold the tensors' addresses and shapes, so they are encoded
    // per call: a host-side encoding, no device work
    CUtensorMap mq, mk, mv;
    int e = encode_map(&mq, q, D, R, BH);
    if (e == 0) e = encode_map(&mk, k, D, Sk, BH);
    if (e == 0) e = encode_map(&mv, v, D, Sk, BH);
    if (e != 0) return e;
    auto* kern = flash_attention_bf16_kernel<D>;
    const cudaError_t a = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (a != cudaSuccess) return static_cast<int>(a);
    kern<<<grid, BF16_THREADS, smem, s>>>(mq, mk, mv, static_cast<bf16*>(out), R, Sk, q_len,
                                          causal, window, scale, softcap);
  }
  return 0;
}

// One instantiation of the kernel: dtype and head dim.
template <typename T, int D_>
struct Inst {
  using type = T;
  static constexpr int D = D_;
};

// Calls f(Inst<T, D>{}) for the instantiation that serves head dim D and
// dtype (0 float32, 1 bf16); returns `none` for one it is not built for.
// The launch and the shared-memory query both take it.
template <typename R, typename F>
R with_inst(int D, int dtype, R none, F&& f) {
  if (dtype != 0 && dtype != 1) return none;
  switch (D) {  // the head dims the kernel is instantiated for (_build.py HEAD_DIMS)
    case 16:
      return dtype == 0 ? f(Inst<float, 16>{}) : f(Inst<bf16, 16>{});
    case 64:
      return dtype == 0 ? f(Inst<float, 64>{}) : f(Inst<bf16, 64>{});
    case 128:
      return dtype == 0 ? f(Inst<float, 128>{}) : f(Inst<bf16, 128>{});
    case 256:
      return dtype == 0 ? f(Inst<float, 256>{}) : f(Inst<bf16, 256>{});
    default:
      return none;
  }
}

}  // namespace

// q [BH, R, D] with R = G * q_len (G query heads of one KV head stacked);
// k, v [BH, Sk, D]; out [BH, R, D], all of one dtype (0 float32, 1 bf16),
// contiguous with 16-byte aligned starts.  Returns a cudaError_t, or
// 10000 + the CUresult of a failed TMA map encoding (bf16).
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v, void* out,
                                      int BH, int R, int Sk, int D, int q_len, int causal,
                                      int window, float scale, float softcap, int dtype,
                                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (BH <= 0 || BH > 65535 || R <= 0 || Sk <= 0 || q_len <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int e = with_inst(D, dtype, static_cast<int>(cudaErrorInvalidValue), [&](auto t) {
    using I = decltype(t);
    return launch<typename I::type, I::D>(q, k, v, out, BH, R, Sk, q_len, causal, window,
                                           scale, softcap, s);
  });
  if (e != 0) return e;
  return static_cast<int>(cudaGetLastError());
}

// Dynamic shared memory of the kernel at head dim D and dtype (0 float32,
// 1 bf16); 0 for a head dim it is not built for.
extern "C" int flash_attention_smem_bytes(int D, int dtype) {
  return with_inst(D, dtype, 0, [](auto t) {
    using I = decltype(t);
    return static_cast<int>(smem_bytes<typename I::type, I::D>());
  });
}
