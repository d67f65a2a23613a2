// Causal suffix prefill straight from the paged KV pool (sm_90a).
//
// Replaces: src/repro/kernels/paged_attention/kernel.py ::
// paged_attention_kernel, its causal mode (causal=True): query row r of a
// (slot, KV head) sits at absolute position start[b] + r % q_len (the G
// query heads of the KV head folded over the q_len suffix rows,
// kernel.py:111) and sees every pooled key at or before it, read through
// the block table (key kp is row kp % BS of pool block table[b, kp / BS]);
// softcap tanh(s/c)*c before the mask, the fully-masked-row guards
// (m_safe, alpha), p rounded to V's compute dtype before the PV product,
// the output divided by max(l, 1e-30).  Over bf16 pools, float32 pools and
// int8 pools (the quantized branch, kernel.py:96-98: float32 queries, each
// K/V element dequantized as float(k) * k_scale[h], the reference's
// float32 product).  Decode stays in paged_attention.cu.
//
// What bounds it on an H100: S suffix rows of a KV head reuse each of its
// keys up to S times, ~2 * pairs * D multiply-adds per query head against
// one read of q, k, v and one write of o, so past a few dozen rows
// operations bound it: bf16 on the tensor cores (989 TFLOP/s), float32 on
// the CUDA cores (67 TFLOP/s; an int8 pool's attention computes on
// dequantized float32 K/V, as the reference does).
//
// Design: both kernels run one block per (64-row query tile, KV head,
// slot).  The block reads its slot's suffix start and block-table row from
// device memory (no host sync) and walks keys [0, k_hi) in key tiles,
// k_hi = min(start + the tile's last suffix index + 1, W * BS): tiles
// above the tile's last row position are never visited.  Only tiles that
// straddle the diagonal, the key end or a GQA fold boundary take a mask
// (ref.paged_prefill_tiles is this walk in Python).  Keys are gathered
// through the table in pieces that never span two pool blocks, so any
// block size BS > 0 runs; keys past k_hi take the mask, and the gathers
// read zeros for them wherever a piece lies wholly past k_hi.
//
// bf16 (dtype code 1), flash_attention.cu's design on a gathered ring:
// * One consumer warpgroup owns the 64 rows.  S = Q K^T and O += P V are
//   wgmma.mma_async m64n64k16 (bf16 in, float32 out), P from registers as
//   the A operand, V as an MN-major B operand; O over head dim D is D/64
//   accumulators of 64 x 64; the ex2 softmax rescales O only when a row
//   max of the warp moved; the output is written in bf16 by the kernel.
// * A producer warp fills a 3-stage ring (2 at head dims 128 and 256) of
//   64-key K and V tiles in the 128-byte swizzled layout wgmma reads (piece
//   c of row r at r * 128 + 16 * (c ^ (r % 8)) of a 1024-byte aligned 64 x
//   64 tile, where TMA's swizzle puts it), gathered through the table by
//   one of two routes.  When BS is a multiple of 8, every 8-key group of a
//   tile lies in one pool block, and a TMA box of 8 rows (one swizzle atom)
//   brings it: one table lookup and two box loads per group and head-dim
//   chunk, 16 lanes issuing one each at head dim 64, the stage's full
//   mbarrier counting the bytes (a group past the keys reads a plane past
//   the pool, which TMA zero-fills).  Otherwise each lane copies 16-byte
//   pieces with cp.async (piece l % 8 of rows l / 8, l / 8 + 4, ..., the
//   table walked without a division, keys past the end zero-filled) and
//   ends the tile with cp.async.mbarrier.arrive (32 arrivals, completing as
//   its copies land), and a consumer fences the landed tile into the async
//   proxy (fence.proxy.async) before its wgmma reads it.  Either way the
//   producer never waits on its own loads, and the consumers arrive on a
//   stage's empty mbarrier when done.  Per-row copies cost the producer
//   about as many instructions per tile as the four consumer warps' softmax
//   (chip_smoke.py times both routes).  Q comes by cp.async first.
// * Head dim 16 runs as one 64-column chunk whose columns past 16 are
//   zero-filled by the copies.
//
// float32 and int8 pools (dtype codes 0 and 2) keep float32 products on
// the CUDA cores (the tensor cores' float32 modes round to TF32): Q staged
// transposed in shared memory, 32-key tiles, 4 x 4 register tiles of FMA
// dot products (thread tx of a row group takes keys tx, tx + 8, tx + 16,
// tx + 24, so its float4 reads along the head dim of 8 neighbouring
// threads fall in distinct banks), p through shared memory.  Key tile
// t + 1 is gathered with cp.async while tile t computes: a float32 pool's
// rows land in a second pair of float tiles, an int8 pool's codes in a
// staging pair that the block dequantizes by the KV head's scale into one
// pair of float tiles.
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

constexpr int RT = 64;  // query rows per block
constexpr float NEG_INF = -1e30f;

// The keys one block visits: [0, k_hi), and the lowest absolute position
// of its rows (rows r0 .. r0 + 63 of R = G * q_len; all of the suffix when
// the tile spans a fold boundary).
struct Walk {
  int n;       // the slot's suffix start
  int pos_lo;  // the lowest position of the tile's rows
  int k_hi;    // keys past it are seen by no row of the tile
};

__device__ __forceinline__ Walk tile_walk(int r0, int R, int q_len, int n, int ctx) {
  const int r_last = min(r0 + RT, R) - 1;
  int i_lo = r0 % q_len, i_hi = r_last % q_len;
  if (r0 / q_len != r_last / q_len) {
    i_lo = 0;
    i_hi = q_len - 1;
  }
  return Walk{n, n + i_lo, max(0, min(n + i_hi + 1, ctx))};
}

// A key tile [kb, kb + bn) that every row of the tile sees whole takes no mask.
__device__ __forceinline__ bool whole_tile(const Walk& w, int kb, int bn) {
  return kb + bn <= w.k_hi && kb + bn - 1 <= w.pos_lo;
}

// The reference's logit transform and causal mask of one score.
__device__ __forceinline__ float masked_logit(float dot, bool row_ok, int pos, int kp, int k_hi,
                                              float scale, float softcap) {
  const bool ok = row_ok && kp < k_hi && kp <= pos;
  float x = dot * scale;
  if (softcap > 0.f) x = tanhf(x / softcap) * softcap;
  return ok ? x : NEG_INF;
}

// offset of key kp's row in a [NB, KVH, BS, D] pool, through the table row
__device__ __forceinline__ size_t pool_row(const int32_t* __restrict__ tbl, int kp, int kh,
                                           int KVH, int BS, int D) {
  return (((size_t)__ldg(tbl + kp / BS) * KVH + kh) * BS + kp % BS) * D;
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

// Shared memory of the bf16 kernel, in bytes from a 1024-byte aligned base:
// Q's head-dim chunks, STAGES ring stages of K's chunks and V's chunks,
// then the mbarriers (full[STAGES], empty[STAGES], q).
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

// byte offset of 16-byte piece c (0..7) of row r in a 64 x 64 bf16 tile,
// where TMA's 128-byte swizzle puts it (wgmma reads it through smem_desc)
__device__ __forceinline__ uint32_t swizzled(int r, int c) {
  return r * 128 + ((c ^ (r & 7)) << 4);
}

template <int D>
__global__ void __launch_bounds__(BF16_THREADS, Bf16Cfg<D>::MIN_BLOCKS)
paged_prefill_bf16_kernel(const __grid_constant__ CUtensorMap map_k,  // [NB * KVH, BS, D]
                          const __grid_constant__ CUtensorMap map_v,  // (BS % 8 == 0)
                          const bf16* __restrict__ q,          // [B, KVH, R, D]
                          const bf16* __restrict__ k_pool,     // [NB, KVH, BS, D]
                          const bf16* __restrict__ v_pool,     // [NB, KVH, BS, D]
                          const int32_t* __restrict__ table,   // [B, W]
                          const int32_t* __restrict__ start,   // [B]
                          bf16* __restrict__ out,              // [B, KVH, R, D]
                          int NB, int KVH, int R, int BS, int W, int q_len, float scale,
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
  const int r0 = blockIdx.x * RT, kh = blockIdx.y, b = blockIdx.z;
  const Walk w = tile_walk(r0, R, q_len, start[b], W * BS);
  const int n_tiles = (w.k_hi + BN - 1) / BN;
  const size_t row_base = ((size_t)b * KVH + kh) * R;

  const bool boxes = BS % 8 == 0;  // the gather route (see the note at the top)
  if (tid == 0) {
    for (int st = 0; st < STAGES; ++st) {
      mbar_init(full(st), boxes ? 1 : 32);  // one expect_tx, or each lane's copies
      mbar_init(empty(st), CONSUMERS);
    }
    mbar_init(q_bar, 32);
    mbar_fence_init();
  }
  __syncthreads();

  if (warp == CONSUMERS / 32) {  // producer: every lane copies
    const int c = lane % 8;  // the 16-byte piece of a 128-byte row this lane copies
    const bf16* qb = q + row_base * D;
    for (int r = lane / 8; r < RT; r += 4) {
      const bool live = r0 + r < R;
#pragma unroll
      for (int ch = 0; ch < NCH; ++ch) {
        const int col = ch * CHUNK + c * 8;
        const bool ok = live && col < D;
        cp_async16(q_s + ch * TILE_BYTES + swizzled(r, c),
                   ok ? qb + (size_t)(r0 + r) * D + col : qb, ok);
      }
    }
    cp_async_arrive(q_bar);
    const int32_t* tbl = table + (size_t)b * W;
    for (int t = 0; t < n_tiles; ++t) {
      const int st = t % STAGES;
      if (lane == 0) {
        if (t >= STAGES) mbar_wait(empty(st), ((t / STAGES) - 1) & 1);
        if (boxes) mbar_expect_tx(full(st), C::STAGE_BYTES);
      }
      __syncwarp();
      const uint32_t ks = ring + st * C::STAGE_BYTES, vs = ks + NCH * TILE_BYTES;
      if (boxes) {
        // lane e < 8 * NCH: 8-key group e % 8, head-dim chunk e / 8, one
        // box of 8 rows of one pool block each for K and V; a group past
        // k_hi reads plane NB * KVH, past the pool, which TMA zero-fills
        for (int e = lane; e < 8 * NCH; e += 32) {
          const int kp = t * BN + (e % 8) * 8, ch = e / 8;
          const bool live = kp < w.k_hi;
          const int plane = live ? __ldg(tbl + kp / BS) * KVH + kh : NB * KVH;
          const int row = live ? kp % BS : 0;
          const uint32_t dst = ch * TILE_BYTES + (e % 8) * 1024;
          tma_load_3d(ks + dst, &map_k, ch * CHUNK, row, plane, full(st));
          tma_load_3d(vs + dst, &map_v, ch * CHUNK, row, plane, full(st));
        }
        continue;
      }
      // any other block size: the lane's 16 key rows (lane / 8, + 4, ...)
      // walked through the table without a division, then the copies
      const int kp0 = t * BN + lane / 8;
      int blk = kp0 / BS, r = kp0 % BS;
      size_t off[BN / 4];
      bool live[BN / 4];
#pragma unroll
      for (int i = 0; i < BN / 4; ++i) {
        live[i] = kp0 + 4 * i < w.k_hi;  // keys past it arrive as zeros
        off[i] = live[i] ? (((size_t)__ldg(tbl + blk) * KVH + kh) * BS + r) * D : 0;
        for (r += 4; r >= BS; r -= BS) ++blk;
      }
#pragma unroll
      for (int i = 0; i < BN / 4; ++i) {
#pragma unroll
        for (int ch = 0; ch < NCH; ++ch) {
          const int col = ch * CHUNK + c * 8;
          const bool ok = live[i] && col < D;
          const uint32_t dst = ch * TILE_BYTES + swizzled(lane / 8 + 4 * i, c);
          cp_async16(ks + dst, k_pool + (ok ? off[i] + col : 0), ok);
          cp_async16(vs + dst, v_pool + (ok ? off[i] + col : 0), ok);
        }
      }
      cp_async_arrive(full(st));  // once this lane's copies of the tile have landed
    }
    cp_async_commit();  // no copy outlives the lane that issued it
    cp_async_wait<0>();
    return;
  }

  // consumers: accumulator row gid (+ 8) of warp `warp`'s 16 rows
  const int gid = lane / 4, tig = lane % 4;
  int row[2], pos[2];
  bool row_ok[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    row[hh] = r0 + warp * 16 + gid + 8 * hh;
    row_ok[hh] = row[hh] < R;
    pos[hh] = row_ok[hh] ? w.n + row[hh] % q_len : 0;
  }
  float o[NCH][32], m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int ch = 0; ch < NCH; ++ch)
#pragma unroll
    for (int i = 0; i < 32; ++i) o[ch][i] = 0.f;

  // the copies are generic-proxy writes and wgmma reads in the async
  // proxy: each wait that hands a tile over is followed by a proxy fence
  mbar_wait(q_bar, 0);
  fence_proxy_async();
  for (int t = 0; t < n_tiles; ++t) {
    const int st = t % STAGES;
    const uint32_t ks = ring + st * C::STAGE_BYTES, vs = ks + NCH * TILE_BYTES;
    mbar_wait(full(st), (t / STAGES) & 1);
    fence_proxy_async();

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
    // The branch stays outside the loops (inside them the compiler
    // predicates both paths for every score).  Without a softcap a whole
    // tile keeps the raw dots: the scale rides on the max and on the exp's
    // FMA (a positive factor commutes with the max, rounding included).
    const int kb = t * BN;
    float raw = 1.f;  // what takes s to logits: scale for raw dots
    if (whole_tile(w, kb, BN)) {
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
                            kb + (i / 4) * 8 + tig * 2 + (i & 1), w.k_hi, scale, softcap);
    }
    float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int i = 0; i < 32; ++i) mx[(i % 4) / 2] = fmaxf(mx[(i % 4) / 2], s[i]);
    // e^(x - m) as 2^(x log2(e) - m log2(e)): one FMA and ex2 per score
    float m_l2[2], alpha[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      // a row's 4 owner threads are neighbouring lanes
      mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 1));
      mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 2));
      const float m_new = fmaxf(m[hh], mx[hh] * raw);
      // guard fully-masked rows exactly as the reference kernel does
      const float m_safe = m_new <= NEG_INF / 2 ? 0.f : m_new;
      alpha[hh] = m[hh] <= NEG_INF / 2 ? 0.f : ex2((m[hh] - m_safe) * LOG2E);
      m_l2[hh] = m_safe * LOG2E;
      m[hh] = m_new;
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
    for (int hh = 0; hh < 2; ++hh) {
      lsum[hh] += __shfl_xor_sync(0xffffffffu, lsum[hh], 1);
      lsum[hh] += __shfl_xor_sync(0xffffffffu, lsum[hh], 2);
      l[hh] = alpha[hh] * l[hh] + lsum[hh];
    }
    if (__any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f)) {  // a max moved
#pragma unroll
      for (int ch = 0; ch < NCH; ++ch)
#pragma unroll
        for (int i = 0; i < 32; ++i) o[ch][i] *= alpha[(i % 4) / 2];
    }

    // O += P V: the score tiles of keys 16kc .. 16kc + 15 are the A fragment
    wgmma_fence();
#pragma unroll
    for (int ch = 0; ch < NCH; ++ch) {
#pragma unroll
      for (int kc = 0; kc < BN / 16; ++kc) {
        const uint32_t a[4] = {pf[2 * kc][0], pf[2 * kc][1], pf[2 * kc + 1][0],
                               pf[2 * kc + 1][1]};
        wgmma_rs(o[ch], a, smem_desc(vs + ch * TILE_BYTES + kc * 16 * 128));
      }
    }
    wgmma_commit();
    wgmma_wait_all();
#pragma unroll
    for (int ch = 0; ch < NCH; ++ch) fence_regs(o[ch]);
    mbar_arrive(empty(st));  // this stage's K and V have been read
  }

#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    if (!row_ok[hh]) continue;
    const float denom = fmaxf(l[hh], 1e-30f);
    bf16* orow = out + (row_base + row[hh]) * D;
#pragma unroll
    for (int ch = 0; ch < NCH; ++ch)
#pragma unroll
      for (int j = 0; j < CHUNK / 8; ++j) {
        const int col = ch * CHUNK + j * 8 + tig * 2;
        if (col < D)
          *reinterpret_cast<uint32_t*>(orow + col) =
              pack_bf16(o[ch][4 * j + 2 * hh] / denom, o[ch][4 * j + 2 * hh + 1] / denom);
      }
  }
}

// ------------------------------------------------- float32 and int8 pools
constexpr int THREADS = 128;  // float32 kernel
constexpr int KC = 32;        // keys per tile
constexpr int TX = 8;         // threads across a tile's keys (4 keys each, 8 apart)
constexpr int TY = RT / 4;    // threads down the rows (4 rows each)
static_assert(TX * TY == THREADS && KC == 4 * TX, "4 x 4 score tiles cover the block");

// Dynamic shared memory of the float32 kernel, in floats: Q transposed; K
// rows (stride KP = D + 4: the float4 reads of keys 8 apart fall in
// distinct banks) and V rows, two pairs for a float32 pool (the copies of
// the next tile land in the other), one for an int8 pool; p (+1 column);
// then, for an int8 pool, two staging stages of K and V codes (bytes).
template <typename TKV, int D>
struct F32Smem {
  static constexpr bool QUANT = std::is_same<TKV, int8_t>::value;
  static constexpr int KP = D + 4;
  static constexpr int PAIRS = QUANT ? 1 : 2;
  static constexpr int QT = 0, KS = QT + D * RT, VS = KS + PAIRS * KC * KP,
                       PS = VS + PAIRS * KC * D, ST = PS + RT * (KC + 1);
  static constexpr size_t STAGE = QUANT ? 2 * KC * D : 0;  // bytes: K codes, then V codes
  static constexpr size_t bytes = ST * sizeof(float) + 2 * STAGE;
  static_assert(ST % 4 == 0 && KP % 4 == 0, "16-byte aligned tiles");
};

template <typename TKV, int D>
__global__ void __launch_bounds__(THREADS)
paged_prefill_f32_kernel(const float* __restrict__ q,         // [B, KVH, R, D]
                         const TKV* __restrict__ k_pool,      // [NB, KVH, BS, D]
                         const TKV* __restrict__ v_pool,      // [NB, KVH, BS, D]
                         const int32_t* __restrict__ table,   // [B, W]
                         const int32_t* __restrict__ start,   // [B]
                         const float* __restrict__ k_scale,   // [KVH] (int8 pools)
                         const float* __restrict__ v_scale,   // [KVH] (int8 pools)
                         float* __restrict__ out,             // [B, KVH, R, D]
                         int KVH, int R, int BS, int W, int q_len, float scale,
                         float softcap) {
  using L = F32Smem<TKV, D>;
  constexpr bool QUANT = L::QUANT;
  constexpr int KP = L::KP;
  constexpr int VEC = 16 / sizeof(TKV);  // elements per 16-byte copy
  constexpr int PIECES = D / VEC;        // copies per K or V row
  constexpr int CW = D >= 32 ? 4 : D / TX;  // output columns of a thread per group
  constexpr int NG = D / (TX * CW);         // groups: columns g * TX * CW + tx * CW ..
  static_assert(D % VEC == 0 && NG * TX * CW == D, "head dim must split into copies and lanes");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* const sm = reinterpret_cast<float*>(smem_raw);
  float(*const qT)[RT] = reinterpret_cast<float(*)[RT]>(sm + L::QT);
  float* const ks0 = sm + L::KS;
  float* const vs0 = sm + L::VS;
  float(*const ps)[KC + 1] = reinterpret_cast<float(*)[KC + 1]>(sm + L::PS);
  int8_t* const stage0 = reinterpret_cast<int8_t*>(sm + L::ST);

  const int tid = threadIdx.x, tx = tid % TX, ty = tid / TX;
  const int r0 = blockIdx.x * RT, kh = blockIdx.y, b = blockIdx.z;
  const Walk w = tile_walk(r0, R, q_len, start[b], W * BS);
  const int n_tiles = (w.k_hi + KC - 1) / KC;
  const int32_t* tbl = table + (size_t)b * W;
  const size_t row_base = ((size_t)b * KVH + kh) * R;

  // the copies of key tile t: K and V rows through the table (keys past
  // k_hi zero-filled) into pair t % 2 (float32) or staging stage t % 2
  // (int8), one commit group
  auto gather = [&](int t) {
    for (int e = tid; e < KC * PIECES; e += THREADS) {
      const int j = e / PIECES, pc = e % PIECES, kp = t * KC + j;
      const bool ok = kp < w.k_hi;
      const size_t off = ok ? pool_row(tbl, kp, kh, KVH, BS, D) + pc * VEC : 0;
      uint32_t kd, vd;
      if constexpr (QUANT) {
        int8_t* s = stage0 + (t % 2) * L::STAGE;
        kd = smem_u32(s + j * D + pc * VEC);
        vd = smem_u32(s + KC * D + j * D + pc * VEC);
      } else {
        kd = smem_u32(ks0 + (t % 2) * KC * KP + j * KP + pc * VEC);
        vd = smem_u32(vs0 + (t % 2) * KC * D + j * D + pc * VEC);
      }
      cp_async16(kd, k_pool + off, ok);
      cp_async16(vd, v_pool + off, ok);
    }
    cp_async_commit();
  };
  if (n_tiles > 0) gather(0);

  for (int c = tid; c < RT * (D / 4); c += THREADS) {
    const int r = c % RT, dv = (c / RT) * 4;
    float4 f = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + r < R) f = *reinterpret_cast<const float4*>(q + (row_base + r0 + r) * D + dv);
    qT[dv][r] = f.x;
    qT[dv + 1][r] = f.y;
    qT[dv + 2][r] = f.z;
    qT[dv + 3][r] = f.w;
  }
  float k_sc = 1.f, v_sc = 1.f;
  if constexpr (QUANT) {
    k_sc = k_scale[kh];
    v_sc = v_scale[kh];
  }

  int pos[4];
  bool row_ok[4];
  float m[4], l[4], acc[4][NG * CW];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = r0 + ty * 4 + i;
    row_ok[i] = r < R;
    pos[i] = row_ok[i] ? w.n + r % q_len : 0;
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NG * CW; ++c) acc[i][c] = 0.f;
  }

  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait<0>();
    __syncthreads();  // tile t has landed for every thread; tile t - 1's readers are done
    if (t + 1 < n_tiles) gather(t + 1);
    const float* kt = ks0;
    const float* vt = vs0;
    if constexpr (QUANT) {
      // dequantize: float(code) * scale, the reference's float32 product
      const int8_t* sk = stage0 + (t % 2) * L::STAGE;
      const int8_t* sv = sk + KC * D;
      for (int e = tid; e < KC * (D / 4); e += THREADS) {
        const int j = e / (D / 4), d = (e % (D / 4)) * 4;
        const char4 kc = *reinterpret_cast<const char4*>(sk + j * D + d);
        const char4 vc = *reinterpret_cast<const char4*>(sv + j * D + d);
        *reinterpret_cast<float4*>(ks0 + j * KP + d) =
            make_float4(static_cast<float>(kc.x) * k_sc, static_cast<float>(kc.y) * k_sc,
                        static_cast<float>(kc.z) * k_sc, static_cast<float>(kc.w) * k_sc);
        *reinterpret_cast<float4*>(vs0 + j * D + d) =
            make_float4(static_cast<float>(vc.x) * v_sc, static_cast<float>(vc.y) * v_sc,
                        static_cast<float>(vc.z) * v_sc, static_cast<float>(vc.w) * v_sc);
      }
      __syncthreads();
    } else {
      kt += (t % 2) * KC * KP;
      vt += (t % 2) * KC * D;
    }

    // s[i][jj]: row ty * 4 + i, key tx + 8 jj of the tile
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) s[i][jj] = 0.f;
#pragma unroll 2
    for (int d = 0; d < D; d += 4) {
      float qv[4][4], kv[4][4];  // [d + u][row i], [key jj][d + u]
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float4 a = *reinterpret_cast<const float4*>(&qT[d + u][ty * 4]);
        qv[u][0] = a.x;
        qv[u][1] = a.y;
        qv[u][2] = a.z;
        qv[u][3] = a.w;
      }
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const float4 a = *reinterpret_cast<const float4*>(kt + (tx + TX * jj) * KP + d);
        kv[jj][0] = a.x;
        kv[jj][1] = a.y;
        kv[jj][2] = a.z;
        kv[jj][3] = a.w;
      }
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) s[i][jj] += qv[u][i] * kv[jj][u];
    }

    const int kb = t * KC;
    const bool whole = whole_tile(w, kb, KC);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = NEG_INF;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        if (whole) {
          float x = s[i][jj] * scale;
          if (softcap > 0.f) x = tanhf(x / softcap) * softcap;
          s[i][jj] = x;
        } else {
          s[i][jj] = masked_logit(s[i][jj], row_ok[i], pos[i], kb + tx + TX * jj, w.k_hi,
                                  scale, softcap);
        }
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
        ps[ty * 4 + i][tx + TX * jj] = p;  // float32 V: p is not rounded
      }
#pragma unroll
      for (int o = 1; o < TX; o <<= 1) lsum += __shfl_xor_sync(0xffffffffu, lsum, o);
      l[i] = alpha * l[i] + lsum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < NG * CW; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int j = 0; j < KC; ++j) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = ps[ty * 4 + i][j];
#pragma unroll
      for (int g = 0; g < NG; ++g) {
        float vv[CW];
        const float* src = vt + j * D + g * TX * CW + tx * CW;
        if constexpr (CW == 4) {
          const float4 a = *reinterpret_cast<const float4*>(src);
          vv[0] = a.x;
          vv[1] = a.y;
          vv[2] = a.z;
          vv[3] = a.w;
        } else {
#pragma unroll
          for (int c = 0; c < CW; ++c) vv[c] = src[c];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int c = 0; c < CW; ++c) acc[i][g * CW + c] += pv[i] * vv[c];
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (!row_ok[i]) continue;
    const float denom = fmaxf(l[i], 1e-30f);
    float* orow = out + (row_base + r0 + ty * 4 + i) * D;
#pragma unroll
    for (int g = 0; g < NG; ++g)
#pragma unroll
      for (int c = 0; c < CW; ++c) orow[g * TX * CW + tx * CW + c] = acc[i][g * CW + c] / denom;
  }
}

struct Args {
  const void *q, *kp, *vp;
  const int32_t *table, *start;
  const float *k_scale, *v_scale;
  void* out;
  int B, NB, KVH, R, BS, W, q_len;
  float scale, softcap;
};

// TMA map of a contiguous bf16 pool viewed as [planes = NB * KVH, BS, D],
// read in boxes of 64 columns x 8 rows (one 1024-byte swizzle atom),
// 128-byte swizzled; columns past D and planes past the pool read as
// zeros.  Returns 0 or 10000 + the CUresult.
int encode_pool_map(CUtensorMap* map, const void* pool, int D, int BS, int planes) {
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(BS),
                              static_cast<cuuint64_t>(planes)};
  const cuuint32_t box[3] = {CHUNK, 8, 1};
  return encode_swizzled_map(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, 3, pool, dims, box);
}

template <typename TKV, int D>
constexpr size_t smem_bytes() {
  if constexpr (std::is_same<TKV, bf16>::value)
    return Bf16Cfg<D>::bytes;
  else
    return F32Smem<TKV, D>::bytes;
}

template <typename TKV, int D>
int launch(const Args& a, cudaStream_t s) {
  constexpr size_t smem = smem_bytes<TKV, D>();
  static_assert(smem <= 232448, "tiles exceed the 227 KB a block may use");
  dim3 grid((a.R + RT - 1) / RT, a.KVH, a.B);
  if constexpr (std::is_same<TKV, bf16>::value) {
    // the pools' TMA maps (the box route, BS % 8 == 0): they hold the
    // pools' addresses, so they are encoded per call, host work only
    CUtensorMap mk{}, mv{};
    if (a.BS % 8 == 0) {
      int e = encode_pool_map(&mk, a.kp, D, a.BS, a.NB * a.KVH);
      if (e == 0) e = encode_pool_map(&mv, a.vp, D, a.BS, a.NB * a.KVH);
      if (e != 0) return e;
    }
    auto* kern = paged_prefill_bf16_kernel<D>;
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    kern<<<grid, BF16_THREADS, smem, s>>>(
        mk, mv, static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.kp),
        static_cast<const bf16*>(a.vp), a.table, a.start, static_cast<bf16*>(a.out), a.NB,
        a.KVH, a.R, a.BS, a.W, a.q_len, a.scale, a.softcap);
  } else {
    if (std::is_same<TKV, int8_t>::value && (a.k_scale == nullptr || a.v_scale == nullptr))
      return static_cast<int>(cudaErrorInvalidValue);
    auto* kern = paged_prefill_f32_kernel<TKV, D>;
    if (smem > 48 * 1024) {  // past the default limit: ask for it (per device, cheap)
      const cudaError_t e = cudaFuncSetAttribute(
          kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
      if (e != cudaSuccess) return static_cast<int>(e);
    }
    kern<<<grid, THREADS, smem, s>>>(
        static_cast<const float*>(a.q), static_cast<const TKV*>(a.kp),
        static_cast<const TKV*>(a.vp), a.table, a.start, a.k_scale, a.v_scale,
        static_cast<float*>(a.out), a.KVH, a.R, a.BS, a.W, a.q_len, a.scale, a.softcap);
  }
  return 0;
}

// One instantiation of the kernels: pool type and head dim.
template <typename T, int D_>
struct Inst {
  using type = T;
  static constexpr int D = D_;
};

template <int D, typename R, typename F>
R with_dtype(int dtype, R none, F&& f) {
  switch (dtype) {  // 0 float32 pool, 1 bf16 pool, 2 int8 pool (float32 queries)
    case 0:
      return f(Inst<float, D>{});
    case 1:
      return f(Inst<bf16, D>{});
    case 2:
      return f(Inst<int8_t, D>{});
    default:
      return none;
  }
}

// Calls f(Inst<T, D>{}) for the instantiation that serves head dim D and
// dtype; returns `none` for one it is not built for.  The launch and the
// shared-memory query both take it.
template <typename R, typename F>
R with_inst(int D, int dtype, R none, F&& f) {
  switch (D) {  // the head dims the kernels are instantiated for (_build.py HEAD_DIMS)
    case 16:
      return with_dtype<16>(dtype, none, f);
    case 64:
      return with_dtype<64>(dtype, none, f);
    case 128:
      return with_dtype<128>(dtype, none, f);
    case 256:
      return with_dtype<256>(dtype, none, f);
    default:
      return none;
  }
}

}  // namespace

// q [B, KVH, R, D] with R = G * q_len (bf16 for a bf16 pool, float32
// otherwise); pools [NB, KVH, BS, D]; table [B, W] int32; start [B] int32
// (each slot's suffix start); k_scale/v_scale [KVH] float32 for an int8
// pool, null otherwise; out [B, KVH, R, D] in q's dtype, already divided
// by the softmax denominator.  dtype: 0 float32, 1 bf16, 2 int8.  All
// contiguous with 16-byte aligned starts.  Returns a cudaError_t.
extern "C" int paged_prefill_launch(const void* q, const void* kp, const void* vp,
                                    const void* table, const void* start, const void* k_scale,
                                    const void* v_scale, void* out, int B, int NB, int KVH,
                                    int R, int D, int BS, int W, int q_len, float scale,
                                    float softcap, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || B > 65535 || NB <= 0 || KVH <= 0 || KVH > 65535 || R <= 0 || BS <= 0 ||
      W < 0 || q_len <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{q, kp, vp, static_cast<const int32_t*>(table),
               static_cast<const int32_t*>(start), static_cast<const float*>(k_scale),
               static_cast<const float*>(v_scale), out, B, NB, KVH, R, BS, W, q_len, scale,
               softcap};
  const int e = with_inst(D, dtype, static_cast<int>(cudaErrorInvalidValue), [&](auto t) {
    using I = decltype(t);
    return launch<typename I::type, I::D>(a, s);
  });
  if (e != 0) return e;
  return static_cast<int>(cudaGetLastError());
}

// Dynamic shared memory of the kernel at head dim D and dtype (as above);
// 0 for one it is not built for.
extern "C" int paged_prefill_smem_bytes(int D, int dtype) {
  return with_inst(D, dtype, 0, [](auto t) {
    using I = decltype(t);
    return static_cast<int>(smem_bytes<typename I::type, I::D>());
  });
}
