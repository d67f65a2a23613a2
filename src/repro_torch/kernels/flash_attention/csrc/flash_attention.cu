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
// Design: one 128-thread block per (64-row query tile, batch x KV head).
// The TPU kernel carries m, l and the accumulator in output blocks that
// its sequential grid revisits; here the block itself loops over key
// tiles, keeping the running max m, denominator l and float32 accumulator
// of its rows in registers (a row's owner threads hold identical copies of
// m and l, reduced by warp shuffles).  Key tiles wholly above the diagonal
// or wholly outside the window of every row of the tile are never visited:
// the block walks keys [max(0, pos_lo - window + 1), pos_hi + 1) of its
// rows' position range; keys past the end read as zero.
//
// bf16 takes the tensor cores (mma.sync m16n8k16, bf16 products summed in
// float32, as the reference's dot_general with a float32 result): each
// warp owns 16 query rows, holds their Q fragments in registers, and per
// 64-key tile computes its 16 x 64 scores against K in shared memory, the
// softmax update in registers, and O += P V with P rounded to bf16 and
// reused as the A fragment straight from the score registers (V is staged
// transposed so each B fragment is one 32-bit load).  float32 keeps
// float32 products on the CUDA cores (the tensor cores' float32 modes
// round to TF32): Q staged transposed in shared memory, 32-key tiles,
// 4 x 4 register tiles of FMA dot products, p through shared memory.
// Instantiated for head dims 16, 64, 128 and 256.  The tiles live in
// dynamic shared memory (F32Smem, Bf16Smem): past head dim 64 they outgrow
// the 48 KB of a static allocation (float32 at 256: 140 KB; bf16 at 256:
// 104 KB), so the launch raises the kernel's limit first.  At head dim 256
// the bf16 path's O accumulator alone is 128 floats a thread, so Q's
// fragments are read from shared memory at each k-step instead of being
// held in registers.  No cp.async/TMA pipeline and no wgmma yet: later
// work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int THREADS = 128;
constexpr int RT = 64;  // query rows per block
constexpr float NEG_INF = -1e30f;

// Keys [k_lo, k_hi) that some row of the tile starting at row r0 may see.
__device__ __forceinline__ void key_range(int r0, int R, int Sk, int q_len, int causal,
                                          int window, int& k_lo, int& k_hi) {
  const int r_last = min(r0 + RT, R) - 1;
  int pos_lo = r0 % q_len, pos_hi = r_last % q_len;
  if (r0 / q_len != r_last / q_len) {  // the tile spans a head boundary
    pos_lo = 0;
    pos_hi = q_len - 1;
  }
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
constexpr int MMA_KC = 64;  // keys per tile
constexpr int PAD = 8;      // bf16 padding of a shared-memory row: conflict-free fragments
static_assert(RT == 16 * (THREADS / 32), "each warp owns 16 query rows");

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two bf16 (round to nearest even), the lower column in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Dynamic shared memory of the bf16 kernel, in bytes: K as is (B fragments
// of QK^T), V transposed (B fragments of PV), and past head dim 128 the
// tile's Q rows (A fragments of QK^T).
template <int D>
struct Bf16Smem {
  static constexpr bool QSMEM = D > 128;
  static constexpr size_t KS = 0, VT = KS + MMA_KC * (D + PAD) * sizeof(bf16),
                          QS = VT + D * (MMA_KC + PAD) * sizeof(bf16),
                          bytes = QS + (QSMEM ? RT * (D + PAD) * sizeof(bf16) : 0);
};

template <int D>
__global__ void __launch_bounds__(THREADS)
flash_attention_bf16_kernel(const bf16* __restrict__ q,  // [BH, R, D]
                            const bf16* __restrict__ k,  // [BH, Sk, D]
                            const bf16* __restrict__ v,  // [BH, Sk, D]
                            bf16* __restrict__ out,      // [BH, R, D]
                            int R, int Sk, int q_len, int causal, int window, float scale,
                            float softcap) {
  constexpr int VEC = 8;            // bf16 per 16-byte load
  constexpr int KD = D / 16;        // k-steps of QK^T over the head dim
  constexpr int ND = D / 8;         // n-tiles of O over the head dim
  constexpr int NK = MMA_KC / 8;    // n-tiles of S over a tile's keys
  static_assert(D % 16 == 0, "head dim must be whole mma k-steps");
  using L = Bf16Smem<D>;
  constexpr bool QSMEM = L::QSMEM;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16(*const ks)[D + PAD] = reinterpret_cast<bf16(*)[D + PAD]>(smem_raw + L::KS);
  bf16(*const vt)[MMA_KC + PAD] = reinterpret_cast<bf16(*)[MMA_KC + PAD]>(smem_raw + L::VT);
  bf16(*const qs)[D + PAD] = reinterpret_cast<bf16(*)[D + PAD]>(smem_raw + L::QS);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gid = lane / 4, tig = lane % 4;  // mma fragment row group, thread in group
  const int r0 = blockIdx.x * RT;
  const size_t bh = blockIdx.y;
  const bf16* qb = q + bh * R * D;
  const bf16* kb = k + bh * Sk * D;
  const bf16* vb = v + bh * Sk * D;
  int k_lo, k_hi;
  key_range(r0, R, Sk, q_len, causal, window, k_lo, k_hi);

  // this thread's two rows (fragment rows gid and gid + 8 of the warp's 16)
  int row[2], pos[2];
  bool row_ok[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    row[h] = r0 + warp * 16 + gid + 8 * h;
    row_ok[h] = row[h] < R;
    pos[h] = row_ok[h] ? row[h] % q_len : 0;
  }
  uint32_t qf[QSMEM ? 1 : KD][4];  // A fragments of Q, rows past R zero
  if constexpr (QSMEM) {
    // the tile's Q rows, rows past R zero; the first tile's barrier
    // publishes them
    for (int c = tid; c < RT * (D / VEC); c += THREADS) {
      const int r = c / (D / VEC), dv = (c % (D / VEC)) * VEC;
      uint4 w = make_uint4(0u, 0u, 0u, 0u);
      if (r0 + r < R) w = *reinterpret_cast<const uint4*>(qb + (size_t)(r0 + r) * D + dv);
      *reinterpret_cast<uint4*>(&qs[r][dv]) = w;
    }
  } else {
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      const int c = kk * 16 + tig * 2;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const bf16* qr = qb + (size_t)row[h] * D + c;
        qf[kk][h] = row_ok[h] ? ld32(qr) : 0u;
        qf[kk][h + 2] = row_ok[h] ? ld32(qr + 8) : 0u;
      }
    }
  }
  float o[ND][4], m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;

  for (int base = k_lo; base < k_hi; base += MMA_KC) {
    __syncthreads();  // the previous tile's readers are done
    for (int c = tid; c < MMA_KC * (D / VEC); c += THREADS) {
      const int j = c % MMA_KC, dv = (c / MMA_KC) * VEC;
      const int kp = base + j;
      uint4 kw = make_uint4(0u, 0u, 0u, 0u), vw = kw;
      if (kp < k_hi) {
        kw = *reinterpret_cast<const uint4*>(kb + (size_t)kp * D + dv);
        vw = *reinterpret_cast<const uint4*>(vb + (size_t)kp * D + dv);
      }
      *reinterpret_cast<uint4*>(&ks[j][dv]) = kw;
      const bf16* ve = reinterpret_cast<const bf16*>(&vw);
#pragma unroll
      for (int i = 0; i < VEC; ++i) vt[dv + i][j] = ve[i];
    }
    __syncthreads();

    float s[NK][4];  // scores: [n-tile][c0 c1 (row gid) c2 c3 (row gid + 8)]
#pragma unroll
    for (int j = 0; j < NK; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      uint32_t a[4];
      if constexpr (QSMEM) {
        const bf16* qr = &qs[warp * 16 + gid][kk * 16 + tig * 2];
        a[0] = ld32(qr);
        a[1] = ld32(qr + 8 * (D + PAD));
        a[2] = ld32(qr + 8);
        a[3] = ld32(qr + 8 * (D + PAD) + 8);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) a[e] = qf[kk][e];
      }
#pragma unroll
      for (int j = 0; j < NK; ++j) {  // each s[j] still sums its k-steps in order
        const bf16* kr = &ks[j * 8 + gid][kk * 16 + tig * 2];
        mma_bf16(s[j], a, ld32(kr), ld32(kr + 8));
      }
    }

    float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int j = 0; j < NK; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e / 2;
        s[j][e] = masked_logit(s[j][e], row_ok[h], pos[h], base + j * 8 + tig * 2 + (e & 1),
                               k_hi, causal, window, scale, softcap);
        mx[h] = fmaxf(mx[h], s[j][e]);
      }
    float m_safe[2], alpha[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      // a row's 4 owner threads are neighbouring lanes
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      const float m_new = fmaxf(m[h], mx[h]);
      // guard fully-masked rows exactly as the reference kernel does
      m_safe[h] = m_new <= NEG_INF / 2 ? 0.f : m_new;
      alpha[h] = m[h] <= NEG_INF / 2 ? 0.f : expf(m[h] - m_safe[h]);
      m[h] = m_new;
    }
    float lsum[2] = {0.f, 0.f};
    uint32_t pf[NK][2];  // p rounded to bf16 (V's dtype): row gid, row gid + 8
#pragma unroll
    for (int j = 0; j < NK; ++j) {
      float p[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        p[e] = s[j][e] > NEG_INF / 2 ? expf(s[j][e] - m_safe[e / 2]) : 0.f;
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
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      o[n][0] *= alpha[0];
      o[n][1] *= alpha[0];
      o[n][2] *= alpha[1];
      o[n][3] *= alpha[1];
    }
#pragma unroll
    for (int kc = 0; kc < MMA_KC / 16; ++kc) {
      // the score tiles of keys kc*16 .. +15 are the A fragment of P
      const uint32_t a[4] = {pf[2 * kc][0], pf[2 * kc][1], pf[2 * kc + 1][0],
                             pf[2 * kc + 1][1]};
#pragma unroll
      for (int n = 0; n < ND; ++n) {
        const bf16* vr = &vt[n * 8 + gid][kc * 16 + tig * 2];
        mma_bf16(o[n], a, ld32(vr), ld32(vr + 8));
      }
    }
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (!row_ok[h]) continue;
    const float denom = fmaxf(l[h], 1e-30f);
    bf16* orow = out + (bh * R + row[h]) * D + tig * 2;
#pragma unroll
    for (int n = 0; n < ND; ++n)
      *reinterpret_cast<uint32_t*>(orow + n * 8) =
          pack_bf16(o[n][2 * h] / denom, o[n][2 * h + 1] / denom);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* out, int BH, int R,
                   int Sk, int q_len, int causal, int window, float scale, float softcap,
                   cudaStream_t s) {
  dim3 grid((R + RT - 1) / RT, BH);
  if constexpr (std::is_same<T, float>::value) {
    constexpr size_t smem = F32Smem<D>::bytes;
    static_assert(smem <= 232448, "tiles exceed the 227 KB a block may use");
    auto* kern = flash_attention_f32_kernel<D>;
    if (smem > 48 * 1024) {  // past the default limit: ask for it (per device, cheap)
      const cudaError_t e = cudaFuncSetAttribute(
          kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
      if (e != cudaSuccess) return e;
    }
    kern<<<grid, THREADS, smem, s>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(out), R, Sk, q_len, causal, window,
        scale, softcap);
  } else {
    constexpr size_t smem = Bf16Smem<D>::bytes;
    static_assert(smem <= 232448, "tiles exceed the 227 KB a block may use");
    auto* kern = flash_attention_bf16_kernel<D>;
    if (smem > 48 * 1024) {  // past the default limit: ask for it (per device, cheap)
      const cudaError_t e = cudaFuncSetAttribute(
          kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
      if (e != cudaSuccess) return e;
    }
    kern<<<grid, THREADS, smem, s>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
        static_cast<bf16*>(out), R, Sk, q_len, causal, window, scale, softcap);
  }
  return cudaSuccess;
}

template <int D>
cudaError_t launch_dtype(const void* q, const void* k, const void* v, void* out, int BH,
                         int R, int Sk, int q_len, int causal, int window, float scale,
                         float softcap, int dtype, cudaStream_t s) {
  if (dtype == 0)
    return launch<float, D>(q, k, v, out, BH, R, Sk, q_len, causal, window, scale, softcap, s);
  if (dtype == 1)
    return launch<bf16, D>(q, k, v, out, BH, R, Sk, q_len, causal, window, scale, softcap, s);
  return cudaErrorInvalidValue;
}

}  // namespace

// q [BH, R, D] with R = G * q_len (G query heads of one KV head stacked);
// k, v [BH, Sk, D]; out [BH, R, D], all of one dtype (0 float32, 1 bf16),
// contiguous with 16-byte aligned starts.  Returns a cudaError_t.
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v, void* out,
                                      int BH, int R, int Sk, int D, int q_len, int causal,
                                      int window, float scale, float softcap, int dtype,
                                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (BH <= 0 || BH > 65535 || R <= 0 || Sk <= 0 || q_len <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e;
  switch (D) {  // the head dims the kernel is instantiated for (_build.py HEAD_DIMS)
    case 16:
      e = launch_dtype<16>(q, k, v, out, BH, R, Sk, q_len, causal, window, scale, softcap,
                           dtype, s);
      break;
    case 64:
      e = launch_dtype<64>(q, k, v, out, BH, R, Sk, q_len, causal, window, scale, softcap,
                           dtype, s);
      break;
    case 128:
      e = launch_dtype<128>(q, k, v, out, BH, R, Sk, q_len, causal, window, scale, softcap,
                            dtype, s);
      break;
    case 256:
      e = launch_dtype<256>(q, k, v, out, BH, R, Sk, q_len, causal, window, scale, softcap,
                            dtype, s);
      break;
    default:
      e = cudaErrorInvalidValue;
  }
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}
