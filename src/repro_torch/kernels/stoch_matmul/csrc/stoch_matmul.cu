// The OSSM array on CUDA cores (sm_90a): stochastic matmul reading the
// activations as packed streams or as int8 codes it encodes while staging,
// against a weight's packed streams.
//
// Replaces: src/repro/kernels/stoch_matmul/kernel.py :: stoch_matmul_packed_kernel
// (the Pallas kernel that ANDs 128-bit streams, popcounts them and sums the
// signed counts over K on the TPU's vector unit) at its packed interface.
// Computes
//   C[m, n] = sum_k SX[m, k] * SW[n, k] * popc(X[m, k] & W[n, k])
// into int32, with X [M, K, 4] and W [N, K, 4] 128-bit streams (4 x 32
// bits, both K-contiguous) and SX, SW signs.  Integer sums are exact in any
// order, so the result is bit-identical to the plain version.  The serving
// path (codes against codes, weights cached as codes) runs
// stoch_gemm_sm90.cu on the binary tensor cores instead; this kernel serves
// stoch_matmul_packed (the TPU kernel's interface) and stoch_matmul_codes
// (activation codes against packed weight streams).
//
// Each X operand is a policy (Packed, Codes) of the one kernel template:
// * Packed: words and int8 signs as bts_encode writes them.
// * Codes: int8 codes, expanded while the tile is staged.  At phase 0 a
//   code's stream is a fixed function of its magnitude: the block copies
//   the generator's table of 129 streams (magnitudes 0..127, then row
//   128, code -128's; 16 bytes each, built by the wrapper from
//   core/bitstream.py's encode and encode_signed, so the two cannot
//   differ) into shared memory once, and a code c stages as table[|c|]
//   with sign c < 0 ? -1 : +1 (zero: the empty stream, sign +1; every code
//   as encode_signed gives it).  A codes form loads its tiles as unrolled
//   runs, so each K step's global loads are in flight together and the
//   table lookups hide behind them.
//
// What bounds it on an H100: the popcounts.  Each (m, n, k) costs four
// __popc, and the card retires 16 of them per clock per SM, against 64 per
// clock for the AND, the adds and the sign multiply; at decode (M = 8 slots)
// a step runs 8 x 1.44e9 x 4 = 4.6e10 of them, about 11 ms on 132 SMs,
// above the 7.3 ms it takes to stream the 24.5 GB of weight streams and
// signs once.  stoch_gemm_sm90.cu takes the same products to the binary
// tensor cores (mma.sync / wgmma .b1 .and.popc), from codes alone.
//
// Design: a block owns a BM x BN output tile and walks its K range BK
// positions at a time through shared memory (coalesced 16-byte loads of
// each row's words, rows padded by one 16-byte group so the threads' reads
// of 16 consecutive rows fall on distinct banks).  Each thread keeps a
// TM x TN register tile; per K position it reads TM words of X (the same
// for the threads of a row, so broadcast) and TN words of W.  Decode-sized
// problems (M <= 8) take an 8 x 128 tile, one output column and all eight
// rows per thread; larger M a 64 x 64 tile of 4 x 4 per thread.  Ragged
// M/N/K read zero words, which add nothing whatever their sign.
// gridDim.z runs over splits of K whose int32 partial sums meet by
// atomicAdd, when the output tiles cannot fill the SMs, and in a separate
// instantiation over a batch of independent products as well.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BK = 16;          // K positions per shared-memory step
constexpr int PITCH = BK + 1;   // uint4 per shared row of words
constexpr int SPITCH = BK + 4;  // bytes per shared row of signs (odd word stride)
constexpr int TABLE = 129;      // streams of magnitudes 0..128 (128: code -128)

// An operand read as the TPU kernel's packed streams and int8 signs.
struct Packed {
  static constexpr bool kCodes = false;
  const uint4* words;   // [rows, K] streams
  const int8_t* sign;   // [rows, K] +1 / -1
  __device__ __forceinline__ void skip(size_t n) {
    words += n;
    sign += n;
  }
  __device__ __forceinline__ void read(size_t at, const uint4*, uint4& w, int8_t& s) const {
    w = __ldg(words + at);
    s = __ldg(sign + at);
  }
};

// An X operand read as int8 codes and encoded from the generator's table
// (staged in shared memory as ``table_s``).
struct Codes {
  static constexpr bool kCodes = true;
  const int8_t* q;      // [rows, K] codes
  const uint4* table;   // [TABLE] the generator's stream of each magnitude
  __device__ __forceinline__ void skip(size_t n) { q += n; }
  __device__ __forceinline__ void read(size_t at, const uint4* table_s, uint4& w,
                                       int8_t& s) const {
    const int c = __ldg(q + at);
    w = table_s[c < 0 ? -c : c];
    s = c < 0 ? int8_t(-1) : int8_t(1);
  }
};

// Rows [r0, r0 + ROWS) x K positions [k0, k0 + BK) of an operand into
// shared memory; rows >= rows and positions >= k_end read zero words.
// UNROLL: each thread's loads as one unrolled run, so all of a K step's
// global loads are in flight together.
template <int ROWS, int THREADS, bool UNROLL, class Op>
__device__ __forceinline__ void load_tile(uint4* __restrict__ words_s, int8_t* __restrict__ sign_s,
                                          const Op& op, const uint4* table_s, int r0, int rows,
                                          int k0, int k_end, int K) {
  auto stage = [&](int c) {
    const int r = c / BK, kk = c % BK;
    const int gr = r0 + r, gk = k0 + kk;
    uint4 w = make_uint4(0u, 0u, 0u, 0u);
    int8_t s = 0;
    if (gr < rows && gk < k_end) op.read((size_t)gr * K + gk, table_s, w, s);
    words_s[r * PITCH + kk] = w;
    sign_s[r * SPITCH + kk] = s;
  };
  if constexpr (UNROLL) {
    static_assert(ROWS * BK % THREADS == 0, "whole positions a thread");
#pragma unroll
    for (int i = 0; i < ROWS * BK / THREADS; ++i) stage(threadIdx.x + i * THREADS);
  } else {
    for (int c = threadIdx.x; c < ROWS * BK; c += THREADS) stage(c);
  }
}

template <int BM, int BN, int TM, int TN, bool BATCHED, class XOp>
__global__ void __launch_bounds__((BM / TM) * (BN / TN))
stoch_matmul_kernel(XOp x, Packed w, int32_t* __restrict__ C, int M, int N, int K, int kps,
                    int splits) {
  constexpr int TX = BN / TN, TY = BM / TM, THREADS = TX * TY;
  // Codes forms unroll their tile loads (an X tile of codes is one byte a
  // thread), so a K step's code, word and sign loads are in flight
  // together behind the table lookups; the packed form keeps its loops,
  // which unrolled (17 live 16-byte words a thread) ran slower on an H100.
  constexpr bool UNROLL = XOp::kCodes;
  __shared__ uint4 Xs[BM * PITCH];
  __shared__ uint4 Ws[BN * PITCH];
  __shared__ int8_t SXs[BM * SPITCH];
  __shared__ int8_t SWs[BN * SPITCH];
  __shared__ uint4 x_table[XOp::kCodes ? TABLE : 1];
  if constexpr (XOp::kCodes) {
    for (int i = threadIdx.x; i < TABLE; i += THREADS) x_table[i] = __ldg(x.table + i);
    __syncthreads();
  }

  const int tx = threadIdx.x % TX, ty = threadIdx.x / TX;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  int k_split = blockIdx.z;
  if constexpr (BATCHED) {  // blockIdx.z = batch element * splits + K split
    const int batch = blockIdx.z / splits;
    k_split = blockIdx.z % splits;
    x.skip((size_t)batch * M * K);
    w.skip((size_t)batch * N * K);
    C += (size_t)batch * M * N;
  }
  const int k_begin = k_split * kps;
  const int k_end = min(K, k_begin + kps);

  int acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0;

  for (int k0 = k_begin; k0 < k_end; k0 += BK) {
    load_tile<BM, THREADS, UNROLL>(Xs, SXs, x, x_table, m0, M, k0, k_end, K);
    load_tile<BN, THREADS, UNROLL>(Ws, SWs, w, nullptr, n0, N, k0, k_end, K);
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      uint4 xv[TM], wv[TN];
      int xs[TM], ws[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const int r = ty + i * TY;
        xv[i] = Xs[r * PITCH + kk];
        xs[i] = SXs[r * SPITCH + kk];
      }
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int n = tx + j * TX;
        wv[j] = Ws[n * PITCH + kk];
        ws[j] = SWs[n * SPITCH + kk];
      }
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          // optical AND + photodetector charge, steered by the sign product
          const int pc = __popc(xv[i].x & wv[j].x) + __popc(xv[i].y & wv[j].y) +
                         __popc(xv[i].z & wv[j].z) + __popc(xv[i].w & wv[j].w);
          acc[i][j] += xs[i] * ws[j] * pc;
        }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int r = m0 + ty + i * TY, c = n0 + tx + j * TX;
      if (r < M && c < N) {
        int32_t* dst = C + (size_t)r * N + c;
        if (splits > 1) atomicAdd(dst, acc[i][j]);
        else *dst = acc[i][j];
      }
    }
}

// One launch of the kernel over operands x, w (cfg 0: 8 x 128 tiles for
// decode, cfg 1: 64 x 64 tiles; B > 1: the batched instantiation).
template <class XOp>
int launch(XOp x, Packed w, int32_t* C, int B, int M, int N, int K, int kps, int splits, int cfg,
           cudaStream_t s) {
  const dim3 grid0((N + 127) / 128, (M + 7) / 8, B * splits);
  const dim3 grid1((N + 63) / 64, (M + 63) / 64, B * splits);
  if (cfg == 0 && B == 1)
    stoch_matmul_kernel<8, 128, 8, 1, false><<<grid0, 128, 0, s>>>(x, w, C, M, N, K, kps, splits);
  else if (cfg == 0)
    stoch_matmul_kernel<8, 128, 8, 1, true><<<grid0, 128, 0, s>>>(x, w, C, M, N, K, kps, splits);
  else if (B == 1)
    stoch_matmul_kernel<64, 64, 4, 4, false><<<grid1, 256, 0, s>>>(x, w, C, M, N, K, kps, splits);
  else
    stoch_matmul_kernel<64, 64, 4, 4, true><<<grid1, 256, 0, s>>>(x, w, C, M, N, K, kps, splits);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// X [B,M,K] and W [B,N,K] operands, each packed streams (x: [.., 4] uint32
// words, x_aux: int8 signs) or, for X, int8 codes (x: codes, x_aux: [129,
// 4] uint32 streams of magnitudes 0..128 under the operand's generator), as
// x_codes says; w_codes must be 0 (codes against codes run
// stoch_gemm_sm90.cu).  c [B,M,N] int32 (zeroed by the caller when splits >
// 1).  cfg 0: 8 x 128 tiles (decode), cfg 1: 64 x 64 tiles.
extern "C" int stoch_matmul_launch(const void* x, const void* x_aux, const void* w,
                                   const void* w_aux, void* c, int B, int M, int N, int K,
                                   int kps, int splits, int cfg, int x_codes, int w_codes,
                                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int32_t* C = static_cast<int32_t*>(c);
  const Packed xp{static_cast<const uint4*>(x), static_cast<const int8_t*>(x_aux)};
  const Packed wp{static_cast<const uint4*>(w), static_cast<const int8_t*>(w_aux)};
  const Codes xc{static_cast<const int8_t*>(x), static_cast<const uint4*>(x_aux)};
  if (w_codes) return static_cast<int>(cudaErrorInvalidValue);
  if (!x_codes) return launch(xp, wp, C, B, M, N, K, kps, splits, cfg, s);
  return launch(xc, wp, C, B, M, N, K, kps, splits, cfg, s);
}
