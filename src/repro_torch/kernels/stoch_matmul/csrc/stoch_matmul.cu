// The OSSM array: packed-stream stochastic matmul on Hopper (sm_90a).
//
// Replaces: src/repro/kernels/stoch_matmul/kernel.py :: stoch_matmul_packed_kernel
// (the Pallas kernel that ANDs 128-bit streams, popcounts them and sums the
// signed counts over K on the TPU's vector unit).  Computes
//   C[m, n] = sum_k SX[m, k] * SW[n, k] * popc(X[m, k] & W[n, k])
// into int32, with X [M, K, 4] and W [N, K, 4] packed streams (4 x 32 bits,
// both K-contiguous) and SX, SW int8 signs.  Integer sums are exact in any
// order, so the result is bit-identical to the plain version.
//
// What bounds it on an H100: the popcounts.  Each (m, n, k) costs four
// __popc, and the card retires 16 of them per clock per SM, against 64 per
// clock for the AND, the adds and the sign multiply; at decode (M = 8 slots)
// a step runs 8 x 1.44e9 x 4 = 4.6e10 of them, about 11 ms on 132 SMs,
// above the 7.3 ms it takes to stream the 24.5 GB of weight streams and
// signs once.  Binary tensor cores (mma .b1 .and.popc) would lift the
// operation bound to the byte bound; this kernel is the plain CUDA-core
// design.
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
// instantiation over a batch of independent products as well (dynamic
// qk/pv sites under sc).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BK = 16;          // K positions per shared-memory step
constexpr int PITCH = BK + 1;   // uint4 per shared row of words
constexpr int SPITCH = BK + 4;  // bytes per shared row of signs (odd word stride)

template <int ROWS, int THREADS>
__device__ __forceinline__ void load_tile(uint4* __restrict__ words_s, int8_t* __restrict__ sign_s,
                                          const uint4* __restrict__ words,
                                          const int8_t* __restrict__ sign, int r0, int rows,
                                          int k0, int k_end, int K) {
  for (int c = threadIdx.x; c < ROWS * BK; c += THREADS) {
    const int r = c / BK, kk = c % BK;
    const int gr = r0 + r, gk = k0 + kk;
    const bool ok = gr < rows && gk < k_end;
    const size_t at = (size_t)gr * K + gk;
    words_s[r * PITCH + kk] = ok ? words[at] : make_uint4(0u, 0u, 0u, 0u);
    sign_s[r * SPITCH + kk] = ok ? sign[at] : int8_t(0);
  }
}

template <int BM, int BN, int TM, int TN, bool BATCHED>
__global__ void __launch_bounds__((BM / TM) * (BN / TN))
stoch_matmul_kernel(const uint4* __restrict__ X, const int8_t* __restrict__ SX,
                    const uint4* __restrict__ W, const int8_t* __restrict__ SW,
                    int32_t* __restrict__ C, int M, int N, int K, int kps, int splits) {
  constexpr int TX = BN / TN, TY = BM / TM, THREADS = TX * TY;
  __shared__ uint4 Xs[BM * PITCH];
  __shared__ uint4 Ws[BN * PITCH];
  __shared__ int8_t SXs[BM * SPITCH];
  __shared__ int8_t SWs[BN * SPITCH];

  const int tx = threadIdx.x % TX, ty = threadIdx.x / TX;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  int k_split = blockIdx.z;
  if constexpr (BATCHED) {  // blockIdx.z = batch element * splits + K split
    const int batch = blockIdx.z / splits;
    k_split = blockIdx.z % splits;
    X += (size_t)batch * M * K;
    SX += (size_t)batch * M * K;
    W += (size_t)batch * N * K;
    SW += (size_t)batch * N * K;
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
    load_tile<BM, THREADS>(Xs, SXs, X, SX, m0, M, k0, k_end, K);
    load_tile<BN, THREADS>(Ws, SWs, W, SW, n0, N, k0, k_end, K);
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

}  // namespace

// xs [B,M,K,4] uint32, sx [B,M,K] int8, ws [B,N,K,4] uint32, sw [B,N,K] int8,
// c [B,M,N] int32 (zeroed by the caller when splits > 1).  cfg 0: 8 x 128
// tiles (decode), cfg 1: 64 x 64 tiles.
extern "C" int stoch_matmul_launch(const void* xs, const void* sx, const void* ws,
                                   const void* sw, void* c, int B, int M, int N, int K,
                                   int kps, int splits, int cfg, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint4* X = static_cast<const uint4*>(xs);
  const uint4* W = static_cast<const uint4*>(ws);
  const int8_t* SX = static_cast<const int8_t*>(sx);
  const int8_t* SW = static_cast<const int8_t*>(sw);
  int32_t* C = static_cast<int32_t*>(c);
  const dim3 grid0((N + 127) / 128, (M + 7) / 8, B * splits);
  const dim3 grid1((N + 63) / 64, (M + 63) / 64, B * splits);
  if (cfg == 0 && B == 1)
    stoch_matmul_kernel<8, 128, 8, 1, false><<<grid0, 128, 0, s>>>(X, SX, W, SW, C, M, N, K,
                                                                   kps, splits);
  else if (cfg == 0)
    stoch_matmul_kernel<8, 128, 8, 1, true><<<grid0, 128, 0, s>>>(X, SX, W, SW, C, M, N, K,
                                                                  kps, splits);
  else if (B == 1)
    stoch_matmul_kernel<64, 64, 4, 4, false><<<grid1, 256, 0, s>>>(X, SX, W, SW, C, M, N, K,
                                                                   kps, splits);
  else
    stoch_matmul_kernel<64, 64, 4, 4, true><<<grid1, 256, 0, s>>>(X, SX, W, SW, C, M, N, K,
                                                                  kps, splits);
  return static_cast<int>(cudaGetLastError());
}
