// int8 x int8 -> int32 GEMM on Hopper's tensor cores (sm_90a).
//
// Replaces: src/repro/kernels/int8_matmul/kernel.py :: int8_matmul_kernel
// (the Pallas output-stationary 128x128x128 MXU GEMM behind ASTRA's int8
// "expectation" mode).  C[M,N] = X[M,K] . W[K,N], with the weight taken
// pre-transposed as Wt[N,K] so both operands are K-contiguous.
//
// What bounds it on an H100: at decode (M = 8 slots) the weight bytes do —
// N*K int8 read once per GEMM against 2*M*N*K operations, two orders of
// magnitude under the card's 295 int8 ops/byte ridge, so the floor is
// N*K / 3.35 TB/s.  At prefill (M in the thousands) the 1,979 int8 TOPS of
// the tensor cores bound it.
//
// Design: each 128-thread block owns a BM x BN output tile and walks K in
// 64-byte steps through shared memory; each warp issues
// mma.sync.m16n8k32.s8.s8.s32 on fragments read straight from the padded
// tiles (row pitch 80 bytes: the eight fragment rows land on distinct
// banks).  Ragged M/N/K edges are zero-filled in the tile loads and masked
// in the stores, so callers pass tensors as they are, without padding.
// Decode-sized problems (M <= 16) take a 16-row tile, and when the output
// tiles alone cannot fill the SMs, gridDim.z splits K: partial sums meet
// through atomicAdd on int32, which is exact in any order, so the result
// stays bit-identical to the plain version.  Not yet here: wgmma, TMA and
// a multi-stage pipeline (loads and math of one block do not overlap).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;
constexpr int BK = 64;        // K bytes per shared-memory step
constexpr int LDS = BK + 16;  // padded row pitch in bytes

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Rows [r0, r0+ROWS) x bytes [k0, k0+BK) of a row-major [rows, K] int8
// matrix into shared memory; rows >= rows_valid and bytes >= k_end read 0.
// ``vec``: K (and so every row start and k_end) is a multiple of 16, so a
// 16-byte chunk is either wholly inside or wholly outside [0, k_end).
template <int ROWS>
__device__ __forceinline__ void load_tile(int8_t* smem, const int8_t* __restrict__ g,
                                          int r0, int rows_valid, int k0, int k_end,
                                          int K, bool vec) {
  constexpr int CHUNKS = ROWS * (BK / 16);
  for (int c = threadIdx.x; c < CHUNKS; c += THREADS) {
    const int row = c / (BK / 16);
    const int col = (c % (BK / 16)) * 16;
    const int gr = r0 + row, gk = k0 + col;
    union { int4 v; int8_t b[16]; } u;
    u.v = make_int4(0, 0, 0, 0);
    if (gr < rows_valid) {
      const int8_t* src = g + (size_t)gr * K;
      if (vec) {
        if (gk < k_end) u.v = *reinterpret_cast<const int4*>(src + gk);
      } else {
#pragma unroll
        for (int i = 0; i < 16; ++i) u.b[i] = (gk + i < k_end) ? src[gk + i] : int8_t(0);
      }
    }
    *reinterpret_cast<int4*>(smem + row * LDS + col) = u.v;
  }
}

template <int BM, int BN, int WM, int WN>
__global__ void __launch_bounds__(THREADS)
int8_gemm_kernel(const int8_t* __restrict__ X, const int8_t* __restrict__ Wt,
                 int32_t* __restrict__ C, int M, int N, int K, int kps) {
  static_assert(WM * WN * 32 == THREADS, "four warps per block");
  constexpr int WTM = BM / WM, WTN = BN / WN;  // warp tile
  constexpr int TM = WTM / 16, TN = WTN / 8;   // mma tiles per warp
  static_assert(TM * 16 == WTM && TN * 8 == WTN, "warp tile must be whole mma tiles");
  __shared__ __align__(16) int8_t As[BM * LDS];
  __shared__ __align__(16) int8_t Bs[BN * LDS];

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;  // mma fragment group / thread-in-group
  const int wm = warp / WN, wn = warp % WN;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int k_begin = blockIdx.z * kps;
  const int k_end = min(K, k_begin + kps);
  const bool vec = (K % 16) == 0;

  int acc[TM][TN][4];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  for (int k0 = k_begin; k0 < k_end; k0 += BK) {
    load_tile<BM>(As, X, m0, M, k0, k_end, K, vec);
    load_tile<BN>(Bs, Wt, n0, N, k0, k_end, K, vec);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; kk += 32) {
      uint32_t a[TM][4], b[TN][2];
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        // A fragment (16x32, row-major): rows g and g+8, bytes 4t..4t+3 and +16
        const int8_t* p = As + (wm * WTM + i * 16 + g) * LDS + kk + t * 4;
        a[i][0] = *reinterpret_cast<const uint32_t*>(p);
        a[i][1] = *reinterpret_cast<const uint32_t*>(p + 8 * LDS);
        a[i][2] = *reinterpret_cast<const uint32_t*>(p + 16);
        a[i][3] = *reinterpret_cast<const uint32_t*>(p + 8 * LDS + 16);
      }
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        // B fragment (32x8, column-major = Wt rows): column g, k 4t..4t+3 and +16
        const int8_t* p = Bs + (wn * WTN + j * 8 + g) * LDS + kk + t * 4;
        b[j][0] = *reinterpret_cast<const uint32_t*>(p);
        b[j][1] = *reinterpret_cast<const uint32_t*>(p + 16);
      }
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) mma_s8(acc[i][j], a[i], b[j]);
    }
    __syncthreads();
  }

  const bool split = gridDim.z > 1;
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        // C fragment: e=0,1 -> row g, e=2,3 -> row g+8; columns 2t, 2t+1
        const int r = m0 + wm * WTM + i * 16 + g + (e >> 1) * 8;
        const int c = n0 + wn * WTN + j * 8 + t * 2 + (e & 1);
        if (r < M && c < N) {
          int32_t* dst = C + (size_t)r * N + c;
          if (split) atomicAdd(dst, acc[i][j][e]);
          else *dst = acc[i][j][e];
        }
      }
}

}  // namespace

// x [M,K] int8, wt [N,K] int8, c [M,N] int32 (zeroed by the caller when
// splits > 1).  cfg 0: 16x64 tiles (decode), cfg 1: 64x128 tiles.
extern "C" int int8_gemm_launch(const void* x, const void* wt, void* c, int M, int N,
                                int K, int kps, int splits, int cfg, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int8_t* X = static_cast<const int8_t*>(x);
  const int8_t* W = static_cast<const int8_t*>(wt);
  int32_t* C = static_cast<int32_t*>(c);
  if (cfg == 0) {
    dim3 grid((N + 63) / 64, (M + 15) / 16, splits);
    int8_gemm_kernel<16, 64, 1, 4><<<grid, THREADS, 0, s>>>(X, W, C, M, N, K, kps);
  } else {
    dim3 grid((N + 127) / 128, (M + 63) / 64, splits);
    int8_gemm_kernel<64, 128, 2, 2><<<grid, THREADS, 0, s>>>(X, W, C, M, N, K, kps);
  }
  return static_cast<int>(cudaGetLastError());
}
