// int8 x int8 -> int32 GEMMs on Hopper (sm_90a): wgmma on TMA-fed tiles
// for admissions, a weight-streaming kernel for decode, a batch of small
// products streamed one product a block, and a batch of larger products a
// tile a block.
//
// Replaces: src/repro/kernels/int8_matmul/kernel.py :: int8_matmul_kernel
// (the Pallas output-stationary 128x128x128 MXU GEMM behind ASTRA's int8
// "expectation" mode and, vmapped, its quantized qk/pv products) for the
// single-product entry when K % 16 == 0, the row pitch TMA and 16-byte
// copies need, and for the batched entry when K % 16 == 0 (K up to
// 4096).  C[M,N] = X[M,K] . Wt[N,K]^T, the weight pre-transposed so both
// operands are K-contiguous.  Every other shape keeps int8_matmul.cu's
// mma.sync kernel; ops.py's int8_gemm_plan and int8_batched_plan pick the
// kernel from the shapes alone.
//
// What bounds it on an H100: at admission (M in the thousands) the 1,979
// int8 TOPS of the tensor cores, reachable only through wgmma; at decode
// (M <= 16 slots) the weight bytes, N*K read once against 2*M*N*K
// operations, far below the card's ~590 int8 ops/byte ridge, so the floor
// is N*K / 3.35 TB/s.  The batched decode products (one query row of each
// slot and KV head against its 32 KB of K or V codes under the mixed plan)
// are bound by those bytes too: 8 MB a launch, 2.5 us at HBM's rate.  So
// are the batched admission products (160 query rows of each slot and KV
// head against 176 positions): qk moves 17.2 MB a launch, 14.4 MB of it
// the int32 output, pv 10.3 MB, 5.1 and 3.1 us, against 0.2 us of int8
// operations.
//
// Design: four kernels behind the two entries.
//
// Admission (int8_gemm_wgmma_kernel, M > 16):
// * One block per 128 x 128 output tile, walking its K range in 128-byte
//   steps.  X [M, K] and Wt [N, K] are both K-major, the only layout wgmma
//   takes for 8-bit operands, so nothing is transposed: a 128-byte K slab
//   of 128 rows is one TMA box in the 128-byte swizzle and one wgmma
//   operand (common/hopper.cuh's smem_desc, as flash attention's bf16
//   tiles).  TMA's zero fill covers the ragged M, N and K edges: the host
//   pads nothing.
// * A ring of 3 stages (32 KB each: the X and Wt slabs) with a full and an
//   empty mbarrier per stage.  One producer warp, one lane of it, keeps
//   the ring's loads in flight; two consumer warpgroups each run
//   wgmma.mma_async m64n128k32 .s32.s8.s8 on their 64 rows against the
//   shared Wt slab, keeping one k-step of products in flight while the
//   next stage's wait is taken.  97 KB of shared memory a block, so two
//   blocks share an SM and one's epilogue overlaps the other's main loop.
// * blockIdx.x walks M, the fastest grid dimension, so the blocks of one
//   Wt slab run together and each weight byte leaves HBM about once even
//   for the lm_head's 100352 x 2048 weight; X (a few MB) stays in L2.
// * The epilogue stores int32 pairs with a mask.  K is split (gridDim.z)
//   only when the output tiles are fewer than the SMs and the K steps a
//   block is spared outweigh the split's cost (ops.int8_gemm_plan: short
//   admissions with long K or narrow N), the partials meeting by int32
//   atomicAdd into a zeroed output: exact in any order.  Split ranges are
//   whole 128-byte steps, so no box reaches into the next split's K.
//
// Decode (int8_gemm_stream_kernel, M <= 16):
// * The operands are swapped: C^T = Wt . X^T, so the weight rows are the
//   16-row A operand of mma.sync m16n8k32 and the <= 16 activation rows the
//   n8 B operand (one or two n8 tiles).  No lane multiplies padding rows.
// * One block per 16 weight rows (N / 16 blocks: 128 for a 2048-wide
//   output; 72 KB or 96 KB of shared memory, so 3 or 2 resident an SM).  Its four warps split K, each
//   streaming its share through its own ring of 6 cp.async stages of 128 K
//   bytes of the 16 rows and of the X rows: 48 KB of weight in flight per
//   block, all of a 2048 x 16 tile at once.  The four partial sums meet in
//   shared memory in a fixed order, so one launch is the whole GEMM: no
//   split over blocks, no zeroed output, no second pass.
// * A warp's copy instruction takes whole 128-byte lines (4 rows x 128
//   bytes): read as 64-byte pieces, an earlier design of this kernel
//   streamed the lm_head's weight at about half of HBM's rate.  Chunk c of
//   row r lands at chunk c ^ (r % 8), so the fragment reads, lane (g, t)
//   taking bytes [32t, 32t + 32) of rows g and g + 8 and of X row g, hit
//   distinct banks.  K is permuted inside a step identically for both
//   operands (integer sums are exact in any order), so those 32 bytes are
//   the A and B fragments of four k32 products.  Integer sums: the bits
//   are the plain version's.
//
// Batched decode (int8_gemm_batched_stream_kernel, M <= 16, one product a
// block): the mma.sync kernel of int8_matmul.cu padded each product's one
// query row to a 16-row tile, walked K in serial 64-byte load -> barrier ->
// mma steps, and split K across blocks with a zeroed output and atomics
// when the tiles were few: 14.4 us a launch against a 2.6 us byte bound.
// * The grid runs over the products.  A block takes a whole product: no K
//   split, no zeroed output, no atomics.
// * The block issues cp.async copies of all of its product's weight rows
//   (32 KB at the decode shapes; larger products in chunks of about 48 KB,
//   two in flight) and of its X rows at once, waits once, and computes from
//   shared memory: every byte of the product is in flight together, and 2
//   blocks an SM (256 products on 132 SMs) keep all 8 MB of a launch in
//   flight.
// * The products run on the decode kernel's swapped-operand mma.sync
//   m16n8k32 (weight rows as the 16-row A operand, the <= 16 X rows as one
//   or two n8 B tiles), not __dp4a: one code path for M = 1..16, and at
//   M = 1 the time is the bytes, not the 64 mma of a qk product.  Lane
//   (g, t) takes 16-byte chunk t of each 64-byte K step of weight rows g
//   and g + 8 and of X row g, the A and B fragments of two k32 products
//   (K permuted identically for both operands; integer sums are exact in
//   any order).  Rows are padded to 16 x (4 mod 8) bytes so the eight
//   lanes of each quarter-warp read distinct banks; chunks past K read as
//   zeros, rows past M or N are computed and not stored.
//
// Batched admission (int8_gemm_batched_tiles_kernel, M > 16): int8_matmul.cu's
// mma.sync kernel ran these on 64 x 128 tiles (57% and 42% of their work
// useful at qk's 160 x 176 and pv's 160 x 64), loaded and synced for each
// 64-byte K step with nothing in flight during the math, and wrote 8 bytes
// a thread from its fragments: 0.0187 ms a launch, 22% of the byte bound.
// * A block a tile of 32 rows (two m16 tiles) by the product's whole N,
//   or by N cut into the fewest tiles of at most 256 columns, each a
//   multiple of 8: no mma on padded n8 tiles (N 176 is 22 of them).  At the
//   serving shapes 640 blocks a launch, 4-5 an SM, all resident at once.
// * The block issues cp.async copies of its X rows and all of its Wt rows,
//   the whole K (stages of the most pieces that fit 64 KB when K is long),
//   waits once, and computes from shared memory: every byte of the tile in
//   flight together, and other blocks' loads cover one block's math.
// * The four warps split the n8 tiles (warp w takes w, w + 4, ...); the
//   fragments are the batched decode kernel's (lane (g, t) reads 16-byte
//   piece t of each 64-byte K step, two k32 products; K permuted alike in
//   both operands), A from X rows g and g + 8 of each m16 tile.
// * The epilogue stages the int32 tile in shared memory over the operand
//   rows (pitch 8 mod 32 int32: the int2 fragment stores of a half-warp
//   hit distinct banks) and writes whole output rows, 704 or 256
//   contiguous bytes at the serving shapes, in 16-byte stores (4-byte ones
//   when N % 4 != 0).  No K split, no zeroed output, no atomics: the bits
//   are the plain version's.
#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "../../common/hopper.cuh"

namespace {

using namespace hopper;

// ------------------------------------------------------------ admission
constexpr int WG_BM = 128, WG_BN = 128;  // output tile
constexpr int WG_BK = 128;               // K bytes per stage: one swizzle atom
constexpr int WG_STAGES = 3;
constexpr int WG_CONSUMERS = 256;              // two warpgroups, 64 rows each
constexpr int WG_THREADS = WG_CONSUMERS + 32;  // and one producer warp
constexpr uint32_t WG_A_BYTES = WG_BM * WG_BK, WG_B_BYTES = WG_BN * WG_BK;
constexpr uint32_t WG_STAGE_BYTES = WG_A_BYTES + WG_B_BYTES;
constexpr uint32_t WG_BAR = WG_STAGES * WG_STAGE_BYTES;
constexpr size_t WG_SMEM = 1024 + WG_BAR + 2 * WG_STAGES * 8;  // + base alignment
static_assert(2 * (WG_SMEM + 1024) <= 233472, "two blocks must share an SM");

// d[64 x 128] += A[64 x 32] B[32 x 128], A and B K-major int8 in shared
// memory, int32 accumulators
__device__ __forceinline__ void wgmma_s8(int (&d)[64], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, "
      "%35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, "
      "%52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]),
        "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]),
        "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]),
        "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]),
        "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]),
        "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]), "+r"(d[42]),
        "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]),
        "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]),
        "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]),
        "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(a), "l"(b), "r"(1));
}

__global__ void __launch_bounds__(WG_THREADS, 2)
int8_gemm_wgmma_kernel(const __grid_constant__ CUtensorMap map_x,  // X [M, K]
                       const __grid_constant__ CUtensorMap map_w,  // Wt [N, K]
                       int32_t* __restrict__ C, int M, int N, int K, int kps) {
  extern __shared__ __align__(1024) unsigned char wg_smem[];
  const uint32_t base = (smem_u32(wg_smem) + 1023u) & ~1023u;
  const uint32_t bars = base + WG_BAR;
  auto full = [&](int st) { return bars + 8 * st; };
  auto empty = [&](int st) { return bars + 8 * (WG_STAGES + st); };

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int m0 = blockIdx.x * WG_BM, n0 = blockIdx.y * WG_BN;
  const int k_begin = blockIdx.z * kps;
  const int n_k = (min(K, k_begin + kps) - k_begin + WG_BK - 1) / WG_BK;

  if (tid == 0) {
    for (int st = 0; st < WG_STAGES; ++st) {
      mbar_init(full(st), 1);
      mbar_init(empty(st), WG_CONSUMERS / 32);  // one arrival per consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp == WG_CONSUMERS / 32) {  // producer: one lane keeps the ring's loads in flight
    if (lane == 0) {
      for (int t = 0; t < n_k; ++t) {
        const int st = t % WG_STAGES;
        if (t >= WG_STAGES) mbar_wait(empty(st), ((t / WG_STAGES) - 1) & 1);
        mbar_expect_tx(full(st), WG_STAGE_BYTES);  // edge boxes still count whole
        const uint32_t a_s = base + st * WG_STAGE_BYTES;
        const int k = k_begin + t * WG_BK;
        tma_load_2d(a_s, &map_x, k, m0, full(st));
        tma_load_2d(a_s + WG_A_BYTES, &map_w, k, n0, full(st));
      }
    }
    return;
  }

  const int wg = warp / 4;  // rows m0 + 64 wg .. + 63
  int acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0;
  for (int t = 0; t < n_k; ++t) {
    const int st = t % WG_STAGES;
    const uint32_t a_s = base + st * WG_STAGE_BYTES + wg * (64 * WG_BK);
    const uint32_t b_s = base + st * WG_STAGE_BYTES + WG_A_BYTES;
    mbar_wait(full(st), (t / WG_STAGES) & 1);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < WG_BK / 32; ++kk)
      wgmma_s8(acc, smem_desc(a_s + kk * 32), smem_desc(b_s + kk * 32));
    wgmma_commit();
    wgmma_wait<1>();  // the previous step's products are done: free its stage
    if (t > 0 && lane == 0) mbar_arrive(empty((t - 1) % WG_STAGES));
  }
  wgmma_wait<0>();
  fence_regs(acc);

  // acc[4j + e]: row 16 (warp % 4) + gid + 8 (e / 2), column 8j + 2 tig + (e % 2)
  const int gid = lane / 4, tig = lane % 4;
  const bool split = gridDim.z > 1, pairs = (N % 2) == 0;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = m0 + wg * 64 + (warp % 4) * 16 + gid + 8 * h;
    if (r >= M) continue;
    int32_t* crow = C + (size_t)r * N;
#pragma unroll
    for (int j = 0; j < WG_BN / 8; ++j) {
      const int c = n0 + j * 8 + tig * 2;
      const int v0 = acc[4 * j + 2 * h], v1 = acc[4 * j + 2 * h + 1];
      if (split) {
        if (c < N) atomicAdd(crow + c, v0);
        if (c + 1 < N) atomicAdd(crow + c + 1, v1);
      } else if (pairs && c + 1 < N) {
        *reinterpret_cast<int2*>(crow + c) = make_int2(v0, v1);
      } else {
        if (c < N) crow[c] = v0;
        if (c + 1 < N) crow[c + 1] = v1;
      }
    }
  }
}

// --------------------------------------------------------------- decode
constexpr int ST_WARPS = 4;  // the block's K range split four ways
constexpr int ST_THREADS = 32 * ST_WARPS;
constexpr int ST_BN = 16;    // weight rows (output columns) per block: one m16 tile
constexpr int ST_BK = 128;   // K bytes per step: one 128-byte line a row
constexpr int ST_STAGES = 6;  // ring depth of each warp
constexpr int ST_W_BYTES = ST_BN * ST_BK;  // a stage's weight tile: 2 KB
// a stage: the weight tile and the 8 * MT X rows; the ring of every warp
template <int MT>
__host__ __device__ constexpr int st_stage_bytes() { return ST_W_BYTES + 8 * MT * ST_BK; }
template <int MT>
__host__ __device__ constexpr int st_smem_bytes() {
  return ST_WARPS * ST_STAGES * st_stage_bytes<MT>();
}

__device__ __forceinline__ void mma_s8(int (&c)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                       uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// word i (0..3) of a 16-byte vector
__device__ __forceinline__ uint32_t word(const uint4& v, int i) {
  return i == 0 ? v.x : (i == 1 ? v.y : (i == 2 ? v.z : v.w));
}

// MT n8 tiles of X rows: 1 for M <= 8, 2 for M <= 16
template <int MT>
__global__ void __launch_bounds__(ST_THREADS)
int8_gemm_stream_kernel(const int8_t* __restrict__ X, const int8_t* __restrict__ Wt,
                        int32_t* __restrict__ C, int M, int N, int K) {
  constexpr int STAGE = st_stage_bytes<MT>();
  extern __shared__ __align__(128) unsigned char st_smem[];
  __shared__ int red[ST_WARPS - 1][32][4 * MT];  // warps 1.. hand their sums to warp 0

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int n0 = blockIdx.x * ST_BN;
  // this warp's share of K, in whole steps
  const int kpw = (K + ST_WARPS * ST_BK - 1) / (ST_WARPS * ST_BK) * ST_BK;
  const int kw0 = warp * kpw, kw1 = min(K, kw0 + kpw);
  const int n_steps = kw1 > kw0 ? (kw1 - kw0 + ST_BK - 1) / ST_BK : 0;
  unsigned char* ring = st_smem + warp * ST_STAGES * STAGE;
  const uint32_t ring_s = smem_u32(ring);

  // A warp copies 4 rows x 128 bytes per instruction (lane: row lane / 8,
  // chunk lane % 8), whole lines of each row; chunk c of row r lands at
  // chunk c ^ (r % 8), so the fragment reads below hit distinct banks.
  const int crow = lane / 8, cchunk = lane % 8;
  auto issue = [&](int s) {  // past N, M or the warp's K: zeros, nothing read
    const uint32_t st = ring_s + (s % ST_STAGES) * STAGE;
    const int k = kw0 + s * ST_BK + cchunk * 16;
    const bool kin = k < kw1;
#pragma unroll
    for (int i = 0; i < ST_BN / 4; ++i) {
      const int r = 4 * i + crow, n = n0 + r;
      const bool ok = kin && n < N;
      cp_async16(st + r * ST_BK + ((cchunk ^ (r & 7)) << 4), ok ? Wt + (size_t)n * K + k : Wt,
                 ok);
    }
#pragma unroll
    for (int i = 0; i < 2 * MT; ++i) {
      const int r = 4 * i + crow;
      const bool ok = kin && r < M;
      cp_async16(st + ST_W_BYTES + r * ST_BK + ((cchunk ^ (r & 7)) << 4),
                 ok ? X + (size_t)r * K + k : X, ok);
    }
  };
#pragma unroll
  for (int s = 0; s < ST_STAGES; ++s) {
    if (s < n_steps) issue(s);
    cp_async_commit();  // empty groups keep the count uniform
  }

  // acc[i]: the C^T tile of weight rows n0 .. n0 + 15 and X rows 8i .. 8i + 7
  int acc[MT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0;
  for (int s = 0; s < n_steps; ++s) {
    cp_async_wait<ST_STAGES - 1>();  // this lane's copies of step s have landed
    __syncwarp();                    // and every lane's are visible
    const unsigned char* st = ring + (s % ST_STAGES) * STAGE;
    // lane (g, t) takes chunks 2t and 2t + 1 (bytes 32t .. 32t + 31) of
    // weight rows g and g + 8 and of X rows 8i + g: K permuted the same way
    // for both operands, which integer sums allow
    uint4 w[2][2], x[MT][2];
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int off = ((2 * t + c) ^ g) << 4;
#pragma unroll
      for (int r = 0; r < 2; ++r)
        w[r][c] = *reinterpret_cast<const uint4*>(st + (g + 8 * r) * ST_BK + off);
#pragma unroll
      for (int i = 0; i < MT; ++i)
        x[i][c] = *reinterpret_cast<const uint4*>(st + ST_W_BYTES + (8 * i + g) * ST_BK + off);
    }
    __syncwarp();  // the stage has been read: refill it
    if (s + ST_STAGES < n_steps) issue(s + ST_STAGES);
    cp_async_commit();
    // four k32 products a step: product j takes bytes 8j .. 8j + 7 of the
    // lane's 32 (a0/a1 and b0 the first four, a2/a3 and b1 the next four)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = j / 2, e = 2 * (j % 2);
#pragma unroll
      for (int i = 0; i < MT; ++i)
        mma_s8(acc[i], word(w[0][c], e), word(w[1][c], e), word(w[0][c], e + 1),
               word(w[1][c], e + 1), word(x[i][c], e), word(x[i][c], e + 1));
    }
  }

  // warps 1.. hand their partial sums to warp 0, which adds them in order
  if (warp > 0) {
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) red[warp - 1][lane][4 * i + e] = acc[i][e];
  }
  __syncthreads();
  if (warp != 0) return;
  // acc[i][e]: weight row n0 + g + 8 (e / 2), X row 8i + 2t + (e % 2)
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      int v = acc[i][e];
#pragma unroll
      for (int w2 = 0; w2 < ST_WARPS - 1; ++w2) v += red[w2][lane][4 * i + e];
      const int m = 8 * i + 2 * t + (e & 1), n = n0 + g + 8 * (e >> 1);
      if (m < M && n < N) C[(size_t)m * N + n] = v;
    }
}

// ------------------------------------------------------ batched decode
constexpr int BT_WARPS = 4;
constexpr int BT_THREADS = 32 * BT_WARPS;
constexpr int BT_MAX_K = 4096;         // longest K the route takes (ops.int8_batched_plan)
constexpr int BT_W_BUDGET = 48 << 10;  // weight bytes of one chunk of rows
constexpr int BT_SMEM_MAX = 232448;    // an H100 block's shared memory

// Shared-memory geometry of one product: row pitch (16-byte chunks, 4 mod
// 8), weight rows per chunk (a multiple of 16), chunks and bytes.
struct BatchedGeometry {
  int pitch, rows, chunks, smem;
};
inline BatchedGeometry bt_geometry(int M, int N, int K) {
  const int kc = K / 16;
  const int pitch = 16 * (kc + ((4 - kc) & 7));
  const int n16 = (N + 15) / 16 * 16;
  const int fit = BT_W_BUDGET / pitch / 16 * 16;
  const int want = fit > 16 ? fit : 16;
  const int rows = n16 < want ? n16 : want;
  const int chunks = (N + rows - 1) / rows;
  const int x_rows = M <= 8 ? 8 : 16;
  return {pitch, rows, chunks, (x_rows + (chunks > 1 ? 2 : 1) * rows) * pitch};
}

// MT n8 tiles of X rows: 1 for M <= 8, 2 for M <= 16
template <int MT>
__global__ void __launch_bounds__(BT_THREADS)
int8_gemm_batched_stream_kernel(const int8_t* __restrict__ X, const int8_t* __restrict__ Wt,
                                int32_t* __restrict__ C, int M, int N, int K, int pitch,
                                int rows_per_chunk) {
  extern __shared__ __align__(128) unsigned char bt_smem[];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const size_t prod = blockIdx.x;
  X += prod * M * K;
  Wt += prod * N * K;
  C += prod * M * N;
  const int kc = K / 16;  // 16-byte chunks a row
  const int n_chunks = (N + rows_per_chunk - 1) / rows_per_chunk;
  const int stage = rows_per_chunk * pitch;
  const unsigned char* xs = bt_smem;                // 8 MT rows x pitch
  const unsigned char* ws = bt_smem + 8 * MT * pitch;  // 1 or 2 chunks of weight rows
  const uint32_t xs_s = smem_u32(xs), ws_s = smem_u32(ws);

  // the M real X rows (columns of C^T past M are computed, never stored)
  for (int c = tid; c < M * kc; c += BT_THREADS)
    cp_async16(xs_s + (c / kc) * pitch + 16 * (c % kc), X + 16 * (size_t)c, true);
  auto issue = [&](int ch) {  // chunk ch of weight rows into stage ch % 2
    const int r0 = ch * rows_per_chunk, n_c = min(rows_per_chunk, N - r0) * kc;
    const int8_t* src = Wt + (size_t)r0 * K;
    const uint32_t dst = ws_s + (ch % 2) * stage;
    for (int c = tid; c < n_c; c += BT_THREADS)
      cp_async16(dst + (c / kc) * pitch + 16 * (c % kc), src + 16 * (size_t)c, true);
  };
  issue(0);
  cp_async_commit();  // X and chunk 0
  if (n_chunks > 1) issue(1);
  cp_async_commit();  // chunk 1, or an empty group

  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  for (int ch = 0; ch < n_chunks; ++ch) {
    cp_async_wait<1>();  // this thread's copies of chunk ch have landed
    __syncthreads();     // and every thread's
    const unsigned char* st = ws + (ch % 2) * stage;
    const int r0 = ch * rows_per_chunk, rows = min(rows_per_chunk, N - r0);
    for (int tile = warp; tile * 16 < rows; tile += BT_WARPS) {
      const unsigned char* wa = st + (tile * 16 + g) * pitch;  // weight rows g and g + 8
      int acc[MT][4];
#pragma unroll
      for (int i = 0; i < MT; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0;
      for (int k0 = 0; k0 < kc; k0 += 4) {  // 64-byte K steps: chunk k0 + t a lane
        const int q = k0 + t;
        const bool ok = q < kc;
        const uint4 w0 = ok ? *reinterpret_cast<const uint4*>(wa + 16 * q) : zero;
        const uint4 w1 = ok ? *reinterpret_cast<const uint4*>(wa + 8 * pitch + 16 * q) : zero;
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          const uint4 x =
              ok ? *reinterpret_cast<const uint4*>(xs + (8 * i + g) * pitch + 16 * q) : zero;
          mma_s8(acc[i], w0.x, w1.x, w0.y, w1.y, x.x, x.y);
          mma_s8(acc[i], w0.z, w1.z, w0.w, w1.w, x.z, x.w);
        }
      }
      // acc[i][e]: weight row r0 + 16 tile + g + 8 (e / 2), X row 8i + 2t + (e % 2)
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int m = 8 * i + 2 * t + (e & 1), n = r0 + 16 * tile + g + 8 * (e >> 1);
          if (m < M && n < N) C[(size_t)m * N + n] = acc[i][e];
        }
    }
    __syncthreads();  // the stage has been read: refill it
    if (ch + 2 < n_chunks) issue(ch + 2);
    cp_async_commit();
  }
}

// ------------------------------------------------------ batched admission
constexpr int BA_WARPS = 4;
constexpr int BA_THREADS = 32 * BA_WARPS;
constexpr int BA_BM = 32;                  // X rows of a tile: two m16 tiles
constexpr int BA_MAX_BN = 256;             // output columns of a tile: 32 n8 tiles, 8 a warp
constexpr int BA_MAX_K = 4096;             // longest K the route takes (ops.int8_batched_plan)
constexpr int BA_STAGE_BUDGET = 64 << 10;  // bytes of the X and Wt rows of one K stage
constexpr int BA_SMEM_MAX = 64 << 10;      // the most any geometry asks for

// A tile's geometry: its columns (a multiple of 8) and the tiles across N;
// 16-byte pieces of K a stage (all of K when the tile's X and Wt rows fit
// the budget, else the most that are 4 mod 8, whole 64-byte steps) and the
// row pitch in pieces (4 mod 8: the 8 lanes of a quarter-warp read distinct
// banks); the staged output's row pitch in int32 (8 mod 32: the int2
// fragment stores of a half-warp hit distinct banks); shared memory bytes,
// the output staged over the operand rows.
struct AdmissionGeometry {
  int bn, tiles_n, kc, pitch, out_pitch, smem;
};
inline AdmissionGeometry ba_geometry(int M, int N, int K) {
  const int tiles_n = (N + BA_MAX_BN - 1) / BA_MAX_BN;
  const int bn = ((N + tiles_n - 1) / tiles_n + 7) / 8 * 8;
  const int rows = BA_BM + bn;
  int kc = K / 16;
  int pitch = kc + ((4 - kc) & 7);
  if (rows * 16 * pitch > BA_STAGE_BUDGET) {
    kc = (BA_STAGE_BUDGET / (rows * 16) - 4) / 8 * 8 + 4;
    pitch = kc;
  }
  const int out_pitch = bn + (40 - bn % 32) % 32;
  const int operands = rows * 16 * pitch, staged = BA_BM * out_pitch * 4;
  return {bn, tiles_n, kc, pitch, out_pitch, operands > staged ? operands : staged};
}

// NTW: n8 tiles a warp, at most (the tile's bn / 8 over 4 warps, rounded up)
template <int NTW>
__global__ void __launch_bounds__(BA_THREADS)
int8_gemm_batched_tiles_kernel(const int8_t* __restrict__ X, const int8_t* __restrict__ Wt,
                               int32_t* __restrict__ C, int M, int N, int K, int tiles_m,
                               AdmissionGeometry geo) {
  extern __shared__ __align__(128) unsigned char ba_smem[];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int tn = blockIdx.x % geo.tiles_n, tm = (blockIdx.x / geo.tiles_n) % tiles_m;
  const size_t prod = blockIdx.x / geo.tiles_n / tiles_m;
  const int m0 = tm * BA_BM, n0 = tn * geo.bn;
  const int rows_m = min(BA_BM, M - m0), rows_n = min(geo.bn, N - n0);
  X += (prod * M + m0) * K;
  Wt += (prod * N + n0) * K;
  C += (prod * M + m0) * N + n0;
  const int nt = geo.bn / 8, kc_all = K / 16, pitch = 16 * geo.pitch;
  const unsigned char* xs = ba_smem;                 // BA_BM rows of X
  const unsigned char* ws = ba_smem + BA_BM * pitch;  // bn rows of Wt
  const uint32_t xs_s = smem_u32(xs);

  int acc[2][NTW][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < NTW; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0;

  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  for (int k0 = 0; k0 < kc_all; k0 += geo.kc) {
    // every copy of the stage in flight before the first mma: X rows then
    // Wt rows, rows past M or N zero-filled
    const int kn = min(geo.kc, kc_all - k0);
    for (int c = tid; c < (BA_BM + geo.bn) * kn; c += BA_THREADS) {
      const int r = c / kn, q = c % kn;
      const bool is_x = r < BA_BM;
      const int rr = is_x ? r : r - BA_BM;
      const bool ok = rr < (is_x ? rows_m : rows_n);
      const int8_t* src = (is_x ? X : Wt) + (ok ? (size_t)rr * K + 16 * (k0 + q) : 0);
      cp_async16(xs_s + r * pitch + 16 * q, src, ok);
    }
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    for (int q0 = 0; q0 < kn; q0 += 4) {  // 64-byte K steps: piece q0 + t a lane
      const int q = q0 + t;
      const bool ok = q < kn;
      uint4 a[2][2];  // [m16 tile][row g, g + 8]
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          a[i][h] = ok ? *reinterpret_cast<const uint4*>(xs + (16 * i + 8 * h + g) * pitch + 16 * q)
                       : zero;
#pragma unroll
      for (int jj = 0; jj < NTW; ++jj) {
        const int j = warp + BA_WARPS * jj;
        if (j < nt) {
          const uint4 b = ok ? *reinterpret_cast<const uint4*>(ws + (8 * j + g) * pitch + 16 * q)
                             : zero;
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            mma_s8(acc[i][jj], a[i][0].x, a[i][1].x, a[i][0].y, a[i][1].y, b.x, b.y);
            mma_s8(acc[i][jj], a[i][0].z, a[i][1].z, a[i][0].w, a[i][1].w, b.z, b.w);
          }
        }
      }
    }
    __syncthreads();  // the stage has been read: refill it, or stage the output over it
  }

  // acc[i][jj][e]: row 16 i + g + 8 (e / 2), column 8 (warp + 4 jj) + 2 t + e % 2
  int32_t* out = reinterpret_cast<int32_t*>(ba_smem);
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int jj = 0; jj < NTW; ++jj) {
      const int j = warp + BA_WARPS * jj;
      if (j < nt)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          *reinterpret_cast<int2*>(out + (16 * i + g + 8 * h) * geo.out_pitch + 8 * j + 2 * t) =
              make_int2(acc[i][jj][2 * h], acc[i][jj][2 * h + 1]);
    }
  __syncthreads();
  // whole output rows, 16 bytes a store when N % 4 == 0 (then rows_n, n0
  // and every row start are multiples of 4 int32)
  if ((N & 3) == 0) {
    const int per_row = rows_n / 4;
    for (int c = tid; c < rows_m * per_row; c += BA_THREADS) {
      const int r = c / per_row, p = c % per_row;
      *reinterpret_cast<int4*>(C + (size_t)r * N + 4 * p) =
          *reinterpret_cast<const int4*>(out + r * geo.out_pitch + 4 * p);
    }
  } else {
    for (int c = tid; c < rows_m * rows_n; c += BA_THREADS) {
      const int r = c / rows_n, col = c % rows_n;
      C[(size_t)r * N + col] = out[r * geo.out_pitch + col];
    }
  }
}

// Lets `kern` take up to `bytes` of dynamic shared memory on the current
// device, asking the runtime once per device.
template <int ID>
int allow_smem(const void* kern, int bytes) {
  static bool asked[64] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev < 64 && asked[dev]) return 0;
  e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e == cudaSuccess && dev < 64) asked[dev] = true;
  return static_cast<int>(e);
}

// TMA map of a contiguous int8 [rows, K] matrix, read in boxes of 128 K
// bytes x 128 rows.  Returns 0 or 10000 + the CUresult.
int encode_int8_map(CUtensorMap* map, const void* ptr, int K, int rows) {
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(K), static_cast<cuuint64_t>(rows)};
  const cuuint32_t box[2] = {WG_BK, WG_BM};
  return encode_swizzled_map(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, 2, ptr, dims, box);
}

}  // namespace

// x [M,K] int8, wt [N,K] int8, c [M,N] int32 (zeroed by the caller when
// splits > 1), K % 16 == 0, 16-byte aligned starts; K split into `splits`
// ranges of kps bytes (a multiple of 128).  Returns a cudaError_t, or
// 10000 + the CUresult of a failed TMA map encoding.
extern "C" int int8_gemm_wgmma_launch(const void* x, const void* wt, void* c, int M, int N,
                                      int K, int kps, int splits, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || K % 16 != 0 || kps <= 0 || kps % WG_BK != 0 ||
      splits < 1 || (long long)kps * (splits - 1) >= K || (N + WG_BN - 1) / WG_BN > 65535 ||
      splits > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap mx, mw;
  int e = encode_int8_map(&mx, x, K, M);
  if (e == 0) e = encode_int8_map(&mw, wt, K, N);
  if (e != 0) return e;
  e = allow_smem<0>(reinterpret_cast<const void*>(int8_gemm_wgmma_kernel),
                    static_cast<int>(WG_SMEM));
  if (e != 0) return e;
  const dim3 grid((M + WG_BM - 1) / WG_BM, (N + WG_BN - 1) / WG_BN, splits);
  int8_gemm_wgmma_kernel<<<grid, WG_THREADS, WG_SMEM, static_cast<cudaStream_t>(stream)>>>(
      mx, mw, static_cast<int32_t*>(c), M, N, K, kps);
  return static_cast<int>(cudaGetLastError());
}

// x [M,K] int8 with M <= 16, wt [N,K] int8, c [M,N] int32, K % 16 == 0,
// 16-byte aligned starts.  Returns a cudaError_t.
extern "C" int int8_gemm_stream_launch(const void* x, const void* wt, void* c, int M, int N,
                                       int K, void* stream) {
  if (M <= 0 || M > 16 || N <= 0 || K <= 0 || K % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int8_t* X = static_cast<const int8_t*>(x);
  const int8_t* W = static_cast<const int8_t*>(wt);
  int32_t* C = static_cast<int32_t*>(c);
  const dim3 grid((N + ST_BN - 1) / ST_BN);
  if (M <= 8) {
    auto* kern = int8_gemm_stream_kernel<1>;
    const int e = allow_smem<1>(reinterpret_cast<const void*>(kern), st_smem_bytes<1>());
    if (e != 0) return e;
    kern<<<grid, ST_THREADS, st_smem_bytes<1>(), s>>>(X, W, C, M, N, K);
  } else {
    auto* kern = int8_gemm_stream_kernel<2>;
    const int e = allow_smem<2>(reinterpret_cast<const void*>(kern), st_smem_bytes<2>());
    if (e != 0) return e;
    kern<<<grid, ST_THREADS, st_smem_bytes<2>(), s>>>(X, W, C, M, N, K);
  }
  return static_cast<int>(cudaGetLastError());
}

// x [B,M,K] int8 with M <= 16, wt [B,N,K] int8, c [B,M,N] int32, K % 16 ==
// 0 and K <= 4096, 16-byte aligned starts: B products, one a block.
// Returns a cudaError_t.
extern "C" int int8_gemm_batched_stream_launch(const void* x, const void* wt, void* c, int B,
                                               int M, int N, int K, void* stream) {
  if (B <= 0 || M <= 0 || M > 16 || N <= 0 || K <= 0 || K % 16 != 0 || K > BT_MAX_K)
    return static_cast<int>(cudaErrorInvalidValue);
  const BatchedGeometry geo = bt_geometry(M, N, K);
  if (geo.smem > BT_SMEM_MAX) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int8_t* X = static_cast<const int8_t*>(x);
  const int8_t* W = static_cast<const int8_t*>(wt);
  int32_t* C = static_cast<int32_t*>(c);
  if (M <= 8) {
    auto* kern = int8_gemm_batched_stream_kernel<1>;
    const int e = allow_smem<3>(reinterpret_cast<const void*>(kern), BT_SMEM_MAX);
    if (e != 0) return e;
    kern<<<B, BT_THREADS, geo.smem, s>>>(X, W, C, M, N, K, geo.pitch, geo.rows);
  } else {
    auto* kern = int8_gemm_batched_stream_kernel<2>;
    const int e = allow_smem<4>(reinterpret_cast<const void*>(kern), BT_SMEM_MAX);
    if (e != 0) return e;
    kern<<<B, BT_THREADS, geo.smem, s>>>(X, W, C, M, N, K, geo.pitch, geo.rows);
  }
  return static_cast<int>(cudaGetLastError());
}

template <int NTW>
int ba_launch(const int8_t* X, const int8_t* W, int32_t* C, int blocks, int M, int N, int K,
              int tiles_m, const AdmissionGeometry& geo, cudaStream_t s) {
  auto* kern = int8_gemm_batched_tiles_kernel<NTW>;
  const int e = allow_smem<4 + NTW>(reinterpret_cast<const void*>(kern), BA_SMEM_MAX);
  if (e != 0) return e;
  kern<<<blocks, BA_THREADS, geo.smem, s>>>(X, W, C, M, N, K, tiles_m, geo);
  return static_cast<int>(cudaGetLastError());
}

// x [B,M,K] int8, wt [B,N,K] int8, c [B,M,N] int32, K % 16 == 0 and K <=
// 4096, 16-byte aligned starts: B products in tiles of 32 rows by up to 256
// columns, one a block.  Returns a cudaError_t.
extern "C" int int8_gemm_batched_tiles_launch(const void* x, const void* wt, void* c, int B,
                                              int M, int N, int K, void* stream) {
  if (B <= 0 || M <= 0 || N <= 0 || K <= 0 || K % 16 != 0 || K > BA_MAX_K)
    return static_cast<int>(cudaErrorInvalidValue);
  const AdmissionGeometry geo = ba_geometry(M, N, K);
  const int tiles_m = (M + BA_BM - 1) / BA_BM;
  const long long blocks = (long long)B * tiles_m * geo.tiles_n;
  if (geo.smem > BA_SMEM_MAX || blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int8_t* X = static_cast<const int8_t*>(x);
  const int8_t* W = static_cast<const int8_t*>(wt);
  int32_t* C = static_cast<int32_t*>(c);
  const int nb = static_cast<int>(blocks);
  switch ((geo.bn / 8 + BA_WARPS - 1) / BA_WARPS) {
    case 1: return ba_launch<1>(X, W, C, nb, M, N, K, tiles_m, geo, s);
    case 2: return ba_launch<2>(X, W, C, nb, M, N, K, tiles_m, geo, s);
    case 3: return ba_launch<3>(X, W, C, nb, M, N, K, tiles_m, geo, s);
    case 4: return ba_launch<4>(X, W, C, nb, M, N, K, tiles_m, geo, s);
    case 5: return ba_launch<5>(X, W, C, nb, M, N, K, tiles_m, geo, s);
    case 6: return ba_launch<6>(X, W, C, nb, M, N, K, tiles_m, geo, s);
    case 7: return ba_launch<7>(X, W, C, nb, M, N, K, tiles_m, geo, s);
    default: return ba_launch<8>(X, W, C, nb, M, N, K, tiles_m, geo, s);
  }
}

// The batched admission kernel's tile geometry for [M, K] x [N, K]: into
// out[6] bn, tiles_n, K pieces a stage, row pitch (pieces), staged-output
// pitch (int32), dynamic shared memory bytes.
extern "C" void int8_gemm_batched_tiles_geometry(int M, int N, int K, int* out) {
  const AdmissionGeometry geo = ba_geometry(M, N, K);
  out[0] = geo.bn;
  out[1] = geo.tiles_n;
  out[2] = geo.kc;
  out[3] = geo.pitch;
  out[4] = geo.out_pitch;
  out[5] = geo.smem;
}

// The batched decode kernel's dynamic shared memory for one product of
// [M, K] x [N, K].
extern "C" int int8_gemm_batched_smem_bytes(int M, int N, int K) {
  return bt_geometry(M, N, K).smem;
}

// Dynamic shared memory of each kernel's launch: 0 the admission kernel,
// 1 and 2 the decode kernel at M <= 8 and M <= 16.
extern "C" int int8_gemm_smem_bytes(int which) {
  return which == 0 ? static_cast<int>(WG_SMEM)
                    : (which == 1 ? st_smem_bytes<1>() : st_smem_bytes<2>());
}
