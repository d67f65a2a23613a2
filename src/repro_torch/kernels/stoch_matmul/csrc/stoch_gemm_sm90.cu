// The OSSM array on Hopper's binary tensor cores (sm_90a): int8 codes
// against int8 codes, each expanded to sign planes of its 128-bit
// stochastic stream while it is staged, the signed popcounts summed by
// mma.sync / wgmma .b1.b1 .and.popc.
//
// Replaces: src/repro/kernels/stoch_matmul/kernel.py :: stoch_matmul_packed_kernel
// (the Pallas kernel that ANDs 128-bit streams, popcounts them and sums the
// signed counts over K on the TPU's vector unit) on the serving path, where
// both operands are codes at phase 0: the weights as quantize_weight_t's
// codes (1 byte a code, not bts_encode's 17), the activations as the
// quantizer writes them.  Computes
//   C[m, n] = sum_k sx * sw * popc(T_x[|X[m, k]|] & T_w[|W[n, k]|])
// into int32, X [M, K] and W [N, K] int8 codes (both K-contiguous), T_x /
// T_w the generators' tables of 129 streams, magnitudes 0..127 and then
// the stream of code -128 (ops.stream_table, built from core/bitstream.py's
// encode and encode_signed, so the two cannot differ; at -128 the wrapped
// int8 magnitude of the reference's encode_signed), sx / sw = -1 for a
// negative code, else +1.  Integer sums
// are exact in any order: the result is bit-identical to the plain version
// (ref.stoch_gemm_codes_ref) for every generator pair and every code.
// stoch_matmul.cu keeps the TPU kernel's packed interface and codes
// against cached streams.
//
// The arithmetic: a code c stages as two 128-bit planes, P = T[|c|] if c >=
// 0 else 0 and N = T[|c|] if c < 0 else 0.  Against a weight row of 256
// bits [P_w | N_w] a row [P_x | N_x] gives same = popc(P_x & P_w) +
// popc(N_x & N_w), a row [N_x | P_x] gives opp = popc(N_x & P_w) + popc(P_x
// & N_w), and C = same - opp: one binary product of k256 per code and
// sign variant, 512 bit-MACs a signed product.
//
// What bounds it on an H100: the products, then the shared memory that
// builds the planes.  NVIDIA publishes no rate for single-bit tensor-core
// products; chip_smoke.py's probe measured, on an H100 80GB HBM3 at 700 W,
// mma.sync m16n8k256 .b1 at 5.18e15 and wgmma m64n128k256 .b1 at 7.82e15
// bit-MACs/s (10.1e12 and 15.2e12 signed products/s), against 2.34e12
// random byte lookups/s into a shared 129 x 129 pair table (the other
// route: one lookup a product) and 1.05e12 products/s for the 4 CUDA-core
// popcounts a product of stoch_matmul.cu.  A decode step (M = 8) reads
// 1.44e9 weight codes, 0.43 ms at 3.35 TB/s, for 1.15e10 products, 1.1 ms
// at the mma.sync rate; every weight code also costs a 16-byte table
// lookup and 4 bit operations, and an SM's shared memory serves 128 bytes
// a clock, so the lookups run close to the products.
//
// Design: two kernels behind one launch function.
//
// Decode (stoch_gemm_stream_kernel, M <= 16):
// * Swapped roles: 16 weight rows (rows g and g + 8 of a group), each
//   [P_w | N_w], are mma.sync's m16 A operand and the 8 activation rows its
//   n8 B operand, once as [P_x | N_x] (same) and once as [N_x | P_x]
//   (opp): C = same - opp, fragment by fragment.
// * Both operands come from registers: a lane takes 16 consecutive codes of
//   its rows (one 16-byte load a row) and builds each code's planes from
//   tables in shared memory.  A weight code is a 16-byte lookup of its
//   stream and 4 bit operations a word, written straight into the A
//   fragment; an activation code one lookup in a table of every int8
//   code's planes, laid out {P0, N0, P1, N1}, {P2, N2, P3, N3}, so (P_i,
//   N_i) is already mma.sync's register pair b0, b1.  The k256 of one
//   product is four lanes' words: lane t supplies word i of its own code
//   c, so the products (c, i) over a lane's 16 codes and 4 words cover its
//   64 codes' streams exactly once, with no exchange between lanes (K is
//   permuted identically for both operands).
// * The tables sit in 8 interleaved copies, one per lane of a quarter
//   warp, so a lookup never meets a bank conflict (with one copy a random
//   16-byte lookup cost a warp 10.6 clocks against 4; the probe's 0.79e12
//   lookups/s).
// * A block (16 warps) walks row blocks of 32 weight rows in turn, one
//   block an SM, so the tables are staged once a launch; its warps take
//   64-code chunks of K in turn, each loading the next chunk's codes (in
//   this row block or the next) while it computes the current one, and
//   their sums meet in shared memory in a fixed order.  The weight codes
//   are read once, 64 contiguous bytes a row a load.  K is split over
//   blocks (int32 atomics into a zeroed output) when that fills the last
//   wave of SMs better (ops.stoch_gemm_plan).
//
// Admission (stoch_gemm_wgmma_kernel, M > 16):
// * One block (two warpgroups) per 128 x 128 output tile.  Since same +
//   opp = popc(X & W) of the bare streams, C = 2 same - popc(X & W): a code
//   costs a k256 product of the sign planes and half a k256 product of the
//   streams, 384 bit-MACs where same - opp takes 512.
// * X never crosses shared memory: wgmma takes A from registers, and each
//   thread builds its fragment (rows g and g + 8 of its warp's 16, word t
//   of each code) from a table lookup and two masks.  W is staged as sign
//   planes (128 rows x 32 bytes a code) and as streams (16 bytes a code);
//   a b1 K-major operand of 256 bits a row has the 32-byte row layout of
//   an int8 k32 operand, so a stage of 8 codes is whole 128-byte swizzle
//   atoms that common/hopper.cuh's smem_desc reads, the start advanced 32
//   bytes a product.  The threads store the W tile themselves (16-byte
//   stores at chunk c ^ (row % 8), the 128-byte swizzle, so a quarter
//   warp's stores hit distinct banks).
// * A stage is two groups of 4 codes (4 products of the planes, 2 of the
//   streams), each with its own fragment registers: group 0's products run
//   while group 1's fragments are built, group 1's while the next stage's
//   W tile is staged into the other of two buffers and its group 0 built;
//   the codes of the stage after next are loaded meanwhile.  Ragged M, N
//   and K read code 0: an empty stream, no product.  K is split (atomics)
//   when that fills the last wave of SMs better.
#include <cuda_runtime.h>
#include <stdint.h>

#include "../../common/hopper.cuh"

namespace {

using namespace hopper;

constexpr int TABLE = 129;  // streams of magnitudes 0..127, then row 128: code -128's
// A stream table sits in shared memory as 8 interleaved copies, entry e of
// copy j at 16-byte slot 8 e + j, and lane l reads copy l % 8: the 8 lanes
// of a quarter warp, which one 16-byte load serves together, then fall on
// 8 distinct bank groups whatever codes they look up.  With one copy a
// random lookup cost a warp about 10.6 clocks on an H100 (the probe's
// 0.79 T lookups/s), with 8 the conflict-free 4.
constexpr int COPIES = 8;
constexpr int TABLE_SLOTS = TABLE * COPIES;

__device__ __forceinline__ void stage_table(uint4* dst, const uint4* __restrict__ src, int tid,
                                            int threads) {
  for (int i = tid; i < TABLE_SLOTS; i += threads) dst[i] = __ldg(src + i / COPIES);
}

// all ones for a negative code, else zero
__device__ __forceinline__ uint32_t neg_mask(int c) { return static_cast<uint32_t>(c >> 31); }

__device__ __forceinline__ int abs_code(int c) { return c < 0 ? -c : c; }

// byte i of a 16-byte vector of codes, sign-extended
__device__ __forceinline__ int code_at(const uint4& v, int i) {
  const uint32_t w = i < 4 ? v.x : (i < 8 ? v.y : (i < 12 ? v.z : v.w));
  return static_cast<int>(static_cast<int8_t>(w >> (8 * (i & 3))));
}

__device__ __forceinline__ uint32_t word(const uint4& v, int i) {
  return i == 0 ? v.x : (i == 1 ? v.y : (i == 2 ? v.z : v.w));
}

// codes [k, k + 16) of a row, zero past k_end; vec: 16-byte aligned rows
__device__ __forceinline__ uint4 load16(const int8_t* row, int k, int k_end, bool vec,
                                        bool streaming) {
  if (vec && k + 16 <= k_end) {
    const uint4* p = reinterpret_cast<const uint4*>(row + k);
    return streaming ? __ldcs(p) : __ldg(p);
  }
  uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int i = 0; i < 16; ++i)
    if (k + i < k_end) w[i / 4] |= static_cast<uint32_t>(static_cast<uint8_t>(row[k + i]))
                                   << (8 * (i % 4));
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// codes [k, k + 4) of a row as 4 bytes, zero past k_end; vec: 4-byte aligned rows
__device__ __forceinline__ uint32_t load4(const int8_t* row, int k, int k_end, bool vec) {
  if (vec && k + 4 <= k_end) return __ldg(reinterpret_cast<const uint32_t*>(row + k));
  uint32_t w = 0u;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    if (k + i < k_end) w |= static_cast<uint32_t>(static_cast<uint8_t>(row[k + i])) << (8 * i);
  return w;
}

// d[16 x 8] += A[16 x 256] . B[256 x 8] in popcounts of ANDed bits (not
// volatile: the compiler may interleave the products with the table reads)
__device__ __forceinline__ void mma_b1(int (&d)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                       uint32_t a3, uint32_t b0, uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// ---------------------------------------------------------------- decode
constexpr int ST_GROUPS = 2;            // 16-row weight groups a warp multiplies
constexpr int ST_ROWS = 16 * ST_GROUPS;  // weight rows of a row block
constexpr int ST_CHUNK = 64;            // K codes a warp takes at a time, 16 a lane
// An activation code's planes, indexed by the code's byte u (0..255, two's
// complement) and the lane's copy: two 16-byte halves {P0, N0, P1, N1} and
// {P2, N2, P3, N3}, so (P_i, N_i) is an adjacent register pair, mma.sync's
// b0, b1.  Half h of (u, copy) sits at 16-byte slot (h 256 + u) 8 + copy.
constexpr int ST_HALF = 256 * COPIES;   // 16-byte slots of one half
constexpr int ST_XSLOTS = 2 * ST_HALF;  // 64 KB
// warps a block (the K chunks of a row block taken in turn): 16, or 8 for
// 16 activation rows, whose registers double
template <int MT>
__host__ __device__ constexpr int st_warps() { return MT == 1 ? 16 : 8; }
// dynamic shared memory: the activation planes, the weight stream table,
// then the warps' sums of a row block
template <int MT>
__host__ __device__ constexpr int st_smem_bytes() {
  return (ST_XSLOTS + TABLE_SLOTS) * 16 + st_warps<MT>() * MT * 8 * ST_ROWS * 4;
}

__device__ __forceinline__ void stage_x_planes(uint4* dst, const uint4* __restrict__ src,
                                               int tid, int threads) {
  for (int i = tid; i < ST_XSLOTS; i += threads) {
    const int h = i / ST_HALF, u = (i % ST_HALF) / COPIES;
    const int q = static_cast<int>(static_cast<int8_t>(u));
    const uint4 e = __ldg(src + abs_code(q));
    const uint32_t s = neg_mask(q);
    const uint32_t a = h ? e.z : e.x, b = h ? e.w : e.y;
    dst[i] = make_uint4(a & ~s, a & s, b & ~s, b & s);
  }
}

// MT n8 tiles of activation rows: 1 for M <= 8, 2 for M <= 16
template <int MT>
__global__ void __launch_bounds__(st_warps<MT>() * 32, 1)
stoch_gemm_stream_kernel(const int8_t* __restrict__ X, const int8_t* __restrict__ W,
                         const uint4* __restrict__ x_table, const uint4* __restrict__ w_table,
                         int32_t* __restrict__ C, int M, int N, int K, int kps, int splits) {
  constexpr int WARPS = st_warps<MT>();
  extern __shared__ uint4 st_smem[];
  uint4* const xt = st_smem;
  uint4* const wt = st_smem + ST_XSLOTS;
  int (*red)[MT * 8][ST_ROWS] =
      reinterpret_cast<int (*)[MT * 8][ST_ROWS]>(st_smem + ST_XSLOTS + TABLE_SLOTS);
  const int batch = blockIdx.z / splits, split = blockIdx.z % splits;
  X += (size_t)batch * M * K;
  W += (size_t)batch * N * K;
  C += (size_t)batch * M * N;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int n_blocks = (N + ST_ROWS - 1) / ST_ROWS;
  const int k_begin = split * kps, k_end = min(K, k_begin + kps);
  const int k_first = k_begin + warp * ST_CHUNK;  // this warp's first chunk of a row block
  const bool vec = (K % 16) == 0;
  const uint4* const x_lane = xt + lane % COPIES;  // this lane's copy of each table
  const uint4* const w_lane = wt + lane % COPIES;

  // this lane's rows: activation rows 8 mt + g (the B columns), weight rows
  // ST_ROWS rb + 8 r + g for r = 2 j + h (rows g, g + 8 of group j: A)
  const int8_t* xrow[MT];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    const int m = 8 * mt + g;
    xrow[mt] = m < M ? X + (size_t)m * K : nullptr;
  }
  auto fetch = [&](int rb, int k0, uint4 (&xv)[MT], uint4 (&wv)[2 * ST_GROUPS]) {
    const int k = k0 + 16 * t;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
      xv[mt] = xrow[mt] ? load16(xrow[mt], k, k_end, vec, false) : make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
    for (int r = 0; r < 2 * ST_GROUPS; ++r) {
      const int n = rb * ST_ROWS + 8 * r + g;
      wv[r] = n < N ? load16(W + (size_t)n * K, k, k_end, vec, true) : make_uint4(0u, 0u, 0u, 0u);
    }
  };

  // the blocks walk the row blocks in turn (gridDim.x of them, one an SM),
  // so the tables are staged once a block and a warp's loads of its next
  // chunk, in this row block or the next, run under its current one
  uint4 xv[MT], wv[2 * ST_GROUPS], xn[MT], wn[2 * ST_GROUPS];
  int rb = blockIdx.x;
  if (rb < n_blocks && k_first < k_end) fetch(rb, k_first, xv, wv);
  stage_x_planes(xt, x_table, threadIdx.x, blockDim.x);
  stage_table(wt, w_table, threadIdx.x, blockDim.x);
  __syncthreads();
  for (; rb < n_blocks; rb += gridDim.x) {
    int acc[MT][ST_GROUPS][2][4];  // [.][.][0]: same, [1]: opp
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int j = 0; j < ST_GROUPS; ++j)
#pragma unroll
        for (int v = 0; v < 2; ++v)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mt][j][v][e] = 0;
    for (int k0 = k_first; k0 < k_end; k0 += WARPS * ST_CHUNK) {
      int next_rb = rb, next_k = k0 + WARPS * ST_CHUNK;
      if (next_k >= k_end) {
        next_rb = rb + gridDim.x;
        next_k = k_first;
      }
      if (next_rb < n_blocks) fetch(next_rb, next_k, xn, wn);
#pragma unroll
      for (int c = 0; c < 16; ++c) {
        uint4 xl[MT], xh[MT], we[2 * ST_GROUPS];
        uint32_t ws[2 * ST_GROUPS];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          const uint32_t u = static_cast<uint32_t>(code_at(xv[mt], c)) & 0xFFu;
          xl[mt] = x_lane[u * COPIES];
          xh[mt] = x_lane[u * COPIES + ST_HALF];
        }
#pragma unroll
        for (int r = 0; r < 2 * ST_GROUPS; ++r) {
          const int q = code_at(wv[r], c);
          we[r] = w_lane[abs_code(q) * COPIES];
          ws[r] = neg_mask(q);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < ST_GROUPS; ++j) {
            // A: rows g, g + 8 of the group as [P_w | N_w]
            const uint32_t e0 = word(we[2 * j], i), s0 = ws[2 * j];
            const uint32_t e1 = word(we[2 * j + 1], i), s1 = ws[2 * j + 1];
            const uint32_t a0 = e0 & ~s0, a1 = e1 & ~s1, a2 = e0 & s0, a3 = e1 & s1;
#pragma unroll
            for (int mt = 0; mt < MT; ++mt) {  // B: [P_x | N_x] (same), [N_x | P_x] (opp)
              const uint4& xw = i < 2 ? xl[mt] : xh[mt];
              const uint32_t p = i % 2 ? xw.z : xw.x, n = i % 2 ? xw.w : xw.y;
              mma_b1(acc[mt][j][0], a0, a1, a2, a3, p, n);
              mma_b1(acc[mt][j][1], a0, a1, a2, a3, n, p);
            }
          }
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) xv[mt] = xn[mt];
#pragma unroll
      for (int r = 0; r < 2 * ST_GROUPS; ++r) wv[r] = wn[r];
    }

    // d0, d1: weight row g, activation rows 2t, 2t + 1; d2, d3: row g + 8
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int j = 0; j < ST_GROUPS; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          red[warp][8 * mt + 2 * t + e % 2][16 * j + g + 8 * (e / 2)] =
              acc[mt][j][0][e] - acc[mt][j][1][e];
    __syncthreads();
    const int n0 = rb * ST_ROWS;
    for (int i = threadIdx.x; i < MT * 8 * ST_ROWS; i += blockDim.x) {
      const int r = i / ST_ROWS, col = n0 + i % ST_ROWS;
      int sum = 0;
#pragma unroll
      for (int w = 0; w < WARPS; ++w) sum += red[w][r][i % ST_ROWS];
      if (r < M && col < N) {
        if (splits > 1) atomicAdd(C + (size_t)r * N + col, sum);
        else C[(size_t)r * N + col] = sum;
      }
    }
    __syncthreads();  // the sums are read before the next row block's are written
  }
}

// ------------------------------------------------------------- admission
constexpr int WG_BM = 128, WG_BN = 128;  // output tile
constexpr int WG_CODES = 8;              // K codes a stage, two groups of 4
constexpr int WG_THREADS = 256;          // two warpgroups, 64 rows of X each
constexpr uint32_t WG_ATOM = 128 * 128;  // 128 rows x 128 bytes
// a stage of W: sign planes, two atoms (32 bytes a code), and bare
// streams, one atom (16 bytes a code)
constexpr uint32_t WG_W = 0, WG_WT = 2 * WG_ATOM;
constexpr uint32_t WG_STAGE = 3 * WG_ATOM;
constexpr uint32_t WG_TABLES = 2 * WG_STAGE;
constexpr size_t WG_SMEM = 1024 + WG_TABLES + 2 * TABLE_SLOTS * 16;  // + base alignment
static_assert(WG_SMEM <= 232448, "one block an SM");

// d[64 x 128] += A[64 x 256 bits] . B[256 bits x 128] in popcounts of ANDed
// bits: A from registers (a thread's fragment: rows g and g + 8 of its
// warp's 16, bits 32 t.. of each half), B K-major b1 in shared memory,
// int32 accumulators
__device__ __forceinline__ void wgmma_b1(int (&d)[64], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k256.s32.b1.b1.and.popc "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, "
      "%35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, "
      "%52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, "
      "%68, p;\n}\n"
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
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// 16 bytes into row r, 16-byte chunk ch of a 128-byte swizzled atom
__device__ __forceinline__ void st_chunk(uint32_t atom, int r, int ch, uint4 v) {
  const uint32_t addr = atom + r * 128 + ((ch ^ (r & 7)) << 4);
  asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};\n" ::"r"(addr), "r"(v.x), "r"(v.y),
               "r"(v.z), "r"(v.w)
               : "memory");
}

// codes [k, k + 8) of a row as 8 bytes, zero past k_end; vec: 8-byte aligned rows
__device__ __forceinline__ uint2 load8(const int8_t* row, int k, int k_end, bool vec) {
  if (vec && k + 8 <= k_end) return __ldg(reinterpret_cast<const uint2*>(row + k));
  uint32_t w[2] = {0u, 0u};
#pragma unroll
  for (int i = 0; i < 8; ++i)
    if (k + i < k_end) w[i / 4] |= static_cast<uint32_t>(static_cast<uint8_t>(row[k + i]))
                                   << (8 * (i % 4));
  return make_uint2(w[0], w[1]);
}

// A fragments of a group of 4 codes: [0..3] the sign planes [P | N] of code
// j of rows g, g + 8 (same), [4..5] the bare streams of codes 2q, 2q + 1
// (all)
struct AFrags {
  uint32_t r[6][4];
};

__global__ void __launch_bounds__(WG_THREADS, 1)
stoch_gemm_wgmma_kernel(const int8_t* __restrict__ X, const int8_t* __restrict__ W,
                        const uint4* __restrict__ x_table, const uint4* __restrict__ w_table,
                        int32_t* __restrict__ C, int M, int N, int K, int kps, int splits) {
  extern __shared__ __align__(1024) unsigned char wg_smem[];
  const uint32_t base = (smem_u32(wg_smem) + 1023u) & ~1023u;
  uint4* const xt = reinterpret_cast<uint4*>(wg_smem + (base - smem_u32(wg_smem)) + WG_TABLES);
  uint4* const wt = xt + TABLE_SLOTS;
  const int batch = blockIdx.z / splits, split = blockIdx.z % splits;
  X += (size_t)batch * M * K;
  W += (size_t)batch * N * K;
  C += (size_t)batch * M * N;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int m0 = blockIdx.x * WG_BM, n0 = blockIdx.y * WG_BN;
  const int k_begin = split * kps, k_end = min(K, k_begin + kps);
  const int n_steps = (k_end - k_begin + WG_CODES - 1) / WG_CODES;
  const int wg = warp / 4;  // rows m0 + 64 wg .. + 63

  // W staging: this thread's row r of the W tile, atom h (codes 4h .. 4h + 3)
  const int r = tid % 128, h = tid / 128, copy = lane % COPIES;
  const int8_t* wrow = n0 + r < N ? W + (size_t)(n0 + r) * K : nullptr;
  // A: this thread's rows of X, g and g + 8 of its warp's 16
  const int xr = m0 + wg * 64 + (warp % 4) * 16 + g;
  const int8_t* xrow0 = xr < M ? X + (size_t)xr * K : nullptr;
  const int8_t* xrow1 = xr + 8 < M ? X + (size_t)(xr + 8) * K : nullptr;
  // word t of a stream, from this lane's copy of the table (copy g: the 8
  // groups of a warp and the 4 words fall on 32 distinct banks)
  const uint32_t* const x_words = reinterpret_cast<const uint32_t*>(xt + g) + t;
  auto fetch = [&](int step, uint2& x0, uint2& x1, uint32_t& wc) {
    const int k = k_begin + step * WG_CODES;
    x0 = xrow0 ? load8(xrow0, k, k_end, (K % 8) == 0) : make_uint2(0u, 0u);
    x1 = xrow1 ? load8(xrow1, k, k_end, (K % 8) == 0) : make_uint2(0u, 0u);
    wc = wrow ? load4(wrow, k + 4 * h, k_end, (K % 4) == 0) : 0u;
  };
  auto stage_w = [&](int buf, uint32_t wc) {
    const uint32_t s = base + buf * WG_STAGE;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int q = static_cast<int>(static_cast<int8_t>(wc >> (8 * c)));
      const uint4 e = wt[abs_code(q) * COPIES + copy];
      const uint32_t sg = neg_mask(q);
      st_chunk(s + WG_W + h * WG_ATOM, r, 2 * c,
               make_uint4(e.x & ~sg, e.y & ~sg, e.z & ~sg, e.w & ~sg));
      st_chunk(s + WG_W + h * WG_ATOM, r, 2 * c + 1,
               make_uint4(e.x & sg, e.y & sg, e.z & sg, e.w & sg));
      st_chunk(s + WG_WT, r, 4 * h + c, e);
    }
  };
  // the fragments of codes 4 half .. + 3 of a stage's X codes x0, x1
  auto build = [&](AFrags& a, uint2 x0, uint2 x1, int half) {
    const uint32_t w0 = half ? x0.y : x0.x, w1 = half ? x1.y : x1.x;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int q0 = static_cast<int>(static_cast<int8_t>(w0 >> (8 * j)));
      const int q1 = static_cast<int>(static_cast<int8_t>(w1 >> (8 * j)));
      const uint32_t e0 = x_words[abs_code(q0) * COPIES * 4];
      const uint32_t e1 = x_words[abs_code(q1) * COPIES * 4];
      const uint32_t s0 = neg_mask(q0), s1 = neg_mask(q1);
      a.r[j][0] = e0 & ~s0;
      a.r[j][1] = e1 & ~s1;
      a.r[j][2] = e0 & s0;
      a.r[j][3] = e1 & s1;
      a.r[4 + j / 2][2 * (j % 2)] = e0;
      a.r[4 + j / 2][2 * (j % 2) + 1] = e1;
    }
  };
  // same: [P_x | N_x] . [P_w | N_w] a code; all: popc(X & W) of the bare
  // streams, two codes a k256; C = 2 same - all
  int same[64], all[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) same[i] = all[i] = 0;
  auto issue = [&](const AFrags& a, int buf, int half) {
    const uint32_t s = base + buf * WG_STAGE;
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < 4; ++j)
      wgmma_b1(same, a.r[j], smem_desc(s + WG_W + half * WG_ATOM + 32 * j));
#pragma unroll
    for (int q = 0; q < 2; ++q)
      wgmma_b1(all, a.r[4 + q], smem_desc(s + WG_WT + 64 * half + 32 * q));
    wgmma_commit();
  };

  stage_table(xt, x_table, tid, WG_THREADS);
  stage_table(wt, w_table, tid, WG_THREADS);
  uint2 x0, x1, xn0, xn1;
  uint32_t wc, wn;
  AFrags a0, a1;
  if (n_steps > 0) fetch(0, x0, x1, wc);
  if (n_steps > 1) fetch(1, xn0, xn1, wn);
  __syncthreads();  // the tables are staged
  if (n_steps > 0) {
    stage_w(0, wc);
    build(a0, x0, x1, 0);
  }
  fence_proxy_async();
  __syncthreads();
  // a stage: group 0 runs while group 1's fragments are built; group 1
  // while the next stage's W tile is staged and its group 0 built
  for (int step = 0; step < n_steps; ++step) {
    const int buf = step & 1;
    issue(a0, buf, 0);
    wgmma_wait<1>();  // the last stage's group 1 is done: a1 is free
    build(a1, x0, x1, 1);
    issue(a1, buf, 1);
    wgmma_wait<1>();  // group 0 is done: a0 is free
    if (step + 1 < n_steps) {
      __syncthreads();  // both warpgroups are done with the last stage's buffer
      stage_w(buf ^ 1, wn);
      x0 = xn0;
      x1 = xn1;
      build(a0, x0, x1, 0);
      if (step + 2 < n_steps) fetch(step + 2, xn0, xn1, wn);
      fence_proxy_async();
      __syncthreads();
    }
  }
  wgmma_wait<0>();
  fence_regs(same);
  fence_regs(all);

  // d[4j + e]: row 16 (warp % 4) + gid + 8 (e / 2), column 8j + 2 tig + (e % 2)
  const int gid = lane / 4, tig = lane % 4;
  const bool pairs = (N % 2) == 0;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = m0 + wg * 64 + (warp % 4) * 16 + gid + 8 * hh;
    if (row >= M) continue;
    int32_t* crow = C + (size_t)row * N;
#pragma unroll
    for (int j = 0; j < WG_BN / 8; ++j) {
      const int col = n0 + j * 8 + tig * 2;
      const int v0 = 2 * same[4 * j + 2 * hh] - all[4 * j + 2 * hh];
      const int v1 = 2 * same[4 * j + 2 * hh + 1] - all[4 * j + 2 * hh + 1];
      if (splits > 1) {
        if (col < N) atomicAdd(crow + col, v0);
        if (col + 1 < N) atomicAdd(crow + col + 1, v1);
      } else if (pairs && col + 1 < N) {
        *reinterpret_cast<int2*>(crow + col) = make_int2(v0, v1);
      } else {
        if (col < N) crow[col] = v0;
        if (col + 1 < N) crow[col + 1] = v1;
      }
    }
  }
}

// lets kernel take bytes of dynamic shared memory on the current device,
// once a device (set: a bit a device it was done on)
template <class Kernel>
cudaError_t allow_smem(Kernel* kernel, int bytes, uint64_t& set) {
  int device = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e != cudaSuccess) return e;
  const uint64_t bit = uint64_t(1) << (device & 63);
  if (set & bit) return cudaSuccess;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e == cudaSuccess) set |= bit;
  return e;
}

}  // namespace

// Codes X [B, M, K] and W [B, N, K] (int8, K-contiguous) against each
// other; x_table / w_table: [129, 4] uint32 streams of magnitudes 0..128
// under each operand's generator.  c [B, M, N] int32 (zeroed by the caller
// when splits > 1).  kernel 0: the decode kernel (M <= 16; width blocks
// walking the row blocks of 16 weight rows), 1: the wgmma kernel (128 x
// 128 tiles; width unused).  gridDim.z runs over B x splits, each split kps
// codes of K.
extern "C" int stoch_gemm_launch(const void* x, const void* x_table, const void* w,
                                 const void* w_table, void* c, int B, int M, int N, int K,
                                 int kps, int splits, int kernel, int width, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int8_t* X = static_cast<const int8_t*>(x);
  const int8_t* Wc = static_cast<const int8_t*>(w);
  const uint4* xt = static_cast<const uint4*>(x_table);
  const uint4* wt = static_cast<const uint4*>(w_table);
  int32_t* C = static_cast<int32_t*>(c);
  if (kernel == 0) {
    const dim3 grid(width, 1, B * splits);
    cudaError_t e;
    if (M <= 8) {
      static uint64_t set = 0;
      if ((e = allow_smem(stoch_gemm_stream_kernel<1>, st_smem_bytes<1>(), set)) != cudaSuccess)
        return static_cast<int>(e);
      stoch_gemm_stream_kernel<1><<<grid, st_warps<1>() * 32, st_smem_bytes<1>(), s>>>(
          X, Wc, xt, wt, C, M, N, K, kps, splits);
    } else if (M <= 16) {
      static uint64_t set = 0;
      if ((e = allow_smem(stoch_gemm_stream_kernel<2>, st_smem_bytes<2>(), set)) != cudaSuccess)
        return static_cast<int>(e);
      stoch_gemm_stream_kernel<2><<<grid, st_warps<2>() * 32, st_smem_bytes<2>(), s>>>(
          X, Wc, xt, wt, C, M, N, K, kps, splits);
    } else {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  } else if (kernel == 1) {
    static uint64_t set = 0;
    const cudaError_t e = allow_smem(stoch_gemm_wgmma_kernel, (int)WG_SMEM, set);
    if (e != cudaSuccess) return static_cast<int>(e);
    const dim3 grid((M + WG_BM - 1) / WG_BM, (N + WG_BN - 1) / WG_BN, B * splits);
    stoch_gemm_wgmma_kernel<<<grid, WG_THREADS, WG_SMEM, s>>>(X, Wc, xt, wt, C, M, N, K, kps,
                                                              splits);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// dynamic shared memory of the wgmma kernel, as its launch requests it
extern "C" int stoch_gemm_smem_bytes() { return static_cast<int>(WG_SMEM); }
