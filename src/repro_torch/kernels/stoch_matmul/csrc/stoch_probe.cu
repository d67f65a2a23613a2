// Rate probes for the stochastic GEMM's two candidate routes on Hopper
// (sm_90a), run by chip_smoke.py's probe phase.  They replace no TPU
// kernel: NVIDIA publishes no rate for single-bit tensor-core products on
// the H100, so the route of stoch_gemm_sm90.cu was chosen from what
// these measure (PERF.md).
//
// * mma_b1_kernel: mma.sync.aligned.m16n8k256 .s32.b1.b1 .and.popc, each
//   warp issuing MMA_CHAINS independent accumulator chains back to back
//   (16 x 8 x 256 bit-MACs an instruction).  A signed stochastic product
//   of sign planes costs 512 of them ([P | N] rows dotted against both
//   sign variants of the other operand), or 384 (2 * same - popc(X & W)).
// * wgmma_b1_kernel: wgmma.mma_async m64n128k256 .s32.b1.b1 .and.popc, one
//   warpgroup a block issuing it back to back on one accumulator from two
//   shared-memory operands in the 128-byte swizzle (64 x 32-byte and 128 x
//   32-byte K-major rows, the layout of an int8 k32 operand), 64 x 128 x
//   256 bit-MACs an instruction.
// * lds_u8_kernel: random byte lookups into the 129 x 129 pair table
//   P[a][b] = popc(table_x[a] & table_w[b]) (16,641 bytes) in shared
//   memory, each lane on its own LOOKUPS indices: one lookup a product.
// * lds_v4_kernel: random 16-byte lookups into a 128 KB shared table, the
//   read of a per-position table of 8 signed products (eight 16-bit
//   lanes) that one weight code selects.
// Each kernel writes one int a thread so the compiler keeps its work; the
// loads are ld.volatile, so ptxas hoists none of them out of the loop (a
// plain ld.shared in a volatile asm statement is still hoisted by ptxas).
#include "../../common/hopper.cuh"

namespace {

using namespace hopper;

constexpr int MMA_CHAINS = 8;   // independent accumulators a warp
constexpr int LOOKUPS = 16;     // independent indices a lane
constexpr int PAIRS = 129 * 129;

__global__ void mma_b1_kernel(int iters, int* out) {
  const uint32_t s = (blockIdx.x * blockDim.x + threadIdx.x) * 2654435761u;
  const uint32_t a0 = s, a1 = s ^ 0x9e3779b9u, a2 = s * 3u, a3 = ~s;
  const uint32_t b0 = s >> 3, b1 = s * 7u;
  int d[MMA_CHAINS][4] = {};
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int c = 0; c < MMA_CHAINS; ++c)
      asm volatile(
          "mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc "
          "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
          : "+r"(d[c][0]), "+r"(d[c][1]), "+r"(d[c][2]), "+r"(d[c][3])
          : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
  }
  int sum = 0;
#pragma unroll
  for (int c = 0; c < MMA_CHAINS; ++c) sum += d[c][0] + d[c][1] + d[c][2] + d[c][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = sum;
}

__global__ void lds_u8_kernel(const uint8_t* __restrict__ table,
                              const uint32_t* __restrict__ idx, int iters, int* out) {
  __shared__ uint8_t t[(PAIRS + 15) / 16 * 16];
  for (int i = threadIdx.x; i < PAIRS; i += blockDim.x) t[i] = table[i];
  __syncthreads();
  const int gid = blockIdx.x * blockDim.x + threadIdx.x;
  const uint32_t base = static_cast<uint32_t>(__cvta_generic_to_shared(t));
  uint32_t addr[LOOKUPS];
#pragma unroll
  for (int j = 0; j < LOOKUPS; ++j) addr[j] = base + idx[gid * LOOKUPS + j] % PAIRS;
  int acc = 0;
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int j = 0; j < LOOKUPS; ++j) {
      uint32_t v;
      asm volatile("ld.volatile.shared.u8 %0, [%1];\n" : "=r"(v) : "r"(addr[j]));
      acc += v;
    }
  }
  out[gid] = acc;
}

constexpr int V4_ENTRIES = 8192;  // 128 KB of 16-byte entries

__global__ void lds_v4_kernel(const uint4* __restrict__ table, const uint32_t* __restrict__ idx,
                              int iters, int* out) {
  extern __shared__ uint4 tv[];
  for (int i = threadIdx.x; i < V4_ENTRIES; i += blockDim.x) tv[i] = table[i];
  __syncthreads();
  const int gid = blockIdx.x * blockDim.x + threadIdx.x;
  const uint32_t base = static_cast<uint32_t>(__cvta_generic_to_shared(tv));
  uint32_t addr[LOOKUPS];
#pragma unroll
  for (int j = 0; j < LOOKUPS; ++j) addr[j] = base + 16 * (idx[gid * LOOKUPS + j] % V4_ENTRIES);
  uint32_t acc0 = 0, acc1 = 0, acc2 = 0, acc3 = 0;
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int j = 0; j < LOOKUPS; ++j) {
      uint32_t x, y, z, w;
      asm volatile("ld.volatile.shared.v4.u32 {%0, %1, %2, %3}, [%4];\n"
                   : "=r"(x), "=r"(y), "=r"(z), "=r"(w)
                   : "r"(addr[j]));
      acc0 += x;
      acc1 += y;
      acc2 += z;
      acc3 += w;
    }
  }
  out[gid] = static_cast<int>(acc0 ^ acc1 ^ acc2 ^ acc3);
}

__global__ void __launch_bounds__(128) wgmma_b1_kernel(int iters, int* out) {
  __shared__ __align__(1024) uint8_t a_s[64 * 128];
  __shared__ __align__(1024) uint8_t b_s[128 * 128];
  for (int i = threadIdx.x; i < 64 * 128; i += 128) a_s[i] = static_cast<uint8_t>(i * 37 + 11);
  for (int i = threadIdx.x; i < 128 * 128; i += 128) b_s[i] = static_cast<uint8_t>(i * 91 + 5);
  __syncthreads();
  fence_proxy_async();
  const uint64_t da = smem_desc(smem_u32(a_s)), db = smem_desc(smem_u32(b_s));
  int d[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) d[i] = 0;
  for (int it = 0; it < iters; ++it) {
    wgmma_fence();
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k256.s32.b1.b1.and.popc "
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
        : "l"(da), "l"(db), "r"(1));
    wgmma_commit();
    wgmma_wait<1>();
  }
  wgmma_wait_all();
  int sum = 0;
#pragma unroll
  for (int i = 0; i < 64; ++i) sum += d[i];
  out[blockIdx.x * blockDim.x + threadIdx.x] = sum;
}

}  // namespace

// kind 0: mma.sync b1 (table, idx unused); 1: byte lookups into the
// 16,641-byte table; 2: 16-byte lookups into a 128 KB table; 3: wgmma b1
// (table, idx unused; 128 threads a block whatever `threads` says).  idx
// holds LOOKUPS random uint32 a thread; out one int a thread.
extern "C" int stoch_probe_launch(int kind, const void* table, const void* idx, void* out,
                                  int blocks, int threads, int iters, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int* o = static_cast<int*>(out);
  const uint32_t* ix = static_cast<const uint32_t*>(idx);
  if (kind == 0) {
    mma_b1_kernel<<<blocks, threads, 0, s>>>(iters, o);
  } else if (kind == 1) {
    lds_u8_kernel<<<blocks, threads, 0, s>>>(static_cast<const uint8_t*>(table), ix, iters, o);
  } else if (kind == 2) {
    const int smem = V4_ENTRIES * 16;
    cudaFuncSetAttribute(lds_v4_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    lds_v4_kernel<<<blocks, threads, smem, s>>>(static_cast<const uint4*>(table), ix, iters, o);
  } else if (kind == 3) {
    wgmma_b1_kernel<<<blocks, 128, 0, s>>>(iters, o);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int stoch_probe_lookups() { return LOOKUPS; }
extern "C" int stoch_probe_chains() { return MMA_CHAINS; }
