// Linear recurrence h_t = a_t * h_{t-1} + b_t, h_{-1} = 0, every state
// kept, on Hopper (sm_90a): the RG-LRU scan of RecurrentGemma's prefill.
//
// Replaces: src/repro/kernels/rglru_scan/kernel.py :: rglru_scan_kernel
// (grid (B/bb, S/chunk) with the chunk axis sequential, a log-depth
// associative scan inside each [bb, chunk, D] block and the carry in a
// revisited output block).  Same function: float32 a and b [B, S, D] ->
// float32 h [B, S, D].
//
// What bounds it on an H100: bytes.  Each element of a and b is read once
// and each h written once, 12 bytes per (b, t, d) against one multiply-add:
// far below the card's ridge, so the floor is 3 * B * S * D * 4 bytes over
// 3.35 TB/s (0.0188 ms at [8, 256, 2560]).  What reaches that floor is
// bytes in flight: HBM's latency at its rate wants tens of KB outstanding
// on every SM.  One thread per channel walking the whole sequence (this
// kernel before) gave 160 blocks of 128 threads at the serving shape, about
// 10 KB in flight an SM, and 41% of the floor.
//
// Design: parallel over the sequence as well as over channels, in one pass.
// * A block owns one batch row and TILE_D = 32 channels (a lane each, so a
//   warp's row of a step is 128 contiguous bytes) and walks S in chunks of
//   CHUNK = WARPS x SPW = 32 steps: [8, 256, 2560] gives 640 blocks of 8
//   warps, all resident at once.
// * A ring of STAGES = 3 chunks in shared memory (8 KB each: a and b) is
//   filled by 16-byte cp.async copies (4-byte ones when D % 4 != 0 or a
//   start is not 16-byte aligned), so two chunks, 16 KB, are in flight
//   while the third is scanned.  Steps past S and channels past D read as
//   zeros and are never stored.
// * In a chunk, warp w scans its SPW steps in registers from a zero state,
//   keeping each step's local state h_loc and the running product of its
//   decays P.  The warps' (P, h_loc) at their last step go through shared
//   memory; each warp folds those of the warps before it into the carry of
//   the previous chunk (c <- P_j c + h_j), writes h = h_loc + P * c_in for
//   its steps in coalesced rows, and keeps the chunk's outgoing carry.  Each
//   byte is read once and written once: no second pass.
// The recurrence is reassociated (as the reference kernel's associative scan
// does) and nvcc contracts each a * h + b into one FMA, so h differs from
// the plain loop's in the last bits: parity is to tolerance, not bit for
// bit.  ref.rglru_scan_chunked_ref is this decomposition in PyTorch.
#include <cuda_runtime.h>
#include <stdint.h>

#include "../../common/hopper.cuh"

namespace {

using namespace hopper;

constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;
constexpr int TILE_D = 32;             // channels of a block: one a lane
constexpr int SPW = 4;                 // steps a warp scans in a chunk
constexpr int CHUNK = WARPS * SPW;     // steps of a chunk
constexpr int STAGES = 3;              // chunks in the ring: two in flight, one scanned
constexpr int PIECES = TILE_D * 4 / 16;  // 16-byte pieces of a step's row

struct Stage {
  float a[CHUNK][TILE_D];
  float b[CHUNK][TILE_D];
};
constexpr int SMEM_BYTES = STAGES * static_cast<int>(sizeof(Stage)) + 2 * WARPS * TILE_D * 4;

// 4 bytes global -> shared at dst, zero-filled when !valid (nothing is read then)
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 4 : 0)
               : "memory");
}

// Chunk `chunk` of the block's rows of a and b into `st`.  VEC: D % 4 == 0
// and 16-byte aligned starts, so a 16-byte piece of 4 channels lies wholly
// inside or wholly outside [0, D).
template <bool VEC>
__device__ __forceinline__ void load_chunk(Stage* st, const float* __restrict__ a,
                                           const float* __restrict__ b, int chunk, int S,
                                           int D, int d0) {
  const int t0 = chunk * CHUNK;
  if constexpr (VEC) {
    for (int c = threadIdx.x; c < 2 * CHUNK * PIECES; c += THREADS) {
      const int arr = c / (CHUNK * PIECES), row = (c / PIECES) % CHUNK, p = c % PIECES;
      const int t = t0 + row, d = d0 + 4 * p;
      const bool ok = t < S && d < D;
      const float* src = (arr ? b : a) + (ok ? (size_t)t * D + d : 0);
      cp_async16(smem_u32(arr ? &st->b[row][4 * p] : &st->a[row][4 * p]), src, ok);
    }
  } else {
    for (int c = threadIdx.x; c < 2 * CHUNK * TILE_D; c += THREADS) {
      const int arr = c / (CHUNK * TILE_D), row = (c / TILE_D) % CHUNK, l = c % TILE_D;
      const int t = t0 + row, d = d0 + l;
      const bool ok = t < S && d < D;
      const float* src = (arr ? b : a) + (ok ? (size_t)t * D + d : 0);
      cp_async4(smem_u32(arr ? &st->b[row][l] : &st->a[row][l]), src, ok);
    }
  }
}

template <bool VEC>
__global__ void __launch_bounds__(THREADS)
rglru_scan_kernel(const float* __restrict__ a,  // [B, S, D]
                  const float* __restrict__ b,  // [B, S, D]
                  float* __restrict__ h_out,    // [B, S, D]
                  int S, int D) {
  __shared__ __align__(16) Stage ring[STAGES];
  __shared__ float end_p[WARPS][TILE_D], end_h[WARPS][TILE_D];  // each warp's last (P, h_loc)
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int d0 = blockIdx.x * TILE_D, d = d0 + lane;
  const size_t row0 = (size_t)blockIdx.y * S * D;
  a += row0;
  b += row0;
  h_out += row0;
  const int n_chunks = (S + CHUNK - 1) / CHUNK;

#pragma unroll
  for (int c = 0; c < STAGES - 1; ++c) {
    if (c < n_chunks) load_chunk<VEC>(&ring[c], a, b, c, S, D, d0);
    cp_async_commit();  // empty groups keep the count uniform
  }
  float carry = 0.f;  // h at the last step of the previous chunk
  for (int c = 0; c < n_chunks; ++c) {
    cp_async_wait<STAGES - 2>();  // this thread's copies of chunk c have landed
    __syncthreads();              // every thread's, and chunk c - 1's stage is read
    if (c + STAGES - 1 < n_chunks)
      load_chunk<VEC>(&ring[(c + STAGES - 1) % STAGES], a, b, c + STAGES - 1, S, D, d0);
    cp_async_commit();

    const Stage& st = ring[c % STAGES];
    float h_loc[SPW], prod[SPW];
    float h = 0.f, p = 1.f;
#pragma unroll
    for (int i = 0; i < SPW; ++i) {
      const float av = st.a[warp * SPW + i][lane];
      h = av * h + st.b[warp * SPW + i][lane];
      p *= av;
      h_loc[i] = h;
      prod[i] = p;
    }
    end_p[warp][lane] = p;
    end_h[warp][lane] = h;
    __syncthreads();
    float c_in = carry;
#pragma unroll
    for (int j = 0; j < WARPS; ++j) {
      if (j == warp) c_in = carry;
      carry = end_p[j][lane] * carry + end_h[j][lane];
    }
    if (d < D) {
#pragma unroll
      for (int i = 0; i < SPW; ++i) {
        const int t = c * CHUNK + warp * SPW + i;
        if (t < S) h_out[(size_t)t * D + d] = prod[i] * c_in + h_loc[i];
      }
    }
  }
}

}  // namespace

// a, b, h [B, S, D] float32, contiguous.  Returns a cudaError_t.
extern "C" int rglru_scan_launch(const void* a, const void* b, void* h, int B, int S, int D,
                                 void* stream) {
  if (B <= 0 || B > 65535 || S <= 0 || D <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((D + TILE_D - 1) / TILE_D, B);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec =
      D % 4 == 0 && (reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b)) % 16 == 0;
  if (vec)
    rglru_scan_kernel<true><<<grid, THREADS, 0, s>>>(static_cast<const float*>(a),
                                                     static_cast<const float*>(b),
                                                     static_cast<float*>(h), S, D);
  else
    rglru_scan_kernel<false><<<grid, THREADS, 0, s>>>(static_cast<const float*>(a),
                                                      static_cast<const float*>(b),
                                                      static_cast<float*>(h), S, D);
  return static_cast<int>(cudaGetLastError());
}

// Shared memory of a block (static: the ring and the warps' end values).
extern "C" int rglru_scan_smem_bytes() { return SMEM_BYTES; }
