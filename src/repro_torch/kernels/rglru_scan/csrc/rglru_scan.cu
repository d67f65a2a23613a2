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
// 3.35 TB/s (0.0188 ms at [8, 256, 2560]).
//
// Design: one thread per (b, d) channel, 128-thread blocks across d, so
// each step's loads and stores of a warp are 128 consecutive bytes; the
// thread walks the whole sequence with h in a register, taking STEPS steps
// at a time: their 2 * STEPS loads (independent of h) are issued before
// the dependent multiply-adds, so a thread keeps that many loads in flight
// instead of one.  The TPU's blocked associative scan exists to keep its
// vector unit busy; here the B * D channels are the parallelism, enough for
// the serving shapes (8 x 2560 = 20480 threads).  A chunked two-pass scan
// for small B * D at long S is later work.  nvcc contracts a * h + b into
// one FMA, so h differs from the plain loop's in the last bits: parity is to
// tolerance, not bit for bit.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;
constexpr int STEPS = 8;  // sequence steps whose loads are issued together

__global__ void __launch_bounds__(THREADS)
rglru_scan_kernel(const float* __restrict__ a,  // [B, S, D]
                  const float* __restrict__ b,  // [B, S, D]
                  float* __restrict__ h_out,    // [B, S, D]
                  int S, int D) {
  const int d = blockIdx.x * THREADS + threadIdx.x;
  if (d >= D) return;
  const size_t base = (size_t)blockIdx.y * S * D + d;
  const float* ap = a + base;
  const float* bp = b + base;
  float* hp = h_out + base;
  float h = 0.f;
  int t = 0;
  for (; t + STEPS <= S; t += STEPS) {
    float av[STEPS], bv[STEPS];
#pragma unroll
    for (int i = 0; i < STEPS; ++i) {
      av[i] = ap[(size_t)(t + i) * D];
      bv[i] = bp[(size_t)(t + i) * D];
    }
#pragma unroll
    for (int i = 0; i < STEPS; ++i) {
      h = av[i] * h + bv[i];
      hp[(size_t)(t + i) * D] = h;
    }
  }
  for (; t < S; ++t) {
    h = ap[(size_t)t * D] * h + bp[(size_t)t * D];
    hp[(size_t)t * D] = h;
  }
}

}  // namespace

// a, b, h [B, S, D] float32, contiguous.  Returns a cudaError_t.
extern "C" int rglru_scan_launch(const void* a, const void* b, void* h, int B, int S, int D,
                                 void* stream) {
  if (B <= 0 || B > 65535 || S <= 0 || D <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((D + THREADS - 1) / THREADS, B);
  rglru_scan_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const float*>(b), static_cast<float*>(h), S, D);
  return static_cast<int>(cudaGetLastError());
}
