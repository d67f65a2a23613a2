// The B-to-S converter bank: int8 sign-magnitude codes -> packed 128-bit
// stochastic streams (4 words) + signs, on Hopper (sm_90a).
//
// Replaces: src/repro/kernels/bts_encode/kernel.py :: bts_encode_kernel
// (the Pallas encoder that builds each [rows, cols] tile's streams on the
// TPU's vector unit).  Bit-exact with core/bitstream.py:
//   thermometer  bit i = i < m
//   bresenham    bit i = ((i+1)m + 64) / 128 - (i m + 64) / 128
//   lfsr         bit i = order[i] < m, order = the 7-bit LFSR visit table
// for stream position i = 32 w + b of word w, bit b (little-endian).
//
// What bounds it on an H100: the bytes written, 17 per code (16 of stream
// words, 1 of sign), against 1 read: an elementwise pass far below the
// card's ridge.  Design: one thread per output word, so a warp writes 128
// consecutive bytes; the thread that writes word 0 of a code also writes its
// sign.  The LFSR table sits in __constant__ memory, written once per device
// by bts_encode_set_lfsr from the Python copy of the table, so the two can
// never differ.  Bounds are checked in the kernel: no padding to blocks.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__constant__ int c_lfsr_order[128];

constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
bts_encode_kernel(const int8_t* __restrict__ q, uint32_t* __restrict__ words,
                  int8_t* __restrict__ sign, long long n_codes, int gen) {
  const long long t = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (t >= n_codes * 4) return;
  const long long e = t >> 2;
  const int w = (int)(t & 3);
  const int qv = q[e];
  const int m = qv < 0 ? -qv : qv;
  const int base = 32 * w;
  uint32_t word = 0;
  if (gen == 0) {  // thermometer: the first m positions
    const int ones = min(max(m - base, 0), 32);
    word = ones == 32 ? 0xFFFFFFFFu : ((1u << ones) - 1u);
  } else if (gen == 1) {  // bresenham with the +64 counter preset
    int prev = (base * m + 64) >> 7;
#pragma unroll 8
    for (int b = 0; b < 32; ++b) {
      const int next = ((base + b + 1) * m + 64) >> 7;
      word |= (uint32_t)(next - prev) << b;
      prev = next;
    }
  } else {  // lfsr comparator
#pragma unroll 8
    for (int b = 0; b < 32; ++b) word |= (uint32_t)(c_lfsr_order[base + b] < m) << b;
  }
  words[t] = word;
  if (w == 0) sign[e] = qv < 0 ? int8_t(-1) : int8_t(1);
}

}  // namespace

// order: 128 host ints, the LFSR visit table; written into the current
// device's constant memory (synchronously, once per device).
extern "C" int bts_encode_set_lfsr(const void* order) {
  return static_cast<int>(cudaMemcpyToSymbol(c_lfsr_order, order, 128 * sizeof(int)));
}

// q [n_codes] int8 -> words [n_codes, 4] uint32, sign [n_codes] int8.
// gen: 0 thermometer, 1 bresenham, 2 lfsr.
extern "C" int bts_encode_launch(const void* q, void* words, void* sign, long long n_codes,
                                 int gen, void* stream) {
  const long long threads = n_codes * 4;
  const unsigned blocks = (unsigned)((threads + THREADS - 1) / THREADS);
  bts_encode_kernel<<<blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(q), static_cast<uint32_t*>(words),
      static_cast<int8_t*>(sign), n_codes, gen);
  return static_cast<int>(cudaGetLastError());
}
