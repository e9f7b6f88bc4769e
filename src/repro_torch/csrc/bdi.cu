// Base-Delta-Immediate compressibility of 64-byte lines: the best of 11
// schemes and its encoded size, per line.
//
// Replaces: repro/kernels/bdi/bdi.py bdi_sizes_pallas, which must agree bit
//   for bit with the offline encoder repro/core/encodings.py
//   bdi_encode_lines (and so must this kernel, with the port's copy of it).
// Scheme ids and sizes: 0 raw (64 B), 1 zeros (1), 2 rep8 (8), 3 b8d1 (16),
//   4 b8d2 (24), 5 b8d4 (40), 6 rep4 (4), 7 b4d1 (20), 8 b4d2 (36),
//   9 rep2 (2), 10 b2d1 (34).  They are tried in the reference's order and a
//   scheme replaces the best only when it is strictly smaller, which decides
//   the id when several schemes fit.
// Arithmetic: 8-byte bases in native int64 modulo 2^64 (the TPU kernel
//   carried two uint32 limbs and a borrow, because its lanes are 32 bits
//   wide); 4-byte and 2-byte deltas exactly, in 64 and 32 bits — so a 4-byte
//   delta that overflows int32 is out of every 1- and 2-byte range, which is
//   the signed-overflow rule the TPU kernel spells out.
// Bound on the H100: bytes.  64 B in and 8 B out per line, for ~400 integer
//   operations on registers.
// Design: one thread per line, the line's 16 words in registers (four
//   16-byte loads).  Simple, not yet fast: a warp's loads touch 32 lines.
#include "common.cuh"

namespace {

constexpr int BDI_THREADS = 128;

__device__ __forceinline__ bool in_range(long long d, int delta_bytes) {
  const long long half = 1LL << (8 * delta_bytes - 1);
  return d >= -half && d < half;
}

__global__ void __launch_bounds__(BDI_THREADS)
bdi_kernel(const uint4* __restrict__ lines, int* __restrict__ sizes,
           int* __restrict__ schemes, long long n) {
  const long long i = (long long)blockIdx.x * BDI_THREADS + threadIdx.x;
  if (i >= n) return;
  uint32_t w[16];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const uint4 v = lines[4 * i + k];
    w[4 * k] = v.x;
    w[4 * k + 1] = v.y;
    w[4 * k + 2] = v.z;
    w[4 * k + 3] = v.w;
  }
  int best = 64, scheme = 0;
  auto take = [&](bool fits, int size, int id) {
    if (fits && size < best) {
      best = size;
      scheme = id;
    }
  };

  bool zeros = true;
#pragma unroll
  for (int k = 0; k < 16; ++k) zeros = zeros && w[k] == 0u;
  take(zeros, 1, 1);

  // 8-byte bases: little-endian words 2k (low) and 2k+1 (high)
  const uint64_t b8 = (uint64_t)w[0] | ((uint64_t)w[1] << 32);
  bool rep8 = true, f81 = true, f82 = true, f84 = true;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const uint64_t v = (uint64_t)w[2 * k] | ((uint64_t)w[2 * k + 1] << 32);
    const long long d = (long long)(v - b8);   // modulo 2^64
    rep8 = rep8 && d == 0;
    f81 = f81 && in_range(d, 1);
    f82 = f82 && in_range(d, 2);
    f84 = f84 && in_range(d, 4);
  }
  take(rep8, 8, 2);
  take(f81 && !rep8, 16, 3);
  take(f82 && !rep8, 24, 4);
  take(f84 && !rep8, 40, 5);

  // 4-byte bases: signed words, exact deltas
  const long long b4 = (int32_t)w[0];
  bool rep4 = true, f41 = true, f42 = true;
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    const long long d = (long long)(int32_t)w[k] - b4;
    rep4 = rep4 && d == 0;
    f41 = f41 && in_range(d, 1);
    f42 = f42 && in_range(d, 2);
  }
  take(rep4, 4, 6);
  take(f41 && !rep4, 20, 7);
  take(f42 && !rep4, 36, 8);

  // 2-byte bases: signed halves, low half first
  const int b2 = (int16_t)(w[0] & 0xffffu);
  bool rep2 = true, f21 = true;
#pragma unroll
  for (int k = 0; k < 32; ++k) {
    const int d = (int16_t)((w[k >> 1] >> (16 * (k & 1))) & 0xffffu) - b2;
    rep2 = rep2 && d == 0;
    f21 = f21 && in_range(d, 1);
  }
  take(rep2, 2, 9);
  take(f21 && !rep2, 34, 10);

  sizes[i] = best;
  schemes[i] = scheme;
}

}  // namespace

// lines: n x 16 int32 words; sizes, schemes: n int32 each
extern "C" int repro_bdi_sizes(const void* lines, void* sizes, void* schemes,
                               long long n, void* stream) {
  if (n > 0) {
    const long long blocks = (n + BDI_THREADS - 1) / BDI_THREADS;
    bdi_kernel<<<(unsigned)blocks, BDI_THREADS, 0, (cudaStream_t)stream>>>(
        (const uint4*)lines, (int*)sizes, (int*)schemes, n);
  }
  return (int)cudaGetLastError();
}
