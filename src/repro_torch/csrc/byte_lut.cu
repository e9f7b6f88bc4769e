// A 256-entry byte lookup table applied to every byte of 64-byte lines.
//
// Replaces: repro/kernels/byte_lut/byte_lut.py byte_lut_pallas (reached
//   through repro/kernels/byte_lut/ops.py apply_lut_lines), the in-DRAM
//   encoding table of the paper's Section 10.1.
// Computes, per 32-bit word w of n_words:
//   out = lut[w & 0xff] | lut[(w >> 8) & 0xff] << 8 | lut[(w >> 16) & 0xff]
//         << 16 | lut[w >> 24] << 24   (uint32 arithmetic, as the reference
//   repacks its looked-up bytes).
// Bound on the H100: bytes.  Every line is read once and written once; the
//   lookups hit a 1 KiB table in shared memory.
// Design: the TPU kernel expanded each byte into a one-hot row and multiplied
//   it against the table on the MXU, because its vector unit has no gather,
//   and its caller first widened the lines into an (N, 64) int32 byte array
//   four times their size.  Here each block copies the table into shared
//   memory once, each thread loads one 16-byte uint4 of lines (coalesced),
//   splits its four words into bytes, looks each one up and repacks the
//   words.  The byte array is never written.
#include "common.cuh"

namespace {

constexpr int LUT_THREADS = 256;   // one table entry per thread to stage

__device__ __forceinline__ uint32_t lut_word(uint32_t w, const uint32_t* t) {
  return t[w & 0xffu] | (t[(w >> 8) & 0xffu] << 8) |
         (t[(w >> 16) & 0xffu] << 16) | (t[w >> 24] << 24);
}

__global__ void __launch_bounds__(LUT_THREADS)
byte_lut_kernel(const uint4* __restrict__ lines, const int* __restrict__ lut,
                uint4* __restrict__ out, long long n_vec) {
  __shared__ uint32_t table[256];
  table[threadIdx.x] = (uint32_t)lut[threadIdx.x];
  __syncthreads();
  const long long i = (long long)blockIdx.x * LUT_THREADS + threadIdx.x;
  if (i < n_vec) {
    const uint4 v = lines[i];
    out[i] = make_uint4(lut_word(v.x, table), lut_word(v.y, table),
                        lut_word(v.z, table), lut_word(v.w, table));
  }
}

}  // namespace

// lines and out: n_lines x 16 int32 words; lut: 256 int32 entries
extern "C" int repro_apply_lut_lines(const void* lines, const void* lut,
                                     void* out, long long n_lines,
                                     void* stream) {
  if (n_lines > 0) {
    const long long n_vec = 4 * n_lines;   // uint4 per line
    const long long blocks = (n_vec + LUT_THREADS - 1) / LUT_THREADS;
    byte_lut_kernel<<<(unsigned)blocks, LUT_THREADS, 0,
                      (cudaStream_t)stream>>>(
        (const uint4*)lines, (const int*)lut, (uint4*)out, n_vec);
  }
  return (int)cudaGetLastError();
}
