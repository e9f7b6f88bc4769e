// Per-line popcount and bus-toggle count over 64-byte cache lines.
//
// Replaces: repro/kernels/popcount/popcount.py line_ones_pallas and
//   repro/kernels/toggle/toggle.py line_toggles_pallas.
// Computes, per line i of n:  repro_line_ones     out[i] = popcount(lines[i])
//                             repro_line_toggles  out[i] = popcount(cur[i] ^
//                                                                 prev[i])
//   as int32.  The sequential variant (toggles of each line against the one
//   before it) passes cur = lines + 1 line and prev = lines, two views of one
//   buffer, so no shifted copy is ever written.
// Bound on the H100: bytes.  64 B in (the sequential variant's second view
//   re-reads cached lines) and 4 B out per line, for ~30-50 integer
//   operations: far below the card's operations-per-byte balance.
// Design: the layout of features.cu — four threads per line, each loading
//   one 16-byte uint4, so a warp reads 8 whole lines in 512 contiguous bytes;
//   __popc per word, a 4-lane __shfl_xor_sync sum, and the first lane of each
//   line writes its count.  No shared memory.
#include "common.cuh"

namespace {

template <bool TOGGLE>
__global__ void __launch_bounds__(256)
line_bits_kernel(const uint4* __restrict__ cur, const uint4* __restrict__ prev,
                 int* __restrict__ out, long long n) {
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long line = tid >> 2;
  int c = 0;
  if (line < n) {
    const uint4 v = cur[tid];
    c = repro::popc4(TOGGLE ? repro::xor4(v, prev[tid]) : v);
  }
  c = repro::quad_sum(c);
  if (line < n && (tid & 3) == 0) out[line] = c;
}

template <bool TOGGLE>
int launch(const void* cur, const void* prev, void* out, long long n,
           void* stream) {
  if (n > 0) {
    const int threads = 256;
    const long long blocks = (4 * n + threads - 1) / threads;
    line_bits_kernel<TOGGLE><<<(unsigned)blocks, threads, 0,
                               (cudaStream_t)stream>>>(
        (const uint4*)cur, (const uint4*)prev, (int*)out, n);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int repro_line_ones(const void* lines, void* out, long long n,
                               void* stream) {
  return launch<false>(lines, nullptr, out, n, stream);
}

extern "C" int repro_line_toggles(const void* cur, const void* prev,
                                  void* out, long long n, void* stream) {
  return launch<true>(cur, prev, out, n, stream);
}
