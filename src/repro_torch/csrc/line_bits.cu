// Per-line popcount and bus-toggle count over 64-byte cache lines.
//
// Replaces: repro/kernels/popcount/popcount.py line_ones_pallas and
//   repro/kernels/toggle/toggle.py line_toggles_pallas (through
//   repro/kernels/toggle/ops.py line_toggles_seq).
// Computes, per line i of n, as int32:
//   repro_line_ones         out[i] = popcount(lines[i])
//   repro_line_toggles      out[i] = popcount(cur[i] ^ prev[i])
//   repro_line_toggles_seq  out[i] = popcount(lines[i] ^ lines[i - 1]),
//                           out[0] = 0
// Bound on the H100: bytes.  64 B in and 4 B out per line, for ~30-50
//   integer operations: far below the card's operations-per-byte balance.
// Design of repro_line_ones and repro_line_toggles: four threads per line,
//   each loading one 16-byte uint4, so a warp reads 8 whole lines in 512
//   contiguous bytes; __popc per word, a 4-lane __shfl_xor_sync sum, and
//   the first lane of each line writes its count.  No shared memory.
// Design of repro_line_toggles_seq, which replaces a fill of out[0] plus
//   repro_line_toggles over the two views lines[1:] and lines[:-1] (two
//   device operations, every line loaded twice, one 16-byte load in flight
//   per thread): one kernel that writes out[0] itself and reads each line
//   once.  Each warp takes a run of SEQ_RUN lines, 8 lines (512 B) a step,
//   and issues all SEQ_UNROLL steps' streaming 16-byte loads (__ldcs:
//   nothing is reused from L1) before it consumes any.  A line's
//   predecessor quarter comes from the lane 4 below (one rotation of the
//   warp's quarters by 4 lanes); lanes 0-3 take the rotation of the step
//   before, which holds that step's last line, and a run's first step
//   loads the line before the run (1 line in 32 read twice, mostly from
//   L2).  One short run a warp over a grid as long as the input, so the
//   hardware hands out the warps in address order: a grid of a few blocks
//   per SM whose warps each walk one long run (reads spread over as many
//   places as warps) was slower on 1 GiB than the two-view kernel it
//   replaces (PERF.md, tools/line_bits_ab.py).
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

constexpr int SEQ_THREADS = 256;
constexpr int SEQ_UNROLL = 4;                  // loads in flight a thread
constexpr long long SEQ_RUN = 8 * SEQ_UNROLL;  // lines a warp takes

__device__ __forceinline__ uint4 shfl4(uint4 v, int src) {
  return make_uint4(__shfl_sync(0xffffffffu, v.x, src),
                    __shfl_sync(0xffffffffu, v.y, src),
                    __shfl_sync(0xffffffffu, v.z, src),
                    __shfl_sync(0xffffffffu, v.w, src));
}

// Run r covers lines [r * SEQ_RUN, min((r + 1) * SEQ_RUN, n)); lane l holds
// quarter l & 3 of line l >> 2 of each step.  The launcher gives every
// warp one run; the grid-stride loop takes any grid, and ptxas schedules
// this form faster on 1 GiB than the same body without the loop.
__global__ void __launch_bounds__(SEQ_THREADS)
line_toggles_seq_kernel(const uint4* __restrict__ lines, int* __restrict__ out,
                        long long n, long long n_runs) {
  const int lane = threadIdx.x & 31;
  const int quarter = lane & 3;
  const long long sub = lane >> 2;
  const int from = (lane + 28) & 31;            // the lane 4 below
  const long long warps = (long long)gridDim.x * (SEQ_THREADS / 32);
  for (long long run =
           ((long long)blockIdx.x * SEQ_THREADS + threadIdx.x) >> 5;
       run < n_runs; run += warps) {
    const long long base = run * SEQ_RUN;
    uint4 carry = make_uint4(0u, 0u, 0u, 0u);   // lanes 0-3: the line before
    if (lane < 4 && base > 0)
      carry = __ldcs(lines + (base - 1) * 4 + quarter);
    uint4 v[SEQ_UNROLL];
#pragma unroll
    for (int j = 0; j < SEQ_UNROLL; ++j) {
      const long long line = base + 8 * j + sub;
      v[j] = line < n ? __ldcs(lines + line * 4 + quarter)
                      : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int j = 0; j < SEQ_UNROLL; ++j) {
      const uint4 rot = shfl4(v[j], from);
      const int c = repro::quad_sum(
          repro::popc4(repro::xor4(v[j], lane < 4 ? carry : rot)));
      carry = rot;
      const long long line = base + 8 * j + sub;
      if (quarter == 0 && line < n) out[line] = line == 0 ? 0 : c;
    }
  }
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

extern "C" int repro_line_toggles_seq(const void* lines, void* out,
                                      long long n, void* stream) {
  if (n > 0) {
    const long long n_runs = (n + SEQ_RUN - 1) / SEQ_RUN;
    const long long warps_per_block = SEQ_THREADS / 32;
    const long long blocks = (n_runs + warps_per_block - 1) / warps_per_block;
    line_toggles_seq_kernel<<<(unsigned)blocks, SEQ_THREADS, 0,
                              (cudaStream_t)stream>>>(
        (const uint4*)lines, (int*)out, n, n_runs);
  }
  return (int)cudaGetLastError();
}
