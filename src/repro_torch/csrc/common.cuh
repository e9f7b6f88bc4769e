// Shared constants and helpers of the kernels (DDR3L-800 command codes and
// timing, the per-command state packing, the reduction geometry, and the
// per-line bit counts of the line kernels).
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

namespace repro {

// command codes (repro_torch/core/dram.py)
constexpr int ACT = 1, PRE = 2, RD = 3, WR = 4, REF = 5;
// DDR3L-800 timing in clocks
constexpr float T_BURST = 4.0f, T_RC = 20.0f, T_RAS = 14.0f, T_RP = 6.0f,
                T_RFC = 64.0f;
constexpr float LINE_BITS = 512.0f;
constexpr int N_CELLS = 64;          // 8 banks x 8 row bands
constexpr int ROW_BAND_SHIFT = 12;

// per-command state word (ops.pack_state):
//   bits 0-1 interleave mode, bits 2-4 background state, bits 8-15 the
//   open-bank mask before the command
__device__ __forceinline__ int il_mode(int st) { return st & 3; }
__device__ __forceinline__ int bg_state(int st) { return (st >> 2) & 7; }
__device__ __forceinline__ int open_mask(int st) { return (st >> 8) & 0xff; }
__device__ __forceinline__ int cell_of(int bank, int row) {
  return ((bank & 7) << 3) | ((row >> ROW_BAND_SHIFT) & 7);
}

// One block covers CHUNK commands of one (trace, vendor) pair with
// THREADS threads, PER_THREAD commands each (strided, so loads coalesce).
constexpr int THREADS = 256;
constexpr int CHUNK = 1024;
constexpr int PER_THREAD = CHUNK / THREADS;

// Deterministic block reductions of the per-command masked charges.
// Mean: each thread sums its commands in order, then a fixed tree.
__device__ __forceinline__ float block_sum(float acc, float* sred) {
  sred[threadIdx.x] = acc;
  __syncthreads();
  for (int s = THREADS / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s) sred[threadIdx.x] += sred[threadIdx.x + s];
    __syncthreads();
  }
  return sred[0];
}

// Surface: thread (cell c, quarter q) sums, in index order, the charges of
// cell c among commands [q*CHUNK/4, (q+1)*CHUNK/4) of the chunk; the four
// quarters are then added in order.  Needs scharge/scell filled for the
// whole chunk and THREADS == 4 * N_CELLS.
static_assert(THREADS == 4 * N_CELLS, "surface reduction geometry");
__device__ __forceinline__ void cell_sums(const float* scharge,
                                          const unsigned char* scell,
                                          float* squarter, float* out) {
  const int c = threadIdx.x & (N_CELLS - 1);
  const int q = threadIdx.x / N_CELLS;
  float s = 0.0f;
  for (int i = q * (CHUNK / 4); i < (q + 1) * (CHUNK / 4); ++i)
    if (scell[i] == c) s += scharge[i];
  squarter[threadIdx.x] = s;
  __syncthreads();
  if (threadIdx.x < N_CELLS)
    out[c] = ((squarter[c] + squarter[N_CELLS + c]) + squarter[2 * N_CELLS + c])
             + squarter[3 * N_CELLS + c];
}

// Per-line bit counts: four threads share a 64-byte line, each holding one
// 16-byte uint4 of it; popc4 counts one quarter, quad_sum adds the four
// quarters across the lanes (every lane must take part).
__device__ __forceinline__ int popc4(uint4 v) {
  return __popc(v.x) + __popc(v.y) + __popc(v.z) + __popc(v.w);
}
__device__ __forceinline__ uint4 xor4(uint4 a, uint4 b) {
  return make_uint4(a.x ^ b.x, a.y ^ b.y, a.z ^ b.z, a.w ^ b.w);
}
__device__ __forceinline__ int quad_sum(int v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  v += __shfl_xor_sync(0xffffffffu, v, 2);
  return v;
}

}  // namespace repro
