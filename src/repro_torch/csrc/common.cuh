// Shared constants and helpers of the kernels (DDR3L-800 command codes and
// timing, the per-command state packing and (bank, row-band) cell, and the
// per-line bit counts of the line kernels).
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

namespace repro {

// command codes (repro_torch/core/dram.py)
constexpr int ACT = 1, PRE = 2, RD = 3, WR = 4, REF = 5;
constexpr int PDE = 6, PDX = 7, PREA = 8, PDE_SLOW = 9, SRE = 10, SRX = 11;
// background states and interleave modes (core/energy_model.py, dram.py)
constexpr int BG_ACTIVE = 0, BG_PDN_FAST = 1, BG_PDN_SLOW = 2,
              BG_PDN_ACT = 3, BG_SR = 4;
constexpr int IL_NONE = 0, IL_COL = 1, IL_BANK = 2, IL_BANKCOL = 3;
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
