// The datasheet-baseline (Micron calculator, DRAMPower) charge kernel,
// mean and surface variants, templated on the baseline KIND.
//
// Replaces: repro/kernels/baseline_energy/baseline_energy.py
//   baseline_energy_pallas with _make_kernel(kind) (mean/range/distribution)
//   and _make_surface_kernel(kind) (surface), over _masked_charge.
// Computes, per command of every (trace, vendor) pair, from the vendor's
//   10-entry IDD row (IDD0, IDD2N, IDD2P1, IDD3N, IDD4R, IDD4W, IDD5B,
//   IDD2P0, IDD3P, IDD6):
//   micron:    IDD3N worst-case background (LUT in low-power states),
//              ACT/PRE at the spec rate any_act * q_act * dt / tRC while
//              powered up, IDD4R/IDD4W per burst stacked on top;
//   drampower: IDD2N + (IDD3N - IDD2N) * open / 8, the ACT pair charge per
//              ACT, (IDD4R/W - bg) per burst;
//   both: REF (IDD5B - IDD2N) * tRFC, times the weight.  q_act is
//   act_pair_charge, worked out once per block.  Outputs as in
//   vampire_energy.cu: (V, T, chunks) or (V, T, chunks, 64) partials.
// Bound on the H100: bytes (7 words per command in, ~15 flops per vendor).
// Design: as vampire_energy.cu.  The IDD row and q_act sit in shared
//   memory, any_act is one float per trace, the open-bank count is the
//   popcount of the packed state word's mask.
#include "common.cuh"

namespace {

using namespace repro;

constexpr int MICRON = 0, DRAMPOWER = 1;
constexpr int N_IDD = 10;
enum { IDD0, IDD2N, IDD2P1, IDD3N, IDD4R, IDD4W, IDD5B, IDD2P0, IDD3P, IDD6 };

template <int KIND>
__device__ __forceinline__ float masked_charge(const float* idd, float q_act,
                                               float any_act, int c, int dti,
                                               int st, float w) {
  const int bg = bg_state(st);
  const float dt = (float)dti;
  const float i_low = bg == 1 ? idd[IDD2P1]
                              : bg == 2 ? idd[IDD2P0]
                                        : bg == 3 ? idd[IDD3P] : idd[IDD6];
  const float burst = fminf(dt, T_BURST);
  float charge;
  if (KIND == MICRON) {
    const float i_bg = bg == 0 ? idd[IDD3N] : i_low;
    charge = i_bg * dt;
    if (bg == 0 && any_act != 0.0f) charge = charge + q_act * dt / T_RC;
    if (c == RD) charge = charge + idd[IDD4R] * burst;
    if (c == WR) charge = charge + idd[IDD4W] * burst;
  } else {
    const float open = (float)__popc(open_mask(st));
    const float i_bg =
        bg == 0 ? idd[IDD2N] + (idd[IDD3N] - idd[IDD2N]) * open / 8.0f : i_low;
    charge = i_bg * dt;
    if (c == ACT) charge = charge + q_act;
    if (c == RD) charge = charge + (idd[IDD4R] - i_bg) * burst;
    if (c == WR) charge = charge + (idd[IDD4W] - i_bg) * burst;
  }
  if (c == REF) charge = charge + (idd[IDD5B] - idd[IDD2N]) * T_RFC;
  return charge * w;
}

template <int KIND, bool SURFACE>
__global__ void __launch_bounds__(THREADS)
baseline_charge_kernel(const int* __restrict__ cmd,
                       const int* __restrict__ bank,
                       const int* __restrict__ row, const int* __restrict__ dt,
                       const int* __restrict__ state,
                       const float* __restrict__ w,
                       const float* __restrict__ any_act,
                       const float* __restrict__ table, float* __restrict__ out,
                       int n_traces, int n_cmds, int n_chunks) {
  __shared__ float idd[N_IDD + 1];
  __shared__ float sred[SURFACE ? CHUNK : THREADS];
  __shared__ unsigned char scell[SURFACE ? CHUNK : 1];
  __shared__ float squarter[SURFACE ? THREADS : 1];
  const int chunk = blockIdx.x, t = blockIdx.y, v = blockIdx.z;
  if (threadIdx.x < N_IDD) idd[threadIdx.x] = table[v * N_IDD + threadIdx.x];
  __syncthreads();
  if (threadIdx.x == 0)  // act_pair_charge (baselines_power.py)
    idd[N_IDD] = fmaxf((idd[IDD0] - (idd[IDD3N] * T_RAS + idd[IDD2N] * T_RP) /
                                        T_RC) * T_RC,
                       0.0f);
  __syncthreads();
  const float q_act = idd[N_IDD];
  const float act = any_act[t];

  const long long base = (long long)t * n_cmds;
  float acc = 0.0f;
#pragma unroll
  for (int k = 0; k < PER_THREAD; ++k) {
    const int slot = k * THREADS + threadIdx.x;
    const int j = chunk * CHUNK + slot;
    float cw = 0.0f;
    int cell = 0;
    if (j < n_cmds) {
      const long long g = base + j;
      cw = masked_charge<KIND>(idd, q_act, act, cmd[g], dt[g], state[g], w[g]);
      if (SURFACE) cell = cell_of(bank[g], row[g]);
    }
    if (SURFACE) {
      sred[slot] = cw;
      scell[slot] = (unsigned char)cell;
    } else {
      acc += cw;
    }
  }
  const long long o = ((long long)v * n_traces + t) * n_chunks + chunk;
  if (SURFACE) {
    __syncthreads();
    cell_sums(sred, scell, squarter, out + o * N_CELLS);
  } else {
    const float total = block_sum(acc, sred);
    if (threadIdx.x == 0) out[o] = total;
  }
}

template <int KIND, bool SURFACE>
int launch(const void* cmd, const void* bank, const void* row, const void* dt,
           const void* state, const void* w, const void* any_act,
           const void* table, void* out, int n_traces, int n_cmds,
           int n_vendors, void* stream) {
  const int n_chunks = (n_cmds + CHUNK - 1) / CHUNK;
  if (n_traces > 0 && n_vendors > 0 && n_chunks > 0) {
    dim3 grid(n_chunks, n_traces, n_vendors);
    baseline_charge_kernel<KIND, SURFACE>
        <<<grid, THREADS, 0, (cudaStream_t)stream>>>(
            (const int*)cmd, (const int*)bank, (const int*)row,
            (const int*)dt, (const int*)state, (const float*)w,
            (const float*)any_act, (const float*)table, (float*)out,
            n_traces, n_cmds, n_chunks);
  }
  return (int)cudaGetLastError();
}

}  // namespace

#define REPRO_BASELINE_ENTRY(NAME, KIND, SURFACE)                             \
  extern "C" int NAME(const void* cmd, const void* bank, const void* row,     \
                      const void* dt, const void* state, const void* w,       \
                      const void* any_act, const void* table, void* out,      \
                      int n_traces, int n_cmds, int n_vendors, void* stream) { \
    return launch<KIND, SURFACE>(cmd, bank, row, dt, state, w, any_act,       \
                                 table, out, n_traces, n_cmds, n_vendors,     \
                                 stream);                                     \
  }

REPRO_BASELINE_ENTRY(repro_micron_charge, MICRON, false)
REPRO_BASELINE_ENTRY(repro_micron_charge_surface, MICRON, true)
REPRO_BASELINE_ENTRY(repro_drampower_charge, DRAMPOWER, false)
REPRO_BASELINE_ENTRY(repro_drampower_charge_surface, DRAMPOWER, true)
