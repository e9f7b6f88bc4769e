// The per-vendor VAMPIRE charge kernel, mean and surface variants.
//
// Replaces: repro/kernels/vampire_energy/vampire_energy.py
//   batched_energy_pallas with _energy_kernel (mode mean/range/distribution)
//   and with _surface_kernel (mode surface), both over _masked_charge.
// Computes, per command of every (trace, vendor) pair: the background
//   current from the background-state LUT or i2n + the open banks' deltas;
//   paper Eq. 2's (interleave mode, op) coefficients over ones and toggles
//   with the ones_quad curvature, times the bank read/write factor, plus
//   the I/O-driver current; the integrator bg*dt + burst crediting +
//   ACT*(1 + slope*row_ones)*act_surface[bank][band] + REF; times the
//   weight.  Mean: one partial sum per block -> out (V, T, chunks).
//   Surface: one partial per (bank, row-band) cell -> out (V, T, chunks, 64).
//   The partials are summed over chunks outside, as the TPU kernel's are.
// Bound on the H100: bytes.  Per command it reads 8 words (ones, togg,
//   cmd, bank, row, dt, state, w: 32 B) and does ~40 flops per vendor.
// Design: compact per-command inputs instead of the TPU assembler's
//   planes: the raw cmd/bank/row/dt fields, one packed state word (mode,
//   background state, open-bank mask) in place of the (T,8,N) bank/open
//   float planes, and the (bank, row-band) cell worked out from bank and
//   row here, so act_surface is gathered from shared memory and the
//   (V,T,N) surface plane is never built.  The vendor's 123 parameters
//   live in shared memory.  One block per (chunk of 1024 commands, trace,
//   vendor); each of its 256 threads takes 4 of the chunk's commands,
//   strided so that every load coalesces.  Deterministic reductions, no
//   atomics: a fixed tree for the mean, and for the surface each thread
//   sums one cell over one quarter of the chunk in index order.
#include "common.cuh"

namespace {

using namespace repro;

// layout of one vendor's packed parameter row (ops.pack_param_blocks)
constexpr int P_COEFFS = 0;     // 24: datadep[mode][op][3]
constexpr int P_SCAL = 24;      // 11: see the S_* offsets
constexpr int P_BVEC = 35;      // 24: open delta[8], read fac[8], write fac[8]
constexpr int P_SURF = 59;      // 64: act_surface[bank][band]
constexpr int P_SIZE = 123;
constexpr int S_I2N = 0, S_QACT = 1, S_SLOPE = 2, S_QREF = 3, S_IPD = 4,
              S_IOR = 5, S_IOW = 6, S_QUAD = 7, S_IPD_SLOW = 8, S_IACTPD = 9,
              S_ISR = 10;

__device__ __forceinline__ float masked_charge(const float* sp, float ones,
                                               float togg, int c, int b,
                                               int r, int dti, int st,
                                               float w) {
  const float* sc = sp + P_SCAL;
  const int bg = bg_state(st);
  const float dt = (float)dti;
  float i_bg;
  if (bg == 0) {
    const int open = open_mask(st);
    float delta = 0.0f;
#pragma unroll
    for (int k = 0; k < 8; ++k)
      if ((open >> k) & 1) delta += sp[P_BVEC + k];
    i_bg = sc[S_I2N] + delta;
  } else {
    i_bg = bg == 1 ? sc[S_IPD]
                   : bg == 2 ? sc[S_IPD_SLOW]
                             : bg == 3 ? sc[S_IACTPD] : sc[S_ISR];
  }
  float charge = i_bg * dt;
  if (c == RD || c == WR) {
    const int op = c == WR;
    const float* cf = sp + P_COEFFS + (il_mode(st) * 2 + op) * 3;
    float base = cf[0] + cf[1] * ones + cf[2] * togg;
    base = base + sc[S_QUAD] * cf[1] * ones * (ones / LINE_BITS - 0.5f);
    const float fac = sp[P_BVEC + (op ? 16 : 8) + (b & 7)];
    const float io = op ? sc[S_IOW] * (LINE_BITS - ones) : sc[S_IOR] * ones;
    const float i_rw = base * fac + io;
    charge = charge + (i_rw - i_bg) * fminf(dt, T_BURST);
  } else if (c == ACT) {
    charge = charge + sc[S_QACT] * (1.0f + sc[S_SLOPE] * (float)__popc(r)) *
                          sp[P_SURF + cell_of(b, r)];
  } else if (c == REF) {
    charge = charge + sc[S_QREF];
  }
  return charge * w;
}

template <bool SURFACE>
__global__ void __launch_bounds__(THREADS)
vampire_charge_kernel(const float* __restrict__ ones,
                      const float* __restrict__ togg,
                      const int* __restrict__ cmd, const int* __restrict__ bank,
                      const int* __restrict__ row, const int* __restrict__ dt,
                      const int* __restrict__ state,
                      const float* __restrict__ w,
                      const float* __restrict__ params,
                      float* __restrict__ out, int n_traces, int n_cmds,
                      int n_chunks) {
  __shared__ float sp[P_SIZE];
  __shared__ float sred[SURFACE ? CHUNK : THREADS];
  __shared__ unsigned char scell[SURFACE ? CHUNK : 1];
  __shared__ float squarter[SURFACE ? THREADS : 1];
  const int chunk = blockIdx.x, t = blockIdx.y, v = blockIdx.z;
  for (int i = threadIdx.x; i < P_SIZE; i += THREADS)
    sp[i] = params[(long long)v * P_SIZE + i];
  __syncthreads();

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
      const int b = bank[g], r = row[g];
      cw = masked_charge(sp, ones[g], togg[g], cmd[g], b, r, dt[g], state[g],
                         w[g]);
      cell = cell_of(b, r);
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

template <bool SURFACE>
int launch(const void* ones, const void* togg, const void* cmd,
           const void* bank, const void* row, const void* dt,
           const void* state, const void* w, const void* params, void* out,
           int n_traces, int n_cmds, int n_vendors, void* stream) {
  const int n_chunks = (n_cmds + CHUNK - 1) / CHUNK;
  if (n_traces > 0 && n_vendors > 0 && n_chunks > 0) {
    dim3 grid(n_chunks, n_traces, n_vendors);
    vampire_charge_kernel<SURFACE><<<grid, THREADS, 0, (cudaStream_t)stream>>>(
        (const float*)ones, (const float*)togg, (const int*)cmd,
        (const int*)bank, (const int*)row, (const int*)dt, (const int*)state,
        (const float*)w, (const float*)params, (float*)out, n_traces, n_cmds,
        n_chunks);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int repro_vampire_charge(const void* ones, const void* togg,
                                    const void* cmd, const void* bank,
                                    const void* row, const void* dt,
                                    const void* state, const void* w,
                                    const void* params, void* out,
                                    int n_traces, int n_cmds, int n_vendors,
                                    void* stream) {
  return launch<false>(ones, togg, cmd, bank, row, dt, state, w, params, out,
                       n_traces, n_cmds, n_vendors, stream);
}

extern "C" int repro_vampire_charge_surface(
    const void* ones, const void* togg, const void* cmd, const void* bank,
    const void* row, const void* dt, const void* state, const void* w,
    const void* params, void* out, int n_traces, int n_cmds, int n_vendors,
    void* stream) {
  return launch<true>(ones, togg, cmd, bank, row, dt, state, w, params, out,
                      n_traces, n_cmds, n_vendors, stream);
}
