// The datasheet-baseline (Micron calculator, DRAMPower) charge kernel,
// mean and surface instances, templated on the baseline KIND.
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
//   act_pair_charge, worked out once per vendor and block.  Outputs: the
//   (T, V) sums, or the (T, V, 64) sums per (bank, row-band) cell.
// Bound on the H100: bytes.  Per command it reads 4 words (cmd, dt, state,
//   w), 6 for the surface (+ bank, row), and does ~15 flops per vendor.
//   What holds it back on the card: as vampire_energy.cu, the launch
//   floor and the cluster's start and finish are half of the time at the
//   estimation batch's 16 MB.
// Design: charge.cuh's kernel, as vampire_energy.cu: each command is read
//   once (cp.async, staged two steps ahead for the mean, one for the
//   surface) for a group of up to 32 vendors (16 floats each in shared
//   memory: the IDD row, act_pair_charge and the background current by
//   state), decoded once and charged without branches; the tiles of a
//   trace are one cluster's blocks and their partials are summed in rank
//   order inside the kernel; the surface adds into per-warp cell bins,
//   O(1) per command per vendor.  The open-bank count is the popcount of
//   the packed state word's mask.
#include "charge.cuh"

namespace {

using namespace repro;

constexpr int MICRON = 0, DRAMPOWER = 1;
constexpr int N_IDD = 10;
enum { IDD0, IDD2N, IDD2P1, IDD3N, IDD4R, IDD4W, IDD5B, IDD2P0, IDD3P, IDD6 };

// each vendor's shared-memory row: the IDD row, act_pair_charge, then the
// background current by state (micron: IDD3N in state 0), as the LUT of
// the low-power states reads it
constexpr int P_QACT = N_IDD;
constexpr int P_BG = N_IDD + 1;
constexpr int P_SMEM = P_BG + 5;

// One command as every vendor sees it, worked out once per command.
struct Command {
  float dt, w, open;
  int bgi, cmd, cell;
  bool spec;      // micron: powered up in a trace with an ACT
};

struct Scalars {
  float idd2n, idd3n, idd4r, idd4w, idd5b, q_act;
};

// The masked charge of one command for the vendor row at idd: the
// arithmetic of the TPU kernel's _masked_charge, each class worked out
// and the command's kept, so the lanes of a warp do not diverge.
template <int KIND>
__device__ __forceinline__ float masked_charge(const float* idd,
                                               const Scalars& u,
                                               const Command& d) {
  const float dt = d.dt;
  const float i_low = idd[P_BG + d.bgi];
  const float burst = fminf(dt, T_BURST);
  float charge;
  if (KIND == MICRON) {
    const float i_bg = i_low;     // IDD3N in state 0
    charge = i_bg * dt;
    const float spec = charge + u.q_act * dt / T_RC;
    charge = d.spec ? spec : charge;
    const float rd = charge + u.idd4r * burst;
    const float wr = charge + u.idd4w * burst;
    charge = d.cmd == RD ? rd : d.cmd == WR ? wr : charge;
  } else {
    const float i_bg =
        d.bgi == 0 ? u.idd2n + (u.idd3n - u.idd2n) * d.open / 8.0f : i_low;
    charge = i_bg * dt;
    const float act = charge + u.q_act;
    const float rd = charge + (u.idd4r - i_bg) * burst;
    const float wr = charge + (u.idd4w - i_bg) * burst;
    charge = d.cmd == ACT ? act : d.cmd == RD ? rd : d.cmd == WR ? wr : charge;
  }
  const float ref = charge + (u.idd5b - u.idd2n) * T_RFC;
  return (d.cmd == REF ? ref : charge) * d.w;
}

// The baseline side of charge.cuh's kernel: the group's IDD rows,
// act_pair_charge (baselines_power.py) and background currents in shared
// memory, any_act per trace; bank and row are read only when CELLS (the
// surface).
template <int KIND, bool CELLS>
struct Baseline {
  static constexpr int P = P_SMEM;
  // cmd, dt, state, w (+ bank, row); the mean stages 2 steps (32 KB)
  static constexpr int PLANES = CELLS ? 6 : 4;
  using Dec = Command;
  using Vend = Scalars;
  struct Args {
    const int *cmd, *bank, *row, *dt, *state;
    const float *w, *any_act, *table;
  };
  struct Cmds {
    float w[4];
    int cmd[4], bank[4], row[4], dt[4], st[4];
  };
  __device__ static void load_params(float* sp, const Args& a, int g0,
                                     int vg) {
    for (int i = threadIdx.x; i < vg * N_IDD; i += CT)
      sp[(i / N_IDD) * P + i % N_IDD] = a.table[(long long)g0 * N_IDD + i];
    __syncthreads();
    for (int v = threadIdx.x; v < vg; v += CT) {
      float* idd = sp + v * P;
      idd[P_QACT] = fmaxf((idd[IDD0] - (idd[IDD3N] * T_RAS +
                                         idd[IDD2N] * T_RP) / T_RC) * T_RC,
                          0.0f);
      idd[P_BG] = KIND == MICRON ? idd[IDD3N] : 0.0f;
      idd[P_BG + 1] = idd[IDD2P1];
      idd[P_BG + 2] = idd[IDD2P0];
      idd[P_BG + 3] = idd[IDD3P];
      idd[P_BG + 4] = idd[IDD6];
    }
    __syncthreads();
  }
  __device__ static float trace_scalar(const Args& a, int t) {
    return a.any_act[t];
  }
  __device__ static const int* plane(const Args& a, int p) {
    switch (p) {
      case 0: return a.cmd;
      case 1: return a.dt;
      case 2: return a.state;
      case 3: return reinterpret_cast<const int*>(a.w);
      case 4: return a.bank;
      default: return a.row;
    }
  }
  __device__ static void unpack(Cmds& c, int p, const int4 v) {
    switch (p) {
      case 0: unpack4(v, c.cmd); break;
      case 1: unpack4(v, c.dt); break;
      case 2: unpack4(v, c.st); break;
      case 3: unpack4(v, c.w); break;
      case 4: unpack4(v, c.bank); break;
      default: unpack4(v, c.row); break;
    }
  }
  __device__ static Dec decode(const Cmds& c, int k, float any_act) {
    Dec d;
    const int bg = bg_state(c.st[k]);
    d.dt = (float)c.dt[k];
    d.w = c.w[k];
    d.open = (float)__popc(open_mask(c.st[k]));
    d.bgi = min(bg, 4);
    d.cmd = c.cmd[k];
    d.cell = CELLS ? cell_of(c.bank[k], c.row[k]) : 0;
    d.spec = bg == 0 && any_act != 0.0f;
    return d;
  }
  __device__ static int cell(const Dec& d) { return d.cell; }
  __device__ static Vend vendor(const float* idd) {
    return Vend{idd[IDD2N], idd[IDD3N], idd[IDD4R], idd[IDD4W], idd[IDD5B],
                idd[P_QACT]};
  }
  __device__ static float charge(const float* idd, const Vend& u,
                                 const Dec& d) {
    return masked_charge<KIND>(idd, u, d);
  }
};

template <int KIND, bool SURFACE>
int launch(const void* cmd, const void* bank, const void* row, const void* dt,
           const void* state, const void* w, const void* any_act,
           const void* table, void* out, int n_traces, int n_cmds,
           int n_vendors, int cluster, int group, int phase,
           void* stream) {
  using Pol = Baseline<KIND, SURFACE>;
  const typename Pol::Args a{(const int*)cmd,   (const int*)bank,
                             (const int*)row,   (const int*)dt,
                             (const int*)state, (const float*)w,
                             (const float*)any_act, (const float*)table};
  return launch_charge<Pol, SURFACE>(a, out, n_traces, n_cmds, n_vendors,
                                     cluster, group, phase, stream);
}

}  // namespace

#define REPRO_BASELINE_ENTRY(NAME, KIND, SURFACE)                          \
  extern "C" int NAME(const void* cmd, const void* bank, const void* row,  \
                      const void* dt, const void* state, const void* w,    \
                      const void* any_act, const void* table, void* out,   \
                      int n_traces, int n_cmds, int n_vendors, int cluster, \
                      int group, int phase, void* stream) {                \
    return launch<KIND, SURFACE>(cmd, bank, row, dt, state, w, any_act,    \
                                 table, out, n_traces, n_cmds, n_vendors,  \
                                 cluster, group, phase, stream);           \
  }

REPRO_BASELINE_ENTRY(repro_micron_charge, MICRON, false)
REPRO_BASELINE_ENTRY(repro_micron_charge_surface, MICRON, true)
REPRO_BASELINE_ENTRY(repro_drampower_charge, DRAMPOWER, false)
REPRO_BASELINE_ENTRY(repro_drampower_charge_surface, DRAMPOWER, true)
