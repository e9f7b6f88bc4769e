// The per-vendor VAMPIRE charge kernel, mean and surface instances.
//
// Replaces: repro/kernels/vampire_energy/vampire_energy.py
//   batched_energy_pallas with _energy_kernel (mode mean/range/distribution)
//   and with _surface_kernel (mode surface), both over _masked_charge.
// Computes, per command of every (trace, vendor) pair: the background
//   current from the background-state LUT or i2n + the open banks' deltas;
//   paper Eq. 2's (interleave mode, op) coefficients over ones and toggles
//   with the ones_quad curvature, times the bank read/write factor, plus
//   the I/O current; the integrator bg*dt + burst crediting +
//   ACT*(1 + slope*row_ones)*act_surface[bank][band] + REF; times the
//   weight.  Mean: the (T, V) sums.  Surface: the (T, V, 64) sums per
//   (bank, row-band) cell.
// Bound on the H100: bytes.  Per command it reads 8 words (ones, togg,
//   cmd, bank, row, dt, state, w: 32 B) and does ~40 flops per vendor;
//   with V = 3 the bytes bound it.  What holds it back on the card: a
//   ~5 us launch floor and the cluster's start and finish (~2 us), and
//   ~30 instructions per command and vendor; with the L2 left dirty by
//   the timing's flush, the reads also write back as many bytes.
// Design: compact per-command inputs instead of the TPU assembler's
//   planes: the raw cmd/bank/row/dt fields, one packed state word (mode,
//   background state, open-bank mask) in place of the (T,8,N) bank/open
//   float planes, and the (bank, row-band) cell worked out from bank and
//   row here, so act_surface is gathered from shared memory and the
//   (V,T,N) surface plane is never built.  charge.cuh's kernel reads each
//   command once for a whole group of up to 32 vendors (cp.async, 16
//   bytes a plane, staged two steps ahead), one tile of a trace per block
//   and a trace per cluster; each command is decoded once for all vendors
//   and charged without branches; the vendor rows sit in shared memory
//   with a 260-entry background table each (i2n plus the open banks'
//   deltas for every mask, added in bank order as the TPU kernel adds
//   them, and the low-power currents), 47.9 KB for a group of 32.  It adds
//   the mean per thread and the surface in per-warp cell bins (O(1) per
//   command per vendor), then sums the tiles inside the kernel through
//   distributed shared memory.  One launch writes the output; the sums
//   are in a fixed order, so two runs give the same bits.
#include "charge.cuh"

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

// the background table after each vendor's row: [open mask] for state 0
// (i2n + the open banks' deltas), [255 + state] for the low-power states
constexpr int P_BG = P_SIZE;
constexpr int N_BG = 256 + 4;
constexpr int P_SMEM = P_SIZE + N_BG;
enum { K_OTHER = 0, K_RW = 1, K_ACT = 2, K_REF = 3 };

// One command as every vendor sees it: its floats, and its table offsets
// and class, worked out once per command.
struct Command {
  float ones, togg, w, dt, iof, rowones;
  int bgi, co, fo, io, cell, kind;
};

__device__ __forceinline__ Command decode_cmd(float ones, float togg,
                                              int c, int b, int r, int dti,
                                              int st, float w) {
  Command d;
  const int bg = bg_state(st);
  const int op = c == WR;
  d.ones = ones;
  d.togg = togg;
  d.w = w;
  d.dt = (float)dti;
  d.iof = op ? LINE_BITS - ones : ones;
  d.rowones = (float)__popc(r);
  d.bgi = bg == 0 ? open_mask(st) : 255 + min(bg, 4);
  d.co = P_COEFFS + (il_mode(st) * 2 + op) * 3;
  d.fo = P_BVEC + (op ? 16 : 8) + (b & 7);
  d.io = P_SCAL + (op ? S_IOW : S_IOR);
  d.cell = cell_of(b, r);
  d.kind = (c == RD || c == WR) ? K_RW
           : c == ACT            ? K_ACT
           : c == REF            ? K_REF
                                 : K_OTHER;
  return d;
}

// The background table of the vendor row at sv, the arithmetic of the TPU
// kernel's background current: i2n + the deltas of the open banks, added
// in bank order, or the low-power state's current.
__device__ __forceinline__ float background(const float* sv, int e) {
  const float* sc = sv + P_SCAL;
  if (e < 256) {
    float delta = 0.0f;
    for (int k = 0; k < 8; ++k)
      if ((e >> k) & 1) delta += sv[P_BVEC + k];
    return sc[S_I2N] + delta;
  }
  const int bg = e - 255;
  return bg == 1 ? sc[S_IPD]
                 : bg == 2 ? sc[S_IPD_SLOW]
                           : bg == 3 ? sc[S_IACTPD] : sc[S_ISR];
}

struct Scalars {
  float quad, qact, slope, qref;
};

// The masked charge of one command for the vendor row at sv: the
// background current times dt, burst crediting of the (mode, op)
// coefficients over ones and toggles with the ones_quad curvature, the
// bank factor and the I/O current for RD/WR, the ACT charge with its
// row-ones slope and (bank, row-band) factor, the REF charge; times the
// weight.  Every class is worked out and the command's is kept, so the
// lanes of a warp do not diverge.
__device__ __forceinline__ float masked_charge(const float* sv,
                                               const Scalars& u,
                                               const Command& d) {
  const float i_bg = sv[P_BG + d.bgi];
  const float charge = i_bg * d.dt;
  const float* cf = sv + d.co;
  float base = cf[0] + cf[1] * d.ones + cf[2] * d.togg;
  base = base + u.quad * cf[1] * d.ones * (d.ones / LINE_BITS - 0.5f);
  const float fac = sv[d.fo];
  const float io = sv[d.io] * d.iof;
  const float i_rw = base * fac + io;
  const float rw = charge + (i_rw - i_bg) * fminf(d.dt, T_BURST);
  const float act =
      charge + u.qact * (1.0f + u.slope * d.rowones) * sv[P_SURF + d.cell];
  const float ref = charge + u.qref;
  const float out = d.kind == K_RW    ? rw
                    : d.kind == K_ACT ? act
                    : d.kind == K_REF ? ref
                                      : charge;
  return out * d.w;
}

// The VAMPIRE side of charge.cuh's kernel: eight per-command planes; each
// vendor's packed parameter row and background table in shared memory.
struct Vampire {
  static constexpr int P = P_SMEM;
  static constexpr int PLANES = 8;
  using Dec = Command;
  using Vend = Scalars;
  struct Args {
    const float *ones, *togg;
    const int *cmd, *bank, *row, *dt, *state;
    const float *w, *params;
  };
  struct Cmds {
    float ones[4], togg[4], w[4];
    int cmd[4], bank[4], row[4], dt[4], st[4];
  };
  __device__ static void load_params(float* sp, const Args& a, int g0,
                                     int vg) {
    for (int i = threadIdx.x; i < vg * P_SIZE; i += CT)
      sp[(i / P_SIZE) * P + i % P_SIZE] = a.params[(long long)g0 * P_SIZE + i];
    __syncthreads();
    for (int i = threadIdx.x; i < vg * N_BG; i += CT) {
      float* sv = sp + (i / N_BG) * P;
      sv[P_BG + i % N_BG] = background(sv, i % N_BG);
    }
    __syncthreads();
  }
  __device__ static float trace_scalar(const Args&, int) { return 0.0f; }
  __device__ static const int* plane(const Args& a, int p) {
    switch (p) {
      case 0: return reinterpret_cast<const int*>(a.ones);
      case 1: return reinterpret_cast<const int*>(a.togg);
      case 2: return a.cmd;
      case 3: return a.bank;
      case 4: return a.row;
      case 5: return a.dt;
      case 6: return a.state;
      default: return reinterpret_cast<const int*>(a.w);
    }
  }
  __device__ static void unpack(Cmds& c, int p, const int4 v) {
    switch (p) {
      case 0: unpack4(v, c.ones); break;
      case 1: unpack4(v, c.togg); break;
      case 2: unpack4(v, c.cmd); break;
      case 3: unpack4(v, c.bank); break;
      case 4: unpack4(v, c.row); break;
      case 5: unpack4(v, c.dt); break;
      case 6: unpack4(v, c.st); break;
      default: unpack4(v, c.w); break;
    }
  }
  __device__ static Dec decode(const Cmds& c, int k, float) {
    return decode_cmd(c.ones[k], c.togg[k], c.cmd[k], c.bank[k], c.row[k],
                      c.dt[k], c.st[k], c.w[k]);
  }
  __device__ static int cell(const Dec& d) { return d.cell; }
  __device__ static Vend vendor(const float* sv) {
    const float* sc = sv + P_SCAL;
    return Vend{sc[S_QUAD], sc[S_QACT], sc[S_SLOPE], sc[S_QREF]};
  }
  __device__ static float charge(const float* sv, const Vend& u,
                                 const Dec& d) {
    return masked_charge(sv, u, d);
  }
};

template <bool SURFACE>
int launch(const void* ones, const void* togg, const void* cmd,
           const void* bank, const void* row, const void* dt,
           const void* state, const void* w, const void* params, void* out,
           int n_traces, int n_cmds, int n_vendors, int cluster, int group,
           int phase, void* stream) {
  const Vampire::Args a{(const float*)ones, (const float*)togg,
                        (const int*)cmd,    (const int*)bank,
                        (const int*)row,    (const int*)dt,
                        (const int*)state,  (const float*)w,
                        (const float*)params};
  return launch_charge<Vampire, SURFACE>(a, out, n_traces, n_cmds, n_vendors,
                                         cluster, group, phase, stream);
}

}  // namespace

extern "C" int repro_vampire_charge(const void* ones, const void* togg,
                                    const void* cmd, const void* bank,
                                    const void* row, const void* dt,
                                    const void* state, const void* w,
                                    const void* params, void* out,
                                    int n_traces, int n_cmds, int n_vendors,
                                    int cluster, int group, int phase,
                                    void* stream) {
  return launch<false>(ones, togg, cmd, bank, row, dt, state, w, params, out,
                       n_traces, n_cmds, n_vendors, cluster, group, phase,
                       stream);
}

extern "C" int repro_vampire_charge_surface(
    const void* ones, const void* togg, const void* cmd, const void* bank,
    const void* row, const void* dt, const void* state, const void* w,
    const void* params, void* out, int n_traces, int n_cmds, int n_vendors,
    int cluster, int group, int phase, void* stream) {
  return launch<true>(ones, togg, cmd, bank, row, dt, state, w, params, out,
                      n_traces, n_cmds, n_vendors, cluster, group, phase,
                      stream);
}
