// The param-independent kernels of the estimation path: the feature kernel,
// with the previous RD/WR's line gathered inside it, and the state kernel
// (below), whose prev_rw it reads.
//
// Replaces: repro/kernels/vampire_energy/vampire_energy.py
//   batched_features_pallas (_features_kernel), the TPU's fused popcount /
//   bus-toggle pass over a padded batch's data stream, together with the
//   gather of the previous line that feeds it there (the reference's
//   structural_state prev_data and its toggle mask).
// Computes, per 64-byte line of a padded (T, N) batch (line = t * N + i):
//   ones[line] = popcount(data[line])
//   togg[line] = popcount(data[line] ^ data[t * N + prev_rw[line]]) when
//                cmd[line] is RD or WR and prev_rw[line] >= 0, else 0,
//   both as float32; prev_rw is the index of the previous RD/WR within the
//   same trace (-1 where there is none), and every line's ones is computed,
//   pad lines included.
// Bound on the H100: bytes.  A line needs data 64 B, cmd 4 B and prev_rw
//   4 B read and two float32 written: 80 B, against ~40 integer operations.
//   The TPU design read a materialised copy of the previous line (64 B
//   more a line, made by a gather, a select and a cast before the launch).
// Design: a block takes a tile of TILE lines plus the line before it,
//   staged into shared memory with 16-byte cp.async copies (four or five
//   a thread, neighbouring threads on neighbouring addresses), while
//   it loads its lines' cmd and prev_rw.  Four threads share a line, one
//   16-byte quarter each.  The previous RD/WR of a trace is nearly always
//   a few commands back, so its line is read from the tile in shared
//   memory; only where it lies before the tile (and its overlap line) is
//   it read from global memory, where the block before will have brought
//   it into L2.  The trace of a line comes from one division a thread at
//   the tile's start (a tile wraps a trace end by subtraction; only for
//   traces shorter than a tile does a line divide again).  Line indices
//   are 64-bit: T * N * 16 words can pass 2^31.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int TILE = 256;                   // lines a block takes
constexpr int QUARTERS = 4;                 // 16-byte quarters a line
constexpr int LINES_PER_PASS = THREADS / QUARTERS;
constexpr int PASSES = TILE / LINES_PER_PASS;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

__global__ void __launch_bounds__(THREADS)
features_kernel(const uint4* __restrict__ data, const int* __restrict__ cmd,
                const int* __restrict__ prev_rw, float* __restrict__ ones,
                float* __restrict__ togg, long long m, long long n) {
  // slot 0 holds the line before the tile, slot 1 + j the tile's line j
  __shared__ uint4 tile[(TILE + 1) * QUARTERS];
  const int tid = threadIdx.x;
  const int q = tid & (QUARTERS - 1);
  const long long first = (long long)blockIdx.x * TILE;
  const long long lo = first > 0 ? first - 1 : 0;   // first staged line
  const long long stop = first + TILE < m ? first + TILE : m;

  // stage [lo, stop) at slot (line - first + 1)
  for (long long c = (lo - first + 1) * QUARTERS + tid;
       c < (stop - first + 1) * QUARTERS; c += THREADS) {
    const long long line = first - 1 + c / QUARTERS;
    cp_async16(&tile[c], &data[line * QUARTERS + (c & (QUARTERS - 1))]);
  }
  asm volatile("cp.async.commit_group;\n" ::);

  int cmds[PASSES], prevs[PASSES];
#pragma unroll
  for (int k = 0; k < PASSES; ++k) {
    const long long line = first + k * LINES_PER_PASS + tid / QUARTERS;
    cmds[k] = line < m ? cmd[line] : 0;
    prevs[k] = line < m ? prev_rw[line] : -1;
  }
  // the tile's first line: trace t0, index i0 within it
  const long long t0 = first / n;
  const long long i0 = first - t0 * n;

  asm volatile("cp.async.wait_group 0;\n" ::);
  __syncthreads();

#pragma unroll
  for (int k = 0; k < PASSES; ++k) {
    const int j = k * LINES_PER_PASS + tid / QUARTERS;
    const long long line = first + j;
    int o = 0, t = 0;
    if (line < m) {
      const uint4 d = tile[(j + 1) * QUARTERS + q];
      o = repro::popc4(d);
      const int c = cmds[k], p = prevs[k];
      if ((c == repro::RD || c == repro::WR) && p >= 0) {
        long long i = i0 + j, base = first - i0;
        if (i >= n) {                 // the tile wrapped a trace end
          i -= n;
          base += n;
          if (i >= n) {               // traces shorter than a tile
            const long long w = i / n;
            i -= w * n;
            base += w * n;
          }
        }
        const long long pl = base + p;
        const uint4 pv = pl >= lo
            ? tile[(pl - first + 1) * QUARTERS + q]
            : __ldg(&data[pl * QUARTERS + q]);
        t = repro::popc4(repro::xor4(d, pv));
      }
    }
    // every lane takes part in the shuffles; the 4 lanes of a line share
    // a warp and its branch
    o = repro::quad_sum(o);
    t = repro::quad_sum(t);
    if (line < m && q == 0) {
      ones[line] = (float)o;
      togg[line] = (float)t;
    }
  }
}

}  // namespace

extern "C" int repro_features(const void* data, const void* cmd,
                              const void* prev_rw, void* ones, void* togg,
                              long long m, long long n, void* stream) {
  if (m > 0 && n > 0) {
    const long long blocks = (m + TILE - 1) / TILE;
    features_kernel<<<(unsigned)blocks, THREADS, 0, (cudaStream_t)stream>>>(
        (const uint4*)data, (const int*)cmd, (const int*)prev_rw,
        (float*)ones, (float*)togg, m, n);
  }
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The state kernel: structural_state's bookkeeping and pack_state's word.
//
// Replaces no TPU kernel: the reference computes this in jnp
//   (repro/core/energy_model.py structural_state, cumulative-max scans over
//   per-bank and per-event index planes), and the port's 'cuda' path ran the
//   same scans as ~140 eager operations.
// Computes, per command i of trace t of a padded (T, N) batch:
//   prev_rw[t, i] = the index of the last RD/WR before i in trace t (-1 if
//                   none): structural_state(...).prev_rw;
//   state[t, i]   = il_mode | bg_state << 2 | open-bank mask << 8 before
//                   command i: ops.pack_state(structural_state(...)).
//   Banks are taken as bank & 7 (structural_state refuses any outside
//   [0, 8)).
// Bound on the H100: bytes.  cmd, bank and col read (12 B) and the two
//   words written (8 B): 20 B a command, 168 MB and 50 us at 3.35 TB/s for
//   a (512, 16384) batch, against some 80 integer operations a command.
// Design: every quantity structural_state scans is a "last event wins"
//   fact, so the state before a command is a prefix of the trace under an
//   associative combine of an 11-word carry (Carry: each bank's last
//   ACT/PRE/PREA, the last of PDE/PDE_SLOW/PDX and of SRE/SRX, the last
//   RD/WR's index, bank and col, each bank's last RD/WR col), with no
//   gather: the values ride with the carry, so each input byte is read
//   once and each output written once, and nothing else touches device
//   memory (structural_state's scans write (T, 8, N) planes).  A block
//   takes one trace in tiles of BLOCK * RUN commands; a thread owns RUN
//   contiguous commands of a tile, read with 16-byte loads (as scalars
//   where N or a pointer is not 16-byte aligned), walks them to its
//   carry, the block scans the carries (warp shuffles, then one warp over
//   the warps' sums in shared memory), and the thread walks its run again
//   from its exclusive prefix, writing both words four at a time with
//   16-byte stores.  The tile's sum carries into the next tile.
//   Geometry follows T and N only: 1024 threads for traces of over 4096
//   commands in batches of fewer traces than SMs, else 256, held to 64
//   registers so that four blocks share an SM (a (512, N) batch in one
//   wave; 7 % faster than 80 registers at (512, 16384)).
// Measured (H100 80GB HBM3, 700 W; PERF.md's kernel table, row 1s):
//   0.1071 ms at (512, 16384), 47 % of the bound; 0.0874 ms at
//   (4096, 2048), 57 %; 0.0332 ms at (64, 16384), 19 %; 0.0305 ms at the
//   map's (23, 16384), 7 %: 23 blocks, one trace each, on 132 SMs.
namespace {

constexpr int RUN = 8;                      // commands a thread owns a tile
constexpr unsigned FULL = 0xffffffffu;

// w: bits 0-7 banks with an ACT/PRE/PREA, 8-15 of those the open ones,
// 16-17 the last of PDE (1) / PDE_SLOW (2) / PDX (3), 18-19 the last of
// SRE (1) / SRX (2), 20-27 banks with a RD/WR, 28-30 the last RD/WR's bank
struct Carry {
  unsigned w;
  int prev;                                 // last RD/WR's index, -1 none
  int prev_col;                             // its col
  int col[8];                               // each bank's last RD/WR col
};

__device__ __forceinline__ Carry nothing() {
  Carry r;
  r.w = 0u;
  r.prev = -1;
  r.prev_col = 0;
#pragma unroll
  for (int k = 0; k < 8; ++k) r.col[k] = 0;
  return r;
}

// the carry of a stretch a followed by a stretch b: b's facts win
__device__ __forceinline__ Carry combine(const Carry& a, const Carry& b) {
  const unsigned touched = b.w & 0xffu, has = (b.w >> 20) & 0xffu;
  unsigned w = (a.w | b.w) & (0xffu | 0xffu << 20);
  w |= ((a.w & ~(touched << 8)) | b.w) & 0xff00u;
  w |= (b.w & (3u << 16)) ? b.w & (3u << 16) : a.w & (3u << 16);
  w |= (b.w & (3u << 18)) ? b.w & (3u << 18) : a.w & (3u << 18);
  const bool later = b.prev >= 0;
  w |= (later ? b.w : a.w) & (7u << 28);
  Carry r;
  r.w = w;
  r.prev = later ? b.prev : a.prev;
  r.prev_col = later ? b.prev_col : a.prev_col;
#pragma unroll
  for (int k = 0; k < 8; ++k) r.col[k] = (has >> k) & 1u ? b.col[k] : a.col[k];
  return r;
}

// command c on bank b (in [0, 8)), col x, at index i, after the carry s
__device__ __forceinline__ void step(Carry& s, int c, int b, int x, int i) {
  const unsigned bit = 1u << b;
  unsigned w = s.w;
  const unsigned touch = c == repro::PREA ? 0xffu
      : (c == repro::ACT || c == repro::PRE) ? bit : 0u;
  w = ((w | touch) & ~(touch << 8)) | (c == repro::ACT ? bit << 8 : 0u);
  const unsigned pd = c == repro::PDE ? 1u : c == repro::PDE_SLOW ? 2u
      : c == repro::PDX ? 3u : 0u;
  w = pd ? (w & ~(3u << 16)) | pd << 16 : w;
  const unsigned sr = c == repro::SRE ? 1u : c == repro::SRX ? 2u : 0u;
  w = sr ? (w & ~(3u << 18)) | sr << 18 : w;
  if (c == repro::RD || c == repro::WR) {
    w = (w & ~(7u << 28)) | bit << 20 | (unsigned)b << 28;
    s.prev = i;
    s.prev_col = x;
#pragma unroll
    for (int k = 0; k < 8; ++k) s.col[k] = b == k ? x : s.col[k];
  }
  s.w = w;
}

// the state word of a command on bank b, col x, after the carry s
__device__ __forceinline__ int word(const Carry& s, int b, int x) {
  const unsigned open = (s.w >> 8) & 0xffu;
  const unsigned pd = (s.w >> 16) & 3u, sr = (s.w >> 18) & 3u;
  const int bg = sr == 1u ? repro::BG_SR
      : pd == 1u ? (open ? repro::BG_PDN_ACT : repro::BG_PDN_FAST)
      : pd == 2u ? repro::BG_PDN_SLOW : repro::BG_ACTIVE;
  int bank_col = s.col[0];
#pragma unroll
  for (int k = 1; k < 8; ++k) bank_col = b == k ? s.col[k] : bank_col;
  const bool bank_prev = (s.w >> (20 + b)) & 1u;
  const int il = s.prev < 0 ? repro::IL_NONE
      : (int)((s.w >> 28) & 7u) == b
          ? (s.prev_col == x ? repro::IL_NONE : repro::IL_COL)
          : (bank_prev && bank_col == x ? repro::IL_BANK
                                        : repro::IL_BANKCOL);
  return il | bg << 2 | (int)open << 8;
}

__device__ __forceinline__ Carry shfl_up(const Carry& s, int d) {
  Carry r;
  r.w = __shfl_up_sync(FULL, s.w, d);
  r.prev = __shfl_up_sync(FULL, s.prev, d);
  r.prev_col = __shfl_up_sync(FULL, s.prev_col, d);
#pragma unroll
  for (int k = 0; k < 8; ++k) r.col[k] = __shfl_up_sync(FULL, s.col[k], d);
  return r;
}

// a thread's run [first, first + RUN) of one plane, 0 past n
template <bool VEC>
__device__ __forceinline__ void load_run(const int* __restrict__ p, int first,
                                         int n, int (&v)[RUN]) {
#pragma unroll
  for (int q = 0; q < RUN; q += 4) {
    if (VEC) {
      const int4 u = first + q < n
          ? __ldg(reinterpret_cast<const int4*>(p + first + q))
          : make_int4(0, 0, 0, 0);
      v[q] = u.x;
      v[q + 1] = u.y;
      v[q + 2] = u.z;
      v[q + 3] = u.w;
    } else {
#pragma unroll
      for (int j = q; j < q + 4; ++j)
        v[j] = first + j < n ? __ldg(p + first + j) : 0;
    }
  }
}

template <bool VEC>
__device__ __forceinline__ void store4(int* __restrict__ p, int at, int n,
                                       int a, int b, int c, int d) {
  if (VEC) {
    if (at < n) *reinterpret_cast<int4*>(p + at) = make_int4(a, b, c, d);
  } else {
    if (at < n) p[at] = a;
    if (at + 1 < n) p[at + 1] = b;
    if (at + 2 < n) p[at + 2] = c;
    if (at + 3 < n) p[at + 3] = d;
  }
}

template <int BLOCK, bool VEC>
__global__ void __launch_bounds__(BLOCK, BLOCK == 256 ? 4 : 1)
state_kernel(const int* __restrict__ cmd, const int* __restrict__ bank,
             const int* __restrict__ col, int* __restrict__ prev_rw,
             int* __restrict__ state, int n) {
  constexpr int WARPS = BLOCK / 32, TILE = BLOCK * RUN;
  // each warp's sum, then the carry before each warp's first run
  __shared__ Carry warp_sum[WARPS];
  __shared__ Carry tile_sum;
  const long long row = (long long)blockIdx.x * n;
  cmd += row;
  bank += row;
  col += row;
  prev_rw += row;
  state += row;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  Carry carry = nothing();                  // the state before the tile
  for (int base = 0; base < n; base += TILE) {
    const int first = base + threadIdx.x * RUN;
    int c[RUN], b[RUN], x[RUN];
    load_run<VEC>(cmd, first, n, c);
    load_run<VEC>(bank, first, n, b);
    load_run<VEC>(col, first, n, x);
#pragma unroll
    for (int j = 0; j < RUN; ++j) b[j] &= 7;

    Carry own = nothing();
#pragma unroll
    for (int j = 0; j < RUN; ++j)
      if (first + j < n) step(own, c[j], b[j], x[j], first + j);

    // the warp's inclusive scan of the runs, then each run's exclusive one
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const Carry up = shfl_up(own, d);
      if (lane >= d) own = combine(up, own);
    }
    const Carry before = shfl_up(own, 1);
    if (lane == 31) warp_sum[warp] = own;
    __syncthreads();
    if (warp == 0) {
      Carry s = lane < WARPS ? warp_sum[lane] : nothing();
#pragma unroll
      for (int d = 1; d < WARPS; d <<= 1) {
        const Carry up = shfl_up(s, d);
        if (lane >= d) s = combine(up, s);
      }
      const Carry ex = shfl_up(s, 1);
      if (lane < WARPS) warp_sum[lane] = lane ? ex : nothing();
      if (lane == WARPS - 1) tile_sum = s;
    }
    __syncthreads();
    Carry s = combine(carry, warp_sum[warp]);
    if (lane) s = combine(s, before);
    carry = combine(carry, tile_sum);

#pragma unroll
    for (int q = 0; q < RUN; q += 4) {
      int pw[4], sw[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        pw[j] = s.prev;
        sw[j] = word(s, b[q + j], x[q + j]);
        const int i = first + q + j;
        if (i < n) step(s, c[q + j], b[q + j], x[q + j], i);
      }
      store4<VEC>(prev_rw, first + q, n, pw[0], pw[1], pw[2], pw[3]);
      store4<VEC>(state, first + q, n, sw[0], sw[1], sw[2], sw[3]);
    }
  }
}

template <int BLOCK>
void launch_state(const int* cmd, const int* bank, const int* col,
                  int* prev_rw, int* state, long long t, int n, bool vec,
                  cudaStream_t stream) {
  if (vec)
    state_kernel<BLOCK, true><<<(unsigned)t, BLOCK, 0, stream>>>(
        cmd, bank, col, prev_rw, state, n);
  else
    state_kernel<BLOCK, false><<<(unsigned)t, BLOCK, 0, stream>>>(
        cmd, bank, col, prev_rw, state, n);
}

}  // namespace

extern "C" int repro_state(const void* cmd, const void* bank, const void* col,
                           void* prev_rw, void* state, long long t,
                           long long n, void* stream) {
  if (n > 0x7fff0000LL) return (int)cudaErrorInvalidValue;  // int indices
  if (t > 0 && n > 0) {
    static int sms = 0;
    if (sms == 0) {
      int dev = 0;
      cudaGetDevice(&dev);
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    }
    const bool vec =
        n % 4 == 0 &&
        ((unsigned long long)cmd | (unsigned long long)bank |
         (unsigned long long)col | (unsigned long long)prev_rw |
         (unsigned long long)state) % 16 == 0;
    const int* c = (const int*)cmd;
    const int* b = (const int*)bank;
    const int* x = (const int*)col;
    int* p = (int*)prev_rw;
    int* s = (int*)state;
    cudaStream_t st = (cudaStream_t)stream;
    if (t < sms && n > 2 * 256 * RUN)
      launch_state<1024>(c, b, x, p, s, t, (int)n, vec, st);
    else
      launch_state<256>(c, b, x, p, s, t, (int)n, vec, st);
  }
  return (int)cudaGetLastError();
}
