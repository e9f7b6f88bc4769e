// The param-independent feature kernel of the estimation path, with the
// previous RD/WR's line gathered inside it.
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
