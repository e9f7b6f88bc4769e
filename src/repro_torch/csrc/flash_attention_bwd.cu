// The backward of grouped-query flash attention: three kernels, no atomics.
//
// Replaces: nothing on the TPU.  The reference trains through the pure-jnp
//   twin of its Pallas kernel (src/repro/models/layers.py:87-156,
//   blockwise_attention, each kv block's body under jax.checkpoint) and its
//   flash_attention_pallas (src/repro/kernels/flash_attention/
//   flash_attention.py:73) has no custom_vjp.  These kernels are the
//   backward of this port's forward kernel (csrc/flash_attention.cu), so
//   that a train step on the card never materialises the (BH, S, S) scores.
// Computes, for q (BH, Sq, D), k (BH_kv, Skv, D), v (BH_kv, Skv, Dv), the
//   forward's out (BH, Sq, Dv), its log-normaliser lse (BH, Sq) and the
//   gradient dout, q row bh reading kv row bh / group, the keys j < Skv
//   and, for causal attention, j <= i (top-left alignment, no q offset):
//   K0 repro_flash_bwd_prep   delta_i = dout_i . out_i, float32 (lse_i =
//                             m_i + log l_i of the softmax over s_ij =
//                             scale q_i . k_j comes from the forward kernel,
//                             which writes it from its epilogue when asked);
//   K1 repro_flash_bwd_dkdv   P = exp(s - lse), dP = dout v^T,
//                             dS = P (dP - delta); dv_j = sum P_ij dout_i and
//                             dk_j = scale sum dS_ij q_i over every q head of
//                             the group and every q tile that sees key j
//                             (the group's sum stays inside the block);
//   K2 repro_flash_bwd_dq     dq_i = scale sum_j dS_ij k_j.
//   Everything accumulates in float32 and is written in the inputs' type.
// Bound on the H100 at one qwen2.5-3b train layer (q (64, 2048, 128), k/v
//   (8, 2048, 128), causal, bf16), over the pairs the mask keeps: K1 does
//   S, dP, dV and dK, 137.5 GFLOP, 0.1390 ms at 989 TFLOP/s; K2 does S, dP
//   and dQ, 103.1 GFLOP, 0.1043 ms; each reads q, k, v, dout, lse and delta
//   and writes its gradients (under 0.05 ms at 3.35 TB/s): both are bound
//   by operations, so the bf16 design is about keeping the tensor cores fed.
//   K0 reads out and dout (2 x 33.55 MB) and writes delta (0.52 MB): 67.6
//   MB, 0.0202 ms at 3.35 TB/s, against 33.5 MFLOP: bound by bytes.
// Design of K0: one pass over the rows of out and dout, no shared memory.
//   A row is the least power of two of lanes that holds its 16-byte chunks
//   (16 lanes for a 128-wide bf16 row of 256 bytes), each lane one chunk of
//   out and one of dout; a thread takes 4 rows, all 8 loads issued before
//   any sum, so a block of 256 threads has 32 KB in flight; each lane sums
//   its chunk in order with fmaf and the row's lanes add by an xor
//   butterfly, a fixed order, so the same bits come out on every run.
// Design of bf16 K1 and K2 (Hopper): wgmma and TMA, as the forward kernel,
//   with the PTX helpers of hopper.cuh; 384 threads, a producer warpgroup
//   (setmaxnreg.dec 24; one thread starts every TMA load, 128-byte
//   swizzled 64-column boxes, zeros past a head's rows and the width) and
//   two consumer warpgroups (setmaxnreg.inc 240).  One block per work item
//   on a plain grid, numbered heaviest first, so the hardware's block
//   scheduler deals the causal triangle out as a longest-first list.
//   - K2: an item is one q head and 128 positions (64 a consumer); Q and dO
//     come once, the K and V tiles of 64 keys through a 2-stage ring.  Per
//     tile S = Q K^T and dP = dO V^T (m64n64k16, both operands K-major from
//     shared memory), then in registers P = 2^(S scale log2(e) - lse
//     log2(e)) and dS = P (dP - delta), masked only on tiles that cross the
//     diagonal or the end of the keys, then dQ += dS K with dS from
//     registers as the A operand and K as an MN-major B.
//   - K1 puts the keys on wgmma's M: an item is one kv head and 64 keys,
//     shared by both consumers, which take alternate (q head, q tile)
//     pairs of the group (so GQA's group sum, and the causal triangle's
//     short rows, split evenly).  A 4-slot ring streams Q and dO tiles (2
//     slots a consumer).  Per pair S^T = K Q^T and dP^T = V dO^T, so that
//     P^T and dS^T come out in registers in the A layout; the pair's lse
//     and delta pass through a consumer-private shared buffer (written
//     under the products); then dV += P^T dO and dK += dS^T Q with Q and dO
//     as MN-major B.  At the end the consumers swap halves of their partial
//     sums through the (then idle) ring: consumer 0 stores dV, consumer 1
//     dK, each the sum of two terms, so the bits are the same on every run.
//     q tiles are 64 rows, 32 at (192, 128): there dK alone is 96
//     accumulators a thread, beside dV's 64.
//   Why plain items and not a persistent grid or a cluster split: with 64
//   keys an item and the pairs split between two consumers, the heaviest
//   K1 item (key tile 0: 8 heads x 32 q tiles at the train layer) is half
//   of what a 128-key item would be, and the 256 items (1024 for K2) are
//   enough for the block scheduler to balance; a persistent grid would
//   deal them statically, and a cluster split would need a DSMEM sum.
//   Why K2's items are per q head and not the forward's flattened (position,
//   head) rows: any group then takes the same 3-D TMA maps (the forward
//   needs per-thread Q loads when the group does not divide 128), and the
//   K/V tiles a group re-reads come from L2.
//   Widths are padded to the instance's (64, 64), (128, 128) or MLA's
//   (192, 128) (d 16 runs (64, 64)).
// Other instances: float32 K1 and K2 (the reference's tolerance case) are
//   the simple first version: plain FMA on the CUDA cores, 256 threads a
//   block, 64 x 64 tiles of queries x keys staged in shared memory as
//   float32 with a row stride of width + 1, each thread holding a 4 x 4
//   block of a score tile.
// Left on the table: inside a consumer the products and the exponentials
//   do not overlap (only the two consumers' do), S and dP are computed
//   twice (K1 and K2); K2's K and V tiles are read once per q head, not
//   once per group; dQ and dK/dV are stored from registers, not staged for
//   a TMA store; no fp8.
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"  // mbarriers, TMA, wgmma; the TMA descriptor encoder

namespace {

// ---------------------------------------------------------------------------
// SIMT: K1 and K2 in float32
// ---------------------------------------------------------------------------
constexpr int BM = 64;        // query rows a tile
constexpr int BN = 64;        // keys a tile (BM == BN: the causal tile walk)
constexpr int THREADS = 256;  // 16 x 16 threads, each a 4 x 4 score block
constexpr int SP = BN + 1;    // row stride of a score tile in shared memory

struct Shape {
  int group, sq, skv, d, dv, causal;
  float scale;
};

// rows [r0, r0 + BM) of a (rows, width) matrix into a BM x W float tile of
// row stride W + 1, zeros past the rows and the width
template <typename T, int W>
__device__ void load_tile(float* dst, const T* src, int r0, int rows,
                          int width) {
  for (int idx = threadIdx.x; idx < BM * W; idx += THREADS) {
    const int r = idx / W, c = idx % W;
    float x = 0.f;
    if (r0 + r < rows && c < width)
      x = src[(size_t)(r0 + r) * width + c];
    dst[r * (W + 1) + c] = x;
  }
}

// acc[a][b] = A[ty + 16a] . B[tx + 16b] over W columns (tiles of stride W+1)
template <int W>
__device__ __forceinline__ void dot_tile(const float* A, const float* B,
                                         float acc[4][4]) {
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) acc[a][b] = 0.f;
#pragma unroll 4
  for (int e = 0; e < W; ++e) {
    float x[4], y[4];
#pragma unroll
    for (int a = 0; a < 4; ++a) x[a] = A[(ty + 16 * a) * (W + 1) + e];
#pragma unroll
    for (int b = 0; b < 4; ++b) y[b] = B[(tx + 16 * b) * (W + 1) + e];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) acc[a][b] = fmaf(x[a], y[b], acc[a][b]);
  }
}

__device__ __forceinline__ bool visible(int i, int j, const Shape& s) {
  return i < s.sq && j < s.skv && (!s.causal || j <= i);
}

// the last key tile that q tile qt sees (all of them when not causal)
__device__ __forceinline__ int last_key_tile(int qt, const Shape& s) {
  const int nk = (s.skv + BN - 1) / BN;
  return s.causal ? min(nk - 1, qt) : nk - 1;
}

// P and dS of one (q tile, key tile) pair into shared memory, from the
// staged Q, dO, K, V tiles and the rows' lse and delta
template <int DP, int DVP>
__device__ void p_ds_tile(const float* Qs, const float* dOs, const float* Ks,
                          const float* Vs, const float* lse_s,
                          const float* delta_s, int q0, int k0,
                          const Shape& s, float* Ps, float* dSs) {
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  float sc[4][4], dp[4][4];
  dot_tile<DP>(Qs, Ks, sc);
  dot_tile<DVP>(dOs, Vs, dp);
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int r = ty + 16 * a;
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int c = tx + 16 * b;
      const float p = visible(q0 + r, k0 + c, s)
                          ? expf(sc[a][b] * s.scale - lse_s[r]) : 0.f;
      if (Ps != nullptr) Ps[r * SP + c] = p;
      dSs[r * SP + c] = p * (dp[a][b] - delta_s[r]);
    }
  }
}

// ----------------------------------------------------------------------- K0
constexpr int PREP_THREADS = 256;
constexpr int PREP_ROWS = 4;  // rows a thread

// the dot product of two 16-byte chunks, in order, in float32: eight bf16
// pairs (a bf16 is the high half of a float) or four floats
__device__ __forceinline__ float chunk_dot(uint4 a, uint4 b, __nv_bfloat16) {
  const uint32_t x[4] = {a.x, a.y, a.z, a.w}, y[4] = {b.x, b.y, b.z, b.w};
  float acc = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    acc = fmaf(__uint_as_float(x[i] << 16), __uint_as_float(y[i] << 16), acc);
    acc = fmaf(__uint_as_float(x[i] & 0xffff0000u),
               __uint_as_float(y[i] & 0xffff0000u), acc);
  }
  return acc;
}
__device__ __forceinline__ float chunk_dot(uint4 a, uint4 b, float) {
  float acc = __uint_as_float(a.x) * __uint_as_float(b.x);
  acc = fmaf(__uint_as_float(a.y), __uint_as_float(b.y), acc);
  acc = fmaf(__uint_as_float(a.z), __uint_as_float(b.z), acc);
  return fmaf(__uint_as_float(a.w), __uint_as_float(b.w), acc);
}

// delta[r] = dout[r] . out[r] for the rows r < rows of (rows, cpr) 16-byte
// chunks: 2^lpr_log2 lanes a row (>= cpr), lane c its chunk c; the block's
// rows are PREP_ROWS passes of PREP_THREADS >> lpr_log2 consecutive rows
template <typename T>
__global__ void __launch_bounds__(PREP_THREADS)
    bwd_delta_kernel(const uint4* __restrict__ o,
                     const uint4* __restrict__ dout,
                     float* __restrict__ delta, int rows, int cpr,
                     int lpr_log2) {
  const int c = threadIdx.x & ((1 << lpr_log2) - 1);
  const int per_pass = PREP_THREADS >> lpr_log2;
  const int r0 = blockIdx.x * per_pass * PREP_ROWS + (threadIdx.x >> lpr_log2);
  uint4 a[PREP_ROWS], b[PREP_ROWS];
#pragma unroll
  for (int u = 0; u < PREP_ROWS; ++u) {
    const int r = r0 + u * per_pass;
    a[u] = b[u] = make_uint4(0u, 0u, 0u, 0u);
    if (r < rows && c < cpr) {
      a[u] = o[(size_t)r * cpr + c];
      b[u] = dout[(size_t)r * cpr + c];
    }
  }
#pragma unroll
  for (int u = 0; u < PREP_ROWS; ++u) {
    float acc = chunk_dot(a[u], b[u], T());
    for (int off = (1 << lpr_log2) >> 1; off > 0; off >>= 1)
      acc += __shfl_xor_sync(0xffffffffu, acc, off);
    const int r = r0 + u * per_pass;
    if (c == 0 && r < rows) delta[r] = acc;
  }
}

// ----------------------------------------------------------------------- K1
template <typename T, int DP, int DVP>
__global__ void __launch_bounds__(THREADS)
    bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dk,
                    T* __restrict__ dv, Shape s) {
  extern __shared__ float smem[];
  float* Ks = smem;
  float* Vs = Ks + BN * (DP + 1);
  float* Qs = Vs + BN * (DVP + 1);
  float* dOs = Qs + BM * (DP + 1);
  float* Ps = dOs + BM * (DVP + 1);
  float* dSs = Ps + BM * SP;
  float* lse_s = dSs + BM * SP;
  float* delta_s = lse_s + BM;
  const int kt = blockIdx.x, hk = blockIdx.y, k0 = kt * BN;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  load_tile<T, DP>(Ks, k + (size_t)hk * s.skv * s.d, k0, s.skv, s.d);
  load_tile<T, DVP>(Vs, v + (size_t)hk * s.skv * s.dv, k0, s.skv, s.dv);

  float acc_k[4][DP / 16], acc_v[4][DVP / 16];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
#pragma unroll
    for (int c = 0; c < DP / 16; ++c) acc_k[a][c] = 0.f;
#pragma unroll
    for (int c = 0; c < DVP / 16; ++c) acc_v[a][c] = 0.f;
  }
  const int nq = (s.sq + BM - 1) / BM;
  const int qt_first = s.causal ? kt : 0;
  for (int g = 0; g < s.group; ++g) {
    const int bh = hk * s.group + g;
    for (int qt = qt_first; qt < nq; ++qt) {
      const int q0 = qt * BM;
      __syncthreads();
      load_tile<T, DP>(Qs, q + (size_t)bh * s.sq * s.d, q0, s.sq, s.d);
      load_tile<T, DVP>(dOs, dout + (size_t)bh * s.sq * s.dv, q0, s.sq,
                        s.dv);
      if (threadIdx.x < BM) {
        const int i = q0 + threadIdx.x;
        lse_s[threadIdx.x] = i < s.sq ? lse[(size_t)bh * s.sq + i] : 0.f;
        delta_s[threadIdx.x] = i < s.sq ? delta[(size_t)bh * s.sq + i] : 0.f;
      }
      __syncthreads();
      p_ds_tile<DP, DVP>(Qs, dOs, Ks, Vs, lse_s, delta_s, q0, k0, s, Ps,
                         dSs);
      __syncthreads();
      // dV[j] += sum_i P[i][j] dO[i];  dK[j] += sum_i dS[i][j] Q[i]
#pragma unroll 2
      for (int i = 0; i < BM; ++i) {
        float p[4], ds[4];
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          p[a] = Ps[i * SP + ty + 16 * a];
          ds[a] = dSs[i * SP + ty + 16 * a];
        }
#pragma unroll
        for (int c = 0; c < DVP / 16; ++c) {
          const float x = dOs[i * (DVP + 1) + tx + 16 * c];
#pragma unroll
          for (int a = 0; a < 4; ++a) acc_v[a][c] = fmaf(p[a], x, acc_v[a][c]);
        }
#pragma unroll
        for (int c = 0; c < DP / 16; ++c) {
          const float x = Qs[i * (DP + 1) + tx + 16 * c];
#pragma unroll
          for (int a = 0; a < 4; ++a)
            acc_k[a][c] = fmaf(ds[a], x, acc_k[a][c]);
        }
      }
    }
  }
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int j = k0 + ty + 16 * a;
    if (j >= s.skv) continue;
#pragma unroll
    for (int c = 0; c < DP / 16; ++c) {
      const int e = tx + 16 * c;
      if (e < s.d)
        dk[((size_t)hk * s.skv + j) * s.d + e] =
            acc_k[a][c] * s.scale;
    }
#pragma unroll
    for (int c = 0; c < DVP / 16; ++c) {
      const int e = tx + 16 * c;
      if (e < s.dv)
        dv[((size_t)hk * s.skv + j) * s.dv + e] = acc_v[a][c];
    }
  }
}

// ----------------------------------------------------------------------- K2
template <typename T, int DP, int DVP>
__global__ void __launch_bounds__(THREADS)
    bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, const T* __restrict__ dout,
                  const float* __restrict__ lse,
                  const float* __restrict__ delta, T* __restrict__ dq,
                  Shape s) {
  extern __shared__ float smem[];
  float* Qs = smem;
  float* dOs = Qs + BM * (DP + 1);
  float* Ks = dOs + BM * (DVP + 1);
  float* Vs = Ks + BN * (DP + 1);
  float* dSs = Vs + BN * (DVP + 1);
  float* lse_s = dSs + BM * SP;
  float* delta_s = lse_s + BM;
  const int qt = blockIdx.x, bh = blockIdx.y, q0 = qt * BM;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const T* kb = k + (size_t)(bh / s.group) * s.skv * s.d;
  const T* vb = v + (size_t)(bh / s.group) * s.skv * s.dv;
  load_tile<T, DP>(Qs, q + (size_t)bh * s.sq * s.d, q0, s.sq, s.d);
  load_tile<T, DVP>(dOs, dout + (size_t)bh * s.sq * s.dv, q0, s.sq, s.dv);
  if (threadIdx.x < BM) {
    const int i = q0 + threadIdx.x;
    lse_s[threadIdx.x] = i < s.sq ? lse[(size_t)bh * s.sq + i] : 0.f;
    delta_s[threadIdx.x] = i < s.sq ? delta[(size_t)bh * s.sq + i] : 0.f;
  }
  float acc[4][DP / 16];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < DP / 16; ++c) acc[a][c] = 0.f;
  const int kt_last = last_key_tile(qt, s);
  for (int kt = 0; kt <= kt_last; ++kt) {
    const int k0 = kt * BN;
    __syncthreads();
    load_tile<T, DP>(Ks, kb, k0, s.skv, s.d);
    load_tile<T, DVP>(Vs, vb, k0, s.skv, s.dv);
    __syncthreads();
    p_ds_tile<DP, DVP>(Qs, dOs, Ks, Vs, lse_s, delta_s, q0, k0, s, nullptr,
                       dSs);
    __syncthreads();
    // dQ[i] += sum_j dS[i][j] K[j]
#pragma unroll 2
    for (int j = 0; j < BN; ++j) {
      float ds[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) ds[a] = dSs[(ty + 16 * a) * SP + j];
#pragma unroll
      for (int c = 0; c < DP / 16; ++c) {
        const float x = Ks[j * (DP + 1) + tx + 16 * c];
#pragma unroll
        for (int a = 0; a < 4; ++a) acc[a][c] = fmaf(ds[a], x, acc[a][c]);
      }
    }
  }
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int i = q0 + ty + 16 * a;
    if (i >= s.sq) continue;
#pragma unroll
    for (int c = 0; c < DP / 16; ++c) {
      const int e = tx + 16 * c;
      if (e < s.d)
        dq[((size_t)bh * s.sq + i) * s.d + e] = acc[a][c] * s.scale;
    }
  }
}

// shared memory of each kernel, in bytes
template <int DP, int DVP>
struct Smem {
  static constexpr int DKDV =
      ((BM + BN) * (DP + DVP + 2) + 2 * BM * SP + 2 * BM) * 4;
  static constexpr int DQ =
      ((BM + BN) * (DP + DVP + 2) + BM * SP + 2 * BM) * 4;
};
static_assert(Smem<192, 128>::DKDV <= 232448,
              "K1's widest instance must fit a block's shared memory");

// ---------------------------------------------------------------------------
// bf16 K1 and K2: wgmma + TMA, a producer and two consumer warpgroups
// ---------------------------------------------------------------------------
constexpr int TC_THREADS = 384;   // producer + 2 consumer warpgroups
constexpr int PRODUCER_REGS = 24, CONSUMER_REGS = 240;
constexpr int KB = 64;            // keys a K2 tile and a K1 work item
constexpr int QB = 128;           // positions a K2 work item (2 x 64 rows)
constexpr int DQ_STAGES = 2;      // K2's K/V ring
constexpr int DKDV_STAGES = 4;    // K1's Q/dO ring: slots 2 st + w for consumer w

// A 64 x N float32 accumulator of wgmma (N = 64, 128 or 192, the register
// order of hopper.cuh): one n = 64 or n = 128 product, and for N = 192 an
// n = 64 product beside it for the columns from 128.
template <int N>
struct Acc {
  static constexpr int A = N >= 128 ? 64 : 32;
  static constexpr int B = N == 192 ? 32 : 0;
  float a[A];
  float b[B > 0 ? B : 1];
  __device__ __forceinline__ float& operator[](int i) {
    return i < A ? a[i] : b[i - A];
  }
};

template <int N>
__device__ __forceinline__ void acc_zero(Acc<N>& x) {
#pragma unroll
  for (int i = 0; i < N / 2; ++i) x[i] = 0.f;
}

template <int N>
__device__ __forceinline__ void acc_pin(Acc<N>& x) {
  pin(x.a);
  if constexpr (Acc<N>::B > 0) pin(x.b);
}

// x += A (64 x 16 bf16, registers) * B (16 x N, MN-major in shared memory
// at `addr`, its 64-column blocks `block` bytes apart)
template <int N>
__device__ __forceinline__ void acc_mma(Acc<N>& x, const uint32_t (&a)[4],
                                        uint32_t addr, uint32_t block) {
  wgmma_rs(x.a, a, sw128_desc(addr, block, 1024));
  if constexpr (Acc<N>::B > 0)
    wgmma_rs(x.b, a, sw128_desc(addr + 2 * block, block, 1024));
}

// this thread's two rows of x times `mul` as bf16 pairs into rows[h]
// (skipped where !ok[h]), the columns below `width`
template <int N>
__device__ __forceinline__ void acc_store(Acc<N>& x, float mul,
                                          __nv_bfloat16* (&rows)[2],
                                          bool (&ok)[2], int width, int t4) {
#pragma unroll
  for (int n = 0; n < N / 8; ++n) {
    const int col = 8 * n + 2 * t4;
#pragma unroll
    for (int h = 0; h < 2; ++h)
      if (ok[h] && col < width)
        *reinterpret_cast<__nv_bfloat162*>(rows[h] + col) =
            __floats2bfloat162_rn(x[4 * n + 2 * h] * mul,
                                  x[4 * n + 2 * h + 1] * mul);
  }
}

__device__ __forceinline__ void init_barriers(uint32_t first, int n,
                                              uint32_t count) {
  for (int i = 0; i < n; ++i) mbar_init(first + 8 * i, count);
}

// The K-major descriptor of k-step kk (16 columns) of a tile of 64-column
// blocks `block` bytes apart.
__device__ __forceinline__ uint64_t kmajor(uint32_t tile, int kk,
                                           uint32_t block) {
  return sw128_desc(tile + (kk / 4) * block + (kk % 4) * 32, 16, 1024);
}

// ----------------------------------------------------------- K2 (bf16) dQ
// Shared memory from a 1024-byte aligned base: Q and dO of the item (QB
// rows in 64-column blocks, 128-byte swizzle), then DQ_STAGES stages of a
// K tile and a V tile (KB rows), then the mbarriers.
template <int DP, int DVP>
struct DqLayout {
  static constexpr int NB = DP / 64, NBV = DVP / 64;
  static constexpr int Q_BLOCK = QB * ROW_BYTES;
  static constexpr int KV_BLOCK = KB * ROW_BYTES;
  static constexpr int DO_OFF = NB * Q_BLOCK;
  static constexpr int K_OFF = DO_OFF + NBV * Q_BLOCK;
  static constexpr int K_TILE = NB * KV_BLOCK;
  static constexpr int STAGE = K_TILE + NBV * KV_BLOCK;
  static constexpr int BAR_OFF = K_OFF + DQ_STAGES * STAGE;
  static constexpr int BYTES = BAR_OFF + (1 + 2 * DQ_STAGES) * 8;
};

template <int DP, int DVP>
__global__ void __launch_bounds__(TC_THREADS, 1)
    bwd_dq_bf16_kernel(const __grid_constant__ CUtensorMap tm_q,
                       const __grid_constant__ CUtensorMap tm_do,
                       const __grid_constant__ CUtensorMap tm_k,
                       const __grid_constant__ CUtensorMap tm_v,
                       const float* __restrict__ lse,
                       const float* __restrict__ delta,
                       __nv_bfloat16* __restrict__ dq, Shape s, int bh) {
  using L = DqLayout<DP, DVP>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t full_q = base + L::BAR_OFF, full = full_q + 8;
  const uint32_t empty = full + 8 * DQ_STAGES;
  // the item: q head `head`, positions [p0, p0 + QB), the last position
  // tiles (the most keys under a causal mask) first
  const int n_pt = (s.sq + QB - 1) / QB;
  const int head = blockIdx.x % bh, hk = head / s.group;
  const int p0 = (n_pt - 1 - blockIdx.x / bh) * QB;
  const int nk = (s.skv + KB - 1) / KB;
  const int n_kt =
      s.causal ? min(nk, (min(p0 + QB, s.sq) - 1) / KB + 1) : nk;

  if (threadIdx.x == 0) {
    mbar_init(full_q, 1);
    init_barriers(full, DQ_STAGES, 1);
    init_barriers(empty, DQ_STAGES, 2 * 128);  // every consumer thread
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ---- producer: Q and dO once, then the K/V ring ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    if (threadIdx.x == 0) {
      mbar_expect_tx(full_q, (L::NB + L::NBV) * L::Q_BLOCK);
#pragma unroll
      for (int b = 0; b < L::NB; ++b)
        tma_load_3d(base + b * L::Q_BLOCK, &tm_q, full_q, 64 * b, p0, head);
#pragma unroll
      for (int b = 0; b < L::NBV; ++b)
        tma_load_3d(base + L::DO_OFF + b * L::Q_BLOCK, &tm_do, full_q,
                    64 * b, p0, head);
      for (int j = 0; j < n_kt; ++j) {
        const int st = j % DQ_STAGES;
        const uint32_t dst = base + L::K_OFF + st * L::STAGE;
        if (j >= DQ_STAGES)
          mbar_wait(empty + 8 * st, ((j / DQ_STAGES) & 1) ^ 1);
        mbar_expect_tx(full + 8 * st, L::STAGE);
#pragma unroll
        for (int b = 0; b < L::NB; ++b)
          tma_load_3d(dst + b * L::KV_BLOCK, &tm_k, full + 8 * st, 64 * b,
                      j * KB, hk);
#pragma unroll
        for (int b = 0; b < L::NBV; ++b)
          tma_load_3d(dst + L::K_TILE + b * L::KV_BLOCK, &tm_v, full + 8 * st,
                      64 * b, j * KB, hk);
      }
    }
  } else {
    // ---- consumers: 64 positions each ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
    const int w = threadIdx.x / 128 - 1, t = threadIdx.x % 128;
    const int warp = t / 32, g = (t % 32) / 4, t4 = t % 4;
    const float sl2 = s.scale * LOG2E;  // p = 2^(s sl2 - lse log2(e))
    const int first = p0 + 64 * w;      // the consumer's least position
    int pos[2];
    bool ok[2];
    float nl[2], dl[2];  // -lse log2(e) and delta of this thread's rows
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      pos[h] = first + 16 * warp + g + 8 * h;
      ok[h] = pos[h] < s.sq;
      const size_t at = (size_t)head * s.sq + pos[h];
      nl[h] = ok[h] ? -lse[at] * LOG2E : 0.f;
      dl[h] = ok[h] ? delta[at] : 0.f;
    }
    const uint32_t q_a = base + 64 * w * ROW_BYTES;
    const uint32_t do_a = base + L::DO_OFF + 64 * w * ROW_BYTES;
    Acc<DP> acc;
    acc_zero(acc);
    float sc[KB / 2], dp[KB / 2];  // S, then P; dP, then dS
    uint32_t da[KB / 16][4];       // dS as A fragments

    mbar_wait(full_q, 0);
    for (int j = 0; j < n_kt; ++j) {
      const int st = j % DQ_STAGES;
      const uint32_t k_t = base + L::K_OFF + st * L::STAGE;
      const uint32_t v_t = k_t + L::K_TILE;
      mbar_wait(full + 8 * st, (j / DQ_STAGES) & 1);
      // S = Q K^T and dP = dO V^T (both operands K-major)
      wgmma_fence();
      wgmma_ss<true>(sc, kmajor(q_a, 0, L::Q_BLOCK),
                     kmajor(k_t, 0, L::KV_BLOCK));
#pragma unroll
      for (int kk = 1; kk < DP / 16; ++kk)
        wgmma_ss<false>(sc, kmajor(q_a, kk, L::Q_BLOCK),
                        kmajor(k_t, kk, L::KV_BLOCK));
      wgmma_ss<true>(dp, kmajor(do_a, 0, L::Q_BLOCK),
                     kmajor(v_t, 0, L::KV_BLOCK));
#pragma unroll
      for (int kk = 1; kk < DVP / 16; ++kk)
        wgmma_ss<false>(dp, kmajor(do_a, kk, L::Q_BLOCK),
                        kmajor(v_t, kk, L::KV_BLOCK));
      wgmma_commit();
      wgmma_wait<0>();
      pin(sc);
      pin(dp);
      // P and dS = P (dP - delta); masks only on tiles that cross the
      // diagonal or the end of the keys
      const int key0 = j * KB;
      const bool edge =
          key0 + KB > s.skv || (s.causal && key0 + KB - 1 > first);
#pragma unroll
      for (int i = 0; i < KB / 2; ++i) {
        const int h = (i >> 1) & 1;
        const int key = key0 + 8 * (i >> 2) + 2 * t4 + (i & 1);
        float p = fast_exp2(fmaf(sc[i], sl2, nl[h]));
        if (edge && (key >= s.skv || (s.causal && key > pos[h]))) p = 0.f;
        dp[i] = p * (dp[i] - dl[h]);
      }
      pack_a(da, dp);
      // dQ += dS K (K MN-major)
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < KB / 16; ++kk)
        acc_mma(acc, da[kk], k_t + kk * 16 * ROW_BYTES, L::KV_BLOCK);
      wgmma_commit();
      wgmma_wait<0>();
      acc_pin(acc);
      pin(da);
      mbar_arrive(empty + 8 * st);
    }
    __nv_bfloat16* rows[2];
#pragma unroll
    for (int h = 0; h < 2; ++h)
      rows[h] = dq + ((size_t)head * s.sq + pos[h]) * s.d;
    acc_store(acc, s.scale, rows, ok, s.d, t4);
  }
}

// ------------------------------------------------------ K1 (bf16) dK, dV
// Shared memory from a 1024-byte aligned base: the item's K and V tiles (KB
// rows in 64-column blocks, 128-byte swizzle), DKDV_STAGES stages of a Q
// tile and a dO tile (BMQ rows), each consumer's two buffers of a pair's
// -lse log2(e) and delta, then the mbarriers.  At the end the stages hold
// the consumers' partial sums.
template <int DP, int DVP, int BMQ>
struct DkdvLayout {
  static constexpr int NB = DP / 64, NBV = DVP / 64;
  static constexpr int KV_BLOCK = KB * ROW_BYTES;
  static constexpr int V_OFF = NB * KV_BLOCK;
  static constexpr int Q_BLOCK = BMQ * ROW_BYTES;
  static constexpr int DO_OFF = NB * Q_BLOCK;  // within a stage
  static constexpr int STAGE = (NB + NBV) * Q_BLOCK;
  static constexpr int ST_OFF = V_OFF + NBV * KV_BLOCK;
  static constexpr int STATS_OFF = ST_OFF + DKDV_STAGES * STAGE;
  static constexpr int STATS = 2 * BMQ;  // floats of one buffer
  static constexpr int BAR_OFF = STATS_OFF + 2 * 2 * STATS * 4;
  static constexpr int BYTES = BAR_OFF + (1 + 2 * DKDV_STAGES) * 8;
  // the partial sums of dV (consumer 1's) and dK (consumer 0's)
  static constexpr int SUM_BYTES = 128 * (DVP + DP) / 2 * 4;
  static_assert(SUM_BYTES <= DKDV_STAGES * STAGE,
                "the partial sums must fit the Q/dO ring");
};

template <int DP, int DVP, int BMQ>
__global__ void __launch_bounds__(TC_THREADS, 1)
    bwd_dkdv_bf16_kernel(const __grid_constant__ CUtensorMap tm_q,
                         const __grid_constant__ CUtensorMap tm_do,
                         const __grid_constant__ CUtensorMap tm_k,
                         const __grid_constant__ CUtensorMap tm_v,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         __nv_bfloat16* __restrict__ dk,
                         __nv_bfloat16* __restrict__ dv, Shape s,
                         int bh_kv) {
  using L = DkdvLayout<DP, DVP, BMQ>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* smem = smem_raw + (base - raw);
  const uint32_t full_kv = base + L::BAR_OFF, full = full_kv + 8;
  const uint32_t empty = full + 8 * DKDV_STAGES;
  // the item: kv head hk, keys [k0, k0 + KB), the first key tiles (seen by
  // the most q tiles under a causal mask) first.  Its pairs are (q head of
  // the group, q tile from the first that sees a key of the item), q tiles
  // inner; consumer w takes the pairs p = w, w + 2, ...
  const int hk = blockIdx.x % bh_kv, k0 = (blockIdx.x / bh_kv) * KB;
  const int nq = (s.sq + BMQ - 1) / BMQ;
  const int qt0 = s.causal ? min(k0 / BMQ, nq) : 0;
  const int nqv = nq - qt0;
  const int n_pairs = s.group * nqv;

  if (threadIdx.x == 0) {
    mbar_init(full_kv, 1);
    init_barriers(full, DKDV_STAGES, 1);
    init_barriers(empty, DKDV_STAGES, 128);  // the slot's consumer
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ---- producer: K and V once, then the Q/dO ring ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    if (threadIdx.x == 0) {
      mbar_expect_tx(full_kv, (L::NB + L::NBV) * L::KV_BLOCK);
#pragma unroll
      for (int b = 0; b < L::NB; ++b)
        tma_load_3d(base + b * L::KV_BLOCK, &tm_k, full_kv, 64 * b, k0, hk);
#pragma unroll
      for (int b = 0; b < L::NBV; ++b)
        tma_load_3d(base + L::V_OFF + b * L::KV_BLOCK, &tm_v, full_kv,
                    64 * b, k0, hk);
      for (int p = 0; p < n_pairs; ++p) {
        const int st = p % DKDV_STAGES;
        const uint32_t dst = base + L::ST_OFF + st * L::STAGE;
        const int bhq = hk * s.group + p / nqv;
        const int q0 = (qt0 + p % nqv) * BMQ;
        if (p >= DKDV_STAGES)
          mbar_wait(empty + 8 * st, ((p / DKDV_STAGES) & 1) ^ 1);
        mbar_expect_tx(full + 8 * st, L::STAGE);
#pragma unroll
        for (int b = 0; b < L::NB; ++b)
          tma_load_3d(dst + b * L::Q_BLOCK, &tm_q, full + 8 * st, 64 * b, q0,
                      bhq);
#pragma unroll
        for (int b = 0; b < L::NBV; ++b)
          tma_load_3d(dst + L::DO_OFF + b * L::Q_BLOCK, &tm_do, full + 8 * st,
                      64 * b, q0, bhq);
      }
    }
  } else {
    // ---- consumers: the item's 64 keys, alternate pairs ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
    const int w = threadIdx.x / 128 - 1, t = threadIdx.x % 128;
    const int warp = t / 32, g = (t % 32) / 4, t4 = t % 4;
    const float sl2 = s.scale * LOG2E;
    int key[2];  // this thread's two keys (rows of S^T)
#pragma unroll
    for (int h = 0; h < 2; ++h) key[h] = k0 + 16 * warp + g + 8 * h;
    float* stats = reinterpret_cast<float*>(smem + L::STATS_OFF) +
                   w * 2 * L::STATS;
    Acc<DP> dka;
    Acc<DVP> dva;
    acc_zero(dka);
    acc_zero(dva);
    float sc[BMQ / 2], dp[BMQ / 2];    // S^T, then P^T; dP^T, then dS^T
    uint32_t pa[BMQ / 16][4], da[BMQ / 16][4];

    mbar_wait(full_kv, 0);
    for (int p = w, buf = 0; p < n_pairs; p += 2, buf ^= 1) {
      const int st = p % DKDV_STAGES;
      const uint32_t q_t = base + L::ST_OFF + st * L::STAGE;
      const uint32_t do_t = q_t + L::DO_OFF;
      const int bhq = hk * s.group + p / nqv;
      const int q0 = (qt0 + p % nqv) * BMQ;
      // the pair's -lse log2(e) (threads < BMQ) and delta (the next BMQ),
      // -inf and 0 past the queries so that P^T and dS^T are 0 there
      float x = 0.f;
      if (t < 2 * BMQ) {
        const int i = q0 + t % BMQ;
        const size_t at = (size_t)bhq * s.sq + i;
        if (t < BMQ)
          x = i < s.sq ? -lse[at] * LOG2E : -INFINITY;
        else if (i < s.sq)
          x = delta[at];
      }
      mbar_wait(full + 8 * st, (p / DKDV_STAGES) & 1);
      // S^T = K Q^T and dP^T = V dO^T (both operands K-major)
      wgmma_fence();
      wgmma_ss<true>(sc, kmajor(base, 0, L::KV_BLOCK),
                     kmajor(q_t, 0, L::Q_BLOCK));
#pragma unroll
      for (int kk = 1; kk < DP / 16; ++kk)
        wgmma_ss<false>(sc, kmajor(base, kk, L::KV_BLOCK),
                        kmajor(q_t, kk, L::Q_BLOCK));
      wgmma_ss<true>(dp, kmajor(base + L::V_OFF, 0, L::KV_BLOCK),
                     kmajor(do_t, 0, L::Q_BLOCK));
#pragma unroll
      for (int kk = 1; kk < DVP / 16; ++kk)
        wgmma_ss<false>(dp, kmajor(base + L::V_OFF, kk, L::KV_BLOCK),
                        kmajor(do_t, kk, L::Q_BLOCK));
      wgmma_commit();
      // the statistics into this pair's buffer, under the products (the
      // buffer's last readers passed this barrier a pair ago)
      float* sb = stats + buf * L::STATS;
      if (t < 2 * BMQ) sb[t] = x;
      asm volatile("bar.sync %0, 128;\n" ::"r"(1 + w) : "memory");
      wgmma_wait<0>();
      pin(sc);
      pin(dp);
      // P^T and dS^T = P^T (dP^T - delta); the causal mask only on pairs
      // whose q tile crosses the item's keys (keys past Skv are rows that
      // are never stored)
      const bool diag = s.causal && k0 + KB - 1 > q0;
#pragma unroll
      for (int i = 0; i < BMQ / 2; ++i) {
        const int h = (i >> 1) & 1;
        const int col = 8 * (i >> 2) + 2 * t4 + (i & 1);
        float pv = fast_exp2(fmaf(sc[i], sl2, sb[col]));
        if (diag && key[h] > q0 + col) pv = 0.f;
        sc[i] = pv;
        dp[i] = pv * (dp[i] - sb[BMQ + col]);
      }
      pack_a(pa, sc);
      pack_a(da, dp);
      // dV += P^T dO and dK += dS^T Q (dO and Q MN-major)
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BMQ / 16; ++kk)
        acc_mma(dva, pa[kk], do_t + kk * 16 * ROW_BYTES, L::Q_BLOCK);
#pragma unroll
      for (int kk = 0; kk < BMQ / 16; ++kk)
        acc_mma(dka, da[kk], q_t + kk * 16 * ROW_BYTES, L::Q_BLOCK);
      wgmma_commit();
      wgmma_wait<0>();
      acc_pin(dva);
      acc_pin(dka);
      pin(pa);
      pin(da);
      mbar_arrive(empty + 8 * st);
    }

    // The two consumers' partial sums, added in shared memory over the
    // ring (free once both are here), register by register: consumer 1
    // hands over its dV and stores dK, consumer 0 hands over its dK and
    // stores dV.  Each sum has two terms, so the order is fixed.
    float* sum_v = reinterpret_cast<float*>(smem + L::ST_OFF);
    float* sum_k = sum_v + 128 * (DVP / 2);
    asm volatile("bar.sync 3, 256;\n" ::: "memory");
    if (w == 1) {
#pragma unroll
      for (int i = 0; i < DVP / 2; ++i) sum_v[i * 128 + t] = dva[i];
    } else {
#pragma unroll
      for (int i = 0; i < DP / 2; ++i) sum_k[i * 128 + t] = dka[i];
    }
    asm volatile("bar.sync 3, 256;\n" ::: "memory");
    bool ok[2];
    __nv_bfloat16* rows[2];
    if (w == 0) {
#pragma unroll
      for (int i = 0; i < DVP / 2; ++i) dva[i] += sum_v[i * 128 + t];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        ok[h] = key[h] < s.skv;
        rows[h] = dv + ((size_t)hk * s.skv + key[h]) * s.dv;
      }
      acc_store(dva, 1.f, rows, ok, s.dv, t4);
    } else {
#pragma unroll
      for (int i = 0; i < DP / 2; ++i) dka[i] += sum_k[i * 128 + t];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        ok[h] = key[h] < s.skv;
        rows[h] = dk + ((size_t)hk * s.skv + key[h]) * s.d;
      }
      acc_store(dka, s.scale, rows, ok, s.d, t4);
    }
  }
}

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------
struct Ptrs {
  const void *q, *k, *v, *dout;
  float *lse, *delta;
  void *dq, *dk, *dv;
};

template <typename Kernel>
cudaError_t set_smem(Kernel kernel, int bytes) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

// Once per tensor-core kernel: check that its entry register count covers
// the producer's and the consumers' setmaxnreg shares (else the consumers
// would wait for registers forever) and allow its shared memory.
template <typename Kernel>
cudaError_t prepare_tc(Kernel kernel, int bytes) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return err;
  if (attr.numRegs * TC_THREADS < 128 * (PRODUCER_REGS + 2 * CONSUMER_REGS))
    return cudaErrorInvalidConfiguration;
  return set_smem(kernel, bytes);
}

// 3-D maps (width, rows, heads) of q, dout, k and v in 128-byte swizzled
// boxes of (64 columns, `rows_q` or KB rows, 1 head); out-of-bounds
// elements (past a head's rows or the width) read as zeros
bool tc_maps(CUtensorMap (&m)[4], const Ptrs& p, const Shape& s, int bh,
             int bh_kv, int rows_q) {
  const cuuint64_t q_dims[3] = {(cuuint64_t)s.d, (cuuint64_t)s.sq,
                                (cuuint64_t)bh};
  const cuuint64_t do_dims[3] = {(cuuint64_t)s.dv, (cuuint64_t)s.sq,
                                 (cuuint64_t)bh};
  const cuuint64_t k_dims[3] = {(cuuint64_t)s.d, (cuuint64_t)s.skv,
                                (cuuint64_t)bh_kv};
  const cuuint64_t v_dims[3] = {(cuuint64_t)s.dv, (cuuint64_t)s.skv,
                                (cuuint64_t)bh_kv};
  const cuuint32_t q_box[3] = {64, (cuuint32_t)rows_q, 1};
  const cuuint32_t kv_box[3] = {64, KB, 1};
  return tensor_map(&m[0], p.q, 3, q_dims, q_box) &&
         tensor_map(&m[1], p.dout, 3, do_dims, q_box) &&
         tensor_map(&m[2], p.k, 3, k_dims, kv_box) &&
         tensor_map(&m[3], p.v, 3, v_dims, kv_box);
}

// K1 in bf16: one block per (64-key tile, kv head), first key tiles first
template <int DP, int DVP, int BMQ>
int launch_dkdv_bf16(const Ptrs& p, const Shape& s, int bh, int bh_kv,
                     cudaStream_t st) {
  constexpr int bytes = DkdvLayout<DP, DVP, BMQ>::BYTES + 1024;  // + align
  static cudaError_t ready = prepare_tc(bwd_dkdv_bf16_kernel<DP, DVP, BMQ>,
                                        bytes);
  if (ready != cudaSuccess) return ready;
  CUtensorMap m[4];
  if (!tc_maps(m, p, s, bh, bh_kv, BMQ)) return cudaErrorInvalidValue;
  const int nk = (s.skv + KB - 1) / KB;
  bwd_dkdv_bf16_kernel<DP, DVP, BMQ><<<nk * bh_kv, TC_THREADS, bytes, st>>>(
      m[0], m[1], m[2], m[3], p.lse, p.delta,
      static_cast<__nv_bfloat16*>(p.dk), static_cast<__nv_bfloat16*>(p.dv),
      s, bh_kv);
  return cudaGetLastError();
}

// K2 in bf16: one block per (128-position tile, q head), last tiles first
template <int DP, int DVP>
int launch_dq_bf16(const Ptrs& p, const Shape& s, int bh, int bh_kv,
                   cudaStream_t st) {
  constexpr int bytes = DqLayout<DP, DVP>::BYTES + 1024;
  static cudaError_t ready = prepare_tc(bwd_dq_bf16_kernel<DP, DVP>, bytes);
  if (ready != cudaSuccess) return ready;
  CUtensorMap m[4];
  if (!tc_maps(m, p, s, bh, bh_kv, QB)) return cudaErrorInvalidValue;
  const int n_pt = (s.sq + QB - 1) / QB;
  bwd_dq_bf16_kernel<DP, DVP><<<n_pt * bh, TC_THREADS, bytes, st>>>(
      m[0], m[1], m[2], m[3], p.lse, p.delta,
      static_cast<__nv_bfloat16*>(p.dq), s, bh);
  return cudaGetLastError();
}

// bf16 K1 and K2 by the padded widths; K1's q tiles are 32 rows at (192,
// 128), where 64 would need 224 accumulator registers a thread
template <int DP, int DVP>
int launch_tc(int which, const Ptrs& p, const Shape& s, int bh, int bh_kv,
              cudaStream_t st) {
  if (which == 2) return launch_dq_bf16<DP, DVP>(p, s, bh, bh_kv, st);
  return launch_dkdv_bf16<DP, DVP, DP == 192 ? 32 : 64>(p, s, bh, bh_kv, st);
}

// which: 1 = K1, 2 = K2: the float32 kernels are SIMT, bf16 the
// tensor-core kernels
template <typename T, int DP, int DVP>
int launch(int which, const Ptrs& p, const Shape& s, int bh, int bh_kv,
           cudaStream_t st) {
  if constexpr (sizeof(T) == 2) {
    return launch_tc<DP, DVP>(which, p, s, bh, bh_kv, st);
  } else {
    const T* q = static_cast<const T*>(p.q);
    const T* k = static_cast<const T*>(p.k);
    const T* v = static_cast<const T*>(p.v);
    const T* dout = static_cast<const T*>(p.dout);
    cudaError_t err;
    if (which == 1) {
      err = set_smem(bwd_dkdv_kernel<T, DP, DVP>, Smem<DP, DVP>::DKDV);
      if (err != cudaSuccess) return err;
      bwd_dkdv_kernel<T, DP, DVP>
          <<<dim3((s.skv + BN - 1) / BN, bh_kv), THREADS,
             Smem<DP, DVP>::DKDV, st>>>(q, k, v, dout, p.lse, p.delta,
                                        static_cast<T*>(p.dk),
                                        static_cast<T*>(p.dv), s);
    } else {
      err = set_smem(bwd_dq_kernel<T, DP, DVP>, Smem<DP, DVP>::DQ);
      if (err != cudaSuccess) return err;
      bwd_dq_kernel<T, DP, DVP>
          <<<dim3((s.sq + BM - 1) / BM, bh), THREADS, Smem<DP, DVP>::DQ,
             st>>>(q, k, v, dout, p.lse, p.delta, static_cast<T*>(p.dq), s);
    }
    return cudaGetLastError();
  }
}

// the instance by the widths: the smallest of (64, 64), (128, 128) and
// (192, 128) that holds d and dv
template <typename T>
int dispatch(int which, const Ptrs& p, const Shape& s, int bh, int bh_kv,
             cudaStream_t st) {
  if (s.d <= 64 && s.dv <= 64)
    return launch<T, 64, 64>(which, p, s, bh, bh_kv, st);
  if (s.d <= 128 && s.dv <= 128)
    return launch<T, 128, 128>(which, p, s, bh, bh_kv, st);
  return launch<T, 192, 128>(which, p, s, bh, bh_kv, st);
}

int run(int which, const Ptrs& p, int bh, int bh_kv, int sq, int skv, int d,
        int dv, float scale, int causal, int is_bf16, void* stream) {
  if (bh_kv <= 0 || bh % bh_kv != 0 || sq <= 0 || skv <= 0 || d <= 0 ||
      d > 192 || d % 8 != 0 || dv <= 0 || dv > d || dv > 128 || dv % 8 != 0)
    return cudaErrorInvalidValue;
  const Shape s{bh / bh_kv, sq, skv, d, dv, causal, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_bf16 ? dispatch<__nv_bfloat16>(which, p, s, bh, bh_kv, st)
                 : dispatch<float>(which, p, s, bh, bh_kv, st);
}

}  // namespace

// K0: out and dout (bh, sq, dv), contiguous, 16-byte aligned, bf16 when
// is_bf16 else float32, dv a multiple of 8 up to 128; delta float32 (bh,
// sq).  Returns cudaGetLastError() after its launch.
extern "C" int repro_flash_bwd_prep(const void* out, const void* dout,
                                    void* delta, int bh, int sq, int dv,
                                    int is_bf16, void* stream) {
  if (bh <= 0 || sq <= 0 || dv <= 0 || dv > 128 || dv % 8 != 0 ||
      (reinterpret_cast<uintptr_t>(out) | reinterpret_cast<uintptr_t>(dout)) %
              16 != 0)
    return cudaErrorInvalidValue;
  const int rows = bh * sq;
  const int cpr = dv / (is_bf16 ? 8 : 4);  // 16-byte chunks a row
  int lpr_log2 = 0;
  while ((1 << lpr_log2) < cpr) ++lpr_log2;
  const int per_block = (PREP_THREADS >> lpr_log2) * PREP_ROWS;
  const int grid = (rows + per_block - 1) / per_block;
  const uint4* o = static_cast<const uint4*>(out);
  const uint4* d = static_cast<const uint4*>(dout);
  float* dl = static_cast<float*>(delta);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    bwd_delta_kernel<__nv_bfloat16>
        <<<grid, PREP_THREADS, 0, st>>>(o, d, dl, rows, cpr, lpr_log2);
  else
    bwd_delta_kernel<float>
        <<<grid, PREP_THREADS, 0, st>>>(o, d, dl, rows, cpr, lpr_log2);
  return cudaGetLastError();
}

// K1 and K2: all tensors contiguous: q (bh, sq, d), k (bh_kv, skv, d), v
// (bh_kv, skv, dv), dout (bh, sq, dv), dq, dk and dv like q, k and v, bf16
// when is_bf16 else float32; lse (the forward kernel's) and delta (K0's)
// float32 (bh, sq).  d and dv multiples of 8 with dv <= d <= 192 and dv <=
// 128.  Each returns cudaGetLastError() after its launch.
extern "C" int repro_flash_bwd_dkdv(const void* q, const void* k,
                                    const void* v, const void* dout,
                                    const void* lse, const void* delta,
                                    void* dk, void* dv_out, int bh, int bh_kv,
                                    int sq, int skv, int d, int dv,
                                    float scale, int causal, int is_bf16,
                                    void* stream) {
  Ptrs p{q, k, v, dout,
         const_cast<float*>(static_cast<const float*>(lse)),
         const_cast<float*>(static_cast<const float*>(delta)), nullptr, dk,
         dv_out};
  return run(1, p, bh, bh_kv, sq, skv, d, dv, scale, causal, is_bf16, stream);
}

extern "C" int repro_flash_bwd_dq(const void* q, const void* k,
                                  const void* v, const void* dout,
                                  const void* lse, const void* delta, void* dq,
                                  int bh, int bh_kv, int sq, int skv, int d,
                                  int dv, float scale, int causal, int is_bf16,
                                  void* stream) {
  Ptrs p{q, k, v, dout,
         const_cast<float*>(static_cast<const float*>(lse)),
         const_cast<float*>(static_cast<const float*>(delta)), dq, nullptr,
         nullptr};
  return run(2, p, bh, bh_kv, sq, skv, d, dv, scale, causal, is_bf16, stream);
}
