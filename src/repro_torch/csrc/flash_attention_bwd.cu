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
//   forward's out (BH, Sq, Dv) and its gradient dout, q row bh reading kv
//   row bh / group, the keys j < Skv and, for causal attention, j <= i
//   (top-left alignment, no q offset):
//   K0 repro_flash_bwd_prep   lse_i = m_i + log l_i of the softmax over
//                             s_ij = scale q_i . k_j (one pass over the key
//                             tiles) and delta_i = dout_i . out_i, float32;
//   K1 repro_flash_bwd_dkdv   P = exp(s - lse), dP = dout v^T,
//                             dS = P (dP - delta); dv_j = sum P_ij dout_i and
//                             dk_j = scale sum dS_ij q_i over every q head of
//                             the group and every q tile that sees key tile j
//                             (the group's sum stays inside the block);
//   K2 repro_flash_bwd_dq     dq_i = scale sum_j dS_ij k_j.
//   Everything accumulates in float32 and is written in the inputs' type.
// Bound on the H100 at one qwen2.5-3b train layer (q (64, 2048, 128), k/v
//   (8, 2048, 128), causal, bf16): the backward needs S again, dP, dV, dK
//   and dQ, five products over the causal pairs, 2.5 x the forward's 68.7
//   GFLOP = 171.8 GFLOP, 0.174 ms at 989 TFLOP/s; it reads q, k, v, out and
//   dout and writes dq, dk and dv (0.143 GB, 0.043 ms): bound by operations.
// Design: the simple first version (speed is later work).  Plain FMA on the
//   CUDA cores, 256 threads a block, 64 x 64 tiles of queries x keys staged
//   in shared memory as float32 with a row stride of width + 1 (conflict-free
//   column reads), each thread holding a 4 x 4 block of a score tile (rows
//   ty + 16a, keys tx + 16b) and its share of the output rows in registers.
//   Widths are padded to the instance's (DP, DVP) with zeros: (64, 64),
//   (128, 128) and MLA's (192, 128); float32 takes the smallest instance
//   that holds its widths.  K0 recomputes lse rather than taking it from the
//   forward, which keeps the wgmma forward kernel as it is.  K1 walks, for
//   its key tile and kv head, the q tiles of every q head of the group in
//   turn (no cross-block sum); K2 walks the key tiles of its q tile.  S and
//   dP are computed twice (K1 and K2) and S a third time (K0).
// Left on the table: no tensor cores (wgmma or mma.sync), no TMA or
//   cp.async, one block an SM at the larger widths, scalar global loads, and
//   K1's heaviest blocks (key tile 0 under a causal mask) walk every q tile
//   of the group while the last ones walk one.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;        // query rows a tile
constexpr int BN = 64;        // keys a tile (BM == BN: the causal tile walk)
constexpr int THREADS = 256;  // 16 x 16 threads, each a 4 x 4 score block
constexpr int SP = BN + 1;    // row stride of a score tile in shared memory

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(
    float x) {
  return __float2bfloat16_rn(x);
}

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
      x = to_f(src[(size_t)(r0 + r) * width + c]);
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
template <typename T, int DP, int DVP>
__global__ void __launch_bounds__(THREADS)
    bwd_prep_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ o, const T* __restrict__ dout,
                    float* __restrict__ lse, float* __restrict__ delta,
                    Shape s) {
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + BM * (DP + 1);
  const int qt = blockIdx.x, bh = blockIdx.y, q0 = qt * BM;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const T* qb = q + (size_t)bh * s.sq * s.d;
  const T* kb = k + (size_t)(bh / s.group) * s.skv * s.d;

  // delta: one warp a row, lanes across the width
  for (int r = warp; r < BM && q0 + r < s.sq; r += THREADS / 32) {
    const size_t row = ((size_t)bh * s.sq + q0 + r) * s.dv;
    float acc = 0.f;
    for (int e = lane; e < s.dv; e += 32)
      acc = fmaf(to_f(dout[row + e]), to_f(o[row + e]), acc);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (lane == 0) delta[(size_t)bh * s.sq + q0 + r] = acc;
  }

  load_tile<T, DP>(Qs, qb, q0, s.sq, s.d);
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  float m[4], l[4];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    m[a] = -INFINITY;
    l[a] = 0.f;
  }
  const int kt_last = last_key_tile(qt, s);
  for (int kt = 0; kt <= kt_last; ++kt) {
    __syncthreads();
    load_tile<T, DP>(Ks, kb, kt * BN, s.skv, s.d);
    __syncthreads();
    float sc[4][4];
    dot_tile<DP>(Qs, Ks, sc);
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        if (!visible(q0 + ty + 16 * a, kt * BN + tx + 16 * b, s)) continue;
        const float x = sc[a][b] * s.scale;
        if (x > m[a]) {
          l[a] = l[a] * expf(m[a] - x) + 1.f;
          m[a] = x;
        } else {
          l[a] += expf(x - m[a]);
        }
      }
  }
  // combine the 16 lanes of a row (one half-warp: the lanes of one ty)
#pragma unroll
  for (int a = 0; a < 4; ++a) {
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) {
      const float m2 = __shfl_xor_sync(0xffffffffu, m[a], off);
      const float l2 = __shfl_xor_sync(0xffffffffu, l[a], off);
      const float mn = fmaxf(m[a], m2);
      const float x = m[a] == -INFINITY ? 0.f : l[a] * expf(m[a] - mn);
      const float y = m2 == -INFINITY ? 0.f : l2 * expf(m2 - mn);
      l[a] = x + y;
      m[a] = mn;
    }
    const int i = q0 + ty + 16 * a;
    // a row that sees no key gets +inf, so that its P is 0
    if (tx == 0 && i < s.sq)
      lse[(size_t)bh * s.sq + i] = l[a] > 0.f ? m[a] + logf(l[a]) : INFINITY;
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
            from_f<T>(acc_k[a][c] * s.scale);
    }
#pragma unroll
    for (int c = 0; c < DVP / 16; ++c) {
      const int e = tx + 16 * c;
      if (e < s.dv)
        dv[((size_t)hk * s.skv + j) * s.dv + e] = from_f<T>(acc_v[a][c]);
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
        dq[((size_t)bh * s.sq + i) * s.d + e] = from_f<T>(acc[a][c] * s.scale);
    }
  }
}

// shared memory of each kernel, in bytes
template <int DP, int DVP>
struct Smem {
  static constexpr int PREP = (BM + BN) * (DP + 1) * 4;
  static constexpr int DKDV =
      ((BM + BN) * (DP + DVP + 2) + 2 * BM * SP + 2 * BM) * 4;
  static constexpr int DQ =
      ((BM + BN) * (DP + DVP + 2) + BM * SP + 2 * BM) * 4;
};
static_assert(Smem<192, 128>::DKDV <= 232448,
              "K1's widest instance must fit a block's shared memory");

template <typename Kernel>
cudaError_t set_smem(Kernel kernel, int bytes) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

struct Ptrs {
  const void *q, *k, *v, *o, *dout;
  float *lse, *delta;
  void *dq, *dk, *dv;
};

// which: 0 = K0, 1 = K1, 2 = K2
template <typename T, int DP, int DVP>
int launch(int which, const Ptrs& p, const Shape& s, int bh, int bh_kv,
           cudaStream_t st) {
  const T* q = static_cast<const T*>(p.q);
  const T* k = static_cast<const T*>(p.k);
  const T* v = static_cast<const T*>(p.v);
  const T* dout = static_cast<const T*>(p.dout);
  const int nq = (s.sq + BM - 1) / BM, nk = (s.skv + BN - 1) / BN;
  cudaError_t err;
  if (which == 0) {
    err = set_smem(bwd_prep_kernel<T, DP, DVP>, Smem<DP, DVP>::PREP);
    if (err != cudaSuccess) return err;
    bwd_prep_kernel<T, DP, DVP>
        <<<dim3(nq, bh), THREADS, Smem<DP, DVP>::PREP, st>>>(
            q, k, static_cast<const T*>(p.o), dout, p.lse, p.delta, s);
  } else if (which == 1) {
    err = set_smem(bwd_dkdv_kernel<T, DP, DVP>, Smem<DP, DVP>::DKDV);
    if (err != cudaSuccess) return err;
    bwd_dkdv_kernel<T, DP, DVP>
        <<<dim3(nk, bh_kv), THREADS, Smem<DP, DVP>::DKDV, st>>>(
            q, k, v, dout, p.lse, p.delta, static_cast<T*>(p.dk),
            static_cast<T*>(p.dv), s);
  } else {
    err = set_smem(bwd_dq_kernel<T, DP, DVP>, Smem<DP, DVP>::DQ);
    if (err != cudaSuccess) return err;
    bwd_dq_kernel<T, DP, DVP>
        <<<dim3(nq, bh), THREADS, Smem<DP, DVP>::DQ, st>>>(
            q, k, v, dout, p.lse, p.delta, static_cast<T*>(p.dq), s);
  }
  return cudaGetLastError();
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

// All tensors contiguous: q (bh, sq, d), k (bh_kv, skv, d), v (bh_kv, skv,
// dv), out and dout (bh, sq, dv), dq, dk and dv like q, k and v, bf16 when
// is_bf16 else float32; lse and delta float32 (bh, sq).  d and dv multiples
// of 8 with dv <= d <= 192 and dv <= 128.  Each returns cudaGetLastError()
// after its launch.
extern "C" int repro_flash_bwd_prep(const void* q, const void* k,
                                    const void* out, const void* dout,
                                    void* lse, void* delta, int bh, int bh_kv,
                                    int sq, int skv, int d, int dv,
                                    float scale, int causal, int is_bf16,
                                    void* stream) {
  Ptrs p{q, k, nullptr, out, dout, static_cast<float*>(lse),
         static_cast<float*>(delta), nullptr, nullptr, nullptr};
  return run(0, p, bh, bh_kv, sq, skv, d, dv, scale, causal, is_bf16, stream);
}

extern "C" int repro_flash_bwd_dkdv(const void* q, const void* k,
                                    const void* v, const void* dout,
                                    const void* lse, const void* delta,
                                    void* dk, void* dv_out, int bh, int bh_kv,
                                    int sq, int skv, int d, int dv,
                                    float scale, int causal, int is_bf16,
                                    void* stream) {
  Ptrs p{q, k, v, nullptr, dout,
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
  Ptrs p{q, k, v, nullptr, dout,
         const_cast<float*>(static_cast<const float*>(lse)),
         const_cast<float*>(static_cast<const float*>(delta)), dq, nullptr,
         nullptr};
  return run(2, p, bh, bh_kv, sq, skv, d, dv, scale, causal, is_bf16, stream);
}
