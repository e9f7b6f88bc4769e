// Causal / non-causal grouped-query attention with an online softmax.
//
// Replaces: repro/kernels/flash_attention/flash_attention.py
//   flash_attention_pallas (its _kernel).
// Computes: q (BH, Sq, D), k and v (BH_kv, Skv, D), BH % BH_kv == 0, q row bh
//   reading kv row bh / group.  out[bh, i] = softmax_j(q_i . k_j * scale)
//   v_j over the keys j < Skv, and for causal attention only those with
//   q_offset + i >= j (top-left alignment, positions counted from 0).  The
//   softmax runs in float32 with the reference's NEG_INF = -1e30 mask and
//   max(l, 1e-30) guard; the output is written in q's type.  Sq and Skv are
//   any lengths: the kernel masks the ragged kv tile and drops rows past Sq.
// Bound on the H100 at the serving prefill (B=4, H=16, Kh=2, S=2048, D=128,
//   causal, bf16): 2 * 2 * B*H * S^2 * D / 2 = 68.7 GFLOP, 0.0695 ms at
//   989 TFLOP/s; q, k, v and out are 75.5 MB, 0.0225 ms at 3.35 TB/s.  It is
//   bound by operations.
// Design: one CTA owns one kv head and BM = 64 consecutive rows of the
//   flattened (position, q-head-of-the-group) space: all `group` q heads that
//   share a kv head sit in one CTA, so each K/V tile is loaded from device
//   memory once per group, not once per q head (the Pallas index map's
//   `b // group`).  The TPU walked kv blocks as a sequential grid axis with
//   m, l and acc in VMEM scratch; here the CTA loops over kv tiles itself
//   and keeps m, l and the output accumulator in registers, writing the
//   output once after the loop.  The causal loop stops at the CTA's last
//   diagonal tile and only tiles that cross the diagonal (or the end of
//   the keys) are masked.  bf16 runs on the tensor cores: ldmatrix +
//   mma.sync m16n8k16 with float32 accumulation for Q K^T and P V, four
//   warps of 16 rows each, K/V tiles double-buffered through cp.async so
//   the next tile loads while this one computes.  float32 inputs (the
//   reference's tolerance case) take a plain FMA kernel.  Heaviest causal
//   tiles are scheduled first.  wgmma, TMA and warp specialisation are
//   later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -1e30f;

struct Shape {
  int group;      // q heads per kv head
  int sq, skv, d;
  int q_offset;   // position of q row 0 (causal alignment)
  int causal;
  float scale;
};

// ---------------------------------------------------------------------------
// PTX helpers
// ---------------------------------------------------------------------------
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte async copy; zero-fills the destination when !pred
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool pred) {
  const int n = pred ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(n));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// c (16x8 f32) += a (16x16 bf16, row) * b (16x8 bf16, col)
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// rows of the flattened (position, head) space of one kv head -> q/out row
__device__ __forceinline__ size_t q_row(const Shape& s, int bkv, int r) {
  const int pos = r / s.group;
  const int head = bkv * s.group + r % s.group;
  return (size_t)head * s.sq + pos;
}

// kv tiles the CTA of rows [row0, row0 + bm) must visit
__device__ __forceinline__ int kv_tiles(const Shape& s, int row0, int bm,
                                        int bn) {
  const int last = min(row0 + bm, s.group * s.sq) - 1;
  int kv_end = s.skv;
  if (s.causal) kv_end = min(s.skv, s.q_offset + last / s.group + 1);
  return kv_end > 0 ? (kv_end + bn - 1) / bn : 0;
}

// ---------------------------------------------------------------------------
// bf16: tensor cores
// ---------------------------------------------------------------------------
constexpr int BM = 64;        // flattened rows per CTA (4 warps x 16)
constexpr int BN = 64;        // keys per tile
constexpr int THREADS = 128;

template <int DP>             // head dim padded to 16, 32, 64 or 128
__global__ void __launch_bounds__(THREADS)
flash_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                  const __nv_bfloat16* __restrict__ k,
                  const __nv_bfloat16* __restrict__ v,
                  __nv_bfloat16* __restrict__ o, Shape s) {
  constexpr int LD = DP + 8;  // smem row stride: 16-byte pad, no conflicts
  constexpr int CPR = DP / 8; // 16-byte chunks per smem row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Ks = Qs + BM * LD;       // two buffers
  __nv_bfloat16* Vs = Ks + 2 * BN * LD;   // two buffers

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;        // mma fragment coordinates
  const int mi = lane >> 3, mr = lane & 7;       // ldmatrix matrix / row
  const int bkv = blockIdx.y;
  const int rows = s.group * s.sq;
  const int row0 = (gridDim.x - 1 - blockIdx.x) * BM;  // heavy tiles first
  const int chunks = s.d / 8;
  const int n_tiles = kv_tiles(s, row0, BM, BN);
  const __nv_bfloat16* kb = k + (size_t)bkv * s.skv * s.d;
  const __nv_bfloat16* vb = v + (size_t)bkv * s.skv * s.d;

  for (int i = tid; i < BM * CPR; i += THREADS) {
    const int r = i / CPR, c = i % CPR;
    const bool ok = row0 + r < rows && c < chunks;
    const __nv_bfloat16* src =
        ok ? q + q_row(s, bkv, row0 + r) * s.d + c * 8 : q;
    cp_async16(Qs + r * LD + c * 8, src, ok);
  }
  auto load_kv = [&](int j, int buf) {
    __nv_bfloat16* kd = Ks + buf * BN * LD;
    __nv_bfloat16* vd = Vs + buf * BN * LD;
    for (int i = tid; i < BN * CPR; i += THREADS) {
      const int r = i / CPR, c = i % CPR;
      const int key = j * BN + r;
      const bool ok = key < s.skv && c < chunks;
      const size_t off = ok ? (size_t)key * s.d + c * 8 : 0;
      cp_async16(kd + r * LD + c * 8, kb + off, ok);
      cp_async16(vd + r * LD + c * 8, vb + off, ok);
    }
  };
  if (n_tiles > 0) load_kv(0, 0);
  cp_async_commit();

  const int wr = warp * 16;  // the warp's first row in the tile
  int pos[2];                // q positions of this thread's rows g, g + 8
  pos[0] = (row0 + wr + g) / s.group + s.q_offset;
  pos[1] = (row0 + wr + g + 8) / s.group + s.q_offset;
  const int first_pos = row0 / s.group + s.q_offset;

  uint32_t qf[DP / 16][4];
  float acc[DP / 8][4];
  float m_run[2] = {NEG_INF, NEG_INF}, l_run[2] = {0.f, 0.f};
#pragma unroll
  for (int n = 0; n < DP / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int j = 0; j < n_tiles; ++j) {
    if (j + 1 < n_tiles) load_kv(j + 1, (j + 1) & 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    if (j == 0) {
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk)
        ldmatrix_x4(qf[kk],
                    Qs + (wr + (mi & 1) * 8 + mr) * LD + kk * 16 + (mi >> 1) * 8);
    }
    const __nv_bfloat16* Kt = Ks + (j & 1) * BN * LD;
    const __nv_bfloat16* Vt = Vs + (j & 1) * BN * LD;

    // S = Q K^T (16 rows x 64 keys per warp)
    float sc[BN / 8][4];
#pragma unroll
    for (int n = 0; n < BN / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
#pragma unroll
      for (int nn = 0; nn < BN / 16; ++nn) {
        uint32_t b[4];
        ldmatrix_x4(b, Kt + (nn * 16 + (mi >> 1) * 8 + mr) * LD + kk * 16 +
                           (mi & 1) * 8);
        mma_bf16(sc[2 * nn], qf[kk], b[0], b[1]);
        mma_bf16(sc[2 * nn + 1], qf[kk], b[2], b[3]);
      }
    }

    // scale, mask, online softmax (rows g and g + 8 of the warp)
    const int key0 = j * BN;
    const bool need_mask = key0 + BN > s.skv ||
                           (s.causal && key0 + BN - 1 > first_pos);
    float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int n = 0; n < BN / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = sc[n][e] * s.scale;
        if (need_mask) {
          const int key = key0 + n * 8 + 2 * t4 + (e & 1);
          if (key >= s.skv || (s.causal && key > pos[e >> 1])) x = NEG_INF;
        }
        sc[n][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    float alpha[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      const float m_new = fmaxf(m_run[h], mx[h]);
      alpha[h] = __expf(m_run[h] - m_new);
      m_run[h] = m_new;
    }
    float lsum[2] = {0.f, 0.f};
#pragma unroll
    for (int n = 0; n < BN / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = __expf(sc[n][e] - m_run[e >> 1]);
        sc[n][e] = p;
        lsum[e >> 1] += p;
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) l_run[h] = l_run[h] * alpha[h] + lsum[h];
#pragma unroll
    for (int n = 0; n < DP / 8; ++n) {
      acc[n][0] *= alpha[0];
      acc[n][1] *= alpha[0];
      acc[n][2] *= alpha[1];
      acc[n][3] *= alpha[1];
    }

    // O += P V: the score accumulators are the A fragments of P
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      uint32_t a[4];
      a[0] = pack_bf16(sc[2 * kk][0], sc[2 * kk][1]);
      a[1] = pack_bf16(sc[2 * kk][2], sc[2 * kk][3]);
      a[2] = pack_bf16(sc[2 * kk + 1][0], sc[2 * kk + 1][1]);
      a[3] = pack_bf16(sc[2 * kk + 1][2], sc[2 * kk + 1][3]);
#pragma unroll
      for (int nn = 0; nn < DP / 16; ++nn) {
        uint32_t b[4];
        ldmatrix_x4_trans(b, Vt + (kk * 16 + (mi & 1) * 8 + mr) * LD +
                                 nn * 16 + (mi >> 1) * 8);
        mma_bf16(acc[2 * nn], a, b[0], b[1]);
        mma_bf16(acc[2 * nn + 1], a, b[2], b[3]);
      }
    }
    __syncthreads();  // every warp is done with this buffer
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float l = l_run[h];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const int r = row0 + wr + g + 8 * h;
    if (r >= rows) continue;
    const float den = fmaxf(l, 1e-30f);
    __nv_bfloat16* dst = o + q_row(s, bkv, r) * s.d;
#pragma unroll
    for (int n = 0; n < DP / 8; ++n) {
      const int col = n * 8 + 2 * t4;
      if (col < s.d)
        *reinterpret_cast<__nv_bfloat162*>(dst + col) = __floats2bfloat162_rn(
            acc[n][2 * h] / den, acc[n][2 * h + 1] / den);
    }
  }
}

// ---------------------------------------------------------------------------
// float32: plain FMA (one row per 4 threads)
// ---------------------------------------------------------------------------
constexpr int FBM = 32, FBN = 32, FTHREADS = 128;

template <int DP>
__global__ void __launch_bounds__(FTHREADS)
flash_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o,
                 Shape s) {
  constexpr int LQ = DP + 1, LP = FBN + 1;   // padded strides
  extern __shared__ float fsm[];
  float* Qs = fsm;                  // FBM x LQ
  float* Ks = Qs + FBM * LQ;        // FBN x LQ
  float* Vs = Ks + FBN * LQ;        // FBN x DP
  float* Ps = Vs + FBN * DP;        // FBM x LP

  const int tid = threadIdx.x, row = tid >> 2, sub = tid & 3;
  const int bkv = blockIdx.y;
  const int rows = s.group * s.sq;
  const int row0 = (gridDim.x - 1 - blockIdx.x) * FBM;
  const int n_tiles = kv_tiles(s, row0, FBM, FBN);
  const float* kb = k + (size_t)bkv * s.skv * s.d;
  const float* vb = v + (size_t)bkv * s.skv * s.d;
  const int r = row0 + row;
  const int pos = r / s.group + s.q_offset;

  for (int i = tid; i < FBM * DP; i += FTHREADS) {
    const int rr = i / DP, c = i % DP;
    const bool ok = row0 + rr < rows && c < s.d;
    Qs[rr * LQ + c] = ok ? q[q_row(s, bkv, row0 + rr) * s.d + c] : 0.f;
  }
  float acc[DP / 4];
#pragma unroll
  for (int c = 0; c < DP / 4; ++c) acc[c] = 0.f;
  float m_run = NEG_INF, l_run = 0.f;

  for (int j = 0; j < n_tiles; ++j) {
    __syncthreads();  // the previous tile is consumed (and Q is staged)
    for (int i = tid; i < FBN * DP; i += FTHREADS) {
      const int kr = i / DP, c = i % DP;
      const int key = j * FBN + kr;
      const bool ok = key < s.skv && c < s.d;
      const size_t off = (size_t)key * s.d + c;
      Ks[kr * LQ + c] = ok ? kb[off] : 0.f;
      Vs[kr * DP + c] = ok ? vb[off] : 0.f;
    }
    __syncthreads();
    float sc[FBN / 4];
    float mx = NEG_INF;
#pragma unroll
    for (int c = 0; c < FBN / 4; ++c) {
      const int kr = sub + 4 * c;
      float dot = 0.f;
      for (int dd = 0; dd < DP; ++dd)
        dot = fmaf(Qs[row * LQ + dd], Ks[kr * LQ + dd], dot);
      float x = dot * s.scale;
      const int key = j * FBN + kr;
      if (key >= s.skv || (s.causal && key > pos)) x = NEG_INF;
      sc[c] = x;
      mx = fmaxf(mx, x);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m_run, mx);
    const float alpha = expf(m_run - m_new);
    m_run = m_new;
    float lsum = 0.f;
#pragma unroll
    for (int c = 0; c < FBN / 4; ++c) {
      const float p = expf(sc[c] - m_run);
      Ps[row * LP + sub + 4 * c] = p;
      lsum += p;
    }
    lsum += __shfl_xor_sync(0xffffffffu, lsum, 1);
    lsum += __shfl_xor_sync(0xffffffffu, lsum, 2);
    l_run = l_run * alpha + lsum;
    __syncwarp();  // the row's probabilities come from the 4 lanes of a quad
#pragma unroll
    for (int c = 0; c < DP / 4; ++c) {
      const int col = sub + 4 * c;
      float a = acc[c] * alpha;
      for (int kr = 0; kr < FBN; ++kr)
        a = fmaf(Ps[row * LP + kr], Vs[kr * DP + col], a);
      acc[c] = a;
    }
  }
  if (r < rows) {
    const float den = fmaxf(l_run, 1e-30f);
    float* dst = o + q_row(s, bkv, r) * s.d;
#pragma unroll
    for (int c = 0; c < DP / 4; ++c) {
      const int col = sub + 4 * c;
      if (col < s.d) dst[col] = acc[c] / den;
    }
  }
}

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------
template <int DP>
int launch_bf16(const void* q, const void* k, const void* v, void* o,
                const Shape& s, int bh_kv, cudaStream_t st) {
  const int smem = (BM + 4 * BN) * (DP + 8) * (int)sizeof(__nv_bfloat16);
  cudaError_t err = cudaFuncSetAttribute(
      flash_bf16_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((s.group * s.sq + BM - 1) / BM, bh_kv);
  flash_bf16_kernel<DP><<<grid, THREADS, smem, st>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      s);
  return cudaGetLastError();
}

template <int DP>
int launch_f32(const void* q, const void* k, const void* v, void* o,
               const Shape& s, int bh_kv, cudaStream_t st) {
  const int smem =
      ((FBM + FBN) * (DP + 1) + FBN * DP + FBM * (FBN + 1)) * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_f32_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((s.group * s.sq + FBM - 1) / FBM, bh_kv);
  flash_f32_kernel<DP><<<grid, FTHREADS, smem, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), s);
  return cudaGetLastError();
}

}  // namespace

// q (bh, sq, d), k and v (bh_kv, skv, d), out (bh, sq, d), all contiguous,
// bf16 when is_bf16 else float32; d <= 128 and a multiple of 8.
extern "C" int repro_flash_attention(const void* q, const void* k,
                                     const void* v, void* out, int bh,
                                     int bh_kv, int sq, int skv, int d,
                                     float scale, int causal, int q_offset,
                                     int is_bf16, void* stream) {
  if (bh_kv <= 0 || bh % bh_kv != 0 || sq <= 0 || skv <= 0 || d <= 0 ||
      d > 128 || d % 8 != 0 || q_offset < 0)
    return cudaErrorInvalidValue;
  const Shape s{bh / bh_kv, sq, skv, d, q_offset, causal, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int dp = d <= 16 ? 16 : d <= 32 ? 32 : d <= 64 ? 64 : 128;
  if (is_bf16) {
    switch (dp) {
      case 16: return launch_bf16<16>(q, k, v, out, s, bh_kv, st);
      case 32: return launch_bf16<32>(q, k, v, out, s, bh_kv, st);
      case 64: return launch_bf16<64>(q, k, v, out, s, bh_kv, st);
      default: return launch_bf16<128>(q, k, v, out, s, bh_kv, st);
    }
  }
  switch (dp) {
    case 16: return launch_f32<16>(q, k, v, out, s, bh_kv, st);
    case 32: return launch_f32<32>(q, k, v, out, s, bh_kv, st);
    case 64: return launch_f32<64>(q, k, v, out, s, bh_kv, st);
    default: return launch_f32<128>(q, k, v, out, s, bh_kv, st);
  }
}
