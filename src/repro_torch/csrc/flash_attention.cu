// Causal / non-causal grouped-query attention with an online softmax.
//
// Replaces: src/repro/kernels/flash_attention/flash_attention.py:73
//   flash_attention_pallas (its _kernel).
// Computes: q and k (BH, Sq, D) and (BH_kv, Skv, D), v (BH_kv, Skv, Dv) with
//   Dv <= D (MLA's values are narrower than its queries and keys), BH % BH_kv
//   == 0, q row bh reading kv row bh / group.  out[bh, i] (Dv wide) =
//   softmax_j(q_i . k_j * scale) v_j over the keys j < Skv, and for causal
//   attention only those with q_offset + i >= j (top-left alignment,
//   positions counted from 0).  The softmax runs in float32 with the
//   reference's NEG_INF = -1e30 start and max(l, 1e-30) guard (masked keys
//   weigh exactly 0, as there); the output is written in q's type.  Sq and
//   Skv are any lengths: the kernel masks the ragged kv tile and drops rows
//   past Sq.  Given an lse pointer (the train path, for the backward in
//   flash_attention_bwd.cu), it also writes each row's log-normaliser
//   lse[bh, i] = m_i + log l_i of the scaled scores in natural log, float32
//   (BH, Sq), from the m and l its epilogue already holds, and +inf for a
//   row that sees no key; a null pointer (serving) writes nothing.
// Bound on the H100 at the serving prefill (B=4, H=16, Kh=2, S=2048, D=128,
//   causal, bf16): 2 * 2 * B*H * S^2 * D / 2 = 68.7 GFLOP, 0.0695 ms at
//   989 TFLOP/s; q, k, v and out are 75.5 MB, 0.0225 ms at 3.35 TB/s.  It is
//   bound by operations, so the design is about keeping the tensor cores fed.
//   At the MLA prefill (deepseek-v2-lite-16b: B=4, H=16, group 1, S=2048,
//   D=192, Dv=128, causal, bf16): B*H*S^2*(D+Dv) = 85.9 GFLOP, 0.0869 ms;
//   q, k, v and out are 167.8 MB, 0.0501 ms: bound by operations too.
// Design (bf16, Hopper).  A work item is one kv head and BM = 128 rows of
//   the flattened (position, q-head-of-the-group) space, so all `group` q
//   heads that share a kv head read each K/V tile from one copy in shared
//   memory (the Pallas index map's `b // group`); it walks the kv tiles of
//   BN = 128 keys up to its last diagonal tile (the TPU's sequential grid
//   axis becomes this loop; m, l and the output stay in registers).  One
//   persistent CTA per SM takes items heaviest first, dealt out in bands
//   that alternate direction.  Three warpgroups:
//   - warpgroup 0 is the producer: it gives registers back
//     (setmaxnreg.dec 24) and one thread streams through TMA the item's Q
//     (a 4-D map (D, Sq, group, BH_kv) when the group divides 128: the
//     item's rows are then 128 / group positions x group heads) and its K
//     and V tiles (3-D maps (D, Skv, BH_kv), so a ragged Skv zero-fills at
//     each head's end) into a 2-stage ring that runs on across items, all
//     in 128-byte swizzled 64-column boxes, with a full and an empty
//     mbarrier per stage for K and for V (V is needed later than K) and a
//     pair for Q;
//   - warpgroups 1 and 2 are consumers of 64 rows each (setmaxnreg.inc
//     240).  For a group that does not divide 128 each loads its Q rows
//     with 16-byte loads into the same swizzled layout.  Per tile: S = Q
//     K^T with wgmma m64n128k16 from shared memory (both K-major); the
//     online softmax in registers (row max and sum over the quad, exp2 with
//     scale * log2(e) folded into one FMA, masks only on tiles that cross
//     the diagonal or the end of the keys); O += P V with wgmma taking P
//     from registers (the bf16-packed score accumulators) and V from shared
//     memory as an MN-major operand (transpose bit set).  Phase j issues
//     S(j) together with P(j-1) V(j-1); the two consumers take turns to
//     issue (named barriers), so one's softmax runs under the other's
//     products, and inside a consumer the softmax of tile j overlaps P(j-1)
//     V(j-1).  A stage is released only after wgmma.wait_group has retired
//     the products that read it.  The epilogue divides by max(l, 1e-30) and
//     stores bf16 pairs straight to the rows' places in `out`; asked for
//     lse, the first lane of each quad stores its two rows' |scale| m +
//     log l (m is the raw running max: the scale is folded into the
//     softmax's exp2, and a negative scale into Q), 0.52 MB at the train
//     layer's 131,072 rows.
//   Head dims up to 64 run the D = 64 instance (128 keys a tile, 80 KB of
//   shared memory), head dims up to 128 the D = 128 one (160 KB); a head
//   dim below the instance's width is padded with zeros by the TMA boxes'
//   out-of-bounds fill and the Q loads, so D <= 32 pays for 64 columns.
//   The MLA instance (D = 192, Dv = 128) is the same kernel with three
//   64-column blocks for Q and K (S = Q K^T is 12 k-steps) and two for V
//   (P V stays at n = 128, so a consumer holds the same accumulators as at
//   D = 128): Q 48 KB + K 2 x 48 KB + V 2 x 32 KB = 208 KB of shared memory
//   at BM = BN = 128 with two stages, under the 227 KB a block may have.
//   The instances with Dv = D compile from the same template as before.
//   float32 inputs (the reference's tolerance case) take a plain FMA
//   kernel.
// Left on the table: the output is not staged through shared memory for a
//   TMA store; the diagonal tile computes all of its 128 x 128 scores; the
//   exp2 of every score runs on the MUFU unit (16 a clock per SM), none on
//   the FMA pipes; items are dealt out statically, not by an atomic
//   counter; K/V are not multicast across a cluster; no fp8.  The (192, 128)
//   instance spills 4 bytes (an 8-byte stack frame in `-Xptxas -v`, 168
//   registers as the others); at group 1 no K/V tile is shared across q
//   heads.
#include <math.h>

#include "hopper.cuh"  // mbarriers, TMA, wgmma; the TMA descriptor encoder

namespace {

constexpr float NEG_INF = -1e30f;

struct Shape {
  int group;      // q heads per kv head
  int sq, skv, d;
  int dv;         // value (and output) width, <= d
  int q_offset;   // position of q row 0 (causal alignment)
  int causal;
  float scale;
  int q_tma;      // bf16 kernel: Q comes by TMA (group divides 128, scale >= 0)
};

// rows of the flattened (position, head) space of one kv head -> q/out row
__device__ __forceinline__ size_t q_row(const Shape& s, int bkv, int r) {
  const int pos = r / s.group;
  const int head = bkv * s.group + r % s.group;
  return (size_t)head * s.sq + pos;
}

// kv tiles that rows [row0, row0 + bm) must visit
__device__ __forceinline__ int kv_tiles(const Shape& s, int row0, int bm,
                                        int bn) {
  const int last = min(row0 + bm, s.group * s.sq) - 1;
  int kv_end = s.skv;
  if (s.causal) kv_end = min(s.skv, s.q_offset + last / s.group + 1);
  return kv_end > 0 ? (kv_end + bn - 1) / bn : 0;
}

// the consumers' turns (named barriers 3 and 4 over both consumers): wait
// for consumer w's turn, or hand the turn to consumer w
__device__ __forceinline__ void turn_wait(int w) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(3 + w) : "memory");
}
__device__ __forceinline__ void turn_pass(int w) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(3 + w) : "memory");
}

// ---------------------------------------------------------------------------
// bf16: wgmma + TMA, warp-specialised
// ---------------------------------------------------------------------------
constexpr int BM = 128;        // flattened rows a work item (2 consumers x 64)
constexpr int BN = 128;        // keys per K/V tile
constexpr int STAGES = 2;      // K/V ring depth
constexpr int THREADS = 384;   // producer + 2 consumer warpgroups
constexpr int PRODUCER_REGS = 24, CONSUMER_REGS = 240;

// Shared memory of the instance with DP-wide Q and K and DVP-wide V, from a
// 1024-byte aligned base.  Q and each K tile are DP / 64 blocks, each V tile
// DVP / 64 blocks, of [rows][64 columns] with 128-byte rows in TMA's
// 128-byte swizzle; then the 4 x STAGES K/V mbarriers and Q's.
template <int DP, int DVP>
struct Layout {
  static constexpr int NB = DP / 64;
  static constexpr int NBV = DVP / 64;
  static constexpr int Q_BLOCK = BM * ROW_BYTES;   // one Q column block
  static constexpr int KV_BLOCK = BN * ROW_BYTES;  // one K/V column block
  static constexpr int K_TILE = NB * KV_BLOCK;     // one K tile
  static constexpr int V_TILE = NBV * KV_BLOCK;    // one V tile
  static constexpr int K_OFF = NB * Q_BLOCK;
  static constexpr int V_OFF = K_OFF + STAGES * K_TILE;
  static constexpr int BAR_OFF = V_OFF + STAGES * V_TILE;
  static constexpr int Q_BAR_OFF = BAR_OFF + 4 * STAGES * 8;
  static constexpr int BYTES = Q_BAR_OFF + 2 * 8;
};

// Work items are (row tile, kv head) pairs, numbered heaviest first (row
// tiles descending).  The persistent CTAs deal them out in bands of
// gridDim.x, alternating direction band by band, so that every CTA gets a
// similar sum of causal work: the CTA's k-th item is item_index(k).
__device__ __forceinline__ int item_index(int k) {
  return k * gridDim.x +
         ((k & 1) ? gridDim.x - 1 - blockIdx.x : blockIdx.x);
}
struct Item {
  int bkv, row0, n_tiles;
};
__device__ __forceinline__ Item work_item(const Shape& s, int n_row_tiles,
                                          int bh_kv, int i) {
  Item it;
  it.bkv = i % bh_kv;
  it.row0 = (n_row_tiles - 1 - i / bh_kv) * BM;
  it.n_tiles = kv_tiles(s, it.row0, BM, BN);
  return it;
}

template <int DP, int DVP>
__global__ void __launch_bounds__(THREADS, 1)
flash_bf16_kernel(const __grid_constant__ CUtensorMap tm_q,
                  const __grid_constant__ CUtensorMap tm_k,
                  const __grid_constant__ CUtensorMap tm_v,
                  const __nv_bfloat16* __restrict__ q,
                  __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                  Shape s, int n_row_tiles, int bh_kv) {
  using L = Layout<DP, DVP>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  // mbarriers of stage st: full_k + 8 st, ...
  const uint32_t full_k = base + L::BAR_OFF, full_v = full_k + 8 * STAGES;
  const uint32_t empty_k = full_v + 8 * STAGES, empty_v = empty_k + 8 * STAGES;
  const uint32_t full_q = base + L::Q_BAR_OFF, empty_q = full_q + 8;
  const int n_items = n_row_tiles * bh_kv;

  if (threadIdx.x == 0) {
    for (int st = 0; st < STAGES; ++st) {
      mbar_init(full_k + 8 * st, 1);
      mbar_init(full_v + 8 * st, 1);
      mbar_init(empty_k + 8 * st, 2 * 128);  // every consumer thread
      mbar_init(empty_v + 8 * st, 2 * 128);
    }
    mbar_init(full_q, 1);
    mbar_init(empty_q, 2 * 128);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ---- producer: one thread keeps Q and the K/V ring filled ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    if (threadIdx.x == 0) {
      int tile = 0;  // K/V tiles loaded so far: the ring position
      for (int k = 0; item_index(k) < n_items; ++k) {
        const Item it = work_item(s, n_row_tiles, bh_kv, item_index(k));
        if (s.q_tma) {
          // the item's 128 rows are 128 / group positions x group heads;
          // the buffer is free once both consumers' last Q K^T retired
          if (k > 0) mbar_wait(empty_q, (k - 1) & 1);
          mbar_expect_tx(full_q, L::NB * L::Q_BLOCK);
#pragma unroll
          for (int b = 0; b < L::NB; ++b)
            tma_load_4d(base + b * L::Q_BLOCK, &tm_q, full_q, 64 * b,
                        it.row0 / s.group, 0, it.bkv);
        }
        for (int j = 0; j < it.n_tiles; ++j, ++tile) {
          const int st = tile % STAGES;
          // the consumers' release of tile `tile - STAGES`
          const uint32_t parity = ((tile / STAGES) & 1) ^ 1;
          const uint32_t k_dst = base + L::K_OFF + st * L::K_TILE;
          const uint32_t v_dst = base + L::V_OFF + st * L::V_TILE;
          if (tile >= STAGES) mbar_wait(empty_k + 8 * st, parity);
          mbar_expect_tx(full_k + 8 * st, L::K_TILE);
#pragma unroll
          for (int b = 0; b < L::NB; ++b)
            tma_load_3d(k_dst + b * L::KV_BLOCK, &tm_k, full_k + 8 * st,
                        64 * b, j * BN, it.bkv);
          if (tile >= STAGES) mbar_wait(empty_v + 8 * st, parity);
          mbar_expect_tx(full_v + 8 * st, L::V_TILE);
#pragma unroll
          for (int b = 0; b < L::NBV; ++b)
            tma_load_3d(v_dst + b * L::KV_BLOCK, &tm_v, full_v + 8 * st,
                        64 * b, j * BN, it.bkv);
        }
      }
    }
  } else {
    // ---- consumers: 64 rows each ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
    const int w = threadIdx.x / 128 - 1;  // consumer 0 or 1
    const int t = threadIdx.x % 128;
    const int warp = t / 32, lane = t % 32;
    const int g = lane / 4, t4 = lane % 4;  // accumulator fragment coordinates
    const uint32_t q_base = base + 64 * w * ROW_BYTES;
    const int qp = s.q_tma ? BM / s.group : 0;
    // log2 domain: p = 2^(s * sl2 - m * sl2); the floor keeps a zero scale
    // finite on masked (-inf) scores
    const float sl2 = fmaxf(fabsf(s.scale) * LOG2E, 1e-30f);

    float acc[DVP / 2];       // O: DVP / 8 column blocks of 8 x 4 values
    float m_run[2] = {NEG_INF, NEG_INF}, l_run[2] = {0.f, 0.f};
    float sc[64];             // S of the current tile, then its p values
    uint32_t pa[BN / 16][4];  // P of the previous tile as A fragments
    float alpha[2], lsum[2];  // the current tile's rescale and row sums
    int pos[2];               // the positions of this thread's two rows
    int first_pos;            // the least position among the consumer's rows

    auto k_tile = [&](int tile) {
      return base + L::K_OFF + (tile % STAGES) * L::K_TILE;
    };
    auto v_tile = [&](int tile) {
      return base + L::V_OFF + (tile % STAGES) * L::V_TILE;
    };
    auto parity = [](int tile) { return (uint32_t)((tile / STAGES) & 1); };
    // S = Q K^T: 64 rows x 128 keys, DP / 16 steps of 16 dims
    auto issue_s = [&](int tile) {
      auto desc_q = [&](int kk) {  // kk: steps of 16 dims (32 bytes)
        return sw128_desc(q_base + (kk / 4) * L::Q_BLOCK + (kk % 4) * 32, 16,
                          1024);
      };
      auto desc_k = [&](int kk) {
        return sw128_desc(
            k_tile(tile) + (kk / 4) * L::KV_BLOCK + (kk % 4) * 32, 16, 1024);
      };
      wgmma_ss<true>(sc, desc_q(0), desc_k(0));
#pragma unroll
      for (int kk = 1; kk < DP / 16; ++kk)
        wgmma_ss<false>(sc, desc_q(kk), desc_k(kk));
      wgmma_commit();
    };
    // O += P V: V is keys x DVP row-major, an MN-major B operand
    auto issue_pv = [&](int tile) {
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk)
        wgmma_rs(acc, pa[kk],
                 sw128_desc(v_tile(tile) + kk * 16 * ROW_BYTES, L::KV_BLOCK,
                            1024));
      wgmma_commit();
    };
    // the online softmax of key tile j on its retired S (rows g and g + 8
    // of the warp): masks only tiles crossing the diagonal or the end of
    // the keys; leaves p in sc, the rescale in alpha and the row sums in
    // lsum
    auto softmax = [&](int j) {
      const int key0 = j * BN;
      if (key0 + BN > s.skv || (s.causal && key0 + BN - 1 > first_pos)) {
#pragma unroll
        for (int n = 0; n < BN / 8; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int key = key0 + n * 8 + 2 * t4 + (e & 1);
            if (key >= s.skv || (s.causal && key > pos[e >> 1]))
              sc[4 * n + e] = -INFINITY;
          }
      }
      float mx[2] = {m_run[0], m_run[1]}, neg_m[2];
#pragma unroll
      for (int i = 0; i < 64; ++i)
        mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sc[i]);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
        alpha[h] = fast_exp2((m_run[h] - mx[h]) * sl2);
        m_run[h] = mx[h];
        neg_m[h] = -mx[h] * sl2;
        lsum[h] = 0.f;
      }
#pragma unroll
      for (int i = 0; i < 64; ++i) {
        const int h = (i >> 1) & 1;
        sc[i] = fast_exp2(fmaf(sc[i], sl2, neg_m[h]));
        lsum[h] += sc[i];
      }
    };
    // once the product that read the last P has retired: rescale O and the
    // sums by this tile's alpha, and pack its P (the accumulator layout of
    // n-blocks 2kk and 2kk + 1 is the A layout of step kk)
    auto rescale_and_pack = [&]() {
#pragma unroll
      for (int h = 0; h < 2; ++h) l_run[h] = l_run[h] * alpha[h] + lsum[h];
#pragma unroll
      for (int i = 0; i < DVP / 2; ++i) acc[i] *= alpha[(i >> 1) & 1];
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk) {
        pa[kk][0] = pack_bf16(sc[8 * kk + 0], sc[8 * kk + 1]);
        pa[kk][1] = pack_bf16(sc[8 * kk + 2], sc[8 * kk + 3]);
        pa[kk][2] = pack_bf16(sc[8 * kk + 4], sc[8 * kk + 5]);
        pa[kk][3] = pack_bf16(sc[8 * kk + 6], sc[8 * kk + 7]);
      }
    };

    int tile = 0;                 // K/V tiles consumed so far
    if (w == 1) turn_pass(0);     // consumer 0 goes first
    for (int k = 0; item_index(k) < n_items; ++k) {
      const Item it = work_item(s, n_row_tiles, bh_kv, item_index(k));
      const int n = it.n_tiles;   // >= 1: key 0 is visible to every row
      const bool last_item = item_index(k + 1) >= n_items;
      const int wrow0 = it.row0 + 64 * w;  // the consumer's first row

      // This thread's rows of the item, rl = 64 w + 16 warp + g + 8 h:
      // their positions and q/out rows.  By TMA the item's rows are
      // head-major (row = head * P + position, P = 128 / group); otherwise
      // they are the flattened rows row0 + rl (position-major).
      const int p0 = it.row0 / s.group;
      bool valid[2];
      size_t orow[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int rl = 64 * w + 16 * warp + g + 8 * h;
        const int p = s.q_tma ? p0 + rl % qp : (it.row0 + rl) / s.group;
        const int head = s.q_tma ? rl / qp : (it.row0 + rl) % s.group;
        pos[h] = p + s.q_offset;
        valid[h] = p < s.sq;
        orow[h] = (size_t)(it.bkv * s.group + head) * s.sq + p;
      }
      first_pos = (s.q_tma ? p0 + (qp > 64 ? 64 * w : 0) : wrow0 / s.group) +
                  s.q_offset;

      if (s.q_tma) {
        mbar_wait(full_q, k & 1);
      } else {
        // Q rows [wrow0, wrow0 + 64) into the consumer's slice of each
        // column block, in TMA's 128-byte swizzle (16-byte chunk c of row r
        // sits at chunk c ^ (r % 8)); zeros past the rows and the head dim.
        // A negative scale is carried by negating Q, so the softmax scale
        // is |scale|.
        const int rows = s.group * s.sq;
        const uint32_t sign = s.scale < 0.f ? 0x80008000u : 0u;
        constexpr int CPR = DP / 8;            // 16-byte chunks per row
        constexpr int PER = 64 * CPR / 128;    // chunks per thread
        uint4 qv[PER];                         // all loads in flight at once
#pragma unroll
        for (int i = 0; i < PER; ++i) {
          const int c4 = t + 128 * i, r = c4 / CPR, c = c4 % CPR;
          qv[i] = make_uint4(0u, 0u, 0u, 0u);
          if (wrow0 + r < rows && c * 8 < s.d)
            qv[i] = *reinterpret_cast<const uint4*>(
                q + q_row(s, it.bkv, wrow0 + r) * s.d + c * 8);
        }
#pragma unroll
        for (int i = 0; i < PER; ++i) {
          const int c4 = t + 128 * i, r = c4 / CPR, c = c4 % CPR;
          const uint32_t dst = q_base + (c / 8) * L::Q_BLOCK + r * ROW_BYTES +
                               (((c % 8) ^ (r % 8)) * 16);
          asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(dst),
                       "r"(qv[i].x ^ sign), "r"(qv[i].y ^ sign),
                       "r"(qv[i].z ^ sign), "r"(qv[i].w ^ sign)
                       : "memory");
        }
        // generic-proxy stores -> visible to wgmma; then the consumer's
        // threads
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        asm volatile("bar.sync %0, 128;\n" ::"r"(1 + w) : "memory");
      }

#pragma unroll
      for (int i = 0; i < DVP / 2; ++i) acc[i] = 0.f;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        m_run[h] = NEG_INF;
        l_run[h] = 0.f;
      }

      // Phase j issues S(j) and P(j-1) V(j-1) together, and the two
      // consumers take turns to issue theirs (named barriers 3 and 4), so
      // one's softmax runs under the other's products.  Inside a phase the
      // softmax of tile j starts as soon as S(j) is retired, while P(j-1)
      // V(j-1) still runs; O is rescaled and P(j) packed only after that
      // product has retired too.  The first and last phases are peeled off
      // so that no product is issued under a branch (ptxas would serialise
      // them).  Q is released after the item's last S.
      turn_wait(w);
      mbar_wait(full_k + 8 * (tile % STAGES), parity(tile));
      wgmma_fence();
      issue_s(tile);
      turn_pass(1 - w);
      wgmma_wait<0>();
      pin(sc);
      mbar_arrive(empty_k + 8 * (tile % STAGES));
      if (n == 1 && s.q_tma) mbar_arrive(empty_q);
      softmax(0);
      rescale_and_pack();
      for (int j = 1; j < n; ++j) {
        const int cur = tile + j, prev = cur - 1;
        turn_wait(w);
        mbar_wait(full_k + 8 * (cur % STAGES), parity(cur));
        mbar_wait(full_v + 8 * (prev % STAGES), parity(prev));
        wgmma_fence();
        issue_s(cur);
        issue_pv(prev);
        turn_pass(1 - w);
        wgmma_wait<1>();
        pin(sc);
        mbar_arrive(empty_k + 8 * (cur % STAGES));
        if (j == n - 1 && s.q_tma) mbar_arrive(empty_q);
        softmax(j);
        wgmma_wait<0>();
        pin(acc);
        pin(pa);  // P(j-1) is retired before P(j) takes its registers
        mbar_arrive(empty_v + 8 * (prev % STAGES));
        rescale_and_pack();
      }
      const int last = tile + n - 1;
      turn_wait(w);
      mbar_wait(full_v + 8 * (last % STAGES), parity(last));
      wgmma_fence();
      issue_pv(last);
      if (w == 0 || !last_item) turn_pass(1 - w);
      wgmma_wait<0>();
      pin(acc);
      mbar_arrive(empty_v + 8 * (last % STAGES));
      tile += n;

#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float l = l_run[h];
        l += __shfl_xor_sync(0xffffffffu, l, 1);
        l += __shfl_xor_sync(0xffffffffu, l, 2);
        if (!valid[h]) continue;
        if (lse != nullptr && t4 == 0)
          lse[orow[h]] =
              l > 0.f ? fmaf(m_run[h], fabsf(s.scale), logf(l)) : INFINITY;
        const float inv = 1.f / fmaxf(l, 1e-30f);
        __nv_bfloat16* dst = o + orow[h] * s.dv;
#pragma unroll
        for (int c = 0; c < DVP / 8; ++c) {
          const int col = c * 8 + 2 * t4;
          if (col < s.dv)
            *reinterpret_cast<__nv_bfloat162*>(dst + col) =
                __floats2bfloat162_rn(acc[4 * c + 2 * h] * inv,
                                      acc[4 * c + 2 * h + 1] * inv);
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// float32: plain FMA (one row per 4 threads)
// ---------------------------------------------------------------------------
constexpr int FBM = 32, FBN = 32, FTHREADS = 128;

template <int DP, int DVP>
__global__ void __launch_bounds__(FTHREADS)
flash_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o,
                 float* __restrict__ lse, Shape s) {
  constexpr int LQ = DP + 1, LP = FBN + 1;   // padded strides
  extern __shared__ float fsm[];
  float* Qs = fsm;                  // FBM x LQ
  float* Ks = Qs + FBM * LQ;        // FBN x LQ
  float* Vs = Ks + FBN * LQ;        // FBN x DVP
  float* Ps = Vs + FBN * DVP;       // FBM x LP

  const int tid = threadIdx.x, row = tid >> 2, sub = tid & 3;
  const int bkv = blockIdx.y;
  const int rows = s.group * s.sq;
  const int row0 = (gridDim.x - 1 - blockIdx.x) * FBM;
  const int n_tiles = kv_tiles(s, row0, FBM, FBN);
  const float* kb = k + (size_t)bkv * s.skv * s.d;
  const float* vb = v + (size_t)bkv * s.skv * s.dv;
  const int r = row0 + row;
  const int pos = r / s.group + s.q_offset;

  for (int i = tid; i < FBM * DP; i += FTHREADS) {
    const int rr = i / DP, c = i % DP;
    const bool ok = row0 + rr < rows && c < s.d;
    Qs[rr * LQ + c] = ok ? q[q_row(s, bkv, row0 + rr) * s.d + c] : 0.f;
  }
  float acc[DVP / 4];
#pragma unroll
  for (int c = 0; c < DVP / 4; ++c) acc[c] = 0.f;
  float m_run = NEG_INF, l_run = 0.f;

  for (int j = 0; j < n_tiles; ++j) {
    __syncthreads();  // the previous tile is consumed (and Q is staged)
    for (int i = tid; i < FBN * DP; i += FTHREADS) {
      const int kr = i / DP, c = i % DP;
      const int key = j * FBN + kr;
      const bool ok = key < s.skv && c < s.d;
      Ks[kr * LQ + c] = ok ? kb[(size_t)key * s.d + c] : 0.f;
    }
    for (int i = tid; i < FBN * DVP; i += FTHREADS) {
      const int kr = i / DVP, c = i % DVP;
      const int key = j * FBN + kr;
      const bool ok = key < s.skv && c < s.dv;
      Vs[kr * DVP + c] = ok ? vb[(size_t)key * s.dv + c] : 0.f;
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
    for (int c = 0; c < DVP / 4; ++c) {
      const int col = sub + 4 * c;
      float a = acc[c] * alpha;
      for (int kr = 0; kr < FBN; ++kr)
        a = fmaf(Ps[row * LP + kr], Vs[kr * DVP + col], a);
      acc[c] = a;
    }
  }
  if (r < rows) {
    // m_run is scaled here; a row that sees no key keeps the NEG_INF start
    if (lse != nullptr && sub == 0)
      lse[q_row(s, bkv, r)] =
          m_run > NEG_INF ? m_run + logf(l_run) : INFINITY;
    const float den = fmaxf(l_run, 1e-30f);
    float* dst = o + q_row(s, bkv, r) * s.dv;
#pragma unroll
    for (int c = 0; c < DVP / 4; ++c) {
      const int col = sub + 4 * c;
      if (col < s.dv) dst[col] = acc[c] / den;
    }
  }
}

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------
// Once per instance: check that the entry register count covers the
// producer's and the consumers' setmaxnreg shares (else the consumers would
// wait for registers forever), allow its shared memory, and count the SMs
// (one card).  Returns the SM count, or minus a CUDA error.
template <int DP, int DVP>
int prepare_bf16() {
  static int sms = 0;
  if (sms > 0) return sms;
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, flash_bf16_kernel<DP, DVP>);
  if (err != cudaSuccess) return -err;
  if (attr.numRegs * THREADS < 128 * (PRODUCER_REGS + 2 * CONSUMER_REGS))
    return -cudaErrorInvalidConfiguration;
  err = cudaFuncSetAttribute(flash_bf16_kernel<DP, DVP>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             Layout<DP, DVP>::BYTES + 1024);  // + alignment
  int dev = 0, n = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return -err;
  sms = n;
  return sms;
}

template <int DP, int DVP>
int launch_bf16(const void* q, const void* k, const void* v, void* o,
                float* lse, Shape s, int bh_kv, cudaStream_t st) {
  const int sms = prepare_bf16<DP, DVP>();
  if (sms < 0) return -sms;
  // K (D, Skv, BH_kv) and V (Dv, Skv, BH_kv) in boxes of (64 columns, BN
  // keys, 1 head); Q as (D, Sq, group, BH_kv) in boxes of one work item's
  // rows when the group divides BM (a negative scale needs Q negated on the
  // way in, which the per-thread loads do)
  const cuuint64_t k_dims[3] = {(cuuint64_t)s.d, (cuuint64_t)s.skv,
                                (cuuint64_t)bh_kv};
  const cuuint64_t v_dims[3] = {(cuuint64_t)s.dv, (cuuint64_t)s.skv,
                                (cuuint64_t)bh_kv};
  const cuuint32_t kv_box[3] = {64, BN, 1};
  CUtensorMap tm_q, tm_k, tm_v;
  if (!tensor_map(&tm_k, k, 3, k_dims, kv_box) ||
      !tensor_map(&tm_v, v, 3, v_dims, kv_box))
    return cudaErrorInvalidValue;
  s.q_tma = BM % s.group == 0 && s.scale >= 0.f;
  tm_q = tm_k;
  if (s.q_tma) {
    const cuuint64_t q_dims[4] = {(cuuint64_t)s.d, (cuuint64_t)s.sq,
                                  (cuuint64_t)s.group, (cuuint64_t)bh_kv};
    const cuuint32_t q_box[4] = {64, (cuuint32_t)(BM / s.group),
                                 (cuuint32_t)s.group, 1};
    if (!tensor_map(&tm_q, q, 4, q_dims, q_box)) return cudaErrorInvalidValue;
  }
  // one persistent CTA per SM (at most one per work item)
  const int n_row_tiles = (s.group * s.sq + BM - 1) / BM;
  const int grid = n_row_tiles * bh_kv < sms ? n_row_tiles * bh_kv : sms;
  flash_bf16_kernel<DP, DVP>
      <<<grid, THREADS, Layout<DP, DVP>::BYTES + 1024, st>>>(
      tm_q, tm_k, tm_v, static_cast<const __nv_bfloat16*>(q),
      static_cast<__nv_bfloat16*>(o), lse, s, n_row_tiles, bh_kv);
  return cudaGetLastError();
}

template <int DP, int DVP>
int launch_f32(const void* q, const void* k, const void* v, void* o,
               float* lse, const Shape& s, int bh_kv, cudaStream_t st) {
  const int smem = ((FBM + FBN) * (DP + 1) + FBN * DVP + FBM * (FBN + 1)) *
                   (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_f32_kernel<DP, DVP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((s.group * s.sq + FBM - 1) / FBM, bh_kv);
  flash_f32_kernel<DP, DVP><<<grid, FTHREADS, smem, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), lse, s);
  return cudaGetLastError();
}

}  // namespace

// q (bh, sq, d), k (bh_kv, skv, d), v (bh_kv, skv, dv), out (bh, sq, dv), all
// contiguous, bf16 when is_bf16 else float32; d and dv multiples of 8; lse
// float32 (bh, sq), or null to write none.  The
// instances, by widths padded to 64: bf16 (64, 64), (128, 128) and (192,
// 128); float32 dv = d <= 128 (by d padded to 16, 32, 64 or 128), else
// (192, 128) for any d <= 192 with dv <= 128.
extern "C" int repro_flash_attention(const void* q, const void* k,
                                     const void* v, void* out, void* lse_out,
                                     int bh, int bh_kv, int sq, int skv,
                                     int d, int dv, float scale, int causal,
                                     int q_offset, int is_bf16, void* stream) {
  if (bh_kv <= 0 || bh % bh_kv != 0 || sq <= 0 || skv <= 0 || d <= 0 ||
      d > 192 || d % 8 != 0 || dv <= 0 || dv > d || dv % 8 != 0 ||
      q_offset < 0)
    return cudaErrorInvalidValue;
  const Shape s{bh / bh_kv, sq, skv, d, dv, q_offset, causal, scale, 0};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* lse = static_cast<float*>(lse_out);
  const int dp = (d + 63) / 64 * 64, dvp = (dv + 63) / 64 * 64;
  if (is_bf16) {
    if (dp == 64 && dvp == 64)
      return launch_bf16<64, 64>(q, k, v, out, lse, s, bh_kv, st);
    if (dp == 128 && dvp == 128)
      return launch_bf16<128, 128>(q, k, v, out, lse, s, bh_kv, st);
    if (dp == 192 && dvp == 128)
      return launch_bf16<192, 128>(q, k, v, out, lse, s, bh_kv, st);
    return cudaErrorInvalidValue;
  }
  if (dv == d && d <= 128) {
    const int fp = d <= 16 ? 16 : d <= 32 ? 32 : d <= 64 ? 64 : 128;
    switch (fp) {
      case 16: return launch_f32<16, 16>(q, k, v, out, lse, s, bh_kv, st);
      case 32: return launch_f32<32, 32>(q, k, v, out, lse, s, bh_kv, st);
      case 64: return launch_f32<64, 64>(q, k, v, out, lse, s, bh_kv, st);
      default: return launch_f32<128, 128>(q, k, v, out, lse, s, bh_kv, st);
    }
  }
  if (dv > 128) return cudaErrorInvalidValue;
  return launch_f32<192, 128>(q, k, v, out, lse, s, bh_kv, st);
}
