// Hopper building blocks shared by the flash-attention kernels
// (flash_attention.cu, flash_attention_bwd.cu): shared-memory addresses,
// mbarriers, TMA tile loads, wgmma descriptors and products (bf16 in, f32
// accumulators), and the host-side TMA descriptor encoder.
//
// wgmma's f32 accumulator of a 64 x N product: thread t of the warpgroup
//   (warp w = t / 32, g = lane / 4, t4 = lane % 4) holds register
//   4 n + 2 h + e = element (row 16 w + g + 8 h, column 8 n + 2 t4 + e).
//   Packing registers 8 kk .. 8 kk + 7 into bf16 pairs gives the A fragment
//   of k-step kk of a product that takes those columns as its depth
//   (pack_a).
#pragma once
#include <cuda.h>  // CUtensorMap and its enums (the encoder comes at run time)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float LOG2E = 1.4426950408889634f;
constexpr int ROW_BYTES = 128;  // one swizzled row of a 64-column bf16 block

// ---------------------------------------------------------------------------
// PTX helpers: shared memory, mbarriers, TMA, wgmma
// ---------------------------------------------------------------------------
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// the A fragments of a product whose depth is the N columns of accumulator
// x: k-step kk packs registers 8 kk .. 8 kk + 7
template <int N>
__device__ __forceinline__ void pack_a(uint32_t (&a)[N / 8][4],
                                       const float (&x)[N]) {
#pragma unroll
  for (int kk = 0; kk < N / 8; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      a[kk][r] = pack_bf16(x[8 * kk + 2 * r], x[8 * kk + 2 * r + 1]);
}

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}
// one arrival that also announces `bytes` of TMA traffic
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}
// spin until the phase of parity `parity` has completed.  (No trap after a
// bound on the spins: a __trap() anywhere in the kernel caps ptxas's
// register allocation near 176 and serialises the wgmma.)
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n"
      "}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// box (64 columns, 128 rows, 1 head) at (c0, c1, c2) -> shared memory
__device__ __forceinline__ void tma_load_3d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2)
      : "memory");
}

// box (64 columns, 128 / group positions, group heads, 1 kv head) of q
__device__ __forceinline__ void tma_load_4d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

// wgmma shared-memory descriptor of a 128-byte-swizzled operand (layout
// type 1); byte offsets: lbo between 64-column blocks of an MN-major
// operand, sbo between groups of 8 rows.  Bases are 1024-byte aligned.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// wait until at most N committed groups of products are still running
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keep the compiler from moving reads or writes of registers that an
// asynchronous product uses across its wait
template <int N>
__device__ __forceinline__ void pin(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void pin(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(r[i][e])::"memory");
}

#define F8(a, i)                                                     \
  "+f"(a[i]), "+f"(a[i + 1]), "+f"(a[i + 2]), "+f"(a[i + 3]),        \
      "+f"(a[i + 4]), "+f"(a[i + 5]), "+f"(a[i + 6]), "+f"(a[i + 7])
#define F32(a, i) F8(a, i), F8(a, i + 8), F8(a, i + 16), F8(a, i + 24)

#define W8(a, i)                                                     \
  "=f"(a[i]), "=f"(a[i + 1]), "=f"(a[i + 2]), "=f"(a[i + 3]),        \
      "=f"(a[i + 4]), "=f"(a[i + 5]), "=f"(a[i + 6]), "=f"(a[i + 7])
#define W32(a, i) W8(a, i), W8(a, i + 8), W8(a, i + 16), W8(a, i + 24)

// d (64 x 128 f32) (+)= A (64 x 16, K-major, smem) * B (16 x 128, K-major,
// smem): the first step of a product overwrites d (its old value is dead),
// the others accumulate
template <bool FIRST>
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t da,
                                              uint64_t db) {
#define SS_N128                                                             \
  "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "                 \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "     \
  "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, " \
  "%29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, " \
  "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, " \
  "%57, %58, %59, %60, %61, %62, %63}, "                                    \
  "%64, %65, p, 1, 1, 0, 0;\n"
  if constexpr (FIRST)
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n" SS_N128
                 "}\n"
                 : W32(d, 0), W32(d, 32)
                 : "l"(da), "l"(db), "r"(0));
  else
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n" SS_N128
                 "}\n"
                 : F32(d, 0), F32(d, 32)
                 : "l"(da), "l"(db), "r"(1));
#undef SS_N128
}

// d (64 x 128 f32) += A (64 x 16 bf16, registers) * B (16 x 128, MN-major
// smem)
__device__ __forceinline__ void wgmma_rs(float (&d)[64],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "
      "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, "
      "%57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n"
      "}\n"
      : F32(d, 0), F32(d, 32)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x 64 f32) += A (64 x 16 bf16, registers) * B (16 x 64, MN-major
// smem)
__device__ __forceinline__ void wgmma_rs(float (&d)[32],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : F32(d, 0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x 64 f32) (+)= A (64 x 16, K-major, smem) * B (16 x 64, K-major,
// smem)
template <bool FIRST>
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da,
                                         uint64_t db) {
#define SS_N64                                                              \
  "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "                  \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "     \
  "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, " \
  "%29, %30, %31}, "                                                        \
  "%32, %33, p, 1, 1, 0, 0;\n"
  if constexpr (FIRST)
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n" SS_N64 "}\n"
                 : W32(d, 0)
                 : "l"(da), "l"(db), "r"(0));
  else
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n" SS_N64 "}\n"
                 : F32(d, 0)
                 : "l"(da), "l"(db), "r"(1));
#undef SS_N64
}

// d (64 x 32 f32) (+)= A (64 x 16, K-major, smem) * B (16 x 32, K-major,
// smem)
template <bool FIRST>
__device__ __forceinline__ void wgmma_ss(float (&d)[16], uint64_t da,
                                         uint64_t db) {
#define SS_N32                                                          \
  "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "              \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, " \
  "%15}, "                                                              \
  "%16, %17, p, 1, 1, 0, 0;\n"
  if constexpr (FIRST)
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n" SS_N32 "}\n"
                 : W8(d, 0), W8(d, 8)
                 : "l"(da), "l"(db), "r"(0));
  else
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n" SS_N32 "}\n"
                 : F8(d, 0), F8(d, 8)
                 : "l"(da), "l"(db), "r"(1));
#undef SS_N32
}

#undef W32
#undef W8
#undef F32
#undef F8

// ---------------------------------------------------------------------------
// host: TMA descriptors
// ---------------------------------------------------------------------------
// cuTensorMapEncodeTiled from the driver through the runtime, so the library
// links against nothing but the runtime
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// a bf16 tensor of `rank` dims (innermost first, the innermost contiguous)
// in 128-byte-swizzled boxes; out-of-bounds elements read as zeros
bool tensor_map(CUtensorMap* map, const void* ptr, int rank,
                const cuuint64_t* dims, const cuuint32_t* box) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  cuuint64_t strides[3];
  cuuint64_t stride = dims[0] * 2;
  for (int i = 0; i + 1 < rank; ++i) {
    strides[i] = stride;
    stride *= dims[i + 1];
  }
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank,
                const_cast<void*>(ptr), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace
