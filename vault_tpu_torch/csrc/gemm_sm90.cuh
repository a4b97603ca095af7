// The Hopper GEMM core of the port: C = A B on the tensor cores through
// wgmma, fed by TMA through a ring of shared-memory stages, with the
// elementwise work fused into an epilogue.  Two operand types: bf16 with
// fp32 accumulation, and int8 (s8 x s8 -> s32).  The bf16 MLP blocks,
// forward (mlp.cu) and backward (mlp_bwd.cu), the w8 blocks (mlp.cu, behind
// a dequantization pass, dequant below) and the bf16 LN->QKV projection
// (ln_qkv.cu) run on the bf16 instance; the w8a8 SwiGLU block
// (swiglu_w8a8.cu) and the w8a8 MLP blocks (mlp_w8a8.cu) on the int8 one.
// The bf16 attention kernel
// (attention_common.cuh) is not a product of the core but is built from its
// pieces: tensor maps, mbarriers, TMA loads, descriptors and the wgmma
// forms, the register-A form included.
//
// Operands, row-major, 16-byte aligned, rows of 16-byte multiples:
//   A (M, K): K-contiguous (LN(x), the activation, the masked cotangent, dh1,
//   the int8 codes of a row);
//   B either N-contiguous, (K, N) (W1 in y W1, W2 in a W2), read through
//   wgmma's transpose bit, or K-contiguous, (N, K) (W2 in gc W2^T, W1 in
//   dh1 W1^T).  Neither is copied or transposed on the host: the weights
//   change every training step.  The int8 forms of wgmma have no transpose
//   bit, so an int8 B is K-contiguous: the w8a8 MLP and SwiGLU weights are
//   held so at rest (ops/quantize.py k_major).
//   A stage holds 128 bytes of K, one 128-byte swizzle row; M, N and K are
//   anything whose rows are 16-byte multiples: TMA fills the rows, columns
//   and k past the edge with zeros on load (a last stage of K in part, whose
//   zeros add nothing to the products) and the epilogue skips them.
//
// Split-K: with S splits a work item is (tile, split s); split s walks its
// own range of K (the k-steps cut into S near-equal runs) and its epilogue
// sees row r + s M, so StoreF32 (StoreS32) writes the fp32 (s32) partial
// of slice s of an (S M, N) workspace.  No atomics: the row pass after the
// product adds the S slices, fp32 ones in a fixed order (integer sums are
// exact in any order).  Only an epilogue that stores the plain product
// (StoreF32, StoreS32) takes S > 1.
//
// Segments (int8): an epilogue with a `scale` member (Segmented below) cuts
// K into runs of `seg` k-steps.  At the end of each run the consumers wait
// for the run's products and fold the s32 accumulator into an fp32 sum in
// order, sum = sum + float(acc) * scale(row, run), then start the next run
// from zero; the epilogue gets the fp32 sum.  The int32 sum of a run is
// exact and its conversion too while |acc| < 2^24, so the result has the
// bits of the same sum taken run by run in plain fp32 arithmetic.
//
// The block: 128 x BN output tile (BN 64, 128 or 192), 384 threads in three
// warpgroups.
//   * warpgroup 2 is the producer (setmaxnreg down to 40): one thread walks
//     K a stage at a time, waits for a stage's "empty" mbarrier, arms its
//     "full" mbarrier with the stage's bytes and issues the TMA loads
//     (128-byte swizzle: A one box of 128 rows x 128 bytes; B K-contiguous
//     one box of BN rows x 128 bytes, N-contiguous BN / 64 boxes of 64
//     k-rows x 64).
//   * warpgroups 0 and 1 are the consumers (setmaxnreg up to 232), 64 rows
//     of the tile each: per stage four wgmma.mma_async (m64nBNk16 bf16,
//     m64nBNk32 int8, 32 bytes of K each) with the accumulator in
//     registers, one commit group, then wait until at most this group is in
//     flight and release the previous stage (one arrive per warp on its
//     "empty" mbarrier).  The dual forms issue a second product into a
//     second accumulator of the same fragment layout, so the epilogue has
//     both values of an element in the same thread: DUAL A2 B2^T (B2
//     K-contiguous), DUAL_A A B2^T, the stage holding A once.
//   * the epilogue functor gets (row, col, v(row, col), v(row, col + 1)[,
//     the second product's pair], in) for every pair of the tile, col even,
//     row and col clamped into (M, N); it stores only when `in` (the pair
//     lies inside).  It reads its other operands with __ldg: a plain load
//     would be ordered behind the stores of the pairs before it.
// Runs (int8): a segmented epilogue with `seg_cols` too (SegMapped below)
// reads K as runs of seg_cols columns, a 16-byte multiple that need not be
// one of the stage: both operands through 3-d maps (run column, run, row)
// whose boxes stop at their run's end, so each run is seg = ceil(seg_cols /
// 128) stages with zeros past it, and a segment is one run (the SwiGLU
// block's down product over I-tiles of 688 or 960 columns).
//
// Stages: as many as fit in 200 KB, at most 6.  The grid is persistent, a
// block per SM walking work items N fastest, then rows, then splits (or,
// ROWS_FIRST, rows fastest), so the blocks that run together share A's
// rows and all read the same weights from L2 (or, rows first, each weight
// tile is read by all the row tiles at once: a weight larger than L2 is
// then read from memory once), and the next item's loads overlap this
// one's epilogue.
//
// What bounds a product on the H100: 2 M N K operations at 989 TFLOP/s
// (bf16) or 1,979 TOP/s (int8) against the bytes of A, B and C at 3.35
// TB/s: the operations, for every product of the MLP blocks at 2,048 rows
// and more and for the SwiGLU block's at 640.
#pragma once

#include <cuda.h>  // CUtensorMap and its enums; the encoder comes through the runtime
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <initializer_list>
#include <type_traits>

// Internal linkage: every library that includes the core gets its own
// kernels and its own once-per-process flags (a static local of an inline
// function with external linkage would be one object across all the
// libraries loaded in a process).
namespace {
namespace sm90 {

using bf16 = __nv_bfloat16;

constexpr int BM = 128;       // rows of an output tile (two consumer warpgroups)
constexpr int BK = 64;        // k per stage: one 128-byte swizzle row of bf16
constexpr int ROW_BYTES = 128;  // bytes of K per stage, any operand type
constexpr int THREADS = 384;  // two consumer warpgroups and the producer's
constexpr int CONSUMER_WARPS = 8;

// What the core needs of an operand type: k per stage, the accumulator's
// type and the tensor map's element type.
template <class T>
struct Operand;
template <>
struct Operand<bf16> {
  static constexpr int K = BK;
  using Acc = float;
  static constexpr CUtensorMapDataType MAP = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
};
template <>
struct Operand<int8_t> {
  static constexpr int K = ROW_BYTES;
  using Acc = int;
  static constexpr CUtensorMapDataType MAP = CU_TENSOR_MAP_DATA_TYPE_UINT8;
};

// ---------------------------------------------------------------- host side

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, through the runtime (no -lcuda).
inline EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t e =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (e == cudaSuccess && q == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// An array of `rank` dimensions (dims[0] contiguous; strides[i], in bytes,
// of dimension i + 1) of elements `type` (bf16 unless said), read in boxes
// of `box` under swizzle `sw`, zeros past the edges.  cudaErrorInvalidValue
// for a pointer or stride that is not 16-byte aligned.
inline cudaError_t make_map_nd(CUtensorMap* map, const void* ptr, int rank, const cuuint64_t* dims,
                               const cuuint64_t* strides, const cuuint32_t* box,
                               CUtensorMapSwizzle sw,
                               CUtensorMapDataType type = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16) {
  if (ptr == nullptr || reinterpret_cast<uintptr_t>(ptr) % 16 != 0) return cudaErrorInvalidValue;
  for (int i = 0; i < rank; ++i)
    if (dims[i] == 0 || (i + 1 < rank && strides[i] % 16 != 0)) return cudaErrorInvalidValue;
  const EncodeTiled encode = encoder();
  if (encode == nullptr) return cudaErrorInvalidDeviceFunction;
  const cuuint32_t elem[5] = {1, 1, 1, 1, 1};
  const CUresult r = encode(map, type, rank, const_cast<void*>(ptr), dims,
                            strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, sw,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// A row-major (outer, inner) matrix of T read in boxes of (box_outer, 128
// bytes), 128-byte swizzle, zeros past the edges.
template <class T = bf16>
inline cudaError_t make_map(CUtensorMap* map, const void* ptr, int outer, int inner, int box_outer) {
  if (outer <= 0 || inner <= 0) return cudaErrorInvalidValue;
  const cuuint64_t dims[2] = {(cuuint64_t)inner, (cuuint64_t)outer};
  const cuuint64_t strides[1] = {(cuuint64_t)inner * sizeof(T)};
  const cuuint32_t box[2] = {(cuuint32_t)Operand<T>::K, (cuuint32_t)box_outer};
  return make_map_nd(map, ptr, 2, dims, strides, box, CU_TENSOR_MAP_SWIZZLE_128B,
                     Operand<T>::MAP);
}

// The same matrix with its inner dimension cut into runs of `run` columns
// (a 16-byte multiple dividing inner), as a 3-d array (run column, run,
// row) read in boxes of (128 bytes, 1, box_outer): a box stops at its run's
// end, zeros past it.
template <class T>
inline cudaError_t make_map_runs(CUtensorMap* map, const void* ptr, int outer, int inner,
                                 int run, int box_outer) {
  if (outer <= 0 || run <= 0 || inner <= 0 || inner % run != 0) return cudaErrorInvalidValue;
  const cuuint64_t dims[3] = {(cuuint64_t)run, (cuuint64_t)(inner / run), (cuuint64_t)outer};
  const cuuint64_t strides[2] = {(cuuint64_t)run * sizeof(T), (cuuint64_t)inner * sizeof(T)};
  const cuuint32_t box[3] = {(cuuint32_t)Operand<T>::K, 1, (cuuint32_t)box_outer};
  return make_map_nd(map, ptr, 3, dims, strides, box, CU_TENSOR_MAP_SWIZZLE_128B,
                     Operand<T>::MAP);
}

// -------------------------------------------------------------- device side

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

// TMA: the box at (inner c0, outer c1) of `map` into shared memory at dst;
// completion counts its bytes on `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                         uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// The same for a 4-d map: the box at coordinates (c0, c1, c2, c3).
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                         int c2, int c3, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// The same for a 3-d map: the box at coordinates (c0, c1, c2).
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                         int c2, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// wgmma shared-memory matrix descriptor: start address, leading and stride
// byte offsets (all >> 4), swizzle (SW128 or SW64).  128-byte swizzle:
// K-contiguous tiles: rows of 128 bytes, 8-row groups 1024 bytes apart
// (SBO), LBO unused; a k16 step moves the start 32 bytes.  N-contiguous
// tiles: 64-column blocks of 64 k-rows, 8192 bytes apart (LBO), 8-k-row
// groups 1024 bytes apart (SBO); a k16 step moves the start 16 rows, 2048
// bytes.  64-byte swizzle: rows of 64 bytes (32 columns), 8-row groups 512
// bytes apart (SBO); K-contiguous, a k16 step moves the start 32 bytes;
// N-contiguous, 32-column blocks LBO apart, a k16 step 16 rows, 1024 bytes.
constexpr uint64_t SW128 = 1, SW64 = 2;
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo, uint32_t sbo,
                                         uint64_t swizzle = SW128) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (swizzle << 62);
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keeps the compiler from moving accumulator reads across the async MMAs
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
// and the A fragments of the register-A form, which the hardware reads until
// the wait: live, and in place, across it
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}
// and the s32 accumulators of the int8 forms
template <int N>
__device__ __forceinline__ void fence_regs(int (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

template <int TB>
__device__ __forceinline__ void wgmma_n64(float (&d)[32], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, %35;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TB));
}

// wgmma.mma_async m64nNk16, bf16 x bf16 -> fp32, A and B from shared memory;
// TB = 1: B N-contiguous (transposed), 0: K-contiguous.
template <int TB>
__device__ __forceinline__ void wgmma_n128(float (&d)[64], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, %67;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TB));
}

template <int TB>
__device__ __forceinline__ void wgmma_n192(float (&d)[96], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %98, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95"
      "}, %96, %97, p, 1, 1, 0, %99;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TB));
}

template <int BN, int TB>
__device__ __forceinline__ void mma(float (&d)[BN / 2], uint64_t da, uint64_t db) {
  static_assert(BN == 64 || BN == 128 || BN == 192, "tile widths with a wgmma wrapper: 64, 128, 192");
  if constexpr (BN == 64) wgmma_n64<TB>(d, da, db, 1);
  else if constexpr (BN == 128) wgmma_n128<TB>(d, da, db, 1);
  else wgmma_n192<TB>(d, da, db, 1);
}

// wgmma.mma_async m64nNk32, s8 x s8 -> s32, A and B from shared memory, both
// K-contiguous (the integer forms have no transpose bit); scale_d 0 starts
// the accumulator from zero.  The accumulator's fragment layout is the fp32
// one above.
__device__ __forceinline__ void wgmma_s8_n64(int (&d)[32], uint64_t da, uint64_t db,
                                             int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_s8_n128(int (&d)[64], uint64_t da, uint64_t db,
                                             int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_s8_n192(int (&d)[96], uint64_t da, uint64_t db,
                                             int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %98, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95"
      "}, %96, %97, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]),
        "+r"(d[64]), "+r"(d[65]), "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]),
        "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]), "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]),
        "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]), "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87]),
        "+r"(d[88]), "+r"(d[89]), "+r"(d[90]), "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95])
      : "l"(da), "l"(db), "r"(scale_d));
}

template <int BN>
__device__ __forceinline__ void mma_s8(int (&d)[BN / 2], uint64_t da, uint64_t db, int scale_d) {
  static_assert(BN == 64 || BN == 128 || BN == 192, "int8 tile widths: 64, 128, 192");
  if constexpr (BN == 64) wgmma_s8_n64(d, da, db, scale_d);
  else if constexpr (BN == 128) wgmma_s8_n128(d, da, db, scale_d);
  else wgmma_s8_n192(d, da, db, scale_d);
}

// wgmma.mma_async m64nNk16, bf16 x bf16 -> fp32, A from registers: a[0..3]
// are the thread's four bf16 pairs of the 64 x 16 A slice, in the layout of
// the fp32 accumulator of a 64 x 16 product (warp w rows 16 w + lane / 4 (+
// 8), columns 2 (lane % 4) (+ 8)), so a product's accumulators cast pairwise
// to bf16 are the A operand of the next; B from shared memory, TB as above.
template <int TB>
__device__ __forceinline__ void wgmma_rs_n32(float (&d)[16], const uint32_t* a, uint64_t db,
                                              int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, %22;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d), "n"(TB));
}

template <int TB>
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t* a, uint64_t db,
                                              int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d), "n"(TB));
}

template <int TB>
__device__ __forceinline__ void wgmma_rs_n96(float (&d)[48], const uint32_t* a, uint64_t db,
                                              int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %53, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47"
      "}, {%48, %49, %50, %51}, %52, p, 1, 1, %54;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d), "n"(TB));
}

template <int TB>
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t* a, uint64_t db,
                                              int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d), "n"(TB));
}

template <int N, int TB>
__device__ __forceinline__ void mma_rs(float (&d)[N / 2], const uint32_t* a, uint64_t db) {
  static_assert(N == 32 || N == 64 || N == 96 || N == 128,
                "widths with a register-A wgmma wrapper: 32, 64, 96, 128");
  if constexpr (N == 32) wgmma_rs_n32<TB>(d, a, db, 1);
  else if constexpr (N == 64) wgmma_rs_n64<TB>(d, a, db, 1);
  else if constexpr (N == 96) wgmma_rs_n96<TB>(d, a, db, 1);
  else wgmma_rs_n128<TB>(d, a, db, 1);
}

// Eight int8 codes (q0: codes 0-3, q1: 4-7) -> four bf16 pairs
// bf16(float(q) * sc[e]).  float(q) without a conversion instruction: the
// code's byte plus 128 under the exponent of 2^23 is the float 2^23 + q +
// 128 exactly, less 2^23 + 128 it is q; the product rounds once in fp32 and
// once to bf16, as the plain version's (q.float() * s).to(bf16).
__device__ __forceinline__ void dequant8(uint32_t q0, uint32_t q1, const float (&sc)[8],
                                         uint32_t (&o)[4]) {
  const uint32_t u[2] = {q0 ^ 0x80808080u, q1 ^ 0x80808080u};
#pragma unroll
  for (int p = 0; p < 4; ++p) {
    const uint32_t w = u[p / 2];
    const int j = 2 * (p % 2);
    const float f0 = __uint_as_float(__byte_perm(w, 0x4B000000u, 0x7540u + j)) - 8388736.0f;
    const float f1 = __uint_as_float(__byte_perm(w, 0x4B000000u, 0x7540u + j + 1)) - 8388736.0f;
    const __nv_bfloat162 b =
        __floats2bfloat162_rn(__fmul_rn(f0, sc[2 * p]), __fmul_rn(f1, sc[2 * p + 1]));
    o[p] = *reinterpret_cast<const uint32_t*>(&b);
  }
}

// A pass of its own: out = bf16(float(q) * s[n]) for int8 codes q (K, N),
// N a multiple of 16, sixteen codes a thread; two matrices in one launch.
struct Dequant {
  const int8_t* q;
  const float* s;
  bf16* out;
  int n16;  // codes / 16
  int n;
};

__global__ void __launch_bounds__(256) dequant_kernel(const Dequant a, const Dequant b) {
  int i = blockIdx.x * 256 + threadIdx.x;
  const bool second = i >= a.n16;
  if (second) i -= a.n16;
  const int8_t* q = second ? b.q : a.q;
  const float* s = second ? b.s : a.s;
  bf16* out = second ? b.out : a.out;
  const int n_cols = second ? b.n : a.n;
  if (i >= (second ? b.n16 : a.n16)) return;
  const uint4 v = __ldg(reinterpret_cast<const uint4*>(q) + i);
  const float* sp = s + (unsigned)i % (unsigned)(n_cols / 16) * 16;
  float sc[8];
  uint32_t o[8];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float4 lo = __ldg(reinterpret_cast<const float4*>(sp + 8 * h));
    const float4 hi = __ldg(reinterpret_cast<const float4*>(sp + 8 * h + 4));
    sc[0] = lo.x, sc[1] = lo.y, sc[2] = lo.z, sc[3] = lo.w;
    sc[4] = hi.x, sc[5] = hi.y, sc[6] = hi.z, sc[7] = hi.w;
    uint32_t (&oh)[4] = *reinterpret_cast<uint32_t(*)[4]>(o + 4 * h);
    dequant8(h ? v.z : v.x, h ? v.w : v.y, sc, oh);
  }
  uint4* dst = reinterpret_cast<uint4*>(out) + 2 * i;
  dst[0] = make_uint4(o[0], o[1], o[2], o[3]);
  dst[1] = make_uint4(o[4], o[5], o[6], o[7]);
}

// a and b (b.n16 = 0: a alone) through dequant_kernel; every pointer 16-byte
// aligned.
inline cudaError_t dequant(const Dequant& a, const Dequant& b, cudaStream_t st) {
  if (a.n16 <= 0 || b.n16 < 0 || a.n16 > (1 << 30) - b.n16 || a.n % 16 != 0 ||
      (b.n16 > 0 && b.n % 16 != 0))
    return cudaErrorInvalidValue;
  dequant_kernel<<<(a.n16 + b.n16 + 255) / 256, 256, 0, st>>>(a, b);
  return cudaGetLastError();
}

// The two consumer warpgroups share one 128 x BN tile, 64 rows each.
//   COOP: one product.
//   DUAL: a second product A2 B2^T (B2 K-contiguous) into a second
//     accumulator of the same fragment layout.
//   DUAL_A: a second product A B2^T (B2 K-contiguous), the stage holding A
//     once (the SwiGLU block's gate and up).
enum Mode { COOP = 0, DUAL = 1, DUAL_A = 2 };

template <int BN, int MODE>
struct Shape {
  static constexpr int A_BYTES = BM * ROW_BYTES;              // 16 KB
  static constexpr int B_BYTES = BN * ROW_BYTES;              // BN x 128 bytes
  static constexpr int PAIR = A_BYTES + B_BYTES;
  static constexpr int STAGE = MODE == DUAL ? 2 * PAIR : MODE == DUAL_A ? PAIR + B_BYTES : PAIR;
  static constexpr int STAGES = (200 * 1024) / STAGE < 6 ? (200 * 1024) / STAGE : 6;
  static constexpr size_t SMEM = (size_t)STAGES * STAGE + 1024 + 2 * STAGES * 8;
  static_assert(STAGES >= 2 && BN % 64 == 0, "tile");
};

// An epilogue with `seg` (k-steps per segment) and `scale(row, segment)`
// takes K in segments (see the head of this file).
template <class E, class = void>
struct Segmented : std::false_type {};
template <class E>
struct Segmented<E, decltype((void)&E::scale)> : std::true_type {};
// A segmented epilogue with `seg_cols` as well reads K in runs (see the
// head of this file): its seg is ceil(seg_cols / k per stage).
template <class E, class = void>
struct SegMapped : std::false_type {};
template <class E>
struct SegMapped<E, decltype((void)&E::seg_cols)> : std::true_type {};
template <class E>
__device__ __forceinline__ int seg_steps(const E& epi) {
  if constexpr (Segmented<E>::value) return epi.seg;
  else return 0;
}

// The origin of tile `tile` of a (M, N) product in BM x BN tiles: N fastest,
// or rows fastest (ROWS_FIRST).
template <int BN, bool ROWS_FIRST>
__device__ __forceinline__ void tile_origin(int tile, int tiles_n, int tiles_m, int& m0, int& n0) {
  if constexpr (ROWS_FIRST) {
    m0 = (tile % tiles_m) * BM, n0 = (tile / tiles_m) * BN;
  } else {
    m0 = (tile / tiles_n) * BM, n0 = (tile % tiles_n) * BN;
  }
}

// Persistent: one block per SM (at most one per work item) walks the items
// t = blockIdx.x, blockIdx.x + gridDim.x, ...: tile t % tiles (tile_origin),
// split t / tiles, k-steps [s kt / S, (s + 1) kt / S) of kt = K / (k per
// stage) (each split gets at least one: S <= kt).  The producer runs on into
// the next item while the consumers are in this one's epilogue, so the ring
// is full when they come back.  Non-dual launches pass ta2 = ta, tb2 = tb.
template <class T, int BN, bool B_MN, int MODE, bool ROWS_FIRST, class Epi>
__global__ void __launch_bounds__(THREADS, 1)
gemm_kernel(const __grid_constant__ CUtensorMap ta, const __grid_constant__ CUtensorMap tb,
            const __grid_constant__ CUtensorMap ta2, const __grid_constant__ CUtensorMap tb2,
            int M, int N, int K, int splits, Epi epi) {
  using S = Shape<BN, MODE>;
  using Acc = typename Operand<T>::Acc;
  constexpr int ST = S::STAGES;
  constexpr bool kDual = MODE != COOP;
  constexpr bool kInt8 = std::is_same<T, int8_t>::value;
  constexpr bool kSeg = Segmented<Epi>::value;
  constexpr bool kRuns = SegMapped<Epi>::value;
  static_assert(!(kInt8 && B_MN), "an int8 B is K-contiguous: wgmma has no int8 transpose");
  static_assert(!kRuns || (kSeg && MODE == COOP), "runs: a segmented COOP product");
  static_assert(kInt8 || !kSeg, "segments fold an s32 accumulator");
  static_assert(kInt8 ? MODE != DUAL : MODE != DUAL_A, "int8: COOP or DUAL_A; bf16: COOP or DUAL");
  extern __shared__ unsigned char smem_raw[];
  // stages start on a 1024-byte boundary, the 128-byte swizzle's period
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t bars = base + ST * S::STAGE;  // full[ST], then empty[ST]
  const int wg = threadIdx.x / 128;
  const int kt_n = K / Operand<T>::K;
  const int tiles_n = (N + BN - 1) / BN, tiles_m = (M + BM - 1) / BM, tiles = tiles_n * tiles_m;
  const int items = tiles * splits;
  const int seg_n = seg_steps(epi);

  if (threadIdx.x == 0) {
    for (int s = 0; s < ST; ++s) {
      mbar_init(bars + 8 * s, 1);
      mbar_init(bars + 8 * (ST + s), CONSUMER_WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {
    // ---- producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 256) {
      int s = 0;
      uint32_t ph = 0;
      for (int t = blockIdx.x; t < items; t += gridDim.x) {
        const int tile = t % tiles, sp = t / tiles;
        int m0, n0;
        tile_origin<BN, ROWS_FIRST>(tile, tiles_n, tiles_m, m0, n0);
        const int k_end = (sp + 1) * kt_n / splits;
        for (int kt = sp * kt_n / splits; kt < k_end; ++kt) {
          const uint32_t full = bars + 8 * s, empty = bars + 8 * (ST + s);
          mbar_wait(empty, ph ^ 1);
          mbar_expect_tx(full, S::STAGE);
          const uint32_t sa = base + s * S::STAGE, sb = sa + S::A_BYTES;
          const int k0 = kt * Operand<T>::K;
          if constexpr (kRuns) {
            // k-step kt is stage kt % seg of run kt / seg
            const int run = kt / seg_n, c0 = (kt - run * seg_n) * Operand<T>::K;
            tma_load(sa, &ta, c0, run, m0, full);
            tma_load(sb, &tb, c0, run, n0, full);
          } else {
            tma_load(sa, &ta, k0, m0, full);
            if constexpr (B_MN) {
#pragma unroll
              for (int q = 0; q < BN / 64; ++q)
                tma_load(sb + q * (64 * BK * 2), &tb, n0 + 64 * q, k0, full);
            } else {
              tma_load(sb, &tb, k0, n0, full);
            }
            if constexpr (MODE == DUAL) {
              tma_load(sa + S::PAIR, &ta2, k0, m0, full);
              tma_load(sb + S::PAIR, &tb2, k0, n0, full);
            } else if constexpr (MODE == DUAL_A) {
              tma_load(sb + S::B_BYTES, &tb2, k0, n0, full);
            }
          }
          if (++s == ST) s = 0, ph ^= 1;
        }
      }
    }
  } else {
    // ---- consumers: warpgroup wg owns rows [m0 + 64 wg, m0 + 64 wg + 64)
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int lane = threadIdx.x & 31, w = (threadIdx.x >> 5) & 3;
    int s = 0;
    uint32_t ph = 0;
    for (int t = blockIdx.x; t < items; t += gridDim.x) {
      const int tile = t % tiles, sp = t / tiles;
      int m0, n0;
      tile_origin<BN, ROWS_FIRST>(tile, tiles_n, tiles_m, m0, n0);
      const int k_begin = sp * kt_n / splits, k_end = (sp + 1) * kt_n / splits;
      // thread (warp w, lane l) of the warpgroup holds rows 16 w + l / 4 (+
      // 8) and columns 8 j + 2 (l % 4) (+ 1) of its 64 x BN
      const int r0 = m0 + 64 * wg + 16 * w + (lane >> 2);
      // acc[0]: the product; dual: acc[1] the second one
      Acc acc[kDual ? 2 : 1][BN / 2];
      // segments: the fp32 sum of the segments done
      float sum[kSeg ? BN / 2 : 1];
      if constexpr (!kInt8) {
#pragma unroll
        for (int a = 0; a < (kDual ? 2 : 1); ++a)
#pragma unroll
          for (int e = 0; e < BN / 2; ++e) acc[a][e] = 0.0f;
      }
      int prev = -1;
      for (int kt = k_begin; kt < k_end; ++kt) {
        mbar_wait(bars + 8 * s, ph);
        const uint32_t sa = base + s * S::STAGE + wg * (64 * ROW_BYTES);
        const uint32_t sb = base + s * S::STAGE + S::A_BYTES;
        wgmma_fence();
        if constexpr (kInt8) {
          // each segment (or item) starts its s32 sums from zero
          const bool first = kt == k_begin || (kSeg && (kt - k_begin) % seg_n == 0);
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            const int scale_d = first && kk == 0 ? 0 : 1;
            mma_s8<BN>(acc[0], desc(sa + 32 * kk, 0, 1024), desc(sb + 32 * kk, 0, 1024), scale_d);
            if constexpr (MODE == DUAL_A)
              mma_s8<BN>(acc[1], desc(sa + 32 * kk, 0, 1024),
                         desc(sb + S::B_BYTES + 32 * kk, 0, 1024), scale_d);
          }
        } else {
#pragma unroll
          for (int kk = 0; kk < BK / 16; ++kk) {
            const uint64_t db =
                B_MN ? desc(sb + 2048 * kk, 64 * BK * 2, 1024) : desc(sb + 32 * kk, 0, 1024);
            mma<BN, B_MN ? 1 : 0>(acc[0], desc(sa + 32 * kk, 0, 1024), db);
            if constexpr (MODE == DUAL)
              mma<BN, 0>(acc[1], desc(sa + S::PAIR + 32 * kk, 0, 1024),
                         desc(sb + S::PAIR + 32 * kk, 0, 1024));
          }
        }
        wgmma_commit();
        if constexpr (kSeg) {
          const int seg = (kt - k_begin) / seg_n;
          if ((kt - k_begin + 1) % seg_n == 0) {
            // the segment's last stage: its sums, converted once, times the
            // segment's row factors, onto the fp32 sum in order
            wgmma_wait<0>();
            fence_regs(acc[0]);
            const float f0 = epi.scale(min(r0, M - 1), seg), f1 = epi.scale(min(r0 + 8, M - 1), seg);
#pragma unroll
            for (int e = 0; e < BN / 2; ++e) {
              const float v = __fmul_rn(__int2float_rn(acc[0][e]), (e & 2) ? f1 : f0);
              sum[e] = seg == 0 ? v : __fadd_rn(sum[e], v);
            }
          } else {
            wgmma_wait<1>();
          }
        } else {
          wgmma_wait<1>();  // the previous stage's products are done: release it
        }
        if (prev >= 0 && lane == 0) mbar_arrive(bars + 8 * (ST + prev));
        prev = s;
        if (++s == ST) s = 0, ph ^= 1;
      }
      wgmma_wait<0>();
      if (lane == 0) mbar_arrive(bars + 8 * (ST + prev));  // the tile's last stage
#pragma unroll
      for (int a = 0; a < (kDual ? 2 : 1); ++a) fence_regs(acc[a]);

      // ---- epilogue.  Every pair is computed, at indices clamped into (M,
      // N), and stored only inside: branch-free arithmetic the compiler can
      // interleave.  Split s hands the epilogue row r + s M (its slice).
      const int slice = sp * M;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int c = n0 + 8 * j + 2 * (lane & 3);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = r0 + 8 * h, e = 4 * j + 2 * h;
          const bool in = r < M && c < N;
          const int rc = (r < M ? r : M - 1) + slice, cc = c < N ? c : N - 2;
          if constexpr (kSeg)
            epi(rc, cc, sum[e], sum[e + 1], in);
          else if constexpr (kDual)
            epi(rc, cc, acc[0][e], acc[0][e + 1], acc[1][e], acc[1][e + 1], in);
          else
            epi(rc, cc, acc[0][e], acc[0][e + 1], in);
        }
      }
    }
  }
}

inline int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    if (n <= 0) n = 132;
  }
  return n;
}

// A tile width and a split count for an (M, N, K) product.
struct Tiling {
  int bn, splits;
};

// Of the tile widths offered (narrow, wide) and 1 .. max_splits splits of
// K, the pair whose waves of work items over the SMs take least time:
// waves x (k-steps per item + 2, a tile's fill and epilogue) x width; of
// equal ones the wide tile (fewest bytes from L2 per operation) and the
// fewest splits (fewest bytes of partial sums).  K in k-steps of kstep:
// BK for bf16, ROW_BYTES (128) for int8.
inline Tiling pick_tiling(int M, int N, int K, int narrow, int wide, int max_splits,
                          int kstep = BK) {
  const int kt = K / kstep;
  Tiling best{wide, 1};
  long best_cost = -1;
  for (const int bn : {wide, narrow}) {
    const long tiles = (long)((N + bn - 1) / bn) * ((M + BM - 1) / BM);
    for (int s = 1; s <= max_splits && s <= kt; ++s) {
      const long waves = (tiles * s + sm_count() - 1) / sm_count();
      const long cost = waves * ((kt + s - 1) / s + 2) * bn;
      if (best_cost < 0 || cost < best_cost) best = Tiling{bn, s}, best_cost = cost;
    }
  }
  return best;
}

// The tiling of a product whose fp32 slices a row pass adds (StoreF32):
// 128 or 192 wide, at most MAX_SPLITS splits.
constexpr int MAX_SPLITS = 8;
inline Tiling split_k_tiling(int M, int N, int K) { return pick_tiling(M, N, K, 128, 192, MAX_SPLITS); }

template <class T>
struct Same {
  using type = T;
};

// C = A B through the kernel above, epilogue `epi`.  a: (M, K); b: (K, N)
// when B_MN, else (N, K); dual: a2 (M, K), b2 (N, K); DUAL_A: b2 (N, K);
// K in whole stages, or with a last stage in part (rows of 16-byte
// multiples), or in runs (SegMapped); splits: of K (see the head of this
// file; 1 for a segmented epilogue, whose seg must divide the k-steps).
// Returns the launch's error (cudaErrorInvalidValue for a shape or pointer
// the maps refuse).
template <int BN, bool B_MN, int MODE = COOP, bool ROWS_FIRST = false, class Epi, class T>
cudaError_t gemm(const T* a, const T* b, int M, int N, int K, Epi epi, cudaStream_t st,
                 const typename Same<T>::type* a2 = nullptr,
                 const typename Same<T>::type* b2 = nullptr, int splits = 1) {
  using S = Shape<BN, MODE>;
  constexpr int KB = Operand<T>::K;
  constexpr bool kRuns = SegMapped<Epi>::value;
  if (M <= 0 || N <= 0 || K <= 0 || (K * sizeof(T)) % 16 != 0) return cudaErrorInvalidValue;
  // the kernel's K: whole stages (of each run)
  int kp = (K + KB - 1) / KB * KB;
  if constexpr (kRuns) {
    const int run = epi.seg_cols;
    if (run <= 0 || K % run != 0 || (run * sizeof(T)) % 16 != 0 || epi.seg != (run + KB - 1) / KB)
      return cudaErrorInvalidValue;
    kp = K / run * epi.seg * KB;
  }
  if (splits < 1 || splits > kp / KB) return cudaErrorInvalidValue;
  if constexpr (Segmented<Epi>::value) {
    if (splits != 1 || epi.seg <= 0 || (kp / KB) % epi.seg != 0) return cudaErrorInvalidValue;
  }
  CUtensorMap ta, tb, ta2, tb2;
  cudaError_t e;
  if constexpr (kRuns) {
    if ((e = make_map_runs<T>(&ta, a, M, K, epi.seg_cols, BM)) != cudaSuccess) return e;
    if ((e = make_map_runs<T>(&tb, b, N, K, epi.seg_cols, BN)) != cudaSuccess) return e;
  } else {
    if ((e = make_map<T>(&ta, a, M, K, BM)) != cudaSuccess) return e;
    if ((e = B_MN ? make_map<T>(&tb, b, K, N, 64) : make_map<T>(&tb, b, N, K, BN)) !=
        cudaSuccess)
      return e;
  }
  ta2 = ta, tb2 = tb;
  if constexpr (MODE == DUAL) {
    if ((e = make_map<T>(&ta2, a2, M, K, BM)) != cudaSuccess) return e;
  }
  if constexpr (MODE != COOP) {
    if ((e = make_map<T>(&tb2, b2, N, K, BN)) != cudaSuccess) return e;
  }
  auto kernel = gemm_kernel<T, BN, B_MN, MODE, ROWS_FIRST, Epi>;
  static bool smem_set = false;  // once per instantiation and library
  if (!smem_set) {
    if ((e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)S::SMEM)) != cudaSuccess)
      return e;
    smem_set = true;
  }
  const int items = ((N + BN - 1) / BN) * ((M + BM - 1) / BM) * splits;
  kernel<<<items < sm_count() ? items : sm_count(), THREADS, S::SMEM, st>>>(ta, tb, ta2, tb2, M,
                                                                          N, kp, splits, epi);
  return cudaGetLastError();
}

// Epilogue: the fp32 product itself, (M, N) at c; with S splits the
// (S M, N) slices, slice s the partial sum of split s.
struct StoreF32 {
  float* c;
  int n;
  __device__ __forceinline__ void operator()(int r, int col, float v0, float v1, bool in) const {
    if (in) *reinterpret_cast<float2*>(c + (size_t)r * n + col) = make_float2(v0, v1);
  }
};

// The same for the int8 instance: the s32 product, or its (S M, N) slices.
struct StoreS32 {
  int* c;
  int n;
  __device__ __forceinline__ void operator()(int r, int col, int v0, int v1, bool in) const {
    if (in) *reinterpret_cast<int2*>(c + (size_t)r * n + col) = make_int2(v0, v1);
  }
};

}  // namespace sm90
}  // namespace
