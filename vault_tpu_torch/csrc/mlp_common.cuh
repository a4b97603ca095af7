// Pieces shared by the fused MLP kernels, forward (mlp.cu) and backward
// (mlp_bwd.cu), and the LN->QKV kernels: cp.async helpers, fixed-order
// sums, the SM count, the shared-memory opt-in; for the wgmma route the
// width contract, the row kernels' shapes (row_shape), ln_rows_bf16 and the
// first products' activation epilogue (EpiAct).
#pragma once

#include <math.h>
#include <stdint.h>
#include <type_traits>

#include "common.cuh"

namespace {

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

template <int W>
__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int o = W / 2; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

int num_sms() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    if (n <= 0) n = 132;
  }
  return n;
}

// Raise a kernel's dynamic shared-memory limit, once per kernel and process.
template <auto KERNEL>
cudaError_t allow_smem(size_t bytes) {
  static bool done = false;
  if (done) return cudaSuccess;
  const cudaError_t e = cudaFuncSetAttribute(
      KERNEL, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e == cudaSuccess) done = true;
  return e;
}

// Row kernels (the LN passes after the products) take H at run time, any
// multiple of 64 up to 8,192.  A block takes a row at a time, thread t of
// its T holding columns t + T i, i < PER, in registers: 128 threads and PER
// the next of 2, 4, 6, 8 up to H = 1,024 (H = 768: PER 6), then 16 columns
// a thread, T = 128 ceil(H / 2,048) up to 512 threads.  The launch bounds
// follow (row_threads: 128 threads leave a thread up to 255 registers, 512
// threads 128; bounded at 1,024 threads' 64, the LN backward rows spilled).
// Sums over a row run in a fixed order: a thread's columns in order, the
// warp's butterfly, then the warps in order.  (A warp a row, tried for
// H <= 1,024, needed 145-230 registers a thread at H = 768 and took longer
// at 320 and 8,192 rows.)
constexpr int ROW_MAX_THREADS = 512;
constexpr int ROW_MAX_H = 8192;

// The widths the bf16 blocks on the wgmma core take (the core: K a multiple
// of 64 for both products, 16-byte TMA rows; the row kernels: H <= 8,192).
inline bool core_shape_ok(int rows, int H, int I) {
  return rows > 0 && H >= 64 && H <= ROW_MAX_H && H % 64 == 0 && I >= 64 && I % 64 == 0;
}

// The widths the fp32 blocks on gemm_tiles take (gemm_tiles.cuh: both
// products' N a multiple of 128; the pre-LN row pass gm::row_prologue: H a
// multiple of its 128 threads up to 8,192).
inline bool tiles_shape_ok(int rows, int H, int I) {
  return rows > 0 && H >= 128 && H <= ROW_MAX_H && H % 128 == 0 && I >= 128 && I % 128 == 0;
}

// exact: H = threads x PER, every column a thread holds lies in the row,
// and the kernels drop the column masks (H = 256, 512, 768, 1,024, and 16
// T above).  With run-time masks and stride the pre-LN rows at 8,192 rows
// took twice their time at a fixed width; up to H = 1,024 the stride (128)
// is a compile-time constant too.
struct RowShape {
  int threads, per;
  bool exact;
};

inline RowShape row_shape(int H) {
  RowShape rs;
  if (H <= 1024) {
    const int per = (H + 127) / 128;
    rs = RowShape{128, per <= 2 ? 2 : per <= 4 ? 4 : per <= 6 ? 6 : 8, false};
  } else {
    rs = RowShape{(H + 2047) / 2048 * 128, 16, false};
  }
  rs.exact = H == rs.threads * rs.per;
  return rs;
}

template <int PER>
constexpr int row_threads() { return PER <= 8 ? 128 : ROW_MAX_THREADS; }

// The column stride of a row kernel's thread: 128 at compile time up to
// PER = 8 (row_shape), the block's size above.
template <int PER>
__device__ __forceinline__ int row_stride() { return PER <= 8 ? 128 : (int)blockDim.x; }

// f(std::integral_constant<int, PER>, std::bool_constant<EXACT>) for the
// shape row_shape picked; returns the launch's error.
template <class F>
cudaError_t with_rows(const RowShape& rs, F f) {
  auto go = [&](auto P) {
    if (rs.exact) f(P, std::true_type{});
    else f(P, std::false_type{});
  };
  switch (rs.per) {
    case 2: go(std::integral_constant<int, 2>{}); break;
    case 4: go(std::integral_constant<int, 4>{}); break;
    case 6: go(std::integral_constant<int, 6>{}); break;
    case 8: go(std::integral_constant<int, 8>{}); break;
    case 16: go(std::integral_constant<int, 16>{}); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

// The sum of a over the block's threads (blockDim.x a multiple of 32), in
// a fixed order; red holds blockDim.x / 32 floats.
__device__ __forceinline__ float row_block_sum(float a, float* red) {
  a = group_sum<32>(a);
  __syncthreads();  // red is free (its last readers are done)
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = a;
  __syncthreads();
  float t = 0.0f;
  for (int w = 0; w < (int)(blockDim.x >> 5); ++w) t += red[w];
  return t;
}

// Epilogue of a first product: a = bf16(act(acc + b1)), ACT a vt::Act code
// fixed at compile time (a run-time switch in the epilogue cost a quarter
// of the product's time at 1,280 rows).
template <int ACT>
struct EpiAct {
  const __nv_bfloat16* b1;
  __nv_bfloat16* a;
  int n;
  __device__ __forceinline__ void operator()(int r, int c, float v0, float v1, bool in) const {
    const __nv_bfloat162 b = __ldg(reinterpret_cast<const __nv_bfloat162*>(b1 + c));
    const __nv_bfloat162 o(vt::from_f<__nv_bfloat16>(vt::activate(v0 + vt::to_f(b.x), ACT)),
                           vt::from_f<__nv_bfloat16>(vt::activate(v1 + vt::to_f(b.y), ACT)));
    if (in) *reinterpret_cast<__nv_bfloat162*>(a + (size_t)r * n + c) = o;
  }
};

// f(EpiAct<code>{b1, a, n}) for the run-time activation code; returns f's
// error, cudaErrorInvalidValue for an unknown code.
template <class F>
cudaError_t with_act(int act, const __nv_bfloat16* b1, __nv_bfloat16* a, int n, F f) {
  switch (act) {
    case vt::kGeluErf: return f(EpiAct<vt::kGeluErf>{b1, a, n});
    case vt::kGeluTanh: return f(EpiAct<vt::kGeluTanh>{b1, a, n});
    case vt::kRelu: return f(EpiAct<vt::kRelu>{b1, a, n});
    default: return cudaErrorInvalidValue;
  }
}

// One warp per row of H bf16 values (H a multiple of 8): y = bf16(LN(x))
// with fp32 statistics as mlp_main's prologue takes them; with g given also
// gc = bf16(g m) (the masked cotangent of the backward).  Rows past `rows`
// are skipped.  Three passes over the row, 16 bytes a lane at a time: the
// sum, the squared deviations, the output; the second and third read the
// row again (from L1), so no width is held in registers.
constexpr int LN_WARPS = 8;
constexpr int V8 = 8;  // bf16 values in 16 bytes

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&v)[V8]) {
  const uint4 q = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&q);
#pragma unroll
  for (int k = 0; k < V8; ++k) v[k] = vt::to_f(e[k]);
}

// The same for fp32 (two 16-byte loads).
__device__ __forceinline__ void load8(const float* p, float (&v)[V8]) {
  const float4 lo = *reinterpret_cast<const float4*>(p);
  const float4 hi = *reinterpret_cast<const float4*>(p + 4);
  v[0] = lo.x, v[1] = lo.y, v[2] = lo.z, v[3] = lo.w;
  v[4] = hi.x, v[5] = hi.y, v[6] = hi.z, v[7] = hi.w;
}

__global__ void __launch_bounds__(LN_WARPS * 32)
ln_rows_bf16(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ gamma,
             const __nv_bfloat16* __restrict__ beta, __nv_bfloat16* __restrict__ y,
             const __nv_bfloat16* __restrict__ g, const __nv_bfloat16* __restrict__ m,
             __nv_bfloat16* __restrict__ gc, int rows, int H, float eps) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * LN_WARPS + (threadIdx.x >> 5);
  if (row >= rows) return;
  const size_t off = (size_t)row * H;
  const int nv = H / V8;  // 16-byte vectors in the row
  float v[V8];
  float sum = 0.0f;
  for (int i = lane; i < nv; i += 32) {
    load8(x + off + i * V8, v);
#pragma unroll
    for (int k = 0; k < V8; ++k) sum += v[k];
  }
  const float mean = group_sum<32>(sum) / H;
  float sq = 0.0f;
  for (int i = lane; i < nv; i += 32) {
    load8(x + off + i * V8, v);
#pragma unroll
    for (int k = 0; k < V8; ++k) sq += (v[k] - mean) * (v[k] - mean);
  }
  const float inv = 1.0f / sqrtf(group_sum<32>(sq) / H + eps);
  for (int i = lane; i < nv; i += 32) {
    const int c = i * V8;
    float ga[V8], be[V8];
    load8(x + off + c, v);
    load8(gamma + c, ga);
    load8(beta + c, be);
    uint4 out;
    __nv_bfloat16* o = reinterpret_cast<__nv_bfloat16*>(&out);
#pragma unroll
    for (int k = 0; k < V8; ++k) o[k] = vt::from_f<__nv_bfloat16>((v[k] - mean) * inv * ga[k] + be[k]);
    *reinterpret_cast<uint4*>(y + off + c) = out;
    if (gc != nullptr) {
      float ge[V8], me[V8];
      load8(g + off + c, ge);
      load8(m + off + c, me);
#pragma unroll
      for (int k = 0; k < V8; ++k) o[k] = vt::from_f<__nv_bfloat16>(ge[k] * me[k]);
      *reinterpret_cast<uint4*>(gc + off + c) = out;
    }
  }
}

}  // namespace
