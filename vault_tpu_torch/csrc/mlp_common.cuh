// Pieces shared by the fused MLP kernels, forward (mlp.cu) and backward
// (mlp_bwd.cu): the walk's tiling constants, cp.async helpers, the split
// picker and the main forward walk (mlp_main: the fp32 blocks, with fp32 or
// int8 weights; the fp32 post-LN backward reruns it to rebuild the MLP
// output before its LayerNorm backward); for the wgmma route the width contract,
// the row kernels' shapes (row_shape), ln_rows_bf16 and the first
// products' activation epilogue (EpiAct).
//
// mlp_main: grid (row tiles, splits).  Block (r, s) owns rows [32 r, 32 r +
// 32) and I columns [s * ic, (s + 1) * ic).  It computes LN(x) (pre-LN) or
// x (post-LN) once into shared memory, then walks its slice 128 columns at
// a time: act(xa W1[:, j:j+128] + b1) into shared memory (also written to
// a_out when that is given), then that slice's
// contribution to all H output columns, accumulated in fp32 across the
// walk.  W1 and W2 stream through shared memory in tiles, double-buffered
// with cp.async; plain FMA in full fp32.  The block writes its fp32
// partial (32, H) to ws[s].
//
// Weight type W: T (the fp blocks), or int8_t with per-column fp32 scales s1
// (I) and s2 (H) (the w8 blocks).  int8 tiles arrive through the same
// cp.async ring at a quarter of the bytes (dense rows of 128 or H bytes,
// every copy 16-byte aligned), and each is dequantized into one tile of T in
// shared memory before the product reads it: w = T(float(q) * s), as the
// plain version's linear does.  One barrier separates the copy's arrival
// from that pass, another the pass from the product.
#pragma once

#include <math.h>
#include <stdint.h>
#include <type_traits>

#include "common.cuh"

namespace {

constexpr int BM = 32;       // rows per block of mlp_main
constexpr int NW = 8;        // warps per block
constexpr int NT = NW * 32;  // threads per block
constexpr int BN1 = 128;     // I columns per sub-slice (16 per warp)
constexpr int TPR = NT / BM; // threads per row in mlp_main's prologue (8)

template <typename T> struct Tiles {
  static constexpr int PAD = 16 / sizeof(T);                // 16-byte row pad
  static constexpr int KT1 = 256 / sizeof(T);               // W1 tile rows (k)
  static constexpr int KT2 = 64 / sizeof(T);                // W2 tile rows (k)
  static constexpr int LD1 = BN1 + PAD;                     // W1 tile / hs ld
};

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

// Shared-memory bytes of mlp_main: the weight ring (two tiles of W, plus
// one dequantized tile of T when W is int8), xa and hs.
template <typename T, int H, typename W = T>
constexpr size_t main_smem() {
  using TL = Tiles<T>;
  constexpr size_t w1 = (size_t)TL::KT1 * TL::LD1;
  constexpr size_t w2 = (size_t)TL::KT2 * (H + TL::PAD);
  constexpr size_t buf = w1 > w2 ? w1 : w2;  // elements
  constexpr size_t ring = std::is_same<W, T>::value ? 2 * buf * sizeof(T)
                                                     : 2 * buf + buf * sizeof(T);
  return ring + (size_t)BM * (H + TL::PAD) * sizeof(T)       // ring, xa
         + (size_t)BM * TL::LD1 * sizeof(T);                 // hs
}

// (rows, cols) int8 codes, dense, -> dst (ld elements a row) as
// T(float(q) * scale[col]), four columns a step.
template <typename T>
__device__ __forceinline__ void dequant_tile(const int8_t* __restrict__ src, T* __restrict__ dst,
                                             int rows, int cols, int ld,
                                             const float* __restrict__ scale) {
  const int per_row = cols / 4;
  for (int c = threadIdx.x; c < rows * per_row; c += NT) {
    const int r = c / per_row, col = (c % per_row) * 4;
    const char4 q = *reinterpret_cast<const char4*>(src + r * cols + col);
    const float4 s = *reinterpret_cast<const float4*>(scale + col);
    T* d = dst + r * ld + col;
    d[0] = vt::from_f<T>(__fmul_rn(static_cast<float>(q.x), s.x));
    d[1] = vt::from_f<T>(__fmul_rn(static_cast<float>(q.y), s.y));
    d[2] = vt::from_f<T>(__fmul_rn(static_cast<float>(q.z), s.z));
    d[3] = vt::from_f<T>(__fmul_rn(static_cast<float>(q.w), s.w));
  }
}

template <typename T, int NF, bool POSTLN, typename W = T>
__global__ void __launch_bounds__(NT)
mlp_main(const T* __restrict__ x, const T* __restrict__ gamma,
         const T* __restrict__ beta, const W* __restrict__ w1,
         const T* __restrict__ b1, const W* __restrict__ w2,
         float* __restrict__ ws, T* __restrict__ a_out, int rows, int rows_pad,
         int I, int ic, float eps, int act, const float* __restrict__ s1,
         const float* __restrict__ s2) {
  using TL = Tiles<T>;
  constexpr int H = NF * 16 * NW;
  constexpr int LDX = H + TL::PAD;
  constexpr int LD2 = H + TL::PAD;
  constexpr int LD1 = TL::LD1;
  constexpr int KT1 = TL::KT1, KT2 = TL::KT2;
  constexpr int N1 = H / KT1;        // W1 tiles per sub-slice
  constexpr int N2 = BN1 / KT2;      // W2 tiles per sub-slice
  constexpr int BUF = (KT1 * LD1 > KT2 * LD2) ? KT1 * LD1 : KT2 * LD2;  // elements
  static_assert(std::is_same<T, float>::value, "the walk runs the fp32 blocks alone");
  constexpr bool kQ8 = !std::is_same<W, T>::value;
  constexpr int SD1 = kQ8 ? BN1 : LD1;  // row strides of the ring's tiles
  constexpr int SD2 = kQ8 ? H : LD2;

  extern __shared__ __align__(128) unsigned char smem_raw[];
  W* ring = reinterpret_cast<W*>(smem_raw);  // 2 x BUF: the cp.async ring
  // the tiles the products read: the ring itself, or (int8 weights) one
  // dequantized tile behind it
  T* wbuf = kQ8 ? reinterpret_cast<T*>(ring + 2 * BUF) : reinterpret_cast<T*>(smem_raw);
  T* xa = wbuf + (kQ8 ? 1 : 2) * BUF;        // (BM, LDX) first operand
  T* hs = xa + BM * LDX;                     // (BM, LD1) activation

  const int tid = threadIdx.x, w = tid >> 5, lane = tid & 31;
  const int row0 = blockIdx.x * BM;
  const int i0 = blockIdx.y * ic;
  const int n_tiles = (ic / BN1) * (N1 + N2);

  // tile t of the stream: sub-slice t / (N1 + N2); first N1 tiles are W1
  // (KT1 x 128 at rows k0, columns i0 + 128 sub), then N2 tiles of W2
  // (KT2 x H at rows i0 + 128 sub + k0).
  auto fetch = [&](int t) {
    W* dst = ring + (t & 1) * BUF;
    const int sub = t / (N1 + N2), p = t % (N1 + N2);
    constexpr int V = 16 / sizeof(W);  // elements per 16-byte copy
    if (p < N1) {
      const W* src = w1 + (size_t)(p * KT1) * I + i0 + sub * BN1;
      for (int c = tid; c < KT1 * (BN1 / V); c += NT) {
        const int r = c / (BN1 / V), col = (c % (BN1 / V)) * V;
        cp_async16(dst + r * SD1 + col, src + (size_t)r * I + col);
      }
    } else {
      const W* src = w2 + (size_t)(i0 + sub * BN1 + (p - N1) * KT2) * H;
      for (int c = tid; c < KT2 * (H / V); c += NT) {
        const int r = c / (H / V), col = (c % (H / V)) * V;
        cp_async16(dst + r * SD2 + col, src + (size_t)r * H + col);
      }
    }
    cp_async_commit();
  };

  fetch(0);

  // ---- prologue: xa = LN(x) (pre-LN) or x (post-LN); rows past `rows` are 0
  {
    const int r = tid / TPR, cl = tid % TPR;
    const bool ok = row0 + r < rows;
    const T* xr = x + (size_t)(row0 + r) * H;
    float sum = 0.0f;
    for (int c = cl; c < H; c += TPR) {
      const T v = ok ? xr[c] : vt::from_f<T>(0.0f);
      xa[r * LDX + c] = v;
      sum += vt::to_f(v);
    }
    if constexpr (!POSTLN) {
      const float mean = group_sum<TPR>(sum) / H;
      float sq = 0.0f;
      for (int c = cl; c < H; c += TPR) {
        const float d = vt::to_f(xa[r * LDX + c]) - mean;
        sq += d * d;
      }
      const float inv = 1.0f / sqrtf(group_sum<TPR>(sq) / H + eps);
      for (int c = cl; c < H; c += TPR) {
        const float y = (vt::to_f(xa[r * LDX + c]) - mean) * inv;
        xa[r * LDX + c] = vt::from_f<T>(y * vt::to_f(gamma[c]) + vt::to_f(beta[c]));
      }
    }
  }

  // accumulators: thread (r = tid/8, q = tid%8) owns GEMM1 columns 16 q ..
  // 16 q + 16 and GEMM2 columns q + 8 j of row r.
  constexpr int F1 = BN1 / 8, F2 = H / 8;
  float f1[F1], f2[F2];
#pragma unroll
  for (int i = 0; i < F1; ++i) f1[i] = 0.0f;
#pragma unroll
  for (int i = 0; i < F2; ++i) f2[i] = 0.0f;
  const int fr = tid >> 3, fq = tid & 7;  // fp32 thread mapping

  for (int t = 0; t < n_tiles; ++t) {
    if (t + 1 < n_tiles) {
      fetch(t + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // tile t (and, at t = 0, xa) visible to every warp
    const int sub = t / (N1 + N2), p = t % (N1 + N2);
    const T* wt = wbuf + (kQ8 ? 0 : (t & 1) * BUF);
    if constexpr (kQ8) {
      const W* q = ring + (t & 1) * BUF;
      if (p < N1) dequant_tile<T>(q, wbuf, KT1, BN1, LD1, s1 + i0 + sub * BN1);
      else dequant_tile<T>(q, wbuf, KT2, H, LD2, s2);
      __syncthreads();  // the dequantized tile is whole before any fragment loads
    }
    if (p < N1) {
      // GEMM1: acc1 += xa[:, k0:k0+KT1] wt
      const int k0 = p * KT1;
      for (int k = 0; k < KT1; ++k) {
        const float a = xa[fr * LDX + k0 + k];
#pragma unroll
        for (int c = 0; c < F1; ++c) f1[c] = fmaf(a, wt[k * LD1 + fq * F1 + c], f1[c]);
      }
      if (p == N1 - 1) {
        // sub-slice done: hs = act(acc1 + b1)
        const int j0 = i0 + sub * BN1;
#pragma unroll
        for (int c = 0; c < F1; ++c) {
          const int cc = fq * F1 + c;
          const float av = vt::activate(f1[c] + b1[j0 + cc], act);
          hs[fr * LD1 + cc] = av;
          if (a_out && row0 + fr < rows) a_out[(size_t)(row0 + fr) * I + j0 + cc] = av;
          f1[c] = 0.0f;
        }
      }
    } else {
      // GEMM2: acc2 += hs[:, k0:k0+KT2] wt   (hs complete: written before
      // the previous iteration's closing barrier)
      const int k0 = (p - N1) * KT2;
      for (int k = 0; k < KT2; ++k) {
        const float a = hs[fr * LD1 + k0 + k];
#pragma unroll
        for (int j = 0; j < F2; ++j) f2[j] = fmaf(a, wt[k * LD2 + fq + 8 * j], f2[j]);
      }
    }
    __syncthreads();  // every warp is done with this tile and hs
  }

  // partial sums of this split -> ws[split] (rows padded to BM)
  float* dst = ws + ((size_t)blockIdx.y * rows_pad + row0) * H;
#pragma unroll
  for (int j = 0; j < F2; ++j) dst[(size_t)fr * H + fq + 8 * j] = f2[j];
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

// Splits of I for blocks of `bm` rows: the fewest that keep the waves of
// one-block-per-SM shortest.
int pick_splits(int rows, int I, int bm = BM) {
  const int tiles = (rows + bm - 1) / bm, nsub = I / BN1, sms = num_sms();
  int best = 1;
  long best_cost = -1;
  for (int s = 1; s <= nsub; ++s) {
    if (nsub % s) continue;
    const long waves = (tiles * (long)s + sms - 1) / sms;
    const long cost = waves * (nsub / s);
    if (best_cost < 0 || cost < best_cost) best = s, best_cost = cost;
  }
  return best;
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
