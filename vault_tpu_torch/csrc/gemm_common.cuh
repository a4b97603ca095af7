// Pieces shared by the LN->QKV kernels (ln_qkv.cu) and the w8a8 kernels
// (mlp_w8a8.cu, swiglu_w8a8.cu):
//
//   * row helpers for one block of RT threads per row, the whole row in
//     registers: a LayerNorm (ln_row), a row's int8 quantization (quant,
//     quant_scale), sums and maxima over the block in a fixed order, the
//     row kernel row_prologue (LN and/or quantization of each row), pairs
//     of T to and from fp32, and eight values' int8 codes (quant8);
//   * gemm_tiles, a tiled product C = A B with A (M, K) and B (K, N) both
//     row-major as the JAX package stores them, through the tensor cores
//     (int8 x int8 -> int32; wmma 16x16x16) or plain fp32 FMA, with a bias
//     (fp32) or a dequantization and a bias (int8) in its epilogue: the
//     fp32 and w8a8 LN->QKV products.
//
// Numerics.  The LayerNorm takes its mean and variance in double from the
// fp32 row and rounds them to fp32, then normalises in fp32: the
// statistics are the correctly rounded ones, so the plain versions in
// ops/cuda_ln_qkv.py and ops/cuda_mlp.py (which take them the same way in
// PyTorch) give the same bits, and so the same int8 codes, where fp32
// statistics summed in two different orders would differ by an ulp and flip
// a code now and then.  Quantization: scale = max(absmax, 1e-8) / 127 and
// q = clip(rint(v / scale), -127, 127), both true divisions (__fdiv_rn),
// rint half to even as jnp.round.  Dequantization: acc * (row scale *
// column scale) + bias, the two scales multiplied first, as the JAX
// package's linear does.  Every fp32 step is an _rn intrinsic, so nvcc
// contracts none into an FMA (which rounds once where PyTorch rounds twice).
// The activations are written the way the plain versions write them, one
// rounding a step: the exact-erf GELU v * (erf(v * 0.70710677f) + 1) * 0.5,
// the tanh form 0.5 v (1 + tanh(0.7978846 (v + 0.044715 v v v))) in
// ops/nn.py gelu_tanh's order (tanhf, as torch.tanh on the card), ReLU.
//
// gemm_tiles: a block owns a (64, 128) tile of C and walks K in steps of
// 64, the next A and B tiles loading with cp.async while the tensor cores
// work on the current ones (double buffering).  Shared memory holds each
// tile as 16-column chunks, each chunk a dense (rows, 16) array, so every
// wmma fragment starts 32-byte aligned (the rule for load_matrix_sync) and
// reads 16-byte rows.  Eight warps, 2 x 4, each own a (32, 32) piece: four
// accumulator fragments.  int8 B fragments are row-major, which wmma takes
// (PTX mma.sync takes s8 B only column-major), so the weights keep their
// (in, out) layout.
#pragma once

#include <stdint.h>

#include <type_traits>

#include "mlp_common.cuh"  // cp.async helpers, allow_smem, load8

namespace {
namespace gm {

constexpr int RT = 128;  // threads of a row kernel
constexpr int ROW_H_MAX = 8192;  // the widest row a row kernel holds in registers
constexpr int BM = 64, BN = 128, BK = 64;
constexpr int CH = 16;   // columns per shared-memory chunk
constexpr int NT = 256;  // threads of gemm_tiles (8 warps)
constexpr int LDS = BN + 4;  // ld of the epilogue's staging tile

enum Epi {
  kBias = 0,     // out = T(acc + bias)                      (fp products)
  kDequant = 1,  // out = T(acc * (rs * cs) + bias)           (int8)
};

__device__ __forceinline__ float act_rn(float v, int act) {
  if (act == vt::kGeluErf)
    return __fmul_rn(__fmul_rn(v, __fadd_rn(erff(__fmul_rn(v, 0.70710678118654752440f)), 1.0f)),
                     0.5f);
  if (act == vt::kGeluTanh) {
    const float cube = __fmul_rn(__fmul_rn(__fmul_rn(0.044715f, v), v), v);
    const float u = __fmul_rn(0.7978845608028654f, __fadd_rn(v, cube));
    return __fmul_rn(__fmul_rn(0.5f, v), __fadd_rn(1.0f, tanhf(u)));
  }
  return fmaxf(v, 0.0f);
}

__device__ __forceinline__ float quant_scale(float absmax) {
  return __fdiv_rn(fmaxf(absmax, 1e-8f), 127.0f);
}

__device__ __forceinline__ int8_t quant(float v, float scale) {
  const float r = rintf(__fdiv_rn(v, scale));
  return static_cast<int8_t>(static_cast<int>(fminf(fmaxf(r, -127.0f), 127.0f)));
}

// Sums and maxima over the block in a fixed order (deterministic).
__device__ __forceinline__ double block_sum(double v, double* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  __syncthreads();  // red is free: its last readers are done
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  double t = 0.0;
#pragma unroll
  for (int w = 0; w < RT / 32; ++w) t += red[w];
  return t;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// The maximum of v >= 0 over a block of at most WARPS warps; red holds
// WARPS floats, those of warps the block lacks 0.
template <int WARPS = RT / 32>
__device__ __forceinline__ float block_max(float v, float* red) {
  v = warp_max(v);
  __syncthreads();
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float t = 0.0f;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) t = fmaxf(t, red[w]);
  return t;
}

// LayerNorm of a row of H = RT n columns held as v[i] = column tid + RT i,
// i < n <= PER, in place.
template <typename T, int PER>
__device__ __forceinline__ void ln_row(float (&v)[PER], int n, const T* __restrict__ gamma,
                                       const T* __restrict__ beta, float eps, double* red) {
  const int H = RT * n;
  double s = 0.0;
#pragma unroll
  for (int i = 0; i < PER; ++i)
    if (i < n) s += static_cast<double>(v[i]);
  const float mean = static_cast<float>(block_sum(s, red) / H);
  double q = 0.0;
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    if (i < n) {
      v[i] = __fsub_rn(v[i], mean);
      q += static_cast<double>(v[i]) * static_cast<double>(v[i]);
    }
  }
  const float var = static_cast<float>(block_sum(q, red) / H);
  const float rstd = __fdiv_rn(1.0f, __fsqrt_rn(__fadd_rn(var, eps)));
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int c = threadIdx.x + RT * i;
    if (i < n)
      v[i] = __fadd_rn(__fmul_rn(__fmul_rn(v[i], rstd), vt::to_f(gamma[c])), vt::to_f(beta[c]));
  }
}

// One row per block, H = RT n columns, n <= PER: [LN(x) rounded to T (LN)]
// then either the row in T (y) or its int8 codes and scale (QUANT: q,
// scale).
template <typename T, int PER, bool LN, bool QUANT>
__global__ void __launch_bounds__(RT)
row_prologue(const T* __restrict__ x, const T* __restrict__ gamma, const T* __restrict__ beta,
             T* __restrict__ y, int8_t* __restrict__ q, float* __restrict__ scale, int H,
             float eps) {
  __shared__ double redd[RT / 32];
  __shared__ float redf[RT / 32];
  const int n = H / RT;
  const size_t base = static_cast<size_t>(blockIdx.x) * H + threadIdx.x;
  float v[PER];
#pragma unroll
  for (int i = 0; i < PER; ++i) v[i] = i < n ? vt::to_f(x[base + RT * i]) : 0.0f;
  if constexpr (LN) {
    ln_row<T, PER>(v, n, gamma, beta, eps, redd);
#pragma unroll
    for (int i = 0; i < PER; ++i) v[i] = vt::to_f(vt::from_f<T>(v[i]));
  }
  if constexpr (!QUANT) {
#pragma unroll
    for (int i = 0; i < PER; ++i)
      if (i < n) y[base + RT * i] = vt::from_f<T>(v[i]);
  } else {
    float m = 0.0f;
#pragma unroll
    for (int i = 0; i < PER; ++i) m = fmaxf(m, fabsf(v[i]));
    const float s = quant_scale(block_max(m, redf));
#pragma unroll
    for (int i = 0; i < PER; ++i)
      if (i < n) q[base + RT * i] = quant(v[i], s);
    if (threadIdx.x == 0) scale[blockIdx.x] = s;
  }
}

// f(std::integral_constant<int, PER>) for a row kernel of H = RT n
// columns, n <= PER, H <= ROW_H_MAX; returns the launch's error.
template <class F>
cudaError_t with_per(int H, F f) {
  if (H <= 8 * RT) f(std::integral_constant<int, 8>());
  else if (H <= 32 * RT) f(std::integral_constant<int, 32>());
  else f(std::integral_constant<int, ROW_H_MAX / RT>());
  return cudaGetLastError();
}

// A pair of T at p (c even) from or to fp32, rounded to T on the way out.
template <typename T>
__device__ __forceinline__ void store_pair(T* p, float v0, float v1);
template <>
__device__ __forceinline__ void store_pair<float>(float* p, float v0, float v1) {
  *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
}
template <>
__device__ __forceinline__ void store_pair<__nv_bfloat16>(__nv_bfloat16* p, float v0, float v1) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v0, v1);
}

template <typename T>
__device__ __forceinline__ float2 load_pair(const T* p);
template <>
__device__ __forceinline__ float2 load_pair<float>(const float* p) {
  return __ldg(reinterpret_cast<const float2*>(p));
}
template <>
__device__ __forceinline__ float2 load_pair<__nv_bfloat16>(const __nv_bfloat16* p) {
  return __bfloat1622float2(__ldg(reinterpret_cast<const __nv_bfloat162*>(p)));
}

// The int8 codes of eight values in scale s, packed in two words.
__device__ __forceinline__ uint2 quant8(const float (&v)[8], float s) {
  uint32_t w[2] = {0u, 0u};
#pragma unroll
  for (int e = 0; e < 8; ++e) w[e / 4] |= (uint32_t)(uint8_t)quant(v[e], s) << (8 * (e % 4));
  return make_uint2(w[0], w[1]);
}

template <typename E> struct AccOf { using type = float; };
template <> struct AccOf<int8_t> { using type = int; };

template <typename E>
constexpr size_t gemm_smem() {
  constexpr size_t stages = 2 * (size_t)(BM * BK + BK * BN) * sizeof(E);
  constexpr size_t staging = (size_t)BM * LDS * 4;
  return stages > staging ? stages : staging;
}

struct EpiArgs {
  void* out;              // (M, N) T
  const float* rs;        // (M,) row scales: kDequant
  const float* cs;        // (N,) column scales: kDequant
  const void* bias;       // (N,) T
};

template <typename E, typename T, int EPI>
__global__ void __launch_bounds__(NT)
gemm_tiles(const E* __restrict__ a, const E* __restrict__ b, int M, int N, int K, EpiArgs ep) {
  using Acc = typename AccOf<E>::type;
  constexpr bool kScalar = std::is_same<E, float>::value;
  constexpr int STAGE = BM * BK + BK * BN;  // elements
  constexpr int V = 16 / sizeof(E);         // elements per 16-byte copy
  extern __shared__ __align__(128) unsigned char smem_raw[];
  E* sm = reinterpret_cast<E*>(smem_raw);
  const int tid = threadIdx.x, w = tid >> 5;
  const int row0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int nk = K / BK;

  auto fetch = [&](int stage, int k0) {
    E* as = sm + stage * STAGE;
    E* bs = as + BM * BK;
    for (int c = tid; c < BM * (BK / V); c += NT) {
      const int r = c / (BK / V), e = (c % (BK / V)) * V;
      const int src = min(row0 + r, M - 1);  // rows past M: loaded, never stored
      cp_async16(as + ((e / CH) * BM + r) * CH + e % CH, a + (size_t)src * K + k0 + e);
    }
    for (int c = tid; c < BK * (BN / V); c += NT) {
      const int k = c / (BN / V), e = (c % (BN / V)) * V;
      cp_async16(bs + ((e / CH) * BK + k) * CH + e % CH, b + (size_t)(k0 + k) * N + n0 + e);
    }
    cp_async_commit();
  };

  const int wm = w >> 2, wn = w & 3;  // warp piece: rows 32 wm, columns 32 wn
  const int cc = tid % BN, rg = tid / BN;  // scalar path and epilogue: column,
                                           // rows rg + 2 i
  wmma::fragment<wmma::accumulator, 16, 16, 16, Acc> acc[2][2];
  float facc[kScalar ? BM / 2 : 1];
  if constexpr (kScalar) {
#pragma unroll
    for (int i = 0; i < BM / 2; ++i) facc[i] = 0.0f;
  } else {
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], static_cast<Acc>(0));
  }

  fetch(0, 0);
  for (int t = 0; t < nk; ++t) {
    if (t + 1 < nk) {
      fetch((t + 1) & 1, (t + 1) * BK);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // tile t visible to every warp
    const E* as = sm + (t & 1) * STAGE;
    const E* bs = as + BM * BK;
    if constexpr (kScalar) {
      for (int k = 0; k < BK; ++k) {
        const float bv = bs[((cc / CH) * BK + k) * CH + cc % CH];
#pragma unroll
        for (int i = 0; i < BM / 2; ++i)
          facc[i] = fmaf(as[((k / CH) * BM + rg + 2 * i) * CH + k % CH], bv, facc[i]);
      }
    } else {
#pragma unroll
      for (int kk = 0; kk < BK / CH; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, E, wmma::row_major> fa[2];
        wmma::fragment<wmma::matrix_b, 16, 16, 16, E, wmma::row_major> fb[2];
#pragma unroll
        for (int i = 0; i < 2; ++i)
          wmma::load_matrix_sync(fa[i], as + (kk * BM + wm * 32 + i * 16) * CH, CH);
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::load_matrix_sync(fb[j], bs + ((wn * 2 + j) * BK + kk * CH) * CH, CH);
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
      }
    }
    __syncthreads();  // every warp is done with this stage
  }

  // ---- epilogue: the tile through shared memory (the stages are free now)
  Acc* st = reinterpret_cast<Acc*>(smem_raw);
  if constexpr (kScalar) {
#pragma unroll
    for (int i = 0; i < BM / 2; ++i) st[(rg + 2 * i) * LDS + cc] = facc[i];
  } else {
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::store_matrix_sync(st + (wm * 32 + i * 16) * LDS + wn * 32 + j * 16, acc[i][j],
                                LDS, wmma::mem_row_major);
  }
  __syncthreads();
  const int col = n0 + cc;
  T* out = static_cast<T*>(ep.out);
  const float bias = vt::to_f(static_cast<const T*>(ep.bias)[col]);
  const float cs = EPI == kBias ? 0.0f : ep.cs[col];
  for (int i = 0; i < BM / 2; ++i) {
    const int r = rg + 2 * i, row = row0 + r;
    float o;
    if constexpr (EPI == kBias) {
      o = __fadd_rn(static_cast<float>(st[r * LDS + cc]), bias);
    } else {
      const float rs = ep.rs[min(row, M - 1)];
      o = __fadd_rn(__fmul_rn(__int2float_rn(static_cast<int>(st[r * LDS + cc])),
                              __fmul_rn(rs, cs)),
                    bias);
    }
    if (row < M) out[(size_t)row * N + col] = vt::from_f<T>(o);
  }
}

template <typename E, typename T, int EPI>
int launch_gemm(const E* a, const E* b, int M, int N, int K, const EpiArgs& ep,
                cudaStream_t stream) {
  if (M <= 0 || N % BN || K % BK) return (int)cudaErrorInvalidValue;
  constexpr size_t smem = gemm_smem<E>();
  const cudaError_t e = allow_smem<gemm_tiles<E, T, EPI>>(smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((M + BM - 1) / BM, N / BN);
  gemm_tiles<E, T, EPI><<<grid, NT, smem, stream>>>(a, b, M, N, K, ep);
  return (int)cudaGetLastError();
}

}  // namespace gm
}  // namespace
