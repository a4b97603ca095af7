// Pieces shared by the LN->QKV kernels (ln_qkv.cu) and the w8a8 kernels
// (mlp_w8a8.cu, swiglu_w8a8.cu): row helpers for one block of RT threads
// per row, the whole row in registers (a LayerNorm, ln_row; a row's int8
// quantization, quant and quant_scale; sums and maxima over the block in a
// fixed order), the row kernel row_prologue (LN and/or quantization of each
// row), pairs of T to and from fp32, eight values' int8 codes (quant8), and
// the dequantization of an int32 sum (dequant_acc) that the epilogues of
// the int8 core's products share.
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
// Row kernels: H = RT n columns, thread t holding columns t + RT i, i < n <=
// PER.  with_row picks an exact instance (n = PER at compile time, no
// column guards) where H is RT times 4, 6 or 8 (512, 768, 1,024), else the
// guarded one with_per picks (PER 8 for H 768: two slots of eight idle and
// a guard on each of the others; at 2,048 rows on an H100 the LN pass took
// 0.0068 ms so, 0.0061 exact).
#pragma once

#include <stdint.h>

#include <type_traits>

#include "mlp_common.cuh"  // vt:: conversions, load8

namespace {
namespace gm {

constexpr int RT = 128;  // threads of a row kernel
constexpr int ROW_H_MAX = 8192;  // the widest row a row kernel holds in registers

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

// One row per block, H = RT n columns, n <= PER (EXACT: n = PER, no
// column guards): [LN(x) rounded to T (LN)] then either the row in T (y) or
// its int8 codes and scale (QUANT: q, scale).
template <typename T, int PER, bool LN, bool QUANT, bool EXACT = false>
__global__ void __launch_bounds__(RT)
row_prologue(const T* __restrict__ x, const T* __restrict__ gamma, const T* __restrict__ beta,
             T* __restrict__ y, int8_t* __restrict__ q, float* __restrict__ scale, int H,
             float eps) {
  __shared__ double redd[RT / 32];
  __shared__ float redf[RT / 32];
  const int n = EXACT ? PER : H / RT;
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

// f(std::integral_constant<int, PER>, std::bool_constant<EXACT>) for
// row_prologue at H = RT n, H <= ROW_H_MAX: the exact instance (n = PER)
// at H = 512, 768 and 1,024, else with_per's; returns the launch's error.
template <class F>
cudaError_t with_row(int H, F f) {
  switch (H) {
    case 4 * RT: f(std::integral_constant<int, 4>(), std::true_type()); break;
    case 6 * RT: f(std::integral_constant<int, 6>(), std::true_type()); break;
    case 8 * RT: f(std::integral_constant<int, 8>(), std::true_type()); break;
    default: return with_per(H, [&](auto P) { f(P, std::false_type()); });
  }
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

// Dequantized int32 sum: float(acc) * (rs * cs) + b, the scales multiplied
// first, one rounding a step.
__device__ __forceinline__ float dequant_acc(int acc, float rs, float cs, float b) {
  return __fadd_rn(__fmul_rn(__int2float_rn(acc), __fmul_rn(rs, cs)), b);
}

}  // namespace gm
}  // namespace
