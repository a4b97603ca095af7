// Pieces shared by the LN->QKV kernels (ln_qkv.cu) and the w8a8 MLP
// kernels (mlp_w8a8.cu):
//
//   * row kernels, one block of RT threads per row, the whole row in
//     registers: a LayerNorm (row_prologue), a row's int8 quantization
//     (row_prologue, requant_rows), the w8a8 MLP's last step (w8a8_out);
//   * gemm_tiles, a tiled product C = A B with A (M, K) and B (K, N) both
//     row-major as the JAX package stores them, through the tensor cores
//     (int8 x int8 -> int32, or bf16 with fp32 accumulation; wmma 16x16x16)
//     or plain fp32 FMA, with the epilogues the kernels need.
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
// (in, out) layout.  Split-K blocks (grid z) write int32 partial sums; the
// caller adds them in a fixed order (integer sums are exact in any order).
#pragma once

#include <stdint.h>

#include "mlp_common.cuh"  // cp.async helpers, num_sms, allow_smem

namespace {
namespace gm {

constexpr int RT = 128;  // threads of a row kernel
constexpr int BM = 64, BN = 128, BK = 64;
constexpr int CH = 16;   // columns per shared-memory chunk
constexpr int NT = 256;  // threads of gemm_tiles (8 warps)
constexpr int LDS = BN + 4;  // ld of the epilogue's staging tile

enum Epi {
  kBias = 0,     // out = T(acc + bias)                      (fp products)
  kDequant = 1,  // out = T(acc * (rs * cs) + bias)           (int8)
  kAct = 2,      // out = T(act(acc * (rs * cs) + bias)), act a vt::Act code;
                 //   per-(row, column tile) absmax of the rounded values into pmax
  kPartial = 3,  // ws[z] = acc, int32, rows < M only
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

__device__ __forceinline__ float block_max(float v, float* red) {
  v = warp_max(v);
  __syncthreads();
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float t = 0.0f;
#pragma unroll
  for (int w = 0; w < RT / 32; ++w) t = fmaxf(t, red[w]);
  return t;
}

// LayerNorm of a row held as v[i] = column tid + RT i, in place.
template <typename T, int PER>
__device__ __forceinline__ void ln_row(float (&v)[PER], const T* __restrict__ gamma,
                                       const T* __restrict__ beta, float eps, double* red) {
  constexpr int H = RT * PER;
  double s = 0.0;
#pragma unroll
  for (int i = 0; i < PER; ++i) s += static_cast<double>(v[i]);
  const float mean = static_cast<float>(block_sum(s, red) / H);
  double q = 0.0;
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    v[i] = __fsub_rn(v[i], mean);
    q += static_cast<double>(v[i]) * static_cast<double>(v[i]);
  }
  const float var = static_cast<float>(block_sum(q, red) / H);
  const float rstd = __fdiv_rn(1.0f, __fsqrt_rn(__fadd_rn(var, eps)));
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int c = threadIdx.x + RT * i;
    v[i] = __fadd_rn(__fmul_rn(__fmul_rn(v[i], rstd), vt::to_f(gamma[c])), vt::to_f(beta[c]));
  }
}

// One row per block: [LN(x) rounded to T (LN)] then either the row in T
// (y) or its int8 codes and scale (QUANT: q, scale).
template <typename T, int PER, bool LN, bool QUANT>
__global__ void __launch_bounds__(RT)
row_prologue(const T* __restrict__ x, const T* __restrict__ gamma, const T* __restrict__ beta,
             T* __restrict__ y, int8_t* __restrict__ q, float* __restrict__ scale, float eps) {
  constexpr int H = RT * PER;
  __shared__ double redd[RT / 32];
  __shared__ float redf[RT / 32];
  const size_t base = static_cast<size_t>(blockIdx.x) * H + threadIdx.x;
  float v[PER];
#pragma unroll
  for (int i = 0; i < PER; ++i) v[i] = vt::to_f(x[base + RT * i]);
  if constexpr (LN) {
    ln_row<T, PER>(v, gamma, beta, eps, redd);
#pragma unroll
    for (int i = 0; i < PER; ++i) v[i] = vt::to_f(vt::from_f<T>(v[i]));
  }
  if constexpr (!QUANT) {
#pragma unroll
    for (int i = 0; i < PER; ++i) y[base + RT * i] = vt::from_f<T>(v[i]);
  } else {
    float m = 0.0f;
#pragma unroll
    for (int i = 0; i < PER; ++i) m = fmaxf(m, fabsf(v[i]));
    const float s = quant_scale(block_max(m, redf));
#pragma unroll
    for (int i = 0; i < PER; ++i) q[base + RT * i] = quant(v[i], s);
    if (threadIdx.x == 0) scale[blockIdx.x] = s;
  }
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
  void* out;              // (M, N) T: kBias, kDequant, kAct
  const float* rs;        // (M,) row scales: kDequant, kAct
  const float* cs;        // (N,) column scales: kDequant, kAct
  const void* bias;       // (N,) T: kBias, kDequant, kAct
  float* pmax;            // (M, N / BN): kAct
  int* ws;                // (splits, M, N): kPartial
  int act;                // vt::Act code: kAct
};

template <typename E, typename T, int EPI>
__global__ void __launch_bounds__(NT)
gemm_tiles(const E* __restrict__ a, const E* __restrict__ b, int M, int N, int K, int kc,
           EpiArgs ep) {
  using Acc = typename AccOf<E>::type;
  constexpr bool kScalar = std::is_same<E, float>::value;
  constexpr int STAGE = BM * BK + BK * BN;  // elements
  constexpr int V = 16 / sizeof(E);         // elements per 16-byte copy
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __shared__ float red[BM][BN / 32];
  E* sm = reinterpret_cast<E*>(smem_raw);
  const int tid = threadIdx.x, w = tid >> 5, lane = tid & 31;
  const int row0 = blockIdx.x * BM, n0 = blockIdx.y * BN, kb = blockIdx.z * kc;
  const int nk = kc / BK;

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

  fetch(0, kb);
  for (int t = 0; t < nk; ++t) {
    if (t + 1 < nk) {
      fetch((t + 1) & 1, kb + (t + 1) * BK);
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
  if constexpr (EPI == kPartial) {
    for (int i = 0; i < BM / 2; ++i) {
      const int row = row0 + rg + 2 * i;
      if (row < M) ep.ws[((size_t)blockIdx.z * M + row) * N + col] = st[(rg + 2 * i) * LDS + cc];
    }
    return;
  } else {
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
      if constexpr (EPI == kAct) o = act_rn(o, ep.act);
      const T ov = vt::from_f<T>(o);
      if (row < M) out[(size_t)row * N + col] = ov;
      if constexpr (EPI == kAct) {
        const float m = warp_max(fabsf(vt::to_f(ov)));  // a warp shares its row
        if (lane == 0) red[r][cc / 32] = m;
      }
    }
    if constexpr (EPI == kAct) {
      __syncthreads();
      if (tid < BM && row0 + tid < M) {
        float m = 0.0f;
#pragma unroll
        for (int j = 0; j < BN / 32; ++j) m = fmaxf(m, red[tid][j]);
        ep.pmax[(size_t)(row0 + tid) * gridDim.y + blockIdx.y] = m;
      }
    }
  }
}

template <typename E, typename T, int EPI>
int launch_gemm(const E* a, const E* b, int M, int N, int K, int splits, const EpiArgs& ep,
                cudaStream_t stream) {
  if (M <= 0 || N % BN || K % (BK * splits)) return (int)cudaErrorInvalidValue;
  constexpr size_t smem = gemm_smem<E>();
  const cudaError_t e = allow_smem<gemm_tiles<E, T, EPI>>(smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((M + BM - 1) / BM, N / BN, splits);
  gemm_tiles<E, T, EPI><<<grid, NT, smem, stream>>>(a, b, M, N, K, K / splits, ep);
  return (int)cudaGetLastError();
}

// K splits of a (M, K) x (K, N) product: double them while the blocks fill
// fewer than one wave of SMs (at most 8; each split keeps a whole K tile).
inline int pick_k_splits(int M, int N, int K) {
  const int tiles = ((M + BM - 1) / BM) * (N / BN);
  int s = 1;
  while (tiles * s < num_sms() && s < 8 && (K / BK) % (2 * s) == 0) s *= 2;
  return s;
}

}  // namespace gm
}  // namespace
