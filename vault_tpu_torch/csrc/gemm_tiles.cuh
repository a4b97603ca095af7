// gemm_tiles: the port's fp32 matrix product on the FMA units, for the fp32
// blocks (mlp.cu, mlp_bwd.cu: the fp32 MLP blocks forward, with fp32 or
// int8 weights, and backward) and the fp32 LN->QKV projection (ln_qkv.cu).
//
//   C = A B, A (M, K) and B (K, N) fp32 row-major, each sum over k taken in
//   order with fmaf (no TF32: full fp32, as the plain versions on the card),
//   handed to an epilogue functor four columns at a time.
//
// A block owns a (64, 128) tile of C and walks K in steps of 32, the next A
// and B tiles loading with cp.async while the threads work on the current
// ones (double buffering, 51,200 bytes of shared memory).  Each of the 256
// threads owns a 4 x 8 register tile: rows 4 ty + i (ty = t / 16, i < 4) and
// columns 4 tx + j and 64 + 4 tx + j (tx = t % 16, j < 4).  A k-step of four
// reads 4 float4 of A (each a broadcast: the A tile's rows are padded to 36
// floats, 16-byte aligned, so the two rows a warp reads fall in other
// banks) and 8 float4 of B (a warp's 16 distinct float4 lie in 256
// consecutive bytes) for 128 fmaf: the FMA units, not shared memory, set
// the pace.  Rows past M load row M - 1 and are never stored.
//
// Split-K: grid z cuts K into `splits` ranges of whole k-steps; the
// epilogue receives its range's index, so a product can write fp32 slices
// that a row pass adds in a fixed order (no atomics: repeats are
// bit-equal).  pick_splits chooses the count by waves of resident blocks.
//
// What bounds it on an H100: 2 M N K fp32 operations at 67 TFLOP/s without
// the tensor cores (the fp32 blocks' products: 4 rows H I; at 2,048 rows
// and H 768, I 3,072, 0.29 ms).  Widths: N a multiple of 128, K of 32.
#pragma once

#include <algorithm>

#include "mlp_common.cuh"  // cp_async16, allow_smem, num_sms

namespace {
namespace ft {

constexpr int BM = 64, BN = 128, BK = 32;  // tile and k-step
constexpr int NT = 256;                     // threads (8 warps)
constexpr int LDA = BK + 4;                 // the A tile's row stride, floats
constexpr int STAGE = BM * LDA + BK * BN;   // floats: A (BM, LDA), then B (BK, BN)
constexpr size_t SMEM = 2 * (size_t)STAGE * sizeof(float);
constexpr int RESIDENT = 3;                 // blocks an SM holds (registers)
constexpr int MAX_SPLITS = 8;

__device__ __forceinline__ float comp(const float4& v, int k) {
  return k == 0 ? v.x : k == 1 ? v.y : k == 2 ? v.z : v.w;
}

template <class Epi>
__global__ void __launch_bounds__(NT, 2)
gemm_tiles(const float* __restrict__ a, const float* __restrict__ b, int M, int N, int K,
           int kper, Epi epi) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  float* sm = reinterpret_cast<float*>(smem_raw);
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int row0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int k_begin = blockIdx.z * kper;
  const int nk = max(0, min(K - k_begin, kper)) / BK;

  auto fetch = [&](int stage, int k0) {
    float* as = sm + stage * STAGE;
    float* bs = as + BM * LDA;
#pragma unroll
    for (int c = tid; c < BM * (BK / 4); c += NT) {
      const int r = c / (BK / 4), e = (c % (BK / 4)) * 4;
      const int src = min(row0 + r, M - 1);
      cp_async16(as + r * LDA + e, a + (size_t)src * K + k0 + e);
    }
#pragma unroll
    for (int c = tid; c < BK * (BN / 4); c += NT) {
      const int k = c / (BN / 4), e = (c % (BN / 4)) * 4;
      cp_async16(bs + k * BN + e, b + (size_t)(k0 + k) * N + n0 + e);
    }
    cp_async_commit();
  };

  float acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;

  if (nk > 0) fetch(0, k_begin);
  for (int t = 0; t < nk; ++t) {
    if (t + 1 < nk) {
      fetch((t + 1) & 1, k_begin + (t + 1) * BK);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // tile t visible to every thread
    const float* as = sm + (t & 1) * STAGE;
    const float* bs = as + BM * LDA;
#pragma unroll
    for (int k = 0; k < BK; k += 4) {
      float4 av[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        av[i] = *reinterpret_cast<const float4*>(as + (4 * ty + i) * LDA + k);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const float4 b0 = *reinterpret_cast<const float4*>(bs + (k + kk) * BN + 4 * tx);
        const float4 b1 = *reinterpret_cast<const float4*>(bs + (k + kk) * BN + 64 + 4 * tx);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float x = comp(av[i], kk);
          acc[i][0] = fmaf(x, b0.x, acc[i][0]);
          acc[i][1] = fmaf(x, b0.y, acc[i][1]);
          acc[i][2] = fmaf(x, b0.z, acc[i][2]);
          acc[i][3] = fmaf(x, b0.w, acc[i][3]);
          acc[i][4] = fmaf(x, b1.x, acc[i][4]);
          acc[i][5] = fmaf(x, b1.y, acc[i][5]);
          acc[i][6] = fmaf(x, b1.z, acc[i][6]);
          acc[i][7] = fmaf(x, b1.w, acc[i][7]);
        }
      }
    }
    __syncthreads();  // every thread is done with this stage
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = row0 + 4 * ty + i;
    if (r >= M) continue;
    epi(r, n0 + 4 * tx, make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]), blockIdx.z);
    epi(r, n0 + 64 + 4 * tx, make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]),
        blockIdx.z);
  }
}

// Splits of K for an (M, N, K) product whose epilogue writes fp32 slices:
// the count (at most MAX_SPLITS) that keeps the waves of RESIDENT blocks
// an SM shortest, each wave costing its k-steps plus two (fill, epilogue).
inline int pick_splits(int M, int N, int K) {
  const long tiles = (long)((M + BM - 1) / BM) * (N / BN);
  const long slots = (long)RESIDENT * num_sms();
  const int steps = K / BK;
  int best = 1;
  long best_cost = -1;
  for (int s = 1; s <= MAX_SPLITS && s <= steps; ++s) {
    const long cost = (tiles * s + slots - 1) / slots * ((steps + s - 1) / s + 2);
    if (best_cost < 0 || cost < best_cost) best = s, best_cost = cost;
  }
  return best;
}

// C = A B through gemm_tiles with epilogue `epi`, K cut into `splits`
// ranges.  N a multiple of BN, K of BK.
template <class Epi>
cudaError_t gemm(const float* a, const float* b, int M, int N, int K, Epi epi, cudaStream_t st,
                 int splits = 1) {
  if (M <= 0 || N <= 0 || N % BN || K <= 0 || K % BK || splits < 1 || splits > K / BK)
    return cudaErrorInvalidValue;
  const cudaError_t e = allow_smem<gemm_tiles<Epi>>(SMEM);
  if (e != cudaSuccess) return e;
  const int kper = (K / BK + splits - 1) / splits * BK;
  gemm_tiles<Epi><<<dim3((M + BM - 1) / BM, N / BN, splits), NT, SMEM, st>>>(a, b, M, N, K, kper,
                                                                            epi);
  return cudaGetLastError();
}

// Epilogues (r, c: the first of four columns; v: their sums; s: the split).

// out = v + bias.
struct EpiBias {
  const float* bias;
  float* out;
  int n;
  __device__ __forceinline__ void operator()(int r, int c, float4 v, int) const {
    const float4 bb = __ldg(reinterpret_cast<const float4*>(bias + c));
    *reinterpret_cast<float4*>(out + (size_t)r * n + c) =
        make_float4(v.x + bb.x, v.y + bb.y, v.z + bb.z, v.w + bb.w);
  }
};

// The split's fp32 slice: out[s] (rows, n) = v.
struct StoreSlice {
  float* out;
  int rows, n;
  __device__ __forceinline__ void operator()(int r, int c, float4 v, int s) const {
    *reinterpret_cast<float4*>(out + ((size_t)s * rows + r) * n + c) = v;
  }
};

// a = act(v + b1), ACT a vt::Act code.
template <int ACT>
struct EpiAct {
  const float* b1;
  float* a;
  int n;
  __device__ __forceinline__ void operator()(int r, int c, float4 v, int) const {
    const float4 bb = __ldg(reinterpret_cast<const float4*>(b1 + c));
    *reinterpret_cast<float4*>(a + (size_t)r * n + c) =
        make_float4(vt::activate(v.x + bb.x, ACT), vt::activate(v.y + bb.y, ACT),
                    vt::activate(v.z + bb.z, ACT), vt::activate(v.w + bb.w, ACT));
  }
};

// f(EpiAct<code>{b1, a, n}) for the run-time activation code.
template <class F>
cudaError_t with_act(int act, const float* b1, float* a, int n, F f) {
  switch (act) {
    case vt::kGeluErf: return f(EpiAct<vt::kGeluErf>{b1, a, n});
    case vt::kGeluTanh: return f(EpiAct<vt::kGeluTanh>{b1, a, n});
    case vt::kRelu: return f(EpiAct<vt::kRelu>{b1, a, n});
    default: return cudaErrorInvalidValue;
  }
}

// out (cols, rows) = in (rows, cols)^T, fp32, 32 x 32 tiles through shared
// memory (a padded column against bank conflicts).
__global__ void __launch_bounds__(256)
transpose(const float* __restrict__ in, float* __restrict__ out, int rows, int cols) {
  __shared__ float tile[32][33];
  const int c0 = blockIdx.x * 32, r0 = blockIdx.y * 32;
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < 32; k += 8) {
    const int r = r0 + ty + k, c = c0 + tx;
    if (r < rows && c < cols) tile[ty + k][tx] = in[(size_t)r * cols + c];
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < 32; k += 8) {
    const int c = c0 + ty + k, r = r0 + tx;
    if (r < rows && c < cols) out[(size_t)c * rows + r] = tile[tx][ty + k];
  }
}

inline cudaError_t launch_transpose(const float* in, float* out, int rows, int cols,
                                    cudaStream_t st) {
  transpose<<<dim3((cols + 31) / 32, (rows + 31) / 32), 256, 0, st>>>(in, out, rows, cols);
  return cudaGetLastError();
}

// int8 codes q (rows, cols), per-column scales s -> out = float(q) * s[col]
// in fp32 (the plain version's cast point: w_q.float() * w_scale), four
// codes a thread.
__global__ void __launch_bounds__(256)
dequant_f32(const int8_t* __restrict__ q, const float* __restrict__ s, float* __restrict__ out,
            long n4, int cols) {
  for (long i = (long)blockIdx.x * blockDim.x + threadIdx.x; i < n4;
       i += (long)gridDim.x * blockDim.x) {
    const char4 v = __ldg(reinterpret_cast<const char4*>(q) + i);
    const int c = (int)((4 * i) % cols);
    const float4 sc = __ldg(reinterpret_cast<const float4*>(s + c));
    reinterpret_cast<float4*>(out)[i] =
        make_float4(__fmul_rn((float)v.x, sc.x), __fmul_rn((float)v.y, sc.y),
                    __fmul_rn((float)v.z, sc.z), __fmul_rn((float)v.w, sc.w));
  }
}

inline cudaError_t launch_dequant(const int8_t* q, const float* s, float* out, int rows, int cols,
                                  cudaStream_t st) {
  const long n4 = (long)rows * cols / 4;
  dequant_f32<<<(int)std::min<long>((n4 + 255) / 256, 8L * num_sms()), 256, 0, st>>>(
      q, s, out, n4, cols);
  return cudaGetLastError();
}

}  // namespace ft
}  // namespace
