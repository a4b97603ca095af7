// The attention kernel shared by the encoder attention (attention.cu) and
// the grouped-query attention of the Llama tower (attention_gqa.cu):
// out = softmax(q k^T / sqrt(d) + bias) v, head dim D = 32, 64, 96 or 128
// (a multiple of 16: the wmma fragments; 32 BERT-small, 64 BERT-base and
// -large, ViLT-B/32, 96, 128 Llama-3-8B).
//
// Index map.  q and out have H = G * rep heads, k and v have G.  Query head
// g * rep + i reads K/V head g, so the rep query heads of a group are folded
// into one (rep * L, D) matrix against the group's unrepeated (L, D) keys
// and values, as the TPU kernel folds them: block (x, g, b) owns 64 rows of
// that folded matrix; folded row f is head g * rep + f / L at position
// f % L.  rep = 1 is plain multi-head attention.  The bias is fp32,
// bias[b * bias_b + position * bias_q + key]: bias_q = 0 gives the encoder's
// (B, 1, 1, L) key bias, bias_q = L a full (B, 1, L, L) block added per
// query row (causal and padding).  Masked entries carry a finite fill
// (finfo(float32).min), never -inf: s * scale + fill rounds to the fill, the
// running maximum stays finite, and a row whose keys are all masked gets the
// uniform distribution over its L keys, as the plain composition does.
//
// All operands have contiguous rows of D and any batch, head and row
// strides (in elements), so q, k and v can be views into one fused
// projection and out a view of the (B, L, H, D) layout the next product
// reads.  Scores and softmax are fp32; the probabilities are normalised and
// then cast to v's type before the PV product.
//
// Design: one block per (query tile of 64 folded rows, K/V head, batch
// row), 4 warps of 16 query rows each, bf16 16x16x16 tensor-core products
// (wmma) with fp32 accumulation, plain FMA for fp32 operands.  The full
// (64, L) score row is never stored: pass 1 walks the key tiles for the row
// max and the exp-sum; pass 2 recomputes each score tile, forms the
// normalised probabilities before the cast, as the reference does (the
// hardware exp and a reciprocal of the sum move p by a few fp32 ulps, far
// below the bf16 step), and accumulates P V in registers.  Key and value
// tiles stream through shared memory double-buffered with cp.async; rows of
// every tile are padded by 16 bytes against bank conflicts.  Shared memory
// is fixed whatever L is (71 KB at D = 64 in bf16, 130 KB at D = 128), and
// keys past L (the ragged edge) are excluded from both passes.  Shared
// memory at D = 128 is 130 KB in bf16 and 220 KB in fp32 (of 227 KB), the
// same at any L.
#pragma once

#include <mma.h>

#include <math.h>

#include "common.cuh"

using namespace nvcuda;

namespace {

constexpr int BQ = 64;   // query rows per block
constexpr int BK = 64;   // keys per tile
constexpr int NT = 128;  // 4 warps x 16 query rows

// Row strides in shared memory, padded so that the rows of a 16x16 fragment
// fall in different banks: the Q, K and V tiles (D wide), the probability
// tile (BK wide), and the fp32 tile that holds the scores (BK wide) and
// then the output (D wide).
template <typename T, int D> struct Lds { static constexpr int v = D + 16 / sizeof(T); };
template <typename T> struct Ldp { static constexpr int v = BK + 16 / sizeof(T); };
template <int D> struct Ldf { static constexpr int v = (D > BK ? D : BK) + 4; };

// Element strides of a (B, heads, L, D) operand whose rows are contiguous.
struct Strides { long long b, h, l; };

// The index map of one launch (see the head of this file).
struct Map {
  int L, rep;
  Strides q, k, v, o;
  long long bias_b, bias_q;
  float scale;  // 1 / sqrt(D)
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = valid ? 16 : 0;  // 0: fill the 16 bytes with zeros
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem), "r"(n));
}

// Rows [row0, row0 + 64) of one K/V head's (L, D) matrix (rows `ld` elements
// apart) into a (64, D) tile, asynchronously; rows past L are zero.
template <typename T, int D>
__device__ void load_tile(T* dst, const T* src, long long ld, int row0, int L) {
  constexpr int VEC = 16 / sizeof(T), PER_ROW = D / VEC, LD = Lds<T, D>::v;
  for (int c = threadIdx.x; c < 64 * PER_ROW; c += NT) {
    const int r = c / PER_ROW, col = (c % PER_ROW) * VEC;
    const bool ok = row0 + r < L;
    cp_async16(dst + r * LD + col, ok ? src + (row0 + r) * ld + col : src, ok);
  }
}

// Folded query rows [f0, f0 + 64) of group g (`src` at the batch row's
// first head) into a (64, D) tile; rows past rep * L are zero.
template <typename T, int D>
__device__ void load_q_tile(T* dst, const T* src, const Map& mp, int g, int f0) {
  constexpr int VEC = 16 / sizeof(T), PER_ROW = D / VEC, LD = Lds<T, D>::v;
  for (int c = threadIdx.x; c < 64 * PER_ROW; c += NT) {
    const int r = c / PER_ROW, col = (c % PER_ROW) * VEC, f = f0 + r;
    const bool ok = f < mp.rep * mp.L;
    const T* row = src + (g * mp.rep + f / mp.L) * mp.q.h + (f % mp.L) * mp.q.l + col;
    cp_async16(dst + r * LD + col, ok ? row : src, ok);
  }
}

// s[rows of warp w][0, BK) = q k^T (unscaled), fp32.
template <int D>
__device__ void score_tile(const __nv_bfloat16* qs, const __nv_bfloat16* ks, float* s) {
  constexpr int LD = Lds<__nv_bfloat16, D>::v, LDS = Ldf<D>::v;
  const int w = threadIdx.x >> 5;
#pragma unroll
  for (int n = 0; n < BK / 16; ++n) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> c;
    wmma::fill_fragment(c, 0.0f);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> b;
      wmma::load_matrix_sync(a, qs + 16 * w * LD + kk * 16, LD);
      wmma::load_matrix_sync(b, ks + n * 16 * LD + kk * 16, LD);
      wmma::mma_sync(c, a, b, c);
    }
    wmma::store_matrix_sync(s + 16 * w * LDS + n * 16, c, LDS, wmma::mem_row_major);
  }
}

// fp32: each thread computes its own 32 scores (row tid/2, columns
// 2 j + (tid & 1)).
template <int D>
__device__ void score_tile(const float* qs, const float* ks, float* s) {
  constexpr int LD = Lds<float, D>::v, LDS = Ldf<D>::v;
  const int r = threadIdx.x >> 1, half = threadIdx.x & 1;
  float acc[32];
#pragma unroll
  for (int j = 0; j < 32; ++j) acc[j] = 0.0f;
  for (int d = 0; d < D; ++d) {
    const float qv = qs[r * LD + d];
#pragma unroll
    for (int j = 0; j < 32; ++j) acc[j] = fmaf(qv, ks[(2 * j + half) * LD + d], acc[j]);
  }
#pragma unroll
  for (int j = 0; j < 32; ++j) s[r * LDS + 2 * j + half] = acc[j];
}

// O += P V for the warp's 16 query rows, accumulated in fragments.
template <int D>
struct AccBF16 {
  static constexpr int LD = Lds<__nv_bfloat16, D>::v, LDP = Ldp<__nv_bfloat16>::v;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> f[D / 16];
  __device__ void zero() {
#pragma unroll
    for (int n = 0; n < D / 16; ++n) wmma::fill_fragment(f[n], 0.0f);
  }
  __device__ void add_pv(const __nv_bfloat16* ps, const __nv_bfloat16* vs) {
    const int w = threadIdx.x >> 5;
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
      wmma::load_matrix_sync(a, ps + 16 * w * LDP + kk * 16, LDP);
#pragma unroll
      for (int n = 0; n < D / 16; ++n) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> b;
        wmma::load_matrix_sync(b, vs + kk * 16 * LD + n * 16, LD);
        wmma::mma_sync(f[n], a, b, f[n]);
      }
    }
  }
  __device__ void store(float* o) {
    const int w = threadIdx.x >> 5;
#pragma unroll
    for (int n = 0; n < D / 16; ++n)
      wmma::store_matrix_sync(o + 16 * w * Ldf<D>::v + n * 16, f[n], Ldf<D>::v,
                              wmma::mem_row_major);
  }
};

// fp32: each thread owns D/2 outputs (row tid/2, columns (tid&1)*D/2 + c).
template <int D>
struct AccF32 {
  static constexpr int LD = Lds<float, D>::v, LDP = Ldp<float>::v;
  float o[D / 2];
  __device__ void zero() {
#pragma unroll
    for (int c = 0; c < D / 2; ++c) o[c] = 0.0f;
  }
  __device__ void add_pv(const float* ps, const float* vs) {
    const int r = threadIdx.x >> 1, c0 = (threadIdx.x & 1) * (D / 2);
    for (int j = 0; j < BK; ++j) {
      const float p = ps[r * LDP + j];
#pragma unroll
      for (int c = 0; c < D / 2; ++c) o[c] = fmaf(p, vs[j * LD + c0 + c], o[c]);
    }
  }
  __device__ void store(float* out) {
    const int r = threadIdx.x >> 1, c0 = (threadIdx.x & 1) * (D / 2);
#pragma unroll
    for (int c = 0; c < D / 2; ++c) out[r * Ldf<D>::v + c0 + c] = o[c];
  }
};

template <typename T, int D>
constexpr size_t smem_bytes() {
  // fp32 scores / output + Q + 2 x (K, V) + P
  return (size_t)BQ * Ldf<D>::v * sizeof(float)
         + (size_t)(BQ + 4 * BK) * Lds<T, D>::v * sizeof(T) + (size_t)BQ * Ldp<T>::v * sizeof(T);
}

template <typename T, int D, typename Acc>
__global__ void __launch_bounds__(NT)
attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const float* __restrict__ bias,
                 T* __restrict__ out, Map mp) {
  constexpr int LD = Lds<T, D>::v, LDP = Ldp<T>::v, LDS = Ldf<D>::v;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  float* s = reinterpret_cast<float*>(smem_raw);  // (BQ, LDS) scores, then output
  T* qs = reinterpret_cast<T*>(s + BQ * LDS);     // (BQ, LD)
  T* kv = qs + BQ * LD;                           // 2 buffers x (K, V) x (BK, LD)
  T* ps = kv + 4 * BK * LD;                       // (BQ, LDP) probabilities

  const int L = mp.L;
  const int f0 = blockIdx.x * BQ, g = blockIdx.y, b = blockIdx.z;
  const T* kg = k + b * mp.k.b + g * mp.k.h;  // the group's keys and values
  const T* vg = v + b * mp.v.b + g * mp.v.h;
  // Row ops: thread tid owns row tid/2 of the tile, columns 2 j + (tid&1).
  // Row tid/2 lies in warp tid/32's 16-row strip, so a warp only ever reads
  // the scores it wrote itself and __syncwarp suffices between the two.
  const int r = threadIdx.x >> 1, half = threadIdx.x & 1;
  const int f = f0 + r;                      // this thread's folded row
  const bool row_ok = f < mp.rep * L;
  const int head = g * mp.rep + f / L, pos = f % L;
  const float* brow = bias + b * mp.bias_b + (row_ok ? pos * mp.bias_q : 0);
  const int n_kt = (L + BK - 1) / BK;

  // The key tiles stream twice, K alone for pass 1, then K and V for pass
  // 2; tile t + 1 loads (cp.async) while tile t is in use.
  auto fetch = [&](int t) {
    T* dst = kv + (t & 1) * 2 * BK * LD;
    const int kt = t < n_kt ? t : t - n_kt;
    load_tile<T, D>(dst, kg, mp.k.l, kt * BK, L);
    if (t >= n_kt) load_tile<T, D>(dst + BK * LD, vg, mp.v.l, kt * BK, L);
    asm volatile("cp.async.commit_group;\n" ::);
  };
  load_q_tile<T, D>(qs, q + b * mp.q.b, mp, g, f0);
  fetch(0);

  float m = -INFINITY, l = 0.0f;
  Acc acc;
  acc.zero();
  for (int t = 0; t < 2 * n_kt; ++t) {
    if (t + 1 < 2 * n_kt) {
      fetch(t + 1);
      asm volatile("cp.async.wait_group 1;\n" ::);
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::);
    }
    __syncthreads();  // tile t (and Q) visible to every warp
    const T* ks = kv + (t & 1) * 2 * BK * LD;
    const int kt = t < n_kt ? t : t - n_kt;
    score_tile<D>(qs, ks, s);
    __syncwarp();
    if (t < n_kt) {
      // Pass 1: row max and sum of exp(s - max), online over the key tiles.
      float sv[32];
      float tmax = -INFINITY;
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        const int c = 2 * j + half, col = kt * BK + c;
        sv[j] = col < L ? __fmaf_rn(s[r * LDS + c], mp.scale, brow[col]) : -INFINITY;
        tmax = fmaxf(tmax, sv[j]);
      }
      tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 1));
      const float mn = fmaxf(m, tmax);
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < 32; ++j) sum += __expf(sv[j] - mn);
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      l = l * expf(m - mn) + sum;
      m = mn;
    } else {
      // Pass 2: p = exp(s - max) / sum, cast to T, O += P V.
      const float inv_l = 1.0f / l;
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        const int c = 2 * j + half, col = kt * BK + c;
        const float p = col < L
            ? __expf(__fmaf_rn(s[r * LDS + c], mp.scale, brow[col]) - m) * inv_l
            : 0.0f;
        ps[r * LDP + c] = vt::from_f<T>(p);
      }
      __syncwarp();
      acc.add_pv(ps, ks + BK * LD);
    }
    __syncthreads();  // every warp is done with buffer t & 1
  }
  acc.store(s);  // each warp its own strip of the (BQ, D) fp32 staging
  __syncwarp();
  if (row_ok) {
    const int c0 = half * (D / 2);
    T* dst = out + b * mp.o.b + head * mp.o.h + pos * mp.o.l + c0;
#pragma unroll
    for (int c = 0; c < D / 2; ++c) dst[c] = vt::from_f<T>(s[r * LDS + c0 + c]);
  }
}

template <typename T, int D, typename Acc>
int launch(const void* q, const void* k, const void* v, const void* bias, void* out, int B,
           int G, const Map& mp, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<T, D>();
  static bool smem_set = false;  // once per instantiation and process
  if (!smem_set) {
    const cudaError_t e = cudaFuncSetAttribute(attention_kernel<T, D, Acc>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               (int)smem);
    if (e != cudaSuccess) return (int)e;
    smem_set = true;
  }
  const dim3 grid((mp.rep * mp.L + BQ - 1) / BQ, G, B);
  attention_kernel<T, D, Acc><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const float*>(bias), static_cast<T*>(out), mp);
  return (int)cudaGetLastError();
}

// B batch rows, G K/V heads, G * mp.rep query heads; dtype a vt::Dtype.
template <int D>
int launch_attention(const void* q, const void* k, const void* v, const void* bias, void* out,
                     int B, int G, Map mp, int dtype, cudaStream_t stream) {
  if (B <= 0 || G <= 0 || mp.L <= 0 || mp.rep <= 0) return (int)cudaErrorInvalidValue;
  mp.scale = 1.0f / sqrtf((float)D);
  if (dtype == vt::kBF16)
    return launch<__nv_bfloat16, D, AccBF16<D>>(q, k, v, bias, out, B, G, mp, stream);
  if (dtype == vt::kF32) return launch<float, D, AccF32<D>>(q, k, v, bias, out, B, G, mp, stream);
  return (int)cudaErrorInvalidValue;
}

// launch_attention at a run-time head dim: 32, 64, 96 or 128.
inline int launch_attention_d(int head_dim, const void* q, const void* k, const void* v,
                              const void* bias, void* out, int B, int G, const Map& mp, int dtype,
                              cudaStream_t stream) {
  switch (head_dim) {
    case 32: return launch_attention<32>(q, k, v, bias, out, B, G, mp, dtype, stream);
    case 64: return launch_attention<64>(q, k, v, bias, out, B, G, mp, dtype, stream);
    case 96: return launch_attention<96>(q, k, v, bias, out, B, G, mp, dtype, stream);
    case 128: return launch_attention<128>(q, k, v, bias, out, B, G, mp, dtype, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace
