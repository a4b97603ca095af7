// Encoder attention for Hopper: out = softmax(q k^T / sqrt(d) + bias) v.
//
// Replaces the JAX package's three Pallas encoder-attention kernels, which
// compute the same function and differ only in TPU program layout:
// fused_attention (_attn_kernel, grid (B, H)), fused_attention_batched
// (_attn_kernel_batched) and fused_attention_dotbatch
// (_attn_kernel_dotbatch), all in vault_tpu/ops/pallas_attention.py.
//
// Operands: q, k, v, out (B, H, L, 64) with contiguous rows of 64 (any
// batch, head and row strides, so q, k and v can be views into the fused
// QKV projection and out a view of the (B, L, H) layout the next product
// reads), all bf16 or all fp32;
// bias (B, 1, 1, L) fp32, an additive key bias with a finite fill for
// masked keys.  Scores and softmax are fp32; the probabilities are
// normalised and then cast to v's type before the PV product, as
// pallas_attention.py:69-71 does.
//
// What bounds it on an H100: at the main path's L = 40 and L = 256 the
// work is tiny (4 B H L^2 d FLOP, well under 1 us of tensor-core time at
// 989 TFLOP/s) and the bytes are a few MB, so the kernel is bound by
// latency and by how many blocks fill the 132 SMs.  Design: one block per
// (query tile of 64 rows, head, batch row), 4 warps of 16 query rows each,
// bf16 16x16x16 tensor-core products (wmma) with fp32 accumulation.  The
// full (64, L) score row is never stored: pass 1 walks the key tiles for
// the row max and the exp-sum; pass 2 recomputes each score tile, forms
// the normalised probabilities before the cast, as the reference does
// (the hardware exp and a reciprocal of the sum move p by a few fp32 ulps,
// far below the bf16 step), and accumulates P V in registers.
// Key and value tiles stream through shared memory double-buffered with
// cp.async; rows of every tile are padded by 16 bytes against bank
// conflicts.  Shared memory is fixed (71 KB in bf16) whatever L is, and
// keys past L (the ragged edge) are excluded from both passes.
#include <mma.h>

#include <math.h>

#include "common.cuh"

using namespace nvcuda;

namespace {

constexpr int D = 64;    // head dim
constexpr int BQ = 64;   // query rows per block
constexpr int BK = 64;   // keys per tile
constexpr int NT = 128;  // 4 warps x 16 query rows
constexpr int LDS = BK + 4;  // fp32 score / output staging row stride
static_assert(BK == D, "the output staging reuses the score tile");

// Row strides of the T tiles, padded by 16 bytes so that the rows of a
// 16x16 fragment fall in different shared-memory banks.
template <typename T> struct Lds { static constexpr int v = D + 16 / sizeof(T); };

// Element strides of a (B, heads, L, D) operand whose rows are contiguous:
// q, k and v may be views into one fused (B, L, 3 H) projection, and the
// output may be written straight into the (B, L, H) layout.
struct Strides { long long b, h, l; };

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = valid ? 16 : 0;  // 0: fill the 16 bytes with zeros
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem), "r"(n));
}

// Rows [row0, row0 + 64) of one head's (L, D) matrix (rows `ld` elements
// apart) into a (64, D) tile, asynchronously; rows past L are zero.
template <typename T>
__device__ void load_tile(T* dst, const T* src, long long ld, int row0, int L) {
  constexpr int VEC = 16 / sizeof(T), PER_ROW = D / VEC, LD = Lds<T>::v;
  for (int c = threadIdx.x; c < 64 * PER_ROW; c += NT) {
    const int r = c / PER_ROW, col = (c % PER_ROW) * VEC;
    const bool ok = row0 + r < L;
    cp_async16(dst + r * LD + col, ok ? src + (row0 + r) * ld + col : src, ok);
  }
}

// s[rows of warp w][0, BK) = q k^T (unscaled), fp32.
__device__ void score_tile(const __nv_bfloat16* qs, const __nv_bfloat16* ks,
                           float* s) {
  constexpr int LD = Lds<__nv_bfloat16>::v;
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
__device__ void score_tile(const float* qs, const float* ks, float* s) {
  constexpr int LD = Lds<float>::v;
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
struct AccBF16 {
  static constexpr int LD = Lds<__nv_bfloat16>::v;
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
      wmma::load_matrix_sync(a, ps + 16 * w * LD + kk * 16, LD);
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
      wmma::store_matrix_sync(o + 16 * w * LDS + n * 16, f[n], LDS, wmma::mem_row_major);
  }
};

// fp32: each thread owns 32 outputs (row tid/2, columns (tid&1)*32 + c).
struct AccF32 {
  static constexpr int LD = Lds<float>::v;
  float o[32];
  __device__ void zero() {
#pragma unroll
    for (int c = 0; c < 32; ++c) o[c] = 0.0f;
  }
  __device__ void add_pv(const float* ps, const float* vs) {
    const int r = threadIdx.x >> 1, c0 = (threadIdx.x & 1) * 32;
    for (int j = 0; j < BK; ++j) {
      const float p = ps[r * LD + j];
#pragma unroll
      for (int c = 0; c < 32; ++c) o[c] = fmaf(p, vs[j * LD + c0 + c], o[c]);
    }
  }
  __device__ void store(float* out) {
    const int r = threadIdx.x >> 1, c0 = (threadIdx.x & 1) * 32;
#pragma unroll
    for (int c = 0; c < 32; ++c) out[r * LDS + c0 + c] = o[c];
  }
};

template <typename T>
constexpr size_t smem_bytes() {
  // fp32 scores + Q + 2 x (K, V) + P
  return (size_t)BQ * LDS * sizeof(float) + (size_t)(BQ + 4 * BK + BQ) * Lds<T>::v * sizeof(T);
}

template <typename T, typename Acc>
__global__ void __launch_bounds__(NT)
attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const float* __restrict__ bias,
                 T* __restrict__ out, int L, float scale, Strides in, Strides os) {
  constexpr int LD = Lds<T>::v;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  float* s = reinterpret_cast<float*>(smem_raw);  // (BQ, LDS) scores
  T* qs = reinterpret_cast<T*>(s + BQ * LDS);     // (BQ, LD)
  T* kv = qs + BQ * LD;                           // 2 buffers x (K, V) x (BK, LD)
  T* ps = kv + 4 * BK * LD;                       // (BQ, LD) probabilities

  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const long long base = b * in.b + h * in.h;
  const float* brow = bias + (size_t)b * L;
  // Row ops: thread tid owns row tid/2 of the tile, columns 2 j + (tid&1).
  // Row tid/2 lies in warp tid/32's 16-row strip, so a warp only ever reads
  // the scores it wrote itself and __syncwarp suffices between the two.
  const int r = threadIdx.x >> 1, half = threadIdx.x & 1;
  const int n_kt = (L + BK - 1) / BK;

  // The key tiles stream twice, K alone for pass 1, then K and V for pass
  // 2; tile t + 1 loads (cp.async) while tile t is in use.
  auto fetch = [&](int t) {
    T* dst = kv + (t & 1) * 2 * BK * LD;
    const int kt = t < n_kt ? t : t - n_kt;
    load_tile(dst, k + base, in.l, kt * BK, L);
    if (t >= n_kt) load_tile(dst + BK * LD, v + base, in.l, kt * BK, L);
    asm volatile("cp.async.commit_group;\n" ::);
  };
  load_tile(qs, q + base, in.l, q0, L);
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
    score_tile(qs, ks, s);
    __syncwarp();
    if (t < n_kt) {
      // Pass 1: row max and sum of exp(s - max), online over the key tiles.
      float sv[32];
      float tmax = -INFINITY;
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        const int c = 2 * j + half, col = kt * BK + c;
        sv[j] = col < L ? __fmaf_rn(s[r * LDS + c], scale, brow[col]) : -INFINITY;
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
            ? __expf(__fmaf_rn(s[r * LDS + c], scale, brow[col]) - m) * inv_l
            : 0.0f;
        ps[r * LD + c] = vt::from_f<T>(p);
      }
      __syncwarp();
      acc.add_pv(ps, ks + BK * LD);
    }
    __syncthreads();  // every warp is done with buffer t & 1
  }
  acc.store(s);  // each warp its own strip of the (BQ, D) fp32 staging
  __syncwarp();
  if (q0 + r < L) {
    const int c0 = half * 32;
    T* dst = out + b * os.b + h * os.h + (q0 + r) * os.l + c0;
#pragma unroll
    for (int c = 0; c < 32; ++c) dst[c] = vt::from_f<T>(s[r * LDS + c0 + c]);
  }
}

template <typename T, typename Acc>
int launch(const void* q, const void* k, const void* v, const void* bias,
           void* out, int B, int H, int L, Strides in, Strides os,
           cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<T>();
  static bool smem_set = false;  // once per instantiation and process
  if (!smem_set) {
    const cudaError_t e = cudaFuncSetAttribute(attention_kernel<T, Acc>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               (int)smem);
    if (e != cudaSuccess) return (int)e;
    smem_set = true;
  }
  const dim3 grid((L + BQ - 1) / BQ, H, B);
  attention_kernel<T, Acc><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const float*>(bias), static_cast<T*>(out), L,
      1.0f / sqrtf((float)D), in, os);
  return (int)cudaGetLastError();
}

}  // namespace

// q, k, v share the strides (sb, sh, sl); out has (ob, oh, ol); all rows
// contiguous.  Strides are in elements.
extern "C" int vt_attention_fwd(const void* q, const void* k, const void* v,
                                const void* bias, void* out, int B, int H, int L,
                                int head_dim, long long sb, long long sh, long long sl,
                                long long ob, long long oh, long long ol, int dtype,
                                void* stream) {
  if (head_dim != D || B <= 0 || H <= 0 || L <= 0) return (int)cudaErrorInvalidValue;
  const Strides in{sb, sh, sl}, os{ob, oh, ol};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == vt::kBF16)
    return launch<__nv_bfloat16, AccBF16>(q, k, v, bias, out, B, H, L, in, os, st);
  if (dtype == vt::kF32)
    return launch<float, AccF32>(q, k, v, bias, out, B, H, L, in, os, st);
  return (int)cudaErrorInvalidValue;
}
