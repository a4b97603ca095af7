// Fused MLP blocks for Hopper: the MLP half of a transformer layer, the
// (rows, I) intermediate never written to device memory.
//
//   pre-LN  (ViLT):  out = x + m * (act(LN(x) W1 + b1) W2 + b2)
//   post-LN (BERT):  out = LN(x + m * (act(x W1 + b1) W2 + b2))
//
// Replaces fused_mlp_block_fwd (_mlp_kernel) and fused_mlp_postln_fwd
// (_mlp_postln_kernel) of vault_tpu/ops/pallas_mlp.py.  Numerics follow
// them: fp32 LN statistics, fp32 accumulation of both products, the bias
// added in fp32, the activation cast to x's type before the second
// product, the optional pre-scaled dropout mask m applied in fp32, and in
// the pre-LN block the residual added after the cast to x's type.  GELU is
// exact (erff); the TPU kernel used the A&S approximation only because
// Mosaic lowers no erf.
//
// Operands: x, m, out (rows, H); w1 (H, I); w2 (I, H); gamma, beta, b2
// (H); b1 (I); all bf16 or all fp32, contiguous.  H is 768 (BERT-base,
// ViLT-B/32) and I a multiple of 128.
//
// What bounds it on an H100: 4 rows H I FLOP against the weights' 4 H I
// bytes (bf16), so it is bound by the tensor cores once rows reaches about
// 300 and by the weight bytes below that (the post-LN block at 320 rows
// sits at the line).  The TPU kernel kept W1 and W2 (9.4 MB at H = 768 in
// bf16) resident in VMEM; an SM has 227 KB, so the work is cut two ways:
//   * a block owns 32 rows and one slice of I ("split"); it computes LN(x)
//     once into shared memory, then walks its slice 128 columns at a time:
//     act(LN(x) W1[:, j:j+128] + b1) into shared memory (cast to x's type),
//     then that slice's contribution to all H output columns, accumulated
//     in fp32 fragments in registers across the whole walk;
//   * W1 and W2 stream through shared memory in tiles (32 KB of W1, 48 KB
//     of W2), double-buffered with cp.async so the next tile loads while
//     the tensor cores (bf16 16x16x16 wmma, fp32 accumulation) work on the
//     current one; rows are padded by 16 bytes against bank conflicts;
//   * the number of splits is chosen so that about one block runs per SM
//     (the 320-row post-LN block would otherwise fill 10 of 132 SMs); each
//     split writes its fp32 partial sums to a workspace, and a second,
//     small kernel adds them in a fixed order (deterministic), then applies
//     b2, the mask, the residual and, post-LN, the LayerNorm.
// fp32 operands take the same tiling with plain FMA in full fp32.
#include <mma.h>

#include <math.h>
#include <type_traits>

#include "common.cuh"

using namespace nvcuda;

namespace {

constexpr int BM = 32;       // rows per block
constexpr int NW = 8;        // warps per block
constexpr int NT = NW * 32;  // threads per block
constexpr int BN1 = 128;     // I columns per sub-slice (16 per warp)
constexpr int TPR = NT / BM; // threads per row in the prologue (8)

template <typename T> struct Tiles {
  static constexpr int PAD = 16 / sizeof(T);                // 16-byte row pad
  static constexpr int KT1 = 256 / sizeof(T);               // W1 tile rows (k)
  static constexpr int KT2 = 64 / sizeof(T);                // W2 tile rows (k)
  static constexpr int LD1 = BN1 + PAD;                     // W1 tile / hs ld
  static constexpr int LDF = BN1 + 4;                       // fp32 hf ld
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

// Shared-memory bytes of the main kernel.
template <typename T, int H>
constexpr size_t main_smem() {
  using TL = Tiles<T>;
  constexpr size_t w1 = (size_t)TL::KT1 * TL::LD1 * sizeof(T);
  constexpr size_t w2 = (size_t)TL::KT2 * (H + TL::PAD) * sizeof(T);
  constexpr size_t buf = w1 > w2 ? w1 : w2;
  return 2 * buf + (size_t)BM * (H + TL::PAD) * sizeof(T)   // wbuf x2, xa
         + (size_t)BM * TL::LD1 * sizeof(T)                  // hs
         + (std::is_same<T, float>::value ? 0 : (size_t)BM * TL::LDF * sizeof(float));
}

// Grid (row tiles, splits).  Block (r, s): rows [32 r, 32 r + 32), I columns
// [s * ic, (s + 1) * ic); writes its fp32 partial (32, H) to ws[s].
template <typename T, int NF, bool POSTLN>
__global__ void __launch_bounds__(NT)
mlp_main(const T* __restrict__ x, const T* __restrict__ gamma,
         const T* __restrict__ beta, const T* __restrict__ w1,
         const T* __restrict__ b1, const T* __restrict__ w2,
         float* __restrict__ ws, int rows, int rows_pad, int I, int ic,
         float eps, int act) {
  using TL = Tiles<T>;
  constexpr int H = NF * 16 * NW;
  constexpr int LDX = H + TL::PAD;
  constexpr int LD2 = H + TL::PAD;
  constexpr int LD1 = TL::LD1;
  constexpr int KT1 = TL::KT1, KT2 = TL::KT2;
  constexpr int N1 = H / KT1;        // W1 tiles per sub-slice
  constexpr int N2 = BN1 / KT2;      // W2 tiles per sub-slice
  constexpr int BUF = (KT1 * LD1 > KT2 * LD2) ? KT1 * LD1 : KT2 * LD2;  // elements
  constexpr bool kBF16 = std::is_same<T, __nv_bfloat16>::value;

  extern __shared__ __align__(128) unsigned char smem_raw[];
  T* wbuf = reinterpret_cast<T*>(smem_raw);  // 2 x BUF
  T* xa = wbuf + 2 * BUF;                    // (BM, LDX) first operand
  T* hs = xa + BM * LDX;                     // (BM, LD1) activation
  float* hf = reinterpret_cast<float*>(hs + BM * LD1);  // (BM, LDF) bf16 only

  const int tid = threadIdx.x, w = tid >> 5, lane = tid & 31;
  const int row0 = blockIdx.x * BM;
  const int i0 = blockIdx.y * ic;
  const int n_tiles = (ic / BN1) * (N1 + N2);

  // tile t of the stream: sub-slice t / (N1 + N2); first N1 tiles are W1
  // (KT1 x 128 at rows k0, columns i0 + 128 sub), then N2 tiles of W2
  // (KT2 x H at rows i0 + 128 sub + k0).
  auto fetch = [&](int t) {
    T* dst = wbuf + (t & 1) * BUF;
    const int sub = t / (N1 + N2), p = t % (N1 + N2);
    constexpr int V = 16 / sizeof(T);  // elements per 16-byte copy
    if (p < N1) {
      const T* src = w1 + (size_t)(p * KT1) * I + i0 + sub * BN1;
      for (int c = tid; c < KT1 * (BN1 / V); c += NT) {
        const int r = c / (BN1 / V), col = (c % (BN1 / V)) * V;
        cp_async16(dst + r * LD1 + col, src + (size_t)r * I + col);
      }
    } else {
      const T* src = w2 + (size_t)(i0 + sub * BN1 + (p - N1) * KT2) * H;
      for (int c = tid; c < KT2 * (H / V); c += NT) {
        const int r = c / (H / V), col = (c % (H / V)) * V;
        cp_async16(dst + r * LD2 + col, src + (size_t)r * H + col);
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

  // accumulators: bf16 — warp w owns GEMM1 columns [16 w, 16 w + 16) of the
  // sub-slice and GEMM2 columns [w H/8, (w+1) H/8), both for the two 16-row
  // groups; fp32 — thread (r = tid/8, q = tid%8) owns GEMM1 columns
  // 16 q .. 16 q + 16 and GEMM2 columns q + 8 j of row r.
  constexpr int NA1 = kBF16 ? 2 : 1, NA2 = kBF16 ? 2 * NF : 1;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc1[NA1], acc2[NA2];
  constexpr int F1 = kBF16 ? 1 : BN1 / 8, F2 = kBF16 ? 1 : H / 8;
  float f1[F1], f2[F2];
  if constexpr (kBF16) {
#pragma unroll
    for (int i = 0; i < NA1; ++i) wmma::fill_fragment(acc1[i], 0.0f);
#pragma unroll
    for (int i = 0; i < NA2; ++i) wmma::fill_fragment(acc2[i], 0.0f);
  } else {
#pragma unroll
    for (int i = 0; i < F1; ++i) f1[i] = 0.0f;
#pragma unroll
    for (int i = 0; i < F2; ++i) f2[i] = 0.0f;
  }
  const int fr = tid >> 3, fq = tid & 7;  // fp32 thread mapping

  for (int t = 0; t < n_tiles; ++t) {
    if (t + 1 < n_tiles) {
      fetch(t + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // tile t (and, at t = 0, xa) visible to every warp
    const T* wt = wbuf + (t & 1) * BUF;
    const int sub = t / (N1 + N2), p = t % (N1 + N2);
    if (p < N1) {
      // GEMM1: acc1 += xa[:, k0:k0+KT1] wt
      const int k0 = p * KT1;
      if constexpr (kBF16) {
#pragma unroll
        for (int kk = 0; kk < KT1 / 16; ++kk) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> b;
          wmma::load_matrix_sync(b, wt + kk * 16 * LD1 + w * 16, LD1);
#pragma unroll
          for (int g = 0; g < 2; ++g) {
            wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
            wmma::load_matrix_sync(a, xa + g * 16 * LDX + k0 + kk * 16, LDX);
            wmma::mma_sync(acc1[g], a, b, acc1[g]);
          }
        }
      } else {
        for (int k = 0; k < KT1; ++k) {
          const float a = vt::to_f(xa[fr * LDX + k0 + k]);
#pragma unroll
          for (int c = 0; c < F1; ++c) f1[c] = fmaf(a, vt::to_f(wt[k * LD1 + fq * F1 + c]), f1[c]);
        }
      }
      if (p == N1 - 1) {
        // sub-slice done: hs = act(acc1 + b1), cast to T
        const int j0 = i0 + sub * BN1;
        if constexpr (kBF16) {
#pragma unroll
          for (int g = 0; g < 2; ++g) {
            wmma::store_matrix_sync(hf + g * 16 * Tiles<T>::LDF + w * 16, acc1[g],
                                    Tiles<T>::LDF, wmma::mem_row_major);
            wmma::fill_fragment(acc1[g], 0.0f);
          }
          __syncwarp();
#pragma unroll
          for (int e = 0; e < 16; ++e) {
            const int idx = lane + 32 * e, rr = idx / 16, cc = w * 16 + idx % 16;
            const float hv = hf[rr * Tiles<T>::LDF + cc] + vt::to_f(b1[j0 + cc]);
            hs[rr * LD1 + cc] = vt::from_f<T>(vt::activate(hv, act));
          }
        } else {
#pragma unroll
          for (int c = 0; c < F1; ++c) {
            const int cc = fq * F1 + c;
            const float hv = f1[c] + vt::to_f(b1[j0 + cc]);
            hs[fr * LD1 + cc] = vt::from_f<T>(vt::activate(hv, act));
            f1[c] = 0.0f;
          }
        }
      }
    } else {
      // GEMM2: acc2 += hs[:, k0:k0+KT2] wt   (hs complete: written before
      // the previous iteration's closing barrier)
      const int k0 = (p - N1) * KT2;
      if constexpr (kBF16) {
#pragma unroll
        for (int kk = 0; kk < KT2 / 16; ++kk) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a0, a1;
          wmma::load_matrix_sync(a0, hs + k0 + kk * 16, LD1);
          wmma::load_matrix_sync(a1, hs + 16 * LD1 + k0 + kk * 16, LD1);
#pragma unroll
          for (int f = 0; f < NF; ++f) {
            wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> b;
            wmma::load_matrix_sync(b, wt + kk * 16 * LD2 + w * NF * 16 + f * 16, LD2);
            wmma::mma_sync(acc2[f], a0, b, acc2[f]);
            wmma::mma_sync(acc2[NF + f], a1, b, acc2[NF + f]);
          }
        }
      } else {
        for (int k = 0; k < KT2; ++k) {
          const float a = vt::to_f(hs[fr * LD1 + k0 + k]);
#pragma unroll
          for (int j = 0; j < F2; ++j) f2[j] = fmaf(a, vt::to_f(wt[k * LD2 + fq + 8 * j]), f2[j]);
        }
      }
    }
    __syncthreads();  // every warp is done with wbuf[t & 1] and hs
  }

  // partial sums of this split -> ws[split] (rows padded to BM)
  float* dst = ws + ((size_t)blockIdx.y * rows_pad + row0) * H;
  if constexpr (kBF16) {
#pragma unroll
    for (int g = 0; g < 2; ++g)
#pragma unroll
      for (int f = 0; f < NF; ++f)
        wmma::store_matrix_sync(dst + (size_t)g * 16 * H + w * NF * 16 + f * 16,
                                acc2[g * NF + f], H, wmma::mem_row_major);
  } else {
#pragma unroll
    for (int j = 0; j < F2; ++j) dst[(size_t)fr * H + fq + 8 * j] = f2[j];
  }
}

// One block per row, EPI threads: sum the splits' partials in order, then
// b2, the mask, the residual and (post-LN) the LayerNorm.
constexpr int EPI = 128;

template <typename T, int NF, bool POSTLN>
__global__ void __launch_bounds__(EPI)
mlp_epilogue(const T* __restrict__ x, const T* __restrict__ gamma,
             const T* __restrict__ beta, const T* __restrict__ b2,
             const T* __restrict__ m, const float* __restrict__ ws,
             T* __restrict__ out, int rows_pad, int splits, float eps) {
  constexpr int H = NF * 16 * NW;
  constexpr int PER = H / EPI;
  __shared__ float red[EPI / 32];
  const int row = blockIdx.x, tid = threadIdx.x;
  const T* xr = x + (size_t)row * H;
  T* orow = out + (size_t)row * H;
  float v[PER];
#pragma unroll
  for (int i = 0; i < PER; ++i) v[i] = 0.0f;
  for (int s = 0; s < splits; ++s) {
    const float* p = ws + ((size_t)s * rows_pad + row) * H + tid;
#pragma unroll
    for (int i = 0; i < PER; ++i) v[i] += p[EPI * i];
  }
  float sum = 0.0f;
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int c = tid + EPI * i;
    float o = v[i] + vt::to_f(b2[c]);
    if (m) o *= vt::to_f(m[(size_t)row * H + c]);
    if constexpr (POSTLN) {
      v[i] = vt::to_f(xr[c]) + o;
      sum += v[i];
    } else {
      orow[c] = vt::from_f<T>(vt::to_f(vt::from_f<T>(o)) + vt::to_f(xr[c]));
    }
  }
  if constexpr (POSTLN) {
    auto block_sum = [&](float a) {
      a = group_sum<32>(a);
      __syncthreads();  // red is free (its last readers are done)
      if ((tid & 31) == 0) red[tid >> 5] = a;
      __syncthreads();
      float t = 0.0f;
#pragma unroll
      for (int w = 0; w < EPI / 32; ++w) t += red[w];
      return t;
    };
    const float mean = block_sum(sum) / H;
    float sq = 0.0f;
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const float d = v[i] - mean;
      sq += d * d;
    }
    const float inv = 1.0f / sqrtf(block_sum(sq) / H + eps);
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int c = tid + EPI * i;
      orow[c] = vt::from_f<T>((v[i] - mean) * inv * vt::to_f(gamma[c]) + vt::to_f(beta[c]));
    }
  }
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

// Splits of I: the fewest that keep the waves of one-block-per-SM shortest.
int pick_splits(int rows, int I) {
  const int tiles = (rows + BM - 1) / BM, nsub = I / BN1, sms = num_sms();
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

template <typename T, int NF, bool POSTLN>
int launch(const void* x, const void* gamma, const void* beta, const void* w1,
           const void* b1, const void* w2, const void* b2, const void* m, void* out,
           float* ws, int rows, int I, float eps, int act, cudaStream_t stream) {
  constexpr int H = NF * 16 * NW;
  const int splits = pick_splits(rows, I);
  const int tiles = (rows + BM - 1) / BM;
  const size_t smem = main_smem<T, H>();
  static bool smem_set = false;  // once per instantiation and process
  if (!smem_set) {
    const cudaError_t e = cudaFuncSetAttribute(mlp_main<T, NF, POSTLN>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               (int)smem);
    if (e != cudaSuccess) return (int)e;
    smem_set = true;
  }
  mlp_main<T, NF, POSTLN><<<dim3(tiles, splits), NT, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(gamma), static_cast<const T*>(beta),
      static_cast<const T*>(w1), static_cast<const T*>(b1), static_cast<const T*>(w2), ws,
      rows, tiles * BM, I, I / splits, eps, act);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  mlp_epilogue<T, NF, POSTLN><<<rows, EPI, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(gamma), static_cast<const T*>(beta),
      static_cast<const T*>(b2), static_cast<const T*>(m), ws, static_cast<T*>(out),
      tiles * BM, splits, eps);
  return (int)cudaGetLastError();
}

template <typename T, bool POSTLN>
int dispatch_h(int H, const void* x, const void* gamma, const void* beta,
               const void* w1, const void* b1, const void* w2, const void* b2,
               const void* m, void* out, float* ws, int rows, int I, float eps, int act,
               cudaStream_t st) {
  if (H == 768)
    return launch<T, 6, POSTLN>(x, gamma, beta, w1, b1, w2, b2, m, out, ws, rows, I, eps, act, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// fp32 elements of workspace vt_mlp_fwd needs for these shapes.
extern "C" long long vt_mlp_workspace(int rows, int H, int I) {
  if (rows <= 0 || I <= 0 || I % BN1 != 0) return -1;
  return (long long)pick_splits(rows, I) * ((rows + BM - 1) / BM) * BM * H;
}

extern "C" int vt_mlp_fwd(const void* x, const void* gamma, const void* beta,
                          const void* w1, const void* b1, const void* w2,
                          const void* b2, const void* m, void* out, void* ws,
                          int rows, int H, int I, float eps, int act, int postln,
                          int dtype, void* stream) {
  if (rows <= 0 || I <= 0 || I % BN1 != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* wsf = static_cast<float*>(ws);
  if (dtype == vt::kBF16) {
    return postln
        ? dispatch_h<__nv_bfloat16, true>(H, x, gamma, beta, w1, b1, w2, b2, m, out, wsf, rows, I, eps, act, st)
        : dispatch_h<__nv_bfloat16, false>(H, x, gamma, beta, w1, b1, w2, b2, m, out, wsf, rows, I, eps, act, st);
  }
  if (dtype == vt::kF32) {
    return postln
        ? dispatch_h<float, true>(H, x, gamma, beta, w1, b1, w2, b2, m, out, wsf, rows, I, eps, act, st)
        : dispatch_h<float, false>(H, x, gamma, beta, w1, b1, w2, b2, m, out, wsf, rows, I, eps, act, st);
  }
  return (int)cudaErrorInvalidValue;
}
