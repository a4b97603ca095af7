// The wgmma core of gemm_sm90.cuh on its own, for holding each of its
// operand layouts, tile widths and split-K against a plain product
// (ops/cuda_gemm.py): the bf16 products the MLP blocks run, with an
// epilogue that stores the fp32 accumulators, and the int8 instance's, with
// one that stores the s32 ones; and the w8 block's dequantization pass
// alone, against its plain version.  No main path calls these entries.
#include "common.cuh"
#include "gemm_sm90.cuh"

namespace {

using bf = __nv_bfloat16;

// Epilogue of the dual form: both fp32 products, (M, N) each.
struct StoreF32Pair {
  float *c1, *c2;
  int n;
  __device__ __forceinline__ void operator()(int r, int col, float v0, float v1, float u0,
                                             float u1, bool in) const {
    if (!in) return;
    const size_t o = (size_t)r * n + col;
    *reinterpret_cast<float2*>(c1 + o) = make_float2(v0, v1);
    *reinterpret_cast<float2*>(c2 + o) = make_float2(u0, u1);
  }
};

template <int BN>
cudaError_t gemm_s8_at(bool rows_first, const int8_t* a, const int8_t* b, int M, int N, int K,
                       const sm90::StoreS32& epi, cudaStream_t st) {
  return rows_first ? sm90::gemm<BN, false, sm90::COOP, true>(a, b, M, N, K, epi, st)
                    : sm90::gemm<BN, false, sm90::COOP, false>(a, b, M, N, K, epi, st);
}

template <int BN>
cudaError_t gemm_at(bool b_kmajor, const bf* a, const bf* b, int M, int N, int K,
                    const sm90::StoreF32& epi, cudaStream_t st, int splits) {
  return b_kmajor ? sm90::gemm<BN, false>(a, b, M, N, K, epi, st, nullptr, nullptr, splits)
                  : sm90::gemm<BN, true>(a, b, M, N, K, epi, st, nullptr, nullptr, splits);
}

}  // namespace

// c fp32 = a (M, K) b: b is (N, K) when b_kmajor, else (K, N); bn, the tile
// width, 64, 128 or 192; splits of K: c holds `splits` (M, N) slices, slice
// s the product over split s's K range (splits = 1: c is a b).
extern "C" int vt_gemm_bf16(const void* a, const void* b, void* c, int M, int N, int K,
                            int b_kmajor, int bn, int splits, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bf* ap = static_cast<const bf*>(a);
  const bf* bp = static_cast<const bf*>(b);
  const sm90::StoreF32 epi{static_cast<float*>(c), N};
  switch (bn) {
    case 64: return (int)gemm_at<64>(b_kmajor, ap, bp, M, N, K, epi, st, splits);
    case 128: return (int)gemm_at<128>(b_kmajor, ap, bp, M, N, K, epi, st, splits);
    case 192: return (int)gemm_at<192>(b_kmajor, ap, bp, M, N, K, epi, st, splits);
    default: return (int)cudaErrorInvalidValue;
  }
}

// c s32 (M, N) = a (M, K) b^T: a int8, b (N, K) int8 (K-contiguous, the
// only int8 B layout), K a multiple of 128, N even; bn, the tile width, 64,
// 128 or 192; rows_first: the work items walk rows fastest.
extern "C" int vt_gemm_s8(const void* a, const void* b, void* c, int M, int N, int K, int bn,
                          int rows_first, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int8_t* ap = static_cast<const int8_t*>(a);
  const int8_t* bp = static_cast<const int8_t*>(b);
  const sm90::StoreS32 epi{static_cast<int*>(c), N};
  if (N % 2) return (int)cudaErrorInvalidValue;
  switch (bn) {
    case 64: return (int)gemm_s8_at<64>(rows_first != 0, ap, bp, M, N, K, epi, st);
    case 128: return (int)gemm_s8_at<128>(rows_first != 0, ap, bp, M, N, K, epi, st);
    case 192: return (int)gemm_s8_at<192>(rows_first != 0, ap, bp, M, N, K, epi, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The dual form of the backward: c1 = a1 b1 with b1 (K, N), c2 = a2 b2^T
// with b2 (N, K), fp32 (M, N) each, one 128 x 128 tile holding both.
extern "C" int vt_gemm_dual_bf16(const void* a1, const void* b1, const void* a2,
                                 const void* b2, void* c1, void* c2, int M, int N, int K,
                                 void* stream) {
  return (int)sm90::gemm<128, true, sm90::DUAL>(
      static_cast<const bf*>(a1), static_cast<const bf*>(b1), M, N, K,
      StoreF32Pair{static_cast<float*>(c1), static_cast<float*>(c2), N},
      static_cast<cudaStream_t>(stream), static_cast<const bf*>(a2), static_cast<const bf*>(b2));
}

// out (K, N) bf16 = bf16(float(q) * s[n]): q (K, N) int8, s (N) fp32, N a
// multiple of 16, every pointer 16-byte aligned (sm90::dequant).
extern "C" int vt_dequant_bf16(const void* q, const void* s, void* out, int K, int N,
                               void* stream) {
  if (K <= 0 || N <= 0 || (long long)K * N >= (1ll << 34)) return (int)cudaErrorInvalidValue;
  const sm90::Dequant a{static_cast<const int8_t*>(q), static_cast<const float*>(s),
                        static_cast<bf*>(out), (int)((long long)K * N / 16), N};
  return (int)sm90::dequant(a, sm90::Dequant{nullptr, nullptr, nullptr, 0, 16},
                            static_cast<cudaStream_t>(stream));
}
