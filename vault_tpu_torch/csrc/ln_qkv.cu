// Fused LayerNorm -> QKV projection for Hopper, the pre-LN ViLT layer's
// attention input: qkv = LN(x) Wqkv + b, one (rows, 3H) write.
//
//   fp    (vt_ln_qkv):      qkv = T(T(LN(x)) W + b), fp32 accumulation
//   w8a8  (vt_ln_qkv_w8a8): y = T(LN(x)); (yq, ys) = the row's int8 codes
//                           and scale; qkv = T(int32(yq W8) * (ys * s) + b)
//
// Replaces fused_ln_qkv_fwd (_ln_qkv_kernel) and fused_ln_qkv_fwd_w8a8
// (_ln_qkv_kernel_w8a8) of vault_tpu/ops/pallas_mlp.py, with their cast
// points: LN in fp32, rounded to x's type T before the product (and, w8a8,
// back to fp32 before the quantization), the bias added in fp32, one cast.
//
// Operands: x (rows, H) bf16 or fp32; gamma, beta (H) and b (3H) in x's
// type; W (H, 3H) in x's type (fp) or int8 with fp32 scales s (3H) (w8a8);
// H is 768 and 3H a multiple of 128.
//
// What bounds it on an H100: at 2,048 rows, 2 rows H 3H = 7.25 GFLOP against
// 16 MB (bf16) or 14 MB (int8 weights) of operands, so the bf16 kernel is
// bound by the tensor cores (0.0073 ms) and the int8 one by the bytes
// (0.0043 ms).  The TPU kernel kept all of Wqkv in VMEM and normalised a
// 256-row tile in place; here two launches, counted as one call:
//   * a row kernel normalises each row with the whole row in registers and
//     writes it in T (fp) or as int8 codes and a scale (w8a8): 3 MB / 1.5 MB
//     written and read again, against the 7 GFLOP product;
//   * gemm_tiles (gemm_common.cuh) runs the product in (64, 128) tiles,
//     bias (fp) or dequantization + bias (w8a8) in its epilogue.
// fp32 operands take the same path with plain fp32 FMA.
#include "gemm_common.cuh"

namespace {

template <typename T>
int ln_qkv(const void* x, const void* gamma, const void* beta, const void* w, const void* b,
           void* y, void* out, int rows, int N, float eps, cudaStream_t st) {
  gm::row_prologue<T, 6, true, false><<<rows, gm::RT, 0, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(gamma), static_cast<const T*>(beta),
      static_cast<T*>(y), nullptr, nullptr, eps);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  gm::EpiArgs ep{out, nullptr, nullptr, b, nullptr, nullptr};
  return gm::launch_gemm<T, T, gm::kBias>(static_cast<const T*>(y), static_cast<const T*>(w),
                                          rows, N, 768, 1, ep, st);
}

template <typename T>
int ln_qkv_w8a8(const void* x, const void* gamma, const void* beta, const void* wq,
                const void* s, const void* b, void* yq, void* ys, void* out, int rows, int N,
                float eps, cudaStream_t st) {
  gm::row_prologue<T, 6, true, true><<<rows, gm::RT, 0, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(gamma), static_cast<const T*>(beta),
      nullptr, static_cast<int8_t*>(yq), static_cast<float*>(ys), eps);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  gm::EpiArgs ep{out, static_cast<const float*>(ys), static_cast<const float*>(s), b,
                 nullptr, nullptr};
  return gm::launch_gemm<int8_t, T, gm::kDequant>(
      static_cast<const int8_t*>(yq), static_cast<const int8_t*>(wq), rows, N, 768, 1, ep, st);
}

bool bad_shape(int rows, int H, int N) { return rows <= 0 || H != 768 || N % gm::BN; }

}  // namespace

// y: (rows, H) scratch in x's type.
extern "C" int vt_ln_qkv(const void* x, const void* gamma, const void* beta, const void* w,
                         const void* b, void* y, void* out, int rows, int H, int N, float eps,
                         int dtype, void* stream) {
  if (bad_shape(rows, H, N)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == vt::kBF16)
    return ln_qkv<__nv_bfloat16>(x, gamma, beta, w, b, y, out, rows, N, eps, st);
  if (dtype == vt::kF32) return ln_qkv<float>(x, gamma, beta, w, b, y, out, rows, N, eps, st);
  return (int)cudaErrorInvalidValue;
}

// yq: (rows, H) int8 and ys: (rows,) fp32 scratch.
extern "C" int vt_ln_qkv_w8a8(const void* x, const void* gamma, const void* beta,
                              const void* wq, const void* s, const void* b, void* yq, void* ys,
                              void* out, int rows, int H, int N, float eps, int dtype,
                              void* stream) {
  if (bad_shape(rows, H, N)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == vt::kBF16)
    return ln_qkv_w8a8<__nv_bfloat16>(x, gamma, beta, wq, s, b, yq, ys, out, rows, N, eps, st);
  if (dtype == vt::kF32)
    return ln_qkv_w8a8<float>(x, gamma, beta, wq, s, b, yq, ys, out, rows, N, eps, st);
  return (int)cudaErrorInvalidValue;
}
