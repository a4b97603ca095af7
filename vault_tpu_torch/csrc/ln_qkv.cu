// Fused LayerNorm -> QKV projection for Hopper, the pre-LN ViLT layer's
// attention input: qkv = LN(x) Wqkv + b, one (rows, 3H) write.
//
//   fp    (vt_ln_qkv_wgmma bf16, vt_ln_qkv fp32):
//                           qkv = T(T(LN(x)) W + b), fp32 accumulation
//   w8a8  (vt_ln_qkv_w8a8): y = T(LN(x)); (yq, ys) = the row's int8 codes
//                           and scale; qkv = T(int32(yq W8) * (ys * s) + b)
//
// Replaces fused_ln_qkv_fwd (_ln_qkv_kernel) and fused_ln_qkv_fwd_w8a8
// (_ln_qkv_kernel_w8a8) of vault_tpu/ops/pallas_mlp.py, with their cast
// points: LN in fp32, rounded to x's type T before the product (and, w8a8,
// back to fp32 before the quantization), the bias added in fp32, one cast.
//
// Operands: x (rows, H) bf16 or fp32; gamma, beta (H) and b (3H) in x's
// type; W (H, 3H) in x's type (fp) or int8 with fp32 scales s (3H) (w8a8).
//
// What bounds it on an H100: at 2,048 rows, 2 rows H 3H = 7.25 GFLOP against
// 16 MB (bf16) or 14 MB (int8 weights) of operands, so the bf16 kernel is
// bound by the tensor cores (0.0073 ms) and the int8 one by the bytes
// (0.0043 ms).  The TPU kernel kept all of Wqkv in VMEM and normalised a
// 256-row tile in place; here two launches, counted as one call, the
// normalised rows (3 MB / 1.5 MB at 2,048 rows) written and read again:
//   * bf16 (vt_ln_qkv_wgmma): ln_rows_bf16 (mlp_common.cuh) writes y =
//     bf16(LN(x)), then the wgmma core (gemm_sm90.cuh) runs y W with W read
//     N-contiguous, 128 x 128 or 128 x 192 tiles (sm90::pick_tiling), the
//     bias added in fp32 in its epilogue (EpiBias), one cast.  H a multiple
//     of 64 up to 8,192, 3H a multiple of 64.
//   * fp32 and w8a8 (vt_ln_qkv, vt_ln_qkv_w8a8), H 768, 3H a multiple of
//     128: a row kernel normalises each row with the whole row in registers
//     and writes it in T (fp32) or as int8 codes and a scale (w8a8);
//     gemm_tiles (gemm_common.cuh) runs the product in (64, 128) tiles,
//     bias (fp32: plain fp32 FMA) or dequantization + bias (w8a8) in its
//     epilogue.
#include "gemm_common.cuh"
#include "gemm_sm90.cuh"

namespace {

template <typename T>
int ln_qkv(const void* x, const void* gamma, const void* beta, const void* w, const void* b,
           void* y, void* out, int rows, int N, float eps, cudaStream_t st) {
  gm::row_prologue<T, 6, true, false><<<rows, gm::RT, 0, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(gamma), static_cast<const T*>(beta),
      static_cast<T*>(y), nullptr, nullptr, 768, eps);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  gm::EpiArgs ep{out, nullptr, nullptr, b};
  return gm::launch_gemm<T, T, gm::kBias>(static_cast<const T*>(y), static_cast<const T*>(w),
                                          rows, N, 768, ep, st);
}

template <typename T>
int ln_qkv_w8a8(const void* x, const void* gamma, const void* beta, const void* wq,
                const void* s, const void* b, void* yq, void* ys, void* out, int rows, int N,
                float eps, cudaStream_t st) {
  gm::row_prologue<T, 6, true, true><<<rows, gm::RT, 0, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(gamma), static_cast<const T*>(beta),
      nullptr, static_cast<int8_t*>(yq), static_cast<float*>(ys), 768, eps);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  gm::EpiArgs ep{out, static_cast<const float*>(ys), static_cast<const float*>(s), b};
  return gm::launch_gemm<int8_t, T, gm::kDequant>(
      static_cast<const int8_t*>(yq), static_cast<const int8_t*>(wq), rows, N, 768, ep, st);
}

bool bad_shape(int rows, int H, int N) { return rows <= 0 || H != 768 || N % gm::BN; }

// Epilogue of the core's product: out = bf16(acc + float(b)), pairs.
struct EpiBias {
  const __nv_bfloat16* b;
  __nv_bfloat16* out;
  int n;
  __device__ __forceinline__ void operator()(int r, int c, float v0, float v1, bool in) const {
    const __nv_bfloat162 bb = __ldg(reinterpret_cast<const __nv_bfloat162*>(b + c));
    const __nv_bfloat162 o(vt::from_f<__nv_bfloat16>(v0 + vt::to_f(bb.x)),
                           vt::from_f<__nv_bfloat16>(v1 + vt::to_f(bb.y)));
    if (in) *reinterpret_cast<__nv_bfloat162*>(out + (size_t)r * n + c) = o;
  }
};

int ln_qkv_wgmma(const void* x, const void* gamma, const void* beta, const void* w,
                 const void* b, void* y, void* out, int rows, int H, int N, float eps,
                 cudaStream_t st) {
  using bf = __nv_bfloat16;
  if (rows <= 0 || H < 64 || H > ROW_MAX_H || H % 64 != 0 || N <= 0 || N % 64 != 0)
    return (int)cudaErrorInvalidValue;
  bf* yp = static_cast<bf*>(y);
  ln_rows_bf16<<<(rows + LN_WARPS - 1) / LN_WARPS, LN_WARPS * 32, 0, st>>>(
      static_cast<const bf*>(x), static_cast<const bf*>(gamma), static_cast<const bf*>(beta), yp,
      nullptr, nullptr, nullptr, rows, H, eps);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const bf* wp = static_cast<const bf*>(w);
  const EpiBias epi{static_cast<const bf*>(b), static_cast<bf*>(out), N};
  return (int)(sm90::pick_tiling(rows, N, H, 128, 192, 1).bn == 192
                   ? sm90::gemm<192, true>(yp, wp, rows, N, H, epi, st)
                   : sm90::gemm<128, true>(yp, wp, rows, N, H, epi, st));
}

}  // namespace

// bf16 on the core; y: (rows, H) bf16 scratch.
extern "C" int vt_ln_qkv_wgmma(const void* x, const void* gamma, const void* beta,
                               const void* w, const void* b, void* y, void* out, int rows,
                               int H, int N, float eps, void* stream) {
  return ln_qkv_wgmma(x, gamma, beta, w, b, y, out, rows, H, N, eps,
                      static_cast<cudaStream_t>(stream));
}

// fp32 (bf16 takes the core, ops/cuda_ln_qkv.py); y: (rows, H) fp32
// scratch.
extern "C" int vt_ln_qkv(const void* x, const void* gamma, const void* beta, const void* w,
                         const void* b, void* y, void* out, int rows, int H, int N, float eps,
                         int dtype, void* stream) {
  if (bad_shape(rows, H, N) || dtype != vt::kF32) return (int)cudaErrorInvalidValue;
  return ln_qkv<float>(x, gamma, beta, w, b, y, out, rows, N, eps,
                       static_cast<cudaStream_t>(stream));
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
