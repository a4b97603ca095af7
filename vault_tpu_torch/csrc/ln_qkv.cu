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
// type; W (H, 3H) in x's type (fp), or (w8a8) int8 held K-major, i.e.
// stored as its transpose W^T (3H, H) row-major (ops/cuda_ln_qkv.py
// _w8a8_operands: the int8 wgmma has no transpose bit), with fp32 scales s
// (3H).
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
//   * w8a8 (vt_ln_qkv_w8a8): row_prologue (gemm_common.cuh, one block a
//     row, the row in registers; the exact instance at H 768) writes the
//     row's codes and scale, then the int8 instance of the core runs yq W^T
//     with the dequantization and the bias in its epilogue
//     (EpiDequantBias8, gm::dequant_acc), one cast, bit-equal to the plain
//     version.  At 768 the product is 6 int8 k-steps a tile, so a tile's
//     fill and epilogue weigh as much as its products: the tile width
//     (QKV_NARROW, QKV_WIDE, picked by waves, sm90::pick_tiling) was timed
//     on the card by scripts/torch_lnqkv_s8_tiles.py (PERF.md).
//   * fp32 (vt_ln_qkv): row_prologue writes y = LN(x) in fp32, then
//     gemm_tiles (gemm_tiles.cuh, plain fp32 FMA) runs y W + b (EpiBias).
//   The w8a8 and fp32 entries take H a multiple of 128 up to 8,192 (the row
//   pass's 128 threads and its registers; the int8 core's 128-byte k-step)
//   and 3H a multiple of 128 (gemm_tiles' tile width).
#include "gemm_common.cuh"
#include "gemm_sm90.cuh"
#include "gemm_tiles.cuh"

namespace {

constexpr int QKV_NARROW = 64;      // the int8 product's tile widths, picked by waves
constexpr int QKV_WIDE = 192;
constexpr bool ROWS_FIRST = false;  // walk N fastest: W^T (1.8 MB at H 768) sits in L2

bool bad_shape(int rows, int H, int N) {
  return rows <= 0 || H <= 0 || H % gm::RT || H > gm::ROW_H_MAX || N <= 0 || N % ft::BN;
}

// Epilogue of the int8 product: out = T(float(acc) * (ys[r] * s[c]) + b[c]).
template <typename T>
struct EpiDequantBias8 {
  const float *ys, *s;
  const T* b;
  T* out;
  int n;  // 3H
  __device__ __forceinline__ void operator()(int r, int c, int v0, int v1, bool in) const {
    const float rs = __ldg(ys + r);
    const float2 cs = __ldg(reinterpret_cast<const float2*>(s + c));
    const float2 bb = gm::load_pair<T>(b + c);
    const float o0 = gm::dequant_acc(v0, rs, cs.x, bb.x);
    const float o1 = gm::dequant_acc(v1, rs, cs.y, bb.y);
    if (in) gm::store_pair<T>(out + (size_t)r * n + c, o0, o1);
  }
};

// wt (N, H): the codes of W, K-major.
template <typename T>
int ln_qkv_w8a8(const void* x, const void* gamma, const void* beta, const void* wt,
                const void* s, const void* b, void* yq, void* ys, void* out, int rows, int H,
                int N, float eps, cudaStream_t st) {
  int8_t* q = static_cast<int8_t*>(yq);
  float* qs = static_cast<float*>(ys);
  cudaError_t e = gm::with_row(H, [&](auto P, auto EXACT) {
    gm::row_prologue<T, decltype(P)::value, true, true, decltype(EXACT)::value>
        <<<rows, gm::RT, 0, st>>>(static_cast<const T*>(x), static_cast<const T*>(gamma),
                                  static_cast<const T*>(beta), nullptr, q, qs, H, eps);
  });
  if (e != cudaSuccess) return (int)e;
  const EpiDequantBias8<T> epi{qs, static_cast<const float*>(s), static_cast<const T*>(b),
                               static_cast<T*>(out), N};
  const int8_t* w = static_cast<const int8_t*>(wt);
  const int bn =
      sm90::pick_tiling(rows, N, H, QKV_NARROW, QKV_WIDE, 1, sm90::ROW_BYTES).bn;
  return (int)(bn == QKV_WIDE
                   ? sm90::gemm<QKV_WIDE, false, sm90::COOP, ROWS_FIRST>(q, w, rows, N, H, epi, st)
                   : sm90::gemm<QKV_NARROW, false, sm90::COOP, ROWS_FIRST>(q, w, rows, N, H, epi,
                                                                          st));
}

// Epilogue of the core's bf16 product: out = bf16(acc + float(b)), pairs.
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
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* yp = static_cast<float*>(y);
  const cudaError_t e = gm::with_row(H, [&](auto P, auto EXACT) {
    gm::row_prologue<float, decltype(P)::value, true, false, decltype(EXACT)::value>
        <<<rows, gm::RT, 0, st>>>(static_cast<const float*>(x), static_cast<const float*>(gamma),
                                  static_cast<const float*>(beta), yp, nullptr, nullptr, H, eps);
  });
  if (e != cudaSuccess) return (int)e;
  return (int)ft::gemm(yp, static_cast<const float*>(w), rows, N, H,
                       ft::EpiBias{static_cast<const float*>(b), static_cast<float*>(out), N}, st);
}

// wt: (N, H) int8, the codes K-major; yq: (rows, H) int8 and ys: (rows,)
// fp32 scratch.  Every pointer 16-byte aligned.
extern "C" int vt_ln_qkv_w8a8(const void* x, const void* gamma, const void* beta,
                              const void* wt, const void* s, const void* b, void* yq, void* ys,
                              void* out, int rows, int H, int N, float eps, int dtype,
                              void* stream) {
  if (bad_shape(rows, H, N)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == vt::kBF16)
    return ln_qkv_w8a8<__nv_bfloat16>(x, gamma, beta, wt, s, b, yq, ys, out, rows, H, N, eps,
                                      st);
  if (dtype == vt::kF32)
    return ln_qkv_w8a8<float>(x, gamma, beta, wt, s, b, yq, ys, out, rows, H, N, eps, st);
  return (int)cudaErrorInvalidValue;
}
