// The w8a8 linear for Hopper: y = bf16(int32(q(x) W8) * (xs * s) + b), the
// dense layer of ops/nn.py linear on int8 weights held K-major, where
// PyTorch runs it as sixteen kernels (the row quantization's ten, the int8
// product on torch._int_mm, the dequantization's five).
//
// q(.) is the per-row int8 quantization of x (codes and scale,
// gemm_common.cuh quant / quant_scale): scale = max(absmax(float(x)),
// 1e-8) / 127 and codes clip(rint(float(x) / scale), -127, 127), both true
// divisions.  The dequantization multiplies the two scales first, then the
// int32 sum converted to fp32, then adds the bias in fp32, one rounding a
// step (gm::dequant_acc, _rn intrinsics: nvcc contracts none into an FMA),
// then one cast to bf16: the order of ops/nn.py linear_w8a8_plain, whose
// bits it gives (the int32 products are exact).
//
// Operands: x (rows, K) bf16; W8 (K, N) int8 held K-major, i.e. stored as
// its transpose W8^T (N, K) row-major (ops/quantize.py k_major: the int8
// wgmma has no transpose bit); s (N) fp32; b (N) bf16 or none.  K a
// multiple of 128 up to 8,192 (the row pass's 128 threads and its
// registers; the int8 core's 128-byte k-step), N a multiple of 128.
//
// Two launches, counted as one call:
//   1. row_prologue (gemm_common.cuh, without the LayerNorm): one block a
//      row, the row in registers (the exact instance at K 512, 768 and
//      1,024, gm::with_row), writes the row's codes (rows, K) and scale;
//   2. the int8 instance of the wgmma core (gemm_sm90.cuh), A the codes, B
//      W8^T, epilogue EpiDequant8: the dequantization, the bias, the cast.
//      Tile width 64 or 192, picked by waves (sm90::pick_tiling), walking N
//      fastest so that W8^T (0.6 MB at 768 x 768) sits in L2; the widths
//      of ln_qkv.cu's int8 product, which has the same K.
//
// What bounds it on an H100: at BERT's 10,240 rows of 768 -> 768, 12.1 GOP
// (0.0061 ms at the int8 peak) against x read and y written in bf16, 31.5
// MB (0.0094 ms at 3.35 TB/s): the bytes.  The codes of x between the
// launches add half of x's bytes, written and read once (7.9 MB).
#include "gemm_common.cuh"
#include "gemm_sm90.cuh"

namespace {

constexpr int NARROW = 64;          // the product's tile widths, picked by waves
constexpr int WIDE = 192;
constexpr bool ROWS_FIRST = false;  // walk N fastest: W8^T sits in L2
constexpr int N_MULTIPLE = 128;

using bf = __nv_bfloat16;

// out = bf16(float(acc) * (ys[r] * s[c]) [+ float(b[c])]), pairs.
template <bool BIAS>
struct EpiDequant8 {
  const float *ys, *s;
  const bf* b;
  bf* out;
  int n;
  __device__ __forceinline__ void operator()(int r, int c, int v0, int v1, bool in) const {
    const float rs = __ldg(ys + r);
    const float2 cs = __ldg(reinterpret_cast<const float2*>(s + c));
    float o0, o1;
    if constexpr (BIAS) {
      const float2 bb = gm::load_pair<bf>(b + c);
      o0 = gm::dequant_acc(v0, rs, cs.x, bb.x);
      o1 = gm::dequant_acc(v1, rs, cs.y, bb.y);
    } else {
      o0 = __fmul_rn(__int2float_rn(v0), __fmul_rn(rs, cs.x));
      o1 = __fmul_rn(__int2float_rn(v1), __fmul_rn(rs, cs.y));
    }
    if (in) gm::store_pair<bf>(out + (size_t)r * n + c, o0, o1);
  }
};

template <bool BIAS>
cudaError_t product(const int8_t* q, const int8_t* w, const float* qs, const float* s,
                    const bf* b, bf* out, int rows, int K, int N, cudaStream_t st) {
  const EpiDequant8<BIAS> epi{qs, s, b, out, N};
  const int bn = sm90::pick_tiling(rows, N, K, NARROW, WIDE, 1, sm90::ROW_BYTES).bn;
  return bn == WIDE ? sm90::gemm<WIDE, false, sm90::COOP, ROWS_FIRST>(q, w, rows, N, K, epi, st)
                    : sm90::gemm<NARROW, false, sm90::COOP, ROWS_FIRST>(q, w, rows, N, K, epi,
                                                                        st);
}

}  // namespace

// wt: (N, K) int8, the codes K-major; b: (N) bf16 or null; xq: (rows, K)
// int8 and xs: (rows,) fp32 scratch.  Every pointer 16-byte aligned.
extern "C" int vt_linear_w8a8(const void* x, const void* wt, const void* s, const void* b,
                              void* xq, void* xs, void* out, int rows, int K, int N,
                              void* stream) {
  if (rows <= 0 || K <= 0 || K % gm::RT || K > gm::ROW_H_MAX || N <= 0 || N % N_MULTIPLE)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int8_t* q = static_cast<int8_t*>(xq);
  float* qs = static_cast<float*>(xs);
  const cudaError_t e = gm::with_row(K, [&](auto P, auto EXACT) {
    gm::row_prologue<bf, decltype(P)::value, false, true, decltype(EXACT)::value>
        <<<rows, gm::RT, 0, st>>>(static_cast<const bf*>(x), nullptr, nullptr, nullptr, q, qs,
                                  K, 0.0f);
  });
  if (e != cudaSuccess) return (int)e;
  const int8_t* w = static_cast<const int8_t*>(wt);
  const float* sp = static_cast<const float*>(s);
  bf* o = static_cast<bf*>(out);
  return (int)(b != nullptr
                   ? product<true>(q, w, qs, sp, static_cast<const bf*>(b), o, rows, K, N, st)
                   : product<false>(q, w, qs, sp, nullptr, o, rows, K, N, st));
}
