// w8a8 fused MLP blocks for Hopper: both products int8 x int8 -> int32
// through the tensor cores, activations quantized per row on the fly.
//
//   pre-LN  (ViLT):  y = T(LN(x)); h = T(act(int32(q(y) W1) * (ys s1) + b1));
//                    out = T(int32(q(h) W2) * (hs s2) + b2) + x
//   post-LN (BERT):  h = T(act(int32(q(x) W1) * (xs s1) + b1));
//                    out = LN(x + int32(q(h) W2) * (hs s2) + b2)
//
// q(.) is the per-row int8 quantization (codes and scale, gemm_common.cuh).
// Replaces fused_mlp_block_fwd_w8a8 (_mlp_kernel_w8a8) and
// fused_mlp_postln_fwd_w8a8 (_mlp_postln_kernel_w8a8) of
// vault_tpu/ops/pallas_mlp.py, with their cast points: the LN output and h
// rounded to x's type T before they are quantized, each product's int32
// sum converted to fp32 once, whole, then scaled; the pre-LN residual added
// after the cast to T.  act is the exact-erf GELU (the TPU kernel used the
// A&S approximation because Mosaic lowers no erf), the tanh GELU or ReLU
// (vt::Act codes), applied in fp32 where the TPU kernel applies
// _kernel_act, before h is rounded and requantized, one rounding a step as
// the plain versions write it (gemm_common.cuh act_rn).
//
// Operands: x (rows, H) bf16 or fp32; gamma, beta, b2 (H) and b1 (I) in x's
// type; W1 (H, I) and W2 (I, H) int8, s1 (I) and s2 (H) fp32.  H is 768
// and I a multiple of 128.
//
// What bounds it on an H100: 4 rows H I int8 operations against 4.7 MB of
// weights, so the pre-LN block at 2,048 rows is bound by the int8 tensor
// cores (19.3 GOP, 0.0098 ms) and the post-LN block at 320 rows by the
// bytes (0.0017 ms).  The hard part is the requantization: q(h) needs the
// absmax of a whole I-wide row of h before the second product can start,
// and the TPU kernel simply held the full (256, 3072) row tile and both
// weight matrices in VMEM.  An SM has 227 KB (a 32-row tile of h in bf16 is
// 192 KB), so the block is cut into five launches, counted as one call:
//   1. row_prologue: LN (pre-LN) and q() of each row -> codes, scale;
//   2. gemm_tiles, epilogue kAct: h = T(act(...)) in (64, 128) tiles,
//      written to device memory (12.6 MB at 2,048 rows, each way), and the
//      absmax of each (row, 128-column tile) of the rounded h;
//   3. requant_rows: the row's absmax is the max of its tiles' (exact in
//      any order), then q(h) -> codes, scale;
//   4. gemm_tiles, epilogue kPartial: the second product, split along I
//      when the row tiles alone leave SMs idle (the 320-row BERT block),
//      each split's int32 sums to a workspace;
//   5. w8a8_out: the splits' int32 sums added (exact), converted once,
//      dequantized, b2, then the residual (pre-LN) or the residual and the
//      LayerNorm (post-LN).
// fp32 x takes the same kernels: only the casts to T disappear.
#include "gemm_common.cuh"

namespace {

// One row per block: h's int8 codes and scale from the per-tile maxima.
template <typename T>
__global__ void __launch_bounds__(gm::RT)
requant_rows(const T* __restrict__ h, const float* __restrict__ pmax, int tiles, int I,
             int8_t* __restrict__ q, float* __restrict__ scale) {
  __shared__ float red[gm::RT / 32];
  const size_t row = blockIdx.x;
  float m = 0.0f;
  for (int j = threadIdx.x; j < tiles; j += gm::RT) m = fmaxf(m, pmax[row * tiles + j]);
  const float s = gm::quant_scale(gm::block_max(m, red));
  for (int c = threadIdx.x; c < I; c += gm::RT)
    q[row * I + c] = gm::quant(vt::to_f(h[row * I + c]), s);
  if (threadIdx.x == 0) scale[row] = s;
}

// One row per block: sum the splits, dequantize, b2, residual [, LN].
template <typename T, int PER, bool POSTLN>
__global__ void __launch_bounds__(gm::RT)
w8a8_out(const T* __restrict__ x, const int* __restrict__ ws, int splits, int rows,
         const float* __restrict__ hs, const float* __restrict__ s2, const T* __restrict__ b2,
         const T* __restrict__ gamma, const T* __restrict__ beta, T* __restrict__ out,
         float eps) {
  constexpr int H = gm::RT * PER;
  __shared__ double red[gm::RT / 32];
  const int row = blockIdx.x;
  const size_t base = (size_t)row * H + threadIdx.x;
  const float rs = hs[row];
  float v[PER];
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int c = threadIdx.x + gm::RT * i;
    int acc = 0;
    for (int z = 0; z < splits; ++z) acc += ws[((size_t)z * rows + row) * H + c];
    const float o = __fadd_rn(__fmul_rn(__int2float_rn(acc), __fmul_rn(rs, s2[c])),
                              vt::to_f(b2[c]));
    const float xv = vt::to_f(x[base + gm::RT * i]);
    if constexpr (POSTLN) {
      v[i] = __fadd_rn(xv, o);
    } else {
      out[base + gm::RT * i] = vt::from_f<T>(__fadd_rn(vt::to_f(vt::from_f<T>(o)), xv));
    }
  }
  if constexpr (POSTLN) {
    gm::ln_row<T, PER>(v, gamma, beta, eps, red);
#pragma unroll
    for (int i = 0; i < PER; ++i) out[base + gm::RT * i] = vt::from_f<T>(v[i]);
  }
}

struct Bufs {
  int8_t* aq;   // (rows, H) codes of LN(x) or x
  float* as;    // (rows,) their scales
  void* h;      // (rows, I) T
  float* pmax;  // (rows, I / BN)
  int8_t* hq;   // (rows, I) codes of h
  float* hs;    // (rows,) their scales
  int* ws;      // (splits, rows, H) int32 partial sums
};

template <typename T, bool POSTLN>
int mlp_w8a8(const void* x, const void* gamma, const void* beta, const void* w1q,
             const void* s1, const void* b1, const void* w2q, const void* s2, const void* b2,
             const Bufs& bf, void* out, int rows, int I, float eps, int act, cudaStream_t st) {
  constexpr int H = 768;
  const T* xt = static_cast<const T*>(x);
  const T* g = static_cast<const T*>(gamma);
  const T* bt = static_cast<const T*>(beta);
  gm::row_prologue<T, H / gm::RT, !POSTLN, true><<<rows, gm::RT, 0, st>>>(
      xt, g, bt, nullptr, bf.aq, bf.as, eps);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const gm::EpiArgs ep1{bf.h, bf.as, static_cast<const float*>(s1), b1, bf.pmax, nullptr, act};
  int code = gm::launch_gemm<int8_t, T, gm::kAct>(bf.aq, static_cast<const int8_t*>(w1q),
                                                    rows, I, H, 1, ep1, st);
  if (code) return code;
  requant_rows<T><<<rows, gm::RT, 0, st>>>(static_cast<const T*>(bf.h), bf.pmax, I / gm::BN,
                                           I, bf.hq, bf.hs);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int splits = gm::pick_k_splits(rows, H, I);
  const gm::EpiArgs ep2{nullptr, nullptr, nullptr, nullptr, nullptr, bf.ws, 0};
  code = gm::launch_gemm<int8_t, T, gm::kPartial>(bf.hq, static_cast<const int8_t*>(w2q), rows,
                                                  H, I, splits, ep2, st);
  if (code) return code;
  w8a8_out<T, H / gm::RT, POSTLN><<<rows, gm::RT, 0, st>>>(
      xt, bf.ws, splits, rows, bf.hs, static_cast<const float*>(s2),
      static_cast<const T*>(b2), g, bt, static_cast<T*>(out), eps);
  return (int)cudaGetLastError();
}

bool bad_shape(int rows, int H, int I) { return rows <= 0 || H != 768 || I <= 0 || I % gm::BN; }
bool bad_act(int act) { return act != vt::kGeluErf && act != vt::kGeluTanh && act != vt::kRelu; }

}  // namespace

// Splits of the second product (the first dim of ws) for these shapes.
extern "C" int vt_mlp_w8a8_splits(int rows, int H, int I) {
  if (bad_shape(rows, H, I)) return -1;
  return gm::pick_k_splits(rows, H, I);
}

extern "C" int vt_mlp_w8a8(const void* x, const void* gamma, const void* beta, const void* w1q,
                           const void* s1, const void* b1, const void* w2q, const void* s2,
                           const void* b2, void* aq, void* as, void* h, void* pmax, void* hq,
                           void* hs, void* ws, void* out, int rows, int H, int I, float eps,
                           int act, int postln, int dtype, void* stream) {
  if (bad_shape(rows, H, I) || bad_act(act)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Bufs bf{static_cast<int8_t*>(aq), static_cast<float*>(as), h,
                static_cast<float*>(pmax), static_cast<int8_t*>(hq), static_cast<float*>(hs),
                static_cast<int*>(ws)};
#define VT_MLP_W8A8(T, P) \
  mlp_w8a8<T, P>(x, gamma, beta, w1q, s1, b1, w2q, s2, b2, bf, out, rows, I, eps, act, st)
  if (dtype == vt::kBF16)
    return postln ? VT_MLP_W8A8(__nv_bfloat16, true) : VT_MLP_W8A8(__nv_bfloat16, false);
  if (dtype == vt::kF32) return postln ? VT_MLP_W8A8(float, true) : VT_MLP_W8A8(float, false);
#undef VT_MLP_W8A8
  return (int)cudaErrorInvalidValue;
}
