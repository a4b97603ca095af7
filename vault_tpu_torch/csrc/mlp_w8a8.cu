// w8a8 fused MLP blocks for Hopper: both products int8 x int8 -> int32 on
// the int8 instance of the wgmma core (gemm_sm90.cuh), activations
// quantized per row on the fly.
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
// rounded to x's type T before they are quantized, the requantization group
// the whole I-wide row of h, each product's int32 sum over all of K
// converted to fp32 once, whole, then scaled; the pre-LN residual added
// after the cast to T.  act is the exact-erf GELU (the TPU kernel used the
// A&S approximation because Mosaic lowers no erf), the tanh GELU or ReLU
// (vt::Act codes), applied in fp32 where the TPU kernel applies
// _kernel_act, before h is rounded and requantized, one rounding a step as
// the plain versions write it (gemm_common.cuh act_rn).
//
// Operands: x (rows, H) bf16 or fp32; gamma, beta, b2 (H) and b1 (I) in x's
// type; W1 (H, I) and W2 (I, H) int8 held K-major, i.e. stored as their
// transposes W1^T (I, H) and W2^T (H, I), row-major (ops/quantize.py
// k_major: the int8 wgmma has no transpose bit); s1 (I) and s2 (H) fp32.
// H a multiple of 128 up to 8,192 (a stage of the int8 core is 128 bytes of
// K; the row passes hold a row in registers), I a multiple of 128 up to
// 32,768 (h_requant_rows holds a row of h in registers).
//
// What bounds it on an H100: 4 rows H I int8 operations against 4.7 MB of
// weights, so the pre-LN block at 2,048 rows is bound by the int8 tensor
// cores (19.3 GOP, 0.0098 ms) and the post-LN block at 320 rows by the
// bytes (0.0017 ms).  The hard part is the requantization: q(h) needs the
// absmax of a whole I-wide row of h before the second product can start,
// and the TPU kernel held the full (256, 3072) row tile and both weight
// matrices in VMEM.  Here h goes through device memory (12.6 MB at 2,048
// rows in bf16, which L2 holds), and the block is four launches (pre-LN)
// or five (post-LN), counted as one call:
//   1. row_prologue (gemm_common.cuh): LN (pre-LN) rounded to T, then the
//      row's int8 codes and scale; one block a row, the row in registers
//      (the exact instance at H 512, 768 and 1,024, gm::with_row);
//   2. the first product on the int8 core, A the codes (rows, H), B W1^T,
//      epilogue EpiAct8: h = T(act(...)) to device memory;
//   3. h_requant_rows: one block a row, the I-wide row of h in registers
//      (16-byte loads): its absmax, then its codes and scale;
//   4. the second product on the int8 core, A the codes of h (rows, I), B
//      W2^T, K = I:
//      * pre-LN, at one split: its epilogue (EpiResidual8) finishes the
//        block: dequantization, b2, the cast, + x;
//      * post-LN: K split where the tiles alone leave SMs idle (at 320
//        rows, 18 tiles of 128 x 128 on 132 SMs), each split's s32 sum to
//        slice s of an (S rows, H) workspace (sm90::StoreS32): integer
//        sums are exact in any order, so the split changes no bit (it
//        would for the SwiGLU block's fp32 sum over I-tiles);
//   5. post-LN only, w8a8_out: the slices added as integers, converted
//      once, dequantized, b2, the residual and the LayerNorm (which needs
//      the whole row).
// The second product's tile width (both) and split count (post-LN):
// sm90::pick_tiling over the waves and the int8 k-steps, from the widths
// below, which scripts/torch_w8a8_tiles.py timed on the card (PERF.md).
// fp32 x takes the same kernels: only the casts to T disappear.
#include "gemm_common.cuh"
#include "gemm_sm90.cuh"

namespace {

constexpr int RQ_RUNS = 4;         // h_requant_rows: runs of eight columns a thread
constexpr int I_MAX = 8 * RQ_RUNS * 1024;  // ... in at most 1,024 threads
constexpr int UP_BN = 128;         // tile width of the first product
constexpr int DOWN_NARROW = 64;    // tile widths the second product picks from
constexpr int DOWN_WIDE = 128;
constexpr int POST_MAX_SPLITS = 8;  // post-LN; pre-LN takes one split
constexpr bool ROWS_FIRST = false;  // walk N fastest: both weights sit in L2

// f(std::integral_constant<int, ACT>) for the run-time activation code (a
// run-time switch in an epilogue cost a quarter of a product's time, mlp.cu).
template <class F>
cudaError_t with_act_code(int act, F f) {
  switch (act) {
    case vt::kGeluErf: return f(std::integral_constant<int, vt::kGeluErf>());
    case vt::kGeluTanh: return f(std::integral_constant<int, vt::kGeluTanh>());
    case vt::kRelu: return f(std::integral_constant<int, vt::kRelu>());
    default: return cudaErrorInvalidValue;
  }
}

// Epilogue of the first product: h = T(act(float(acc) * (as[r] * s1[c]) +
// b1[c])).
template <typename T, int ACT>
struct EpiAct8 {
  const float *as, *s1;
  const T* b1;
  T* h;
  int n;  // I
  __device__ __forceinline__ void operator()(int r, int c, int v0, int v1, bool in) const {
    const float rs = __ldg(as + r);
    const float2 cs = __ldg(reinterpret_cast<const float2*>(s1 + c));
    const float2 b = gm::load_pair<T>(b1 + c);
    const float o0 = gm::act_rn(gm::dequant_acc(v0, rs, cs.x, b.x), ACT);
    const float o1 = gm::act_rn(gm::dequant_acc(v1, rs, cs.y, b.y), ACT);
    if (in) gm::store_pair<T>(h + (size_t)r * n + c, o0, o1);
  }
};

// Epilogue of the pre-LN second product: out =
// T(T(float(acc) * (hs[r] * s2[c]) + b2[c]) + x).
template <typename T>
struct EpiResidual8 {
  const float *hs, *s2;
  const T *b2, *x;
  T* out;
  int n;  // H
  __device__ __forceinline__ void operator()(int r, int c, int v0, int v1, bool in) const {
    const size_t o = (size_t)r * n + c;
    const float rs = __ldg(hs + r);
    const float2 cs = __ldg(reinterpret_cast<const float2*>(s2 + c));
    const float2 b = gm::load_pair<T>(b2 + c);
    const float2 xv = gm::load_pair<T>(x + o);
    const float o0 = vt::to_f(vt::from_f<T>(gm::dequant_acc(v0, rs, cs.x, b.x)));
    const float o1 = vt::to_f(vt::from_f<T>(gm::dequant_acc(v1, rs, cs.y, b.y)));
    if (in) gm::store_pair<T>(out + o, __fadd_rn(o0, xv.x), __fadd_rn(o1, xv.y));
  }
};

// One block per row of h (I columns), 128 ceil(I / 4,096) threads, each
// holding up to RQ_RUNS runs of eight consecutive columns (16-byte loads):
// the row's absmax, then its int8 codes and scale.
template <typename T>
__global__ void __launch_bounds__(1024)
h_requant_rows(const T* __restrict__ h, int I, int8_t* __restrict__ q,
               float* __restrict__ scale) {
  __shared__ float red[32];
  if (threadIdx.x < 32) red[threadIdx.x] = 0.0f;  // block_max<32>: the warps it lacks
  const size_t base = (size_t)blockIdx.x * I;
  float v[RQ_RUNS][8];
  float m = 0.0f;
#pragma unroll
  for (int k = 0; k < RQ_RUNS; ++k) {
    const int c = 8 * (threadIdx.x + blockDim.x * k);
    if (c < I) {
      load8(h + base + c, v[k]);
#pragma unroll
      for (int e = 0; e < 8; ++e) m = fmaxf(m, fabsf(v[k][e]));
    }
  }
  const float s = gm::quant_scale(gm::block_max<32>(m, red));
#pragma unroll
  for (int k = 0; k < RQ_RUNS; ++k) {
    const int c = 8 * (threadIdx.x + blockDim.x * k);
    if (c < I) *reinterpret_cast<uint2*>(q + base + c) = gm::quant8(v[k], s);
  }
  if (threadIdx.x == 0) scale[blockIdx.x] = s;
}

// Post-LN, one row per block, H = RT n columns, n <= PER: the S slices'
// s32 sums added (exact), converted once, dequantized, b2, then the
// residual and the LayerNorm.
template <typename T, int PER>
__global__ void __launch_bounds__(gm::RT)
w8a8_out(const T* __restrict__ x, const int* __restrict__ ws, int splits, int rows,
         const float* __restrict__ hs, const float* __restrict__ s2, const T* __restrict__ b2,
         const T* __restrict__ gamma, const T* __restrict__ beta, T* __restrict__ out, int H,
         float eps) {
  __shared__ double red[gm::RT / 32];
  const int row = blockIdx.x, n = H / gm::RT;
  const size_t base = (size_t)row * H + threadIdx.x;
  const float rs = hs[row];
  float v[PER];
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    v[i] = 0.0f;
    if (i < n) {
      const int c = threadIdx.x + gm::RT * i;
      int acc = 0;
      for (int z = 0; z < splits; ++z) acc += ws[((size_t)z * rows + row) * H + c];
      const float o = gm::dequant_acc(acc, rs, s2[c], vt::to_f(b2[c]));
      v[i] = __fadd_rn(vt::to_f(x[base + gm::RT * i]), o);
    }
  }
  gm::ln_row<T, PER>(v, n, gamma, beta, eps, red);
#pragma unroll
  for (int i = 0; i < PER; ++i)
    if (i < n) out[base + gm::RT * i] = vt::from_f<T>(v[i]);
}

struct Bufs {
  int8_t* aq;  // (rows, H) codes of LN(x) or x
  float* as;   // (rows,) their scales
  void* h;     // (rows, I) T
  int8_t* hq;  // (rows, I) codes of h
  float* hs;   // (rows,) their scales
  int* ws;     // (slices, rows, H) s32 partial sums of the second product
};

// The second product's tile width and split count (1 pre-LN).
sm90::Tiling down_tiling(int rows, int H, int I, bool postln) {
  return sm90::pick_tiling(rows, H, I, DOWN_NARROW, DOWN_WIDE, postln ? POST_MAX_SPLITS : 1,
                           sm90::ROW_BYTES);
}

// Slices of the workspace w8a8_out adds (post-LN alone).
int slices(int rows, int H, int I, bool postln) {
  return postln ? down_tiling(rows, H, I, true).splits : 0;
}

// The second product hq W2 at the tile width bn, K = I in `splits` splits.
template <class Epi>
cudaError_t down(int bn, const int8_t* hq, const int8_t* w2t, int rows, int H, int I,
                 const Epi& epi, int splits, cudaStream_t st) {
  return bn == DOWN_WIDE
             ? sm90::gemm<DOWN_WIDE, false, sm90::COOP, ROWS_FIRST>(hq, w2t, rows, H, I, epi, st,
                                                                   nullptr, nullptr, splits)
             : sm90::gemm<DOWN_NARROW, false, sm90::COOP, ROWS_FIRST>(
                   hq, w2t, rows, H, I, epi, st, nullptr, nullptr, splits);
}

// w1t (I, H) and w2t (H, I): the weights' K-major codes.
template <typename T, bool POSTLN>
int mlp_w8a8(const void* x, const void* gamma, const void* beta, const void* w1t,
             const void* s1, const void* b1, const void* w2t, const void* s2, const void* b2,
             const Bufs& bf, void* out, int rows, int H, int I, float eps, int act,
             cudaStream_t st) {
  const T* xt = static_cast<const T*>(x);
  const T* g = static_cast<const T*>(gamma);
  const T* bt = static_cast<const T*>(beta);
  T* h = static_cast<T*>(bf.h);
  const int8_t* w2 = static_cast<const int8_t*>(w2t);
  const float* s2f = static_cast<const float*>(s2);
  const T* b2t = static_cast<const T*>(b2);
  cudaError_t e = gm::with_row(H, [&](auto P, auto EXACT) {
    gm::row_prologue<T, decltype(P)::value, !POSTLN, true, decltype(EXACT)::value>
        <<<rows, gm::RT, 0, st>>>(xt, g, bt, nullptr, bf.aq, bf.as, H, eps);
  });
  if (e != cudaSuccess) return (int)e;
  e = with_act_code(act, [&](auto A) {
    const EpiAct8<T, decltype(A)::value> epi{bf.as, static_cast<const float*>(s1),
                                             static_cast<const T*>(b1), h, I};
    return sm90::gemm<UP_BN, false, sm90::COOP, ROWS_FIRST>(
        bf.aq, static_cast<const int8_t*>(w1t), rows, I, H, epi, st);
  });
  if (e != cudaSuccess) return (int)e;
  const int rq_threads = gm::RT * ((I + 8 * RQ_RUNS * gm::RT - 1) / (8 * RQ_RUNS * gm::RT));
  h_requant_rows<T><<<rows, rq_threads, 0, st>>>(h, I, bf.hq, bf.hs);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  const sm90::Tiling tl = down_tiling(rows, H, I, POSTLN);
  if constexpr (!POSTLN) {
    const EpiResidual8<T> epi{bf.hs, s2f, b2t, xt, static_cast<T*>(out), H};
    return (int)down(tl.bn, bf.hq, w2, rows, H, I, epi, 1, st);
  } else {
    if ((e = down(tl.bn, bf.hq, w2, rows, H, I, sm90::StoreS32{bf.ws, H}, tl.splits, st)) !=
        cudaSuccess)
      return (int)e;
    return (int)gm::with_per(H, [&](auto P) {
      w8a8_out<T, decltype(P)::value><<<rows, gm::RT, 0, st>>>(
          xt, bf.ws, tl.splits, rows, bf.hs, s2f, b2t, g, bt, static_cast<T*>(out), H, eps);
    });
  }
}

bool bad_shape(int rows, int H, int I) {
  return rows <= 0 || H <= 0 || H % sm90::ROW_BYTES || H > gm::ROW_H_MAX || I <= 0 ||
         I % sm90::ROW_BYTES || I > I_MAX;
}

}  // namespace

// The (rows, H) s32 slices of the workspace `ws` for these shapes: 0
// pre-LN, whose second product's epilogue finishes the block; -1 for a
// refused shape.
extern "C" int vt_mlp_w8a8_slices(int rows, int H, int I, int postln) {
  if (bad_shape(rows, H, I)) return -1;
  return slices(rows, H, I, postln != 0);
}

// w1t (I, H) and w2t (H, I) int8: W1 and W2 K-major.  Scratch: aq (rows, H)
// int8, as (rows,) fp32, h (rows, I) in x's type, hq (rows, I) int8, hs
// (rows,) fp32, ws (vt_mlp_w8a8_slices, rows, H) int32.  Every pointer
// 16-byte aligned.
extern "C" int vt_mlp_w8a8(const void* x, const void* gamma, const void* beta, const void* w1t,
                           const void* s1, const void* b1, const void* w2t, const void* s2,
                           const void* b2, void* aq, void* as, void* h, void* hq, void* hs,
                           void* ws, void* out, int rows, int H, int I, float eps, int act,
                           int postln, int dtype, void* stream) {
  if (bad_shape(rows, H, I)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Bufs bf{static_cast<int8_t*>(aq), static_cast<float*>(as), h, static_cast<int8_t*>(hq),
                static_cast<float*>(hs), static_cast<int*>(ws)};
#define VT_MLP_W8A8(T, P) \
  mlp_w8a8<T, P>(x, gamma, beta, w1t, s1, b1, w2t, s2, b2, bf, out, rows, H, I, eps, act, st)
  if (dtype == vt::kBF16)
    return postln ? VT_MLP_W8A8(__nv_bfloat16, true) : VT_MLP_W8A8(__nv_bfloat16, false);
  if (dtype == vt::kF32) return postln ? VT_MLP_W8A8(float, true) : VT_MLP_W8A8(float, false);
#undef VT_MLP_W8A8
  return (int)cudaErrorInvalidValue;
}
