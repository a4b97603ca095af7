// Fused w8a8 RMSNorm -> SwiGLU -> residual block for Hopper, the MLP half
// of a Llama layer with int8 weights and activations:
//
//   y  = T(w * (x * rstd(x)))                         RMSNorm, rounded to T
//   (yq, ys) = q(y)                                   per-row int8 codes, scale
//   per I-tile t (pick_tile(I, 1024) columns):
//     g = int32(yq Wg[:, t]) * (ys * sg[t]);  u = int32(yq Wu[:, t]) * (ys * su[t])
//     a = T(silu(g) * u);  (aq, as[t]) = q(a)         per-(row, tile) codes, scale
//     acc += float(int32(aq Wd[t, :])) * as[t]        fp32, tiles in order
//   out = T(acc * sd) + x
//
// Replaces fused_swiglu_block_fwd_w8a8 (_swiglu_kernel_w8a8) of
// vault_tpu/ops/pallas_swiglu.py with its numerics: the requantization
// group is one row of one I-tile (a constant of the function: it decides
// the codes), each tile's int32 down product is scaled by that tile's row
// scale and added in fp32 in tile order 0, 1, ..., sd multiplies once at the
// end, then the cast to T, then the residual.  The RMSNorm takes its mean of
// squares in double and rounds it to fp32 (the correctly rounded value,
// which any summation order reaches), rstd = 1 / sqrt(var + eps) with a
// correctly rounded square root and division, silu(g) = g * (1 / (1 +
// exp(-g))), and every fp32 step is an _rn intrinsic so that nvcc contracts
// none into an FMA: the plain version in ops/cuda_swiglu.py takes the same
// steps in PyTorch and gives the same bits, for bf16 and fp32 x alike (only
// the row passes and the epilogues' casts depend on T).
//
// Operands: x, out (rows, H) bf16 or fp32; w (H) fp32; Wg, Wu (H, I) and Wd
// (I, H) int8 held K-major, i.e. stored as their transposes Wg^T, Wu^T (I,
// H) and Wd^T (H, I), row-major (ops/quantize.py k_major: the int8 wgmma has
// no transpose bit); sg, su (I) and sd (H) fp32.  H a multiple of 16 from 16
// to 8,192, I with an I-tile that is a multiple of 16: the widths the TPU
// kernel takes at the published Llama geometries (Llama-3-8B: H 4,096, I
// 14,336 = 14 tiles of 1,024; Llama-2-7B: 4,096 and 11,008 = 16 tiles of
// 688; TinyLlama-1.1B: 2,048 and 5,632 = 8 of 704; SmolLM-135M: 576 and
// 1,536 = 2 of 768; OpenLLaMA-3B: 3,200 and 8,640 = 9 of 960).
//
// Two instances, chosen by width.  H a multiple of 128 with a tile that is
// one too (Llama-3-8B, Llama-3.2-1B) takes the exact one: whole stages of
// the int8 core everywhere, the row pass without column guards.  Any other
// width takes the widened one: the row pass guards its columns (the RMS sum
// still in thread and block order, so repeats are bit-equal); the gate/up
// products read H in stages of 128 with zeros past H (TMA fills a box past
// the edge, 16-byte rows: H a multiple of 16); and, where the tile is not a
// multiple of 128, the down product reads each I-tile as a run of its own
// (the core's runs, EpiDownRuns: 3-d maps whose boxes stop at the tile's
// end, 16-byte runs: a tile a multiple of 16), so a 128-deep stage over a
// 688-wide tile reads zeros past it, not the next tile's columns.  The
// integer sums are exact either way, so both agree bit for bit with the
// plain version.
//
// What bounds it on an H100: 6 rows H I int8 operations (225 GOP at 640
// rows, 0.114 ms at 1,979 TOP/s) against 176 MB of weights (0.053 ms): the
// tensor cores at 640 rows, level with the bytes near 320.  The TPU kernel
// walks the I-tiles in sequence on one core with a (rows, H) fp32
// accumulator in VMEM; here four launches, counted as one call:
//   1. rms_quant_rows: one block a row, the row in registers -> yq, ys;
//   2. the gate and up products on the int8 core of gemm_sm90.cuh in its
//      DUAL_A form (one yq tile in each stage, both weights' tiles beside it,
//      two s32 accumulators in registers), the epilogue EpiSwiGLU: a =
//      T(silu(g) u) to device memory (18 MB at 640 rows in bf16: L2);
//   3. requant_tiles: one block per (row, I-tile), the tile in registers
//      (16-byte loads): its absmax, then aq and as;
//   4. the down product on the int8 core, K = I cut into segments of one
//      I-tile (the core's Segmented epilogue, EpiDown): each tile's s32 sum
//      starts from zero, is converted once (exact: |sum| <= 1024 127^2 <
//      2^24), times as[row, t], onto the fp32 sum in tile order; then sd,
//      the cast, + x.  No split of K: fp32 addition in another order changes
//      bits.
// Both products walk their tiles rows fastest: every weight is larger than
// L2 at Llama-3-8B's widths (58.7 MB each), and the blocks that run at once
// then share each weight tile, so it is read from memory once.  The tile
// widths were chosen by scripts/torch_swiglu_tiles.py on the card (PERF.md).
#include "gemm_common.cuh"
#include "gemm_sm90.cuh"

namespace {

constexpr int IT = 1024;           // the largest I-tile (pick_tile(I, IT))
constexpr int GATE_UP_BN = 128;    // tile width of the gate/up products
constexpr int DOWN_BN = 128;       // tile width of the down product
constexpr bool ROWS_FIRST = true;  // both products walk rows fastest

__device__ __forceinline__ float silu_mul_rn(float g, float u) {
  const float sig = __fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-g)));
  return __fmul_rn(__fmul_rn(g, sig), u);
}

// One row per block, H = RT n columns, n <= PER (GUARD: H any multiple of
// 16, thread t holding the columns t + RT i < H): RMSNorm rounded to T, then
// the row's int8 codes and scale.
template <typename T, int PER, bool GUARD = false>
__global__ void __launch_bounds__(gm::RT)
rms_quant_rows(const T* __restrict__ x, const float* __restrict__ w, int8_t* __restrict__ q,
               float* __restrict__ scale, int H, float eps) {
  __shared__ double redd[gm::RT / 32];
  __shared__ float redf[gm::RT / 32];
  const int n = GUARD ? (H - (int)threadIdx.x + gm::RT - 1) / gm::RT : H / gm::RT;
  const size_t base = static_cast<size_t>(blockIdx.x) * H + threadIdx.x;
  float v[PER];
  double ss = 0.0;
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    if (i < n) {
      v[i] = vt::to_f(x[base + gm::RT * i]);
      ss += static_cast<double>(v[i]) * static_cast<double>(v[i]);
    }
  }
  const float var = static_cast<float>(gm::block_sum(ss, redd) / H);
  const float rstd = __fdiv_rn(1.0f, __fsqrt_rn(__fadd_rn(var, eps)));
  float m = 0.0f;
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    if (i < n) {
      const float y = __fmul_rn(w[threadIdx.x + gm::RT * i], __fmul_rn(v[i], rstd));
      v[i] = vt::to_f(vt::from_f<T>(y));
      m = fmaxf(m, fabsf(v[i]));
    }
  }
  const float s = gm::quant_scale(gm::block_max(m, redf));
#pragma unroll
  for (int i = 0; i < PER; ++i)
    if (i < n) q[base + gm::RT * i] = gm::quant(v[i], s);
  if (threadIdx.x == 0) scale[blockIdx.x] = s;
}

// Epilogue of the gate/up products: a = T(silu(g) * u), g = float(s32) *
// (ys[row] * sg[col]), u likewise.
template <typename T>
struct EpiSwiGLU {
  const float *ys, *sg, *su;
  T* a;
  int n;  // I
  __device__ __forceinline__ void operator()(int r, int c, int g0, int g1, int u0, int u1,
                                             bool in) const {
    const float rs = __ldg(ys + r);
    const float2 sgc = __ldg(reinterpret_cast<const float2*>(sg + c));
    const float2 suc = __ldg(reinterpret_cast<const float2*>(su + c));
    const float v0 = silu_mul_rn(__fmul_rn(__int2float_rn(g0), __fmul_rn(rs, sgc.x)),
                                 __fmul_rn(__int2float_rn(u0), __fmul_rn(rs, suc.x)));
    const float v1 = silu_mul_rn(__fmul_rn(__int2float_rn(g1), __fmul_rn(rs, sgc.y)),
                                 __fmul_rn(__int2float_rn(u1), __fmul_rn(rs, suc.y)));
    if (in) gm::store_pair<T>(a + (size_t)r * n + c, v0, v1);
  }
};

// One block per (row, I-tile of ti <= IT columns, a multiple of 16: the
// 16-byte loads stay aligned), eight consecutive columns a thread: the
// tile's row maximum, then its int8 codes and scale.
template <typename T>
__global__ void __launch_bounds__(gm::RT)
requant_tiles(const T* __restrict__ a, int I, int ti, int8_t* __restrict__ q,
              float* __restrict__ scale) {
  static_assert(IT == 8 * gm::RT, "a block holds one tile, eight columns a thread");
  __shared__ float redf[gm::RT / 32];
  const size_t base = (size_t)blockIdx.x * I + (size_t)blockIdx.y * ti + 8 * threadIdx.x;
  const bool on = 8 * (int)threadIdx.x < ti;
  float v[8];
  float m = 0.0f;
  if (on) {
    load8(a + base, v);
#pragma unroll
    for (int e = 0; e < 8; ++e) m = fmaxf(m, fabsf(v[e]));
  }
  const float s = gm::quant_scale(gm::block_max(m, redf));
  if (on) *reinterpret_cast<uint2*>(q + base) = gm::quant8(v, s);
  if (threadIdx.x == 0) scale[(size_t)blockIdx.x * gridDim.y + blockIdx.y] = s;
}

// Epilogue of the down product, segmented by I-tile (sm90::Segmented):
// scale(row, t) = as[row, t]; then out = T(T(sum * sd[col]) + x).
template <typename T>
struct EpiDown {
  const float* as;
  int tiles, seg;  // I-tiles; k-steps of one
  const float* sd;
  const T* x;
  T* out;
  int n;  // H
  __device__ __forceinline__ float scale(int r, int t) const {
    return __ldg(as + (size_t)r * tiles + t);
  }
  __device__ __forceinline__ void operator()(int r, int c, float v0, float v1, bool in) const {
    const size_t o = (size_t)r * n + c;
    const float2 sdc = __ldg(reinterpret_cast<const float2*>(sd + c));
    const float2 xv = gm::load_pair<T>(x + o);
    const float o0 = vt::to_f(vt::from_f<T>(__fmul_rn(v0, sdc.x)));
    const float o1 = vt::to_f(vt::from_f<T>(__fmul_rn(v1, sdc.y)));
    if (in) gm::store_pair<T>(out + o, __fadd_rn(xv.x, o0), __fadd_rn(xv.y, o1));
  }
};

// The same where the tile is not a whole number of 128-column stages: the
// down product reads each tile as a run of seg_cols = ti columns, zeros past
// it (the core's runs, sm90::SegMapped).
template <typename T>
struct EpiDownRuns : EpiDown<T> {
  int seg_cols;  // ti
};

struct Bufs {
  int8_t* yq;  // (rows, H) codes of the normalised rows
  float* ys;   // (rows,) their scales
  void* a;     // (rows, I) T
  int8_t* aq;  // (rows, I) codes of a
  float* as;   // (rows, I / ti) their scales
};

// wgt, wut (I, H) and wdt (H, I): the weights' K-major codes.
template <typename T>
int swiglu(const void* x, const void* w, const void* wgt, const void* sg, const void* wut,
           const void* su, const void* wdt, const void* sd, const Bufs& bf, void* out, int rows,
           int H, int I, int ti, float eps, cudaStream_t st) {
  const T* xt = static_cast<const T*>(x);
  // the exact instance: whole stages, rows of whole 128-column slots
  const bool exact = H % gm::RT == 0 && ti % sm90::ROW_BYTES == 0;
  cudaError_t e = gm::with_per(H, [&](auto P) {
    if (exact)
      rms_quant_rows<T, decltype(P)::value><<<rows, gm::RT, 0, st>>>(
          xt, static_cast<const float*>(w), bf.yq, bf.ys, H, eps);
    else
      rms_quant_rows<T, decltype(P)::value, true><<<rows, gm::RT, 0, st>>>(
          xt, static_cast<const float*>(w), bf.yq, bf.ys, H, eps);
  });
  if (e != cudaSuccess) return (int)e;
  const EpiSwiGLU<T> gu{bf.ys, static_cast<const float*>(sg), static_cast<const float*>(su),
                        static_cast<T*>(bf.a), I};
  e = sm90::gemm<GATE_UP_BN, false, sm90::DUAL_A, ROWS_FIRST>(
      bf.yq, static_cast<const int8_t*>(wgt), rows, I, H, gu, st, nullptr,
      static_cast<const int8_t*>(wut));
  if (e != cudaSuccess) return (int)e;
  requant_tiles<T><<<dim3(rows, I / ti), gm::RT, 0, st>>>(static_cast<const T*>(bf.a), I, ti,
                                                           bf.aq, bf.as);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  const int seg = (ti + sm90::ROW_BYTES - 1) / sm90::ROW_BYTES;  // stages of a tile
  const EpiDown<T> down{bf.as, I / ti, seg, static_cast<const float*>(sd), xt,
                        static_cast<T*>(out), H};
  if (ti % sm90::ROW_BYTES != 0)
    return (int)sm90::gemm<DOWN_BN, false, sm90::COOP, ROWS_FIRST>(
        bf.aq, static_cast<const int8_t*>(wdt), rows, H, I, EpiDownRuns<T>{down, ti}, st);
  return (int)sm90::gemm<DOWN_BN, false, sm90::COOP, ROWS_FIRST>(
      bf.aq, static_cast<const int8_t*>(wdt), rows, H, I, down, st);
}

}  // namespace

// Scratch: yq (rows, H) int8, ys (rows,) fp32, a (rows, I) in x's type, aq
// (rows, I) int8, as (rows, I / ti) fp32.  H a multiple of 16 up to 8,192;
// ti: the I-tile, pick_tile(I, 1024) (ops/cuda_swiglu.py), a multiple of 16
// dividing I.  Every pointer 16-byte aligned.
extern "C" int vt_swiglu_w8a8(const void* x, const void* w, const void* wgt, const void* sg,
                              const void* wut, const void* su, const void* wdt, const void* sd,
                              void* yq, void* ys, void* a, void* aq, void* as, void* out,
                              int rows, int H, int I, int ti, float eps, int dtype,
                              void* stream) {
  if (rows <= 0 || H <= 0 || H % 16 || H > gm::ROW_H_MAX || ti <= 0 || ti % 16 || ti > IT ||
      I <= 0 || I % ti)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Bufs bf{static_cast<int8_t*>(yq), static_cast<float*>(ys), a, static_cast<int8_t*>(aq),
                static_cast<float*>(as)};
  if (dtype == vt::kBF16)
    return swiglu<__nv_bfloat16>(x, w, wgt, sg, wut, su, wdt, sd, bf, out, rows, H, I, ti, eps,
                                 st);
  if (dtype == vt::kF32)
    return swiglu<float>(x, w, wgt, sg, wut, su, wdt, sd, bf, out, rows, H, I, ti, eps, st);
  return (int)cudaErrorInvalidValue;
}
