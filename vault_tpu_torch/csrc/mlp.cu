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
//
// The w8 blocks (vt_mlp_fwd_q8) are the same two kernels with int8 weights
// and per-out-channel fp32 scales s1 (I), s2 (H), dequantized tile by tile
// in shared memory (mlp_common.cuh): w = T(float(q) * s), rounded to x's
// type before the product, so the tensor cores see the weights that the
// plain composition's linear sees.  They replace fused_mlp_block_fwd_q8
// (_mlp_kernel_q8) and fused_mlp_postln_fwd_q8 (_mlp_postln_kernel_q8) of
// vault_tpu/ops/pallas_mlp.py.  Same operations as the fp blocks against
// half the weight bytes (2 H I), so the byte bound halves and the pre-LN
// block at 2,048 rows stays bound by the tensor cores; no dropout mask (the
// JAX package has no masked q8 kernel either).
//
// The bf16 pre-LN block with bf16 weights (the ViLT layers, 12 per forward
// and 24 per training step) takes another design, vt_mlp_fwd_wgmma on the
// wgmma core of gemm_sm90.cuh (ops/cuda_mlp.py mlp_route picks the entry;
// vt_mlp_fwd takes the fp32 blocks and the bf16 post-LN block), in three
// launches:
//   1. ln_rows_bf16 (mlp_common.cuh): y = bf16(LN(x)) into the workspace;
//   2. a = bf16(act(y W1 + b1)), (rows, I), into the workspace: 128 x 128
//      tiles, W1 read N-contiguous (wgmma's transpose bit); the narrow tile
//      because the epilogue, GELU with erff on every element, costs as much
//      as the product over K = 768, and 64 values a thread leave it the
//      registers to interleave them;
//   3. out = bf16(bf16(m (a W2 + b2)) + x), W2 read N-contiguous; the
//      epilogue is mlp_epilogue's arithmetic.
// The intermediate a goes through L2 / device memory, where the TPU kernel
// and mlp_main keep it on chip.  Keeping it on chip ties a row tile to a
// 768-wide fp32 accumulator in registers for the second product, which
// forces the 32-row wmma tile and makes every block re-stream the whole
// 9.4 MB of weights from L2 (2.4 GB of L2 -> shared memory traffic per
// launch at 8,192 rows).  Writing it costs 2 rows I 2 bytes each way (50 MB
// at 8,192 rows, 0.030 ms at 3.35 TB/s, and mostly L2-resident at 2,048
// rows) against an operations bound of 0.078 ms, and frees both products
// to run on 128-row wgmma tiles.  Bound on the H100: the operations (4 rows
// H I at 989 TFLOP/s) at 2,048 rows and more.  Tile widths: the first
// product always takes 128 x 128 tiles (above; 16 x 24 = 384 tiles at 2,048
// rows, under three waves on 132 SMs).  The second takes 128 x 128 or
// 128 x 192, whichever sm90::pick_width finds needs the least time in waves
// x width: at 2,048 rows 128 (16 x 6 = 96 tiles, one wave on 73% of the SMs;
// a 64-wide tile gives no more waves, and split-K would need float atomics
// or a second pass), at 8,192 rows 192 (256 tiles in two waves, against
// three of 128), which reads fewer bytes from L2 per operation.
#include "mlp_common.cuh"
#include "gemm_sm90.cuh"

namespace {

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

// Epilogue of the first product: a = bf16(act(acc + b1)).
struct EpiAct {
  const __nv_bfloat16* b1;
  __nv_bfloat16* a;
  int n, act;
  __device__ __forceinline__ void operator()(int r, int c, float v0, float v1, bool in) const {
    const __nv_bfloat162 b = __ldg(reinterpret_cast<const __nv_bfloat162*>(b1 + c));
    const __nv_bfloat162 o(vt::from_f<__nv_bfloat16>(vt::activate(v0 + vt::to_f(b.x), act)),
                           vt::from_f<__nv_bfloat16>(vt::activate(v1 + vt::to_f(b.y), act)));
    if (in) *reinterpret_cast<__nv_bfloat162*>(a + (size_t)r * n + c) = o;
  }
};

// Epilogue of the second product: mlp_epilogue's pre-LN arithmetic, o = acc
// + b2, times m in fp32, out = bf16(bf16(o) + x).
struct EpiResidual {
  const __nv_bfloat16 *b2, *m, *x;
  __nv_bfloat16* out;
  int n;
  __device__ __forceinline__ void operator()(int r, int c, float v0, float v1, bool in) const {
    const size_t o = (size_t)r * n + c;
    const __nv_bfloat162 b = __ldg(reinterpret_cast<const __nv_bfloat162*>(b2 + c));
    const __nv_bfloat162 xv = __ldg(reinterpret_cast<const __nv_bfloat162*>(x + o));
    float o0 = v0 + vt::to_f(b.x), o1 = v1 + vt::to_f(b.y);
    if (m) {
      const __nv_bfloat162 mv = __ldg(reinterpret_cast<const __nv_bfloat162*>(m + o));
      o0 *= vt::to_f(mv.x);
      o1 *= vt::to_f(mv.y);
    }
    const __nv_bfloat162 res(
        vt::from_f<__nv_bfloat16>(vt::to_f(vt::from_f<__nv_bfloat16>(o0)) + vt::to_f(xv.x)),
        vt::from_f<__nv_bfloat16>(vt::to_f(vt::from_f<__nv_bfloat16>(o1)) + vt::to_f(xv.y)));
    if (in) *reinterpret_cast<__nv_bfloat162*>(out + o) = res;
  }
};

// Workspace of the wgmma route: y (rows, H) then a (rows, I), bf16.
size_t wgmma_workspace_floats(int rows, int H, int I) {
  return ((size_t)rows * H + (size_t)rows * I + 1) / 2;
}

int launch_wgmma(const void* x, const void* gamma, const void* beta, const void* w1,
                 const void* b1, const void* w2, const void* b2, const void* m, void* out,
                 float* ws, int rows, int H, int I, float eps, int act, cudaStream_t st) {
  using bf = __nv_bfloat16;
  if (H != 768) return (int)cudaErrorInvalidValue;
  bf* y = reinterpret_cast<bf*>(ws);
  bf* a = y + (size_t)rows * H;
  ln_rows_bf16<768><<<(rows + LN_WARPS - 1) / LN_WARPS, LN_WARPS * 32, 0, st>>>(
      static_cast<const bf*>(x), static_cast<const bf*>(gamma), static_cast<const bf*>(beta), y,
      nullptr, nullptr, nullptr, rows, eps);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const EpiAct act_epi{static_cast<const bf*>(b1), a, I, act};
  const bf* w1p = static_cast<const bf*>(w1);
  e = sm90::gemm<128, true>(y, w1p, rows, I, H, act_epi, st);
  if (e != cudaSuccess) return (int)e;
  const EpiResidual res_epi{static_cast<const bf*>(b2), static_cast<const bf*>(m),
                            static_cast<const bf*>(x), static_cast<bf*>(out), H};
  const bf* w2p = static_cast<const bf*>(w2);
  return (int)(sm90::pick_width(rows, H, 128, 192) == 192
                   ? sm90::gemm<192, true>(a, w2p, rows, H, I, res_epi, st)
                   : sm90::gemm<128, true>(a, w2p, rows, H, I, res_epi, st));
}

// W: the weights' type, T or int8_t (then s1, s2 are their scales).
template <typename T, int NF, bool POSTLN, typename W = T>
int launch(const void* x, const void* gamma, const void* beta, const void* w1,
           const void* b1, const void* w2, const void* b2, const void* m, void* out,
           float* ws, int rows, int I, float eps, int act, cudaStream_t stream,
           const float* s1 = nullptr, const float* s2 = nullptr) {
  constexpr int H = NF * 16 * NW;
  const int splits = pick_splits(rows, I);
  const int tiles = (rows + BM - 1) / BM;
  const size_t smem = main_smem<T, H, W>();
  {
    const cudaError_t e = allow_smem<mlp_main<T, NF, POSTLN, W>>(smem);
    if (e != cudaSuccess) return (int)e;
  }
  mlp_main<T, NF, POSTLN, W><<<dim3(tiles, splits), NT, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(gamma), static_cast<const T*>(beta),
      static_cast<const W*>(w1), static_cast<const T*>(b1), static_cast<const W*>(w2), ws,
      nullptr, rows, tiles * BM, I, I / splits, eps, act, s1, s2);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  mlp_epilogue<T, NF, POSTLN><<<rows, EPI, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(gamma), static_cast<const T*>(beta),
      static_cast<const T*>(b2), static_cast<const T*>(m), ws, static_cast<T*>(out),
      tiles * BM, splits, eps);
  return (int)cudaGetLastError();
}

template <typename T, bool POSTLN, typename W = T>
int dispatch_h(int H, const void* x, const void* gamma, const void* beta,
               const void* w1, const void* b1, const void* w2, const void* b2,
               const void* m, void* out, float* ws, int rows, int I, float eps, int act,
               cudaStream_t st, const float* s1 = nullptr, const float* s2 = nullptr) {
  if (H == 768)
    return launch<T, 6, POSTLN, W>(x, gamma, beta, w1, b1, w2, b2, m, out, ws, rows, I, eps,
                                   act, st, s1, s2);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// fp32 elements of workspace vt_mlp_fwd and vt_mlp_fwd_q8 need for these
// shapes (the fp32 partial sums of the I splits).
extern "C" long long vt_mlp_workspace(int rows, int H, int I) {
  if (rows <= 0 || I <= 0 || I % BN1 != 0) return -1;
  return (long long)pick_splits(rows, I) * ((rows + BM - 1) / BM) * BM * H;
}

// The walk: the fp32 blocks and the bf16 post-LN block.
extern "C" int vt_mlp_fwd(const void* x, const void* gamma, const void* beta,
                          const void* w1, const void* b1, const void* w2,
                          const void* b2, const void* m, void* out, void* ws,
                          int rows, int H, int I, float eps, int act, int postln,
                          int dtype, void* stream) {
  if (rows <= 0 || I <= 0 || I % BN1 != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* wsf = static_cast<float*>(ws);
  if (dtype == vt::kBF16 && postln)
    return dispatch_h<__nv_bfloat16, true>(H, x, gamma, beta, w1, b1, w2, b2, m, out, wsf, rows,
                                           I, eps, act, st);
  if (dtype == vt::kF32) {
    return postln
        ? dispatch_h<float, true>(H, x, gamma, beta, w1, b1, w2, b2, m, out, wsf, rows, I, eps, act, st)
        : dispatch_h<float, false>(H, x, gamma, beta, w1, b1, w2, b2, m, out, wsf, rows, I, eps, act, st);
  }
  return (int)cudaErrorInvalidValue;
}

// fp32 elements of workspace vt_mlp_fwd_wgmma needs for these shapes.
extern "C" long long vt_mlp_wgmma_workspace(int rows, int H, int I) {
  if (rows <= 0 || I <= 0 || I % BN1 != 0) return -1;
  return (long long)wgmma_workspace_floats(rows, H, I);
}

// The bf16 pre-LN block on the wgmma core: every operand bf16.
extern "C" int vt_mlp_fwd_wgmma(const void* x, const void* gamma, const void* beta,
                                const void* w1, const void* b1, const void* w2,
                                const void* b2, const void* m, void* out, void* ws, int rows,
                                int H, int I, float eps, int act, void* stream) {
  if (rows <= 0 || I <= 0 || I % BN1 != 0) return (int)cudaErrorInvalidValue;
  return launch_wgmma(x, gamma, beta, w1, b1, w2, b2, m, out, static_cast<float*>(ws), rows, H,
                      I, eps, act, static_cast<cudaStream_t>(stream));
}

// The w8 blocks: w1q (H, I) and w2q (I, H) int8, s1 (I) and s2 (H) fp32; x,
// gamma, beta, b1, b2 and out in one type; no mask.  Workspace as vt_mlp_fwd.
extern "C" int vt_mlp_fwd_q8(const void* x, const void* gamma, const void* beta,
                             const void* w1q, const void* s1, const void* b1,
                             const void* w2q, const void* s2, const void* b2, void* out,
                             void* ws, int rows, int H, int I, float eps, int act,
                             int postln, int dtype, void* stream) {
  if (rows <= 0 || I <= 0 || I % BN1 != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* wsf = static_cast<float*>(ws);
  const float* s1f = static_cast<const float*>(s1);
  const float* s2f = static_cast<const float*>(s2);
#define VT_MLP_Q8(T, P)                                                                  \
  dispatch_h<T, P, int8_t>(H, x, gamma, beta, w1q, b1, w2q, b2, nullptr, out, wsf, rows, \
                           I, eps, act, st, s1f, s2f)
  if (dtype == vt::kBF16)
    return postln ? VT_MLP_Q8(__nv_bfloat16, true) : VT_MLP_Q8(__nv_bfloat16, false);
  if (dtype == vt::kF32) return postln ? VT_MLP_Q8(float, true) : VT_MLP_Q8(float, false);
#undef VT_MLP_Q8
  return (int)cudaErrorInvalidValue;
}
