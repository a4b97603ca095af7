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
#include "mlp_common.cuh"

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
