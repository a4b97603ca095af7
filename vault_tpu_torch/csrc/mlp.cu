// Fused MLP blocks for Hopper: the MLP half of a transformer layer.
//
//   pre-LN  (ViLT):  out = x + m * (act(LN(x) W1 + b1) W2 + b2)
//   post-LN (BERT):  out = LN(x + m * (act(x W1 + b1) W2 + b2))
//
// Replaces fused_mlp_block_fwd (_mlp_kernel) and fused_mlp_postln_fwd
// (_mlp_postln_kernel) of vault_tpu/ops/pallas_mlp.py.  Numerics follow
// them: fp32 LN statistics, fp32 accumulation of both products, the bias
// added in fp32, the activation cast to x's type before the second
// product, the optional pre-scaled dropout mask m applied in fp32, in the
// pre-LN block the residual added after the cast to x's type, in the
// post-LN block the residual added in fp32 with no cast before the LN.
// GELU is exact (erff); the TPU kernel used the A&S approximation only
// because Mosaic lowers no erf.
//
// Two designs; ops/cuda_mlp.py mlp_route picks the entry, the C side does
// not restate the rule.
//
// 1. The wgmma core (gemm_sm90.cuh), vt_mlp_fwd_wgmma: every bf16 block with
//    bf16 weights (the ViLT and the BERT layers: 24 per forward, 48 per
//    training step).  H a multiple of 64 up to 8,192, I a multiple of 64
//    (the core walks K 64 at a time; TMA wants 16-byte rows).  The (rows, I)
//    activation goes through L2 / device memory between the products: keeping
//    it on chip ties a row tile to an H-wide fp32 accumulator, which forced
//    the old walk's 32-row wmma tile and made every block re-stream the whole
//    9.4 MB of weights from L2; written, it costs 2 rows I 2 bytes each way
//    (50 MB at 8,192 rows, 0.030 ms at 3.35 TB/s; L2-resident at 320 and
//    1,280 rows) and frees both products to run on 128-row wgmma tiles.
//    Pre-LN, three launches:
//      a. ln_rows_bf16 (mlp_common.cuh): y = bf16(LN(x)) into the workspace;
//      b. a = bf16(act(y W1 + b1)) into the workspace, 128 x 128 tiles, W1
//         read N-contiguous (wgmma's transpose bit): the narrow tile because
//         the epilogue (erff on every element) costs as much as the product
//         over K = 768, and 64 values a thread leave it the registers to
//         interleave them;
//      c. out = bf16(bf16(m (a W2 + b2)) + x), W2 N-contiguous, 128 x 128 or
//         128 x 192 tiles, whichever sm90::pick_tiling finds takes the least
//         time in waves (at 2,048 rows 128: 96 tiles, one wave; at 8,192
//         rows 192: 256 tiles in two waves against three).
//    Post-LN, three launches (one ctypes call):
//      a. a = bf16(act(x W1 + b1)) into the workspace, as pre-LN b (128 x
//         128: at 320 rows 72 tiles in one wave; 64- and 192-wide tiles
//         measured slower there, PERF.md);
//      b. a W2, split along K (sm90 split-K) into S fp32 slices of the
//         workspace: at 320 rows a W2 has only 3 x 6 tiles of 128 x 128 for
//         132 SMs, so S splits of K = I fill the card (pick_tiling: S = 7 at
//         320 rows, 2 at 1,280, both the fastest of those measured), at one
//         more pass over S rows H 4 bytes of L2-resident partial sums, which
//         the LN needs a row pass for anyway;
//      c. mlp_epilogue: the S slices added in order, b2, the mask and the
//         residual in fp32, LN with fp32 statistics, one cast.
//    The activation of every first product is a template argument of its
//    epilogue (EpiAct, mlp_common.cuh), picked once per launch: a run-time
//    switch there cost a quarter of the product's time.
//    What bounds it: 4 rows H I operations at 989 TFLOP/s against the
//    weights' 4 H I bytes at 3.35 TB/s: the bytes below about 300 rows (the
//    BERT blocks of a batch-8 forward, 320 rows, sit at the line), the
//    operations above (1,280 rows, 2,048 and 8,192).  At 320 rows the
//    weights are read from L2 once per 128-row tile row: 3 times.
//
//    The w8 blocks with bf16 activations (vt_mlp_fwd_q8_wgmma: the ViLT
//    layers of a w8 model, pre-LN, and its BERT layers, post-LN): one pass
//    turns both int8 weight matrices into bf16(float(q) * s) in the
//    workspace (sm90::dequant, the plain version's cast points: the scale
//    is not moved into the epilogue, which would round elsewhere), then the
//    block's launches above run on them (post-LN: split-K slices and the row
//    pass included).  The weights stay int8 at rest; the bf16 copy lives for
//    one call (2 H I bytes, 9.4 MB at ViLT-B/32's and BERT-base's widths,
//    L2-resident).  It replaces fused_mlp_block_fwd_q8 (_mlp_kernel_q8) and
//    fused_mlp_postln_fwd_q8 (_mlp_postln_kernel_q8) of
//    vault_tpu/ops/pallas_mlp.py at the core's widths; no dropout mask (the
//    JAX package has no masked q8 kernel either).  A dequantizing stage
//    inside the core (each 128-row tile converting its own int8 weight
//    tiles in shared memory) measured slower at the ViLT rows (PERF.md): it
//    converts each weight once per 128 rows, 16 times at 2,048, and the
//    conversion's shared-memory traffic competes with the products' operand
//    reads; the pass converts once, at 2 H I (1 + 2) bytes.
//
// 2. The fp32 tiles (gemm_tiles.cuh), vt_mlp_fwd (the fp32 blocks) and
//    vt_mlp_fwd_q8 (the int8 weight blocks with fp32 activations): H a
//    multiple of 128 from 128 to 8,192, I a multiple of 128, the bf16
//    core's three-launch shape on fp32 FMA tiles (the fp32 route is on no
//    serving path; it is held to 1e-4 of its plain version):
//      a. pre-LN: gm::row_prologue (gemm_common.cuh, LN statistics in
//         double) writes y = LN(x) in fp32 into the workspace;
//      b. a = act(y W1 + b1) (post-LN: act(x W1 + b1)) into the workspace,
//         ft::gemm with the activation in its epilogue (ft::EpiAct);
//      c. a W2 split along K into S fp32 slices (ft::pick_splits: 2 at
//         2,048 rows, 8 at 320), which mlp_epilogue adds in order before b2,
//         the mask and the residual (and, post-LN, the LayerNorm).
//    The walk this replaces held an H-wide fp32 accumulator in registers
//    across each 32-row tile and took H 768 alone.
//    The fp32 w8 blocks (vt_mlp_fwd_q8) take int8 weights and
//    per-out-channel fp32 scales s1 (I), s2 (H): one pass dequantizes both
//    matrices to fp32 scratch (ft::launch_dequant, w = float(q) * s, as the
//    plain composition's linear does), then the launches above.  They
//    replace the fp32 fused_mlp_block_fwd_q8 and fused_mlp_postln_fwd_q8 of
//    vault_tpu/ops/pallas_mlp.py; no dropout mask.
#include "gemm_common.cuh"
#include "gemm_sm90.cuh"
#include "gemm_tiles.cuh"

namespace {

// One block per row, row_shape(H) threads (mlp_common.cuh): sum the S fp32
// partial slices (slice s at ws + s rows_pad H) in order, then b2, the mask,
// the residual and (post-LN) the LayerNorm.
template <typename T, int PER, bool EXACT, bool POSTLN>
__global__ void __launch_bounds__(row_threads<PER>())
mlp_epilogue(const T* __restrict__ x, const T* __restrict__ gamma,
             const T* __restrict__ beta, const T* __restrict__ b2,
             const T* __restrict__ m, const float* __restrict__ ws,
             T* __restrict__ out, int H, int rows_pad, int splits, float eps) {
  __shared__ float red[ROW_MAX_THREADS / 32];
  const int row = blockIdx.x, tid = threadIdx.x, nt = row_stride<PER>();
  const T* xr = x + (size_t)row * H;
  T* orow = out + (size_t)row * H;
  float v[PER];
#pragma unroll
  for (int i = 0; i < PER; ++i) v[i] = 0.0f;
  for (int s = 0; s < splits; ++s) {
    const float* p = ws + ((size_t)s * rows_pad + row) * H + tid;
#pragma unroll
    for (int i = 0; i < PER; ++i)
      if (EXACT || tid + nt * i < H) v[i] += p[nt * i];
  }
  float sum = 0.0f;
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int c = tid + nt * i;
    if (!EXACT && c >= H) continue;
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
    const float mean = row_block_sum(sum, red) / H;
    float sq = 0.0f;
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const float d = v[i] - mean;
      if (EXACT || tid + nt * i < H) sq += d * d;
    }
    const float inv = 1.0f / sqrtf(row_block_sum(sq, red) / H + eps);
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int c = tid + nt * i;
      if (EXACT || c < H)
        orow[c] = vt::from_f<T>((v[i] - mean) * inv * vt::to_f(gamma[c]) + vt::to_f(beta[c]));
    }
  }
}

// mlp_epilogue over rows of H, S slices of rows_pad rows each.
template <typename T, bool POSTLN>
cudaError_t launch_epilogue(const T* x, const T* gamma, const T* beta, const T* b2, const T* m,
                            const float* ws, T* out, int rows, int H, int rows_pad, int splits,
                            float eps, cudaStream_t st) {
  const RowShape rs = row_shape(H);
  return with_rows(rs, [&](auto P, auto E) {
    mlp_epilogue<T, decltype(P)::value, decltype(E)::value, POSTLN><<<rows, rs.threads, 0, st>>>(
        x, gamma, beta, b2, m, ws, out, H, rows_pad, splits, eps);
  });
}

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

// Workspace of the wgmma route, bf16 elements then fp32: pre-LN y (rows, H)
// and a (rows, I) bf16; post-LN a (rows, I) bf16, then the S fp32 slices
// (S, rows, H) of a W2 (sm90::split_k_tiling).
size_t wgmma_workspace_floats(int rows, int H, int I, bool postln) {
  if (!postln) return ((size_t)rows * H + (size_t)rows * I + 1) / 2;
  const size_t a = ((size_t)rows * I + 1) / 2;
  return a + (size_t)sm90::split_k_tiling(rows, H, I).splits * rows * H;
}

int launch_wgmma(const void* x, const void* gamma, const void* beta, const void* w1,
                 const void* b1, const void* w2, const void* b2, const void* m, void* out,
                 float* ws, int rows, int H, int I, float eps, int act, bool postln,
                 cudaStream_t st) {
  using bf = __nv_bfloat16;
  if (!core_shape_ok(rows, H, I)) return (int)cudaErrorInvalidValue;
  const bf* xp = static_cast<const bf*>(x);
  const bf* w1p = static_cast<const bf*>(w1);
  const bf* w2p = static_cast<const bf*>(w2);
  cudaError_t e;
  if (postln) {
    bf* a = reinterpret_cast<bf*>(ws);
    float* slices = ws + ((size_t)rows * I + 1) / 2;
    if ((e = with_act(act, static_cast<const bf*>(b1), a, I, [&](auto epi) {
           return sm90::gemm<128, true>(xp, w1p, rows, I, H, epi, st);
         })) != cudaSuccess)
      return (int)e;
    const sm90::Tiling tl = sm90::split_k_tiling(rows, H, I);
    const sm90::StoreF32 sf{slices, H};
    e = tl.bn == 192 ? sm90::gemm<192, true>(a, w2p, rows, H, I, sf, st, nullptr, nullptr, tl.splits)
                     : sm90::gemm<128, true>(a, w2p, rows, H, I, sf, st, nullptr, nullptr, tl.splits);
    if (e != cudaSuccess) return (int)e;
    return (int)launch_epilogue<bf, true>(
        xp, static_cast<const bf*>(gamma), static_cast<const bf*>(beta), static_cast<const bf*>(b2),
        static_cast<const bf*>(m), slices, static_cast<bf*>(out), rows, H, rows, tl.splits, eps, st);
  }
  bf* y = reinterpret_cast<bf*>(ws);
  bf* a = y + (size_t)rows * H;
  ln_rows_bf16<<<(rows + LN_WARPS - 1) / LN_WARPS, LN_WARPS * 32, 0, st>>>(
      xp, static_cast<const bf*>(gamma), static_cast<const bf*>(beta), y, nullptr, nullptr,
      nullptr, rows, H, eps);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  if ((e = with_act(act, static_cast<const bf*>(b1), a, I, [&](auto epi) {
         return sm90::gemm<128, true>(y, w1p, rows, I, H, epi, st);
       })) != cudaSuccess)
    return (int)e;
  const EpiResidual res_epi{static_cast<const bf*>(b2), static_cast<const bf*>(m), xp,
                            static_cast<bf*>(out), H};
  return (int)(sm90::pick_tiling(rows, H, I, 128, 192, 1).bn == 192
                   ? sm90::gemm<192, true>(a, w2p, rows, H, I, res_epi, st)
                   : sm90::gemm<128, true>(a, w2p, rows, H, I, res_epi, st));
}

// The w8 blocks on the core: W1 and W2 dequantized to bf16 by one pass
// (sm90::dequant: w = bf16(float(q) * s)) into the workspace, then
// launch_wgmma's route of the block on them.  Workspace: the bf16 W1 (H, I)
// and W2 (I, H), then the route's.
size_t q8_workspace_floats(int rows, int H, int I, bool postln) {
  return (size_t)H * I + wgmma_workspace_floats(rows, H, I, postln);
}

int launch_q8_wgmma(const void* x, const void* gamma, const void* beta, const void* w1q,
                    const float* s1, const void* b1, const void* w2q, const float* s2,
                    const void* b2, void* out, float* ws, int rows, int H, int I, float eps,
                    int act, bool postln, cudaStream_t st) {
  using bf = __nv_bfloat16;
  // the pass indexes 16 codes a thread in 32 bits
  if (!core_shape_ok(rows, H, I) || (long long)H * I / 16 > (1 << 29))
    return (int)cudaErrorInvalidValue;
  bf* w1 = reinterpret_cast<bf*>(ws);
  bf* w2 = w1 + (size_t)H * I;
  const int n16 = (int)((long long)H * I / 16);
  const cudaError_t e = sm90::dequant(
      sm90::Dequant{static_cast<const int8_t*>(w1q), s1, w1, n16, I},
      sm90::Dequant{static_cast<const int8_t*>(w2q), s2, w2, n16, H}, st);
  if (e != cudaSuccess) return (int)e;
  return launch_wgmma(x, gamma, beta, w1, b1, w2, b2, nullptr, out, ws + (size_t)H * I, rows, H,
                      I, eps, act, postln, st);
}

// Workspace of the fp32 tiles (fp32 elements): with int8 weights their
// fp32 copies W1 (H, I) and W2 (I, H); pre-LN y (rows, H); a (rows, I);
// the S slices (S, rows, H) of a W2.
size_t tiles_workspace_floats(int rows, int H, int I, bool postln, bool q8) {
  return (q8 ? 2 * (size_t)H * I : 0) + (postln ? 0 : (size_t)rows * H) + (size_t)rows * I +
         (size_t)ft::pick_splits(rows, H, I) * rows * H;
}

int launch_tiles(const float* x, const float* gamma, const float* beta, const float* w1,
                 const float* b1, const float* w2, const float* b2, const float* m, float* out,
                 float* ws, int rows, int H, int I, float eps, int act, bool postln,
                 cudaStream_t st) {
  if (!tiles_shape_ok(rows, H, I)) return (int)cudaErrorInvalidValue;
  const int splits = ft::pick_splits(rows, H, I);
  float* y = ws;
  float* a = ws + (postln ? 0 : (size_t)rows * H);
  float* slices = a + (size_t)rows * I;
  cudaError_t e;
  if (!postln && (e = gm::with_row(H, [&](auto P, auto EXACT) {
                    gm::row_prologue<float, decltype(P)::value, true, false, decltype(EXACT)::value>
                        <<<rows, gm::RT, 0, st>>>(x, gamma, beta, y, nullptr, nullptr, H, eps);
                  })) != cudaSuccess)
    return (int)e;
  if ((e = ft::with_act(act, b1, a, I, [&](auto epi) {
         return ft::gemm(postln ? x : y, w1, rows, I, H, epi, st);
       })) != cudaSuccess)
    return (int)e;
  if ((e = ft::gemm(a, w2, rows, H, I, ft::StoreSlice{slices, rows, H}, st, splits)) !=
      cudaSuccess)
    return (int)e;
  return (int)(postln ? launch_epilogue<float, true>(x, gamma, beta, b2, m, slices, out, rows, H,
                                                     rows, splits, eps, st)
                      : launch_epilogue<float, false>(x, gamma, beta, b2, m, slices, out, rows, H,
                                                      rows, splits, eps, st));
}

}  // namespace

// fp32 elements of workspace vt_mlp_fwd (q8 = 0) and vt_mlp_fwd_q8 (q8 =
// 1) need for these shapes.
extern "C" long long vt_mlp_workspace(int rows, int H, int I, int postln, int q8) {
  if (!tiles_shape_ok(rows, H, I)) return -1;
  return (long long)tiles_workspace_floats(rows, H, I, postln != 0, q8 != 0);
}

// The fp32 blocks on the tiles: every operand fp32 (a bf16 block runs on
// the core, vt_mlp_fwd_wgmma).
extern "C" int vt_mlp_fwd(const void* x, const void* gamma, const void* beta,
                          const void* w1, const void* b1, const void* w2,
                          const void* b2, const void* m, void* out, void* ws,
                          int rows, int H, int I, float eps, int act, int postln,
                          int dtype, void* stream) {
  if (dtype != vt::kF32) return (int)cudaErrorInvalidValue;
  auto c = [](const void* p) { return static_cast<const float*>(p); };
  return launch_tiles(c(x), c(gamma), c(beta), c(w1), c(b1), c(w2), c(b2), c(m),
                      static_cast<float*>(out), static_cast<float*>(ws), rows, H, I, eps, act,
                      postln != 0, static_cast<cudaStream_t>(stream));
}

// fp32 elements of workspace vt_mlp_fwd_wgmma needs for these shapes.
extern "C" long long vt_mlp_wgmma_workspace(int rows, int H, int I, int postln) {
  if (!core_shape_ok(rows, H, I)) return -1;
  return (long long)wgmma_workspace_floats(rows, H, I, postln != 0);
}

// Every bf16 block with bf16 weights, pre-LN or post-LN, on the wgmma core:
// every operand bf16.
extern "C" int vt_mlp_fwd_wgmma(const void* x, const void* gamma, const void* beta,
                                const void* w1, const void* b1, const void* w2,
                                const void* b2, const void* m, void* out, void* ws, int rows,
                                int H, int I, float eps, int act, int postln, void* stream) {
  return launch_wgmma(x, gamma, beta, w1, b1, w2, b2, m, out, static_cast<float*>(ws), rows, H,
                      I, eps, act, postln != 0, static_cast<cudaStream_t>(stream));
}

// fp32 elements of workspace vt_mlp_fwd_q8_wgmma needs for these shapes.
extern "C" long long vt_mlp_q8_wgmma_workspace(int rows, int H, int I, int postln) {
  if (!core_shape_ok(rows, H, I)) return -1;
  return (long long)q8_workspace_floats(rows, H, I, postln != 0);
}

// The w8 blocks with bf16 activations on the core, pre-LN or post-LN: w1q
// (H, I) and w2q (I, H) int8, s1 (I) and s2 (H) fp32, every other operand
// bf16; no mask.
extern "C" int vt_mlp_fwd_q8_wgmma(const void* x, const void* gamma, const void* beta,
                                   const void* w1q, const void* s1, const void* b1,
                                   const void* w2q, const void* s2, const void* b2, void* out,
                                   void* ws, int rows, int H, int I, float eps, int act,
                                   int postln, void* stream) {
  return launch_q8_wgmma(x, gamma, beta, w1q, static_cast<const float*>(s1), b1, w2q,
                         static_cast<const float*>(s2), b2, out, static_cast<float*>(ws), rows,
                         H, I, eps, act, postln != 0, static_cast<cudaStream_t>(stream));
}

// The w8 blocks with fp32 activations on the tiles (ops/cuda_mlp.py
// mlp_route): w1q (H, I) and w2q (I, H) int8, s1 (I) and s2 (H) fp32; x,
// gamma, beta, b1, b2 and out fp32; no mask.  The weights are dequantized
// to fp32 into the front of the workspace, then the fp32 block runs on
// them.  A bf16 block is refused: it runs on the core (vt_mlp_fwd_q8_wgmma).
extern "C" int vt_mlp_fwd_q8(const void* x, const void* gamma, const void* beta,
                             const void* w1q, const void* s1, const void* b1,
                             const void* w2q, const void* s2, const void* b2, void* out,
                             void* ws, int rows, int H, int I, float eps, int act,
                             int postln, int dtype, void* stream) {
  if (dtype != vt::kF32 || !tiles_shape_ok(rows, H, I)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto c = [](const void* p) { return static_cast<const float*>(p); };
  float* w1 = static_cast<float*>(ws);
  float* w2 = w1 + (size_t)H * I;
  cudaError_t e;
  if ((e = ft::launch_dequant(static_cast<const int8_t*>(w1q), c(s1), w1, H, I, st)) !=
          cudaSuccess ||
      (e = ft::launch_dequant(static_cast<const int8_t*>(w2q), c(s2), w2, I, H, st)) !=
          cudaSuccess)
    return (int)e;
  return launch_tiles(c(x), c(gamma), c(beta), w1, c(b1), w2, c(b2), nullptr,
                      static_cast<float*>(out), w2 + (size_t)I * H, rows, H, I, eps, act,
                      postln != 0, st);
}
