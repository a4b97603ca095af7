// Backward kernels of the fused MLP blocks for Hopper.
//
//   pre-LN  (ViLT):  out = x + m * (gelu(LN(x) W1 + b1) W2 + b2)
//   post-LN (BERT):  out = LN(x + m * (gelu(x W1 + b1) W2 + b2))
//
// Replace fused_mlp_block_bwd (_mlp_bwd_kernel) and fused_mlp_postln_block_bwd
// (_mlp_postln_bwd_kernel) of vault_tpu/ops/pallas_mlp.py.  Given x, the
// output cotangent g and the optional pre-scaled dropout mask m (a constant:
// it enters as g m, or ds m post-LN), they recompute the forward chain and
// emit dx, dh1 and a (rows, I), y = LN(x) (pre-LN) or ds = the masked
// cotangent at the MLP output (post-LN), and dgamma, dbeta (fp32).  The
// weight gradients are plain products of those outputs, left to the caller
// as the JAX package leaves them to XLA.  Numerics follow the Pallas
// kernels: fp32 LN statistics, fp32 accumulation, h1 kept in fp32 for
// gelu'(h1) = Phi(h1) + h1 phi(h1) with exact erff (the TPU kernel used the
// A&S erf only because Mosaic has none), and casts to x's type at yc, ac,
// the masked cotangent gc, dh1c and dmlpc.  dgamma and dbeta, which the TPU
// accumulated across its sequential grid, are summed per block of 8 rows
// into partial rows and reduced over the blocks in a fixed order by a last
// small kernel: no float atomics anywhere, so two launches give the same
// bits.
//
// What bounds it on an H100: three (pre-LN) or four (post-LN: the MLP
// output must be rebuilt before the LN backward) products of rows x H x I,
// so the tensor cores at the training rows (8,192 pre-LN, 1,280 post-LN);
// the (rows, I) activations dh1 and a are the bytes it must write.
//
// Two designs; ops/cuda_mlp.py mlp_route picks the entry.
//
// 1. The wgmma core (gemm_sm90.cuh), vt_mlp_bwd_wgmma: every bf16 block with
//    bf16 weights (12 pre-LN and 12 post-LN per training step), H a multiple
//    of 64 up to 8,192, I a multiple of 64.  dh1 goes to device memory
//    between the products (it is an output anyway: 50 MB at 8,192 rows,
//    0.030 ms at 3.35 TB/s against the 0.117 ms bound of the three
//    products), which frees the tile from an H-wide fp32 dy accumulator in
//    registers.  Pre-LN, five launches:
//      a. ln_rows_bf16 (mlp_common.cuh): y = bf16(LN(x)), the y output, and,
//         with a mask, gc = bf16(g m) into the workspace (else gc is g);
//      b. a dual product per (128-row, 128-column) tile of (rows, I): one
//         warpgroup holds h1 = y W1[:, tile] (W1 N-contiguous) and da = gc
//         W2[tile, :]^T (W2 K-contiguous) in two accumulators of one fragment
//         layout; the epilogue writes a = bf16(gelu(h1 + b1)) and dh1 =
//         bf16(da gelu'(h1 + b1)) (exact erff, vt::gelu_grad);
//      c. dy = dh1 W1^T (W1 K-contiguous, K = I) in fp32 into the workspace,
//         128 x 192 tiles (128 x 128 where they fill the SMs' waves better);
//      d. mlp_bwd_preln_rows: the LN backward, dx = g + dx_ln, dgamma/dbeta
//         partial rows; e. mlp_bwd_reduce_cols.
//    Post-LN, seven launches (one ctypes call):
//      a. a = bf16(gelu(x W1 + b1)), the a output (EpiAct, 128 x 128);
//      b. a W2 split along K into S fp32 slices (sm90::split_k_tiling: S = 2
//         at 1,280 rows, 60 tiles of 128 x 128 becoming 120 work items);
//      c. mlp_bwd_postln_rows: the slices in order, b2, the mask, the
//         residual, the LN and its backward -> dsf (fp32, kept for dx), the
//         ds output bf16(ds m), dgamma/dbeta partial rows; one row a block
//         at 1,280 rows (rows_per_block: eight rows a block left 160 blocks
//         for 132 SMs and took three times as long);
//      d. the dual product of pre-LN b on x and ds: h1 = x W1 beside da =
//         ds W2^T; the epilogue writes dh1 only (a came from step a, the
//         same accumulation of the same product, so the same bits).  h1 is
//         recomputed rather than kept: keeping it in fp32 (15.7 MB each way
//         at 1,280 rows) for one product ds W2^T measured slower, since the
//         gelu' epilogue, not the recomputed product, is the cost;
//      e. dh1 W1^T split along K = I into S fp32 slices;
//      f. mlp_bwd_postln_dx: dx = bf16(dsf + the slices in order);
//      g. mlp_bwd_reduce_cols: the partial rows in a fixed order, 32 warps
//         on each 32 columns.
//
// 2. The fp32 tiles (gemm_tiles.cuh), vt_mlp_bwd: the fp32 blocks, H a
//    multiple of 128 from 128 to 8,192, I a multiple of 128; the products
//    on fp32 FMA tiles, their (rows, I) intermediates through device memory
//    as on the core.  One pass transposes W1 and W2 into the workspace (the
//    tiles read B (K, N) row-major; dh1 W1^T and gc W2^T need the
//    transposes), then, pre-LN, six launches:
//      a. gm::row_prologue: y = LN(x), the y output; with a mask gc = g m
//         (mul_rows) into the workspace, else gc is g;
//      b. h1 = y W1 with the epilogue z = h1 + b1 (into the dh1 output, which
//         the next product's epilogue overwrites) and a = gelu(z) (EpiZA);
//      c. gc W2^T with the epilogue dh1 = da gelu'(z) (EpiDh1, in place);
//      d. dh1 W1^T split along K = I into S fp32 slices (ft::pick_splits);
//      e. mlp_bwd_preln_rows (the slices in order), f. mlp_bwd_reduce_cols.
//    Post-LN: a = gelu(x W1 + b1) and z (EpiZA), a W2 in S slices,
//    mlp_bwd_postln_rows (ds, the masked ds output, the partial rows), ds W2^T
//    into dh1 (EpiDh1), dh1 W1^T in S slices, mlp_bwd_postln_dx,
//    mlp_bwd_reduce_cols.  z is kept (in dh1) rather than recomputed: fp32
//    tiles have no spare rate for a fourth product.  The walk this replaces
//    held a 768-wide dy accumulator in registers across each 16-row tile and
//    took H 768 alone.
#include <algorithm>

#include "gemm_common.cuh"
#include "gemm_sm90.cuh"
#include "gemm_tiles.cuh"

namespace {

// Row kernels (mlp_common.cuh row_shape): a block takes rb consecutive
// rows, one at a time, and sums their dgamma/dbeta terms into its partial
// row part[block]; rows_per_block picks rb.
//
// Rows a block takes: enough blocks for every SM (8 a SM), at most 8 rows
// (each block writes a 2 H partial row that mlp_bwd_reduce_cols adds).
// Eight rows a block at 1,280 rows left 160 blocks for 132 SMs, and the
// post-LN rows took 0.046 ms; one row a block, 1,280 blocks.
int rows_per_block(int rows) {
  const int rb = rows / (8 * num_sms());
  return rb < 1 ? 1 : rb > 8 ? 8 : rb;
}

int row_blocks(int rows) {
  const int rb = rows_per_block(rows);
  return (rows + rb - 1) / rb;
}

// Pre-LN: dy = the splits' partials in order; LN backward; dx = g + dx_ln;
// dgamma/dbeta partials of the block's rows -> part[block].
template <typename T, int PER, bool EXACT>
__global__ void __launch_bounds__(row_threads<PER>())
mlp_bwd_preln_rows(const T* __restrict__ x, const T* __restrict__ g,
                   const T* __restrict__ gamma, const float* __restrict__ ws,
                   int splits, int rows_pad, T* __restrict__ dx,
                   float* __restrict__ part, int rows, int rb, int H, float eps) {
  __shared__ float red[ROW_MAX_THREADS / 32];
  const int tid = threadIdx.x, nt = row_stride<PER>();
  float pg[PER], pb[PER];
#pragma unroll
  for (int i = 0; i < PER; ++i) pg[i] = pb[i] = 0.0f;
  for (int rr = 0; rr < rb; ++rr) {
    const int row = blockIdx.x * rb + rr;
    if (row >= rows) break;
    const size_t off = (size_t)row * H;
    float xv[PER], dy[PER], sum = 0.0f;
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int c = tid + nt * i;
      xv[i] = EXACT || c < H ? vt::to_f(x[off + c]) : 0.0f;
      sum += xv[i];
      dy[i] = 0.0f;
    }
    for (int s = 0; s < splits; ++s) {
      const float* p = ws + ((size_t)s * rows_pad + row) * H + tid;
#pragma unroll
      for (int i = 0; i < PER; ++i)
        if (EXACT || tid + nt * i < H) dy[i] += p[nt * i];
    }
    const float mean = row_block_sum(sum, red) / H;
    float sq = 0.0f;
#pragma unroll
    for (int i = 0; i < PER; ++i)
      if (EXACT || tid + nt * i < H) sq += (xv[i] - mean) * (xv[i] - mean);
    const float rstd = 1.0f / sqrtf(row_block_sum(sq, red) / H + eps);
    float s1 = 0.0f, s2 = 0.0f;
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int c = tid + nt * i;
      if (!EXACT && c >= H) continue;
      xv[i] = (xv[i] - mean) * rstd;  // xhat
      const float dxh = dy[i] * vt::to_f(gamma[c]);
      s1 += dxh;
      s2 += dxh * xv[i];
    }
    const float m1 = row_block_sum(s1, red) / H, m2 = row_block_sum(s2, red) / H;
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int c = tid + nt * i;
      if (!EXACT && c >= H) continue;
      const float dxh = dy[i] * vt::to_f(gamma[c]);
      const float dx_ln = (dxh - m1 - xv[i] * m2) * rstd;
      dx[off + c] = vt::from_f<T>(vt::to_f(g[off + c]) + dx_ln);
      pg[i] += dy[i] * xv[i];
      pb[i] += dy[i];
    }
  }
  float* dst = part + (size_t)blockIdx.x * 2 * H;
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int c = tid + nt * i;
    if (EXACT || c < H) {
      dst[c] = pg[i];
      dst[H + c] = pb[i];
    }
  }
}

// Post-LN: o = the S slices of the MLP output (fp32 partial sums, in order)
// + b2; s = x + m o; LN backward of the cotangent g -> ds (fp32, kept for
// dx) and dmlp = ds m (x's type, the `ds` output); dgamma/dbeta partials ->
// part[block].
template <typename T, int PER, bool EXACT>
__global__ void __launch_bounds__(row_threads<PER>())
mlp_bwd_postln_rows(const T* __restrict__ x, const T* __restrict__ g,
                    const T* __restrict__ gamma, const T* __restrict__ b2,
                    const T* __restrict__ m, const float* __restrict__ ws,
                    int splits, int rows_pad, T* __restrict__ ds_out,
                    float* __restrict__ dsf, float* __restrict__ part, int rows, int rb,
                    int H, float eps) {
  __shared__ float red[ROW_MAX_THREADS / 32];
  const int tid = threadIdx.x, nt = row_stride<PER>();
  float pg[PER], pb[PER];
#pragma unroll
  for (int i = 0; i < PER; ++i) pg[i] = pb[i] = 0.0f;
  for (int rr = 0; rr < rb; ++rr) {
    const int row = blockIdx.x * rb + rr;
    if (row >= rows) break;
    const size_t off = (size_t)row * H;
    float sv[PER], sum = 0.0f;
#pragma unroll
    for (int i = 0; i < PER; ++i) sv[i] = 0.0f;
    for (int s = 0; s < splits; ++s) {
      const float* p = ws + ((size_t)s * rows_pad + row) * H + tid;
#pragma unroll
      for (int i = 0; i < PER; ++i)
        if (EXACT || tid + nt * i < H) sv[i] += p[nt * i];
    }
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int c = tid + nt * i;
      if (!EXACT && c >= H) continue;
      float o = sv[i] + vt::to_f(b2[c]);
      if (m) o *= vt::to_f(m[off + c]);
      sv[i] = vt::to_f(x[off + c]) + o;
      sum += sv[i];
    }
    const float mean = row_block_sum(sum, red) / H;
    float sq = 0.0f;
#pragma unroll
    for (int i = 0; i < PER; ++i)
      if (EXACT || tid + nt * i < H) sq += (sv[i] - mean) * (sv[i] - mean);
    const float rstd = 1.0f / sqrtf(row_block_sum(sq, red) / H + eps);
    float s1 = 0.0f, s2 = 0.0f;
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int c = tid + nt * i;
      if (!EXACT && c >= H) continue;
      sv[i] = (sv[i] - mean) * rstd;  // shat
      const float dsh = vt::to_f(g[off + c]) * vt::to_f(gamma[c]);
      s1 += dsh;
      s2 += dsh * sv[i];
    }
    const float m1 = row_block_sum(s1, red) / H, m2 = row_block_sum(s2, red) / H;
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int c = tid + nt * i;
      if (!EXACT && c >= H) continue;
      const float gv = vt::to_f(g[off + c]);
      const float ds = (gv * vt::to_f(gamma[c]) - m1 - sv[i] * m2) * rstd;
      dsf[off + c] = ds;
      ds_out[off + c] = vt::from_f<T>(m ? ds * vt::to_f(m[off + c]) : ds);
      pg[i] += gv * sv[i];
      pb[i] += gv;
    }
  }
  float* dst = part + (size_t)blockIdx.x * 2 * H;
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int c = tid + nt * i;
    if (EXACT || c < H) {
      dst[c] = pg[i];
      dst[H + c] = pb[i];
    }
  }
}

template <typename T>
cudaError_t launch_preln_rows(const T* x, const T* g, const T* gamma, const float* ws,
                              int splits, int rows_pad, T* dx, float* part, int rows, int H,
                              float eps, cudaStream_t st) {
  const RowShape rs = row_shape(H);
  return with_rows(rs, [&](auto P, auto E) {
    mlp_bwd_preln_rows<T, decltype(P)::value, decltype(E)::value>
        <<<row_blocks(rows), rs.threads, 0, st>>>(
        x, g, gamma, ws, splits, rows_pad, dx, part, rows, rows_per_block(rows), H, eps);
  });
}

template <typename T>
cudaError_t launch_postln_rows(const T* x, const T* g, const T* gamma, const T* b2, const T* m,
                               const float* ws, int splits, int rows_pad, T* ds_out, float* dsf,
                               float* part, int rows, int H, float eps, cudaStream_t st) {
  const RowShape rs = row_shape(H);
  return with_rows(rs, [&](auto P, auto E) {
    mlp_bwd_postln_rows<T, decltype(P)::value, decltype(E)::value>
        <<<row_blocks(rows), rs.threads, 0, st>>>(
        x, g, gamma, b2, m, ws, splits, rows_pad, ds_out, dsf, part, rows, rows_per_block(rows),
        H, eps);
  });
}

// Post-LN: dx = ds + the slices of dh1 W1^T (in order), four columns a
// thread (H a multiple of 4).
template <typename T>
__global__ void mlp_bwd_postln_dx(const float* __restrict__ dsf,
                                  const float* __restrict__ ws, int splits,
                                  int rows_pad, T* __restrict__ dx, int rows, int H) {
  const size_t n4 = (size_t)rows * H / 4;
  for (size_t q = (size_t)blockIdx.x * blockDim.x + threadIdx.x; q < n4;
       q += (size_t)gridDim.x * blockDim.x) {
    const size_t idx = 4 * q, row = idx / H, col = idx % H;
    float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    for (int s = 0; s < splits; ++s) {
      const float4 p = *reinterpret_cast<const float4*>(ws + ((size_t)s * rows_pad + row) * H + col);
      v.x += p.x, v.y += p.y, v.z += p.z, v.w += p.w;
    }
    const float4 d = *reinterpret_cast<const float4*>(dsf + idx);
    dx[idx] = vt::from_f<T>(d.x + v.x);
    dx[idx + 1] = vt::from_f<T>(d.y + v.y);
    dx[idx + 2] = vt::from_f<T>(d.z + v.z);
    dx[idx + 3] = vt::from_f<T>(d.w + v.w);
  }
}

template <typename T>
cudaError_t launch_postln_dx(const float* dsf, const float* ws, int splits, int rows_pad, T* dx,
                             int rows, int H, cudaStream_t st) {
  const long n4 = (long)rows * H / 4;
  mlp_bwd_postln_dx<T><<<(int)std::min<long>((n4 + 255) / 256, 4L * num_sms()), 256, 0, st>>>(
      dsf, ws, splits, rows_pad, dx, rows, H);
  return cudaGetLastError();
}

// dgamma, dbeta: the row blocks' partial rows summed in a fixed order.  A
// block takes 32 of the 2 H columns; warp w adds partial rows w, w +
// RC_WARPS, ... in order, then the warps' sums are added in warp order.
constexpr int RC_WARPS = 32;

__global__ void __launch_bounds__(RC_WARPS * 32)
mlp_bwd_reduce_cols(const float* __restrict__ part, int nparts, int H,
                    float* __restrict__ dgamma, float* __restrict__ dbeta) {
  __shared__ float acc[RC_WARPS][32];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int c = blockIdx.x * 32 + lane;
  float s = 0.0f;
  if (c < 2 * H)
    for (int b = w; b < nparts; b += RC_WARPS) s += part[(size_t)b * 2 * H + c];
  acc[w][lane] = s;
  __syncthreads();
  if (w == 0 && c < 2 * H) {
    float t = 0.0f;
#pragma unroll
    for (int k = 0; k < RC_WARPS; ++k) t += acc[k][lane];
    if (c < H) dgamma[c] = t;
    else dbeta[c - H] = t;
  }
}

cudaError_t launch_reduce_cols(const float* part, int rows, int H, float* dgamma, float* dbeta,
                               cudaStream_t st) {
  mlp_bwd_reduce_cols<<<(2 * H + 31) / 32, RC_WARPS * 32, 0, st>>>(part, row_blocks(rows), H,
                                                                  dgamma, dbeta);
  return cudaGetLastError();
}

// Epilogues of the fp32 tiles' products.  EpiZA: z = h1 + b1 into zbuf
// (the dh1 output) and, when a is given, a = gelu(z).  EpiDh1: dh1 = da
// gelu'(z), z read from the same place (each element by the one thread that
// writes it).
struct EpiZA {
  const float* b1;
  float *z, *a;
  int n;
  __device__ __forceinline__ void operator()(int r, int c, float4 v, int) const {
    const float4 bb = __ldg(reinterpret_cast<const float4*>(b1 + c));
    const float4 zv = make_float4(v.x + bb.x, v.y + bb.y, v.z + bb.z, v.w + bb.w);
    const size_t o = (size_t)r * n + c;
    *reinterpret_cast<float4*>(z + o) = zv;
    if (a)
      *reinterpret_cast<float4*>(a + o) =
          make_float4(vt::activate(zv.x, vt::kGeluErf), vt::activate(zv.y, vt::kGeluErf),
                      vt::activate(zv.z, vt::kGeluErf), vt::activate(zv.w, vt::kGeluErf));
  }
};

struct EpiDh1 {
  float* dh1;
  int n;
  __device__ __forceinline__ void operator()(int r, int c, float4 v, int) const {
    float4* p = reinterpret_cast<float4*>(dh1 + (size_t)r * n + c);
    const float4 z = *p;
    *p = make_float4(v.x * vt::gelu_grad(z.x), v.y * vt::gelu_grad(z.y),
                     v.z * vt::gelu_grad(z.z), v.w * vt::gelu_grad(z.w));
  }
};

// gc = g m, fp32, four values a thread.
__global__ void mul_rows(const float* __restrict__ g, const float* __restrict__ m,
                         float* __restrict__ gc, long n4) {
  for (long i = (long)blockIdx.x * blockDim.x + threadIdx.x; i < n4;
       i += (long)gridDim.x * blockDim.x) {
    const float4 a = reinterpret_cast<const float4*>(g)[i];
    const float4 b = reinterpret_cast<const float4*>(m)[i];
    reinterpret_cast<float4*>(gc)[i] = make_float4(a.x * b.x, a.y * b.y, a.z * b.z, a.w * b.w);
  }
}

// Workspace of the fp32 tiles (fp32 elements): W1^T (I, H) and W2^T (H, I),
// the S fp32 slices (S, rows, H) of a W2 (post-LN) and of dh1 W1^T (the
// same (rows, H, I) shape, so the same S), dsf (rows, H) post-LN, the
// dgamma/dbeta partial rows, gc (rows, H) pre-LN.
struct TilesLayout {
  size_t wt, acc, dsf, part, gc;
  int splits;
};

TilesLayout tiles_layout(int rows, int H, int I, bool postln) {
  TilesLayout l;
  l.splits = ft::pick_splits(rows, H, I);
  l.wt = 2 * (size_t)H * I;
  l.acc = (size_t)l.splits * rows * H;
  l.dsf = postln ? (size_t)rows * H : 0;
  l.part = (size_t)row_blocks(rows) * 2 * H;
  l.gc = postln ? 0 : (size_t)rows * H;
  return l;
}

int launch_bwd_tiles(const float* x, const float* g, const float* gamma, const float* beta,
                     const float* w1, const float* b1, const float* w2, const float* b2,
                     const float* m, float* dx, float* dh1, float* a, float* yds, float* dgamma,
                     float* dbeta, float* ws, int rows, int H, int I, float eps, bool postln,
                     cudaStream_t st) {
  if (!tiles_shape_ok(rows, H, I)) return (int)cudaErrorInvalidValue;
  const TilesLayout l = tiles_layout(rows, H, I, postln);
  float* w1t = ws;
  float* w2t = w1t + (size_t)H * I;
  float* acc = ws + l.wt;
  float* dsf = acc + l.acc;
  float* part = dsf + l.dsf;
  float* gc = part + l.part;
  const ft::StoreSlice slices{acc, rows, H};
  cudaError_t e;
  if ((e = ft::launch_transpose(w1, w1t, H, I, st)) != cudaSuccess ||
      (e = ft::launch_transpose(w2, w2t, I, H, st)) != cudaSuccess)
    return (int)e;
  if (postln) {
    if ((e = ft::gemm(x, w1, rows, I, H, EpiZA{b1, dh1, a, I}, st)) != cudaSuccess ||
        (e = ft::gemm(a, w2, rows, H, I, slices, st, l.splits)) != cudaSuccess ||
        (e = launch_postln_rows<float>(x, g, gamma, b2, m, acc, l.splits, rows, yds, dsf, part,
                                       rows, H, eps, st)) != cudaSuccess ||
        (e = ft::gemm(yds, w2t, rows, I, H, EpiDh1{dh1, I}, st)) != cudaSuccess ||
        (e = ft::gemm(dh1, w1t, rows, H, I, slices, st, l.splits)) != cudaSuccess ||
        (e = launch_postln_dx<float>(dsf, acc, l.splits, rows, dx, rows, H, st)) != cudaSuccess)
      return (int)e;
  } else {
    if ((e = gm::with_row(H, [&](auto P, auto EXACT) {
           gm::row_prologue<float, decltype(P)::value, true, false, decltype(EXACT)::value>
               <<<rows, gm::RT, 0, st>>>(x, gamma, beta, yds, nullptr, nullptr, H, eps);
         })) != cudaSuccess)
      return (int)e;
    const float* gm_ = g;
    if (m) {
      const long n4 = (long)rows * H / 4;
      mul_rows<<<(int)std::min<long>((n4 + 255) / 256, 8L * num_sms()), 256, 0, st>>>(g, m, gc,
                                                                                     n4);
      if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
      gm_ = gc;
    }
    if ((e = ft::gemm(yds, w1, rows, I, H, EpiZA{b1, dh1, a, I}, st)) != cudaSuccess ||
        (e = ft::gemm(gm_, w2t, rows, I, H, EpiDh1{dh1, I}, st)) != cudaSuccess ||
        (e = ft::gemm(dh1, w1t, rows, H, I, slices, st, l.splits)) != cudaSuccess ||
        (e = launch_preln_rows<float>(x, g, gamma, acc, l.splits, rows, dx, part, rows, H, eps,
                                      st)) != cudaSuccess)
      return (int)e;
  }
  return (int)launch_reduce_cols(part, rows, H, dgamma, dbeta, st);
}

// Epilogue of the dual product: dh1 = bf16(da gelu'(h1 + b1)) and, with
// WRITE_A, a = bf16(gelu(h1 + b1)) (a compile-time choice: the epilogue
// stays branch-free).
template <bool WRITE_A>
struct EpiGeluGrad {
  const __nv_bfloat16* b1;
  __nv_bfloat16 *a, *dh1;
  int n;
  __device__ __forceinline__ void operator()(int r, int c, float h0, float h1, float d0,
                                             float d1, bool in) const {
    const __nv_bfloat162 b = __ldg(reinterpret_cast<const __nv_bfloat162*>(b1 + c));
    const float z0 = h0 + vt::to_f(b.x), z1 = h1 + vt::to_f(b.y);
    const size_t o = (size_t)r * n + c;
    const __nv_bfloat162 dv(vt::from_f<__nv_bfloat16>(d0 * vt::gelu_grad(z0)),
                            vt::from_f<__nv_bfloat16>(d1 * vt::gelu_grad(z1)));
    if constexpr (WRITE_A) {
      const __nv_bfloat162 av(vt::from_f<__nv_bfloat16>(vt::activate(z0, vt::kGeluErf)),
                              vt::from_f<__nv_bfloat16>(vt::activate(z1, vt::kGeluErf)));
      if (in) *reinterpret_cast<__nv_bfloat162*>(a + o) = av;
    }
    if (in) *reinterpret_cast<__nv_bfloat162*>(dh1 + o) = dv;
  }
};

// Workspace of the wgmma route (fp32 elements).  Pre-LN: dy (rows, H), the
// dgamma/dbeta partial rows, then gc (rows, H) bf16.  Post-LN: the S fp32
// slices (S, rows, H) of a W2 and then of dh1 W1^T (the same (rows, H, I)
// shape, so the same tiling), dsf (rows, H), the partial rows.
struct WgmmaLayout {
  size_t acc, dsf, part, gc;
  int splits;
};

WgmmaLayout wgmma_layout(int rows, int H, int I, bool postln) {
  WgmmaLayout l;
  l.splits = postln ? sm90::split_k_tiling(rows, H, I).splits : 1;
  l.acc = (size_t)l.splits * rows * H;
  l.dsf = postln ? (size_t)rows * H : 0;
  l.part = (size_t)row_blocks(rows) * 2 * H;
  l.gc = postln ? 0 : ((size_t)rows * H + 1) / 2;
  return l;
}

int launch_bwd_wgmma(const __nv_bfloat16* x, const __nv_bfloat16* g,
                     const __nv_bfloat16* gamma, const __nv_bfloat16* beta,
                     const __nv_bfloat16* w1, const __nv_bfloat16* b1,
                     const __nv_bfloat16* w2, const __nv_bfloat16* b2,
                     const __nv_bfloat16* m, __nv_bfloat16* dx, __nv_bfloat16* dh1,
                     __nv_bfloat16* a, __nv_bfloat16* yds, float* dgamma, float* dbeta,
                     float* ws, int rows, int H, int I, float eps, bool postln,
                     cudaStream_t st) {
  using bf = __nv_bfloat16;
  if (!core_shape_ok(rows, H, I)) return (int)cudaErrorInvalidValue;
  const WgmmaLayout l = wgmma_layout(rows, H, I, postln);
  float* acc = ws;
  float* dsf = acc + l.acc;
  float* part = dsf + l.dsf;
  cudaError_t e;
  if (postln) {
    const sm90::Tiling tl = sm90::split_k_tiling(rows, H, I);
    const sm90::StoreF32 sf{acc, H};
    if ((e = sm90::gemm<128, true>(x, w1, rows, I, H, EpiAct<vt::kGeluErf>{b1, a, I}, st)) !=
        cudaSuccess)
      return (int)e;
    e = tl.bn == 192 ? sm90::gemm<192, true>(a, w2, rows, H, I, sf, st, nullptr, nullptr, tl.splits)
                     : sm90::gemm<128, true>(a, w2, rows, H, I, sf, st, nullptr, nullptr, tl.splits);
    if (e != cudaSuccess) return (int)e;
    if ((e = launch_postln_rows<bf>(x, g, gamma, b2, m, acc, tl.splits, rows, yds, dsf, part, rows,
                                    H, eps, st)) != cudaSuccess)
      return (int)e;
    if ((e = sm90::gemm<128, true, sm90::DUAL>(
             x, w1, rows, I, H, EpiGeluGrad<false>{b1, nullptr, dh1, I}, st, yds, w2)) != cudaSuccess)
      return (int)e;
    e = tl.bn == 192 ? sm90::gemm<192, false>(dh1, w1, rows, H, I, sf, st, nullptr, nullptr, tl.splits)
                     : sm90::gemm<128, false>(dh1, w1, rows, H, I, sf, st, nullptr, nullptr, tl.splits);
    if (e != cudaSuccess) return (int)e;
    if ((e = launch_postln_dx<bf>(dsf, acc, tl.splits, rows, dx, rows, H, st)) != cudaSuccess)
      return (int)e;
  } else {
    bf* gc = m ? reinterpret_cast<bf*>(part + l.part) : nullptr;
    ln_rows_bf16<<<(rows + LN_WARPS - 1) / LN_WARPS, LN_WARPS * 32, 0, st>>>(
        x, gamma, beta, yds, g, m, gc, rows, H, eps);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
    if ((e = sm90::gemm<128, true, sm90::DUAL>(yds, w1, rows, I, H, EpiGeluGrad<true>{b1, a, dh1, I}, st,
                                               m ? gc : g, w2)) != cudaSuccess)
      return (int)e;
    const sm90::StoreF32 sf{acc, H};
    e = sm90::pick_tiling(rows, H, I, 128, 192, 1).bn == 192
            ? sm90::gemm<192, false>(dh1, w1, rows, H, I, sf, st)
            : sm90::gemm<128, false>(dh1, w1, rows, H, I, sf, st);
    if (e != cudaSuccess) return (int)e;
    if ((e = launch_preln_rows<bf>(x, g, gamma, acc, 1, rows, dx, part, rows, H, eps, st)) !=
        cudaSuccess)
      return (int)e;
  }
  return (int)launch_reduce_cols(part, rows, H, dgamma, dbeta, st);
}

}  // namespace

// fp32 elements of workspace vt_mlp_bwd needs for these shapes (fp32
// blocks only).
extern "C" long long vt_mlp_bwd_workspace(int rows, int H, int I, int dtype, int postln) {
  if (!tiles_shape_ok(rows, H, I) || dtype != vt::kF32) return -1;
  const TilesLayout l = tiles_layout(rows, H, I, postln != 0);
  return (long long)(l.wt + l.acc + l.dsf + l.part + l.gc);
}

// The fp32 blocks on the tiles.  yds: y = LN(x) (pre-LN) or ds (post-LN),
// (rows, H); dh1 and a (rows, I); dgamma, dbeta (H).
extern "C" int vt_mlp_bwd(const void* x, const void* g, const void* gamma,
                          const void* beta, const void* w1, const void* b1,
                          const void* w2, const void* b2, const void* m, void* dx,
                          void* dh1, void* a, void* yds, void* dgamma, void* dbeta,
                          void* ws, int rows, int H, int I, float eps, int postln,
                          int dtype, void* stream) {
  if (dtype != vt::kF32) return (int)cudaErrorInvalidValue;
  auto c = [](const void* p) { return static_cast<const float*>(p); };
  auto v = [](void* p) { return static_cast<float*>(p); };
  return launch_bwd_tiles(c(x), c(g), c(gamma), c(beta), c(w1), c(b1), c(w2), c(b2), c(m), v(dx),
                          v(dh1), v(a), v(yds), v(dgamma), v(dbeta), v(ws), rows, H, I, eps,
                          postln != 0, static_cast<cudaStream_t>(stream));
}

// fp32 elements of workspace vt_mlp_bwd_wgmma needs for these shapes.
extern "C" long long vt_mlp_bwd_wgmma_workspace(int rows, int H, int I, int postln) {
  if (!core_shape_ok(rows, H, I)) return -1;
  const WgmmaLayout w = wgmma_layout(rows, H, I, postln != 0);
  return (long long)(w.acc + w.dsf + w.part + w.gc);
}

// Every bf16 block with bf16 weights on the wgmma core: every operand bf16;
// yds: y = LN(x) (pre-LN) or ds (post-LN), (rows, H); dh1 and a (rows, I);
// dgamma, dbeta (H) fp32; b2 read post-LN only.
extern "C" int vt_mlp_bwd_wgmma(const void* x, const void* g, const void* gamma,
                                const void* beta, const void* w1, const void* b1,
                                const void* w2, const void* b2, const void* m, void* dx,
                                void* dh1, void* a, void* yds, void* dgamma, void* dbeta,
                                void* ws, int rows, int H, int I, float eps, int postln,
                                void* stream) {
  using bf = __nv_bfloat16;
  auto c = [](const void* p) { return static_cast<const bf*>(p); };
  auto v = [](void* p) { return static_cast<bf*>(p); };
  return launch_bwd_wgmma(c(x), c(g), c(gamma), c(beta), c(w1), c(b1), c(w2), c(b2), c(m), v(dx),
                          v(dh1), v(a), v(yds), static_cast<float*>(dgamma),
                          static_cast<float*>(dbeta), static_cast<float*>(ws), rows, H, I, eps,
                          postln != 0, static_cast<cudaStream_t>(stream));
}
