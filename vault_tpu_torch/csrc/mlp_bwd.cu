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
// the masked cotangent gc, dh1c and dmlpc.
//
// What bounds it on an H100: three (pre-LN) or four (post-LN: the MLP
// output must be rebuilt before the LN backward) products of rows x 768 x
// 3072, so it is bound by the tensor cores at the main path's rows (8192
// pre-LN, 1280 post-LN); the (rows, I) activations dh1 and a are the bytes
// it must write.  The TPU kernel kept both weight matrices in VMEM; an SM
// has 227 KB, so the design is the forward walk (mlp_common.cuh) with a
// third product per slice:
//   * mlp_bwd_walk: a block owns 32 rows (16 in fp32) and one split of I.
//     It puts its first operand (LN(x) pre-LN, x post-LN) and its masked
//     cotangent into shared memory once, then walks its split 128 columns
//     at a time: h1 = a1 W1[:, s] + b1 and da = gc W2[s, :]^T (both kept
//     in fp32), a and dh1 = da gelu'(h1) written out, dh1 kept in shared
//     memory, and dy += dh1 W1[:, s]^T into a 768-wide fp32 accumulator held
//     in registers across the walk.  W1 and W2 stream through shared memory
//     in 128-column tiles, double-buffered with cp.async; W1's tiles stream
//     twice per slice (once per product), since the (768, 128) slice does
//     not fit beside the row tiles.  bf16 runs on the tensor cores (16x16x16
//     wmma, fp32 accumulation), fp32 on plain FMA.
//   * the split partials of dy go to a workspace; a row kernel adds them in
//     a fixed order and runs the LN backward.  dgamma and dbeta, which the
//     TPU accumulated across its sequential grid, are summed per block of 8
//     rows into partial rows and reduced over the blocks in a fixed order by
//     a last small kernel: no float atomics, so two launches give the same
//     bits.
//   * post-LN needs the whole MLP output before any of the chain's
//     backward, so it is five launches: the forward walk (mlp_main, also
//     writing a), the row kernel (sum of its partials, b2, mask, residual,
//     LN and its backward -> ds), the backward walk on the masked ds (h1 is
//     recomputed there, not kept: 15.7 MB of fp32 at 1280 rows would be
//     written and read again for one product of 6 GFLOP), the dx row sum,
//     and the dgamma/dbeta reduction.  At 1280 rows there are 40 row blocks
//     against 132 SMs, so both walks split I across blocks.
//
// The bf16 pre-LN backward (the ViLT layers of a training step, 12 per
// step) takes another design, vt_mlp_bwd_wgmma on the wgmma core of
// gemm_sm90.cuh (ops/cuda_mlp.py mlp_route picks the entry; vt_mlp_bwd
// takes the fp32 blocks and the bf16 post-LN block), in five launches:
//   1. ln_rows_bf16 (mlp_common.cuh): y = bf16(LN(x)), the y output, and,
//      with a mask, gc = bf16(g m) into the workspace (else gc is g);
//   2. a dual product per (128-row, 128-column) tile of (rows, I): one
//      warpgroup holds h1 = y W1[:, tile] (W1 N-contiguous) and da = gc
//      W2[tile, :]^T (W2 K-contiguous) in two accumulators of one fragment
//      layout; the epilogue writes a = bf16(gelu(h1 + b1)) and dh1 =
//      bf16(da gelu'(h1 + b1)) (exact erff, vt::gelu_grad);
//   3. dy = dh1 W1^T (W1 K-contiguous, K = I) in fp32 into the workspace,
//      128 x 192 tiles (128 x 128 where they fill the SMs' waves better),
//      as one "split";
//   4. mlp_bwd_preln_rows (splits = 1) and 5. mlp_bwd_reduce_cols, as
//      before: the LN backward, dx = g + dx_ln, fixed-order dgamma/dbeta.
// dh1 goes to device memory between the products (it is an output anyway:
// 50 MB at 8,192 rows, written by 2, read by 3, 0.030 ms at 3.35 TB/s
// against the 0.117 ms bound of the three products).  That frees the tile
// from the 768-wide fp32 dy accumulator that mlp_bwd_walk keeps in
// registers, which forces its 32-row wmma tile and makes W1 stream twice
// per slice.  No float atomics anywhere: two launches give the same bits.
#include <algorithm>

#include "mlp_common.cuh"
#include "gemm_sm90.cuh"

namespace {

template <typename T> struct BwdTiles {
  static constexpr bool kBF16 = std::is_same<T, __nv_bfloat16>::value;
  static constexpr int BMW = kBF16 ? 32 : 16;   // rows per walk block
  static constexpr int TPRW = NT / BMW;         // threads per row (8 / 16)
  static constexpr int PAD = 16 / sizeof(T);
  static constexpr int KT = 256 / sizeof(T);    // hidden rows per weight tile
  static constexpr int LD1 = BN1 + PAD;         // W1 tile [h][j], dh ld
  static constexpr int LDW = KT + PAD;          // W2 tile [j][h] ld
  static constexpr int LDF = BN1 + 4;           // fp32 staging ld
  static constexpr int BUF = (KT * LD1 > BN1 * LDW) ? KT * LD1 : BN1 * LDW;
};

template <typename T, int H>
constexpr size_t walk_smem() {
  using B = BwdTiles<T>;
  return (2 * (size_t)B::BUF + 2 * (size_t)B::BMW * (H + B::PAD)
          + (size_t)B::BMW * B::LD1) * sizeof(T)
         + 2 * (size_t)B::BMW * B::LDF * sizeof(float);
}

// Grid (row tiles, splits).  LN: a1 = LN(x) (pre-LN, y written by split 0)
// else a1 = x.  g m (or g) is the cotangent at the MLP output.  Writes a
// (when a_out is given) and dh1 for its columns, and its fp32 partial of
// dh1 W1^T to ws[split].
template <typename T, int NF, bool LN>
__global__ void __launch_bounds__(NT)
mlp_bwd_walk(const T* __restrict__ x, const T* __restrict__ g,
             const T* __restrict__ m, const T* __restrict__ gamma,
             const T* __restrict__ beta, const T* __restrict__ w1,
             const T* __restrict__ b1, const T* __restrict__ w2,
             float* __restrict__ ws, T* __restrict__ a_out,
             T* __restrict__ dh1_out, T* __restrict__ y_out, int rows,
             int rows_pad, int I, int ic, float eps) {
  using B = BwdTiles<T>;
  constexpr bool kBF16 = B::kBF16;
  constexpr int H = NF * 16 * NW;
  constexpr int BMW = B::BMW, TPRW = B::TPRW, KT = B::KT;
  constexpr int LDX = H + B::PAD, LD1 = B::LD1, LDW = B::LDW, LDF = B::LDF;
  constexpr int BUF = B::BUF;
  constexpr int NK = H / KT;           // weight tiles per product
  constexpr int PER = 3 * NK;          // tiles per 128-column slice
  constexpr int FC = BN1 / TPRW;       // fp32: slice columns per thread
  constexpr int F3 = KT / TPRW;        // fp32: dy columns per thread per tile

  extern __shared__ __align__(128) unsigned char smem_raw[];
  T* wbuf = reinterpret_cast<T*>(smem_raw);     // 2 x BUF
  T* a1s = wbuf + 2 * BUF;                      // (BMW, LDX) LN(x) or x
  T* gs = a1s + BMW * LDX;                      // (BMW, LDX) masked cotangent
  T* dh = gs + BMW * LDX;                       // (BMW, LD1) dh1 of the slice
  float* hf = reinterpret_cast<float*>(dh + BMW * LD1);  // (BMW, LDF) h1
  float* df = hf + BMW * LDF;                            // (BMW, LDF) da

  const int tid = threadIdx.x, w = tid >> 5, lane = tid & 31;
  const int row0 = blockIdx.x * BMW;
  const int i0 = blockIdx.y * ic;
  const int n_tiles = (ic / BN1) * PER;

  // tile t: slice t / PER; phase p = t % PER: W1[h0:h0+KT, slice] ([h][j])
  // for the first and third products, W2[slice, h0:h0+KT] ([j][h]) for the
  // second.
  auto fetch = [&](int t) {
    T* dst = wbuf + (t & 1) * BUF;
    const int p = t % PER, j0 = i0 + (t / PER) * BN1;
    constexpr int V = 16 / sizeof(T);
    if (p < NK || p >= 2 * NK) {
      const int h0 = (p < NK ? p : p - 2 * NK) * KT;
      const T* src = w1 + (size_t)h0 * I + j0;
      for (int c = tid; c < KT * (BN1 / V); c += NT) {
        const int r = c / (BN1 / V), col = (c % (BN1 / V)) * V;
        cp_async16(dst + r * LD1 + col, src + (size_t)r * I + col);
      }
    } else {
      const int h0 = (p - NK) * KT;
      const T* src = w2 + (size_t)j0 * H + h0;
      for (int c = tid; c < BN1 * (KT / V); c += NT) {
        const int r = c / (KT / V), col = (c % (KT / V)) * V;
        cp_async16(dst + r * LDW + col, src + (size_t)r * H + col);
      }
    }
    cp_async_commit();
  };

  fetch(0);

  // ---- prologue: a1s = LN(x) or x, gs = g m or g; rows past `rows` are 0
  {
    const int r = tid / TPRW, cl = tid % TPRW;
    const bool ok = row0 + r < rows;
    const size_t off = (size_t)(row0 + r) * H;
    float sum = 0.0f;
    for (int c = cl; c < H; c += TPRW) {
      const T v = ok ? x[off + c] : vt::from_f<T>(0.0f);
      a1s[r * LDX + c] = v;
      sum += vt::to_f(v);
      T gv = ok ? g[off + c] : vt::from_f<T>(0.0f);
      if (m != nullptr && ok) gv = vt::from_f<T>(vt::to_f(gv) * vt::to_f(m[off + c]));
      gs[r * LDX + c] = gv;
    }
    if constexpr (LN) {
      const float mean = group_sum<TPRW>(sum) / H;
      float sq = 0.0f;
      for (int c = cl; c < H; c += TPRW) {
        const float d = vt::to_f(a1s[r * LDX + c]) - mean;
        sq += d * d;
      }
      const float inv = 1.0f / sqrtf(group_sum<TPRW>(sq) / H + eps);
      const bool write_y = ok && blockIdx.y == 0;
      for (int c = cl; c < H; c += TPRW) {
        const float y = (vt::to_f(a1s[r * LDX + c]) - mean) * inv;
        const T yc = vt::from_f<T>(y * vt::to_f(gamma[c]) + vt::to_f(beta[c]));
        a1s[r * LDX + c] = yc;
        if (write_y) y_out[off + c] = yc;
      }
    }
  }

  // accumulators.  bf16: warp w owns columns [16 w, 16 w + 16) of h1 and da
  // (acc, two 16-row groups) and, of dy, columns 16 w .. 16 w + 16 of every
  // KT-wide tile (acc3[2 q + group]).  fp32: thread (fr, fq) owns slice
  // columns fq FC .. fq FC + FC of row fr (f1 = h1, f2 = da) and dy columns
  // q KT + fq + TPRW jj (f3).
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[kBF16 ? 2 : 1],
      acc3[kBF16 ? 2 * NK : 1];
  float f1[kBF16 ? 1 : FC], f2[kBF16 ? 1 : FC], f3[kBF16 ? 1 : NK * F3];
  if constexpr (kBF16) {
#pragma unroll
    for (int i = 0; i < 2; ++i) wmma::fill_fragment(acc[i], 0.0f);
#pragma unroll
    for (int i = 0; i < 2 * NK; ++i) wmma::fill_fragment(acc3[i], 0.0f);
  } else {
#pragma unroll
    for (int i = 0; i < FC; ++i) f1[i] = f2[i] = 0.0f;
#pragma unroll
    for (int i = 0; i < NK * F3; ++i) f3[i] = 0.0f;
  }
  const int fr = tid / TPRW, fq = tid % TPRW;

  int t = 0;
  auto wait_tile = [&]() -> const T* {
    if (t + 1 < n_tiles) {
      fetch(t + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // tile t (and, at t = 0, the prologue) visible
    return wbuf + (t & 1) * BUF;
  };
  auto release = [&]() {
    __syncthreads();  // every warp is done with wbuf[t & 1]
    ++t;
  };

  for (int j0 = i0; j0 < i0 + ic; j0 += BN1) {
    // ---- h1 = a1 W1[:, slice]
    for (int p = 0; p < NK; ++p) {
      const T* wt = wait_tile();
      const int k0 = p * KT;
      if constexpr (kBF16) {
#pragma unroll
        for (int kk = 0; kk < KT / 16; ++kk) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> b;
          wmma::load_matrix_sync(b, wt + kk * 16 * LD1 + w * 16, LD1);
#pragma unroll
          for (int gi = 0; gi < 2; ++gi) {
            wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
            wmma::load_matrix_sync(a, a1s + gi * 16 * LDX + k0 + kk * 16, LDX);
            wmma::mma_sync(acc[gi], a, b, acc[gi]);
          }
        }
      } else {
        for (int k = 0; k < KT; ++k) {
          const float a = vt::to_f(a1s[fr * LDX + k0 + k]);
#pragma unroll
          for (int c = 0; c < FC; ++c)
            f1[c] = fmaf(a, vt::to_f(wt[k * LD1 + fq * FC + c]), f1[c]);
        }
      }
      release();
    }
    if constexpr (kBF16) {
#pragma unroll
      for (int gi = 0; gi < 2; ++gi) {
        wmma::store_matrix_sync(hf + gi * 16 * LDF + w * 16, acc[gi], LDF,
                                wmma::mem_row_major);
        wmma::fill_fragment(acc[gi], 0.0f);
      }
    }
    // ---- da = gc W2[slice, :]^T
    for (int p = 0; p < NK; ++p) {
      const T* wt = wait_tile();
      const int k0 = p * KT;
      if constexpr (kBF16) {
#pragma unroll
        for (int kk = 0; kk < KT / 16; ++kk) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> b;
          wmma::load_matrix_sync(b, wt + w * 16 * LDW + kk * 16, LDW);
#pragma unroll
          for (int gi = 0; gi < 2; ++gi) {
            wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
            wmma::load_matrix_sync(a, gs + gi * 16 * LDX + k0 + kk * 16, LDX);
            wmma::mma_sync(acc[gi], a, b, acc[gi]);
          }
        }
      } else {
        for (int k = 0; k < KT; ++k) {
          const float a = vt::to_f(gs[fr * LDX + k0 + k]);
#pragma unroll
          for (int c = 0; c < FC; ++c)
            f2[c] = fmaf(a, vt::to_f(wt[(fq * FC + c) * LDW + k]), f2[c]);
        }
      }
      release();
    }
    // ---- a = gelu(h1 + b1), dh1 = da gelu'(h1 + b1): each warp (thread,
    // in fp32) on the columns it accumulated
    if constexpr (kBF16) {
#pragma unroll
      for (int gi = 0; gi < 2; ++gi) {
        wmma::store_matrix_sync(df + gi * 16 * LDF + w * 16, acc[gi], LDF,
                                wmma::mem_row_major);
        wmma::fill_fragment(acc[gi], 0.0f);
      }
      __syncwarp();
#pragma unroll 4
      for (int e = 0; e < 16; ++e) {
        const int idx = lane + 32 * e, rr = idx / 16, cc = w * 16 + idx % 16;
        const float h = hf[rr * LDF + cc] + vt::to_f(b1[j0 + cc]);
        const T d = vt::from_f<T>(df[rr * LDF + cc] * vt::gelu_grad(h));
        dh[rr * LD1 + cc] = d;
        if (row0 + rr < rows) {
          const size_t o = (size_t)(row0 + rr) * I + j0 + cc;
          dh1_out[o] = d;
          if (a_out) a_out[o] = vt::from_f<T>(vt::activate(h, vt::kGeluErf));
        }
      }
    } else {
#pragma unroll
      for (int c = 0; c < FC; ++c) {
        const int cc = fq * FC + c;
        const float h = f1[c] + vt::to_f(b1[j0 + cc]);
        const T d = vt::from_f<T>(f2[c] * vt::gelu_grad(h));
        dh[fr * LD1 + cc] = d;
        if (row0 + fr < rows) {
          const size_t o = (size_t)(row0 + fr) * I + j0 + cc;
          dh1_out[o] = d;
          if (a_out) a_out[o] = vt::from_f<T>(vt::activate(h, vt::kGeluErf));
        }
        f1[c] = f2[c] = 0.0f;
      }
    }
    __syncthreads();  // dh complete
    // ---- dy[:, h0:h0+KT] += dh1 W1[h0:h0+KT, slice]^T, tile by tile
#pragma unroll
    for (int q = 0; q < NK; ++q) {
      const T* wt = wait_tile();
      if constexpr (kBF16) {
#pragma unroll
        for (int kk = 0; kk < BN1 / 16; ++kk) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> b;
          wmma::load_matrix_sync(b, wt + w * 16 * LD1 + kk * 16, LD1);
#pragma unroll
          for (int gi = 0; gi < 2; ++gi) {
            wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
            wmma::load_matrix_sync(a, dh + gi * 16 * LD1 + kk * 16, LD1);
            wmma::mma_sync(acc3[2 * q + gi], a, b, acc3[2 * q + gi]);
          }
        }
      } else {
        for (int j = 0; j < BN1; ++j) {
          const float a = vt::to_f(dh[fr * LD1 + j]);
#pragma unroll
          for (int jj = 0; jj < F3; ++jj)
            f3[q * F3 + jj] = fmaf(a, vt::to_f(wt[(fq + TPRW * jj) * LD1 + j]), f3[q * F3 + jj]);
        }
      }
      release();
    }
  }

  // partial dy of this split -> ws[split] (rows padded to BMW)
  float* dst = ws + ((size_t)blockIdx.y * rows_pad + row0) * H;
  if constexpr (kBF16) {
#pragma unroll
    for (int q = 0; q < NK; ++q)
#pragma unroll
      for (int gi = 0; gi < 2; ++gi)
        wmma::store_matrix_sync(dst + (size_t)gi * 16 * H + q * KT + w * 16,
                                acc3[2 * q + gi], H, wmma::mem_row_major);
  } else {
#pragma unroll
    for (int q = 0; q < NK; ++q)
#pragma unroll
      for (int jj = 0; jj < F3; ++jj)
        dst[(size_t)fr * H + q * KT + fq + TPRW * jj] = f3[q * F3 + jj];
  }
}

// Row kernels: RT threads, RB rows per block, one row at a time.
constexpr int RT = 128;
constexpr int RB = 8;

__device__ __forceinline__ float block_sum(float a, float* red) {
  a = group_sum<32>(a);
  __syncthreads();  // red is free (its last readers are done)
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = a;
  __syncthreads();
  float t = 0.0f;
#pragma unroll
  for (int w = 0; w < RT / 32; ++w) t += red[w];
  return t;
}

// Pre-LN: dy = the splits' partials in order; LN backward; dx = g + dx_ln;
// dgamma/dbeta partials of the block's rows -> part[block].
template <typename T, int NF>
__global__ void __launch_bounds__(RT)
mlp_bwd_preln_rows(const T* __restrict__ x, const T* __restrict__ g,
                   const T* __restrict__ gamma, const float* __restrict__ ws,
                   int splits, int rows_pad, T* __restrict__ dx,
                   float* __restrict__ part, int rows, float eps) {
  constexpr int H = NF * 16 * NW, PER = H / RT;
  __shared__ float red[RT / 32];
  const int tid = threadIdx.x;
  float pg[PER], pb[PER];
#pragma unroll
  for (int i = 0; i < PER; ++i) pg[i] = pb[i] = 0.0f;
  for (int rr = 0; rr < RB; ++rr) {
    const int row = blockIdx.x * RB + rr;
    if (row >= rows) break;
    const size_t off = (size_t)row * H;
    float xv[PER], dy[PER], sum = 0.0f;
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      xv[i] = vt::to_f(x[off + tid + RT * i]);
      sum += xv[i];
      dy[i] = 0.0f;
    }
    for (int s = 0; s < splits; ++s) {
      const float* p = ws + ((size_t)s * rows_pad + row) * H + tid;
#pragma unroll
      for (int i = 0; i < PER; ++i) dy[i] += p[RT * i];
    }
    const float mean = block_sum(sum, red) / H;
    float sq = 0.0f;
#pragma unroll
    for (int i = 0; i < PER; ++i) sq += (xv[i] - mean) * (xv[i] - mean);
    const float rstd = 1.0f / sqrtf(block_sum(sq, red) / H + eps);
    float s1 = 0.0f, s2 = 0.0f;
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      xv[i] = (xv[i] - mean) * rstd;  // xhat
      const float dxh = dy[i] * vt::to_f(gamma[tid + RT * i]);
      s1 += dxh;
      s2 += dxh * xv[i];
    }
    const float m1 = block_sum(s1, red) / H, m2 = block_sum(s2, red) / H;
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int c = tid + RT * i;
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
    dst[tid + RT * i] = pg[i];
    dst[H + tid + RT * i] = pb[i];
  }
}

// Post-LN: o = the forward walk's partials + b2; s = x + m o; LN backward
// of the cotangent g -> ds (fp32, kept for dx) and dmlp = ds m (x's type,
// the `ds` output); dgamma/dbeta partials -> part[block].
template <typename T, int NF>
__global__ void __launch_bounds__(RT)
mlp_bwd_postln_rows(const T* __restrict__ x, const T* __restrict__ g,
                    const T* __restrict__ gamma, const T* __restrict__ b2,
                    const T* __restrict__ m, const float* __restrict__ ws,
                    int splits, int rows_pad, T* __restrict__ ds_out,
                    float* __restrict__ dsf, float* __restrict__ part, int rows,
                    float eps) {
  constexpr int H = NF * 16 * NW, PER = H / RT;
  __shared__ float red[RT / 32];
  const int tid = threadIdx.x;
  float pg[PER], pb[PER];
#pragma unroll
  for (int i = 0; i < PER; ++i) pg[i] = pb[i] = 0.0f;
  for (int rr = 0; rr < RB; ++rr) {
    const int row = blockIdx.x * RB + rr;
    if (row >= rows) break;
    const size_t off = (size_t)row * H;
    float sv[PER], sum = 0.0f;
#pragma unroll
    for (int i = 0; i < PER; ++i) sv[i] = 0.0f;
    for (int s = 0; s < splits; ++s) {
      const float* p = ws + ((size_t)s * rows_pad + row) * H + tid;
#pragma unroll
      for (int i = 0; i < PER; ++i) sv[i] += p[RT * i];
    }
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int c = tid + RT * i;
      float o = sv[i] + vt::to_f(b2[c]);
      if (m) o *= vt::to_f(m[off + c]);
      sv[i] = vt::to_f(x[off + c]) + o;
      sum += sv[i];
    }
    const float mean = block_sum(sum, red) / H;
    float sq = 0.0f;
#pragma unroll
    for (int i = 0; i < PER; ++i) sq += (sv[i] - mean) * (sv[i] - mean);
    const float rstd = 1.0f / sqrtf(block_sum(sq, red) / H + eps);
    float s1 = 0.0f, s2 = 0.0f;
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int c = tid + RT * i;
      sv[i] = (sv[i] - mean) * rstd;  // shat
      const float dsh = vt::to_f(g[off + c]) * vt::to_f(gamma[c]);
      s1 += dsh;
      s2 += dsh * sv[i];
    }
    const float m1 = block_sum(s1, red) / H, m2 = block_sum(s2, red) / H;
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int c = tid + RT * i;
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
    dst[tid + RT * i] = pg[i];
    dst[H + tid + RT * i] = pb[i];
  }
}

// Post-LN: dx = ds + the backward walk's partials (in order).
template <typename T>
__global__ void mlp_bwd_postln_dx(const float* __restrict__ dsf,
                                  const float* __restrict__ ws, int splits,
                                  int rows_pad, T* __restrict__ dx, int rows, int H) {
  const size_t n = (size_t)rows * H;
  for (size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x; idx < n;
       idx += (size_t)gridDim.x * blockDim.x) {
    const size_t row = idx / H, col = idx % H;
    float v = 0.0f;
    for (int s = 0; s < splits; ++s) v += ws[((size_t)s * rows_pad + row) * H + col];
    dx[idx] = vt::from_f<T>(dsf[idx] + v);
  }
}

// dgamma, dbeta: the blocks' partial rows summed in block order.
__global__ void mlp_bwd_reduce_cols(const float* __restrict__ part, int nblocks,
                                    int H, float* __restrict__ dgamma,
                                    float* __restrict__ dbeta) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= 2 * H) return;
  float s = 0.0f;
  for (int b = 0; b < nblocks; ++b) s += part[(size_t)b * 2 * H + c];
  if (c < H) dgamma[c] = s;
  else dbeta[c - H] = s;
}

// Workspace (fp32 elements): split partials (the larger of the two walks'
// needs), ds (post-LN), dgamma/dbeta partial rows.
struct Layout {
  int splits_a, pad_a, splits_w, pad_w, nblocks;
  size_t acc, dsf, part;
};

template <typename T>
Layout layout(int rows, int H, int I, bool postln) {
  using B = BwdTiles<T>;
  Layout l;
  l.splits_a = pick_splits(rows, I, BM);
  l.pad_a = (rows + BM - 1) / BM * BM;
  l.splits_w = pick_splits(rows, I, B::BMW);
  l.pad_w = (rows + B::BMW - 1) / B::BMW * B::BMW;
  l.nblocks = (rows + RB - 1) / RB;
  size_t acc = (size_t)l.splits_w * l.pad_w;
  if (postln) acc = std::max(acc, (size_t)l.splits_a * l.pad_a);
  l.acc = acc * H;
  l.dsf = postln ? (size_t)rows * H : 0;
  l.part = (size_t)l.nblocks * 2 * H;
  return l;
}

template <typename T, int NF, bool POSTLN>
int launch_bwd(const T* x, const T* g, const T* gamma, const T* beta, const T* w1,
               const T* b1, const T* w2, const T* b2, const T* m, T* dx, T* dh1,
               T* a, T* yds, float* dgamma, float* dbeta, float* ws, int rows,
               int I, float eps, cudaStream_t st) {
  using B = BwdTiles<T>;
  constexpr int H = NF * 16 * NW;
  const Layout l = layout<T>(rows, H, I, POSTLN);
  float* acc = ws;
  float* dsf = acc + l.acc;
  float* part = dsf + l.dsf;
  const dim3 walk_grid((rows + B::BMW - 1) / B::BMW, l.splits_w);
  const size_t smem = walk_smem<T, H>();
  cudaError_t e;
  if constexpr (!POSTLN) {
    if ((e = allow_smem<mlp_bwd_walk<T, NF, true>>(smem)) != cudaSuccess) return (int)e;
    mlp_bwd_walk<T, NF, true><<<walk_grid, NT, smem, st>>>(
        x, g, m, gamma, beta, w1, b1, w2, acc, a, dh1, yds, rows, l.pad_w, I,
        I / l.splits_w, eps);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
    mlp_bwd_preln_rows<T, NF><<<l.nblocks, RT, 0, st>>>(
        x, g, gamma, acc, l.splits_w, l.pad_w, dx, part, rows, eps);
  } else {
    const size_t smem_a = main_smem<T, H>();
    if ((e = allow_smem<mlp_main<T, NF, true>>(smem_a)) != cudaSuccess) return (int)e;
    mlp_main<T, NF, true><<<dim3(l.pad_a / BM, l.splits_a), NT, smem_a, st>>>(
        x, gamma, beta, w1, b1, w2, acc, a, rows, l.pad_a, I, I / l.splits_a,
        eps, vt::kGeluErf, nullptr, nullptr);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
    mlp_bwd_postln_rows<T, NF><<<l.nblocks, RT, 0, st>>>(
        x, g, gamma, b2, m, acc, l.splits_a, l.pad_a, yds, dsf, part, rows, eps);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
    if ((e = allow_smem<mlp_bwd_walk<T, NF, false>>(smem)) != cudaSuccess) return (int)e;
    mlp_bwd_walk<T, NF, false><<<walk_grid, NT, smem, st>>>(
        x, yds, nullptr, gamma, beta, w1, b1, w2, acc, nullptr, dh1, nullptr,
        rows, l.pad_w, I, I / l.splits_w, eps);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
    const int n = rows * H;
    mlp_bwd_postln_dx<T><<<std::min((n + 255) / 256, 4 * num_sms()), 256, 0, st>>>(
        dsf, acc, l.splits_w, l.pad_w, dx, rows, H);
  }
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  mlp_bwd_reduce_cols<<<(2 * H + RT - 1) / RT, RT, 0, st>>>(part, l.nblocks, H,
                                                            dgamma, dbeta);
  return (int)cudaGetLastError();
}

// Epilogue of the dual product: a = bf16(gelu(h1 + b1)), dh1 = bf16(da
// gelu'(h1 + b1)).
struct EpiGeluGrad {
  const __nv_bfloat16* b1;
  __nv_bfloat16 *a, *dh1;
  int n;
  __device__ __forceinline__ void operator()(int r, int c, float h0, float h1, float d0,
                                             float d1, bool in) const {
    const __nv_bfloat162 b = __ldg(reinterpret_cast<const __nv_bfloat162*>(b1 + c));
    const float z0 = h0 + vt::to_f(b.x), z1 = h1 + vt::to_f(b.y);
    const size_t o = (size_t)r * n + c;
    const __nv_bfloat162 av(vt::from_f<__nv_bfloat16>(vt::activate(z0, vt::kGeluErf)),
                            vt::from_f<__nv_bfloat16>(vt::activate(z1, vt::kGeluErf)));
    const __nv_bfloat162 dv(vt::from_f<__nv_bfloat16>(d0 * vt::gelu_grad(z0)),
                            vt::from_f<__nv_bfloat16>(d1 * vt::gelu_grad(z1)));
    if (in) {
      *reinterpret_cast<__nv_bfloat162*>(a + o) = av;
      *reinterpret_cast<__nv_bfloat162*>(dh1 + o) = dv;
    }
  }
};

// Workspace of the wgmma route (fp32 elements): dy (rows, H), the
// dgamma/dbeta partial rows, then gc (rows, H) bf16.
struct WgmmaLayout {
  size_t dy, part, gc;
  int nblocks;
};

WgmmaLayout wgmma_layout(int rows, int H) {
  WgmmaLayout l;
  l.nblocks = (rows + RB - 1) / RB;
  l.dy = (size_t)rows * H;
  l.part = (size_t)l.nblocks * 2 * H;
  l.gc = ((size_t)rows * H + 1) / 2;
  return l;
}

int launch_bwd_wgmma(const __nv_bfloat16* x, const __nv_bfloat16* g,
                     const __nv_bfloat16* gamma, const __nv_bfloat16* beta,
                     const __nv_bfloat16* w1, const __nv_bfloat16* b1,
                     const __nv_bfloat16* w2, const __nv_bfloat16* m, __nv_bfloat16* dx,
                     __nv_bfloat16* dh1, __nv_bfloat16* a, __nv_bfloat16* y, float* dgamma,
                     float* dbeta, float* ws, int rows, int H, int I, float eps,
                     cudaStream_t st) {
  using bf = __nv_bfloat16;
  if (H != 768) return (int)cudaErrorInvalidValue;
  const WgmmaLayout l = wgmma_layout(rows, H);
  float* dy = ws;
  float* part = dy + l.dy;
  bf* gc = m ? reinterpret_cast<bf*>(part + l.part) : nullptr;
  ln_rows_bf16<768><<<(rows + LN_WARPS - 1) / LN_WARPS, LN_WARPS * 32, 0, st>>>(
      x, gamma, beta, y, g, m, gc, rows, eps);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  e = sm90::gemm<128, true, sm90::DUAL>(y, w1, rows, I, H, EpiGeluGrad{b1, a, dh1, I}, st,
                                  m ? gc : g, w2);
  if (e != cudaSuccess) return (int)e;
  e = sm90::pick_width(rows, H, 128, 192) == 192
          ? sm90::gemm<192, false>(dh1, w1, rows, H, I, sm90::StoreF32{dy, H}, st)
          : sm90::gemm<128, false>(dh1, w1, rows, H, I, sm90::StoreF32{dy, H}, st);
  if (e != cudaSuccess) return (int)e;
  mlp_bwd_preln_rows<bf, 6><<<l.nblocks, RT, 0, st>>>(x, g, gamma, dy, 1, rows, dx, part,
                                                      rows, eps);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  mlp_bwd_reduce_cols<<<(2 * H + RT - 1) / RT, RT, 0, st>>>(part, l.nblocks, H, dgamma, dbeta);
  return (int)cudaGetLastError();
}

template <typename T, bool POSTLN>
int dispatch_bwd(int H, const void* x, const void* g, const void* gamma,
                 const void* beta, const void* w1, const void* b1, const void* w2,
                 const void* b2, const void* m, void* dx, void* dh1, void* a,
                 void* yds, float* dgamma, float* dbeta, float* ws, int rows, int I,
                 float eps, cudaStream_t st) {
  if (H != 768) return (int)cudaErrorInvalidValue;
  auto c = [](const void* p) { return static_cast<const T*>(p); };
  auto v = [](void* p) { return static_cast<T*>(p); };
  return launch_bwd<T, 6, POSTLN>(c(x), c(g), c(gamma), c(beta), c(w1), c(b1), c(w2),
                                  c(b2), c(m), v(dx), v(dh1), v(a), v(yds), dgamma, dbeta,
                                  ws, rows, I, eps, st);
}

}  // namespace

// fp32 elements of workspace vt_mlp_bwd needs for these shapes; -1 for the
// bf16 pre-LN block, which runs on vt_mlp_bwd_wgmma.
extern "C" long long vt_mlp_bwd_workspace(int rows, int H, int I, int dtype, int postln) {
  if (rows <= 0 || I <= 0 || I % BN1 != 0) return -1;
  if (dtype == vt::kBF16 && !postln) return -1;
  const Layout l = dtype == vt::kBF16 ? layout<__nv_bfloat16>(rows, H, I, true)
                                      : layout<float>(rows, H, I, postln);
  return (long long)(l.acc + l.dsf + l.part);
}

// The walk: the fp32 blocks and the bf16 post-LN block.  yds: y = LN(x)
// (pre-LN) or ds (post-LN), (rows, H) in x's type; dh1 and a (rows, I);
// dgamma, dbeta (H) fp32.
extern "C" int vt_mlp_bwd(const void* x, const void* g, const void* gamma,
                          const void* beta, const void* w1, const void* b1,
                          const void* w2, const void* b2, const void* m, void* dx,
                          void* dh1, void* a, void* yds, void* dgamma, void* dbeta,
                          void* ws, int rows, int H, int I, float eps, int postln,
                          int dtype, void* stream) {
  if (rows <= 0 || I <= 0 || I % BN1 != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* dg = static_cast<float*>(dgamma);
  float* db = static_cast<float*>(dbeta);
  float* wsf = static_cast<float*>(ws);
  if (dtype == vt::kBF16 && postln)
    return dispatch_bwd<__nv_bfloat16, true>(H, x, g, gamma, beta, w1, b1, w2, b2, m, dx,
                                             dh1, a, yds, dg, db, wsf, rows, I, eps, st);
  if (dtype == vt::kF32)
    return postln ? dispatch_bwd<float, true>(H, x, g, gamma, beta, w1, b1, w2, b2, m, dx,
                                              dh1, a, yds, dg, db, wsf, rows, I, eps, st)
                  : dispatch_bwd<float, false>(H, x, g, gamma, beta, w1, b1, w2, b2, m, dx,
                                               dh1, a, yds, dg, db, wsf, rows, I, eps, st);
  return (int)cudaErrorInvalidValue;
}

// fp32 elements of workspace vt_mlp_bwd_wgmma needs for these shapes.
extern "C" long long vt_mlp_bwd_wgmma_workspace(int rows, int H, int I) {
  if (rows <= 0 || I <= 0 || I % BN1 != 0) return -1;
  const WgmmaLayout w = wgmma_layout(rows, H);
  return (long long)(w.dy + w.part + w.gc);
}

// The bf16 pre-LN block on the wgmma core: every operand bf16, y = LN(x)
// (rows, H); dh1 and a (rows, I); dgamma, dbeta (H) fp32.
extern "C" int vt_mlp_bwd_wgmma(const void* x, const void* g, const void* gamma,
                                const void* beta, const void* w1, const void* b1,
                                const void* w2, const void* m, void* dx, void* dh1, void* a,
                                void* y, void* dgamma, void* dbeta, void* ws, int rows, int H,
                                int I, float eps, void* stream) {
  if (rows <= 0 || I <= 0 || I % BN1 != 0) return (int)cudaErrorInvalidValue;
  using bf = __nv_bfloat16;
  auto c = [](const void* p) { return static_cast<const bf*>(p); };
  auto v = [](void* p) { return static_cast<bf*>(p); };
  return launch_bwd_wgmma(c(x), c(g), c(gamma), c(beta), c(w1), c(b1), c(w2), c(m), v(dx),
                          v(dh1), v(a), v(y), static_cast<float*>(dgamma),
                          static_cast<float*>(dbeta), static_cast<float*>(ws), rows, H, I, eps,
                          static_cast<cudaStream_t>(stream));
}
