// Backward of the encoder attention for Hopper: given q, k, v (B, H, L, D),
// the (B, 1, 1, L) fp32 key bias and dO, the gradient of
// out = softmax(q k^T / sqrt(d) + bias) v, it writes dq, dk and dv in bf16.
//
// Replaces no TPU kernel: the JAX package's Pallas attention kernels
// (vault_tpu/ops/pallas_attention.py) differentiate by recomputing through
// attend_xla, and the port's plain backward (the autograd of
// ops/attention.py attend_plain) upcasts q, k and v to fp32 and writes fp32
// (B, H, L, L) scores, probabilities and their gradients, with four fp32
// products on the CUDA cores.  This kernel keeps every (L, L) tile on chip.
//
// Numerics: the plain path's roundings.  S = q k^T / sqrt(d) + bias,
// accumulated in fp32 (here an fma of the fp32 sum with 1 / sqrt(d) and the
// bias); the row statistics, max m and sum l of exp(S - m), in fp32; P =
// exp(S - m) (1 / l) in fp32, rounded to bf16 where dV = P^T dO multiplies it;
// dP = dO V^T accumulated in fp32 and rounded to bf16, as the plain path's
// cast of P to bf16 rounds its gradient; Delta = rowsum(dP * P) and dS =
// P * (dP - Delta) in fp32; dq = dS K / sqrt(d), dk = dS^T Q / sqrt(d).  The
// one rounding the plain path lacks: dS / sqrt(d) enters the tensor cores in
// bf16 (the plain path multiplies it in fp32).  Every product accumulates
// in fp32 on wgmma.
//
// What bounds it on an H100: at ViLT's training shape (B 256, H 12, L 256,
// D 64) the algorithm's four products, 8 B H L^2 D = 103 GFLOP (0.104 ms at
// 989 TFLOP/s), against q, k, v and dO read and dq, dk and dv written, 705
// MB (0.210 ms at 3.35 TB/s): the bytes.  The design reads each operand
// once from device memory and rereads the tiles it streams from L2, and
// recomputes S (and dP) where keeping them would cost an (L, L) tensor.
//
// Design: FlashAttention-2's split of the backward into a pass over query
// tiles and a pass over key tiles, both without atomics.  Two kernels, one
// launch each, one C entry (vt_attention_bwd):
//   1. attention_bwd_dq, a block per (64 query rows, head, batch row), one
//      warpgroup: Q and dO of its rows stay in shared memory while the key
//      tiles (K, V and their bias) stream twice through two cp.async
//      buffers.  Pass 1 takes S = Q K^T and dP = dO V^T per key tile and
//      keeps, per row and online over the tiles (the forward's rescaling
//      when the maximum moves), m, l and sum(exp(S - m) * dP), so Delta is
//      that sum over l.  Pass 2 recomputes S and dP, forms dS in the
//      accumulator registers, and accumulates dq += dS K on wgmma with dS as
//      the register A operand (the forward's P V form).  It writes dq and
//      the rows' m, 1 / l and Delta (fp32, 12 bytes a row) to a scratch.
//   2. attention_bwd_dkv, a block per (64 key rows, head, batch row): K and
//      V of its keys stay in shared memory while the query tiles (Q, dO and
//      their rows' statistics) stream once.  It takes the transposed tiles
//      S^T = K Q^T and dP^T = V dO^T, so P^T and dS^T lie in the
//      accumulator layout with keys as rows, and accumulates dv += P^T dO
//      and dk += dS^T Q with them as register A operands.
// Every output element is one thread's fixed-order sum over one loop, and
// nothing is shared between blocks but the statistics, written before the
// second kernel runs: repeats are bit-equal.  No float atomics.
//
// Tiles in shared memory are attention_common.cuh's: D / 32 blocks of (64
// rows, 32 columns) under the 64-byte swizzle, loaded by cp.async (16-byte
// pieces at the exact head dims 32, 64, 96 and 128; 8-byte pieces with zeros
// at columns d..D in the padded instances of the other multiples of 4),
// zeros past L.  Any L: the last tile's rows and keys past L are excluded
// (keys masked to exp = 0, query columns' P and dS set to 0) and never
// stored.  49.5 KB of shared memory a block at D 64, 97.5 KB at D 128.
#include "attention_common.cuh"

namespace {

constexpr int BR = 64;  // rows of a tile: queries (pass over queries) or keys

struct BwdMap {
  int L, H, d;
  float scale;           // 1 / sqrt(d)
  Strides in, g, o;      // q, k and v; dO; dq, dk and dv
  long long n_stats;     // B * H * L: the stride between m, 1 / l and Delta
};

template <int D>
struct BwdTiles {
  static_assert(D % 32 == 0, "tiles of 32 columns");
  static constexpr int TILE = BR * D * 2;  // one (64, D) bf16 tile
  // two resident tiles, two buffers of two streamed tiles, then two buffers
  // of the streamed rows' fp32 side data (bias: BR; statistics: 3 BR)
  static constexpr size_t smem() { return 1024 + 6 * (size_t)TILE + 2 * 3 * BR * 4; }
};

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// Rows [row0, row0 + 64) of one head's (L, d) operand (rows `ld` elements
// apart) into a swizzled (64, D) tile by cp.async, zeros past L and (PAD)
// at columns d..D.  Not committed.
template <int D, bool PAD>
__device__ __forceinline__ void load_rows(unsigned char* dst, const bf16* src, long long ld,
                                          int row0, int L, int d) {
  constexpr int C = PAD ? 4 : 8;  // columns a copy: 8 or 16 bytes
  for (int i = threadIdx.x; i < BR * D / C; i += NT) {
    const int r = i / (D / C), col = C * (i % (D / C)), row = row0 + r;
    const bool ok = row < L && (!PAD || col < d);
    const bf16* from = ok ? src + row * ld + col : src;
    if constexpr (PAD) cp_async8(dst + swizzled(r, col, BR), from, ok);
    else cp_async16(dst + swizzled(r, col, BR), from, ok);
  }
}

// acc (64 x 64, fp32) += A B^T over the head dim, A and B (64, D) tiles,
// both K-contiguous: in flight, not committed.
template <int D>
__device__ __forceinline__ void mma_abt(float (&acc)[BR / 2], uint32_t a, uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t at = 32 * (kk % 2);
    sm90::mma<BR, 0>(acc, sm90::desc(a + (kk / 2) * (BR * 64) + at, 0, 512, sm90::SW64),
                     sm90::desc(b + (kk / 2) * (BR * 64) + at, 0, 512, sm90::SW64));
  }
}

// acc (64 x D, fp32) += A B over the tile's 64 rows: A the bf16 pairs of a
// 64 x 64 accumulator (the register form), B a (64, D) tile read
// N-contiguous through the transpose bit: in flight, not committed.
template <int D>
__device__ __forceinline__ void mma_ab(float (&acc)[D / 2], const uint32_t (&a)[BR / 4],
                                       uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < BR / 16; ++kk)
    sm90::mma_rs<D, 1>(acc, a + 4 * kk, sm90::desc(b + kk * 1024, BR * 64, 512, sm90::SW64));
}

template <int N>
__device__ __forceinline__ void zero(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) r[i] = 0.0f;
}

// A (64, D) fp32 accumulator's rows < L as bf16 pairs at dst (row strides
// `ld`); this thread's rows 16 w + lane / 4 (+ 8) of rows [row0, row0 + 64).
template <int D, bool PAD>
__device__ __forceinline__ void store_rows(const float (&acc)[D / 2], bf16* dst, long long ld,
                                           int row0, int L, int d) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = row0 + 16 * w + (lane >> 2) + 8 * hh;
    if (row >= L) continue;
    bf16* out = dst + row * ld + 2 * (lane & 3);
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      if (!PAD || 8 * j + 2 * (lane & 3) < d)
        *reinterpret_cast<uint32_t*>(out + 8 * j) =
            pack_bf16(acc[4 * j + 2 * hh], acc[4 * j + 2 * hh + 1]);
  }
}

// Blocks an SM holds of each pass at D <= 64, which bounds their registers
// (128 and 168 a thread; left to the compiler, 168 and 202, three blocks
// and two: at ViLT's training shape on an H100 80GB HBM3 at 700 W, 1.24 ms
// a call against 1.58).  Wider heads keep the compiler's choice: their
// accumulators need the registers.
constexpr int dq_blocks(int D) { return D <= 64 ? 4 : 1; }
constexpr int dkv_blocks(int D) { return D <= 64 ? 3 : 1; }

// Pass over queries: dq and the rows' statistics.
template <int D, bool PAD>
__global__ void __launch_bounds__(NT, dq_blocks(D))
attention_bwd_dq(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, const float* __restrict__ bias,
                 const bf16* __restrict__ dout, bf16* __restrict__ dq, float* __restrict__ stats,
                 BwdMap mp) {
  constexpr int TILE = BwdTiles<D>::TILE;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = sm90::smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;  // the swizzle's period
  unsigned char* gbase = smem_raw + (base - raw);
  const uint32_t sq = base, sg = base + TILE;  // Q and dO; then 2 x (K, V)
  float* bias_s = reinterpret_cast<float*>(gbase + 6 * TILE);  // [2][BR]

  const int L = mp.L, n_kt = (L + BR - 1) / BR;
  const int i0 = blockIdx.x * BR, h = blockIdx.y, b = blockIdx.z;
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const bf16* kh = k + b * mp.in.b + h * mp.in.h;
  const bf16* vh = v + b * mp.in.b + h * mp.in.h;
  const float* bh = bias + (long long)b * L;

  // key tile t % n_kt (pass t / n_kt) into buffer t & 1
  auto fetch = [&](int t) {
    const int j0 = (t % n_kt) * BR;
    unsigned char* kb = gbase + (2 + 2 * (t & 1)) * TILE;
    load_rows<D, PAD>(kb, kh, mp.in.l, j0, L, mp.d);
    load_rows<D, PAD>(kb + TILE, vh, mp.in.l, j0, L, mp.d);
    if (threadIdx.x < BR) {
      const int col = j0 + threadIdx.x;
      cp_async4(bias_s + (t & 1) * BR + threadIdx.x, bh + min(col, L - 1), col < L);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };
  load_rows<D, PAD>(gbase, q + b * mp.in.b + h * mp.in.h, mp.in.l, i0, L, mp.d);
  load_rows<D, PAD>(gbase + TILE, dout + b * mp.g.b + h * mp.g.h, mp.g.l, i0, L, mp.d);
  fetch(0);  // commits Q and dO with the first key tile

  // this thread's rows 16 w + lane / 4 (hh = 0) and + 8 (hh = 1); its
  // columns of every 8: 2 (lane % 4) (+ 1); element 4 j + 2 hh + c
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.0f, 0.0f}, pd[2] = {0.0f, 0.0f};
  float delta[2] = {0.0f, 0.0f}, inv_l[2] = {0.0f, 0.0f};
  float acc[D / 2];
  zero(acc);
  for (int t = 0; t < 2 * n_kt; ++t) {
    if (t + 1 < 2 * n_kt) {
      fetch(t + 1);
      asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    }
    // cp.async writes through the generic proxy, wgmma reads through the async one
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    const int j0 = (t % n_kt) * BR;
    const uint32_t kb = base + (2 + 2 * (t & 1)) * TILE, vb = kb + TILE;
    const float* bs = bias_s + (t & 1) * BR + 2 * (lane & 3);

    // S = Q K^T and dP = dO V^T in two commit groups: S is scaled and
    // exponentiated while dP is in flight
    float s[BR / 2], dp[BR / 2];
    zero(s);
    zero(dp);
    sm90::wgmma_fence();
    mma_abt<D>(s, sq, kb);
    sm90::wgmma_commit();
    mma_abt<D>(dp, sg, vb);
    sm90::wgmma_commit();
    sm90::wgmma_wait<1>();
    sm90::fence_regs(s);
#pragma unroll
    for (int j = 0; j < BR / 8; ++j) {
      const float2 bv = *reinterpret_cast<const float2*>(bs + 8 * j);
      const int col = j0 + 8 * j + 2 * (lane & 3);
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int e = 4 * j + 2 * hh;
        s[e] = col < L ? __fmaf_rn(s[e], mp.scale, bv.x) : -INFINITY;
        s[e + 1] = col + 1 < L ? __fmaf_rn(s[e + 1], mp.scale, bv.y) : -INFINITY;
      }
    }

    if (t < n_kt) {
      // pass 1: the row maxima, then l and sum(exp(S - m) dP) rescaled
      float mx[2] = {m[0], m[1]}, sum[2] = {0.0f, 0.0f}, dsum[2] = {0.0f, 0.0f}, alpha[2];
#pragma unroll
      for (int e = 0; e < BR / 2; ++e) mx[(e >> 1) & 1] = fmaxf(mx[(e >> 1) & 1], s[e]);
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 1));
        mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 2));
        alpha[hh] = expf(m[hh] - mx[hh]);  // 0 on the first tile
      }
#pragma unroll
      for (int e = 0; e < BR / 2; ++e) {
        s[e] = __expf(s[e] - mx[(e >> 1) & 1]);
        sum[(e >> 1) & 1] += s[e];
      }
      sm90::wgmma_wait<0>();
      sm90::fence_regs(dp);
#pragma unroll
      for (int e = 0; e < BR / 2; ++e)
        dsum[(e >> 1) & 1] = __fmaf_rn(s[e], round_bf16(dp[e]), dsum[(e >> 1) & 1]);
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        sum[hh] += __shfl_xor_sync(0xffffffffu, sum[hh], 1);
        sum[hh] += __shfl_xor_sync(0xffffffffu, sum[hh], 2);
        dsum[hh] += __shfl_xor_sync(0xffffffffu, dsum[hh], 1);
        dsum[hh] += __shfl_xor_sync(0xffffffffu, dsum[hh], 2);
        l[hh] = l[hh] * alpha[hh] + sum[hh];
        pd[hh] = pd[hh] * alpha[hh] + dsum[hh];
        m[hh] = mx[hh];
      }
      if (t == n_kt - 1) {
        // Delta = rowsum(P dP); the statistics of this thread's rows
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          inv_l[hh] = 1.0f / l[hh];
          delta[hh] = pd[hh] * inv_l[hh];
          const int row = i0 + 16 * w + (lane >> 2) + 8 * hh;
          if ((lane & 3) == 0 && row < L) {
            const long long at = ((long long)b * mp.H + h) * L + row;
            stats[at] = m[hh];
            stats[mp.n_stats + at] = inv_l[hh];
            stats[2 * mp.n_stats + at] = delta[hh];
          }
        }
      }
    } else {
      // pass 2: P, then dS / sqrt(d) = P (dP - Delta) / sqrt(d) in bf16 and
      // dq += dS K
#pragma unroll
      for (int e = 0; e < BR / 2; ++e)
        s[e] = __expf(s[e] - m[(e >> 1) & 1]) * inv_l[(e >> 1) & 1];
      sm90::wgmma_wait<0>();
      sm90::fence_regs(dp);
      uint32_t da[BR / 4];
#pragma unroll
      for (int i = 0; i < BR / 4; ++i) {
        const int hh = i & 1;  // elements 2 i, 2 i + 1: row half (2 i >> 1) & 1
        da[i] = pack_bf16(s[2 * i] * (round_bf16(dp[2 * i]) - delta[hh]) * mp.scale,
                          s[2 * i + 1] * (round_bf16(dp[2 * i + 1]) - delta[hh]) * mp.scale);
      }
      sm90::fence_regs(da);
      sm90::wgmma_fence();
      mma_ab<D>(acc, da, kb);
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::fence_regs(acc);
      sm90::fence_regs(da);
    }
    __syncthreads();  // every warp is done with buffer t & 1
  }
  store_rows<D, PAD>(acc, dq + b * mp.o.b + h * mp.o.h, mp.o.l, i0, L, mp.d);
}

// Pass over keys: dk and dv.
template <int D, bool PAD>
__global__ void __launch_bounds__(NT, dkv_blocks(D))
attention_bwd_dkv(const bf16* __restrict__ q, const bf16* __restrict__ k,
                  const bf16* __restrict__ v, const float* __restrict__ bias,
                  const bf16* __restrict__ dout, bf16* __restrict__ dk, bf16* __restrict__ dv,
                  const float* __restrict__ stats, BwdMap mp) {
  constexpr int TILE = BwdTiles<D>::TILE;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = sm90::smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* gbase = smem_raw + (base - raw);
  const uint32_t sk = base, sv = base + TILE;  // K and V; then 2 x (Q, dO)
  float* stats_s = reinterpret_cast<float*>(gbase + 6 * TILE);  // [2][3][BR]

  const int L = mp.L, n_qt = (L + BR - 1) / BR;
  const int j0 = blockIdx.x * BR, h = blockIdx.y, b = blockIdx.z;
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const bf16* qh = q + b * mp.in.b + h * mp.in.h;
  const bf16* gh = dout + b * mp.g.b + h * mp.g.h;
  const float* st = stats + ((long long)b * mp.H + h) * L;

  // query tile t into buffer t & 1, with its rows' m, 1 / l and Delta
  auto fetch = [&](int t) {
    const int i0 = t * BR;
    unsigned char* qb = gbase + (2 + 2 * (t & 1)) * TILE;
    load_rows<D, PAD>(qb, qh, mp.in.l, i0, L, mp.d);
    load_rows<D, PAD>(qb + TILE, gh, mp.g.l, i0, L, mp.d);
    for (int i = threadIdx.x; i < 3 * BR; i += NT) {
      const int row = i0 + i % BR;
      cp_async4(stats_s + (t & 1) * 3 * BR + i, st + (i / BR) * mp.n_stats + min(row, L - 1),
                row < L);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };
  load_rows<D, PAD>(gbase, k + b * mp.in.b + h * mp.in.h, mp.in.l, j0, L, mp.d);
  load_rows<D, PAD>(gbase + TILE, v + b * mp.in.b + h * mp.in.h, mp.in.l, j0, L, mp.d);
  fetch(0);

  // this thread's keys (rows) and their bias; keys past L get exp = 0
  float kbias[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int key = j0 + 16 * w + (lane >> 2) + 8 * hh;
    kbias[hh] = key < L ? bias[(long long)b * L + key] : -INFINITY;
  }
  float dka[D / 2], dva[D / 2];
  zero(dka);
  zero(dva);
  for (int t = 0; t < n_qt; ++t) {
    if (t + 1 < n_qt) {
      fetch(t + 1);
      asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    const int i0 = t * BR;
    const uint32_t qb = base + (2 + 2 * (t & 1)) * TILE, gb = qb + TILE;
    const float* ss = stats_s + (t & 1) * 3 * BR + 2 * (lane & 3);

    // S^T = K Q^T and dP^T = V dO^T (keys as rows, queries as columns) in
    // two commit groups; dv += P^T dO starts before dP^T is read
    float s[BR / 2], dp[BR / 2];
    zero(s);
    zero(dp);
    sm90::wgmma_fence();
    mma_abt<D>(s, sk, qb);
    sm90::wgmma_commit();
    mma_abt<D>(dp, sv, gb);
    sm90::wgmma_commit();
    sm90::wgmma_wait<1>();
    sm90::fence_regs(s);

    // P^T (0 at queries past L), and its bf16 pairs
    uint32_t pa[BR / 4], da[BR / 4];
#pragma unroll
    for (int j = 0; j < BR / 8; ++j) {
      const float2 mq = *reinterpret_cast<const float2*>(ss + 8 * j);
      const float2 lq = *reinterpret_cast<const float2*>(ss + BR + 8 * j);  // 1 / l
      const int col = i0 + 8 * j + 2 * (lane & 3);
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int e = 4 * j + 2 * hh;
        s[e] = col < L ? __expf(__fmaf_rn(s[e], mp.scale, kbias[hh]) - mq.x) * lq.x : 0.0f;
        s[e + 1] = col + 1 < L ? __expf(__fmaf_rn(s[e + 1], mp.scale, kbias[hh]) - mq.y) * lq.y
                               : 0.0f;
        pa[e >> 1] = pack_bf16(s[e], s[e + 1]);
      }
    }
    sm90::fence_regs(pa);
    sm90::wgmma_fence();
    mma_ab<D>(dva, pa, gb);
    sm90::wgmma_commit();
    sm90::wgmma_wait<1>();  // dP^T (dv may still be in flight)
    sm90::fence_regs(dp);

    // dS^T / sqrt(d) in bf16, dk += dS^T Q
#pragma unroll
    for (int j = 0; j < BR / 8; ++j) {
      const float2 dlt = *reinterpret_cast<const float2*>(ss + 2 * BR + 8 * j);
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int e = 4 * j + 2 * hh;
        da[e >> 1] = pack_bf16(s[e] * (round_bf16(dp[e]) - dlt.x) * mp.scale,
                               s[e + 1] * (round_bf16(dp[e + 1]) - dlt.y) * mp.scale);
      }
    }
    sm90::fence_regs(da);
    sm90::wgmma_fence();
    mma_ab<D>(dka, da, qb);
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::fence_regs(dva);
    sm90::fence_regs(dka);
    sm90::fence_regs(pa);
    sm90::fence_regs(da);
    __syncthreads();  // every warp is done with buffer t & 1
  }
  store_rows<D, PAD>(dka, dk + b * mp.o.b + h * mp.o.h, mp.o.l, j0, L, mp.d);
  store_rows<D, PAD>(dva, dv + b * mp.o.b + h * mp.o.h, mp.o.l, j0, L, mp.d);
}

template <int D, bool PAD = false>
int launch_bwd(const void* q, const void* k, const void* v, const void* bias, const void* dout,
               void* dq, void* dk, void* dv, void* stats, int B, BwdMap mp, cudaStream_t stream) {
  constexpr size_t smem = BwdTiles<D>::smem();
  static bool smem_set = false;  // once per instantiation and library
  cudaError_t e;
  if (!smem_set) {
    if ((e = cudaFuncSetAttribute(attention_bwd_dq<D, PAD>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem)) !=
        cudaSuccess)
      return (int)e;
    if ((e = cudaFuncSetAttribute(attention_bwd_dkv<D, PAD>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem)) !=
        cudaSuccess)
      return (int)e;
    smem_set = true;
  }
  mp.scale = 1.0f / sqrtf((float)mp.d);
  const dim3 grid((mp.L + BR - 1) / BR, mp.H, B);
  const bf16* qb = static_cast<const bf16*>(q);
  const bf16* kb = static_cast<const bf16*>(k);
  const bf16* vb = static_cast<const bf16*>(v);
  const bf16* gb = static_cast<const bf16*>(dout);
  const float* fb = static_cast<const float*>(bias);
  float* sb = static_cast<float*>(stats);
  attention_bwd_dq<D, PAD><<<grid, NT, smem, stream>>>(qb, kb, vb, fb, gb, static_cast<bf16*>(dq),
                                                       sb, mp);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  attention_bwd_dkv<D, PAD><<<grid, NT, smem, stream>>>(
      qb, kb, vb, fb, gb, static_cast<bf16*>(dk), static_cast<bf16*>(dv), sb, mp);
  return (int)cudaGetLastError();
}

}  // namespace

// q, k, v share the strides (sb, sh, sl), dO has (gb, gh, gl), dq, dk and
// dv (ob, oh, ol); all rows contiguous, strides in elements.  stats: 3 B H L
// floats of scratch.  bf16 only; head_dim a multiple of 4 from 8 to 128.
extern "C" int vt_attention_bwd(const void* q, const void* k, const void* v, const void* bias,
                                const void* dout, void* dq, void* dk, void* dv, void* stats,
                                int B, int H, int L, int head_dim, long long sb, long long sh,
                                long long sl, long long gb, long long gh, long long gl,
                                long long ob, long long oh, long long ol, void* stream) {
  if (B <= 0 || H <= 0 || L <= 0 || head_dim < 8 || head_dim > 128 || head_dim % 4 != 0)
    return (int)cudaErrorInvalidValue;
  const BwdMap mp{L, H, head_dim, 0.0f, Strides{sb, sh, sl}, Strides{gb, gh, gl},
                  Strides{ob, oh, ol}, (long long)B * H * L};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 32: return launch_bwd<32>(q, k, v, bias, dout, dq, dk, dv, stats, B, mp, s);
    case 64: return launch_bwd<64>(q, k, v, bias, dout, dq, dk, dv, stats, B, mp, s);
    case 96: return launch_bwd<96>(q, k, v, bias, dout, dq, dk, dv, stats, B, mp, s);
    case 128: return launch_bwd<128>(q, k, v, bias, dout, dq, dk, dv, stats, B, mp, s);
    default: break;
  }
  if (head_dim < 32) return launch_bwd<32, true>(q, k, v, bias, dout, dq, dk, dv, stats, B, mp, s);
  if (head_dim < 64) return launch_bwd<64, true>(q, k, v, bias, dout, dq, dk, dv, stats, B, mp, s);
  if (head_dim < 96) return launch_bwd<96, true>(q, k, v, bias, dout, dq, dk, dv, stats, B, mp, s);
  return launch_bwd<128, true>(q, k, v, bias, dout, dq, dk, dv, stats, B, mp, s);
}
