// The attention kernels shared by the encoder attention (attention.cu) and
// the grouped-query attention of the Llama tower (attention_gqa.cu):
// out = softmax(q k^T / sqrt(d) + bias) v, head dim d any multiple of 4 from
// 8 to 128, the head dims the TPU kernels take.  d = 32, 64, 96 or 128 (32
// BERT-small, 64 BERT-base and -large, ViLT-B/32, TinyLlama, SmolLM, 128
// Llama-2 and Llama-3-8B) run the exact instances, D = d; any other d (100
// OpenLLaMA-3B, 80, 48, 40, 16) a padded one, D = d rounded up to 32, whose
// tiles hold zeros at columns d..D (see "Padded instances" below).
//
// Index map.  q and out have H = G * rep heads, k and v have G.  Query head
// g * rep + i reads K/V head g, so the rep query heads of a group are folded
// into one (rep * L, D) matrix against the group's unrepeated (L, D) keys
// and values, as the TPU kernel folds them: block (x, g, b) owns 64 rows of
// that folded matrix; folded row f is head g * rep + f / L at position
// f % L.  rep = 1 is plain multi-head attention.  The bias is fp32,
// bias[b * bias_b + position * bias_q + key]: bias_q = 0 gives the encoder's
// (B, 1, 1, L) key bias, bias_q = L a full (B, 1, L, L) block added per
// query row (causal and padding).  Masked entries carry a finite fill
// (finfo(float32).min), never -inf: s * scale + fill rounds to the fill, the
// running maximum stays finite, and a row whose keys are all masked gets the
// uniform distribution over its L keys, as the plain composition does.
// Keys past L (the ragged edge) are excluded.
//
// All operands have contiguous rows of D and any batch, head and row
// strides (in elements), so q, k and v can be views into one fused
// projection and out a view of the (B, L, H, D) layout the next product
// reads.  Scores and softmax are fp32.  Two designs, one per element type
// (ops/cuda_attention.py attention_route):
//
// bf16: attention_wgmma, one pass over K and V on the tensor cores.  A block
// is one warpgroup (128 threads) and one tile of 64 folded query rows.  The
// key tiles (KEYS = 64 keys) stream through a ring of shared-memory stages
// by TMA (one 4-d tensor map per operand over (D, L, G, B), so head views
// into the fused projection load as they are), each stage's K and V on
// their own mbarrier.  The encoder's key bias goes with them: the tile's
// KEYS floats into a slot of the stage, one 4-byte cp.async a key by the
// first KEYS threads, complete at the __syncthreads that ends the tile
// before its use, so each tile's bias is read once a block at any L.  (A
// full bias, GQA's, has a row per query: each thread reads its own scores'
// values from global memory, in 8-byte pairs where they are aligned.)  Per
// key tile:
//   * S = Q K^T by wgmma m64n64k16, Q (loaded once by cp.async, which the
//     fold's rows spanning heads need) and K from shared memory; S stays in
//     the accumulator registers: scale, bias, row max, exp and row sum run
//     on the fragment, the row reductions over the four threads of a row by
//     shuffles.
//   * P = exp(S - max), cast to bf16 in registers: the accumulator pairs of
//     a 64 x 16 slice are the A operand of the next k16 step, so
//     O += P V is wgmma m64nDk16 with A from registers and V from shared
//     memory through the descriptor's transpose bit (V's rows have D
//     contiguous: N-major).
//   * Softmax order: when the whole key row is one tile (L <= 64: BERT, the
//     Llama tower) p is normalised before the cast, as the reference does;
//     at longer L the online form: O is rescaled when a row's maximum moves
//     and divided by the row sum once at the end.
// The output leaves the O accumulators as bf16 pairs, 4-byte stores into
// the (B, L, H, D) layout.  Tiles in shared memory are D / 32 blocks of
// (rows, 32 columns) under the 64-byte swizzle, one layout for every head
// dim.  Small blocks fill the card: 42.5 KB of shared memory and 96
// registers a thread at D = 64, five blocks a SM.  No float atomics and a
// fixed order of every sum: repeats are bit-equal.
//
// fp32: attention_fma, plain FMA in full fp32 (tf32 would not keep the 1e-4
// limit), the design of the first port: 4 warps of 16 query rows, the key
// tiles double-buffered by cp.async, pass 1 for the row max and sum, pass 2
// recomputes each score tile, normalises before P V.
//
// Padded instances (PAD; d < D, the Map's d).  A head of d bf16 columns
// need not start on 16 bytes (100 columns are 200 bytes), and TMA takes
// only 16-byte strides, so these load K and V like Q, by cp.async of 8
// bytes (4 columns) into the same swizzled tiles, zeros at columns d..D and
// keys past L, each tile waited for and fenced to the async proxy before
// the __syncthreads that ends the tile before its use (no mbarriers); fp32
// takes 16-byte copies of 4 columns as before.  The zero columns add exact
// zeros to every score (Q's and K's) and leave the output columns d..D zero
// (V's), which are never stored; the scale is 1 / sqrt(d).  The exact
// instances keep their code.
#pragma once

#include <math.h>

#include "common.cuh"
#include "gemm_sm90.cuh"

namespace {

constexpr int BQ = 64;   // folded query rows per block
constexpr int NT = 128;  // threads per block: one warpgroup

// Element strides of a (B, heads, L, D) operand whose rows are contiguous.
struct Strides { long long b, h, l; };

// The index map of one launch (see the head of this file).
struct Map {
  int L, rep;
  Strides q, k, v, o;
  long long bias_b, bias_q;
  float scale;  // 1 / sqrt(d)
  int d;        // the head dim (<= the instance's D)
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = valid ? 16 : 0;  // 0: fill the 16 bytes with zeros
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem), "r"(n));
}

// The folded row f's head and position (rows past rep * L: position 0 of
// the group's first head, read and never stored).
__device__ __forceinline__ void fold(const Map& mp, int g, int f, int& head, int& pos) {
  const bool ok = f < mp.rep * mp.L;
  head = g * mp.rep + (ok ? f / mp.L : 0);
  pos = ok ? f % mp.L : 0;
}

// ============================================================ bf16: wgmma

using sm90::bf16;

// The key tile and the deepest ring of stages (timed against 128 keys
// and 3 stages: scripts/torch_attention_tiles.py, PERF.md).  Two 64-key
// stages keep five blocks a SM; wider or deeper, fewer fit.
constexpr int KEYS = 64;
constexpr int MAX_STAGES = 2;
static_assert(KEYS == 64 || KEYS == 128, "key tiles with a wgmma wrapper for S: 64, 128");

// The shared memory of one block: the Q tile, `stages` stages of a K and a
// V tile, a key-bias slot per stage, then a full mbarrier per K and per V
// tile.  Each tile is D / 32 blocks of (rows, 32) bf16, 64-byte rows under
// the 64-byte swizzle (16-byte piece c of row r at r * 64 + (c ^ (r / 2 %
// 4)) * 16).
template <int D>
struct Tiles {
  static_assert(D % 32 == 0, "tiles of 32 columns");
  static constexpr int Q_BYTES = BQ * D * 2;
  static constexpr int KV_BYTES = KEYS * D * 2;  // one K or V tile
  static constexpr int STAGE = 2 * KV_BYTES;
  static constexpr int BIAS_BYTES = KEYS * 4;    // one key-bias slot
  static constexpr size_t smem(int stages) {
    return 1024 + Q_BYTES + (size_t)stages * (STAGE + BIAS_BYTES + 16);
  }
};

// Which coordinate of a K or V tensor map each of L, G, B is (1, 2 or 3).
struct Coords { int l, g, b; };

__device__ __forceinline__ int coord(const Coords& at, int i, int key0, int g, int b) {
  return at.l == i ? key0 : at.g == i ? g : b;
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = valid ? 4 : 0;  // 0: a zero
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(gmem), "r"(n));
}

__device__ __forceinline__ void cp_async8(void* smem, const void* gmem, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = valid ? 8 : 0;  // 0: eight zero bytes
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(s), "l"(gmem), "r"(n));
}

// The byte offset of column col (a multiple of 4) of row r in a swizzled
// tile of `rows` rows (see Tiles).
__device__ __forceinline__ int swizzled(int r, int col, int rows) {
  return (col / 32) * (rows * 64) + r * 64 + ((((col % 32) / 8) ^ ((r >> 1) & 3)) << 4) +
         (col % 8) * 2;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// k, v: read by the padded instances (PAD) only, the exact ones take tk, tv.
template <int D, bool PAD = false>
__global__ void __launch_bounds__(NT)
attention_wgmma(const bf16* __restrict__ q, const bf16* __restrict__ k,
                const bf16* __restrict__ v, const __grid_constant__ CUtensorMap tk,
                const __grid_constant__ CUtensorMap tv, const float* __restrict__ bias,
                bf16* __restrict__ out, Map mp, Coords ck, Coords cv, int stages) {
  using T = Tiles<D>;
  constexpr int CH = D / 32;  // 32-column blocks of a tile
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = sm90::smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;  // the swizzle's period
  unsigned char* gbase = smem_raw + (base - raw);
  const uint32_t sq = base, skv = base + T::Q_BYTES;
  const uint32_t sbias = skv + stages * T::STAGE;        // key bias [stages][KEYS]
  const uint32_t bars = sbias + stages * T::BIAS_BYTES;  // full K[stages], then full V[stages]
  float* bias_s = reinterpret_cast<float*>(gbase + (sbias - base));

  const int L = mp.L, n_rows = mp.rep * L, n_kt = (L + KEYS - 1) / KEYS;
  const int f0 = blockIdx.x * BQ, g = blockIdx.y, b = blockIdx.z;
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const bool key_bias = mp.bias_q == 0;  // one bias row for every query

  // K and V of key tile t into stage t % stages
  auto fetch_tile = [&](int t) {
    const int s = t % stages, key0 = t * KEYS;
    const uint32_t kb = skv + s * T::STAGE, vb = kb + T::KV_BYTES;
    const uint32_t fk = bars + 8 * s, fv = bars + 8 * (stages + s);
    sm90::mbar_expect_tx(fk, T::KV_BYTES);
#pragma unroll
    for (int c = 0; c < CH; ++c)
      sm90::tma_load(kb + c * KEYS * 64, &tk, 32 * c, coord(ck, 1, key0, g, b),
                     coord(ck, 2, key0, g, b), coord(ck, 3, key0, g, b), fk);
    sm90::mbar_expect_tx(fv, T::KV_BYTES);
#pragma unroll
    for (int c = 0; c < CH; ++c)
      sm90::tma_load(vb + c * KEYS * 64, &tv, 32 * c, coord(cv, 1, key0, g, b),
                     coord(cv, 2, key0, g, b), coord(cv, 3, key0, g, b), fv);
  };
  // PAD: K and V of key tile t into stage t % stages by cp.async, every
  // thread a share (zeros at columns >= d and keys >= L)
  auto copy_tile = [&](int t) {
    unsigned char* kb = gbase + (skv - base) + (t % stages) * T::STAGE;
    const bf16* kh = k + b * mp.k.b + g * mp.k.h;
    const bf16* vh = v + b * mp.v.b + g * mp.v.h;
    for (int i = threadIdx.x; i < KEYS * D / 4; i += NT) {
      const int r = i / (D / 4), col = 4 * (i % (D / 4)), key = t * KEYS + r;
      const bool ok = key < L && col < mp.d;
      const int at = swizzled(r, col, KEYS);
      cp_async8(kb + at, ok ? kh + key * mp.k.l + col : kh, ok);
      cp_async8(kb + T::KV_BYTES + at, ok ? vh + key * mp.v.l + col : vh, ok);
    }
  };
  // the key bias of tile t into its stage's slot (zeros past L)
  auto fetch_bias = [&](int t) {
    if (!key_bias || threadIdx.x >= KEYS) return;
    const int col = t * KEYS + threadIdx.x;
    cp_async4(bias_s + (t % stages) * KEYS + threadIdx.x, bias + b * mp.bias_b + min(col, L - 1),
              col < L);
  };
  if (threadIdx.x == 0) {
    for (int s = 0; s < 2 * stages; ++s) sm90::mbar_init(bars + 8 * s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    if constexpr (!PAD)
      for (int t = 0; t < stages && t < n_kt; ++t) fetch_tile(t);
  }
  if constexpr (PAD)
    for (int t = 0; t < stages && t < n_kt; ++t) copy_tile(t);
  for (int t = 0; t < stages && t < n_kt; ++t) fetch_bias(t);
  // Q: 64 folded rows, 16-byte pieces into the swizzled blocks (PAD: 8-byte
  // pieces, zeros at columns >= d); rows past rep * L are zero (the wait
  // covers the first tiles' key bias, and PAD their K and V, too)
  const bf16* qb = q + b * mp.q.b;
  if constexpr (PAD) {
    for (int i = threadIdx.x; i < BQ * D / 4; i += NT) {
      const int r = i / (D / 4), col = 4 * (i % (D / 4));
      int head, pos;
      fold(mp, g, f0 + r, head, pos);
      const bool ok = f0 + r < n_rows && col < mp.d;
      cp_async8(gbase + swizzled(r, col, BQ), ok ? qb + head * mp.q.h + pos * mp.q.l + col : qb,
                ok);
    }
  } else {
    for (int i = threadIdx.x; i < BQ * D / 8; i += NT) {
      const int r = i / (D / 8), p = i % (D / 8);
      int head, pos;
      fold(mp, g, f0 + r, head, pos);
      const bf16* src = qb + head * mp.q.h + pos * mp.q.l + 8 * p;
      cp_async16(gbase + (p / 4) * (BQ * 64) + r * 64 + (((p % 4) ^ ((r >> 1) & 3)) << 4), src,
                 f0 + r < n_rows);
    }
  }
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
  // cp.async writes through the generic proxy, wgmma reads through the async one
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();

  // this thread's rows of the tile: 16 w + lane / 4 (h = 0) and + 8 (h = 1);
  // its columns of every 8: 2 (lane % 4) (+ 1)
  const float* brow[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    int head, pos;
    fold(mp, g, f0 + 16 * w + (lane >> 2) + 8 * h, head, pos);
    brow[h] = bias + b * mp.bias_b + pos * mp.bias_q;
  }
  // a full bias in 8-byte pairs: every row and pair starts on 8 bytes
  const bool pairs = L % 2 == 0 && (reinterpret_cast<uintptr_t>(bias) & 7) == 0;
  float o[D / 2];
#pragma unroll
  for (int e = 0; e < D / 2; ++e) o[e] = 0.0f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.0f, 0.0f};

  for (int t = 0; t < n_kt; ++t) {
    const int s = t % stages, key0 = t * KEYS;
    const uint32_t ph = (t / stages) & 1;
    const uint32_t kb = skv + s * T::STAGE, vb = kb + T::KV_BYTES;

    // S = Q K^T: K-contiguous A and B, a k16 step 32 bytes into a block
    float sc[KEYS / 2];
#pragma unroll
    for (int e = 0; e < KEYS / 2; ++e) sc[e] = 0.0f;
    if constexpr (!PAD) sm90::mbar_wait(bars + 8 * s, ph);
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t at = 32 * (kk % 2);
      sm90::mma<KEYS, 0>(sc, sm90::desc(sq + (kk / 2) * (BQ * 64) + at, 0, 512, sm90::SW64),
                         sm90::desc(kb + (kk / 2) * (KEYS * 64) + at, 0, 512, sm90::SW64));
    }
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::fence_regs(sc);

    // scale and bias (keys past L excluded), the tile's row maxima
    float mx[2] = {m[0], m[1]};
    auto add_bias = [&](int h, int j, float2 bv) {
      const int e = 4 * j + 2 * h, col = key0 + 8 * j + 2 * (lane & 3);
      sc[e] = col < L ? __fmaf_rn(sc[e], mp.scale, bv.x) : -INFINITY;
      sc[e + 1] = col + 1 < L ? __fmaf_rn(sc[e + 1], mp.scale, bv.y) : -INFINITY;
      mx[h] = fmaxf(mx[h], fmaxf(sc[e], sc[e + 1]));
    };
    if (key_bias) {
      // one pair of the stage's key bias serves both rows
      const float* sb = bias_s + s * KEYS + 2 * (lane & 3);
#pragma unroll
      for (int j = 0; j < KEYS / 8; ++j) {
        const float2 bv = *reinterpret_cast<const float2*>(sb + 8 * j);
        add_bias(0, j, bv);
        add_bias(1, j, bv);
      }
    } else {
#pragma unroll
      for (int j = 0; j < KEYS / 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int col = key0 + 8 * j + 2 * (lane & 3);
          add_bias(h, j, pairs ? __ldg(reinterpret_cast<const float2*>(brow[h] + min(col, L - 2)))
                               : make_float2(__ldg(brow[h] + min(col, L - 1)),
                                             __ldg(brow[h] + min(col + 1, L - 1))));
        }
    }
    float sum[2] = {0.0f, 0.0f}, alpha[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      alpha[h] = expf(m[h] - mx[h]);  // 0 on the first tile
    }
#pragma unroll
    for (int j = 0; j < KEYS / 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int e = 4 * j + 2 * h + c;
          sc[e] = __expf(sc[e] - mx[h]);
          sum[h] += sc[e];
        }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 1);
      sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 2);
      l[h] = l[h] * alpha[h] + sum[h];
      m[h] = mx[h];
    }
    if (n_kt == 1) {
      // the whole row in this tile: normalise before the cast
      const float inv[2] = {1.0f / l[0], 1.0f / l[1]};
#pragma unroll
      for (int e = 0; e < KEYS / 2; ++e) sc[e] *= inv[(e >> 1) & 1];
    } else {
#pragma unroll
      for (int e = 0; e < D / 2; ++e) o[e] *= alpha[(e >> 1) & 1];
    }
    // P in bf16: the accumulator pairs of columns [16 kk, 16 kk + 16) are
    // the A fragment of k16 step kk
    uint32_t pa[KEYS / 4];
#pragma unroll
    for (int i = 0; i < KEYS / 4; ++i) pa[i] = pack_bf16(sc[2 * i], sc[2 * i + 1]);

    // O += P V: V N-contiguous (transpose bit), a k16 step 16 rows
    if constexpr (!PAD) sm90::mbar_wait(bars + 8 * (stages + s), ph);
    sm90::fence_regs(pa);
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KEYS / 16; ++kk)
      sm90::mma_rs<D, 1>(o, pa + 4 * kk, sm90::desc(vb + kk * 1024, KEYS * 64, 512, sm90::SW64));
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::fence_regs(o);
    sm90::fence_regs(pa);

    if (t + 1 < n_kt) {
      // every warp is done with stage s, and the key bias of tile t + 1
      // (fetched a tile or more ago; PAD: its K and V too) is complete and
      // visible
      asm volatile("cp.async.wait_all;\n" ::: "memory");
      if constexpr (PAD) asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      __syncthreads();
      if (t + stages < n_kt) {
        if constexpr (PAD) copy_tile(t + stages);
        else if (threadIdx.x == 0) fetch_tile(t + stages);
        fetch_bias(t + stages);
      }
    }
  }

  // O (divided by the row sum where it was not normalised) as bf16 pairs
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int f = f0 + 16 * w + (lane >> 2) + 8 * h;
    if (f >= n_rows) continue;
    int head, pos;
    fold(mp, g, f, head, pos);
    const float inv = n_kt == 1 ? 1.0f : 1.0f / l[h];
    bf16* dst = out + b * mp.o.b + head * mp.o.h + pos * mp.o.l + 2 * (lane & 3);
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      if (!PAD || 8 * j + 2 * (lane & 3) < mp.d)
        *reinterpret_cast<uint32_t*>(dst + 8 * j) =
            pack_bf16(o[4 * j + 2 * h] * inv, o[4 * j + 2 * h + 1] * inv);
  }
}

// The tensor map of one K or V operand: (D, then L, G, B in the order of
// their strides), boxes of 32 columns by `bk` rows under the 64-byte
// swizzle; `at` gets the coordinate of each of L, G, B.
inline cudaError_t kv_map(CUtensorMap* map, Coords* at, const void* ptr, const Strides& st,
                          int D, int L, int G, int B, int bk) {
  struct Dim { long long stride; int size, which; } d[3] = {{st.l, L, 0}, {st.h, G, 1}, {st.b, B, 2}};
  for (int i = 1; i < 3; ++i)
    for (int j = i; j > 0 && d[j].stride < d[j - 1].stride; --j) {
      const Dim x = d[j];
      d[j] = d[j - 1], d[j - 1] = x;
    }
  cuuint64_t dims[4] = {(cuuint64_t)D}, strides[3];
  cuuint32_t box[4] = {32, 1, 1, 1};
  int* pos[3] = {&at->l, &at->g, &at->b};
  for (int i = 0; i < 3; ++i) {
    if (d[i].stride <= 0) return cudaErrorInvalidValue;
    dims[i + 1] = (cuuint64_t)d[i].size;
    strides[i] = (cuuint64_t)d[i].stride * sizeof(bf16);
    *pos[d[i].which] = i + 1;
    if (d[i].which == 0) box[i + 1] = (cuuint32_t)bk;
  }
  return sm90::make_map_nd(map, ptr, 4, dims, strides, box, CU_TENSOR_MAP_SWIZZLE_64B);
}

template <int D, bool PAD = false>
int launch_wgmma(const void* q, const void* k, const void* v, const void* bias, void* out, int B,
                 int G, const Map& mp, cudaStream_t stream) {
  using T = Tiles<D>;
  CUtensorMap tk{}, tv{};
  Coords ck{}, cv{};
  cudaError_t e;
  if constexpr (!PAD) {
    if ((e = kv_map(&tk, &ck, k, mp.k, D, mp.L, G, B, KEYS)) != cudaSuccess) return (int)e;
    if ((e = kv_map(&tv, &cv, v, mp.v, D, mp.L, G, B, KEYS)) != cudaSuccess) return (int)e;
  }
  // as many stages as there are key tiles, up to MAX_STAGES
  const int n_kt = (mp.L + KEYS - 1) / KEYS;
  const int stages = n_kt < MAX_STAGES ? n_kt : MAX_STAGES;
  static bool smem_set = false;  // once per instantiation and library
  if (!smem_set) {
    if ((e = cudaFuncSetAttribute(attention_wgmma<D, PAD>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)T::smem(MAX_STAGES))) != cudaSuccess)
      return (int)e;
    smem_set = true;
  }
  const dim3 grid((mp.rep * mp.L + BQ - 1) / BQ, G, B);
  attention_wgmma<D, PAD><<<grid, NT, T::smem(stages), stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v), tk,
      tv, static_cast<const float*>(bias), static_cast<bf16*>(out), mp, ck, cv, stages);
  return (int)cudaGetLastError();
}

// ============================================================= fp32: FMA

constexpr int FBK = 64;  // keys per tile

// Row strides in shared memory, padded by 16 bytes against bank conflicts:
// the Q, K and V tiles (D wide), the probability tile (FBK wide), and the
// tile that holds the scores (FBK wide) and then the output (D wide).
template <int D> struct Lds { static constexpr int v = D + 4; };
constexpr int LDP = FBK + 4;
template <int D> struct Ldf { static constexpr int v = (D > FBK ? D : FBK) + 4; };

// Rows [row0, row0 + 64) of one K/V head's (L, D) matrix (rows `ld` elements
// apart) into a (64, D) tile, asynchronously; rows past L are zero (PAD:
// columns from d on too).
template <int D, bool PAD>
__device__ void load_tile(float* dst, const float* src, long long ld, int row0, int L, int d) {
  constexpr int PER_ROW = D / 4, LD = Lds<D>::v;
  for (int c = threadIdx.x; c < 64 * PER_ROW; c += NT) {
    const int r = c / PER_ROW, col = (c % PER_ROW) * 4;
    const bool ok = row0 + r < L && (!PAD || col < d);
    cp_async16(dst + r * LD + col, ok ? src + (row0 + r) * ld + col : src, ok);
  }
}

// Folded query rows [f0, f0 + 64) of group g (`src` at the batch row's
// first head) into a (64, D) tile; rows past rep * L are zero (PAD: columns
// from d on too).
template <int D, bool PAD>
__device__ void load_q_tile(float* dst, const float* src, const Map& mp, int g, int f0) {
  constexpr int PER_ROW = D / 4, LD = Lds<D>::v;
  for (int c = threadIdx.x; c < 64 * PER_ROW; c += NT) {
    const int r = c / PER_ROW, col = (c % PER_ROW) * 4, f = f0 + r;
    const bool ok = f < mp.rep * mp.L && (!PAD || col < mp.d);
    const float* row = src + (g * mp.rep + f / mp.L) * mp.q.h + (f % mp.L) * mp.q.l + col;
    cp_async16(dst + r * LD + col, ok ? row : src, ok);
  }
}

// Each thread computes its own 32 scores (row tid/2, columns 2 j + (tid & 1)).
template <int D>
__device__ void score_tile(const float* qs, const float* ks, float* s) {
  constexpr int LD = Lds<D>::v, LDS = Ldf<D>::v;
  const int r = threadIdx.x >> 1, half = threadIdx.x & 1;
  float acc[32];
#pragma unroll
  for (int j = 0; j < 32; ++j) acc[j] = 0.0f;
  for (int d = 0; d < D; ++d) {
    const float qv = qs[r * LD + d];
#pragma unroll
    for (int j = 0; j < 32; ++j) acc[j] = fmaf(qv, ks[(2 * j + half) * LD + d], acc[j]);
  }
#pragma unroll
  for (int j = 0; j < 32; ++j) s[r * LDS + 2 * j + half] = acc[j];
}

// Each thread owns D/2 outputs (row tid/2, columns (tid&1)*D/2 + c).
template <int D>
struct AccF32 {
  static constexpr int LD = Lds<D>::v;
  float o[D / 2];
  __device__ void zero() {
#pragma unroll
    for (int c = 0; c < D / 2; ++c) o[c] = 0.0f;
  }
  __device__ void add_pv(const float* ps, const float* vs) {
    const int r = threadIdx.x >> 1, c0 = (threadIdx.x & 1) * (D / 2);
    for (int j = 0; j < FBK; ++j) {
      const float p = ps[r * LDP + j];
#pragma unroll
      for (int c = 0; c < D / 2; ++c) o[c] = fmaf(p, vs[j * LD + c0 + c], o[c]);
    }
  }
  __device__ void store(float* out) {
    const int r = threadIdx.x >> 1, c0 = (threadIdx.x & 1) * (D / 2);
#pragma unroll
    for (int c = 0; c < D / 2; ++c) out[r * Ldf<D>::v + c0 + c] = o[c];
  }
};

template <int D>
constexpr size_t fma_smem_bytes() {
  // scores / output + Q + 2 x (K, V) + P
  return (size_t)BQ * Ldf<D>::v * 4 + (size_t)(BQ + 4 * FBK) * Lds<D>::v * 4 + (size_t)BQ * LDP * 4;
}

template <int D, bool PAD = false>
__global__ void __launch_bounds__(NT)
attention_fma(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, const float* __restrict__ bias,
              float* __restrict__ out, Map mp) {
  constexpr int LD = Lds<D>::v, LDS = Ldf<D>::v;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  float* s = reinterpret_cast<float*>(smem_raw);  // (BQ, LDS) scores, then output
  float* qs = s + BQ * LDS;                        // (BQ, LD)
  float* kv = qs + BQ * LD;                        // 2 buffers x (K, V) x (FBK, LD)
  float* ps = kv + 4 * FBK * LD;                   // (BQ, LDP) probabilities

  const int L = mp.L;
  const int f0 = blockIdx.x * BQ, g = blockIdx.y, b = blockIdx.z;
  const float* kg = k + b * mp.k.b + g * mp.k.h;  // the group's keys and values
  const float* vg = v + b * mp.v.b + g * mp.v.h;
  // Row ops: thread tid owns row tid/2 of the tile, columns 2 j + (tid&1).
  // Row tid/2 lies in warp tid/32's 16-row strip, so a warp only ever reads
  // the scores it wrote itself and __syncwarp suffices between the two.
  const int r = threadIdx.x >> 1, half = threadIdx.x & 1;
  const int f = f0 + r;                      // this thread's folded row
  const bool row_ok = f < mp.rep * L;
  const int head = g * mp.rep + f / L, pos = f % L;
  const float* brow = bias + b * mp.bias_b + (row_ok ? pos * mp.bias_q : 0);
  const int n_kt = (L + FBK - 1) / FBK;

  // The key tiles stream twice, K alone for pass 1, then K and V for pass
  // 2; tile t + 1 loads (cp.async) while tile t is in use.
  auto fetch = [&](int t) {
    float* dst = kv + (t & 1) * 2 * FBK * LD;
    const int kt = t < n_kt ? t : t - n_kt;
    load_tile<D, PAD>(dst, kg, mp.k.l, kt * FBK, L, mp.d);
    if (t >= n_kt) load_tile<D, PAD>(dst + FBK * LD, vg, mp.v.l, kt * FBK, L, mp.d);
    asm volatile("cp.async.commit_group;\n" ::);
  };
  load_q_tile<D, PAD>(qs, q + b * mp.q.b, mp, g, f0);
  fetch(0);

  float m = -INFINITY, l = 0.0f;
  AccF32<D> acc;
  acc.zero();
  for (int t = 0; t < 2 * n_kt; ++t) {
    if (t + 1 < 2 * n_kt) {
      fetch(t + 1);
      asm volatile("cp.async.wait_group 1;\n" ::);
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::);
    }
    __syncthreads();  // tile t (and Q) visible to every warp
    const float* ks = kv + (t & 1) * 2 * FBK * LD;
    const int kt = t < n_kt ? t : t - n_kt;
    score_tile<D>(qs, ks, s);
    __syncwarp();
    if (t < n_kt) {
      // Pass 1: row max and sum of exp(s - max), online over the key tiles.
      float sv[32];
      float tmax = -INFINITY;
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        const int c = 2 * j + half, col = kt * FBK + c;
        sv[j] = col < L ? __fmaf_rn(s[r * LDS + c], mp.scale, brow[col]) : -INFINITY;
        tmax = fmaxf(tmax, sv[j]);
      }
      tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 1));
      const float mn = fmaxf(m, tmax);
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < 32; ++j) sum += __expf(sv[j] - mn);
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      l = l * expf(m - mn) + sum;
      m = mn;
    } else {
      // Pass 2: p = exp(s - max) / sum, O += P V.
      const float inv_l = 1.0f / l;
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        const int c = 2 * j + half, col = kt * FBK + c;
        ps[r * LDP + c] = col < L
            ? __expf(__fmaf_rn(s[r * LDS + c], mp.scale, brow[col]) - m) * inv_l
            : 0.0f;
      }
      __syncwarp();
      acc.add_pv(ps, ks + FBK * LD);
    }
    __syncthreads();  // every warp is done with buffer t & 1
  }
  acc.store(s);  // each warp its own strip of the (BQ, D) staging
  __syncwarp();
  if (row_ok) {
    const int c0 = half * (D / 2);
    float* dst = out + b * mp.o.b + head * mp.o.h + pos * mp.o.l + c0;
#pragma unroll
    for (int c = 0; c < D / 2; ++c)
      if (!PAD || c0 + c < mp.d) dst[c] = s[r * LDS + c0 + c];
  }
}

template <int D, bool PAD = false>
int launch_fma(const void* q, const void* k, const void* v, const void* bias, void* out, int B,
               int G, const Map& mp, cudaStream_t stream) {
  constexpr size_t smem = fma_smem_bytes<D>();
  static bool smem_set = false;  // once per instantiation and library
  if (!smem_set) {
    const cudaError_t e = cudaFuncSetAttribute(attention_fma<D, PAD>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               (int)smem);
    if (e != cudaSuccess) return (int)e;
    smem_set = true;
  }
  const dim3 grid((mp.rep * mp.L + BQ - 1) / BQ, G, B);
  attention_fma<D, PAD><<<grid, NT, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(bias), static_cast<float*>(out), mp);
  return (int)cudaGetLastError();
}

// ================================================================ dispatch

// B batch rows, G K/V heads, G * mp.rep query heads; dtype a vt::Dtype;
// PAD: head dim mp.d < D.
template <int D, bool PAD = false>
int launch_attention(const void* q, const void* k, const void* v, const void* bias, void* out,
                     int B, int G, Map mp, int dtype, cudaStream_t stream) {
  if (B <= 0 || G <= 0 || mp.L <= 0 || mp.rep <= 0) return (int)cudaErrorInvalidValue;
  mp.scale = 1.0f / sqrtf((float)(PAD ? mp.d : D));
  if (dtype == vt::kBF16)
    return launch_wgmma<D, PAD>(q, k, v, bias, out, B, G, mp, stream);
  if (dtype == vt::kF32) return launch_fma<D, PAD>(q, k, v, bias, out, B, G, mp, stream);
  return (int)cudaErrorInvalidValue;
}

// launch_attention at a run-time head dim, a multiple of 4 from 8 to 128:
// the exact instance at 32, 64, 96 and 128, else the padded one of the
// next of them.
inline int launch_attention_d(int head_dim, const void* q, const void* k, const void* v,
                              const void* bias, void* out, int B, int G, Map mp, int dtype,
                              cudaStream_t stream) {
  mp.d = head_dim;
  switch (head_dim) {
    case 32: return launch_attention<32>(q, k, v, bias, out, B, G, mp, dtype, stream);
    case 64: return launch_attention<64>(q, k, v, bias, out, B, G, mp, dtype, stream);
    case 96: return launch_attention<96>(q, k, v, bias, out, B, G, mp, dtype, stream);
    case 128: return launch_attention<128>(q, k, v, bias, out, B, G, mp, dtype, stream);
    default: break;
  }
  if (head_dim < 8 || head_dim > 128 || head_dim % 4 != 0) return (int)cudaErrorInvalidValue;
  if (head_dim < 32) return launch_attention<32, true>(q, k, v, bias, out, B, G, mp, dtype, stream);
  if (head_dim < 64) return launch_attention<64, true>(q, k, v, bias, out, B, G, mp, dtype, stream);
  if (head_dim < 96) return launch_attention<96, true>(q, k, v, bias, out, B, G, mp, dtype, stream);
  return launch_attention<128, true>(q, k, v, bias, out, B, G, mp, dtype, stream);
}

}  // namespace
