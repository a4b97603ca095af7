// The routed experts of a mixture-of-experts layer (DeepSeek-V3, as
// Moonlight-16B-A3B runs it): every expert's SwiGLU over the rows routed to
// it, all the experts in one launch of each product.
//
// It replaces no kernel of the JAX package, which has no routed experts:
// the port's own, for the MoE layers of models/deepseek.py (ops/moe.py,
// ops/cuda_moe.py).  Two launches a call:
//
//   a[r]   = bf16(silu(x[r] Wg_e^T) * (x[r] Wu_e^T))   (R, I)
//   out[r] = bf16(w[r] * (a[r] Wd_e^T))                (R, H)
//
// for r in expert e's run [off[e], off[e + 1]) of the routed rows x (R, H),
// grouped by expert (ops/moe.py dispatch).  Weights as HF holds them,
// (out, in), so every B operand is K-contiguous: Wg, Wu (E, I, H), Wd
// (E, H, I), each read through a 3-d tensor map (k, out column, expert) whose
// boxes never cross into the next expert.  The rows come through a 2-d map
// over x (or a) at row off[e] + 128 t: a tile may read rows of the next
// expert (or zeros past R), whose products are computed and never stored.
//
// Offsets on the device.  The host never reads them: the grid is sized for
// the worst case, sum_e ceil(rows_e / 128) <= ceil(R / 128) + E row tiles,
// and each block reads the offsets into shared memory and walks the work
// items (row tile, column tile), columns fastest, that exist; the rest of
// the grid exits.  Row tile t belongs to the expert e whose tiles start at
// start[e] <= t < start[e + 1] (a binary search over the E + 1 starts).  No
// row is dropped and no capacity is set.  No atomics: each output element is
// written by one thread, so two calls give the same bits.
//
// The block is the core's (gemm_sm90.cuh): a 128 x 128 output tile, 384
// threads, a producer warpgroup issuing TMA loads into a ring of stages
// (128-byte swizzle) and two consumer warpgroups of 64 rows each running
// m64n128k16 wgmma; the gate and up products share each stage's A tile
// (the core's DUAL_A form in bf16), so their epilogue holds g and u of an
// element in one thread.  A tile's fp32 sums never leave the registers.
//
// What bounds it on the H100: 6 R H I operations at 989 TFLOP/s against
// every held expert's weights (3 E H I bf16), x, out and the intermediate
// (written and read) at 3.35 TB/s.  At Moonlight's widths (H 2,048, I
// 1,408, E 64) and a batch of 10,240 tokens, 6 a token (R 61,440): 1.06
// TFLOP against 1.96 GB, 543 operations a byte, above the card's ridge of
// about 295: the products, 1.07 ms a layer at the peak.
#include "common.cuh"
#include "gemm_sm90.cuh"

namespace {

using sm90::bf16;
using sm90::BK;
using sm90::BM;
using sm90::ROW_BYTES;
using sm90::THREADS;

constexpr int BN = 128;            // output columns of a tile
constexpr int MAX_EXPERTS = 256;   // offsets and tile starts in shared memory

template <bool DUAL>
struct GroupShape {
  static constexpr int A_BYTES = BM * ROW_BYTES;  // 16 KB
  static constexpr int B_BYTES = BN * ROW_BYTES;  // 16 KB
  static constexpr int STAGE = A_BYTES + (DUAL ? 2 : 1) * B_BYTES;
  static constexpr int STAGES = (200 * 1024) / STAGE < 6 ? (200 * 1024) / STAGE : 6;
  static constexpr int TABLE = 2 * (MAX_EXPERTS + 1) * 4;
  static constexpr size_t SMEM = (size_t)STAGES * STAGE + 1024 + 2 * STAGES * 8 + TABLE;
  static_assert(STAGES >= 2, "stages");
};

// The expert of row tile t: the last e with start[e] <= t.  An expert with
// no rows starts where the next does and is passed over; the one found has
// start[e] <= t < start[e + 1].
__device__ __forceinline__ int expert_of(const int* start, int E, int t) {
  int lo = 0, hi = E - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (start[mid] <= t) lo = mid;
    else hi = mid - 1;
  }
  return lo;
}

// A row tile's origin and its expert's end: (e, m0, m_end).
__device__ __forceinline__ void tile_rows(const int* off, const int* start, int E, int rt,
                                          int& e, int& m0, int& m_end) {
  e = expert_of(start, E, rt);
  m0 = off[e] + (rt - start[e]) * BM;
  m_end = off[e + 1];
}

// C = A B_e^T over every expert's run of rows, epilogue `epi`; DUAL: a
// second product A B2_e^T into a second accumulator.  K in whole stages
// (the host rounds it up; TMA fills zeros past the edge).
template <bool DUAL, class Epi>
__global__ void __launch_bounds__(THREADS, 1)
grouped_kernel(const __grid_constant__ CUtensorMap ta, const __grid_constant__ CUtensorMap tb,
               const __grid_constant__ CUtensorMap tb2, const int* __restrict__ offsets, int E,
               int N, int K, Epi epi) {
  using S = GroupShape<DUAL>;
  constexpr int ST = S::STAGES;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = sm90::smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t bars = base + ST * S::STAGE;  // full[ST], then empty[ST]
  int* off = reinterpret_cast<int*>(smem_raw + (bars - raw) + 2 * ST * 8);
  int* start = off + MAX_EXPERTS + 1;
  const int wg = threadIdx.x / 128;
  const int kt_n = K / BK;
  const int tiles_n = (N + BN - 1) / BN;

  for (int i = threadIdx.x; i <= E; i += THREADS) off[i] = __ldg(offsets + i);
  if (threadIdx.x == 0) {
    for (int s = 0; s < ST; ++s) {
      sm90::mbar_init(bars + 8 * s, 1);
      sm90::mbar_init(bars + 8 * (ST + s), sm90::CONSUMER_WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    int tiles = 0;
    for (int e = 0; e < E; ++e) {
      start[e] = tiles;
      tiles += (off[e + 1] - off[e] + BM - 1) / BM;
    }
    start[E] = tiles;
  }
  __syncthreads();
  const int items = start[E] * tiles_n;

  if (wg == 2) {
    // ---- producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 256) {
      int s = 0;
      uint32_t ph = 0;
      for (int t = blockIdx.x; t < items; t += gridDim.x) {
        const int rt = t / tiles_n, n0 = (t - rt * tiles_n) * BN;
        int e, m0, m_end;
        tile_rows(off, start, E, rt, e, m0, m_end);
        for (int kt = 0; kt < kt_n; ++kt) {
          const uint32_t full = bars + 8 * s, empty = bars + 8 * (ST + s);
          sm90::mbar_wait(empty, ph ^ 1);
          sm90::mbar_expect_tx(full, S::STAGE);
          const uint32_t sa = base + s * S::STAGE, sb = sa + S::A_BYTES;
          const int k0 = kt * BK;
          sm90::tma_load(sa, &ta, k0, m0, full);
          sm90::tma_load(sb, &tb, k0, n0, e, full);
          if constexpr (DUAL) sm90::tma_load(sb + S::B_BYTES, &tb2, k0, n0, e, full);
          if (++s == ST) s = 0, ph ^= 1;
        }
      }
    }
  } else {
    // ---- consumers: warpgroup wg owns rows [m0 + 64 wg, m0 + 64 wg + 64)
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int lane = threadIdx.x & 31, w = (threadIdx.x >> 5) & 3;
    int s = 0;
    uint32_t ph = 0;
    for (int t = blockIdx.x; t < items; t += gridDim.x) {
      const int rt = t / tiles_n, n0 = (t - rt * tiles_n) * BN;
      int e, m0, m_end;
      tile_rows(off, start, E, rt, e, m0, m_end);
      // thread (warp w, lane l) holds rows 16 w + l / 4 (+ 8) and columns
      // 8 j + 2 (l % 4) (+ 1) of its warpgroup's 64 x BN
      const int r0 = m0 + 64 * wg + 16 * w + (lane >> 2);
      float acc[DUAL ? 2 : 1][BN / 2];
#pragma unroll
      for (int a = 0; a < (DUAL ? 2 : 1); ++a)
#pragma unroll
        for (int i = 0; i < BN / 2; ++i) acc[a][i] = 0.0f;
      int prev = -1;
      for (int kt = 0; kt < kt_n; ++kt) {
        sm90::mbar_wait(bars + 8 * s, ph);
        const uint32_t sa = base + s * S::STAGE + wg * (64 * ROW_BYTES);
        const uint32_t sb = base + s * S::STAGE + S::A_BYTES;
        sm90::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) {
          const uint64_t da = sm90::desc(sa + 32 * kk, 0, 1024);
          sm90::mma<BN, 0>(acc[0], da, sm90::desc(sb + 32 * kk, 0, 1024));
          if constexpr (DUAL)
            sm90::mma<BN, 0>(acc[1], da, sm90::desc(sb + S::B_BYTES + 32 * kk, 0, 1024));
        }
        sm90::wgmma_commit();
        sm90::wgmma_wait<1>();  // the previous stage's products are done: release it
        if (prev >= 0 && lane == 0) sm90::mbar_arrive(bars + 8 * (ST + prev));
        prev = s;
        if (++s == ST) s = 0, ph ^= 1;
      }
      sm90::wgmma_wait<0>();
      if (lane == 0) sm90::mbar_arrive(bars + 8 * (ST + prev));  // the tile's last stage
#pragma unroll
      for (int a = 0; a < (DUAL ? 2 : 1); ++a) sm90::fence_regs(acc[a]);

      // ---- epilogue: every pair computed at indices clamped into the
      // expert's rows and N, stored only inside them
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int c = n0 + 8 * j + 2 * (lane & 3);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = r0 + 8 * h, i = 4 * j + 2 * h;
          const bool in = r < m_end && c < N;
          const int rc = r < m_end ? r : m_end - 1, cc = c < N ? c : N - 2;
          if constexpr (DUAL)
            epi(rc, cc, acc[0][i], acc[0][i + 1], acc[1][i], acc[1][i + 1], in);
          else
            epi(rc, cc, acc[0][i], acc[0][i + 1], in);
        }
      }
    }
  }
}

// a = bf16(silu(g) * u), silu(g) = g / (1 + e^-g), in fp32.
struct EpiSwiGLU {
  bf16* a;
  int n;
  __device__ __forceinline__ static float act(float g, float u) {
    return __fmul_rn(__fdiv_rn(g, __fadd_rn(1.0f, expf(-g))), u);
  }
  __device__ __forceinline__ void operator()(int r, int c, float g0, float g1, float u0, float u1,
                                             bool in) const {
    const __nv_bfloat162 v = __floats2bfloat162_rn(act(g0, u0), act(g1, u1));
    if (in) *reinterpret_cast<__nv_bfloat162*>(a + (size_t)r * n + c) = v;
  }
};

// out = bf16(w[r] * acc), the route weight in fp32.
struct EpiDown {
  bf16* out;
  const float* w;
  int n;
  __device__ __forceinline__ void operator()(int r, int c, float v0, float v1, bool in) const {
    const float s = __ldg(w + r);
    const __nv_bfloat162 v = __floats2bfloat162_rn(__fmul_rn(v0, s), __fmul_rn(v1, s));
    if (in) *reinterpret_cast<__nv_bfloat162*>(out + (size_t)r * n + c) = v;
  }
};

// Experts' weights (E, N, K), K contiguous, read in boxes of (64 k, 128
// columns, one expert), 128-byte swizzle, zeros past N and K.
inline cudaError_t expert_map(CUtensorMap* map, const void* w, int E, int N, int K) {
  const cuuint64_t dims[3] = {(cuuint64_t)K, (cuuint64_t)N, (cuuint64_t)E};
  const cuuint64_t strides[2] = {(cuuint64_t)K * sizeof(bf16), (cuuint64_t)N * K * sizeof(bf16)};
  const cuuint32_t box[3] = {(cuuint32_t)BK, (cuuint32_t)BN, 1};
  return sm90::make_map_nd(map, w, 3, dims, strides, box, CU_TENSOR_MAP_SWIZZLE_128B);
}

// One grouped product: a (R, K) against b (and b2) (E, N, K), offsets (E +
// 1) on the device.  N even, K a multiple of 8.
template <bool DUAL, class Epi>
cudaError_t grouped(const void* a, const void* b, const void* b2, const int* offsets, int R,
                    int E, int N, int K, Epi epi, cudaStream_t st) {
  using S = GroupShape<DUAL>;
  if (R <= 0 || E <= 0 || E > MAX_EXPERTS || N <= 0 || N % 2 || K <= 0 || K % 8)
    return cudaErrorInvalidValue;
  CUtensorMap ta, tb, tb2;
  cudaError_t e;
  if ((e = sm90::make_map<bf16>(&ta, a, R, K, BM)) != cudaSuccess) return e;
  if ((e = expert_map(&tb, b, E, N, K)) != cudaSuccess) return e;
  tb2 = tb;
  if constexpr (DUAL) {
    if ((e = expert_map(&tb2, b2, E, N, K)) != cudaSuccess) return e;
  }
  auto kernel = grouped_kernel<DUAL, Epi>;
  static bool smem_set = false;  // once per instantiation
  if (!smem_set) {
    if ((e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)S::SMEM)) != cudaSuccess)
      return e;
    smem_set = true;
  }
  const long worst = ((long)(R + BM - 1) / BM + E) * ((N + BN - 1) / BN);
  const int grid = worst < sm90::sm_count() ? (int)worst : sm90::sm_count();
  const int kp = (K + BK - 1) / BK * BK;
  kernel<<<grid, THREADS, S::SMEM, st>>>(ta, tb, tb2, offsets, E, N, kp, epi);
  return cudaGetLastError();
}

}  // namespace

// x (R, H) bf16 in expert order; wg, wu (E, I, H), wd (E, H, I) bf16;
// offsets (E + 1) int32 and route_w (R) fp32 on the card; a (R, I) bf16
// scratch; out (R, H) bf16.
extern "C" int vt_moe_experts(const void* x, const void* wg, const void* wu, const void* wd,
                              const void* offsets, const void* route_w, void* a, void* out, int R,
                              int H, int I, int E, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* off = static_cast<const int*>(offsets);
  cudaError_t e = grouped<true>(x, wg, wu, off, R, E, I, H, EpiSwiGLU{static_cast<bf16*>(a), I}, st);
  if (e != cudaSuccess) return e;
  return grouped<false>(a, wd, wd, off, R, E, H, I,
                        EpiDown{static_cast<bf16*>(out), static_cast<const float*>(route_w), H},
                        st);
}
