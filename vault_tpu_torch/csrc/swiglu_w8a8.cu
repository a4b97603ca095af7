// Fused w8a8 RMSNorm -> SwiGLU -> residual block for Hopper, the MLP half
// of a Llama layer with int8 weights and activations:
//
//   y  = T(w * (x * rstd(x)))                         RMSNorm, rounded to T
//   (yq, ys) = q(y)                                   per-row int8 codes, scale
//   per 1024-column tile t of I:
//     g = int32(yq Wg[:, t]) * (ys * sg[t]);  u = int32(yq Wu[:, t]) * (ys * su[t])
//     a = T(silu(g) * u);  (aq, as[t]) = q(a)         per-(row, tile) codes, scale
//     acc += float(int32(aq Wd[t, :])) * as[t]        fp32, tiles in order
//   out = T(acc * sd) + x
//
// Replaces fused_swiglu_block_fwd_w8a8 (_swiglu_kernel_w8a8) of
// vault_tpu/ops/pallas_swiglu.py with its numerics: the requantization
// group is one row of one 1024-column I-tile (a constant of the function:
// it decides the codes), each tile's int32 down product is scaled by that
// tile's row scale and added in fp32 in tile order 0, 1, ..., sd multiplies
// once at the end, then the cast to T, then the residual.  The RMSNorm takes
// its mean of squares in double and rounds it to fp32 (the correctly
// rounded value, which any summation order reaches), rstd = 1 / sqrt(var +
// eps) with a correctly rounded square root and division, silu(g) = g * (1 /
// (1 + exp(-g))), and every fp32 step is an _rn intrinsic so that nvcc
// contracts none into an FMA: the plain version in ops/cuda_swiglu.py takes
// the same steps in PyTorch and gives the same bits.
//
// Operands: x, out (rows, H) bf16 or fp32; w (H) fp32; Wg, Wu (H, I) and Wd
// (I, H) int8; sg, su (I) and sd (H) fp32.  H is 4096 and I a multiple of
// 1024 (Llama-3-8B: 14336 = 14 tiles).
//
// What bounds it on an H100: 6 rows H I int8 operations (225 GOP at 640
// rows, 0.114 ms at 1,979 TOP/s) against 176 MB of weights (0.053 ms): the
// tensor cores at 640 rows, level with the bytes near 320.  The TPU kernel
// walks the I-tiles in sequence on one core with a (rows, H) fp32
// accumulator in VMEM; here the work is spread over the SMs in four
// launches, counted as one call:
//   1. rms_quant_rows: one block a row, the row in registers -> yq, ys;
//   2. gate_up_tiles: one block per (64 rows, 128 columns of I) runs BOTH
//      products on the same yq tile (two sets of int32 accumulators, wmma
//      16x16x16, cp.async double buffering as gemm_tiles), then the
//      epilogue above: a in T to device memory (18 MB at 640 rows, it stays
//      in the 50 MB L2) with the absmax of each (row, 128 columns);
//   3. requant_tiles: a tile's row maximum is the maximum of its eight
//      128-column maxima (exact in any order) -> aq, as;
//   4. down_tiles: one block per (64 rows, 128 columns of H) walks all of I;
//      every 1024 steps of K it moves its int32 accumulators through shared
//      memory into fp32 ones, scaled by the tile's row scale, so the fp32
//      sum runs in tile order inside one block (no split of K: fp32
//      addition in another order changes bits); then sd, the cast, + x.
#include "gemm_common.cuh"

namespace {

constexpr int IT = 1024;  // I columns per requantization tile
constexpr int H_SWIGLU = 4096;

using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, int8_t, wmma::row_major>;
using FragB = wmma::fragment<wmma::matrix_b, 16, 16, 16, int8_t, wmma::row_major>;
using FragC = wmma::fragment<wmma::accumulator, 16, 16, 16, int>;

__device__ __forceinline__ float silu_mul_rn(float g, float u) {
  const float sig = __fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-g)));
  return __fmul_rn(__fmul_rn(g, sig), u);
}

// One row per block: RMSNorm rounded to T, then the row's int8 codes and scale.
template <typename T, int PER>
__global__ void __launch_bounds__(gm::RT)
rms_quant_rows(const T* __restrict__ x, const float* __restrict__ w, int8_t* __restrict__ q,
               float* __restrict__ scale, float eps) {
  constexpr int H = gm::RT * PER;
  __shared__ double redd[gm::RT / 32];
  __shared__ float redf[gm::RT / 32];
  const size_t base = static_cast<size_t>(blockIdx.x) * H + threadIdx.x;
  float v[PER];
  double ss = 0.0;
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    v[i] = vt::to_f(x[base + gm::RT * i]);
    ss += static_cast<double>(v[i]) * static_cast<double>(v[i]);
  }
  const float var = static_cast<float>(gm::block_sum(ss, redd) / H);
  const float rstd = __fdiv_rn(1.0f, __fsqrt_rn(__fadd_rn(var, eps)));
  float m = 0.0f;
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const float y = __fmul_rn(w[threadIdx.x + gm::RT * i], __fmul_rn(v[i], rstd));
    v[i] = vt::to_f(vt::from_f<T>(y));
    m = fmaxf(m, fabsf(v[i]));
  }
  const float s = gm::quant_scale(gm::block_max(m, redf));
#pragma unroll
  for (int i = 0; i < PER; ++i) q[base + gm::RT * i] = gm::quant(v[i], s);
  if (threadIdx.x == 0) scale[blockIdx.x] = s;
}

// A (64, 64) tile of a (rows past M repeat row M - 1: loaded, never stored)
// and `nb` (64, 128) tiles of b into one stage, as 16-column chunks.
__device__ __forceinline__ void fetch_stage(int8_t* stage, const int8_t* a, int M, int K,
                                            int row0, int k0, const int8_t* const* b, int nb,
                                            int N, int n0) {
  constexpr int V = 16, BM = gm::BM, BN = gm::BN, BK = gm::BK, CH = gm::CH;
  const int tid = threadIdx.x;
  for (int c = tid; c < BM * (BK / V); c += gm::NT) {
    const int r = c / (BK / V), e = (c % (BK / V)) * V;
    const int src = min(row0 + r, M - 1);
    cp_async16(stage + ((e / CH) * BM + r) * CH + e % CH, a + (size_t)src * K + k0 + e);
  }
  for (int j = 0; j < nb; ++j) {
    int8_t* bs = stage + BM * BK + j * BK * BN;
    for (int c = tid; c < BK * (BN / V); c += gm::NT) {
      const int k = c / (BN / V), e = (c % (BN / V)) * V;
      cp_async16(bs + ((e / CH) * BK + k) * CH + e % CH, b[j] + (size_t)(k0 + k) * N + n0 + e);
    }
  }
  cp_async_commit();
}

__device__ __forceinline__ void load_a(FragA (&fa)[2], const int8_t* as, int kk, int wm) {
#pragma unroll
  for (int i = 0; i < 2; ++i)
    wmma::load_matrix_sync(fa[i], as + (kk * gm::BM + wm * 32 + i * 16) * gm::CH, gm::CH);
}

// acc += fa (the warp's 32 rows, 16 of K) x the warp's 32 columns of bs.
__device__ __forceinline__ void mma_b(FragC (&acc)[2][2], const FragA (&fa)[2], const int8_t* bs,
                                      int kk, int wn) {
  FragB fb[2];
#pragma unroll
  for (int j = 0; j < 2; ++j)
    wmma::load_matrix_sync(fb[j], bs + ((wn * 2 + j) * gm::BK + kk * gm::CH) * gm::CH, gm::CH);
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
}

__device__ __forceinline__ void zero(FragC (&acc)[2][2]) {
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0);
}

__device__ __forceinline__ void store(int* st, const FragC (&acc)[2][2], int wm, int wn) {
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(st + (wm * 32 + i * 16) * gm::LDS + wn * 32 + j * 16, acc[i][j],
                              gm::LDS, wmma::mem_row_major);
}

constexpr size_t kStaging = (size_t)gm::BM * gm::LDS * sizeof(int);  // one int32 tile
constexpr size_t kGateUpStage = gm::BM * gm::BK + 2 * gm::BK * gm::BN;
constexpr size_t kGateUpSmem =
    2 * kGateUpStage > 2 * kStaging ? 2 * kGateUpStage : 2 * kStaging;
constexpr size_t kDownStage = gm::BM * gm::BK + gm::BK * gm::BN;
constexpr size_t kDownSmem = 2 * kDownStage + kStaging;

// a = T(silu(g) * u) for one (64, 128) tile of (M, N = I), K = H, and the
// absmax of each of its rows into pmax (M, N / 128).
template <typename T>
__global__ void __launch_bounds__(gm::NT)
gate_up_tiles(const int8_t* __restrict__ yq, const int8_t* __restrict__ wg,
              const int8_t* __restrict__ wu, int M, int N, int K,
              const float* __restrict__ ys, const float* __restrict__ sg,
              const float* __restrict__ su, T* __restrict__ a_out, float* __restrict__ pmax) {
  constexpr int BM = gm::BM, BN = gm::BN, BK = gm::BK, LDS = gm::LDS;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __shared__ float red[BM][BN / 32];
  int8_t* sm = reinterpret_cast<int8_t*>(smem_raw);
  const int tid = threadIdx.x, w = tid >> 5, lane = tid & 31;
  const int wm = w >> 2, wn = w & 3;
  const int row0 = blockIdx.x * BM, n0 = blockIdx.y * BN, nk = K / BK;
  const int8_t* const bmat[2] = {wg, wu};

  FragC accg[2][2], accu[2][2];
  zero(accg);
  zero(accu);
  fetch_stage(sm, yq, M, K, row0, 0, bmat, 2, N, n0);
  for (int t = 0; t < nk; ++t) {
    if (t + 1 < nk) {
      fetch_stage(sm + ((t + 1) & 1) * kGateUpStage, yq, M, K, row0, (t + 1) * BK, bmat, 2, N,
                  n0);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // stage t visible to every warp
    const int8_t* as = sm + (t & 1) * kGateUpStage;
    const int8_t* bg = as + BM * BK;
    const int8_t* bu = bg + BK * BN;
#pragma unroll
    for (int kk = 0; kk < BK / gm::CH; ++kk) {
      FragA fa[2];
      load_a(fa, as, kk, wm);
      mma_b(accg, fa, bg, kk, wn);
      mma_b(accu, fa, bu, kk, wn);
    }
    __syncthreads();  // every warp is done with this stage
  }

  // ---- epilogue: both tiles through shared memory (the stages are free now)
  int* stg = reinterpret_cast<int*>(smem_raw);
  int* stu = stg + BM * LDS;
  store(stg, accg, wm, wn);
  store(stu, accu, wm, wn);
  __syncthreads();
  const int cc = tid % BN, rg = tid / BN, col = n0 + cc;
  const float sgc = sg[col], suc = su[col];
  for (int i = 0; i < BM / 2; ++i) {
    const int r = rg + 2 * i, row = row0 + r;
    const float rs = ys[min(row, M - 1)];
    const float g = __fmul_rn(__int2float_rn(stg[r * LDS + cc]), __fmul_rn(rs, sgc));
    const float u = __fmul_rn(__int2float_rn(stu[r * LDS + cc]), __fmul_rn(rs, suc));
    const T av = vt::from_f<T>(silu_mul_rn(g, u));
    if (row < M) a_out[(size_t)row * N + col] = av;
    const float m = gm::warp_max(fabsf(vt::to_f(av)));  // a warp shares its row
    if (lane == 0) red[r][cc / 32] = m;
  }
  __syncthreads();
  if (tid < BM && row0 + tid < M) {
    float m = 0.0f;
#pragma unroll
    for (int j = 0; j < BN / 32; ++j) m = fmaxf(m, red[tid][j]);
    pmax[(size_t)(row0 + tid) * gridDim.y + blockIdx.y] = m;
  }
}

// One row per block: each 1024-column tile's int8 codes and scale from the
// maxima of its eight 128-column pieces.
template <typename T>
__global__ void __launch_bounds__(gm::RT)
requant_tiles(const T* __restrict__ a, const float* __restrict__ pmax, int I,
              int8_t* __restrict__ q, float* __restrict__ scale) {
  constexpr int PIECES = IT / gm::BN;
  const size_t row = blockIdx.x;
  const int tiles = I / IT;
  for (int t = 0; t < tiles; ++t) {
    float m = 0.0f;
#pragma unroll
    for (int j = 0; j < PIECES; ++j) m = fmaxf(m, pmax[row * (I / gm::BN) + t * PIECES + j]);
    const float s = gm::quant_scale(m);
    const size_t base = row * I + (size_t)t * IT;
    for (int c = threadIdx.x; c < IT; c += gm::RT) q[base + c] = gm::quant(vt::to_f(a[base + c]), s);
    if (threadIdx.x == 0) scale[row * tiles + t] = s;
  }
}

// out = T(acc * sd) + x for one (64, 128) tile of (M, N = H), K = I: acc is
// the fp32 sum, in tile order, of float(int32 tile product) * its row scale.
template <typename T>
__global__ void __launch_bounds__(gm::NT)
down_tiles(const int8_t* __restrict__ aq, const int8_t* __restrict__ wd, int M, int N, int K,
           const float* __restrict__ as_, const float* __restrict__ sd,
           const T* __restrict__ x, T* __restrict__ out) {
  constexpr int BM = gm::BM, BN = gm::BN, BK = gm::BK, LDS = gm::LDS;
  constexpr int FLUSH = IT / BK;  // K steps per requantization tile
  extern __shared__ __align__(128) unsigned char smem_raw[];
  int8_t* sm = reinterpret_cast<int8_t*>(smem_raw);
  int* st = reinterpret_cast<int*>(smem_raw + 2 * kDownStage);  // beside the stages
  const int tid = threadIdx.x, w = tid >> 5;
  const int wm = w >> 2, wn = w & 3;
  const int row0 = blockIdx.x * BM, n0 = blockIdx.y * BN, nk = K / BK, tiles = K / IT;
  const int cc = tid % BN, rg = tid / BN, col = n0 + cc;
  const int8_t* const bmat[1] = {wd};

  FragC acc[2][2];
  zero(acc);
  float facc[BM / 2];
#pragma unroll
  for (int i = 0; i < BM / 2; ++i) facc[i] = 0.0f;

  fetch_stage(sm, aq, M, K, row0, 0, bmat, 1, N, n0);
  for (int t = 0; t < nk; ++t) {
    if (t + 1 < nk) {
      fetch_stage(sm + ((t + 1) & 1) * kDownStage, aq, M, K, row0, (t + 1) * BK, bmat, 1, N, n0);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // stage t visible to every warp
    const int8_t* as = sm + (t & 1) * kDownStage;
    const int8_t* bs = as + BM * BK;
#pragma unroll
    for (int kk = 0; kk < BK / gm::CH; ++kk) {
      FragA fa[2];
      load_a(fa, as, kk, wm);
      mma_b(acc, fa, bs, kk, wn);
    }
    if ((t + 1) % FLUSH == 0) {
      // a requantization tile is complete: its int32 sums, converted once,
      // times the tile's row scale, onto the fp32 sum.  st was last read
      // FLUSH steps (and as many barriers) ago.
      store(st, acc, wm, wn);
      zero(acc);
      __syncthreads();
      const int tile = t / FLUSH;
#pragma unroll
      for (int i = 0; i < BM / 2; ++i) {
        const int r = rg + 2 * i, row = min(row0 + r, M - 1);
        facc[i] = __fadd_rn(facc[i], __fmul_rn(__int2float_rn(st[r * LDS + cc]),
                                               as_[(size_t)row * tiles + tile]));
      }
    }
    __syncthreads();  // every warp is done with this stage
  }

  const float sdc = sd[col];
#pragma unroll
  for (int i = 0; i < BM / 2; ++i) {
    const int row = row0 + rg + 2 * i;
    if (row < M) {
      const float o = vt::to_f(vt::from_f<T>(__fmul_rn(facc[i], sdc)));
      out[(size_t)row * N + col] = vt::from_f<T>(__fadd_rn(vt::to_f(x[(size_t)row * N + col]), o));
    }
  }
}

struct Bufs {
  int8_t* yq;   // (rows, H) codes of the normalised rows
  float* ys;    // (rows,) their scales
  void* a;      // (rows, I) T
  float* pmax;  // (rows, I / 128)
  int8_t* aq;   // (rows, I) codes of a
  float* as;    // (rows, I / 1024) their scales
};

template <typename T>
int swiglu(const void* x, const void* w, const void* wg, const void* sg, const void* wu,
           const void* su, const void* wd, const void* sd, const Bufs& bf, void* out, int rows,
           int I, float eps, cudaStream_t st) {
  constexpr int H = H_SWIGLU;
  const T* xt = static_cast<const T*>(x);
  rms_quant_rows<T, H / gm::RT><<<rows, gm::RT, 0, st>>>(xt, static_cast<const float*>(w), bf.yq,
                                                         bf.ys, eps);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  if ((e = allow_smem<gate_up_tiles<T>>(kGateUpSmem)) != cudaSuccess) return (int)e;
  const int row_tiles = (rows + gm::BM - 1) / gm::BM;
  gate_up_tiles<T><<<dim3(row_tiles, I / gm::BN), gm::NT, kGateUpSmem, st>>>(
      bf.yq, static_cast<const int8_t*>(wg), static_cast<const int8_t*>(wu), rows, I, H, bf.ys,
      static_cast<const float*>(sg), static_cast<const float*>(su), static_cast<T*>(bf.a),
      bf.pmax);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  requant_tiles<T><<<rows, gm::RT, 0, st>>>(static_cast<const T*>(bf.a), bf.pmax, I, bf.aq,
                                            bf.as);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  if ((e = allow_smem<down_tiles<T>>(kDownSmem)) != cudaSuccess) return (int)e;
  down_tiles<T><<<dim3(row_tiles, H / gm::BN), gm::NT, kDownSmem, st>>>(
      bf.aq, static_cast<const int8_t*>(wd), rows, H, I, bf.as, static_cast<const float*>(sd), xt,
      static_cast<T*>(out));
  return (int)cudaGetLastError();
}

}  // namespace

// Scratch: yq (rows, H) int8, ys (rows,) fp32, a (rows, I) in x's type, pmax
// (rows, I / 128) fp32, aq (rows, I) int8, as (rows, I / 1024) fp32.
extern "C" int vt_swiglu_w8a8(const void* x, const void* w, const void* wg, const void* sg,
                              const void* wu, const void* su, const void* wd, const void* sd,
                              void* yq, void* ys, void* a, void* pmax, void* aq, void* as,
                              void* out, int rows, int H, int I, float eps, int dtype,
                              void* stream) {
  if (rows <= 0 || H != H_SWIGLU || I <= 0 || I % IT) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Bufs bf{static_cast<int8_t*>(yq), static_cast<float*>(ys), a, static_cast<float*>(pmax),
                static_cast<int8_t*>(aq), static_cast<float*>(as)};
  if (dtype == vt::kBF16)
    return swiglu<__nv_bfloat16>(x, w, wg, sg, wu, su, wd, sd, bf, out, rows, I, eps, st);
  if (dtype == vt::kF32) return swiglu<float>(x, w, wg, sg, wu, su, wd, sd, bf, out, rows, I, eps, st);
  return (int)cudaErrorInvalidValue;
}
