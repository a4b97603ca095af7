// HF AdamW over many parameter leaves in one launch (multi-tensor).
//
// Replaces no TPU kernel: the JAX package leaves the update to XLA, which
// fuses it.  In eager PyTorch the per-leaf loop of training/optimizer.py
// HfAdamW.step_ launches ~18 elementwise operations a leaf (7,290 launches a
// step over VAuLT's 405 leaves) and passes over every parameter ~18 times;
// this kernel updates every leaf of one dtype combination in one launch and
// one pass.
//
// Per element, the loop's fp32 operations in the loop's order, each rounded
// once (no contraction into FMAs: __fmul_rn / __fadd_rn; IEEE sqrt and
// division), so the result is the loop's bit for bit on the card:
//   m = M(b1 m + (1 - b1) g);  v = M(b2 v + (1 - b2) (g g))
//   u = (-step_size m) / (sqrt(v) + eps)       (the rounded, stored moments)
//   u = u - decay p                            (when weight_decay > 0)
//   p = P(p + P(u))
// P, G, M: the parameter, gradient and moment types, each fp32 or bf16;
// M(x) rounds to nearest even, as torch's copy_ does.
//
// What bounds it on an H100: the bytes.  Each element is read once and
// written once: fp32 masters, fp32 gradients and bf16 moments are 20 bytes
// an element, 4.4 GB for VAuLT-base's 220 M parameters, 1.3 ms at 3.35 TB/s.
// Work: a block table splits the flat element space into chunks of kChunk
// elements of one leaf each (a 768-element bias is one small block, the
// 64,001 x 768 word table 6,000 full ones), so no block's length depends on
// a neighbour leaf's.  A block whose four arrays start on 16 bytes moves
// 16-byte words (kVec elements a thread a step); its ragged end, and any
// block of a misaligned leaf, goes element by element.
//
// Layout: a leaf's four arrays are rows of `cols` elements, each array with
// its own row stride; a leaf whose arrays are all contiguous is one row
// (cols == n).  ZeRO's slice of a (768, 3072) weight on its last axis is
// 768 rows of 1,536 elements 3,072 apart, its moments 1,536 apart.  Rows
// whose length and strides are multiples of kVec keep the 16-byte words
// (a word never crosses a row).
//
// Operands: leaves, a device array of Leaf (parameter, moment addresses,
// the element count and the layout), built once and kept while the tensors
// stay; blocks, a device array of (leaf, chunk) pairs; the gradients'
// addresses, new every step, travel by value in the kernel's parameters
// (kMaxLeaves of them, under the 4 KB of kernel parameters that CUDA 12
// always takes).
#include <cstdint>
#include <cstring>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kVec = 8;  // elements a thread takes a step: 16 bytes of bf16, 32 of fp32
constexpr int kChunk = 8192;  // elements a block updates (ops/cuda_adamw.py CHUNK)
constexpr int kMaxLeaves = 480;  // leaves a launch takes (ops/cuda_adamw.py MAX_LEAVES)

struct Leaf {
  void* p;
  void* m;
  void* v;
  long long n;
  long long cols;            // elements a row: n when the arrays are contiguous
  long long sp, sg, sm, sv;  // row strides in elements: parameter, gradient, moments
};

// Element i of a leaf: its row and column.
struct Where {
  long long row, col;
  __device__ __forceinline__ Where(const Leaf& l, long long i) {
    row = l.cols == l.n ? 0 : i / l.cols;
    col = i - row * l.cols;
  }
  __device__ __forceinline__ long long at(long long stride) const { return row * stride + col; }
};

struct Grads {
  const void* g[kMaxLeaves];
};

struct Hyper {
  float b1, omb1, b2, omb2, neg_step, eps, decay;
  int decay_on;
};

template <typename T>
struct alignas(16) Word {
  T e[16 / sizeof(T)];
};

template <typename T>
__device__ __forceinline__ void load_vec(const T* src, T (&dst)[kVec]) {
  constexpr int kPer = 16 / sizeof(T);
#pragma unroll
  for (int w = 0; w < kVec / kPer; ++w) {
    const Word<T> x = reinterpret_cast<const Word<T>*>(src)[w];
#pragma unroll
    for (int j = 0; j < kPer; ++j) dst[w * kPer + j] = x.e[j];
  }
}

template <typename T>
__device__ __forceinline__ void store_vec(T* dst, const T (&src)[kVec]) {
  constexpr int kPer = 16 / sizeof(T);
#pragma unroll
  for (int w = 0; w < kVec / kPer; ++w) {
    Word<T> x;
#pragma unroll
    for (int j = 0; j < kPer; ++j) x.e[j] = src[w * kPer + j];
    reinterpret_cast<Word<T>*>(dst)[w] = x;
  }
}

template <typename P, typename G, typename M>
__device__ __forceinline__ void update(P& p, G g, M& m, M& v, const Hyper& h) {
  const float gf = vt::to_f(g);
  m = vt::from_f<M>(__fadd_rn(__fmul_rn(h.b1, vt::to_f(m)), __fmul_rn(h.omb1, gf)));
  v = vt::from_f<M>(__fadd_rn(__fmul_rn(h.b2, vt::to_f(v)),
                              __fmul_rn(h.omb2, __fmul_rn(gf, gf))));
  float u = __fdiv_rn(__fmul_rn(h.neg_step, vt::to_f(m)),
                      __fadd_rn(__fsqrt_rn(vt::to_f(v)), h.eps));
  const float pf = vt::to_f(p);
  if (h.decay_on) u = __fsub_rn(u, __fmul_rn(h.decay, pf));
  p = vt::from_f<P>(__fadd_rn(pf, vt::to_f(vt::from_f<P>(u))));
}

template <typename P, typename G, typename M>
__global__ void __launch_bounds__(kThreads)
    adamw_kernel(const Leaf* __restrict__ leaves, const int2* __restrict__ blocks,
                 const Grads grads, const Hyper h) {
  const int2 blk = blocks[blockIdx.x];
  const Leaf leaf = leaves[blk.x];
  P* p = static_cast<P*>(leaf.p);
  M* m = static_cast<M*>(leaf.m);
  M* v = static_cast<M*>(leaf.v);
  const G* g = static_cast<const G*>(grads.g[blk.x]);
  const long long begin = static_cast<long long>(blk.y) * kChunk;
  const long long end = min(begin + kChunk, leaf.n);
  long long i = begin;
  const uintptr_t addr = reinterpret_cast<uintptr_t>(p) | reinterpret_cast<uintptr_t>(g) |
                         reinterpret_cast<uintptr_t>(m) | reinterpret_cast<uintptr_t>(v);
  // a chunk starts on a multiple of kChunk elements; with a row length and
  // row strides that are multiples of kVec too, no word crosses a row and
  // every word is as aligned as the arrays' starts
  const bool rows_whole = leaf.cols == leaf.n ||
                          ((leaf.cols | leaf.sp | leaf.sg | leaf.sm | leaf.sv) % kVec == 0);
  if ((addr & 15) == 0 && rows_whole) {
    const long long vend = begin + (end - begin) / kVec * kVec;
    for (long long j = begin + threadIdx.x * kVec; j < vend; j += kThreads * kVec) {
      const Where w(leaf, j);
      P pv[kVec];
      G gv[kVec];
      M mv[kVec], vv[kVec];
      load_vec(p + w.at(leaf.sp), pv);
      load_vec(g + w.at(leaf.sg), gv);
      load_vec(m + w.at(leaf.sm), mv);
      load_vec(v + w.at(leaf.sv), vv);
#pragma unroll
      for (int e = 0; e < kVec; ++e) update(pv[e], gv[e], mv[e], vv[e], h);
      store_vec(p + w.at(leaf.sp), pv);
      store_vec(m + w.at(leaf.sm), mv);
      store_vec(v + w.at(leaf.sv), vv);
    }
    i = vend;
  }
  for (long long j = i + threadIdx.x; j < end; j += kThreads) {
    const Where w(leaf, j);
    P pj = p[w.at(leaf.sp)];
    M mj = m[w.at(leaf.sm)], vj = v[w.at(leaf.sv)];
    update(pj, g[w.at(leaf.sg)], mj, vj, h);
    p[w.at(leaf.sp)] = pj;
    m[w.at(leaf.sm)] = mj;
    v[w.at(leaf.sv)] = vj;
  }
}

template <typename P, typename G, typename M>
int launch(const Leaf* leaves, const int2* blocks, int n_blocks, const Grads& grads,
           const Hyper& h, cudaStream_t stream) {
  adamw_kernel<P, G, M><<<n_blocks, kThreads, 0, stream>>>(leaves, blocks, grads, h);
  return static_cast<int>(cudaGetLastError());
}

template <typename P, typename G>
int launch_m(int m_dtype, const Leaf* leaves, const int2* blocks, int n_blocks,
             const Grads& grads, const Hyper& h, cudaStream_t stream) {
  return m_dtype == vt::kF32
             ? launch<P, G, float>(leaves, blocks, n_blocks, grads, h, stream)
             : launch<P, G, __nv_bfloat16>(leaves, blocks, n_blocks, grads, h, stream);
}

template <typename P>
int launch_g(int g_dtype, int m_dtype, const Leaf* leaves, const int2* blocks, int n_blocks,
             const Grads& grads, const Hyper& h, cudaStream_t stream) {
  return g_dtype == vt::kF32
             ? launch_m<P, float>(m_dtype, leaves, blocks, n_blocks, grads, h, stream)
             : launch_m<P, __nv_bfloat16>(m_dtype, leaves, blocks, n_blocks, grads, h, stream);
}

bool known(int dtype) { return dtype == vt::kF32 || dtype == vt::kBF16; }

}  // namespace

// One launch over n_leaves leaves of one dtype combination (vt::Dtype codes):
// leaves, n_leaves Leaf records on the device (nine int64 each: the three
// addresses, n, cols and the four row strides); blocks, n_blocks (leaf, chunk)
// int32 pairs on the device, leaf indexing both leaves and grads; grads,
// n_leaves gradient addresses on the host, copied into the launch's
// parameters.  chunk must be kChunk (the tables were cut to it).  Scalars
// as fp32: b1, 1 - b1, b2, 1 - b2, -step_size, eps, the decay, and whether
// the decay term runs.
extern "C" int vt_adamw(int p_dtype, int g_dtype, int m_dtype, const void* leaves,
                        const void* blocks, int n_blocks, const void* grads, int n_leaves,
                        int chunk, float b1, float omb1, float b2, float omb2, float neg_step,
                        float eps, float decay, int decay_on, void* stream) {
  if (chunk != kChunk || n_leaves < 0 || n_leaves > kMaxLeaves || n_blocks < 0 ||
      !known(p_dtype) || !known(g_dtype) || !known(m_dtype))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_blocks == 0) return 0;
  Grads gs;
  std::memcpy(gs.g, grads, sizeof(void*) * n_leaves);
  const Hyper h{b1, omb1, b2, omb2, neg_step, eps, decay, decay_on};
  const Leaf* lv = static_cast<const Leaf*>(leaves);
  const int2* bl = static_cast<const int2*>(blocks);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return p_dtype == vt::kF32 ? launch_g<float>(g_dtype, m_dtype, lv, bl, n_blocks, gs, h, s)
                             : launch_g<__nv_bfloat16>(g_dtype, m_dtype, lv, bl, n_blocks, gs,
                                                       h, s);
}
