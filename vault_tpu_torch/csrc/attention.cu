// Encoder attention for Hopper: out = softmax(q k^T / sqrt(d) + bias) v.
//
// Replaces the JAX package's three Pallas encoder-attention kernels, which
// compute the same function and differ only in TPU program layout:
// fused_attention (_attn_kernel, grid (B, H)), fused_attention_batched
// (_attn_kernel_batched) and fused_attention_dotbatch
// (_attn_kernel_dotbatch), all in vault_tpu/ops/pallas_attention.py.
//
// Operands: q, k, v, out (B, H, L, D), D a multiple of 4 from 8 to 128
// (BERT-base and ViLT-B/32: 64), with contiguous rows of D (any
// batch, head and row strides, so q, k and v can be views into the fused
// QKV projection and out a view of the (B, L, H) layout the next product
// reads), all bf16 or all fp32; bias (B, 1, 1, L) fp32, an additive key
// bias with a finite fill for masked keys.
//
// What bounds it on an H100: at the main path's L = 40 and L = 256 the
// work is small (4 B H L^2 d FLOP: 1.6 GFLOP at (8, 12, 256, 64), 1.6 us
// of tensor-core time at 989 TFLOP/s) against 12.6 MB of operands (the
// bytes bound it, 0.0038 ms at L = 256), so the kernel is bound by latency
// and by how many blocks fill the 132 SMs.  The kernel is
// attention_common.cuh's (bf16: one pass on wgmma; fp32: FMA), one query
// head per K/V head and a key bias shared by every query row: one block per
// (query tile of 64 rows, head, batch row), 384 blocks at L = 256 that fit
// the card at once (five a SM at D = 64), 96 at L = 40.
#include "attention_common.cuh"

// q, k, v share the strides (sb, sh, sl); out has (ob, oh, ol); all rows
// contiguous.  Strides are in elements.
extern "C" int vt_attention_fwd(const void* q, const void* k, const void* v,
                                const void* bias, void* out, int B, int H, int L,
                                int head_dim, long long sb, long long sh, long long sl,
                                long long ob, long long oh, long long ol, int dtype,
                                void* stream) {
  const Strides in{sb, sh, sl};
  const Map mp{L, 1, in, in, in, Strides{ob, oh, ol}, L, 0, 0.0f};
  return launch_attention_d(head_dim, q, k, v, bias, out, B, H, mp, dtype,
                            static_cast<cudaStream_t>(stream));
}
