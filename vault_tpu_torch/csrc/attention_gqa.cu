// Grouped-query attention for Hopper, the Llama tower's attention core:
// out = softmax(q k^T / sqrt(d) + bias) v with H query heads on G = H / rep
// K/V heads and a full (B, 1, Lq, Lk) additive bias (causal and padding).
//
// Replaces fused_attention_gqa (_attn_kernel_gqa) of
// vault_tpu/ops/pallas_attention.py.  As there, query head i reads K/V head
// i / rep without any repeated copy of K or V: the rep heads of a group are
// folded into one (rep L, d) query matrix against the group's (L, d) keys
// and values, and the bias row of folded row f is that of position f % L.
// fp32 scores and softmax; in bf16 the probabilities are cast before P V
// (normalised first when the key row is one tile, attention_common.cuh).
// The kernel multiplies the scores by 1 / sqrt(d) where the plain composition
// divides by sqrt(d): one fp32 ulp of the score, inside the stated limits.
// Masked entries carry finfo(float32).min, which the kernel keeps finite
// (attention_common.cuh); rep = 1 is multi-head attention with a 2-D bias.
//
// Operands: q, out (B, H, L, d); k, v (B, G, L, d); d a multiple of 4 from 8
// to 128 (128: Llama-2, Llama-3-8B; 64: TinyLlama, SmolLM; 100: OpenLLaMA-3B,
// on the padded instance of attention_common.cuh); contiguous rows, any
// other strides; bf16 or fp32; bias contiguous fp32.
//
// What bounds it on an H100: at the tower's (16, 32, 40, 128) the work is
// 4 B H L^2 d = 0.4 GFLOP against 6.6 MB of operands (q and out 5.2 MB, K/V
// 1.3 MB, bias 0.1 MB): bound by the bytes, about 0.002 ms, and in practice
// by latency.  The fold fills the 64-row query tiles (rep L = 160 rows of a
// group are 3 tiles, where 4 heads of 40 rows would be 4) and reads each
// K/V head once per tile of its group: grid (3, 8, 16) = 384 blocks of one
// warpgroup, all resident at once at L = 40 (one 64-key stage, 50 KB of
// shared memory and 128 registers a thread: four blocks a SM).
#include "attention_common.cuh"

// strides: the (batch, head, row) element strides of q, k, v and out, twelve
// numbers in that order; rows contiguous.  bias: contiguous (B, 1, L, L) fp32.
extern "C" int vt_attention_gqa_fwd(const void* q, const void* k, const void* v,
                                    const void* bias, void* out, int B, int H, int G, int L,
                                    int head_dim, const long long* strides, int dtype,
                                    void* stream) {
  if (G <= 0 || H % G) return (int)cudaErrorInvalidValue;
  const long long* s = strides;
  const Map mp{L, H / G, Strides{s[0], s[1], s[2]}, Strides{s[3], s[4], s[5]},
               Strides{s[6], s[7], s[8]}, Strides{s[9], s[10], s[11]},
               (long long)L * L, L, 0.0f};
  return launch_attention_d(head_dim, q, k, v, bias, out, B, G, mp, dtype,
                            static_cast<cudaStream_t>(stream));
}
