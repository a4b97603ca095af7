"""The products a forward of the ``vault_moe`` family computes, counted as
2·M·N·K from the configuration and the input's geometry, every text
position (the padding too) as the program computes it.

Counted, by kind: ``dense``, the tower's attention projections (q,
kv_a, kv_b, o), its dense layers' SwiGLU, ``lm_proj`` and ViLT's encoder
linears; ``experts``, in each MoE layer the ``num_experts_per_tok`` routed
experts and the shared experts (one SwiGLU of ``n_shared_experts`` times
the expert width) a token; ``router``, the router's product; ``attention``,
q·kᵀ and p·v of the tower (query/key heads of 192, value heads of 128) and
of ViLT; ``patch``, the patch projection.  Not counted: lookups, norms,
RoPE, softmax, the routing's bookkeeping, the pooler and the head.  A
training step would be 3× the forward (the family does not train).

At Moonlight-16B-A3B + ViLT-B/32, batch 256, 40 tokens and a 384 × 608
canvas: routed experts 27.6 TFLOP, routed and shared 36.9, the tower's
attention projections 7.6, 58.1 in all.
"""

from __future__ import annotations

from typing import Dict, Tuple


def vilt_length(cfg: dict, seq: int, canvas: Tuple[int, int]) -> int:
    """ViLT's joint length: the text tokens, the image CLS and
    ``min(num_patch_tokens, patches on the canvas)`` patch tokens."""
    p = cfg["vilt"]["patch_size"]
    patches = (canvas[0] // p) * (canvas[1] // p)
    return seq + 1 + min(cfg["assumed"]["num_patch_tokens"], patches)


def forward_products(cfg: dict, batch: int, seq: int, canvas: Tuple[int, int]) -> Dict[str, float]:
    """FLOPs of one forward by kind (see the module docstring)."""
    t, v = cfg["text_tower"], cfg["vilt"]
    h, n, tokens = t["hidden_size"], t["num_attention_heads"], batch * seq
    dn, dr, dv, r = t["qk_nope_head_dim"], t["qk_rope_head_dim"], t["v_head_dim"], t["kv_lora_rank"]
    moe_layers = t["num_hidden_layers"] - t["first_k_dense_replace"]
    projections = h * n * (dn + dr) + h * (r + dr) + r * n * (dn + dv) + n * dv * h
    i = t["moe_intermediate_size"]
    out = {
        "dense": 2.0 * tokens * (t["num_hidden_layers"] * projections
                                 + t["first_k_dense_replace"] * 3 * h * t["intermediate_size"]
                                 + h * v["hidden_size"]),
        "experts": 2.0 * tokens * moe_layers * 3 * h * i
        * (t["num_experts_per_tok"] + t["n_shared_experts"]),
        "router": 2.0 * tokens * moe_layers * h * t["n_routed_experts"],
        "attention": 2.0 * batch * seq * seq * n * (dn + dr + dv) * t["num_hidden_layers"],
    }
    length, hv = vilt_length(cfg, seq, canvas), v["hidden_size"]
    rows = batch * length
    out["dense"] += v["num_hidden_layers"] * 2.0 * rows * hv * (4 * hv + 2 * v["intermediate_size"])
    out["attention"] += v["num_hidden_layers"] * 4.0 * batch * length * length * hv
    p = v["patch_size"]
    patches = (canvas[0] // p) * (canvas[1] // p)
    out["patch"] = 2.0 * batch * patches * (v["num_channels"] * p * p) * hv
    return out


TRAIN_FACTOR = 3.0  # forward + the backward's two products per product


def train_step_flops(cfg: dict, batch: int, seq: int, canvas: Tuple[int, int]) -> float:
    return TRAIN_FACTOR * sum(forward_products(cfg, batch, seq, canvas).values())
