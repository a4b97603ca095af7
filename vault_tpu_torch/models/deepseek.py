"""DeepSeek-V3-architecture text tower (Moonlight-16B-A3B's geometry by
default): the numerical contract of the published ``modeling_deepseek.py``
(``model_type`` ``deepseek_v3``) for a forward pass without a cache.  The
JAX package has no such tower; this module is the port's own, tested
against a plain fp32 reference (``tests/deepseek_reference.py``).

For x (B, L, H), each layer computes

  * multi-head latent attention (MLA) without query compression:
    ``h = rms(x)``; ``q = h Wq`` split per head into ``q_nope`` (128) and
    ``q_pe`` (64); ``[c, k_pe] = h Wkv_a`` (512 + 64, ``k_pe`` one head
    shared by every head); ``[k_nope, v] = rms_kv(c) Wkv_b`` per head (128 +
    128); RoPE on ``q_pe`` and ``k_pe``, rotating adjacent pairs (2i, 2i + 1)
    by position · θ^(−2i/64); attention of ``[q_nope, q_pe]`` against
    ``[k_nope, k_pe]`` scaled by 192^−½ under a causal + padding mask, over
    ``v``; ``x += o Wo``;
  * the MLP half: layers before ``first_k_dense_replace`` a SwiGLU of
    ``intermediate_size``; the others ``x += moe(h) + shared(h)``, ``h =
    rms(x)``, with the routed experts of ``ops/moe.py`` (a sigmoid router,
    ``num_experts_per_tok`` of ``n_routed_experts``) and the shared experts
    as one SwiGLU of width ``n_shared_experts · moe_intermediate_size``;

and a final RMSNorm gives ``last_hidden_state``.

Departures from the published code, each a rounding or a layout:

  * ``kv_a_layernorm`` keeps its class default eps 1e-6 (``kv_norm_eps``),
    as the published code builds it, not the config's ``rms_norm_eps``.
  * RMSNorm multiplies its fp32 weight by the fp32 normalised row and
    casts once (``ops/nn.py`` ``rms_norm``), where HF casts the normalised
    row to the input's type before the weight.
  * RoPE is computed in fp32 and cast once, where HF casts cos and sin to
    the activations' type; the rotated pairs stay in place, where HF
    de-interleaves them (evens first): the same dot products.
  * Attention is the port's plain composition (``ops/attention.py``
    ``attend_plain``: fp32 scores and softmax, probabilities cast to v's
    type): at 40 positions it is 0.2% of the tower's products, and its
    query/key head size (192) is above the attention kernel's 128.
  * the routed experts round as ``ops/moe.py`` says.

Only the published configuration's branches are written: no query
compression (``q_lora_rank`` None), one expert group (``n_group`` =
``topk_group`` = 1), the sigmoid router with ``noaux_tc`` choice, an MoE
layer every layer after the dense ones; other values raise.

Parameters (``ParamDict``; projections ``{"w": (in, out)}`` as the port's
``linear`` takes them, experts (out, in) as HF holds them): ``embed``;
per layer ``input_ln``, ``q``, ``kv_a``, ``kv_ln``, ``kv_b``, ``o``,
``post_ln``, then ``mlp`` (gate, up, down) or ``router``, ``router_bias``
(``e_score_correction_bias``), ``experts`` (gate, up (E, I, H); down (E,
H, I)) and ``shared`` (gate, up, down); ``final_ln``.

Spans (``utils/profiling.py`` ``span``, only while a profiler records):
``vault.text_embed`` around the lookup, ``vault.layer`` around each
layer, inside it ``vault.mla`` and, in an MoE layer, ``vault.moe``
holding ``vault.moe.route``, ``.experts``, ``.combine`` and ``.shared``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch
from torch import nn

from vault_tpu_torch.ops.attention import attend_plain, merge_heads
from vault_tpu_torch.ops.moe import routed_experts
from vault_tpu_torch.ops.nn import ParamDict, linear, rms_norm, silu
from vault_tpu_torch.utils.profiling import span


@dataclass(frozen=True)
class DeepseekConfig:
    """Defaults are the published ``moonshotai/Moonlight-16B-A3B`` geometry."""
    vocab_size: int = 163840
    hidden_size: int = 2048
    num_hidden_layers: int = 27
    num_attention_heads: int = 16
    intermediate_size: int = 11264
    moe_intermediate_size: int = 1408
    first_k_dense_replace: int = 1
    moe_layer_freq: int = 1
    n_routed_experts: int = 64
    n_shared_experts: int = 2
    num_experts_per_tok: int = 6
    n_group: int = 1
    topk_group: int = 1
    norm_topk_prob: bool = True
    routed_scaling_factor: float = 2.446
    scoring_func: str = "sigmoid"
    topk_method: str = "noaux_tc"
    q_lora_rank: Optional[int] = None
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128
    rms_norm_eps: float = 1e-5
    # the published code builds kv_a_layernorm with its class default
    kv_norm_eps: float = 1e-6
    rope_theta: float = 50000.0
    initializer_range: float = 0.02

    @property
    def qk_head_dim(self) -> int:
        return self.qk_nope_head_dim + self.qk_rope_head_dim

    def is_moe(self, layer: int) -> bool:
        return layer >= self.first_k_dense_replace and layer % self.moe_layer_freq == 0

    def check(self) -> None:
        """Raise ``ValueError`` on a branch of the published code this
        module does not hold."""
        unheld = {"q_lora_rank": (self.q_lora_rank, None), "n_group": (self.n_group, 1),
                  "topk_group": (self.topk_group, 1), "moe_layer_freq": (self.moe_layer_freq, 1),
                  "scoring_func": (self.scoring_func, "sigmoid"),
                  "topk_method": (self.topk_method, "noaux_tc")}
        bad = [f"{k}={v!r} (held: {want!r})" for k, (v, want) in unheld.items() if v != want]
        if bad:
            raise ValueError("DeepseekConfig: " + ", ".join(bad))


def tiny_deepseek_config(**kw) -> DeepseekConfig:
    """A small geometry for tests: 1 dense + 2 MoE layers, 8 experts with 2
    a token and 1 shared, widths of 32 and heads of 8 + 4 / 8."""
    base = dict(vocab_size=99, hidden_size=32, num_hidden_layers=3, num_attention_heads=4,
                intermediate_size=64, moe_intermediate_size=32, n_routed_experts=8,
                n_shared_experts=1, num_experts_per_tok=2, kv_lora_rank=16,
                qk_nope_head_dim=8, qk_rope_head_dim=4, v_head_dim=8, rope_theta=10000.0,
                initializer_range=0.1)
    base.update(kw)
    return DeepseekConfig(**base)


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------

def _draw(gen: Optional[torch.Generator], shape, std: float, dtype, device) -> torch.Tensor:
    """normal(0, std) of ``shape`` from ``gen`` in ``dtype``; on the meta
    device (``gen`` None) storage alone."""
    if gen is None:
        return torch.empty(shape, dtype=dtype, device=device)
    return (torch.randn(shape, generator=gen, device=device) * std).to(dtype)


def _proj(gen, cfg, in_dim, out_dim, dtype, device) -> ParamDict:
    return ParamDict(w=_draw(gen, (in_dim, out_dim), cfg.initializer_range, dtype, device))


def _swiglu_params(gen, cfg, hidden, inter, dtype, device) -> ParamDict:
    return ParamDict(gate=_proj(gen, cfg, hidden, inter, dtype, device),
                     up=_proj(gen, cfg, hidden, inter, dtype, device),
                     down=_proj(gen, cfg, inter, hidden, dtype, device))


def _init_layer(gen, cfg: DeepseekConfig, layer: int, dtype, device) -> ParamDict:
    h, n = cfg.hidden_size, cfg.num_attention_heads
    ones = lambda d: torch.ones(d, device=device)  # noqa: E731
    p = dict(input_ln=ones(h),
             q=_proj(gen, cfg, h, n * cfg.qk_head_dim, dtype, device),
             kv_a=_proj(gen, cfg, h, cfg.kv_lora_rank + cfg.qk_rope_head_dim, dtype, device),
             kv_ln=ones(cfg.kv_lora_rank),
             kv_b=_proj(gen, cfg, cfg.kv_lora_rank, n * (cfg.qk_nope_head_dim + cfg.v_head_dim),
                        dtype, device),
             o=_proj(gen, cfg, n * cfg.v_head_dim, h, dtype, device),
             post_ln=ones(h))
    if not cfg.is_moe(layer):
        p["mlp"] = _swiglu_params(gen, cfg, h, cfg.intermediate_size, dtype, device)
        return ParamDict(**p)
    e, i, std = cfg.n_routed_experts, cfg.moe_intermediate_size, cfg.initializer_range
    p["router"] = _proj(gen, cfg, h, e, dtype, device)
    p["router_bias"] = torch.zeros(e, device=device)
    p["experts"] = ParamDict(gate=_draw(gen, (e, i, h), std, dtype, device),
                             up=_draw(gen, (e, i, h), std, dtype, device),
                             down=_draw(gen, (e, h, i), std, dtype, device))
    p["shared"] = _swiglu_params(gen, cfg, h, cfg.n_shared_experts * i, dtype, device)
    return ParamDict(**p)


def init_deepseek(gen: Optional[torch.Generator], cfg: DeepseekConfig, dtype=torch.float32,
                  device=None) -> ParamDict:
    """Seeded random tower parameters on ``gen``'s device: the embedding,
    the projections and the experts normal(0, initializer range) in
    ``dtype``, the norm weights ones and the router bias zeros in fp32.
    ``gen`` None: storage alone on ``device`` (the meta device, for a module
    whose weights are loaded with ``assign``)."""
    cfg.check()
    device = gen.device if gen is not None else torch.device(device)
    embed = _draw(gen, (cfg.vocab_size, cfg.hidden_size), cfg.initializer_range, dtype, device)
    layers = nn.ModuleList(_init_layer(gen, cfg, i, dtype, device)
                           for i in range(cfg.num_hidden_layers))
    return ParamDict(embed=embed, layers=layers,
                     final_ln=torch.ones(cfg.hidden_size, device=device))


# ---------------------------------------------------------------------------
# Apply
# ---------------------------------------------------------------------------

def rope_pairs(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x (B, heads, L, d) with each adjacent pair (2i, 2i + 1) of its last
    dim rotated by the angle position · θ^(−2i/d), in fp32, cast once.
    ``positions`` (B, L).  The frequencies are made on x's device."""
    d = x.shape[-1]
    inv_freq = 1.0 / theta ** (torch.arange(0, d, 2, device=x.device, dtype=torch.float32) / d)
    angle = positions[:, None, :, None].float() * inv_freq     # (B, 1, L, d/2)
    cos, sin = torch.cos(angle), torch.sin(angle)
    pairs = x.float().unflatten(-1, (d // 2, 2))
    a, b = pairs[..., 0], pairs[..., 1]
    return torch.stack([a * cos - b * sin, b * cos + a * sin], dim=-1).flatten(-2).to(x.dtype)


def mla(lp, cfg: DeepseekConfig, x, bias, positions):
    """The attention half of a layer: ``x + o(attention)`` (see the module
    docstring); ``bias`` (B, 1, L, L) additive fp32."""
    b, l, _ = x.shape
    n, dn, dr, dv = (cfg.num_attention_heads, cfg.qk_nope_head_dim, cfg.qk_rope_head_dim,
                     cfg.v_head_dim)
    h = rms_norm(lp["input_ln"], x, cfg.rms_norm_eps)
    q = linear(lp["q"], h).view(b, l, n, dn + dr).transpose(1, 2)
    c, k_pe = linear(lp["kv_a"], h).split([cfg.kv_lora_rank, dr], dim=-1)
    kv = linear(lp["kv_b"], rms_norm(lp["kv_ln"], c, cfg.kv_norm_eps))
    k_nope, v = kv.view(b, l, n, dn + dv).transpose(1, 2).split([dn, dv], dim=-1)
    q_pe = rope_pairs(q[..., dn:], positions, cfg.rope_theta)
    k_pe = rope_pairs(k_pe[:, None], positions, cfg.rope_theta)
    q = torch.cat([q[..., :dn], q_pe], dim=-1)
    k = torch.cat([k_nope, k_pe.expand(b, n, l, dr)], dim=-1)
    return x + linear(lp["o"], merge_heads(attend_plain(q, k, v, bias)))


def swiglu(p, h):
    """``down(silu(gate(h)) * up(h))``, the port's plain composition."""
    return linear(p["down"], silu(linear(p["gate"], h)) * linear(p["up"], h))


def _layer(lp, cfg: DeepseekConfig, layer: int, x, bias, positions, routes):
    with span("vault.mla"):
        x = mla(lp, cfg, x, bias, positions)
    if not cfg.is_moe(layer):
        return x + swiglu(lp["mlp"], rms_norm(lp["post_ln"], x, cfg.rms_norm_eps))
    with span("vault.moe"):
        h = rms_norm(lp["post_ln"], x, cfg.rms_norm_eps)
        routed = routed_experts(h, lp, cfg.num_experts_per_tok, cfg.routed_scaling_factor,
                                cfg.norm_topk_prob, routes)
        with span("vault.moe.shared"):
            shared = swiglu(lp["shared"], h)
        return x + (routed + shared)


def deepseek_apply(params, cfg: DeepseekConfig, input_ids, attention_mask=None,
                   position_ids=None, routes=None):
    """Returns last_hidden_state (B, L, H) under a causal + padding mask.
    ``routes``, a list, gets each MoE layer's chosen experts (B L, k), as
    routed.  Nothing here reads the device on the host: on the card a
    forward never synchronises."""
    cfg.check()
    b, l = input_ids.shape
    with span("vault.text_embed"):
        x = params["embed"][input_ids]
    dev = x.device
    if position_ids is None:
        position_ids = torch.arange(l, device=dev).expand(b, l)
    keep = torch.tril(torch.ones((l, l), dtype=torch.float32, device=dev))[None, None]
    if attention_mask is not None:
        keep = keep * attention_mask.float()[:, None, None, :]
    bias = (1.0 - keep) * torch.finfo(torch.float32).min
    for i, lp in enumerate(params["layers"]):
        with span("vault.layer"):
            x = _layer(lp, cfg, i, x, bias, position_ids, routes)
    return rms_norm(params["final_ln"], x, cfg.rms_norm_eps)
