"""Llama-architecture text tower (port of ``vault_tpu/models/llama.py``):
the numerical contract of HF ``LlamaModel``: RMSNorm (pre-norm), rotary
position embeddings (rotate-half convention), grouped-query attention,
SwiGLU MLP, no biases, causal + padding mask.  A projection adapter
(:func:`init_lm_projection`) maps the tower width (4096 for 8B) onto ViLT's
768 before the co-encoder takes it as ``inputs_embeds``.

The JAX package stacks the layers on axis 0 and runs them with
``lax.scan``; here they are an ``nn.ModuleList`` run by a Python loop.
Parameters are named after the JAX package's pytree keys (``embed``,
``input_ln``, ``post_ln`` and ``final_ln`` are bare tensors, the seven
projections ``{"w"}`` modules without biases).  A HF checkpoint loads
through ``models/convert.py`` ``llama_params_from_torch``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch
from torch import nn

from vault_tpu_torch.ops.attention import attend, merge_heads, split_heads
from vault_tpu_torch.ops.attention import gqa_attend_plain as _gqa_attend
from vault_tpu_torch.ops.nn import ParamDict, init_linear, linear, silu
from vault_tpu_torch.ops.nn import rms_norm as _rms_norm
from vault_tpu_torch.parallel.tensor_parallel import current_tp, enter, local_heads, row_linear
from vault_tpu_torch.ops.quantize import QUANT_MODES, k_major_site, quantize_linear_params


@dataclass(frozen=True)
class LlamaConfig:
    """Defaults are the published ``meta-llama/Meta-Llama-3-8B`` geometry."""
    vocab_size: int = 128256
    hidden_size: int = 4096
    num_hidden_layers: int = 32
    num_attention_heads: int = 32
    num_key_value_heads: int = 8
    intermediate_size: int = 14336
    max_position_embeddings: int = 8192
    rms_norm_eps: float = 1e-5
    rope_theta: float = 500000.0
    initializer_range: float = 0.02
    # the JAX package's lax.scan unroll factor: kept so that configs carry
    # across; it has no effect on a Python loop over unstacked layers
    scan_unroll: int = 1
    # attention implementation: "xla" (the plain grouped composition,
    # gqa_attend_plain) or "pallas" (the GQA attention kernel,
    # ops/cuda_attention.fused_attention_gqa); the JAX package's names
    attn_impl: str = "xla"
    # MLP implementation: "xla" (the plain composition) or "pallas" (the
    # fused w8a8 RMSNorm -> SwiGLU -> residual kernel, ops/cuda_swiglu.py).
    # The kernel runs only when gate, up and down carry w8a8 parameters; its
    # requantization grouping is per (row, I-tile), finer than the plain
    # path's per row.
    mlp_impl: str = "xla"

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads


def tiny_llama_config(**kw) -> LlamaConfig:
    base = dict(vocab_size=99, hidden_size=32, num_hidden_layers=2,
                num_attention_heads=4, num_key_value_heads=2,
                intermediate_size=64, max_position_embeddings=64,
                rope_theta=10000.0)
    base.update(kw)
    return LlamaConfig(**base)


def _rope(x, position_ids, theta, head_dim):
    """HF rotate-half RoPE: cos/sin over [0, d/2) frequencies, applied as
    x*cos + rotate_half(x)*sin.  The inverse frequencies are taken with
    numpy in float32, as the JAX package takes them (``torch.pow`` rounds
    them another way at a theta of 500000); cos and sin are fp32, x is
    upcast, rotated and cast back once."""
    inv_freq = 1.0 / (theta ** (np.arange(0, head_dim, 2, dtype=np.float32)
                                / head_dim))
    inv_freq = torch.from_numpy(inv_freq.astype(np.float32)).to(x.device)
    freqs = position_ids[..., None].float() * inv_freq[None, None]
    emb = torch.cat([freqs, freqs], dim=-1)              # (B, L, D)
    cos = torch.cos(emb)[:, None]                        # (B, 1, L, D)
    sin = torch.sin(emb)[:, None]
    half = x.shape[-1] // 2
    rot = torch.cat([-x[..., half:], x[..., :half]], dim=-1)
    return (x.float() * cos + rot.float() * sin).to(x.dtype)


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------

def _init_layer(gen: torch.Generator, cfg: LlamaConfig, dtype, quantize) -> ParamDict:
    """One layer, drawn on the generator's device.  With ``quantize`` each
    projection is drawn in fp32 and turned into int8 codes and fp32 scales
    at once, so no more than one projection's fp weights exist at a time;
    the MLP's w8a8 codes come K-major (ops/quantize.py ``k_major``), the
    layout the SwiGLU kernel reads."""
    h, i = cfg.hidden_size, cfg.intermediate_size
    kvh = cfg.num_key_value_heads * cfg.head_dim
    dev = gen.device

    def proj(name, in_dim, out_dim):
        w = torch.randn((in_dim, out_dim), generator=gen, device=dev) * cfg.initializer_range
        if quantize is None:
            return ParamDict(w=w.to(dtype))
        return ParamDict(**quantize_linear_params({"w": w}, quantize,
                                                  k_major_site(name, quantize)))

    return ParamDict(
        input_ln=torch.ones(h, device=dev),
        q=proj("q", h, h), k=proj("k", h, kvh), v=proj("v", h, kvh), o=proj("o", h, h),
        post_ln=torch.ones(h, device=dev),
        gate=proj("gate", h, i), up=proj("up", h, i), down=proj("down", i, h))


def init_llama(gen: torch.Generator, cfg: LlamaConfig, dtype=torch.float32,
               quantize: Optional[str] = None) -> ParamDict:
    """Seeded random tower parameters on ``gen``'s device: the embedding
    table and the projections in ``dtype``, the norm weights fp32.
    ``quantize`` ("w8" or "w8a8") builds the projections already quantized,
    layer by layer, so that the fp tree of a large tower never exists."""
    if quantize is not None and quantize not in QUANT_MODES:
        raise ValueError(f"unknown quantization mode {quantize!r}")
    dev = gen.device
    embed = (torch.randn((cfg.vocab_size, cfg.hidden_size), generator=gen, device=dev)
             * cfg.initializer_range).to(dtype)
    layers = nn.ModuleList(_init_layer(gen, cfg, dtype, quantize)
                           for _ in range(cfg.num_hidden_layers))
    return ParamDict(embed=embed, layers=layers,
                     final_ln=torch.ones(cfg.hidden_size, device=dev))


def init_lm_projection(gen: torch.Generator, in_dim: int, out_dim: int,
                       stddev: float = 0.02) -> ParamDict:
    """Width adapter: Llama hidden -> ViLT hidden, applied to the tower's
    last_hidden_state before it enters the co-encoder as inputs_embeds."""
    return init_linear(gen, in_dim, out_dim, stddev)


# ---------------------------------------------------------------------------
# Apply
# ---------------------------------------------------------------------------

def _layer(lp, cfg: LlamaConfig, x, bias, position_ids):
    """One Llama layer; under the active tensor-parallel group on this
    shard's heads (query and K/V heads split alike) and intermediate
    columns, the plain composition throughout, as the JAX package's
    tensor-parallel path runs (parallel/tensor_parallel.py)."""
    tp = current_tp()
    h = local_heads(cfg.num_attention_heads, tp)
    kvh = local_heads(cfg.num_key_value_heads, tp)
    d = cfg.head_dim
    b, l, _ = x.shape

    y = enter(_rms_norm(lp["input_ln"], x, cfg.rms_norm_eps), tp)
    q = split_heads(linear(lp["q"], y), h)
    k = split_heads(linear(lp["k"], y), kvh)
    v = split_heads(linear(lp["v"], y), kvh)
    q = _rope(q, position_ids, cfg.rope_theta, d)
    k = _rope(k, position_ids, cfg.rope_theta, d)
    if cfg.attn_impl == "pallas" and tp is None:
        from vault_tpu_torch.ops.cuda_attention import fused_attention_gqa

        bias4 = bias.expand(b, 1, l, l).float().contiguous()
        ctx = fused_attention_gqa(q, k, v, bias4)
    elif kvh != h:  # GQA: grouped attention, no materialized K/V repeat
        ctx = _gqa_attend(q, k, v, bias, h // kvh)
    else:
        ctx = attend(q, k, v, bias)
    x = x + row_linear(lp["o"], merge_heads(ctx), tp)

    return _mlp_block(lp, cfg, x, tp)


def _mlp_block(lp, cfg: LlamaConfig, x, tp):
    """The layer's MLP half: x + down(silu(gate(rms(x))) * up(rms(x))), on
    ``ops/cuda_swiglu.py`` ``swiglu_block`` for ``mlp_impl`` "pallas" and
    no group, else ``swiglu_block_plain``'s composition on ``tp``'s shards."""
    if cfg.mlp_impl == "pallas" and tp is None:
        from vault_tpu_torch.ops.cuda_swiglu import swiglu_block

        return swiglu_block(lp["post_ln"], lp["gate"], lp["up"], lp["down"], x,
                            cfg.rms_norm_eps)
    y = enter(_rms_norm(lp["post_ln"], x, cfg.rms_norm_eps), tp)
    return x + row_linear(lp["down"], silu(linear(lp["gate"], y)) * linear(lp["up"], y), tp)


def llama_apply(params, cfg: LlamaConfig, input_ids, attention_mask=None,
                position_ids=None):
    """Returns last_hidden_state (B, L, H) with causal+padding masking."""
    for name in ("attn_impl", "mlp_impl"):
        if getattr(cfg, name) not in ("xla", "pallas"):
            raise ValueError(f"LlamaConfig.{name} must be 'xla' or 'pallas', "
                             f"got {getattr(cfg, name)!r}")
    b, l = input_ids.shape
    x = params["embed"][input_ids]
    dev = x.device
    if position_ids is None:
        position_ids = torch.arange(l, device=dev).expand(b, l)
    keep = torch.tril(torch.ones((l, l), dtype=torch.float32, device=dev))[None, None]
    if attention_mask is not None:
        keep = keep * attention_mask.float()[:, None, None, :]
    bias = (1.0 - keep) * torch.finfo(torch.float32).min
    if cfg.attn_impl == "pallas":
        # the kernel's (B, 1, L, L) block, built once for all the layers
        bias = bias.expand(b, 1, l, l).contiguous()

    for lp in params["layers"]:
        x = _layer(lp, cfg, x, bias, position_ids)
    return _rms_norm(params["final_ln"], x, cfg.rms_norm_eps)
