"""Transformer blocks of the Tom* model families (port of
``vault_tpu/models/modules.py``).

  * cross-attention layer: Q from the querying stream, K/V from the queried
    stream, in a post-LN BERT block without self-attention
    (vault/modules.py:22-99);
  * cross encoder: a stack where only the querying stream updates
    (vault/modules.py:104-166);
  * BertPoolerDim: the tanh pooler over any token index or indices
    (vault/modules.py:169-207).

Parameters are named after the JAX package's pytree keys; the cross
encoder's layers are ``layers.<i>`` modules, as in ``models/bert.py``.
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

import torch
from torch import nn

from vault_tpu_torch.config import TextTowerConfig
from vault_tpu_torch.models.bert import _init_layer
from vault_tpu_torch.ops.attention import (
    attend_plain,
    merge_heads,
    parse_impl,
    split_heads,
)
from vault_tpu_torch.ops.nn import (
    ParamDict,
    act_fn,
    dropout,
    init_linear,
    layer_norm,
    linear,
)


def init_cross_layer(gen: torch.Generator, cfg: TextTowerConfig) -> ParamDict:
    """One cross block: the leaves of a BERT layer (q, k, v, attn_out,
    attn_ln, mlp_in, mlp_out, mlp_ln), so a BERT layer seeds it."""
    return _init_layer(gen, cfg)


def init_cross_encoder(gen: torch.Generator, cfg: TextTowerConfig,
                       num_layers: Optional[int] = None) -> ParamDict:
    n = num_layers if num_layers is not None else cfg.num_hidden_layers
    return ParamDict(layers=nn.ModuleList(init_cross_layer(gen, cfg)
                                          for _ in range(n)))


def cross_layer_apply(lp, cfg: TextTowerConfig, querying, queried, bias,
                      deterministic=True, generator=None, use_pallas="auto"):
    """One cross block: cross-attention, post-LN, MLP, post-LN.  Q, K and V
    are three products (K and V read the other stream, so there is no fused
    QKV product).  The MLP half runs the fused post-LN block
    (``ops/cuda_mlp.py``) when the selector resolves "fusemlp", with its
    dropout as a mask operand, as a BERT layer's does."""
    _, _, fuse_mlp, _ = parse_impl(use_pallas, querying.device)
    heads = cfg.num_attention_heads
    q = split_heads(linear(lp["q"], querying), heads)
    k = split_heads(linear(lp["k"], queried), heads)
    v = split_heads(linear(lp["v"], queried), heads)
    # The plain composition by selection: the JAX package runs this
    # attention on XLA (vault_tpu/models/modules.py calls ``attend`` without
    # a kernel selector), and its keys (the image regions) are not as long
    # as its queries, which the encoder-attention kernel does not take.
    ctx = merge_heads(attend_plain(q, k, v, bias, generator,
                                   cfg.attention_probs_dropout_prob,
                                   deterministic))
    attn = linear(lp["attn_out"], ctx)
    attn = dropout(generator, attn, cfg.hidden_dropout_prob, deterministic)
    x = layer_norm(lp["attn_ln"], querying + attn, cfg.layer_norm_eps)

    if fuse_mlp:
        from vault_tpu_torch.ops.cuda_mlp import fused_postln_mlp

        return fused_postln_mlp(lp, cfg, x, generator, deterministic)
    mlp = act_fn(cfg.hidden_act)(linear(lp["mlp_in"], x))
    mlp = linear(lp["mlp_out"], mlp)
    mlp = dropout(generator, mlp, cfg.hidden_dropout_prob, deterministic)
    return layer_norm(lp["mlp_ln"], x + mlp, cfg.layer_norm_eps)


def cross_encoder_apply(params, cfg: TextTowerConfig, querying, queried, bias,
                        deterministic=True, generator=None, use_pallas="auto"):
    """Only the querying stream updates from layer to layer
    (vault/modules.py:104-166)."""
    for lp in params["layers"]:
        querying = cross_layer_apply(lp, cfg, querying, queried, bias,
                                     deterministic, generator, use_pallas)
    return querying


def init_pooler_dim(gen: torch.Generator, hidden_size: int,
                    num_tokens: int = 1, stddev: float = 0.02) -> ParamDict:
    return ParamDict(dense=init_linear(gen, hidden_size, hidden_size, stddev))


def pooler_dim_apply(params, hidden_states,
                     tokens: Union[int, Sequence[int]] = 0):
    """Tanh-pool the given token index (B, H) or indices (B, n, H)
    (vault/modules.py:169-207)."""
    tok = hidden_states[:, tokens if isinstance(tokens, int) else list(tokens)]
    return torch.tanh(linear(params["dense"], tok))
