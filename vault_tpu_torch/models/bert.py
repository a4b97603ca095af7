"""BERT / RoBERTa (BERTweet) language tower (port of ``vault_tpu/models/bert.py``).

The numerical contract of HF ``BertModel`` /
``RobertaModel(add_pooling_layer=False)`` as the reference uses it for the
VAuLT LM tower (vault/models/vault/model.py:82-86, 118-122, 189-190):
post-LayerNorm encoder, exact GELU, additive attention mask, fp32 LayerNorm.

The JAX package stacks the layers on axis 0 and runs them with
``lax.scan``; here they are an ``nn.ModuleList`` run by a Python loop.
Parameters are named after the JAX package's pytree keys.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from vault_tpu_torch.config import TextTowerConfig
from vault_tpu_torch.ops.attention import (
    attend,
    merge_heads,
    parse_impl,
    project_qkv,
)
from vault_tpu_torch.ops.masks import extend_attention_mask
from vault_tpu_torch.ops.nn import (
    ParamDict,
    act_fn,
    dropout,
    init_embedding,
    init_layer_norm,
    init_linear,
    layer_norm,
    linear,
    remat_apply,
    take,
)
from vault_tpu_torch.parallel.tensor_parallel import (
    current_tp,
    local_heads,
    row_linear,
)


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------

def _init_layer(gen: torch.Generator, cfg: TextTowerConfig) -> ParamDict:
    h, i = cfg.hidden_size, cfg.intermediate_size
    s = cfg.initializer_range
    return ParamDict(
        q=init_linear(gen, h, h, s),
        k=init_linear(gen, h, h, s),
        v=init_linear(gen, h, h, s),
        attn_out=init_linear(gen, h, h, s),
        attn_ln=init_layer_norm(h),
        mlp_in=init_linear(gen, h, i, s),
        mlp_out=init_linear(gen, i, h, s),
        mlp_ln=init_layer_norm(h),
    )


def init_bert(gen: torch.Generator, cfg: TextTowerConfig) -> ParamDict:
    """Seeded random BERT parameters on the host, fp32."""
    embeddings = ParamDict(
        word=init_embedding(gen, cfg.vocab_size, cfg.hidden_size,
                            cfg.initializer_range, padding_idx=cfg.pad_token_id),
        position=init_embedding(gen, cfg.max_position_embeddings,
                                cfg.hidden_size, cfg.initializer_range),
        token_type=init_embedding(gen, cfg.type_vocab_size, cfg.hidden_size,
                                  cfg.initializer_range),
        ln=init_layer_norm(cfg.hidden_size),
    )
    layers = nn.ModuleList(_init_layer(gen, cfg)
                           for _ in range(cfg.num_hidden_layers))
    return ParamDict(embeddings=embeddings, layers=layers)


def grow_word_embeddings(bert_params, new_size: int,
                         generator: Optional[torch.Generator] = None,
                         stddev: float = 0.02):
    """Grow a BERT tower's word table to ``new_size`` rows, the new rows
    drawn normal(0, stddev) from ``generator`` (HF resize_token_embeddings
    semantics, used by TomBERT's resize, reference
    vault/models/tombert/model.py:185-187).  ``bert_params`` is the tower's
    state dict (key ``embeddings.word``); a new one is returned, the old
    rows unchanged.  The draws follow the JAX package's rule, not its
    stream."""
    return {**bert_params, "embeddings.word": grow_rows(
        bert_params["embeddings.word"], new_size, generator, stddev)}


def grow_rows(table, new_size: int,
              generator: Optional[torch.Generator] = None,
              stddev: float = 0.02):
    """``table`` with rows appended up to ``new_size``, each drawn
    normal(0, stddev) from ``generator`` (seed 0 when none is given); the
    table itself when it already has ``new_size`` rows or more."""
    old, dim = table.shape
    if new_size <= old:
        return table
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    extra = torch.randn((new_size - old, dim), generator=generator,
                        device=generator.device) * stddev
    return torch.cat([table, extra.to(table.device, table.dtype)])


# ---------------------------------------------------------------------------
# Apply
# ---------------------------------------------------------------------------

def roberta_position_ids(input_ids, attention_mask, pad_token_id: int):
    """HF ``create_position_ids_from_input_ids``: positions count non-pad
    tokens, offset by padding_idx; pad positions get padding_idx."""
    if attention_mask is None:
        mask = (input_ids != pad_token_id).to(torch.int64)
    else:
        mask = attention_mask.to(torch.int64)
    return torch.cumsum(mask, dim=1) * mask + pad_token_id


def bert_embed(params, cfg: TextTowerConfig, input_ids, token_type_ids=None,
               position_ids=None, inputs_embeds=None, attention_mask=None,
               deterministic=True, generator=None):
    emb = params["embeddings"]
    if inputs_embeds is None:
        inputs_embeds = take(emb["word"], input_ids)
    b, l = inputs_embeds.shape[:2]
    dev = inputs_embeds.device
    if position_ids is None:
        if cfg.position_embedding_style == "roberta":
            if input_ids is not None:
                position_ids = roberta_position_ids(input_ids, attention_mask,
                                                    cfg.pad_token_id)
            else:
                position_ids = torch.arange(
                    cfg.pad_token_id + 1, l + cfg.pad_token_id + 1,
                    device=dev).expand(b, l)
        else:
            position_ids = torch.arange(l, device=dev).expand(b, l)
    if token_type_ids is None:
        token_type_ids = torch.zeros((b, l), dtype=torch.int64, device=dev)

    x = (inputs_embeds + take(emb["position"], position_ids)
         + take(emb["token_type"], token_type_ids))
    x = layer_norm(emb["ln"], x, cfg.layer_norm_eps)
    return dropout(generator, x, cfg.hidden_dropout_prob, deterministic)


def _encoder_layer_tp(lp, cfg: TextTowerConfig, x, bias, deterministic,
                      generator, use_pallas, tp):
    """One post-LN BERT layer on this shard's heads and intermediate
    columns (parallel/tensor_parallel.py): Q/K/V and ``mlp_in`` column
    shards, ``attn_out`` and ``mlp_out`` row shards summed before the bias,
    the residual and the LN.  The products run the plain composition; the
    attention core runs the selector's kernel on the local heads.  The
    dropout draws are the unsharded layer's, cut to the local heads."""
    fuse_qkv = parse_impl(use_pallas, x.device)[0]
    q, k, v = project_qkv(lp, tp.enter(x), local_heads(cfg.num_attention_heads, tp),
                          fuse_qkv)
    ctx = merge_heads(attend(q, k, v, bias, generator,
                             cfg.attention_probs_dropout_prob, deterministic,
                             use_pallas=use_pallas))
    attn = dropout(generator, row_linear(lp["attn_out"], ctx, tp),
                   cfg.hidden_dropout_prob, deterministic)
    x = layer_norm(lp["attn_ln"], x + attn, cfg.layer_norm_eps)
    mlp = act_fn(cfg.hidden_act)(linear(lp["mlp_in"], tp.enter(x)))
    mlp = dropout(generator, row_linear(lp["mlp_out"], mlp, tp),
                  cfg.hidden_dropout_prob, deterministic)
    return layer_norm(lp["mlp_ln"], x + mlp, cfg.layer_norm_eps)


def _encoder_layer(lp, cfg: TextTowerConfig, x, bias, deterministic,
                   generator=None, use_pallas="auto"):
    """One post-LN BERT layer (on the shards of the active tensor-parallel
    group, when one is set)."""
    tp = current_tp()
    if tp is not None:
        return _encoder_layer_tp(lp, cfg, x, bias, deterministic, generator,
                                 use_pallas, tp)
    fuse_qkv, _, fuse_mlp, _ = parse_impl(use_pallas, x.device)
    q, k, v = project_qkv(lp, x, cfg.num_attention_heads, fuse_qkv)
    ctx = merge_heads(attend(q, k, v, bias, generator,
                             cfg.attention_probs_dropout_prob, deterministic,
                             use_pallas=use_pallas))
    attn = linear(lp["attn_out"], ctx)
    attn = dropout(generator, attn, cfg.hidden_dropout_prob, deterministic)
    x = layer_norm(lp["attn_ln"], x + attn, cfg.layer_norm_eps)

    if fuse_mlp:
        from vault_tpu_torch.ops.cuda_mlp import fused_postln_mlp

        return fused_postln_mlp(lp, cfg, x, generator, deterministic)
    mlp = act_fn(cfg.hidden_act)(linear(lp["mlp_in"], x))
    mlp = linear(lp["mlp_out"], mlp)
    mlp = dropout(generator, mlp, cfg.hidden_dropout_prob, deterministic)
    return layer_norm(lp["mlp_ln"], x + mlp, cfg.layer_norm_eps)


def bert_encode(params, cfg: TextTowerConfig, x, attention_mask,
                deterministic=True, generator=None, use_pallas="auto",
                bias=None, remat=False):
    """Run the encoder layers, each under activation checkpointing when
    ``remat`` (ops/nn.py ``remat_apply``).  ``bias`` (a prebuilt additive
    mask) takes precedence over ``attention_mask``."""
    if bias is None and attention_mask is not None:
        bias = extend_attention_mask(attention_mask, torch.float32)
    for lp in params["layers"]:
        x = remat_apply(_encoder_layer, remat, generator, lp, cfg, x, bias,
                        deterministic, use_pallas=use_pallas)
    return x


def bert_apply(params, cfg: TextTowerConfig, input_ids=None,
               attention_mask=None, token_type_ids=None, position_ids=None,
               inputs_embeds=None, deterministic=True,
               generator: Optional[torch.Generator] = None,
               use_pallas="auto", remat=False):
    """Full tower: embeddings + encoder.  Returns last_hidden_state (B, L, H).

    Mirrors ``self.bert(**bert_kwargs).last_hidden_state`` at
    vault/models/vault/model.py:189-190.  Dropout, when not deterministic,
    draws from ``generator``.
    """
    x = bert_embed(params, cfg, input_ids, token_type_ids, position_ids,
                   inputs_embeds, attention_mask, deterministic, generator)
    return bert_encode(params, cfg, x, attention_mask, deterministic,
                       generator, use_pallas, remat=remat)
