"""ViLT vision-and-language co-encoder (port of ``vault_tpu/models/vilt.py``).

The numerical contract of HF ``ViltModel`` that the reference delegates to
(call sites vault/models/vault/model.py:204-218):

  * text embeddings: word + segment (+ optional absolute position), LN, dropout
  * visual path: 32x32 patch projection; per-image align-corners bilinear
    interpolation of the 12x12 position grid; valid-patch selection; CLS;
    modality-type embeddings; concat with text
  * 12 pre-LN transformer layers; final LayerNorm; tanh pooler on token 0.

As in the JAX package, valid patches are gathered valid-first in raster
order into a fixed ``num_patch_tokens`` budget with the padded slots masked
(HF instead samples them with ``torch.multinomial``).  Token merging
(ToMe, ``ops/token_merge.py``) merges the patch tokens at embedding time
(``merge_at_layer`` 0) or after ``merge_at_layer`` encoder layers, as the
JAX package does; the merged tokens' sizes ride the attention's additive
key bias as log(size).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
from torch import nn

from vault_tpu_torch.config import ViltConfig
from vault_tpu_torch.ops.attention import (
    attend,
    merge_heads,
    parse_impl,
    project_qkv,
    split_heads,
)
from vault_tpu_torch.ops.interpolate import (
    downsample_mask_nearest,
    interpolate_pos_grid,
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
    matmul_fp32,
    remat_apply,
    take,
)
from vault_tpu_torch.parallel.tensor_parallel import (
    current_tp,
    local_heads,
    row_linear,
)


class ViltOutput(NamedTuple):
    last_hidden_state: torch.Tensor   # (B, L_text + 1 + L_img, H)
    pooler_output: Optional[torch.Tensor]  # (B, H)
    attention_mask: torch.Tensor      # (B, L_text + 1 + L_img) joint mask


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------

def _init_layer(gen: torch.Generator, cfg: ViltConfig) -> ParamDict:
    h, i = cfg.hidden_size, cfg.intermediate_size
    s = cfg.initializer_range
    return ParamDict(
        ln_before=init_layer_norm(h),
        q=init_linear(gen, h, h, s, bias=cfg.qkv_bias),
        k=init_linear(gen, h, h, s, bias=cfg.qkv_bias),
        v=init_linear(gen, h, h, s, bias=cfg.qkv_bias),
        attn_out=init_linear(gen, h, h, s),
        ln_after=init_layer_norm(h),
        mlp_in=init_linear(gen, h, i, s),
        mlp_out=init_linear(gen, i, h, s),
    )


def init_vilt(gen: torch.Generator, cfg: ViltConfig,
              add_pooling_layer: bool = True) -> ParamDict:
    """Seeded random ViLT parameters on the host, fp32.  The patch
    projection keeps the conv's OIHW layout."""
    h, s, g = cfg.hidden_size, cfg.initializer_range, cfg.pos_grid
    p = dict(
        text_embeddings=ParamDict(
            word=init_embedding(gen, cfg.vocab_size, h, s, cfg.pad_token_id),
            position=init_embedding(gen, cfg.max_position_embeddings, h, s),
            token_type=init_embedding(gen, cfg.type_vocab_size, h, s),
            ln=init_layer_norm(h),
        ),
        cls_token=torch.zeros(h),
        patch_proj=ParamDict(
            w=torch.randn((h, cfg.num_channels, cfg.patch_size,
                           cfg.patch_size), generator=gen) * s,
            b=torch.zeros(h),
        ),
        pos_embeddings=torch.zeros(g * g + 1, h),
        modality_type=init_embedding(gen, cfg.modality_type_vocab_size, h, s),
        final_ln=init_layer_norm(h),
        layers=nn.ModuleList(_init_layer(gen, cfg)
                             for _ in range(cfg.num_hidden_layers)),
    )
    if add_pooling_layer:
        p["pooler"] = init_linear(gen, h, h, s)
    return ParamDict(**p)


# ---------------------------------------------------------------------------
# Embedding stages
# ---------------------------------------------------------------------------

def text_embed(params, cfg: ViltConfig, input_ids=None, token_type_ids=None,
               inputs_embeds=None, deterministic=True, generator=None):
    """ViLT TextEmbeddings; the position add is skipped when
    ``cfg.add_text_position_embeddings`` is False."""
    te = params["text_embeddings"]
    if inputs_embeds is None:
        inputs_embeds = take(te["word"], input_ids)
    b, l = inputs_embeds.shape[:2]
    dev = inputs_embeds.device
    if token_type_ids is None:
        token_type_ids = torch.zeros((b, l), dtype=torch.int64, device=dev)
    x = inputs_embeds + take(te["token_type"], token_type_ids)
    if cfg.add_text_position_embeddings:
        x = x + te["position"][torch.arange(l, device=dev)][None]
    x = layer_norm(te["ln"], x, cfg.layer_norm_eps)
    return dropout(generator, x, cfg.hidden_dropout_prob, deterministic)


def patchify(params, cfg: ViltConfig, pixel_values):
    """32x32/stride-32 patch projection -> (B, hidden, H', W'): space-to-depth
    plus one product over the OIHW weights, accumulated in fp32.  As in the
    JAX package (vilt.py:150), the bias is added AFTER the cast to the
    weights' dtype, unlike :func:`linear`."""
    w = params["patch_proj"]["w"]          # (O, I, ph, pw)
    o, i, ph, pw = w.shape
    x = pixel_values.to(w.dtype)
    b, c, h, wd = x.shape
    gh, gw = h // ph, wd // pw
    # (B, C, gh, ph, gw, pw) -> (B, gh, gw, C, ph, pw) -> (B, N, C*ph*pw)
    x = x.reshape(b, c, gh, ph, gw, pw).permute(0, 2, 4, 1, 3, 5)
    x = x.reshape(b, gh * gw, c * ph * pw)
    proj = matmul_fp32(x, w.reshape(o, i * ph * pw).t())
    proj = proj.to(w.dtype) + params["patch_proj"]["b"]
    return proj.transpose(1, 2).reshape(b, o, gh, gw)


def visual_embed(params, cfg: ViltConfig, pixel_values, pixel_mask,
                 deterministic=True, generator=None):
    """Patch tokens with interpolated position embeddings and validity mask.

    Returns (tokens (B, 1+L_img, H), mask (B, 1+L_img)) with CLS prepended;
    L_img = min(cfg.num_patch_tokens, H'*W'), valid patches first in raster
    order.
    """
    x = patchify(params, cfg, pixel_values)          # (B, Hd, H', W')
    b, hdim, gh, gw = x.shape
    n = gh * gw

    x_mask = downsample_mask_nearest(pixel_mask.to(torch.int32), gh, gw)
    x_h = x_mask[:, :, 0].sum(dim=1)                 # valid rows (col 0)
    x_w = x_mask[:, 0, :].sum(dim=1)                 # valid cols (row 0)

    grid = params["pos_embeddings"][1:].reshape(cfg.pos_grid, cfg.pos_grid,
                                                hdim)
    pos = interpolate_pos_grid(grid, x_h, x_w, gh, gw)    # (B, H', W', Hd)

    x = x.reshape(b, hdim, n).transpose(1, 2)             # (B, N, Hd) raster
    pos = pos.reshape(b, n, hdim)
    flat_mask = x_mask.reshape(b, n)

    # valid-first stable ordering, truncated to the token budget
    l_img = min(cfg.num_patch_tokens, n)
    order = torch.argsort(1 - flat_mask, dim=1, stable=True)[:, :l_img]
    idx = order[..., None].expand(b, l_img, hdim)
    x = torch.gather(x, 1, idx)
    pos = torch.gather(pos, 1, idx)
    sel_mask = torch.gather(flat_mask, 1, order)

    cls = params["cls_token"].expand(b, 1, hdim)
    cls_pos = params["pos_embeddings"][0].expand(b, 1, hdim)
    x = torch.cat([cls, x], dim=1)
    pos = torch.cat([cls_pos, pos], dim=1)
    x = x + pos
    x = dropout(generator, x, cfg.hidden_dropout_prob, deterministic)
    mask = torch.cat([torch.ones((b, 1), dtype=sel_mask.dtype,
                                 device=sel_mask.device), sel_mask], dim=1)
    return x, mask


def joint_embed(params, cfg: ViltConfig, input_ids=None, attention_mask=None,
                token_type_ids=None, pixel_values=None, pixel_mask=None,
                inputs_embeds=None, image_embeds=None, image_token_type_idx=1,
                deterministic=True, generator=None, merge_patches_to=None):
    """ViltEmbeddings.forward: text + visual + modality types, concatenated.

    Returns (tokens, mask, sizes); ``sizes`` is None unless
    ``merge_patches_to`` is set, in which case the patch tokens are
    ToMe-merged down to that count (ops/token_merge.py) and ``sizes``
    carries each token's multiplicity for proportional attention."""
    text = text_embed(params, cfg, input_ids, token_type_ids, inputs_embeds,
                      deterministic, generator)
    b, l_text = text.shape[:2]
    if attention_mask is None:
        attention_mask = torch.ones((b, l_text), dtype=torch.int32,
                                    device=text.device)
    if image_embeds is None:
        img, img_mask = visual_embed(params, cfg, pixel_values, pixel_mask,
                                     deterministic, generator)
    else:
        # external image embeddings: pixel_mask is already the per-token mask
        img = image_embeds
        if pixel_mask is None:
            img_mask = torch.ones(img.shape[:2], dtype=torch.int32,
                                  device=img.device)
        else:
            img_mask = pixel_mask.reshape(b, -1)

    text = text + params["modality_type"][0]
    img = img + params["modality_type"][image_token_type_idx]

    sizes = None
    if merge_patches_to is not None and img.shape[1] - 1 > merge_patches_to:
        # merge after every per-token add (position, modality), so the
        # size-weighted average composes the final embedded tokens; CLS
        # (image slot 0) is exempt: the pooler reads it
        from vault_tpu_torch.ops.token_merge import merge_tokens_to

        patches, p_sizes, p_mask = merge_tokens_to(img[:, 1:], img_mask[:, 1:],
                                                   merge_patches_to)
        img = torch.cat([img[:, :1], patches], dim=1)
        img_mask = torch.cat([img_mask[:, :1], p_mask.to(img_mask.dtype)], dim=1)
        sizes = torch.cat([torch.ones((b, l_text + 1), dtype=torch.float32,
                                      device=img.device), p_sizes], dim=1)

    tokens = torch.cat([text, img], dim=1)
    mask = torch.cat([attention_mask.to(img_mask.dtype), img_mask], dim=1)
    return tokens, mask, sizes


# ---------------------------------------------------------------------------
# Encoder
# ---------------------------------------------------------------------------

def _encoder_layer_tp(lp, cfg: ViltConfig, x, bias, deterministic,
                      generator, use_pallas, tp):
    """One pre-LN ViLT layer on this shard's heads and intermediate columns
    (parallel/tensor_parallel.py; see ``models/bert.py``
    ``_encoder_layer_tp``)."""
    fuse_qkv = parse_impl(use_pallas, x.device)[0]
    y = tp.enter(layer_norm(lp["ln_before"], x, cfg.layer_norm_eps))
    q, k, v = project_qkv(lp, y, local_heads(cfg.num_attention_heads, tp), fuse_qkv)
    ctx = merge_heads(attend(q, k, v, bias, generator,
                             cfg.attention_probs_dropout_prob, deterministic,
                             use_pallas=use_pallas))
    x = x + dropout(generator, row_linear(lp["attn_out"], ctx, tp),
                    cfg.hidden_dropout_prob, deterministic)
    y = tp.enter(layer_norm(lp["ln_after"], x, cfg.layer_norm_eps))
    mlp = act_fn(cfg.hidden_act)(linear(lp["mlp_in"], y))
    return x + dropout(generator, row_linear(lp["mlp_out"], mlp, tp),
                       cfg.hidden_dropout_prob, deterministic)


def _encoder_layer(lp, cfg: ViltConfig, x, bias, deterministic,
                   generator=None, use_pallas="auto"):
    """One pre-LN ViLT layer (modeling_vilt.py ViltLayer.forward), on the
    shards of the active tensor-parallel group when one is set."""
    tp = current_tp()
    if tp is not None:
        return _encoder_layer_tp(lp, cfg, x, bias, deterministic, generator,
                                 use_pallas, tp)
    fuse_qkv, fuse_lnqkv, fuse_mlp, _ = parse_impl(use_pallas, x.device)
    if fuse_lnqkv:
        from vault_tpu_torch.ops.cuda_ln_qkv import fused_ln_qkv

        qkv = fused_ln_qkv(lp["ln_before"], lp["q"], lp["k"], lp["v"], x,
                           cfg.layer_norm_eps)
        q, k, v = (split_heads(t, cfg.num_attention_heads)
                   for t in torch.chunk(qkv, 3, dim=-1))
    else:
        y = layer_norm(lp["ln_before"], x, cfg.layer_norm_eps)
        q, k, v = project_qkv(lp, y, cfg.num_attention_heads, fuse_qkv)
    ctx = merge_heads(attend(q, k, v, bias, generator,
                             cfg.attention_probs_dropout_prob, deterministic,
                             use_pallas=use_pallas))
    attn = linear(lp["attn_out"], ctx)
    attn = dropout(generator, attn, cfg.hidden_dropout_prob, deterministic)
    x = x + attn

    if fuse_mlp:
        from vault_tpu_torch.ops.cuda_mlp import fused_mlp_block
        from vault_tpu_torch.ops.nn import dropout_mask

        mask = None
        if not deterministic and cfg.hidden_dropout_prob > 0.0:
            mask = dropout_mask(generator, x.shape, cfg.hidden_dropout_prob,
                                x.dtype, x.device)
        return fused_mlp_block(lp["ln_after"], lp["mlp_in"], lp["mlp_out"],
                               x, cfg.layer_norm_eps, cfg.hidden_act,
                               drop_mask=mask)
    y = layer_norm(lp["ln_after"], x, cfg.layer_norm_eps)
    mlp = act_fn(cfg.hidden_act)(linear(lp["mlp_in"], y))
    mlp = linear(lp["mlp_out"], mlp)
    mlp = dropout(generator, mlp, cfg.hidden_dropout_prob, deterministic)
    return x + mlp


def vilt_encode(params, cfg: ViltConfig, x, attention_mask, deterministic=True,
                generator=None, use_pallas="auto", remat=False, key_sizes=None,
                merge_spec=None):
    """Encoder stack over the joint sequence, each layer under activation
    checkpointing when ``remat`` (ops/nn.py ``remat_apply``).  Returns
    (hidden states, attention mask).

    ``key_sizes`` (B, L): the multiplicities of embed-time merged tokens,
    added to the key bias as log(size).  ``merge_spec`` ``(layer,
    patch_start, target)``: after ``layer`` layers, ToMe-merge the tokens
    from ``patch_start`` on down to ``target``; the layers run in two
    segments around the merge, and the returned mask is the merged one."""
    def make_bias(mask, sizes):
        bias = extend_attention_mask(mask, torch.float32)
        if sizes is not None:
            # proportional attention: a key standing for s merged tokens
            # weighs s-fold in every softmax, through the (B, 1, 1, L) bias
            bias = bias + torch.log(torch.clamp(sizes, min=1.0))[:, None, None, :]
        return bias

    def run_layers(h, bias, lo, hi):
        for lp in params["layers"][lo:hi]:
            h = remat_apply(_encoder_layer, remat, generator, lp, cfg, h, bias,
                            deterministic, use_pallas=use_pallas)
        return h

    n_layers = cfg.num_hidden_layers
    if merge_spec is None:
        return (run_layers(x, make_bias(attention_mask, key_sizes), 0, n_layers),
                attention_mask)

    from vault_tpu_torch.ops.token_merge import merge_tokens_to

    # one merge per forward: embed-time sizes would be counted twice here
    if key_sizes is not None:
        raise ValueError("merge_spec excludes embed-time merging (key_sizes)")
    layer, patch_start, target = merge_spec
    layer = max(0, min(int(layer), n_layers))
    x = run_layers(x, make_bias(attention_mask, None), 0, layer)
    patches, p_sizes, p_mask = merge_tokens_to(
        x[:, patch_start:], attention_mask[:, patch_start:], target)
    x = torch.cat([x[:, :patch_start], patches], dim=1)
    mask = torch.cat([attention_mask[:, :patch_start],
                      p_mask.to(attention_mask.dtype)], dim=1)
    sizes = torch.cat([torch.ones((x.shape[0], patch_start), dtype=torch.float32,
                                  device=x.device), p_sizes], dim=1)
    return run_layers(x, make_bias(mask, sizes), layer, n_layers), mask


def pooler(params, x):
    """Tanh pooler on token 0 (modeling_vilt.py ViltPooler)."""
    return torch.tanh(linear(params["pooler"], x[:, 0]))


def vilt_apply(params, cfg: ViltConfig, input_ids=None, attention_mask=None,
               token_type_ids=None, pixel_values=None, pixel_mask=None,
               inputs_embeds=None, image_embeds=None, image_token_type_idx=1,
               deterministic=True, generator=None, use_pallas="auto",
               remat=False, merge_patches_to=None,
               merge_at_layer=0) -> ViltOutput:
    """Full ViltModel.forward equivalent (modeling_vilt.py:599-717).

    ``merge_patches_to``: ToMe-merge the patch tokens down to this count
    (ops/token_merge.py); 87 makes the joint sequence 40 + 1 + 87 = 128.
    ``merge_at_layer`` picks where: 0 merges the embeddings before the
    encoder, k > 0 merges after k encoder layers, on contextualized tokens
    (less divergence for (layers - k) / layers of the savings)."""
    embed_merge = merge_patches_to if merge_at_layer == 0 else None
    tokens, mask, sizes = joint_embed(params, cfg, input_ids, attention_mask,
                                      token_type_ids, pixel_values, pixel_mask,
                                      inputs_embeds, image_embeds,
                                      image_token_type_idx, deterministic,
                                      generator, embed_merge)
    merge_spec = None
    if merge_patches_to is not None and merge_at_layer > 0:
        if input_ids is not None:
            l_text = input_ids.shape[1]
        elif inputs_embeds is not None:
            l_text = inputs_embeds.shape[1]
        else:
            raise ValueError("merge_at_layer > 0 needs a text span")
        merge_spec = (merge_at_layer, l_text + 1, merge_patches_to)
    x, mask = vilt_encode(params, cfg, tokens, mask, deterministic, generator,
                          use_pallas, remat, key_sizes=sizes,
                          merge_spec=merge_spec)
    x = layer_norm(params["final_ln"], x, cfg.layer_norm_eps)
    pooled = pooler(params, x) if "pooler" in params else None
    return ViltOutput(last_hidden_state=x, pooler_output=pooled,
                      attention_mask=mask)
