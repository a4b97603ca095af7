"""TomBERT (the IJCAI'19 baseline as the reference re-implements it; port of
``vault_tpu/models/tombert.py``).

Reference: vault/models/tombert/model.py:14-447.  A tweet BERT over the
tweet(+target) text; a target BERT over the target alone; ResNet 7x7
regions mapped to the text width; a cross encoder where the target
representation queries the regions; tanh-pool of token 0; [pooled visual
token ; tweet sequence] through a BERT encoder stack; pooling ("first" =
the visual token 0, "cls" = token 1, "both" = [0, 1]); a classifier.

:func:`init_tombert_from_bert` is the reference's from_pretrained surgery
(model.py:131-183): one BERT checkpoint seeds the tweet tower, the target
tower, the multimodal encoder and the cross encoder.

Parameters are state-dict tensors named after the JAX package's pytree
keys (``tweet_bert.layers.<i>.q.w``, ``resnet.layer3.<b>.conv1``, ...).
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional

import torch
from torch import nn

from vault_tpu_torch.config import TextTowerConfig
from vault_tpu_torch.models import bert as bert_mod
from vault_tpu_torch.models.modules import (
    cross_encoder_apply,
    init_cross_encoder,
    init_pooler_dim,
    pooler_dim_apply,
)
from vault_tpu_torch.models.resnet import init_resnet, resnet_embed
from vault_tpu_torch.ops.masks import extend_attention_mask
from vault_tpu_torch.ops.nn import ParamDict, dropout, init_linear, linear

# The subtrees of a TomBERT tree, in the order init_tombert draws them.
TOMBERT_KEYS = ("tweet_bert", "target_bert", "vis_mapper", "cross",
                "cross_pooler", "mm_encoder", "out_pooler", "classifier",
                "resnet")


def init_tombert(gen: torch.Generator, cfg: TextTowerConfig,
                 n_classes: int = 3, pooling: str = "first",
                 vis_emb_dim: int = 2048,
                 num_hidden_cross_layers: Optional[int] = None,
                 resnet_depth: Optional[int] = None,
                 tie_target_bert: bool = False) -> ParamDict:
    """Seeded random TomBERT parameters on the host, fp32.
    ``tie_target_bert`` is the reference's ``tie_target_bert_weights``
    (tombert/model.py:164-165): the tree has no ``target_bert``, and the
    target stream runs the tweet tower, so both streams' gradients reach
    one set of weights."""
    p: Dict = {"tweet_bert": bert_mod.init_bert(gen, cfg)}
    if not tie_target_bert:
        p["target_bert"] = bert_mod.init_bert(gen, cfg)
    p.update(
        vis_mapper=init_linear(gen, vis_emb_dim, cfg.hidden_size,
                               cfg.initializer_range),
        cross=init_cross_encoder(gen, cfg, num_hidden_cross_layers),
        cross_pooler=init_pooler_dim(gen, cfg.hidden_size),
        # the multimodal encoder: a BERT encoder stack (layers only)
        mm_encoder=ParamDict(layers=nn.ModuleList(
            bert_mod._init_layer(gen, cfg) for _ in range(cfg.num_hidden_layers))),
        out_pooler=init_pooler_dim(gen, cfg.hidden_size),
        classifier=init_linear(
            gen, cfg.hidden_size * (2 if pooling == "both" else 1), n_classes,
            cfg.initializer_range))
    if resnet_depth is not None:
        p["resnet"] = init_resnet(gen, resnet_depth)
    return ParamDict(**p)


def _layer_count(sd: Mapping[str, torch.Tensor], prefix: str) -> int:
    idx = {int(k[len(prefix):].split(".")[0]) for k in sd if k.startswith(prefix)}
    return max(idx) + 1 if idx else 0


def init_tombert_from_bert(bert_params: Mapping[str, torch.Tensor],
                           gen: torch.Generator, cfg: TextTowerConfig,
                           n_classes: int = 3, pooling: str = "first",
                           vis_emb_dim: int = 2048,
                           num_hidden_cross_layers: Optional[int] = None,
                           resnet_params: Optional[Mapping] = None,
                           tweet_params: Optional[Mapping] = None,
                           tie_target_bert: bool = False
                           ) -> Dict[str, torch.Tensor]:
    """The reference's weight surgery (tombert/model.py:162-176), on state
    dicts: ``bert_params`` (one BERT tower, ``embeddings.*`` and
    ``layers.<i>.*``) seeds all four text stacks; with ``tweet_params``
    (``pretrained_tweet_model_name_or_path``, :154-160) the tweet and
    target towers take those instead.  A cross encoder deeper than the
    donor takes the donor's layers first and keeps its other layers random
    (torch's ``strict=False`` load, :173-176).  ``resnet_params``: the
    ResNet's state dict (``stem.*``, ``layer<s>.<b>.*``)."""
    init = init_tombert(gen, cfg, n_classes, pooling, vis_emb_dim,
                        num_hidden_cross_layers,
                        tie_target_bert=tie_target_bert).state_dict()
    towers = tweet_params if tweet_params is not None else bert_params
    n_bert = _layer_count(bert_params, "layers.")
    out: Dict[str, torch.Tensor] = {}
    for group in TOMBERT_KEYS:
        if group in ("tweet_bert", "target_bert"):
            if group == "tweet_bert" or not tie_target_bert:
                out.update({f"{group}.{k}": v.clone() for k, v in towers.items()})
            continue
        if group == "resnet":
            if resnet_params is not None:
                out.update({f"resnet.{k}": v for k, v in resnet_params.items()})
            continue
        for k, v in init.items():
            if not k.startswith(group + "."):
                continue
            rest = k[len(group) + 1:]
            if group == "mm_encoder":
                v = bert_params[rest].clone()
            elif group == "cross" and int(rest.split(".")[1]) < n_bert:
                v = bert_params[rest].clone()
            out[k] = v
    return out


def tombert_apply(params, cfg: TextTowerConfig, input_ids, target_input_ids,
                  visual_embeddings=None, images=None, token_type_ids=None,
                  target_type_ids=None, attention_mask=None,
                  target_attention_mask=None, pooling: str = "first",
                  resnet_depth: int = 101, train_image_encoder: bool = False,
                  tweet_cfg: Optional[TextTowerConfig] = None,
                  deterministic=True, generator=None, return_embeddings=False,
                  use_pallas="auto"):
    """TomBertForTMSC.forward with its ResNet wrapper
    (vault/models/tombert/model.py:199-332, 394-447).  ``tweet_cfg`` is
    the tweet checkpoint's config (``tweet_model_name_or_path``,
    model.py:154-160: the tweet and target towers both come from it); its
    hidden size must be ``cfg``'s, since the pooled visual token joins the
    tweet sequence.  ``use_pallas`` selects the towers' kernels; the cross
    layer's attention always takes the plain composition
    (``models/modules.py``)."""
    tweet_cfg = tweet_cfg or cfg
    if visual_embeddings is None:
        visual_embeddings = resnet_embed(params["resnet"], resnet_depth,
                                         images, train=train_image_encoder)

    tweet_out = bert_mod.bert_apply(
        params["tweet_bert"], tweet_cfg, input_ids, attention_mask,
        token_type_ids, deterministic=deterministic, generator=generator,
        use_pallas=use_pallas)
    # tied (no "target_bert"): the tweet tower serves both streams
    target_out = bert_mod.bert_apply(
        params.get("target_bert", params["tweet_bert"]), tweet_cfg,
        target_input_ids, target_attention_mask, target_type_ids,
        deterministic=deterministic, generator=generator,
        use_pallas=use_pallas)

    # the regions are all valid (a fixed 7x7 grid): no image-part bias
    vis = linear(params["vis_mapper"],
                 visual_embeddings.to(params["vis_mapper"]["w"].dtype))
    attended = cross_encoder_apply(params["cross"], cfg, target_out, vis, None,
                                   deterministic, generator, use_pallas)
    pooled_vis = pooler_dim_apply(params["cross_pooler"], attended, 0)  # (B, H)

    mm = torch.cat([pooled_vis[:, None, :], tweet_out], dim=1)
    mm_bias = None
    if attention_mask is not None:
        mm_mask = torch.cat([torch.ones((mm.shape[0], 1),
                                        dtype=attention_mask.dtype,
                                        device=attention_mask.device),
                             attention_mask], dim=1)
        mm_bias = extend_attention_mask(mm_mask, torch.float32)
    x = bert_mod.bert_encode(params["mm_encoder"], cfg, mm, None, deterministic,
                             generator, use_pallas, bias=mm_bias)

    if pooling == "both":
        pooled = pooler_dim_apply(params["out_pooler"], x, [0, 1])
        pooled = pooled.reshape(pooled.shape[0], -1)
    elif pooling == "cls":
        pooled = pooler_dim_apply(params["out_pooler"], x, 1)
    else:  # "first"
        pooled = pooler_dim_apply(params["out_pooler"], x, 0)

    pooled = dropout(generator, pooled, cfg.hidden_dropout_prob, deterministic)
    logits = linear(params["classifier"], pooled)
    if return_embeddings:
        return logits, visual_embeddings
    return logits


def tombert_unreached_leaf(train_image_encoder: bool = False):
    """Predicate on state-dict keys: the leaves a TomBERT loss never
    reaches, where ``jax.grad`` gives zeros and autograd no gradient: a
    frozen ResNet's (its features are cut from the graph, or cached)."""
    return lambda key: not train_image_encoder and key.startswith("resnet.")
