"""TomViLT ("TomVAuLT"): TomBERT's target-attention front end feeding VAuLT
as the multimodal encoder (port of ``vault_tpu/models/tomvilt.py``).

Reference: vault/models/tomvilt/model.py:14-405.  A target BERT encodes the
target; the ResNet regions are mapped to the text width and cross-attended
by the target representation; the attended sequence (the target's length)
enters VAuLT through ViLT's external ``image_embeds`` input with
``pixel_mask = target_attention_mask``.  ``use_tweet_bert`` (a text tower
in the VaultConfig) switches VAuLT's LM tower on; without it ViLT reads the
token ids itself.
"""

from __future__ import annotations

from typing import Optional

import torch

from vault_tpu_torch.config import TextTowerConfig, VaultConfig
from vault_tpu_torch.models import bert as bert_mod
from vault_tpu_torch.models import vault as vault_mod
from vault_tpu_torch.models.modules import cross_encoder_apply, init_cross_encoder
from vault_tpu_torch.models.resnet import init_resnet, resnet_embed
from vault_tpu_torch.ops.masks import extend_attention_mask
from vault_tpu_torch.ops.nn import ParamDict, init_linear, linear

# ViLT's image path, which the attended sequence bypasses: these leaves are
# never read.
VILT_IMAGE_PATH = ("vault.vilt.cls_token", "vault.vilt.patch_proj.",
                   "vault.vilt.pos_embeddings")


def init_tomvilt(gen: torch.Generator, vault_cfg: VaultConfig,
                 target_cfg: TextTowerConfig, n_classes: int = 3,
                 vis_emb_dim: int = 2048,
                 num_hidden_cross_layers: Optional[int] = None,
                 resnet_depth: Optional[int] = None) -> ParamDict:
    """Seeded random TomViLT parameters on the host, fp32."""
    p = dict(
        target_bert=bert_mod.init_bert(gen, target_cfg),
        vis_mapper=init_linear(gen, vis_emb_dim, target_cfg.hidden_size,
                               target_cfg.initializer_range),
        cross=init_cross_encoder(gen, target_cfg, num_hidden_cross_layers),
        vault=ParamDict(**dict(vault_mod.init_vault(gen, vault_cfg).named_children()),
                        head=vault_mod.init_classifier_head(
                            gen, vault_cfg.vilt.hidden_size, n_classes)),
    )
    if resnet_depth is not None:
        p["resnet"] = init_resnet(gen, resnet_depth)
    return ParamDict(**p)


def tomvilt_apply(params, vault_cfg: VaultConfig, target_cfg: TextTowerConfig,
                  input_ids, target_input_ids, visual_embeddings=None,
                  images=None, token_type_ids=None, target_type_ids=None,
                  attention_mask=None, target_attention_mask=None,
                  image_attention_mask=None, resnet_depth: int = 101,
                  train_image_encoder: bool = False, head_dropout: float = 0.1,
                  deterministic=True, generator=None, return_embeddings=False,
                  use_pallas="auto"):
    """TomViltForTMSC.forward with its ResNet wrapper
    (vault/models/tomvilt/model.py:187-289, 353-405).  ``use_pallas``
    selects the towers' kernels; the cross layer's attention always takes
    the plain composition (``models/modules.py``)."""
    if visual_embeddings is None:
        visual_embeddings = resnet_embed(params["resnet"], resnet_depth,
                                         images, train=train_image_encoder)

    target_out = bert_mod.bert_apply(
        params["target_bert"], target_cfg, target_input_ids,
        target_attention_mask, target_type_ids, deterministic=deterministic,
        generator=generator, use_pallas=use_pallas)

    image_bias = None
    if image_attention_mask is not None:
        image_bias = extend_attention_mask(image_attention_mask, torch.float32)

    vis = linear(params["vis_mapper"],
                 visual_embeddings.to(params["vis_mapper"]["w"].dtype))
    attended = cross_encoder_apply(params["cross"], target_cfg, target_out,
                                   vis, image_bias, deterministic, generator,
                                   use_pallas)

    logits = vault_mod.vault_for_classification(
        params["vault"], vault_cfg,
        dict(input_ids=input_ids, attention_mask=attention_mask,
             token_type_ids=token_type_ids, image_embeds=attended,
             pixel_mask=target_attention_mask),
        head_dropout=head_dropout, deterministic=deterministic,
        generator=generator, use_pallas=use_pallas)
    if return_embeddings:
        return logits, visual_embeddings
    return logits


def tomvilt_unreached_leaf(vault_cfg: VaultConfig,
                           train_image_encoder: bool = False):
    """Predicate on state-dict keys: the leaves a TomViLT loss never
    reaches (zeros under ``jax.grad``, no gradient under autograd): a
    frozen ResNet's, ViLT's image path (the attended sequence takes its
    place), and what VAuLT itself leaves unread
    (:func:`~vault_tpu_torch.models.vault.unreached_leaf`)."""
    vault_unread = vault_mod.unreached_leaf(vault_cfg)

    def unreached(key: str) -> bool:
        if key.startswith("resnet."):
            return not train_image_encoder
        if key.startswith(VILT_IMAGE_PATH):
            return True
        return key.startswith("vault.") and vault_unread(key[len("vault."):])

    return unreached
