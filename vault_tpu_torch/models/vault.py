"""VAuLT: language tower -> ViLT co-encoder composition and the classifier
head (port of ``vault_tpu/models/vault.py``, backbone and TMSC head).

Reference mechanism (vault/models/vault/model.py:151-218): ``lm_preprocess``
runs BERT over ``input_ids``, nulls them, and passes ``last_hidden_state`` to
ViLT as ``inputs_embeds``.  Here that is explicit function composition, as
in the JAX package, plus :class:`VaultForClassification`, the module a user
builds and calls.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from vault_tpu_torch.config import VaultConfig
from vault_tpu_torch.models import bert as bert_mod
from vault_tpu_torch.models import vilt as vilt_mod
from vault_tpu_torch.models.vilt import ViltOutput
from vault_tpu_torch.ops.nn import ParamDict, dropout, init_linear, linear


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: the one named, else the card.
    Without a card and without a named device this raises; nothing drops
    to the CPU on its own."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the "
            "CPU explicitly")
    return torch.device("cuda")


# ---------------------------------------------------------------------------
# Backbone
# ---------------------------------------------------------------------------

def init_vault(gen: torch.Generator, cfg: VaultConfig) -> ParamDict:
    """Seeded random backbone parameters on the host, fp32."""
    p = {"vilt": vilt_mod.init_vilt(gen, cfg.resolved_vilt())}
    if cfg.text_tower is not None:
        p["bert"] = bert_mod.init_bert(gen, cfg.text_tower)
    return ParamDict(**p)


def lm_encode(params, cfg: VaultConfig, input_ids, attention_mask,
              token_type_ids=None, inputs_embeds=None, deterministic=True,
              generator=None, use_pallas="auto"):
    """The reference's ``lm_preprocess`` (vault/models/vault/model.py:151-202):
    run the LM tower; token-type guard for towers with <2 segment types
    (RoBERTa/BERTweet, :174-180); a frozen LM is detached (:189-190)."""
    tower = cfg.text_tower
    if tower.type_vocab_size < 2 and token_type_ids is not None:
        token_type_ids = torch.zeros_like(token_type_ids)
    hidden = bert_mod.bert_apply(
        params["bert"], tower, input_ids, attention_mask, token_type_ids,
        inputs_embeds=inputs_embeds, deterministic=deterministic,
        generator=generator, use_pallas=use_pallas)
    if cfg.freeze_lm:
        hidden = hidden.detach()
    return hidden


def vault_apply(params, cfg: VaultConfig, input_ids=None, attention_mask=None,
                token_type_ids=None, pixel_values=None, pixel_mask=None,
                inputs_embeds=None, image_embeds=None, image_token_type_idx=1,
                deterministic=True, generator=None, use_pallas="auto",
                merge_patches_to=None) -> ViltOutput:
    """VaultModel.forward equivalent (vault/models/vault/model.py:207-218,
    369-372): optional LM pass, then ViLT with inputs_embeds."""
    vilt_cfg = cfg.resolved_vilt()
    vilt_token_types = token_type_ids
    if cfg.text_tower is not None:
        inputs_embeds = lm_encode(params, cfg, input_ids, attention_mask,
                                  token_type_ids, inputs_embeds, deterministic,
                                  generator, use_pallas)
        input_ids = None
        # ViLT's own text token-type add still runs on the provided ids
    return vilt_mod.vilt_apply(
        params["vilt"], vilt_cfg, input_ids, attention_mask, vilt_token_types,
        pixel_values, pixel_mask, inputs_embeds, image_embeds,
        image_token_type_idx, deterministic, generator, use_pallas,
        merge_patches_to)


# ---------------------------------------------------------------------------
# Classifier head
# ---------------------------------------------------------------------------

def init_classifier_head(gen: torch.Generator, hidden_size: int,
                         n_classes: int, stddev: float = 0.02) -> ParamDict:
    """VaultForTMSC head: Dropout + Linear (vault/models/vault/model.py:540-545)."""
    return ParamDict(out=init_linear(gen, hidden_size, n_classes, stddev))


def classifier_head_apply(head, pooled, dropout_prob=0.1, deterministic=True,
                          generator=None):
    x = dropout(generator, pooled, dropout_prob, deterministic)
    return linear(head["out"], x)


def vault_for_classification(params, cfg: VaultConfig, batch: Dict[str, Any],
                             head_dropout: float = 0.1, deterministic=True,
                             generator=None, use_pallas="auto",
                             merge_patches_to=None):
    """VaultForTMSC.forward (vault/models/vault/model.py:547-570): backbone
    pooler -> dropout -> linear logits."""
    out = vault_apply(params, cfg, deterministic=deterministic,
                      generator=generator, use_pallas=use_pallas,
                      merge_patches_to=merge_patches_to, **batch)
    return classifier_head_apply(params["head"], out.pooler_output,
                                 head_dropout, deterministic, generator)


def batch_to_device(batch: Dict[str, Any], device) -> Dict[str, torch.Tensor]:
    """Processor output (numpy or tensors) -> tensors on ``device``; integer
    fields become int64 (index dtype)."""
    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(np.ascontiguousarray(v)) if isinstance(
            v, np.ndarray) else torch.as_tensor(v)
        if not t.is_floating_point():
            t = t.to(torch.int64)
        out[k] = t.to(device, non_blocking=True)
    return out


class VaultForClassification(ParamDict):
    """The VAuLT classifier as a module: ``bert`` and ``vilt`` towers and a
    ``head``, parameters named after the JAX package's pytree keys (so
    ``load_state_dict(params_from_jax(...))`` loads that package's weights).

    Runs on the card unless ``device`` names another; with no card and no
    device it raises.  Weights are seeded random (``seed``) until loaded.
    ``forward(batch)`` returns the logits of a deterministic pass.
    """

    def __init__(self, cfg: VaultConfig, n_classes: int = 3, device=None,
                 dtype: torch.dtype = torch.float32, seed: int = 0,
                 use_pallas="auto", head_dropout: float = 0.1):
        super().__init__()
        device = resolve_device(device)
        gen = torch.Generator().manual_seed(seed)
        backbone = init_vault(gen, cfg)
        for name, mod in backbone.named_children():
            setattr(self, name, mod)
        self.head = init_classifier_head(gen, cfg.vilt.hidden_size, n_classes)
        self.cfg = cfg
        self.use_pallas = use_pallas
        self.head_dropout = head_dropout
        self.to(device=device, dtype=dtype)

    @property
    def device(self) -> torch.device:
        return self.head.out.w.device

    def forward(self, batch: Dict[str, Any], use_pallas=None) -> torch.Tensor:
        batch = batch_to_device(batch, self.device)
        return vault_for_classification(
            self, self.cfg, batch, head_dropout=self.head_dropout,
            deterministic=True,
            use_pallas=self.use_pallas if use_pallas is None else use_pallas)
