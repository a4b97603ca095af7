"""VAuLT: language tower -> ViLT co-encoder composition and the classifier
head (port of ``vault_tpu/models/vault.py``, backbone and TMSC head).

Reference mechanism (vault/models/vault/model.py:151-218): ``lm_preprocess``
runs BERT over ``input_ids``, nulls them, and passes ``last_hidden_state`` to
ViLT as ``inputs_embeds``.  Here that is explicit function composition, as
in the JAX package, plus :class:`VaultForClassification`, the module a user
builds and calls.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from vault_tpu_torch.config import VaultConfig, ViltConfig
from vault_tpu_torch.models import bert as bert_mod
from vault_tpu_torch.models import llama as llama_mod
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
              generator=None, use_pallas="auto", remat=False):
    """The reference's ``lm_preprocess`` (vault/models/vault/model.py:151-202):
    run the LM tower; token-type guard for towers with <2 segment types
    (RoBERTa/BERTweet, :174-180); a frozen LM is detached (:189-190)."""
    tower = cfg.text_tower
    if tower.type_vocab_size < 2 and token_type_ids is not None:
        token_type_ids = torch.zeros_like(token_type_ids)
    hidden = bert_mod.bert_apply(
        params["bert"], tower, input_ids, attention_mask, token_type_ids,
        inputs_embeds=inputs_embeds, deterministic=deterministic,
        generator=generator, use_pallas=use_pallas, remat=remat)
    if cfg.freeze_lm:
        hidden = hidden.detach()
    return hidden


def vault_apply(params, cfg: VaultConfig, input_ids=None, attention_mask=None,
                token_type_ids=None, pixel_values=None, pixel_mask=None,
                inputs_embeds=None, image_embeds=None, image_token_type_idx=1,
                deterministic=True, generator=None, use_pallas="auto",
                remat=False, merge_patches_to=None,
                merge_at_layer=0) -> ViltOutput:
    """VaultModel.forward equivalent (vault/models/vault/model.py:207-218,
    369-372): optional LM pass, then ViLT with inputs_embeds.
    ``merge_patches_to`` / ``merge_at_layer``: ToMe patch-token merging
    (``vilt_apply``, ops/token_merge.py)."""
    vilt_cfg = cfg.resolved_vilt()
    vilt_token_types = token_type_ids
    if cfg.text_tower is not None:
        inputs_embeds = lm_encode(params, cfg, input_ids, attention_mask,
                                  token_type_ids, inputs_embeds, deterministic,
                                  generator, use_pallas, remat)
        input_ids = None
        # ViLT's own text token-type add still runs on the provided ids
    return vilt_mod.vilt_apply(
        params["vilt"], vilt_cfg, input_ids, attention_mask, vilt_token_types,
        pixel_values, pixel_mask, inputs_embeds, image_embeds,
        image_token_type_idx, deterministic, generator, use_pallas, remat,
        merge_patches_to, merge_at_layer)


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


def vault_with_llama_tower(params, vilt_cfg: ViltConfig, llama_cfg,
                           input_ids, attention_mask=None, token_type_ids=None,
                           pixel_values=None, pixel_mask=None,
                           image_embeds=None, deterministic=True, generator=None,
                           use_pallas="auto") -> ViltOutput:
    """A Llama tower's hidden states, width-projected to ViLT's hidden size,
    in place of the BERT contextual embeddings that feed the co-encoder
    (the JAX package's function of the same name).  ViLT's own text position
    embeddings are switched off; ``token_type_ids`` pass through.
    ``use_pallas`` selects the ViLT half's kernels, ``llama_cfg.attn_impl``
    and ``mlp_impl`` the tower's."""
    hidden = llama_mod.llama_apply(params["llama"], llama_cfg, input_ids,
                                   attention_mask)
    if "lm_proj" in params:
        hidden = linear(params["lm_proj"], hidden)
    vcfg = dataclasses.replace(vilt_cfg, add_text_position_embeddings=False)
    return vilt_mod.vilt_apply(
        params["vilt"], vcfg, attention_mask=attention_mask,
        token_type_ids=token_type_ids, pixel_values=pixel_values,
        pixel_mask=pixel_mask, inputs_embeds=hidden, image_embeds=image_embeds,
        deterministic=deterministic, generator=generator, use_pallas=use_pallas)


def vault_for_classification(params, cfg: VaultConfig, batch: Dict[str, Any],
                             head_dropout: float = 0.1, deterministic=True,
                             generator=None, use_pallas="auto", remat=False,
                             merge_patches_to=None, merge_at_layer=0):
    """VaultForTMSC.forward (vault/models/vault/model.py:547-570): backbone
    pooler -> dropout -> linear logits."""
    out = vault_apply(params, cfg, deterministic=deterministic,
                      generator=generator, use_pallas=use_pallas,
                      remat=remat, merge_patches_to=merge_patches_to,
                      merge_at_layer=merge_at_layer, **batch)
    return classifier_head_apply(params["head"], out.pooler_output,
                                 head_dropout, deterministic, generator)


def unreached_leaf(cfg: VaultConfig) -> Callable[[str], bool]:
    """Predicate on state-dict keys: the leaves the classifier's loss never
    reaches, which autograd leaves without a gradient where ``jax.grad``
    gives zeros.  With a text tower ViLT takes embeddings, not ids, so its
    text word table is unread, and so is its text position table when
    :meth:`VaultConfig.resolved_vilt` switches it off; a frozen text tower
    is cut from the graph."""
    if cfg.text_tower is None:
        return lambda key: False
    unread = {"vilt.text_embeddings.word"}
    if not cfg.resolved_vilt().add_text_position_embeddings:
        unread.add("vilt.text_embeddings.position")
    frozen = cfg.freeze_lm
    return lambda key: key in unread or (frozen and key.startswith("bert."))


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


class _ServedModel(ParamDict):
    """What the model modules share: the device they run on and, once
    :attr:`quant_mode` is set, the refusal of a cast (``.to(dtype)``,
    ``.bfloat16()``), which would turn the fp32 scales of the quantized
    linears into the new type."""

    quant_mode: Optional[str] = None

    def _apply(self, fn, recurse=True):
        if self.quant_mode is None:
            return super()._apply(fn, recurse)

        def same_dtype(t):
            out = fn(t)
            if out.dtype != t.dtype:
                raise RuntimeError(
                    f"a {self.quant_mode}-quantized model keeps its dtypes (the "
                    "scales stay fp32): cast before quantize(), not after")
            return out

        return super()._apply(same_dtype, recurse)

    @property
    def device(self) -> torch.device:
        return next(self.parameters()).device


class VaultForClassification(_ServedModel):
    """The VAuLT classifier as a module: ``bert`` and ``vilt`` towers and a
    ``head``, parameters named after the JAX package's pytree keys (so
    ``load_state_dict(params_from_jax(...))`` loads that package's weights).

    Runs on the card unless ``device`` names another; with no card and no
    device it raises.  Weights are seeded random (``seed``) until loaded.
    ``forward(batch)`` returns the logits of a deterministic pass.
    :meth:`quantize` turns it into its int8 serving form in place.
    ``merge_to`` / ``merge_at_layer``: serve with ToMe patch-token merging
    (``vilt_apply``), threaded into every forward as ``use_pallas`` is.
    """

    def __init__(self, cfg: VaultConfig, n_classes: int = 3, device=None,
                 dtype: torch.dtype = torch.float32, seed: int = 0,
                 use_pallas="auto", head_dropout: float = 0.1,
                 merge_to: Optional[int] = None, merge_at_layer: int = 0):
        super().__init__()
        device = resolve_device(device)
        gen = torch.Generator().manual_seed(seed)
        backbone = init_vault(gen, cfg)
        for name, mod in backbone.named_children():
            setattr(self, name, mod)
        self.head = init_classifier_head(gen, cfg.vilt.hidden_size, n_classes)
        self.cfg = cfg
        self.n_classes = n_classes
        self.use_pallas = use_pallas
        self.head_dropout = head_dropout
        self.merge_to, self.merge_at_layer = merge_to, merge_at_layer
        self.to(device=device, dtype=dtype)

    def quantize(self, mode: str = "w8a8", force: bool = False
                 ) -> "VaultForClassification":
        """Quantize every encoder linear in place (ops/quantize.py
        ``quantize_model_params``: int8 codes and fp32 per-out-channel
        scales), for serving, as the JAX package's ``scripts/serve.py``
        does after its cast to bf16: cast first, then quantize.  A selector
        left at "auto" becomes :func:`~vault_tpu_torch.serving.serving_impl`
        (w8a8: the fused LN->QKV and MLP kernels).  Afterwards the model's
        dtypes are fixed: a cast (``.to(dtype)``, ``.bfloat16()``) would
        turn the fp32 scales into the new type, so it raises.  The
        composition with the model's head width and merging is checked
        first (``serving.check_serving_composition``, as the JAX package's
        ``scripts/serve.py`` does): a measured-bad one raises unless
        ``force``; warnings go through ``warnings.warn``."""
        from vault_tpu_torch.ops.quantize import quantize_model_params
        from vault_tpu_torch.serving import check_composition, serving_impl

        if self.quant_mode is not None:
            raise RuntimeError(f"the model is already quantized ({self.quant_mode})")
        check_composition(self.n_classes, mode, self.merge_to, self.merge_at_layer,
                          force)
        quantize_model_params(self, mode=mode)
        self.quant_mode = mode
        if self.use_pallas == "auto":
            self.use_pallas = serving_impl(mode, self.device)
        return self

    def forward(self, batch: Dict[str, Any], use_pallas=None) -> torch.Tensor:
        batch = batch_to_device(batch, self.device)
        return vault_for_classification(
            self, self.cfg, batch, head_dropout=self.head_dropout,
            deterministic=True,
            use_pallas=self.use_pallas if use_pallas is None else use_pallas,
            merge_patches_to=self.merge_to, merge_at_layer=self.merge_at_layer)


class VaultWithLlamaTower(_ServedModel):
    """A Llama tower feeding ViLT through a width projection, as a module:
    ``llama``, ``lm_proj`` and ``vilt``, parameters named after the JAX
    package's pytree keys (:func:`vault_with_llama_tower` reads them).

    Runs on the card unless ``device`` names another; with no card and no
    device it raises.  Weights are seeded random (``seed``), drawn on the
    device.  The tower's embedding table and projections, ``lm_proj`` and
    ViLT are in ``dtype``; the tower's norm weights stay fp32.
    ``quantize`` ("w8" or "w8a8") builds the tower's projections already
    quantized, layer by layer, so the fp weights of a large tower never
    exist at once; :meth:`quantize` does the same to a built model.  Either
    way only the tower is quantized; ViLT and ``lm_proj`` stay in ``dtype``.
    ``forward(batch)`` returns the :class:`ViltOutput` of a deterministic
    pass.
    """

    def __init__(self, vilt_cfg: ViltConfig, llama_cfg: "llama_mod.LlamaConfig",
                 device=None, dtype: torch.dtype = torch.float32, seed: int = 0,
                 use_pallas="auto", quantize: Optional[str] = None):
        super().__init__()
        device = resolve_device(device)
        gen = torch.Generator(device=device).manual_seed(seed)
        self.llama = llama_mod.init_llama(gen, llama_cfg, dtype, quantize)
        host_gen = torch.Generator().manual_seed(seed)
        self.lm_proj = llama_mod.init_lm_projection(
            host_gen, llama_cfg.hidden_size, vilt_cfg.hidden_size).to(device, dtype)
        self.vilt = vilt_mod.init_vilt(host_gen, vilt_cfg).to(device, dtype)
        self.vilt_cfg, self.llama_cfg = vilt_cfg, llama_cfg
        self.use_pallas = use_pallas
        self.quant_mode = quantize

    def quantize(self, mode: str = "w8a8") -> "VaultWithLlamaTower":
        """Quantize the tower's projections in place (ops/quantize.py
        ``quantize_model_params``); afterwards a cast raises."""
        from vault_tpu_torch.ops.quantize import quantize_model_params

        if self.quant_mode is not None:
            raise RuntimeError(f"the model is already quantized ({self.quant_mode})")
        quantize_model_params(self.llama, mode=mode)
        self.quant_mode = mode
        return self

    def forward(self, batch: Dict[str, Any], use_pallas=None) -> ViltOutput:
        batch = batch_to_device(batch, self.device)
        return vault_with_llama_tower(
            self, self.vilt_cfg, self.llama_cfg, deterministic=True,
            use_pallas=self.use_pallas if use_pallas is None else use_pallas, **batch)
