"""VAuLT: language tower -> ViLT co-encoder composition and the task heads
(port of ``vault_tpu/models/vault.py``).

Reference mechanism (vault/models/vault/model.py:151-218): ``lm_preprocess``
runs BERT over ``input_ids``, nulls them, and passes ``last_hidden_state`` to
ViLT as ``inputs_embeds``.  Here that is explicit function composition, as
in the JAX package, plus :class:`VaultForClassification`, the module a user
builds and calls.

Heads (reference locations):
  * TMSC / MVSA / Bloomberg classifier: Dropout + Linear on pooler_output
    (vault/models/vault/model.py:512-570)
  * MLM: HF ViltMLMHead — dense+act+LN transform, decoder tied to ViLT word
    embeddings + free bias (vault/models/vault/model.py:467-468)
  * VQA: Linear(h,2h)+LN+GELU+Linear (vault/models/vault/model.py:472-509)
  * Retrieval: rank_output Linear(h,1) (vault/models/vault/model.py:375-405)
  * Images+Text (NLVR2): per-image backbone passes with
    image_token_type_idx=i+1, concatenated poolers, 2-layer classifier
    (vault/models/vault/model.py:408-464)

Heads are drawn on the host from a ``torch.Generator`` (the JAX package's
rules, not its streams).  The resizing helpers take and return dicts: a
state dict (or the nested form :func:`~vault_tpu_torch.convert.param_tree`
gives).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from vault_tpu_torch.config import VaultConfig, ViltConfig
from vault_tpu_torch.models import bert as bert_mod
from vault_tpu_torch.models import deepseek as deepseek_mod
from vault_tpu_torch.models import llama as llama_mod
from vault_tpu_torch.models import vilt as vilt_mod
from vault_tpu_torch.models.vilt import ViltOutput
from vault_tpu_torch.ops.nn import (
    ParamDict,
    act_fn,
    dropout,
    init_layer_norm,
    init_linear,
    layer_norm,
    linear,
    matmul_fp32,
)
from vault_tpu_torch.utils.profiling import nan_checked, span


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: the one named, else the card.
    Without a card, None or a CUDA device raises; nothing drops to the CPU
    on its own."""
    if device is not None and torch.device(device).type != "cuda":
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the "
            "CPU explicitly")
    return torch.device("cuda" if device is None else device)


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
    (RoBERTa/BERTweet, :174-180); a frozen LM is detached (:189-190).
    The whole runs in a ``vault.text_tower`` span (utils/profiling.py
    ``span``)."""
    with span("vault.text_tower"):
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


def init_mlm_head(gen: torch.Generator, cfg: ViltConfig) -> ParamDict:
    return ParamDict(
        transform=init_linear(gen, cfg.hidden_size, cfg.hidden_size,
                              cfg.initializer_range),
        transform_ln=init_layer_norm(cfg.hidden_size),
        bias=torch.zeros(cfg.vocab_size))


def mlm_head_apply(head, vilt_params, cfg: ViltConfig, hidden):
    """ViltMLMHead with the decoder tied to ViLT's word embeddings
    (modeling_vilt.py:889-908).  The decoder product returns fp32 from
    operands of the compute type (bf16 on the card's tensor cores, exact
    products), as the JAX package's ``preferred_element_type=f32`` does; it
    is not a kernel of the JAX package."""
    x = linear(head["transform"], hidden)
    x = act_fn(cfg.hidden_act)(x)
    x = layer_norm(head["transform_ln"], x, cfg.layer_norm_eps)
    logits = matmul_fp32(x, vilt_params["text_embeddings"]["word"].t())
    return logits + head["bias"]


def init_vqa_head(gen: torch.Generator, cfg: ViltConfig, n_classes: int) -> ParamDict:
    h = cfg.hidden_size
    return ParamDict(**{
        "in": init_linear(gen, h, h * 2, cfg.initializer_range),
        "ln": init_layer_norm(h * 2),
        "out": init_linear(gen, h * 2, n_classes, cfg.initializer_range)})


def vqa_head_apply(head, cfg: ViltConfig, pooled):
    x = linear(head["in"], pooled)
    # HF builds this head with a bare nn.LayerNorm: torch's default eps
    # 1e-5, not config.layer_norm_eps (modeling_vilt.py:925-929)
    x = layer_norm(head["ln"], x, 1e-5)
    x = act_fn("gelu")(x)
    return linear(head["out"], x)


def renew_vqa_classifier(gen: torch.Generator, head, n_classes: int,
                         stddev: float = 0.02):
    """VaultForQuestionAnswering's n_classes override: the final linear
    drawn anew, normal(0, 0.02) weights and zero bias
    (vault/models/vault/model.py:472-509), on the head's device and type.
    Returns a head of ``head``'s kind (a ParamDict or a dict)."""
    w = head["in"]["w"]
    out = init_linear(gen, w.shape[1], n_classes, stddev).to(w.device, w.dtype)
    if isinstance(head, ParamDict):
        return ParamDict(**{"in": head["in"], "ln": head["ln"], "out": out})
    return {**head, "out": out}


def init_rank_head(gen: torch.Generator, cfg: ViltConfig) -> ParamDict:
    return ParamDict(out=init_linear(gen, cfg.hidden_size, 1, cfg.initializer_range))


def rank_head_apply(head, pooled):
    return linear(head["out"], pooled)


def rank_head_from_itm(itm_head) -> ParamDict:
    """Reference checkpoint surgery (vault/models/vault/model.py:375-405): an
    ``itm`` checkpoint carries a 2-way itm_score head; the retrieval rank
    head is its row 1 (the "match" logit)."""
    return ParamDict(out=ParamDict(w=itm_head["w"][:, 1:2].detach().clone(),
                                   b=itm_head["b"][1:2].detach().clone()))


def init_pair_head(gen: torch.Generator, cfg: ViltConfig, n_classes: int = 2,
                   num_images: int = 2) -> ParamDict:
    h = cfg.hidden_size * num_images
    return ParamDict(**{
        "in": init_linear(gen, h, h, cfg.initializer_range),
        "ln": init_layer_norm(h),
        "out": init_linear(gen, h, n_classes, cfg.initializer_range)})


def pair_head_apply(head, cfg: ViltConfig, pooled_concat):
    x = linear(head["in"], pooled_concat)
    # bare nn.LayerNorm in HF: torch's default eps 1e-5 (modeling_vilt.py:1136-1141)
    x = layer_norm(head["ln"], x, 1e-5)
    x = act_fn("gelu")(x)
    return linear(head["out"], x)


def resize_token_embeddings(params, cfg: VaultConfig, new_size: int,
                            generator: Optional[torch.Generator] = None,
                            stddev: float = 0.02):
    """Grow the word-embedding table to ``new_size`` rows (new rows
    normal(0, 0.02) from ``generator``).  Like the reference's
    resize_token_embeddings (vault/models/vault/model.py:130-135), the LM
    tower's table is resized when there is one, otherwise ViLT's.
    ``params`` is the model's state dict; returns (state dict, config)."""
    key = ("bert.embeddings.word" if cfg.text_tower is not None
           else "vilt.text_embeddings.word")
    if new_size <= params[key].shape[0]:
        return params, cfg
    params = {**params, key: bert_mod.grow_rows(params[key], new_size,
                                                generator, stddev)}
    if cfg.text_tower is not None:
        cfg = dataclasses.replace(
            cfg, text_tower=dataclasses.replace(cfg.text_tower, vocab_size=new_size))
    else:
        cfg = dataclasses.replace(cfg, vilt=dataclasses.replace(cfg.vilt,
                                                                vocab_size=new_size))
    return params, cfg


def resize_modality_type_embeddings(vilt_params, num_images: int):
    """Grow ViLT's modality-type table from 2 to num_images+1 rows, copying
    the single pretrained image row into every image slot: the reference's
    resize_token_type_embeddings (vault/models/vault/model.py:437-456).
    ``vilt_params``: ViLT's state dict (or its nested form); a new dict is
    returned."""
    table = vilt_params["modality_type"]
    if table.shape[0] >= num_images + 1:
        return vilt_params
    new = torch.cat([table[0:1]] + [table[1:2]] * num_images)
    return {**vilt_params, "modality_type": new}


def vault_with_tower(params, vilt_cfg: ViltConfig, tower: Callable, input_ids,
                     attention_mask=None, token_type_ids=None, pixel_values=None,
                     pixel_mask=None, image_embeds=None, deterministic=True,
                     generator=None, use_pallas="auto") -> ViltOutput:
    """A decoder tower's hidden states (``tower(input_ids, attention_mask)``,
    in a ``vault.text_tower`` span), width-projected by ``lm_proj`` to
    ViLT's hidden size, in place of the BERT contextual embeddings that
    feed the co-encoder.  ViLT's own text position embeddings are switched
    off; ``token_type_ids`` pass through.  ``use_pallas`` selects the ViLT
    half's kernels."""
    with span("vault.text_tower"):
        hidden = tower(input_ids, attention_mask)
    if "lm_proj" in params:
        hidden = linear(params["lm_proj"], hidden)
    vcfg = dataclasses.replace(vilt_cfg, add_text_position_embeddings=False)
    return vilt_mod.vilt_apply(
        params["vilt"], vcfg, attention_mask=attention_mask,
        token_type_ids=token_type_ids, pixel_values=pixel_values,
        pixel_mask=pixel_mask, inputs_embeds=hidden, image_embeds=image_embeds,
        deterministic=deterministic, generator=generator, use_pallas=use_pallas)


def vault_with_llama_tower(params, vilt_cfg: ViltConfig, llama_cfg, input_ids,
                           attention_mask=None, **kwargs) -> ViltOutput:
    """:func:`vault_with_tower` on a Llama tower (the JAX package's function
    of the same name); ``llama_cfg.attn_impl`` and ``mlp_impl`` select the
    tower's kernels."""
    return vault_with_tower(
        params, vilt_cfg,
        lambda ids, mask: llama_mod.llama_apply(params["llama"], llama_cfg, ids, mask),
        input_ids, attention_mask, **kwargs)


def vault_with_deepseek_tower(params, vilt_cfg: ViltConfig, deepseek_cfg, input_ids,
                              attention_mask=None, routes=None, **kwargs) -> ViltOutput:
    """:func:`vault_with_tower` on a DeepSeek-V3 tower (models/deepseek.py);
    ``routes``, a list, gets each MoE layer's chosen experts."""
    return vault_with_tower(
        params, vilt_cfg,
        lambda ids, mask: deepseek_mod.deepseek_apply(params["deepseek"], deepseek_cfg, ids,
                                                      mask, routes=routes),
        input_ids, attention_mask, **kwargs)


def vault_for_classification(params, cfg: VaultConfig, batch: Dict[str, Any],
                             head_dropout: float = 0.1, deterministic=True,
                             generator=None, use_pallas="auto", remat=False,
                             merge_patches_to=None, merge_at_layer=0):
    """VaultForTMSC.forward (vault/models/vault/model.py:547-570): backbone
    pooler -> dropout -> linear logits, the head in a ``vault.head`` span."""
    out = vault_apply(params, cfg, deterministic=deterministic,
                      generator=generator, use_pallas=use_pallas,
                      remat=remat, merge_patches_to=merge_patches_to,
                      merge_at_layer=merge_at_layer, **batch)
    with span("vault.head"):
        return classifier_head_apply(params["head"], out.pooler_output,
                                     head_dropout, deterministic, generator)


def vault_for_mlm(params, cfg: VaultConfig, batch, deterministic=True,
                  generator=None, use_pallas="auto", remat=False,
                  merge_patches_to=None):
    """VaultForMaskedLM (vault/models/vault/model.py:467-468): MLM logits
    (fp32) over the text span of the joint sequence (text tokens precede
    the patches, so patch merging leaves the text span's indices intact)."""
    out = vault_apply(params, cfg, deterministic=deterministic,
                      generator=generator, use_pallas=use_pallas, remat=remat,
                      merge_patches_to=merge_patches_to, **batch)
    text_hidden = out.last_hidden_state[:, :batch["input_ids"].shape[1]]
    return mlm_head_apply(params["mlm"], params["vilt"], cfg.resolved_vilt(),
                          text_hidden)


def vault_for_vqa(params, cfg: VaultConfig, batch, deterministic=True,
                  generator=None, use_pallas="auto", remat=False,
                  merge_patches_to=None):
    out = vault_apply(params, cfg, deterministic=deterministic,
                      generator=generator, use_pallas=use_pallas, remat=remat,
                      merge_patches_to=merge_patches_to, **batch)
    return vqa_head_apply(params["vqa"], cfg.resolved_vilt(), out.pooler_output)


def vault_for_retrieval(params, cfg: VaultConfig, batch, deterministic=True,
                        generator=None, use_pallas="auto", remat=False,
                        merge_patches_to=None):
    out = vault_apply(params, cfg, deterministic=deterministic,
                      generator=generator, use_pallas=use_pallas, remat=remat,
                      merge_patches_to=merge_patches_to, **batch)
    return rank_head_apply(params["rank"], out.pooler_output)


def vault_for_images_and_text(params, cfg: VaultConfig, batch,
                              deterministic=True, generator=None,
                              use_pallas="auto", remat=False,
                              merge_patches_to=None):
    """VaultForImagesAndTextClassification: pixel_values (B, num_images, C,
    H, W); one whole backbone pass (the text tower included) per image with
    its own modality slot i + 1, poolers concatenated.  The passes draw
    their dropout from ``generator`` one after the other."""
    pixel_values = batch["pixel_values"]
    pixel_mask = batch.get("pixel_mask")
    pooled = []
    for i in range(pixel_values.shape[1]):
        sub = dict(batch)
        sub["pixel_values"] = pixel_values[:, i]
        sub["pixel_mask"] = None if pixel_mask is None else pixel_mask[:, i]
        sub["image_token_type_idx"] = i + 1
        out = vault_apply(params, cfg, deterministic=deterministic,
                          generator=generator, use_pallas=use_pallas, remat=remat,
                          merge_patches_to=merge_patches_to, **sub)
        pooled.append(out.pooler_output)
    return pair_head_apply(params["pair"], cfg.resolved_vilt(), torch.cat(pooled, -1))


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


def mlm_unreached_leaf(cfg: VaultConfig) -> Callable[[str], bool]:
    """:func:`unreached_leaf` for the MLM head: its decoder is tied to
    ViLT's text word table (``mlm_head_apply``), so that table is read and
    gets its gradient; the logits come from the last hidden state, so
    ViLT's pooler is unread; the rest is as for the classifier."""
    base = unreached_leaf(cfg)
    pooler = {"vilt.pooler.w", "vilt.pooler.b"}
    return lambda key: key in pooler or (key != "vilt.text_embeddings.word"
                                         and base(key))


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
    ``forward(batch)`` returns the logits of a deterministic pass, under
    the NaN checks while ``utils.profiling.enable_nan_checks`` is on.
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

    @nan_checked
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
    pass, under the NaN checks while they are on.
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

    @nan_checked
    def forward(self, batch: Dict[str, Any], use_pallas=None) -> ViltOutput:
        batch = batch_to_device(batch, self.device)
        return vault_with_llama_tower(
            self, self.vilt_cfg, self.llama_cfg, deterministic=True,
            use_pallas=self.use_pallas if use_pallas is None else use_pallas, **batch)


class VaultWithDeepseekTower(_ServedModel):
    """A DeepSeek-V3 tower (models/deepseek.py; Moonlight-16B-A3B at its
    defaults) feeding ViLT through a width projection, with the classifier
    head, as a module: ``deepseek``, ``lm_proj``, ``vilt`` and ``head``.
    ``forward(batch)`` returns the logits of a deterministic pass
    (:func:`vault_with_deepseek_tower`, then the head in a ``vault.head``
    span), under the NaN checks while they are on.

    Runs on the card unless ``device`` names another; with no card and no
    device it raises.  Weights are seeded random (``seed``): the tower
    drawn on the device in ``dtype`` (its norm weights and router biases
    fp32), ``lm_proj``, ViLT and the head on the host, then moved.  On the
    meta device nothing is drawn: a model whose weights are loaded with
    ``load_state_dict(..., assign=True)``, as a 31 GB tower is best made.
    ``use_pallas`` selects ViLT's kernels; the routed experts take the
    operator ``vault_tpu_torch::moe_experts`` (the grouped kernel on the
    card).  ``forward(batch, routes=[])`` also puts each MoE layer's chosen
    experts (B L, k) in the list, as routed.
    """

    def __init__(self, vilt_cfg: ViltConfig, deepseek_cfg: "deepseek_mod.DeepseekConfig",
                 n_classes: int = 3, device=None, dtype: torch.dtype = torch.float32,
                 seed: int = 0, use_pallas="auto", head_dropout: float = 0.1):
        super().__init__()
        device = resolve_device(device)
        gen = (None if device.type == "meta"
               else torch.Generator(device=device).manual_seed(seed))
        self.deepseek = deepseek_mod.init_deepseek(gen, deepseek_cfg, dtype, device)
        host_gen = torch.Generator().manual_seed(seed)
        self.lm_proj = llama_mod.init_lm_projection(
            host_gen, deepseek_cfg.hidden_size, vilt_cfg.hidden_size).to(device, dtype)
        self.vilt = vilt_mod.init_vilt(host_gen, vilt_cfg).to(device, dtype)
        self.head = init_classifier_head(host_gen, vilt_cfg.hidden_size,
                                         n_classes).to(device, dtype)
        self.vilt_cfg, self.deepseek_cfg = vilt_cfg, deepseek_cfg
        self.use_pallas = use_pallas
        self.head_dropout = head_dropout

    @nan_checked
    def forward(self, batch: Dict[str, Any], use_pallas=None, routes=None) -> torch.Tensor:
        batch = batch_to_device(batch, self.device)
        out = vault_with_deepseek_tower(
            self, self.vilt_cfg, self.deepseek_cfg, routes=routes, deterministic=True,
            use_pallas=self.use_pallas if use_pallas is None else use_pallas, **batch)
        with span("vault.head"):
            return classifier_head_apply(self.head, out.pooler_output, self.head_dropout)
