"""Checkpoint conversion between HF PyTorch state dicts and this port's state
dicts (port of the JAX package's ``vault_tpu/models/convert.py``, backbone
converters, and of ``llama_params_from_torch``).

The reference loads ``dandelin/vilt-b32-*`` and BERT/BERTweet checkpoints
through HF ``from_pretrained`` (vault/models/vault/model.py:92-128); here the
same state dicts are re-laid into the port's keys, which are the JAX
package's pytree paths with the encoder layers numbered
(``layers.<i>.q.w``; ``vault_tpu_torch/convert.py`` bridges to the stacked
JAX trees).

Layout notes:
  * an HF ``nn.Linear`` weight is (out, in); the port's is (in, out), so it
    is transposed (and made contiguous);
  * a ``Conv2d`` weight (O, I, kh, kw) is kept as it is (patchify reads OIHW);
  * every float is upcast to fp32, as the JAX package's ``_np`` does, so a
    bf16 or fp16 checkpoint gives the same parameters in both packages.

Sources may hold tensors or numpy arrays.  The task-head converters
(``*_head_from_torch``) return the head's state dict (``transform.w``, ...),
to be placed under its key of the model (``mlm``, ``vqa``, ``rank``,
``pair``).
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from vault_tpu_torch.config import TextTowerConfig, ViltConfig

StateDict = Dict[str, torch.Tensor]


def _f32(t) -> torch.Tensor:
    """A source leaf as an fp32 CPU tensor of its own."""
    if isinstance(t, torch.Tensor):
        return t.detach().to("cpu", torch.float32, copy=True)
    return torch.from_numpy(np.array(t, dtype=np.float32, copy=True))


def _lin(out: StateDict, sd, key: str, name: str):
    out[f"{key}.w"] = _f32(sd[f"{name}.weight"]).t().contiguous()
    if f"{name}.bias" in sd:
        out[f"{key}.b"] = _f32(sd[f"{name}.bias"])


def _ln(out: StateDict, sd, key: str, name: str):
    out[f"{key}.scale"] = _f32(sd[f"{name}.weight"])
    out[f"{key}.bias"] = _f32(sd[f"{name}.bias"])


def strip_prefix(state_dict: Mapping, prefix: str) -> dict:
    """The entries of ``state_dict`` under ``prefix``, with it removed."""
    if not prefix:
        return dict(state_dict)
    return {k[len(prefix):]: v for k, v in state_dict.items() if k.startswith(prefix)}


def bert_params_from_torch(state_dict: Mapping, cfg: TextTowerConfig,
                           prefix: str = "") -> StateDict:
    """The BERT tower's state dict from an HF ``BertModel`` /
    ``RobertaModel`` state dict (``add_pooling_layer=False``)."""
    sd = strip_prefix(state_dict, prefix)
    out: StateDict = {}
    for key, name in (("word", "word_embeddings"), ("position", "position_embeddings"),
                      ("token_type", "token_type_embeddings")):
        out[f"embeddings.{key}"] = _f32(sd[f"embeddings.{name}.weight"])
    _ln(out, sd, "embeddings.ln", "embeddings.LayerNorm")
    for i in range(cfg.num_hidden_layers):
        p, k = f"encoder.layer.{i}", f"layers.{i}"
        _lin(out, sd, f"{k}.q", f"{p}.attention.self.query")
        _lin(out, sd, f"{k}.k", f"{p}.attention.self.key")
        _lin(out, sd, f"{k}.v", f"{p}.attention.self.value")
        _lin(out, sd, f"{k}.attn_out", f"{p}.attention.output.dense")
        _ln(out, sd, f"{k}.attn_ln", f"{p}.attention.output.LayerNorm")
        _lin(out, sd, f"{k}.mlp_in", f"{p}.intermediate.dense")
        _lin(out, sd, f"{k}.mlp_out", f"{p}.output.dense")
        _ln(out, sd, f"{k}.mlp_ln", f"{p}.output.LayerNorm")
    return out


def vilt_params_from_torch(state_dict: Mapping, cfg: ViltConfig,
                           prefix: str = "") -> StateDict:
    """The ViLT tower's state dict from an HF ``ViltModel`` state dict
    (optionally under a prefix such as ``vilt.``).  The pooler is there only
    when the source has one, as in the JAX package (``vilt_apply`` then
    returns no pooled output)."""
    sd = strip_prefix(state_dict, prefix)
    out: StateDict = {}
    te = "embeddings.text_embeddings"
    for key, name in (("word", "word_embeddings"), ("position", "position_embeddings"),
                      ("token_type", "token_type_embeddings")):
        out[f"text_embeddings.{key}"] = _f32(sd[f"{te}.{name}.weight"])
    _ln(out, sd, "text_embeddings.ln", f"{te}.LayerNorm")
    out["cls_token"] = _f32(sd["embeddings.cls_token"]).reshape(-1)
    out["patch_proj.w"] = _f32(sd["embeddings.patch_embeddings.projection.weight"])
    out["patch_proj.b"] = _f32(sd["embeddings.patch_embeddings.projection.bias"])
    out["pos_embeddings"] = _f32(sd["embeddings.position_embeddings"]).reshape(
        -1, cfg.hidden_size)
    out["modality_type"] = _f32(sd["embeddings.token_type_embeddings.weight"])
    _ln(out, sd, "final_ln", "layernorm")
    for i in range(cfg.num_hidden_layers):
        p, k = f"encoder.layer.{i}", f"layers.{i}"
        _ln(out, sd, f"{k}.ln_before", f"{p}.layernorm_before")
        _lin(out, sd, f"{k}.q", f"{p}.attention.attention.query")
        _lin(out, sd, f"{k}.k", f"{p}.attention.attention.key")
        _lin(out, sd, f"{k}.v", f"{p}.attention.attention.value")
        _lin(out, sd, f"{k}.attn_out", f"{p}.attention.output.dense")
        _ln(out, sd, f"{k}.ln_after", f"{p}.layernorm_after")
        _lin(out, sd, f"{k}.mlp_in", f"{p}.intermediate.dense")
        _lin(out, sd, f"{k}.mlp_out", f"{p}.output.dense")
    if "pooler.dense.weight" in sd:
        _lin(out, sd, "pooler", "pooler.dense")
    return out


def llama_params_from_torch(state_dict: Mapping, cfg, prefix: str = "") -> StateDict:
    """The Llama tower's state dict (the ``llama`` module of
    :class:`~vault_tpu_torch.models.vault.VaultWithLlamaTower`) from an HF
    ``LlamaModel`` / ``LlamaForCausalLM`` state dict (a ``model.`` prefix is
    dropped).  ``cfg`` is a :class:`~vault_tpu_torch.models.llama.LlamaConfig`."""
    sd = strip_prefix(state_dict, prefix)
    if any(k.startswith("model.") for k in sd):
        sd = strip_prefix(sd, "model.")
    out: StateDict = {"embed": _f32(sd["embed_tokens.weight"])}
    for i in range(cfg.num_hidden_layers):
        p = f"layers.{i}"  # the same in both layouts
        out[f"{p}.input_ln"] = _f32(sd[f"{p}.input_layernorm.weight"])
        for key, name in (("q", "self_attn.q_proj"), ("k", "self_attn.k_proj"),
                          ("v", "self_attn.v_proj"), ("o", "self_attn.o_proj"),
                          ("gate", "mlp.gate_proj"), ("up", "mlp.up_proj"),
                          ("down", "mlp.down_proj")):
            out[f"{p}.{key}.w"] = _f32(sd[f"{p}.{name}.weight"]).t().contiguous()
        out[f"{p}.post_ln"] = _f32(sd[f"{p}.post_attention_layernorm.weight"])
    out["final_ln"] = _f32(sd["norm.weight"])
    return out


# ---------------------------------------------------------------------------
# Reverse converters: the port's state dicts -> HF state dicts
# ---------------------------------------------------------------------------

def _lin_out(sd: StateDict, name: str, params: Mapping, key: str):
    sd[f"{name}.weight"] = _f32(params[f"{key}.w"]).t().contiguous()
    if f"{key}.b" in params:
        sd[f"{name}.bias"] = _f32(params[f"{key}.b"])


def _ln_out(sd: StateDict, name: str, params: Mapping, key: str):
    sd[f"{name}.weight"] = _f32(params[f"{key}.scale"])
    sd[f"{name}.bias"] = _f32(params[f"{key}.bias"])


def bert_params_to_torch(params: Mapping, cfg: TextTowerConfig,
                         prefix: str = "") -> StateDict:
    """The BERT tower's state dict (``model.bert.state_dict()``) -> an HF
    ``BertModel(add_pooling_layer=False)`` state dict, fp32."""
    sd: StateDict = {}
    for key, name in (("word", "word_embeddings"), ("position", "position_embeddings"),
                      ("token_type", "token_type_embeddings")):
        sd[f"embeddings.{name}.weight"] = _f32(params[f"embeddings.{key}"])
    _ln_out(sd, "embeddings.LayerNorm", params, "embeddings.ln")
    for i in range(cfg.num_hidden_layers):
        p, k = f"encoder.layer.{i}", f"layers.{i}"
        _lin_out(sd, f"{p}.attention.self.query", params, f"{k}.q")
        _lin_out(sd, f"{p}.attention.self.key", params, f"{k}.k")
        _lin_out(sd, f"{p}.attention.self.value", params, f"{k}.v")
        _lin_out(sd, f"{p}.attention.output.dense", params, f"{k}.attn_out")
        _ln_out(sd, f"{p}.attention.output.LayerNorm", params, f"{k}.attn_ln")
        _lin_out(sd, f"{p}.intermediate.dense", params, f"{k}.mlp_in")
        _lin_out(sd, f"{p}.output.dense", params, f"{k}.mlp_out")
        _ln_out(sd, f"{p}.output.LayerNorm", params, f"{k}.mlp_ln")
    return {prefix + k: v for k, v in sd.items()}


def vilt_params_to_torch(params: Mapping, cfg: ViltConfig, prefix: str = "") -> StateDict:
    """The ViLT tower's state dict (``model.vilt.state_dict()``) -> an HF
    ``ViltModel`` state dict, fp32."""
    sd: StateDict = {}
    te = "embeddings.text_embeddings"
    for key, name in (("word", "word_embeddings"), ("position", "position_embeddings"),
                      ("token_type", "token_type_embeddings")):
        sd[f"{te}.{name}.weight"] = _f32(params[f"text_embeddings.{key}"])
    _ln_out(sd, f"{te}.LayerNorm", params, "text_embeddings.ln")
    sd["embeddings.cls_token"] = _f32(params["cls_token"]).reshape(1, 1, -1)
    sd["embeddings.patch_embeddings.projection.weight"] = _f32(params["patch_proj.w"])
    sd["embeddings.patch_embeddings.projection.bias"] = _f32(params["patch_proj.b"])
    sd["embeddings.position_embeddings"] = _f32(params["pos_embeddings"])[None]
    sd["embeddings.token_type_embeddings.weight"] = _f32(params["modality_type"])
    _ln_out(sd, "layernorm", params, "final_ln")
    for i in range(cfg.num_hidden_layers):
        p, k = f"encoder.layer.{i}", f"layers.{i}"
        _ln_out(sd, f"{p}.layernorm_before", params, f"{k}.ln_before")
        _lin_out(sd, f"{p}.attention.attention.query", params, f"{k}.q")
        _lin_out(sd, f"{p}.attention.attention.key", params, f"{k}.k")
        _lin_out(sd, f"{p}.attention.attention.value", params, f"{k}.v")
        _lin_out(sd, f"{p}.attention.output.dense", params, f"{k}.attn_out")
        _ln_out(sd, f"{p}.layernorm_after", params, f"{k}.ln_after")
        _lin_out(sd, f"{p}.intermediate.dense", params, f"{k}.mlp_in")
        _lin_out(sd, f"{p}.output.dense", params, f"{k}.mlp_out")
    if "pooler.w" in params:
        _lin_out(sd, "pooler.dense", params, "pooler")
    return {prefix + k: v for k, v in sd.items()}


# ---------------------------------------------------------------------------
# Task-head converters (HF ViltFor* checkpoints <-> the port's head state dicts)
# ---------------------------------------------------------------------------

def mlm_head_from_torch(state_dict: Mapping, prefix: str = "mlm_score.") -> StateDict:
    """ViltForMaskedLM's mlm_score (modeling_vilt.py:889-908); the decoder is
    tied to the word embeddings, so only the transform and the bias are
    stored."""
    sd = strip_prefix(state_dict, prefix)
    out: StateDict = {}
    _lin(out, sd, "transform", "transform.dense")
    _ln(out, sd, "transform_ln", "transform.LayerNorm")
    out["bias"] = _f32(sd["bias"])
    return out


def _seq_head_from_torch(state_dict: Mapping, prefix: str) -> StateDict:
    """Sequential(Linear, LayerNorm, GELU, Linear) under ``prefix``."""
    sd = strip_prefix(state_dict, prefix)
    out: StateDict = {}
    _lin(out, sd, "in", "0")
    _ln(out, sd, "ln", "1")
    _lin(out, sd, "out", "3")
    return out


def vqa_head_from_torch(state_dict: Mapping, prefix: str = "classifier.") -> StateDict:
    """ViltForQuestionAnswering's Sequential(Linear, LN, GELU, Linear)."""
    return _seq_head_from_torch(state_dict, prefix)


def rank_head_from_torch(state_dict: Mapping, prefix: str = "") -> StateDict:
    """ViltForImageAndTextRetrieval's rank_output, or the itm-checkpoint
    surgery: row 1 of a 2-way itm_score head becomes the rank head
    (vault/models/vault/model.py:375-405)."""
    sd = strip_prefix(state_dict, prefix)
    out: StateDict = {}
    if "rank_output.weight" in sd:
        _lin(out, sd, "out", "rank_output")
        return out
    itm: StateDict = {}
    _lin(itm, sd, "itm", "itm_score.fc" if "itm_score.fc.weight" in sd else "itm_score")
    out["out.w"] = itm["itm.w"][:, 1:2].contiguous()
    out["out.b"] = itm["itm.b"][1:2].clone()
    return out


def pair_head_from_torch(state_dict: Mapping, prefix: str = "classifier.") -> StateDict:
    """ViltForImagesAndTextClassification's NLVR2 classifier."""
    return _seq_head_from_torch(state_dict, prefix)
