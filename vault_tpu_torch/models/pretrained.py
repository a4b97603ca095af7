"""Loading pretrained checkpoints from local HF-format directories (port of
the JAX package's ``vault_tpu/models/pretrained.py``).

The reference calls ``from_pretrained`` on hub names (downloads); here
checkpoints are local directories in HF layout (config.json +
model.safetensors / pytorch_model.bin [+ vocab files]).  When a path is not
a directory the named geometry is initialized at random, loudly, so every
code path stays runnable without weights.

``model.safetensors`` is read (and written, :func:`save_safetensors`) by
this module itself: the format is an 8-byte little-endian header length, a
JSON header mapping each tensor name to its ``dtype``, ``shape`` and
``data_offsets`` (plus an optional ``__metadata__``), then the raw bytes.
"""

from __future__ import annotations

import json
import logging
import os
import struct
from typing import Dict, Mapping, Optional

import torch

from vault_tpu_torch.config import TextTowerConfig, VaultConfig, ViltConfig
from vault_tpu_torch.models import bert as bert_mod
from vault_tpu_torch.models import vilt as vilt_mod
from vault_tpu_torch.models.convert import bert_params_from_torch, vilt_params_from_torch
from vault_tpu_torch.presets import bert_base_uncased, bertweet_base, vilt_b32

logger = logging.getLogger(__name__)

_ST_DTYPES = {"F64": torch.float64, "F32": torch.float32, "F16": torch.float16,
              "BF16": torch.bfloat16, "I64": torch.int64, "I32": torch.int32,
              "I16": torch.int16, "I8": torch.int8, "U8": torch.uint8,
              "BOOL": torch.bool}
_ST_NAMES = {v: k for k, v in _ST_DTYPES.items()}


def load_safetensors(path: str) -> Dict[str, torch.Tensor]:
    """Every tensor of a ``.safetensors`` file, as CPU tensors of their
    stored types (bf16 included), each in memory of its own."""
    out = {}
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
        base = 8 + n
        for name, info in header.items():
            if name == "__metadata__":
                continue
            dtype = _ST_DTYPES.get(info["dtype"])
            if dtype is None:
                raise ValueError(f"{path}: {name} has unsupported dtype {info['dtype']}")
            start, end = info["data_offsets"]
            shape = tuple(info["shape"])
            numel = 1
            for d in shape:
                numel *= d
            if end - start != numel * torch.empty((), dtype=dtype).element_size():
                raise ValueError(f"{path}: {name} holds {end - start} bytes for "
                                 f"{info['dtype']} {list(shape)}")
            buf = bytearray(end - start)
            f.seek(base + start)
            if f.readinto(buf) != len(buf):
                raise ValueError(f"{path}: {name} runs past the end of the file")
            out[name] = (torch.frombuffer(buf, dtype=dtype).reshape(shape) if buf
                         else torch.empty(shape, dtype=dtype))
    return out


def save_safetensors(tensors: Mapping[str, torch.Tensor], path: str,
                     metadata: Optional[Dict[str, str]] = None) -> None:
    """Write ``tensors`` (any device, any of the format's types) as a
    ``.safetensors`` file, in the order given."""
    header, blobs, offset = {}, [], 0
    for name, t in tensors.items():
        t = t.detach().to("cpu").contiguous()
        data = t.reshape(-1).view(torch.uint8).numpy().tobytes()
        header[name] = {"dtype": _ST_NAMES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + len(data)]}
        blobs.append(data)
        offset += len(data)
    if metadata:
        header["__metadata__"] = dict(metadata)
    raw = json.dumps(header, separators=(",", ":")).encode()
    raw += b" " * (-len(raw) % 8)  # the data starts 8-byte aligned
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(raw)))
        f.write(raw)
        for data in blobs:
            f.write(data)


def load_torch_state_dict(model_dir: str) -> Dict[str, torch.Tensor]:
    """The state dict of a local HF checkpoint directory:
    ``model.safetensors`` first, else ``pytorch_model.bin`` (loaded with
    ``weights_only=True``)."""
    st_path = os.path.join(model_dir, "model.safetensors")
    bin_path = os.path.join(model_dir, "pytorch_model.bin")
    if os.path.exists(st_path):
        return load_safetensors(st_path)
    if os.path.exists(bin_path):
        return torch.load(bin_path, map_location="cpu", weights_only=True)
    raise FileNotFoundError(f"no weights in {model_dir}")


def _read_config(model_dir: str) -> Optional[dict]:
    p = os.path.join(model_dir, "config.json")
    if os.path.exists(p):
        with open(p) as f:
            return json.load(f)
    return None


def text_config_from_name(name_or_path: str) -> TextTowerConfig:
    """The language tower's geometry from ``config.json``; without one, the
    preset the name suggests (BERTweet-base or bert-base-uncased)."""
    cfg = _read_config(name_or_path) if os.path.isdir(name_or_path) else None
    if cfg is None:
        if "bertweet" in name_or_path:
            return bertweet_base()
        return bert_base_uncased()
    style = "roberta" if cfg.get("model_type") == "roberta" else "bert"
    return TextTowerConfig(
        vocab_size=cfg["vocab_size"], hidden_size=cfg["hidden_size"],
        num_hidden_layers=cfg["num_hidden_layers"],
        num_attention_heads=cfg["num_attention_heads"],
        intermediate_size=cfg["intermediate_size"],
        hidden_act=cfg.get("hidden_act", "gelu"),
        hidden_dropout_prob=cfg.get("hidden_dropout_prob", 0.1),
        attention_probs_dropout_prob=cfg.get("attention_probs_dropout_prob", 0.1),
        max_position_embeddings=cfg["max_position_embeddings"],
        type_vocab_size=cfg.get("type_vocab_size", 2),
        layer_norm_eps=cfg.get("layer_norm_eps", 1e-12),
        pad_token_id=cfg.get("pad_token_id", 0),
        position_embedding_style=style,
    )


def vilt_config_from_name(name_or_path: str, **overrides) -> ViltConfig:
    """ViLT's geometry from ``config.json``; without one, ViLT-B/32."""
    cfg = _read_config(name_or_path) if os.path.isdir(name_or_path) else None
    if cfg is None:
        return vilt_b32(**overrides)
    kw = dict(
        vocab_size=cfg["vocab_size"], hidden_size=cfg["hidden_size"],
        num_hidden_layers=cfg["num_hidden_layers"],
        num_attention_heads=cfg["num_attention_heads"],
        intermediate_size=cfg["intermediate_size"],
        hidden_act=cfg.get("hidden_act", "gelu"),
        hidden_dropout_prob=cfg.get("hidden_dropout_prob", 0.0),
        attention_probs_dropout_prob=cfg.get("attention_probs_dropout_prob", 0.0),
        max_position_embeddings=cfg["max_position_embeddings"],
        type_vocab_size=cfg.get("type_vocab_size", 2),
        layer_norm_eps=cfg.get("layer_norm_eps", 1e-12),
        image_size=cfg.get("image_size", 384),
        patch_size=cfg.get("patch_size", 32),
        qkv_bias=cfg.get("qkv_bias", True),
        max_image_length=cfg.get("max_image_length", -1),
        modality_type_vocab_size=cfg.get("modality_type_vocab_size", 2),
    )
    kw.update(overrides)
    return ViltConfig(**kw)


def _strip_known_prefixes(sd, prefixes=("vilt.", "bert.", "roberta.")):
    """The entries under the first of ``prefixes`` that any key starts with,
    that prefix removed, and the prefix; the whole dict and "" when none."""
    for p in prefixes:
        if any(k.startswith(p) for k in sd):
            return {k[len(p):]: v for k, v in sd.items() if k.startswith(p)}, p
    return dict(sd), ""


def load_vault_backbone(cfg: VaultConfig, gen: torch.Generator,
                        vilt_path: Optional[str] = None,
                        bert_path: Optional[str] = None) -> Dict[str, torch.Tensor]:
    """``VaultMixin.from_pretrained`` (vault/models/vault/model.py:92-128):
    the backbone's state dict (``vilt.*``, and ``bert.*`` with a text
    tower), fp32 on the host, from ViLT's and the LM tower's checkpoint
    directories.  A tower whose path is not a directory is drawn at random
    from ``gen`` (ViLT first, then the LM tower, as ``init_vault`` draws
    them), with a warning when a path was named."""
    vilt_cfg = cfg.resolved_vilt()

    def _warn_random(which, path):
        # random init MUST be loud: a typo'd local path (or a hub name, which
        # nothing here downloads) would otherwise produce a completed run
        # with untrained-backbone metrics that look like a bad experiment
        logger.warning(
            "%s: %r is not a local checkpoint directory — initializing "
            "RANDOM weights (hub downloads are unavailable here)",
            which, path)

    def prefixed(prefix, tower):
        return {f"{prefix}.{k}": v for k, v in tower.items()}

    if vilt_path and os.path.isdir(vilt_path):
        sd, _ = _strip_known_prefixes(load_torch_state_dict(vilt_path))
        out = prefixed("vilt", vilt_params_from_torch(sd, vilt_cfg))
    else:
        if vilt_path:
            _warn_random("vilt tower", vilt_path)
        out = prefixed("vilt", vilt_mod.init_vilt(gen, vilt_cfg).state_dict())
    if cfg.text_tower is not None:
        if bert_path and os.path.isdir(bert_path):
            sd, _ = _strip_known_prefixes(load_torch_state_dict(bert_path))
            out.update(prefixed("bert", bert_params_from_torch(sd, cfg.text_tower)))
        else:
            if bert_path:
                _warn_random("LM tower", bert_path)
            out.update(prefixed("bert", bert_mod.init_bert(gen, cfg.text_tower)
                                .state_dict()))
    return out


def load_bert_tower(model_dir: str, cfg: TextTowerConfig) -> Dict[str, torch.Tensor]:
    """One BERT/RoBERTa tower's state dict from a local HF checkpoint
    directory (the building block of TomBERT's from_pretrained surgery,
    vault/models/tombert/model.py:131-183)."""
    sd, _ = _strip_known_prefixes(load_torch_state_dict(model_dir))
    return bert_params_from_torch(sd, cfg)


def build_tokenizer(name_or_path: str, max_length: int = 40):
    """The tokenizer of a local checkpoint directory: fastBPE for BERTweet's
    ``bpe.codes`` + ``vocab.txt``, WordPiece for a ``vocab.txt``, byte-level
    BPE for ``vocab.json`` + ``merges.txt``, else HF ``AutoTokenizer`` (an
    existing directory whose tokenizer cannot be built raises).  A name that
    is not a directory gets a minimal WordPiece vocabulary (random-weight
    runs, tests)."""
    from vault_tpu_torch.text.wordpiece import WordPieceTokenizer

    if os.path.isdir(name_or_path):
        vocab = os.path.join(name_or_path, "vocab.txt")
        bpe_codes = os.path.join(name_or_path, "bpe.codes")
        if os.path.exists(bpe_codes) and os.path.exists(vocab):
            # BERTweet layout: fairseq dict vocab + fastBPE codes
            from vault_tpu_torch.text.fastbpe import FastBPE

            return FastBPE(vocab, bpe_codes)
        if os.path.exists(vocab):
            # do_lower_case lives in tokenizer_config.json (HF layout);
            # fall back to the name heuristic: lowercase unless the name
            # says "cased" without "uncased" (bert-base-cased vs -uncased)
            lower = None
            tok_cfg_path = os.path.join(name_or_path, "tokenizer_config.json")
            if os.path.exists(tok_cfg_path):
                with open(tok_cfg_path) as f:
                    lower = json.load(f).get("do_lower_case")
            if lower is None:
                lower = (_read_config(name_or_path) or {}).get("do_lower_case")
            if lower is None:
                base = os.path.basename(os.path.normpath(name_or_path))
                lower = not ("cased" in base and "uncased" not in base)
            return WordPieceTokenizer(vocab, lowercase=bool(lower))
        vjson = os.path.join(name_or_path, "vocab.json")
        merges = os.path.join(name_or_path, "merges.txt")
        if os.path.exists(vjson) and os.path.exists(merges):
            from vault_tpu_torch.text.bpe import ByteLevelBPE

            return ByteLevelBPE(vjson, merges)
        try:
            # tokenizer.json fast-tokenizer layouts and other formats
            from transformers import AutoTokenizer

            tok = AutoTokenizer.from_pretrained(name_or_path)
            if max_length:
                tok.model_max_length = max_length
            return tok
        except Exception as e:
            # an EXISTING checkpoint dir whose tokenizer can't be built must
            # not silently degrade to the 57-token toy vocab — real weights
            # + garbage token ids produce quietly wrong predictions
            raise RuntimeError(
                f"{name_or_path} is a checkpoint directory but no tokenizer "
                f"could be built from it (no vocab.txt / vocab.json+merges "
                f"/ bpe.codes; AutoTokenizer failed with: {e})") from e
    # not a local path at all: minimal functional tokenizer (random-weight
    # runs / tests)
    base = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"] + \
        [chr(c) for c in range(ord("a"), ord("z") + 1)] + \
        ["##" + chr(c) for c in range(ord("a"), ord("z") + 1)]
    return WordPieceTokenizer({t: i for i, t in enumerate(base)})
