"""Typed, hashable configuration for the PyTorch port of VAuLT.

A copy of the JAX package's ``vault_tpu/config.py``: the port imports
nothing of that package, so it keeps its own dataclasses with the same
fields and defaults.

The reference (gchochla/VAuLT) drives configuration through HuggingFace
``PretrainedConfig`` objects plus per-class ``argparse_args`` dicts
(``vault/models/vault/model.py:29-51``). Here every model is configured by a
frozen dataclass.

Reference quirk intentionally NOT replicated: the reference writes its ViLT
dropout override to misspelled attributes (``vault/models/vault/model.py:71-75``)
making it a no-op; we expose a working ``hidden_dropout_prob`` /
``attention_probs_dropout_prob`` instead (the *intent* of that code).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional


@dataclass(frozen=True)
class TextTowerConfig:
    """Configuration of the language tower (BERT / BERTweet-RoBERTa).

    Mirrors the contract of HF ``BertModel`` / ``RobertaModel`` as used by the
    reference at ``vault/models/vault/model.py:82-86, 118-122`` (always with
    ``add_pooling_layer=False``).
    """

    vocab_size: int = 30522
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    hidden_act: str = "gelu"
    hidden_dropout_prob: float = 0.1
    attention_probs_dropout_prob: float = 0.1
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    layer_norm_eps: float = 1e-12
    pad_token_id: int = 0
    # "bert": position ids are 0..L-1.  "roberta" (BERTweet): position ids are
    # cumsum(attention_mask) * mask + pad_token_id (HF create_position_ids_
    # from_input_ids), and type_vocab_size is 1 — the reference zeroes incoming
    # token_type_ids for such towers (vault/models/vault/model.py:174-180).
    position_embedding_style: str = "bert"
    initializer_range: float = 0.02

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads


def bertweet_config(**kw) -> TextTowerConfig:
    """vinai/bertweet-base geometry (RoBERTa architecture)."""
    base = dict(
        vocab_size=64001,
        max_position_embeddings=130,
        type_vocab_size=1,
        pad_token_id=1,
        position_embedding_style="roberta",
    )
    base.update(kw)
    return TextTowerConfig(**base)


@dataclass(frozen=True)
class ViltConfig:
    """ViLT co-encoder configuration (dandelin/vilt-b32-* geometry).

    Matches the external numerical contract the reference relies on via HF
    ``ViltModel`` (SURVEY.md §2.7; call sites vault/models/vault/model.py:204-218).

    Fields with no HF counterpart:
      * ``num_patch_tokens``: static image-token budget.  HF selects/pads
        patches with data-dependent ``torch.multinomial`` (non-deterministic);
        we deterministically gather valid patches first (raster order) and pad
        to this static length with masked slots.  Equivalent under masking.
      * ``add_text_position_embeddings``: the reference disables ViLT's
        absolute text position embeddings by smuggling the string
        "NOT_absolute" into the HF config (vault/models/vault/model.py:77-79,
        112-116); here it is an honest boolean.
    """

    vocab_size: int = 30522
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    hidden_act: str = "gelu"
    hidden_dropout_prob: float = 0.0
    attention_probs_dropout_prob: float = 0.0
    max_position_embeddings: int = 40
    type_vocab_size: int = 2
    layer_norm_eps: float = 1e-12
    pad_token_id: int = 0
    image_size: int = 384
    patch_size: int = 32
    num_channels: int = 3
    qkv_bias: bool = True
    # HF semantic: <0 means "budget = max effective patches in batch".  We keep
    # it for config parity but the static budget is num_patch_tokens below.
    max_image_length: int = -1
    modality_type_vocab_size: int = 2
    num_images: int = 2
    initializer_range: float = 0.02
    add_text_position_embeddings: bool = True
    # Static image-token budget (excludes CLS).  The ViltProcessor geometry
    # (shortest edge 384, longest <= 639, /32) yields at most 12x19 = 228
    # patches.  Default 215 makes the joint sequence 40 + 1 + 215 = 256
    # (the JAX package's choice, kept so both packages see one geometry)
    # while staying above the 200-patch budget ViLT itself was trained with; only extreme
    # aspect-ratio images (>= 12x18 grids) lose their last raster patches.
    # Set 228 for exhaustive patch coverage.
    num_patch_tokens: int = 215

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @property
    def pos_grid(self) -> int:
        """Side of the pretrained patch position-embedding grid (12 for b32)."""
        return self.image_size // self.patch_size


@dataclass(frozen=True)
class VaultConfig:
    """Full VAuLT model: optional text tower feeding the ViLT co-encoder.

    Reference mechanism: ``VaultMixin.lm_preprocess`` runs BERT over
    ``input_ids`` and passes ``last_hidden_state`` to ViLT as ``inputs_embeds``
    (vault/models/vault/model.py:151-218).  Here this is explicit composition:
    ``bert.apply`` then ``vilt.apply(inputs_embeds=...)``.
    """

    vilt: ViltConfig = ViltConfig()
    text_tower: Optional[TextTowerConfig] = None
    # Reference default: when a BERT tower is present, ViLT's own text position
    # embeddings are disabled (vault/models/vault/model.py:78-79).
    use_vilt_position_embeddings: bool = False
    freeze_lm: bool = False

    def resolved_vilt(self) -> ViltConfig:
        """ViLT config with the position-embedding switch applied."""
        if self.text_tower is not None and not self.use_vilt_position_embeddings:
            return dataclasses.replace(self.vilt, add_text_position_embeddings=False)
        return self.vilt


def vilt_b32_config(**kw) -> ViltConfig:
    return ViltConfig(**kw)


def tiny_text_config(**kw) -> TextTowerConfig:
    """Small geometry for tests."""
    base = dict(
        vocab_size=99,
        hidden_size=32,
        num_hidden_layers=2,
        num_attention_heads=4,
        intermediate_size=64,
        max_position_embeddings=64,
    )
    base.update(kw)
    return TextTowerConfig(**base)


def tiny_vilt_config(**kw) -> ViltConfig:
    base = dict(
        vocab_size=99,
        hidden_size=32,
        num_hidden_layers=2,
        num_attention_heads=4,
        intermediate_size=64,
        max_position_embeddings=40,
        image_size=64,
        patch_size=16,
        num_patch_tokens=30,
    )
    base.update(kw)
    return ViltConfig(**base)


def debug_tiny_vault_config() -> "VaultConfig":
    """The tiny debug geometry of the JAX package (real tokenizer vocab,
    64x64 canvas), so checkpoints made under it load in either package."""
    return VaultConfig(
        vilt=tiny_vilt_config(image_size=64, patch_size=16,
                              num_patch_tokens=16, vocab_size=30522),
        text_tower=tiny_text_config(vocab_size=30522))
