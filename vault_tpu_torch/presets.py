"""Named model geometries matching the checkpoints the reference targets.

Reference defaults: ViLT tower ``dandelin/vilt-b32-mlm``
(vault/models/vault/model.py:30-32), LM tower ``bert-base-uncased`` or
``vinai/bertweet-base`` (scripts/test-results.sh).
"""

from __future__ import annotations

from vault_tpu_torch.config import (
    TextTowerConfig,
    VaultConfig,
    ViltConfig,
    bertweet_config,
)


def bert_base_uncased() -> TextTowerConfig:
    return TextTowerConfig()  # defaults are exactly bert-base-uncased geometry


def bertweet_base() -> TextTowerConfig:
    return bertweet_config()


def vilt_b32(**kw) -> ViltConfig:
    return ViltConfig(**kw)


def vault_base(tower: str = "bert-base-uncased", **kw) -> VaultConfig:
    towers = {
        "bert-base-uncased": bert_base_uncased,
        "bertweet-base": bertweet_base,
        "vinai/bertweet-base": bertweet_base,  # the reference's full name
        None: lambda: None,
        "none": lambda: None,
    }
    if tower not in towers:
        raise ValueError(f"unknown tower preset {tower!r}; valid: "
                         f"{sorted(k for k in towers if isinstance(k, str))}")
    return VaultConfig(vilt=vilt_b32(), text_tower=towers[tower](), **kw)
