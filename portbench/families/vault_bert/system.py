"""The system under test for the ``vault_bert`` family: the PyTorch and
CUDA port ``vault_tpu_torch``, entered where its users enter it.  Scoring
calls a ``VaultForClassification`` (quantized as its ``quantize`` does it
when the configuration says so); training calls ``Trainer.train_step``.
Only a family's ``system.py`` imports the port, and it imports nothing
else of the repository.
"""

from __future__ import annotations

import dataclasses

import torch

from vault_tpu_torch.config import TextTowerConfig, VaultConfig, ViltConfig
from vault_tpu_torch.models.vault import VaultForClassification
from vault_tpu_torch.training.trainer import TrainArgs, Trainer, classifier_apply_fn

MODES = ("score", "train")


def _fields(cls, values: dict) -> dict:
    names = {f.name for f in dataclasses.fields(cls)}
    return {k: v for k, v in values.items() if k in names}


def program_config(cfg: dict) -> VaultConfig:
    """The port's configuration of a benchmark configuration file."""
    t = dict(cfg["text_tower"])
    t["position_embedding_style"] = "roberta" if t["model_type"] == "roberta" else "bert"
    v = dict(cfg["vilt"], num_patch_tokens=cfg["assumed"]["num_patch_tokens"])
    return VaultConfig(vilt=ViltConfig(**_fields(ViltConfig, v)),
                       text_tower=TextTowerConfig(**_fields(TextTowerConfig, t)))


def build_scorer(cfg: dict, weights: dict) -> VaultForClassification:
    """The classifier holding ``weights`` (taken as they are, no copy), on
    their device and in their type, quantized when ``cfg["quantize"]``
    names a mode, on the kernel selector ``cfg["use_pallas"]`` ("auto": the
    port's own choice for the device and the quantization)."""
    device = next(iter(weights.values())).device
    with torch.device("meta"):
        model = VaultForClassification(program_config(cfg), n_classes=cfg["head"]["n_classes"],
                                       device="meta", head_dropout=cfg["head"]["dropout"],
                                       use_pallas=cfg["use_pallas"])
    model.load_state_dict(weights, strict=True, assign=True)
    if model.device != device:
        raise RuntimeError(f"the model landed on {model.device}, its weights on {device}")
    if cfg["quantize"]:
        model.quantize(cfg["quantize"])
    return model.eval()


def build_trainer(cfg: dict, traffic: dict, weights: dict, seed: int) -> Trainer:
    """A trainer over ``weights`` (the fp32 masters; the trainer copies
    them) at ``TrainArgs``' defaults with the traffic's overrides, its
    optimizer built for ``steps_per_epoch`` steps an epoch."""
    args = TrainArgs(seed=seed, train_batch_size=traffic["batch"],
                     use_pallas=cfg["use_pallas"], **traffic["train_args"])
    device = next(iter(weights.values())).device
    trainer = Trainer(classifier_apply_fn(program_config(cfg), args,
                                          head_dropout=cfg["head"]["dropout"]),
                      weights, args, train_dataset=None, device=device)
    trainer._build_optimizer(traffic["steps_per_epoch"])
    return trainer

