"""The system under test for the ``vault_moe`` family: the PyTorch and
CUDA port ``vault_tpu_torch``, entered where its users enter it.  Scoring
calls a ``VaultWithDeepseekTower`` (the DeepSeek-V3 tower, ``lm_proj``,
ViLT and the classifier head), built on the meta device and given the
run's weights as they are.  The family scores only: training a 15.6 B
parameter model takes about 16 bytes a parameter, more than the card.
Only a family's ``system.py`` imports the port.

The scorer it builds is also left, as the program's router, to the
reference (``routes.py``): after the timed window, the reference runs the
program once more on each batch it checks and reads the experts each MoE
layer chose (``forward(batch, routes=[])``), so that it can follow the
program's choice at a tie.  Nothing of that touches the timed calls.
"""

from __future__ import annotations

import dataclasses

import torch

from portbench.families.vault_moe import routes
from vault_tpu_torch.config import ViltConfig
from vault_tpu_torch.models.deepseek import DeepseekConfig
from vault_tpu_torch.models.vault import VaultWithDeepseekTower

MODES = ("score",)
# the published config's settings that the tower holds one way only
HELD = {"attention_bias": False, "hidden_act": "silu", "model_type": "deepseek_v3"}


def _fields(cls, values: dict) -> dict:
    names = {f.name for f in dataclasses.fields(cls)}
    return {k: v for k, v in values.items() if k in names}


def program_config(cfg: dict):
    """The port's (ViLT, tower) configurations of a benchmark configuration
    file."""
    t = cfg["text_tower"]
    bad = {k: t.get(k) for k, v in HELD.items() if t.get(k) != v}
    if bad:
        raise ValueError(f"configuration {cfg['name']!r}: the tower holds {HELD}, got {bad}")
    tower = DeepseekConfig(**_fields(DeepseekConfig, t),
                           kv_norm_eps=cfg["assumed"]["kv_norm_eps"])
    v = dict(cfg["vilt"], num_patch_tokens=cfg["assumed"]["num_patch_tokens"])
    return ViltConfig(**_fields(ViltConfig, v)), tower


def build_scorer(cfg: dict, weights: dict) -> VaultWithDeepseekTower:
    """The classifier holding ``weights`` (taken as they are, no copy), on
    their device and in their type, ViLT on the kernel selector
    ``cfg["use_pallas"]``; left to the reference as the program's router
    (:func:`chosen_experts`)."""
    routes.release()
    device = next(iter(weights.values())).device
    vilt, tower = program_config(cfg)
    with torch.device("meta"):
        model = VaultWithDeepseekTower(vilt, tower, n_classes=cfg["head"]["n_classes"],
                                       device="meta", use_pallas=cfg["use_pallas"],
                                       head_dropout=cfg["head"]["dropout"])
    model.load_state_dict(weights, strict=True, assign=True)
    if model.device != device:
        raise RuntimeError(f"the model landed on {model.device}, its weights on {device}")
    model.eval()
    routes.leave(lambda batch: chosen_experts(model, batch))
    return model


def chosen_experts(model: VaultWithDeepseekTower, batch: dict) -> list:
    """Each MoE layer's chosen experts (rows, k) of the model's forward of
    ``batch``."""
    chosen = []
    with torch.no_grad():
        model(batch, routes=chosen)
    return chosen
