"""The weights of the ``vault_bert`` family, a BERT or BERTweet tower
feeding ViLT: every parameter of ``portbench/reference/vault_ref.py``'s
:func:`param_shapes`, made on the device from the run's seed."""

from __future__ import annotations

import math
from typing import Dict

import torch

from portbench.generate import generator
from portbench.reference.vault_ref import param_shapes

# weights drawn at 0.02 * sqrt(768 / 32), the published range scaled to the
# narrow width, so that each layer's outputs keep their full-width size and
# the logits move from pair to pair as the full model's do (by about 0.1)
TINY_STD = 0.1
TINY_TOWER = dict(vocab_size=99, hidden_size=32, num_hidden_layers=2, num_attention_heads=4,
                  intermediate_size=64, max_position_embeddings=64, initializer_range=TINY_STD)
TINY_VILT = dict(vocab_size=99, hidden_size=32, num_hidden_layers=2, num_attention_heads=4,
                 intermediate_size=64, image_size=64, patch_size=16,
                 initializer_range=TINY_STD)


def weight_std(cfg: dict, name: str) -> float:
    """The configuration's initializer range for a parameter: the text
    tower's for its leaves, ViLT's for the others (and the head)."""
    tower = "text_tower" if name.startswith("bert.") else "vilt"
    return cfg[tower]["initializer_range"]


def make_weights(cfg: dict, seed: int, dtype, device) -> Dict[str, torch.Tensor]:
    """Every parameter of the configuration (``param_shapes``) from one
    draw of standard normal values times the configuration's initializer
    range: LayerNorm scales are 1 plus such a value, everything else
    (matrices, embeddings, biases, LayerNorm shifts) the value itself, so
    no leaf is a constant.  Each leaf gets storage of its own, in
    ``dtype``."""
    shapes = param_shapes(cfg)
    total = sum(math.prod(s) for s in shapes.values())
    flat = torch.randn(total, generator=generator(device, seed, "weights"),
                       device=device, dtype=torch.float32)
    out, off = {}, 0
    for name, shape in shapes.items():
        n = math.prod(shape)
        leaf = flat[off:off + n].view(shape).mul_(weight_std(cfg, name))
        if name.endswith(".scale"):
            leaf.add_(1.0)
        out[name] = leaf.to(dtype, copy=True)
        off += n
    return out


def tiny(cfg: dict) -> dict:
    """``cfg`` cut to the CPU tests' size: the same layers and mechanisms,
    widths of 32, 2 + 2 layers, 12 patch tokens on 64 x 64 images."""
    return {**cfg, "text_tower": {**cfg["text_tower"], **TINY_TOWER},
            "vilt": {**cfg["vilt"], **TINY_VILT},
            "assumed": {**cfg["assumed"], "num_patch_tokens": 12}}
