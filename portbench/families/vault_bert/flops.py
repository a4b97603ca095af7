"""The products a VAuLT forward and training step compute, counted as
2·M·N·K from the configuration and the input's geometry (a frozen copy of
the port's ``utils/flops.py`` arithmetic, with its training factor taken
as model work only).

Counted: every encoder layer of the text tower and of ViLT (the Q/K/V,
attention-output and two MLP products, and attention's two products per
head, q·kᵀ and p·v) and the patch projection over every patch of the
canvas.  Not counted: the pooler, the head, lookups, LayerNorm, softmax
and every other elementwise step.  A training step is 3× the forward
(the forward and the backward's two products for each product);
activation recomputation (remat) is not model work and is not counted.

At bert-base-uncased + ViLT-B/32, batch 16, 40 tokens and a 384 × 608
canvas: BERT 12 × 9.14 GF, ViLT (L = 40 + 1 + 215 = 256) 12 × 61.2 GF,
the projection over 228 patches 17.2 GF: 861 GF.
"""

from __future__ import annotations

from typing import Dict, Tuple


def encoder_layer(batch: int, length: int, hidden: int, inter: int) -> Dict[str, float]:
    """One encoder layer's products: ``dense`` (Q/K/V, attention output,
    the MLP's two) and ``attention`` (q·kᵀ and p·v over every head)."""
    rows = batch * length
    return {"dense": 2.0 * rows * hidden * (3 * hidden + hidden + 2 * inter),
            "attention": 4.0 * batch * length * length * hidden}


def vilt_length(cfg: dict, seq: int, canvas: Tuple[int, int]) -> int:
    """ViLT's joint length: the text tokens, the image CLS and
    ``min(num_patch_tokens, patches on the canvas)`` patch tokens."""
    p = cfg["vilt"]["patch_size"]
    patches = (canvas[0] // p) * (canvas[1] // p)
    return seq + 1 + min(cfg["assumed"]["num_patch_tokens"], patches)


def forward_products(cfg: dict, batch: int, seq: int, canvas: Tuple[int, int]) -> Dict[str, float]:
    """FLOPs of one forward by kind: ``dense`` (the encoder linears, which a
    w8a8 configuration runs on int8), ``attention`` and ``patch`` (the
    patch projection)."""
    t, v = cfg["text_tower"], cfg["vilt"]
    out = {"dense": 0.0, "attention": 0.0}
    for tower, length in ((t, seq), (v, vilt_length(cfg, seq, canvas))):
        layer = encoder_layer(batch, length, tower["hidden_size"], tower["intermediate_size"])
        for k in out:
            out[k] += tower["num_hidden_layers"] * layer[k]
    p = v["patch_size"]
    patches = (canvas[0] // p) * (canvas[1] // p)
    out["patch"] = 2.0 * batch * patches * (v["num_channels"] * p * p) * v["hidden_size"]
    return out


TRAIN_FACTOR = 3.0  # forward + the backward's two products per product


def train_step_flops(cfg: dict, batch: int, seq: int, canvas: Tuple[int, int]) -> float:
    return TRAIN_FACTOR * sum(forward_products(cfg, batch, seq, canvas).values())
