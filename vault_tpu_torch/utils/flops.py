"""The products a VAuLT forward and training step compute, counted as
2·M·N·K from the configuration and the input's geometry, without running
the model (the MFU accounting of the JAX package's ``bench.py``,
``docs/BENCHMARKS.md`` "MFU accounting").

Counted: every encoder layer of the text tower (BERT) and of ViLT (the
Q/K/V, attention-output and two MLP products, and the attention's two
products per head, q·kᵀ and p·v), and the patch projection over every
patch of the canvas.  Not counted: the pooler, the head, the embeddings'
lookups and adds, LayerNorm, softmax and every other elementwise step,
and ToMe's matching products.  Merged ViLT layers (``merge_to``) are
counted at their merged length.

At ``vault_base("bert-base-uncased")``, batch 16, 40 tokens and a
384 × 608 canvas: BERT 12 × 9.14 GF, ViLT (L = 40 + 1 + 215 = 256)
12 × 61.2 GF, the projection over 228 patches 17.2 GF: 861 GF.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union


def encoder_layer_flops(batch: int, length: int, hidden: int, intermediate: int) -> float:
    """One encoder layer: Q/K/V (H × 3H), attention output (H × H), the MLP
    (H × I, I × H), and q·kᵀ and p·v over every head (2 · L² · H a row of
    the batch, each)."""
    rows = batch * length
    dense = 2.0 * rows * hidden * (3 * hidden + hidden + 2 * intermediate)
    attention = 4.0 * batch * length * length * hidden
    return dense + attention


def vilt_length(cfg, seq: int, canvas: Tuple[int, int]) -> int:
    """ViLT's joint length: the text tokens, the image CLS and the patch
    tokens, ``min(num_patch_tokens, patches on the canvas)``
    (``models/vilt.py`` ``visual_embed``)."""
    vilt = cfg.resolved_vilt()
    patches = (canvas[0] // vilt.patch_size) * (canvas[1] // vilt.patch_size)
    return seq + 1 + min(vilt.num_patch_tokens, patches)


def vault_forward_flops(cfg, batch: int, seq: int, canvas: Tuple[int, int],
                        merge_to: Optional[int] = None, merge_at_layer: int = 0) -> float:
    """Products of one forward of ``cfg`` (a ``VaultConfig``) on ``batch``
    pairs of ``seq`` tokens and a ``canvas`` (H, W) image, in FLOPs."""
    vilt = cfg.resolved_vilt()
    total = 0.0
    tower = cfg.text_tower
    if tower is not None:
        total += tower.num_hidden_layers * encoder_layer_flops(
            batch, seq, tower.hidden_size, tower.intermediate_size)
    length = vilt_length(cfg, seq, canvas)
    patch_tokens = length - seq - 1
    merged = seq + 1 + merge_to if merge_to is not None and merge_to < patch_tokens else length
    for layer in range(vilt.num_hidden_layers):
        l = merged if layer >= merge_at_layer else length
        total += encoder_layer_flops(batch, l, vilt.hidden_size, vilt.intermediate_size)
    p = vilt.patch_size
    patches = (canvas[0] // p) * (canvas[1] // p)
    total += 2.0 * batch * patches * (vilt.num_channels * p * p) * vilt.hidden_size
    return total


def train_step_flops(cfg, batch: int, seq: int, canvas: Tuple[int, int],
                     remat: Union[bool, str] = True, merge_to: Optional[int] = None,
                     merge_at_layer: int = 0) -> float:
    """Products of one training step: the forward and the backward's two
    products for each of its products, 3× the forward; under
    ``remat=True`` the backward recomputes the forward, 4×.  ``"dots"``
    keeps the products and recomputes the rest: 3×."""
    factor = 4.0 if remat is True else 3.0
    return factor * vault_forward_flops(cfg, batch, seq, canvas, merge_to, merge_at_layer)
