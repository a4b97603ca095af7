"""Attention-mask math (port of ``vault_tpu/ops/masks.py``).

HF's ``get_extended_attention_mask`` fills dropped keys with
``finfo(dtype).min``; the JAX package does the same, and so does this port.
The fill is finite on purpose: a key tile made only of masked keys then
gives ``exp(min - min) = 1`` and not ``exp(-inf + inf) = NaN``.
"""

from __future__ import annotations

import torch


def extend_attention_mask(mask: torch.Tensor, dtype=torch.float32,
                          fill=None) -> torch.Tensor:
    """(B, L) {0,1} -> (B, 1, 1, L) additive bias (0 keep / fill drop)."""
    if fill is None:
        fill = torch.finfo(dtype).min
    mask = mask.to(dtype)
    return ((1.0 - mask) * fill)[:, None, None, :]
