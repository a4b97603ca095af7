"""Masked-LM objective utilities (port of ``vault_tpu/training/mlm.py``).

The reference exposes ``VaultForMaskedLM`` (vault/models/vault/model.py:
467-468) but ships no MLM trainer; the JAX package completes the path with
standard BERT-style dynamic masking (15% of non-special tokens; 80% [MASK] /
10% random / 10% unchanged) and a CE-over-masked-positions loss, and so does
this module.  The masks are drawn from an explicit ``torch.Generator``, so
they follow the same rules as the JAX package's but not its stream.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

IGNORE = -100


def mask_tokens(generator: torch.Generator, input_ids: torch.Tensor,
                special_mask: torch.Tensor, mask_token_id: int,
                vocab_size: int, mlm_prob: float = 0.15
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (masked_input_ids, labels); labels are IGNORE except at masked
    positions, where they hold the original id.  The three draws (selection,
    kind, random ids) come from ``generator``, on its device."""
    dev = generator.device
    shape = tuple(input_ids.shape)
    ids = input_ids.to(dev)
    selectable = special_mask.to(dev) == 0
    sel = (torch.rand(shape, generator=generator, device=dev) < mlm_prob) & selectable
    labels = torch.where(sel, ids, torch.full_like(ids, IGNORE))
    kind = torch.rand(shape, generator=generator, device=dev)
    rand_ids = torch.randint(0, vocab_size, shape, generator=generator, device=dev,
                             dtype=ids.dtype)
    masked = torch.where(sel & (kind < 0.8), torch.full_like(ids, mask_token_id), ids)
    masked = torch.where(sel & (kind >= 0.8) & (kind < 0.9), rand_ids, masked)
    return masked, labels


def mlm_loss(logits: torch.Tensor, labels: torch.Tensor,
             weight: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean CE over labeled (non-IGNORE) positions, in fp32."""
    valid = labels != IGNORE
    safe_labels = torch.where(valid, labels, torch.zeros_like(labels)).long()
    logp = F.log_softmax(logits.float(), dim=-1)
    per = -torch.gather(logp, -1, safe_labels[..., None])[..., 0]
    w = valid.float()
    if weight is not None:
        w = w * weight.float()[:, None]
    return (per * w).sum() / torch.clamp(w.sum(), min=1.0)


def mlm_accuracy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    valid = labels != IGNORE
    correct = (logits.argmax(-1) == labels) & valid
    return correct.sum() / torch.clamp(valid.sum(), min=1)
