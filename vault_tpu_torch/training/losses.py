"""Loss functions of the task trainers (port of
``vault_tpu/training/losses.py``).

References:
  * CE default: vault/tmsc_utils/trainer.py:228-242
  * Bloomberg BCE-with-logits: vault/models/vault/trainer.py:39-90
  * MVSA dual-head (two 3-way CE averaged): vault/models/vault/trainer.py:93-203
  * VQA BCE * num_labels: vault/models/vault/trainer.py:211-283

All take an optional per-sample ``weight`` (1 real / 0 pad) so padded rows
contribute nothing.  Losses are computed in fp32 whatever the logits' dtype.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def _wmean(per_sample: torch.Tensor, weight: Optional[torch.Tensor]) -> torch.Tensor:
    if weight is None:
        return per_sample.mean()
    w = weight.to(per_sample.dtype)
    return (per_sample * w).sum() / torch.clamp(w.sum(), min=1.0)


def softmax_cross_entropy(logits, labels, weight=None):
    """torch nn.CrossEntropyLoss(mean) equivalent; labels are int classes."""
    logp = F.log_softmax(logits.float(), dim=-1)
    per = -torch.gather(logp, -1, labels.long()[..., None])[..., 0]
    return _wmean(per, weight)


def _bce_elems(logits, targets):
    logits = logits.float()
    t = targets.float()
    return torch.clamp(logits, min=0) - logits * t + torch.log1p(torch.exp(-logits.abs()))


def bce_with_logits(logits, labels, weight=None):
    """torch nn.BCEWithLogitsLoss(mean over elements) equivalent."""
    per_elem = _bce_elems(logits, labels)
    per = per_elem.reshape(per_elem.shape[0], -1).mean(dim=-1)
    return _wmean(per, weight)


def dual_softmax_cross_entropy(logits, labels, weight=None):
    """MVSA un-preprocessed mode: logits (B, 6) split into two 3-way groups
    for (text, image) sentiment; labels (B, 2); losses averaged."""
    n = logits.shape[-1] // 2
    l_text = softmax_cross_entropy(logits[:, :n], labels[:, 0], weight)
    l_img = softmax_cross_entropy(logits[:, n:], labels[:, 1], weight)
    return 0.5 * (l_text + l_img)


def vqa_bce(logits, target_scores, weight=None):
    """ViLT's VQA objective: BCEWithLogits * num_labels over soft answer
    scores."""
    per = _bce_elems(logits, target_scores).mean(dim=-1) * logits.shape[-1]
    return _wmean(per, weight)
