"""The plain reference of the ``vault_bert`` family: the VAuLT classifier's
forward and first training steps of ``portbench/reference/``, in fp32 with
TF32 off, on the run's weights made again from its seed."""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from portbench.check import full_fp32, reference_weights
from portbench.generate import make_batch
from portbench.reference.train_ref import optimizer_settings, train_steps
from portbench.reference.vault_ref import classifier_logits


def score_reference(cfg: dict, traffic: dict, seed: int, indices, device,
                    prec=None) -> Dict[int, np.ndarray]:
    """The reference's logits of the run's batches ``indices``."""
    with torch.no_grad(), full_fp32():
        p = reference_weights(cfg, seed, getattr(torch, cfg["dtype"]), device)
        out = {}
        for i in indices:
            inputs, _ = make_batch(traffic, cfg, seed, i, device)
            out[i] = classifier_logits(p, cfg, inputs, prec=prec).cpu().numpy()
    return out


def train_reference(cfg: dict, traffic: dict, seed: int, device, prec=None,
                    ste: bool = False, rows=None) -> dict:
    """The reference's first ``checked_steps`` training steps of the run."""
    with full_fp32():
        p = reference_weights(cfg, seed, torch.float32, device)
        made = [make_batch(traffic, cfg, seed, i, device)
                for i in range(traffic["checked_steps"])]
        return train_steps(p, cfg, [b for b, _ in made], [y for _, y in made], seed,
                           optimizer_settings(traffic), prec=prec, ste=ste, rows=rows)
