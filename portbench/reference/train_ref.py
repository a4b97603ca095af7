"""Plain PyTorch reference of the first training steps of the VAuLT
classifier: fp32 forward and backward (:mod:`.vault_ref`), mean softmax
cross-entropy, and HF AdamW (``transformers.AdamW``: bias correction off
by default, decoupled weight decay at the scheduled rate) under
``get_linear_schedule_with_warmup``, the optimizer step ``t`` (from 1) at
the schedule's value for ``t - 1``, with fp32 moments.

The steps draw their dropout as the program's trainer does: step ``s``
from a generator on the device seeded with the first 64-bit word of
``numpy.random.SeedSequence([seed, s])``, shifted right by one.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from portbench.reference.vault_ref import Draws, classifier_logits


def step_seed(seed: int, step: int) -> int:
    """The dropout seed of training step ``step`` of a run seeded ``seed``."""
    state = np.random.SeedSequence([int(seed), int(step)]).generate_state(1, np.uint64)
    return int(state[0] >> np.uint64(1))


def linear_schedule(base_lr: float, warmup: int, total: int):
    """Linear warmup from 0 to ``base_lr`` over ``warmup`` steps, then linear
    decay to 0 at ``total``."""

    def lr(step: int) -> float:
        if step < warmup:
            return base_lr * step / max(warmup, 1)
        return base_lr * max(0.0, (total - step) / max(total - warmup, 1))

    return lr


def optimizer_settings(traffic: dict) -> dict:
    """The optimizer's settings as a training traffic file states them:
    HF AdamW without bias correction, the schedule over
    ``steps_per_epoch * num_train_epochs`` steps."""
    a = traffic["train_args"]
    if a["correct_bias"]:
        raise ValueError("the reference's AdamW has no bias correction")
    total = traffic["steps_per_epoch"] * int(a["num_train_epochs"])
    return {"lr": a["lr"], "betas": (a["adam_beta1"], a["adam_beta2"]),
            "eps": a["adam_epsilon"], "weight_decay": a["weight_decay"],
            "warmup": int(a["warmup_ratio"] * total), "total": total}


def _norm(t: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(t.detach().double()))


def train_steps(params: Dict[str, torch.Tensor], cfg, batches: List[dict],
                labels: List[torch.Tensor], seed: int, optim: dict,
                prec: Optional[str] = None, ste: bool = False,
                rows: Optional[int] = None) -> dict:
    """Run ``len(batches)`` steps from ``params`` (fp32, not modified).

    ``optim``: lr, betas, eps, weight_decay, warmup and total steps.
    ``rows``: take the loss's mean over the first ``rows`` rows of each
    batch only (a fault: part of the batch left out).  Returns the loss of
    each step, each leaf's gradient at the first step and its norm, and
    each leaf's change after the last."""
    p = {k: v.detach().clone().requires_grad_(True) for k, v in params.items()}
    m = {k: torch.zeros_like(v) for k, v in p.items()}
    v2 = {k: torch.zeros_like(v) for k, v in p.items()}
    b1, b2 = optim["betas"]
    sched = linear_schedule(optim["lr"], optim["warmup"], optim["total"])
    losses, g1, first = [], {}, {}
    for s, (batch, y) in enumerate(zip(batches, labels)):
        gen = torch.Generator(device=y.device).manual_seed(step_seed(seed, s))
        logits = classifier_logits(p, cfg, batch, prec=prec, ste=ste, drop=Draws(gen))
        per = F.cross_entropy(logits, y, reduction="none")
        loss = per.mean() if rows is None else per[:rows].mean()
        grads = torch.autograd.grad(loss, list(p.values()), allow_unused=True)
        losses.append(float(loss.detach()))
        lr = sched(s)
        with torch.no_grad():
            for (k, w), g in zip(p.items(), grads):
                g = torch.zeros_like(w) if g is None else g
                if s == 0:
                    g1[k] = _norm(g)
                    first[k] = g.detach().clone()
                m[k].mul_(b1).add_((1 - b1) * g)
                v2[k].mul_(b2).add_((1 - b2) * g * g)
                upd = -lr * m[k] / (torch.sqrt(v2[k]) + optim["eps"])
                if optim["weight_decay"]:
                    upd = upd - lr * optim["weight_decay"] * w
                w.add_(upd)
    delta = {k: _norm(w - params[k]) for k, w in p.items()}
    return {"losses": losses, "grad_norms": g1, "grads": first, "delta_norms": delta}
