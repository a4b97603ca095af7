"""Explicit-collective data-parallel train step (port of
``vault_tpu/parallel/shard_map_step.py``).

The trainer sums its gradients over the "data" group inside
``Trainer.loss_and_grads``; this module is the manual counterpart, written
out in one function: each rank computes the weighted loss *sum* of its
rows, all-reduces the loss, the weight and every gradient explicitly,
divides by the global weight, and applies the same replicated update.

Dropout differs from the trainer's on purpose: each rank draws from its own
generator, seeded from the step's seed and the rank's "data" index (the JAX
package's ``fold_in(rng, axis_index("data"))``), so the masks depend on the
split, as they do there.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from vault_tpu_torch.convert import param_tree
from vault_tpu_torch.parallel.mesh import Mesh, all_reduce_bucket


def shard_generator(seed: int, mesh: Mesh, device) -> torch.Generator:
    """The generator of one step on this rank: a pure function of (seed,
    data index)."""
    state = np.random.SeedSequence([int(seed), int(mesh.data_index)]).generate_state(
        1, np.uint64)[0]
    return torch.Generator(device=device).manual_seed(int(state >> 1))


def make_shard_map_train_step(apply_fn: Callable, loss_per_example_fn: Callable,
                              tx, mesh: Mesh) -> Callable:
    """Returns ``step(params, opt_state, batch, labels, weight, seed=None)
    -> (params, opt_state, loss)``.

    ``apply_fn(params_tree, batch, deterministic, generator) -> logits``;
    ``loss_per_example_fn(logits, labels) -> (B_local,)``.  ``params`` is a
    state dict of tensors (the trainable ones require grad), the same on
    every rank, and is updated in place by ``tx`` (``training/optimizer.py``
    ``HfAdamW``); ``batch``/``labels``/``weight`` are this rank's rows.
    ``seed`` None runs the forward deterministically."""

    def step(params, opt_state, batch, labels, weight, seed: Optional[int] = None):
        trainable = {k: v for k, v in params.items() if v.requires_grad}
        device = next(iter(trainable.values())).device
        generator = None if seed is None else shard_generator(seed, mesh, device)
        logits = apply_fn(param_tree(params), batch, seed is None, generator)
        per = loss_per_example_fn(logits, labels)
        # the local weighted SUM; the normalization is by the global weight
        loss_sum = (per * weight.to(per.dtype)).sum()
        grads = torch.autograd.grad(loss_sum, list(trainable.values()),
                                    allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(trainable.values(), grads)]
        *grads, loss_sum, n = all_reduce_bucket(
            grads + [loss_sum.detach(), weight.float().sum()], mesh.data_group)
        global_n = torch.clamp(n, min=1.0)
        grads = {k: (g / global_n).to(p.dtype)
                 for (k, p), g in zip(trainable.items(), grads)}
        opt_state = tx.step_(trainable, grads, opt_state)
        return params, opt_state, loss_sum / global_n

    return step
