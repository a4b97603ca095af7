"""Optimizer and LR schedule of the reference's training recipe (port of
``vault_tpu/training/optimizer.py``).

Reference: HF ``AdamW`` with a ``correct_bias`` switch (default False,
vault/tmsc_utils/trainer.py:69, 244-253) and
``get_linear_schedule_with_warmup`` (:262-280).  HF AdamW differs from
``torch.optim.AdamW`` in two ways kept here exactly, as in the JAX package:

  * bias correction is optional (``step_size *= sqrt(1-b2^t)/(1-b1^t)``
    only when ``correct_bias``);
  * decoupled weight decay uses the *scheduled* lr, not the bias-corrected
    step size, and applies to every parameter (one parameter group).

The lr at optimizer step t (counted from 1) is ``schedule(t - 1)``: HF steps
the scheduler after the update.

Unlike the JAX package's functional optax transformation, :meth:`HfAdamW.
step_` updates the fp32 master parameters and the moments **in place**: the
port keeps one copy of each instead of returning new trees.  The moments
may be stored in bf16 (``state_dtype=torch.bfloat16``): the moment math runs
in fp32, the new moments are rounded once to the stored type, and the
update reads the *rounded* stored moments, as the JAX package does.  The
blockwise int8 moments (``state_dtype="int8"``) are not ported yet: they
raise.
"""

from __future__ import annotations

from typing import Callable, Dict, Mapping, NamedTuple, Optional

import numpy as np
import torch


def linear_warmup_linear_decay(base_lr: float, warmup_steps: int,
                               total_steps: int) -> Callable[[int], float]:
    """HF get_linear_schedule_with_warmup: linear 0->lr over warmup, then
    linear lr->0 over the remainder.  Computed in float32, as the JAX
    package computes it."""
    f32 = np.float32

    def schedule(step) -> float:
        step = f32(step)
        if step < warmup_steps:
            return float(f32(base_lr) * (step / f32(max(warmup_steps, 1))))
        decay = max(f32(0.0), (f32(total_steps) - step)
                    / f32(max(total_steps - warmup_steps, 1)))
        return float(f32(base_lr) * f32(decay))

    return schedule


class AdamWState(NamedTuple):
    """count: optimizer steps taken; mu, nu: first and second moments keyed
    like the parameters."""
    count: int
    mu: Dict[str, torch.Tensor]
    nu: Dict[str, torch.Tensor]


def _state_dtype(state_dtype) -> Optional[torch.dtype]:
    if state_dtype is None or isinstance(state_dtype, torch.dtype):
        return state_dtype
    if str(state_dtype) == "int8":
        raise NotImplementedError(
            "state_dtype='int8': the blockwise int8 moments are not ported "
            "yet; use 'float32' or 'bfloat16'")
    return getattr(torch, str(state_dtype))


class HfAdamW:
    """HF AdamW over a dict of parameters (see the module docstring).

    ``learning_rate``: a float or a schedule ``step -> lr``.
    ``state_dtype``: None (the parameters' dtype, exact HF semantics),
    ``torch.float32``, ``torch.bfloat16``, or their names."""

    def __init__(self, learning_rate, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8, weight_decay: float = 0.0,
                 correct_bias: bool = False, state_dtype=None):
        self.learning_rate = learning_rate
        self.b1, self.b2, self.eps = b1, b2, eps
        self.weight_decay = weight_decay
        self.correct_bias = correct_bias
        self.state_dtype = _state_dtype(state_dtype)

    def lr_at(self, step: int) -> float:
        lr = self.learning_rate
        return float(lr(step)) if callable(lr) else float(lr)

    def init(self, params: Mapping[str, torch.Tensor]) -> AdamWState:
        def zeros(p):
            return torch.zeros_like(p, dtype=self.state_dtype or p.dtype)

        return AdamWState(0, {k: zeros(p) for k, p in params.items()},
                          {k: zeros(p) for k, p in params.items()})

    def step_sizes(self, count: int):
        """(scheduled lr, step size) at optimizer step ``count`` (from 1),
        in float32 as the JAX package computes them."""
        lr = np.float32(self.lr_at(count - 1))
        if not self.correct_bias:
            return float(lr), float(lr)
        c = np.float32(count)
        b1, b2 = np.float32(self.b1), np.float32(self.b2)
        corr = np.sqrt(np.float32(1) - b2 ** c) / (np.float32(1) - b1 ** c)
        return float(lr), float(lr * corr)

    @torch.no_grad()
    def step_(self, params: Mapping[str, torch.Tensor],
              grads: Mapping[str, torch.Tensor],
              state: AdamWState) -> AdamWState:
        """One update, in place on ``params`` and the moments in
        ``state``; returns the state with the count advanced."""
        count = state.count + 1
        lr, step_size = self.step_sizes(count)
        decay = float(np.float32(lr) * np.float32(self.weight_decay))
        b1, b2 = self.b1, self.b2
        # the JAX package's operation order, each op in fp32
        for k, p in params.items():
            g = grads[k].float()
            m, v = state.mu[k], state.nu[k]
            m.copy_(b1 * m.float() + (1 - b1) * g)
            v.copy_(b2 * v.float() + (1 - b2) * (g * g))
            # the update reads the stored (possibly rounded) moments
            upd = (-step_size * m.float()) / (torch.sqrt(v.float()) + self.eps)
            if self.weight_decay > 0.0:
                upd = upd - decay * p.float()
            p.add_(upd.to(p.dtype))
        return AdamWState(count, state.mu, state.nu)


hf_adamw = HfAdamW  # the JAX package's name and signature


def make_optimizer(lr: float, num_steps: int, warmup_ratio: float = 0.1,
                   b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                   weight_decay: float = 0.0, correct_bias: bool = False,
                   state_dtype=None):
    """The reference recipe: warmup over ``warmup_ratio`` of the steps, then
    linear decay (vault/tmsc_utils/trainer.py:262-280).  Returns
    (optimizer, schedule)."""
    warmup = int(warmup_ratio * num_steps)
    schedule = linear_warmup_linear_decay(lr, warmup, num_steps)
    return hf_adamw(schedule, b1, b2, eps, weight_decay, correct_bias,
                    state_dtype=state_dtype), schedule
