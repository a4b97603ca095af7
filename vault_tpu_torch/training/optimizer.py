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
update reads the *rounded* stored moments, as the JAX package does.

On the card, fp32 and bf16 moments are updated by one launch of the
hand-written multi-tensor kernel ``csrc/adamw.cu`` per dtype group
(``ops/cuda_adamw.py``, in a ``vault.adamw.fused`` span), bit-equal to the
per-leaf loop (:meth:`HfAdamW._leaf_step`), which stays the plain version
and the CPU's path (``step_(..., plain=True)`` runs it on the card too);
a leaf on the card that the kernel does not take raises ``ValueError``.
``fused_leaves`` and ``loop_leaves`` count the leaves each route updated
in the last step.

``state_dtype="int8"`` stores each moment as blockwise int8 codes
(:class:`Q8Moment`: one fp32 absmax scale per 256 values, the second
moment as sqrt(v)), the JAX package's 8-bit moments.  The blocks run over
the JAX package's leaves: the ``layers.<i>`` parameters of one stacked leaf
(``convert.stacked_leaf``) share one code sequence over their values in
layer order, padded once at its end, so the codes, the scales and the
checkpoints are the JAX package's.  Unlike the bf16 path, the int8 update
reads the *unrounded* fp32 moments of the step, as the JAX package's
``update_q8`` does.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Mapping, NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from vault_tpu_torch.ops import cuda_adamw
from vault_tpu_torch.utils.profiling import span


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
    like the parameters, or with int8 moments :class:`Q8Moment`s keyed by
    the JAX package's leaf (:func:`q8_groups`)."""
    count: int
    mu: Dict[str, torch.Tensor]
    nu: Dict[str, torch.Tensor]


# ---------------------------------------------------------------------------
# Blockwise int8 moments (the JAX package's ``Q8Moment``, ``_q8_encode`` and
# ``_q8_decode``): int8 codes and one fp32 absmax/127 scale per block of
# INT8_BLOCK values; the moment math runs in fp32 and is encoded once a step.
# ---------------------------------------------------------------------------

INT8_BLOCK = 256


class Q8Moment(NamedTuple):
    q: torch.Tensor      # int8 (nb, INT8_BLOCK)
    scale: torch.Tensor  # fp32 (nb, 1) per-block absmax / 127


def _q8_encode(x: torch.Tensor) -> Q8Moment:
    """Codes of ``x`` flattened and zero-padded to whole blocks: scale
    ``max(absmax / 127, 1e-12)``, code ``round(x / scale)`` (half to even)
    clipped to +-127."""
    flat = x.float().reshape(-1)
    nb = -(-flat.numel() // INT8_BLOCK)
    blocks = F.pad(flat, (0, nb * INT8_BLOCK - flat.numel())).view(nb, INT8_BLOCK)
    # divided by a tensor: on the card PyTorch turns a division by a Python
    # number into a product with its reciprocal, which rounds otherwise
    absmax = blocks.abs().amax(1, keepdim=True)
    scale = torch.clamp_min(absmax / absmax.new_full((), 127.0), 1e-12)
    q = torch.clamp(torch.round(blocks / scale), -127, 127).to(torch.int8)
    return Q8Moment(q, scale)


def _q8_decode(m: Q8Moment, size: int) -> torch.Tensor:
    """The first ``size`` values of ``m``, flat fp32."""
    return (m.q.float() * m.scale).reshape(-1)[:size]


def _sqrt(x: torch.Tensor) -> torch.Tensor:
    """fp32 square root, correctly rounded as XLA's and the card's are.
    PyTorch's vectorized CPU kernel is not (an ulp off in about 0.6% of
    values, AVX-512 builds), which moves a block's scale; through float64,
    rounded once to float32, it is exact."""
    return torch.sqrt(x.double()).float() if x.device.type == "cpu" else torch.sqrt(x)


def q8_groups(keys) -> Dict[str, List[str]]:
    """The JAX package's leaves over the port's parameter keys: a stacked
    leaf (``convert.stacked_leaf``) maps to its ``layers.<i>`` keys in layer
    order, any other leaf to its own key."""
    from vault_tpu_torch.convert import stacked_leaf  # convert imports this module

    groups: Dict[str, Dict[int, str]] = {}
    for k in keys:
        leaf, i = stacked_leaf(k) or (k, 0)
        groups.setdefault(leaf, {})[i] = k
    return {leaf: [members[i] for i in sorted(members)]
            for leaf, members in groups.items()}


def _state_dtype(state_dtype):
    """A torch dtype, None, or "int8"."""
    if state_dtype is None or isinstance(state_dtype, torch.dtype):
        return "int8" if state_dtype == torch.int8 else state_dtype
    if str(state_dtype) == "int8":
        return "int8"
    return getattr(torch, str(state_dtype))


class HfAdamW:
    """HF AdamW over a dict of parameters (see the module docstring).

    ``learning_rate``: a float or a schedule ``step -> lr``.
    ``state_dtype``: None (the parameters' dtype, exact HF semantics),
    ``torch.float32``, ``torch.bfloat16``, their names, or "int8" (the
    blockwise moments)."""

    def __init__(self, learning_rate, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8, weight_decay: float = 0.0,
                 correct_bias: bool = False, state_dtype=None):
        self.learning_rate = learning_rate
        self.b1, self.b2, self.eps = b1, b2, eps
        self.weight_decay = weight_decay
        self.correct_bias = correct_bias
        self.state_dtype = _state_dtype(state_dtype)
        self._fused = cuda_adamw.FusedAdamW()
        # the leaves each route updated in the last step
        self.fused_leaves = self.loop_leaves = 0

    def lr_at(self, step: int) -> float:
        lr = self.learning_rate
        return float(lr(step)) if callable(lr) else float(lr)

    @property
    def int8(self) -> bool:
        return self.state_dtype == "int8"

    def init(self, params: Mapping[str, torch.Tensor]) -> AdamWState:
        if self.int8:
            def fresh(keys):
                n = sum(params[k].numel() for k in keys)
                return _q8_encode(torch.zeros(n, device=params[keys[0]].device))

            groups = q8_groups(params)
            return AdamWState(0, {g: fresh(ks) for g, ks in groups.items()},
                              {g: fresh(ks) for g, ks in groups.items()})

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
              state: AdamWState, plain: bool = False) -> AdamWState:
        """One update, in place on ``params`` and the moments in
        ``state``; returns the state with the count advanced.  ``plain``:
        every leaf on the per-leaf loop, the kernel's plain version (for
        comparisons on the card)."""
        count = state.count + 1
        lr, step_size = self.step_sizes(count)
        decay = float(np.float32(lr) * np.float32(self.weight_decay))
        if self.int8:
            for leaf, keys in q8_groups(params).items():
                self._step_q8([params[k] for k in keys], [grads[k] for k in keys],
                              state.mu[leaf], state.nu[leaf], step_size, decay)
            self.fused_leaves, self.loop_leaves = 0, len(params)
            return AdamWState(count, state.mu, state.nu)
        groups, loop = (({}, list(params)) if plain
                        else cuda_adamw.split(params, grads, state.mu, state.nu))
        if groups:
            b1, b2 = self.b1, self.b2
            with span("vault.adamw.fused"):
                self._fused.step_(groups, cuda_adamw.Hyper(
                    b1, 1 - b1, b2, 1 - b2, -step_size, self.eps, decay,
                    self.weight_decay > 0.0))
        for k in loop:
            self._leaf_step(params[k], grads[k], state.mu[k], state.nu[k],
                            step_size, decay)
        self.fused_leaves = sum(len(group.rows) for group in groups.values())
        self.loop_leaves = len(loop)
        return AdamWState(count, state.mu, state.nu)

    def _leaf_step(self, p, g, m, v, step_size: float, decay: float):
        """One leaf's update, in place: the plain version of
        ``csrc/adamw.cu``, in the JAX package's operation order, each op in
        fp32."""
        b1, b2 = self.b1, self.b2
        g = g.float()
        m.copy_(b1 * m.float() + (1 - b1) * g)
        v.copy_(b2 * v.float() + (1 - b2) * (g * g))
        # the update reads the stored (possibly rounded) moments
        upd = (-step_size * m.float()) / (torch.sqrt(v.float()) + self.eps)
        if self.weight_decay > 0.0:
            upd = upd - decay * p.float()
        p.add_(upd.to(p.dtype))

    def _step_q8(self, ps, gs, mu: Q8Moment, nu: Q8Moment, step_size: float,
                 decay: float):
        """One JAX leaf's int8 step (``update_q8``): ``ps`` its parameters
        in layer order, decoded and encoded as one flat sequence."""
        b1, b2 = self.b1, self.b2
        cat = lambda ts: torch.cat([t.float().reshape(-1) for t in ts])
        g32 = cat(gs)
        n = g32.numel()
        m32 = b1 * _q8_decode(mu, n) + (1 - b1) * g32
        s = _q8_decode(nu, n)  # the stored sqrt(v)
        v32 = b2 * s * s + (1 - b2) * g32 * g32
        root = _sqrt(v32)
        for dst, src in ((mu, _q8_encode(m32)), (nu, _q8_encode(root))):
            dst.q.copy_(src.q)
            dst.scale.copy_(src.scale)
        # the update reads the unrounded fp32 moments
        upd = (-step_size * m32) / (root + self.eps)
        if self.weight_decay > 0.0:
            upd = upd - decay * cat(ps)
        off = 0
        for p in ps:
            p.add_(upd[off:off + p.numel()].view(p.shape).to(p.dtype))
            off += p.numel()


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
