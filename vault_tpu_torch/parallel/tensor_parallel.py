"""Megatron tensor parallelism: the operators the model layers run on
their column and row shards, with the reduction passed in.

The JAX package gets its tensor parallelism from GSPMD: the parameters are
sharded by ``parallel/sharding.py``'s rules and XLA inserts the
collectives.  Here the layers of ``models/bert.py``, ``models/vilt.py`` and
``models/llama.py`` run one body of Megatron code when a :class:`TPGroup`
is active (:func:`use_tp`):

  * a column-parallel product (Q/K/V, ``mlp_in``, ``gate``, ``up``) runs on
    the local output columns; its input passes :meth:`TPGroup.enter`, the
    identity whose backward all-reduces the gradient (Megatron's conjugate
    operator), so the replicated leaves before it (LayerNorms, embeddings)
    get the whole gradient;
  * a row-parallel product (``attn_out``, ``mlp_out``, ``o``, ``down``)
    runs on the local input rows and its partial products are summed by
    :meth:`TPGroup.reduce` *before* the bias, the residual and the LN
    (:func:`row_linear`); a w8a8 row product quantizes its input with the
    absmax of the whole row (a max over the shards) and sums the int32
    partials, so its codes and sums are the unsharded product's.

Two reductions: :class:`ProcessTP`, an all-reduce over the mesh's "model"
group (the trainer, one process per rank), and :class:`ThreadTP`, a sum
over the shards of one process's device list, one thread per shard
(serving).
"""

from __future__ import annotations

import contextlib
import threading
from typing import List, Optional

import torch
import torch.distributed as dist

from vault_tpu_torch.ops.nn import int8_matmul, matmul_fp32


class TPGroup:
    """What a layer needs of its shard group: ``size``, this shard's
    ``index``, and the three reductions."""

    size: int = 1
    index: int = 0

    def enter(self, x: torch.Tensor) -> torch.Tensor:
        return x

    def reduce(self, x: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def reduce_max(self, x: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError


# ---------------------------------------------------------------------------
# Over a process group
# ---------------------------------------------------------------------------

def _all_reduce(x: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    from vault_tpu_torch.parallel.mesh import all_reduce_

    return all_reduce_(x.clone(memory_format=torch.contiguous_format), group, op)


class _Enter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class ProcessTP(TPGroup):
    """The shards are the ranks of ``group`` (the mesh's "model" group)."""

    def __init__(self, group):
        self.group = group
        self.size = dist.get_world_size(group)
        self.index = dist.get_rank(group)

    def enter(self, x):
        return _Enter.apply(x, self.group) if torch.is_grad_enabled() else x

    def reduce(self, x):
        if torch.is_grad_enabled() and x.requires_grad:
            return _Reduce.apply(x, self.group)
        return _all_reduce(x.detach() if x.requires_grad else x, self.group)

    def reduce_max(self, x):
        return _all_reduce(x.detach(), self.group, dist.ReduceOp.MAX)


# ---------------------------------------------------------------------------
# Over one process's devices
# ---------------------------------------------------------------------------

class ThreadTP(TPGroup):
    """Shard ``index`` of ``size`` shards that run in threads of one process
    (serving, no gradients).  A reduction hands in this shard's tensor,
    waits for the others, and sums all of them on its own device in shard
    order, so every shard holds the same result."""

    def __init__(self, index: int, shared: "ThreadTPShared"):
        self.index, self.size, self.shared = index, shared.size, shared

    def _gather(self, x) -> List[torch.Tensor]:
        s = self.shared
        s.slots[self.index] = x
        s.barrier.wait()
        parts = [p.to(x.device) for p in s.slots]
        s.barrier.wait()
        return parts

    def reduce(self, x):
        parts = self._gather(x)
        out = parts[0]
        for p in parts[1:]:
            out = out + p
        return out

    def reduce_max(self, x):
        parts = self._gather(x)
        out = parts[0]
        for p in parts[1:]:
            out = torch.maximum(out, p)
        return out


class ThreadTPShared:
    def __init__(self, size: int, timeout: Optional[float] = 600.0):
        self.size = size
        self.slots: List[Optional[torch.Tensor]] = [None] * size
        self.barrier = threading.Barrier(size, timeout=timeout)


# ---------------------------------------------------------------------------
# The active group
# ---------------------------------------------------------------------------

_ACTIVE = {"tp": None}
_LOCAL = threading.local()


def current_tp() -> Optional[TPGroup]:
    """The group set for this thread (:func:`thread_tp`), else the one set
    for the process (:func:`use_tp`), else None."""
    tp = getattr(_LOCAL, "tp", None)
    return tp if tp is not None else _ACTIVE["tp"]


@contextlib.contextmanager
def use_tp(tp: Optional[TPGroup]):
    """Make ``tp`` the process's group for the block.  Module-level, so the
    backward's recompute under ``remat`` (which may run on another thread)
    takes the same path."""
    saved = _ACTIVE["tp"]
    _ACTIVE["tp"] = tp
    try:
        yield tp
    finally:
        _ACTIVE["tp"] = saved


@contextlib.contextmanager
def thread_tp(tp: Optional[TPGroup]):
    saved = getattr(_LOCAL, "tp", None)
    _LOCAL.tp = tp
    try:
        yield tp
    finally:
        _LOCAL.tp = saved


def local_heads(heads: int, tp: TPGroup) -> int:
    if heads % tp.size:
        raise ValueError(f"{heads} heads do not split over {tp.size} shards")
    return heads // tp.size


def row_linear(params, x: torch.Tensor, tp: TPGroup) -> torch.Tensor:
    """A row-parallel dense layer: the local rows' partial product, summed
    over the shards, then the bias (replicated), in :func:`~vault_tpu_torch.
    ops.nn.linear`'s numerics for each weight form."""
    b = params.get("b")
    if "w_q8" in params:
        from vault_tpu_torch.ops.quantize import _codes, _scale

        xf = x.float()
        scale = _scale(tp.reduce_max(xf.abs().amax(dim=-1, keepdim=True)))
        acc = tp.reduce(int8_matmul(_codes(xf.detach(), scale), params["w_q8"]))
        y = acc.float() * (scale * params["w_scale"])
        if b is not None:
            y = y + b
        return y.to(x.dtype) if x.dtype == torch.bfloat16 else y
    if "w_q" in params:
        w = (params["w_q"].float() * params["w_scale"]).to(
            x.dtype if x.dtype == torch.bfloat16 else torch.float32)
    else:
        w = params["w"]
    y = tp.reduce(matmul_fp32(x, w))
    if b is not None:
        y = y + b.to(y.dtype)
    return y.to(x.dtype) if x.dtype == torch.bfloat16 else y
