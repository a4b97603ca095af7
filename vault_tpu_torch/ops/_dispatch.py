"""What the kernel wrappers of ``ops/cuda_attention.py``,
``ops/cuda_linear.py``, ``ops/cuda_ln_qkv.py``, ``ops/cuda_mlp.py`` and
``ops/cuda_swiglu.py`` share: the operand check before a launch;
:class:`KernelOp`, a serving kernel and its plain version behind one
operator of the ``vault_tpu_torch`` namespace, so that ``torch.export`` can
trace a launch; and the ``torch.autograd.Function`` that runs a kernel (CUDA
tensors) or its plain version (CPU tensors) forward and takes the gradient
of a reference composition backward, as the JAX package's ``custom_vjp``s
take the vjp of their XLA compositions.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch

Spec = Tuple[Optional[torch.Tensor], tuple, torch.dtype]


def check_operands(what: str, x: torch.Tensor, operands: Dict[str, Spec]) -> None:
    """Every given operand of its (shape, dtype), on x's device, contiguous
    and 16-byte aligned (the kernels load 16 bytes at a time, TMA takes
    16-byte aligned rows), and x on the card.  Raises on anything else:
    nothing falls back.  The operands are checked before the device, so a
    malformed operand is named wherever it lies."""
    for name, (t, shape, dtype) in operands.items():
        if t is None:
            continue
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{what}: {name} has shape {tuple(t.shape)}, "
                             f"expected {tuple(shape)}")
        if t.dtype != dtype:
            raise TypeError(f"{what}: {name} is {t.dtype}, expected {dtype}")
        if t.device != x.device:
            raise ValueError(f"{what}: {name} is on {t.device}, x on {x.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{what}: {name} must be contiguous and 16-byte "
                             "aligned")
    if not x.is_cuda:
        raise ValueError(f"{what}: the kernel takes CUDA tensors, got {x.device}")


class KernelOp:
    """A forward kernel and its plain version behind the operator
    ``vault_tpu_torch::<name>`` (``torch.library.custom_op``, ``schema`` its
    signature: the tensors, then the static arguments keyword-only).  The
    operator's CUDA implementation is ``kernel``, a wrapper that launches
    (and counts the launch) or raises; its CPU implementation is ``plain``;
    ``fake`` gives the output's shape, type and strides while a program is
    traced.  The wrapper is looked up at each call, so replacing a module's
    wrapper (a test running a plain version in its place) reaches the
    operator too.

    Called, a KernelOp calls the operator, which dispatches on the tensors'
    device: ``plain`` when they lie on the CPU, ``kernel`` on the card.  So
    eager calls and an exported program (one node per launch) take the same
    route, and the program launches the hand-written kernels on the card.
    Tensors on any other device go to ``kernel``, which refuses them (the
    operator would hand a meta tensor to ``fake``)."""

    def __init__(self, name: str, schema: str, kernel: Callable, plain: Callable,
                 fake: Callable):
        self.kernel, self.plain = kernel, plain
        self.op = torch.library.custom_op(
            f"vault_tpu_torch::{name}", lambda *ts, **kw: self.plain(*ts, **kw),
            mutates_args=(), device_types="cpu", schema=schema)
        self.op.register_kernel("cuda", lambda *ts, **kw: self.kernel(*ts, **kw))
        self.op.register_fake(fake)

    def __call__(self, *ts, **kw) -> torch.Tensor:
        if any(t is not None and t.device.type not in ("cpu", "cuda") for t in ts):
            return self.kernel(*ts, **kw)
        return self.op(*ts, **kw)


class _KernelOrPlain(torch.autograd.Function):
    """forward: ``op(*ts, **kw)`` (:class:`KernelOp`: the plain version for
    CPU tensors, else the kernel); backward: autograd of ``ref(*ts, **kw)``
    recomputed from the saved inputs, for the inputs that need a gradient."""

    @staticmethod
    def forward(ctx, op, ref, kw, *ts):
        ctx.ref, ctx.kw = ref, kw
        ctx.save_for_backward(*ts)
        return op(*ts, **kw)

    @staticmethod
    def backward(ctx, g):
        need = ctx.needs_input_grad[3:]
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_() if n else t
                      for t, n in zip(ctx.saved_tensors, need)]
            out = ctx.ref(*leaves, **ctx.kw)
            grads = iter(torch.autograd.grad(out, [t for t, n in zip(leaves, need) if n],
                                             g, allow_unused=True))
        return (None, None, None, *(next(grads) if n else None for n in need))


def kernel_or_plain(op: KernelOp, ref: Callable, *ts, **kw) -> torch.Tensor:
    """Differentiable call of a kernel: see :class:`_KernelOrPlain`.  The
    tensors go positionally; ``kw`` holds the static arguments.  A tensor
    passed detached is a constant: it gets no gradient."""
    return _KernelOrPlain.apply(op, ref, kw, *ts)


def like(i: int) -> Callable:
    """A fake implementation whose output is shaped like the ``i``-th
    tensor argument (the MLP and SwiGLU blocks: x in, x's shape out)."""
    return lambda *ts, **kw: torch.empty_like(ts[i])
