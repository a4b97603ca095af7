"""What the kernel wrappers of ``ops/cuda_attention.py``,
``ops/cuda_ln_qkv.py`` and the w8a8 half of ``ops/cuda_mlp.py`` share: the
operand check before a launch, and the ``torch.autograd.Function`` that
runs a kernel (CUDA tensors) or its plain version (CPU tensors) forward and
takes the gradient of a reference composition backward, as the JAX
package's ``custom_vjp``s take the vjp of their XLA compositions.
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


class _KernelOrPlain(torch.autograd.Function):
    """forward: ``plain(*ts, **kw)`` when every tensor lies on the CPU,
    else ``kernel(*ts, **kw)``, which launches or raises; backward:
    autograd of ``ref(*ts, **kw)`` recomputed from the saved inputs, for
    the inputs that need a gradient."""

    @staticmethod
    def forward(ctx, fns, kw, *ts):
        ctx.fns, ctx.kw = fns, kw
        ctx.save_for_backward(*ts)
        kernel, plain, _ = fns
        on_cpu = all(t is None or t.device.type == "cpu" for t in ts)
        return (plain if on_cpu else kernel)(*ts, **kw)

    @staticmethod
    def backward(ctx, g):
        need = ctx.needs_input_grad[2:]
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_() if n else t
                      for t, n in zip(ctx.saved_tensors, need)]
            out = ctx.fns[2](*leaves, **ctx.kw)
            grads = iter(torch.autograd.grad(out, [t for t, n in zip(leaves, need) if n],
                                             g, allow_unused=True))
        return (None, None, *(next(grads) if n else None for n in need))


def kernel_or_plain(kernel: Callable, plain: Callable, ref: Callable, *ts,
                    **kw) -> torch.Tensor:
    """Differentiable call of a kernel: see :class:`_KernelOrPlain`.  The
    tensors go positionally; ``kw`` holds the static arguments.  A tensor
    passed detached is a constant: it gets no gradient."""
    return _KernelOrPlain.apply((kernel, plain, ref), kw, *ts)
