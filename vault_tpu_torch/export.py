"""Model export: the served forward as a ``torch.export`` program, saved to
one file and loaded without the model's Python code (port of the JAX
package's ``vault_tpu/export.py``, which serializes a ``jax.export``
StableHLO artifact).

Export traces with fake tensors, so the hand-written kernels cannot be
traced through their ``ctypes`` launches: each is an operator of the
``vault_tpu_torch`` namespace (``ops/_dispatch.py`` ``KernelOp``), which the
forward calls in eager mode and while it is traced.  The program therefore holds one node
per kernel launch (``torch.ops.vault_tpu_torch.mlp_block``, ...), and runs
the kernel on the card and its plain version on the CPU.  The trace is
non-strict (``strict=False``): Dynamo does not trace the kernels'
``autograd.Function``s.  The program holds the weights; its input shapes are
those of the example (one program per batch shape, as the server pads every
batch to one).
"""

from __future__ import annotations

import os
from typing import Callable, Sequence

import torch

# importing the kernel modules registers the vault_tpu_torch operators
from vault_tpu_torch.ops import cuda_attention, cuda_ln_qkv, cuda_mlp, cuda_swiglu  # noqa: F401


class _Forward(torch.nn.Module):
    def __init__(self, fn: Callable):
        super().__init__()
        self.fn = fn

    def forward(self, *args):
        return self.fn(*args)


def export_forward(module_or_fn, example_args: Sequence, path: str):
    """Export ``module_or_fn(*example_args)`` (an ``nn.Module``, or a
    function, whose closed-over tensors become constants of the program)
    without gradients and save it to ``path``; returns the
    ``ExportedProgram``."""
    module = (module_or_fn if isinstance(module_or_fn, torch.nn.Module)
              else _Forward(module_or_fn))
    with torch.no_grad():
        program = torch.export.export(module, tuple(example_args), strict=False)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    torch.export.save(program, path)
    return program


def load_forward(path: str) -> Callable:
    """The program saved by :func:`export_forward`, as a callable over the
    same inputs.  Loading needs the ``vault_tpu_torch`` operators
    registered: importing this module registers them (to call
    ``torch.export.load`` directly, import ``vault_tpu_torch.export`` or
    the ``vault_tpu_torch.ops.cuda_*`` modules first)."""
    return torch.export.load(path).module()


def exported_ops(program) -> Sequence[str]:
    """The ``vault_tpu_torch`` operators a program (an ``ExportedProgram``
    or the module :func:`load_forward` returns) calls, one entry per node."""
    graph = program.graph
    return [str(n.target) for n in graph.nodes
            if n.op == "call_function" and str(n.target).startswith("vault_tpu_torch.")]

