"""Functional NN primitives shared by all towers (port of ``vault_tpu/ops/nn.py``).

Numerical contract matches HF PyTorch modules and the JAX package:
  * LayerNorm: eps inside sqrt, elementwise affine, fp32 statistics.
  * GELU: exact (erf-based), HF ACT2FN["gelu"].
  * Linear: ``x @ w + b`` with weights stored (in, out), the JAX package's
    layout, so a parameter bridge from it is a copy.

Dtype rule (the JAX package's ``linear``): products accumulate in fp32, the
bias is added in fp32, and the result is cast ONCE to bf16 when ``x`` is
bf16; anything else comes out fp32.  A bf16 ``torch.matmul`` rounds its
output before the bias add, which is a second rounding the JAX result does
not have.

Parameters live in :class:`ParamDict` modules: ``nn.Module``s whose
parameters and children are also reachable by key, so every op here takes
either a module or a plain dict of tensors where the JAX package takes a
pytree dict.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn


class ParamDict(nn.Module):
    """An ``nn.Module`` read like the JAX package's parameter dicts:
    ``p["w"]``, ``"b" in p`` and ``p.get("b")`` reach its parameters and
    children, so the state-dict key ``bert.layers.3.mlp_in.w`` is the pytree
    leaf ``params["bert"]["layers"]["mlp_in"]["w"][3]``."""

    def __init__(self, **entries):
        super().__init__()
        for k, v in entries.items():
            if isinstance(v, torch.Tensor) and not isinstance(v, nn.Parameter):
                v = nn.Parameter(v, requires_grad=v.is_floating_point())
            setattr(self, k, v)

    def __getitem__(self, key: str):
        if key in self._parameters or key in self._modules:
            return getattr(self, key)
        raise KeyError(key)

    def __contains__(self, key: str) -> bool:
        return key in self._parameters or key in self._modules

    def get(self, key: str, default=None):
        return self[key] if key in self else default


def matmul_fp32(x: torch.Tensor, w: torch.Tensor,
                b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``x @ w (+ b)`` accumulated and returned in fp32.  On the card a bf16
    pair goes through the tensor cores with an fp32 output and the bias
    added in fp32 by the same call (no rounding to bf16 before the bias);
    elsewhere both operands are upcast, which gives the same exact
    products."""
    if x.is_cuda and x.dtype == torch.bfloat16 and w.dtype == torch.bfloat16:
        x2 = x.reshape(-1, x.shape[-1])
        if b is None:
            y = torch.mm(x2, w, out_dtype=torch.float32)
        else:
            y = torch.addmm(b.float(), x2, w, out_dtype=torch.float32)
        return y.reshape(*x.shape[:-1], w.shape[-1])
    y = torch.matmul(x.float(), w.float())
    return y if b is None else y + b.float()


def linear(params, x: torch.Tensor) -> torch.Tensor:
    """Dense layer. params = {"w": (in, out), "b": (out,) [optional]}."""
    y = matmul_fp32(x, params["w"], params.get("b"))
    return y.to(x.dtype) if x.dtype == torch.bfloat16 else y


def layer_norm(params, x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """LayerNorm over the last dim: statistics, normalization and affine in
    fp32, one cast back to x's dtype.  PyTorch's kernel computes a bf16
    input in fp32 throughout, so when the parameters share x's dtype it runs
    on x directly; otherwise x is upcast."""
    h = x.shape[-1]
    scale, bias = params["scale"], params["bias"]
    if scale.dtype == x.dtype and bias.dtype == x.dtype:
        return F.layer_norm(x, (h,), scale, bias, eps)
    y = F.layer_norm(x.float(), (h,), scale.float(), bias.float(), eps)
    return y.to(x.dtype)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Exact (erf) GELU, in the JAX package's form x * (erf(x/√2) + 1) / 2."""
    return x * (torch.erf(x / math.sqrt(2.0)) + 1.0) / 2.0


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    return 0.5 * x * (1.0 + torch.tanh(
        math.sqrt(2.0 / math.pi) * (x + 0.044715 * x * x * x)))


def act_fn(name: str):
    if name == "gelu":
        return gelu
    if name == "gelu_new" or name == "gelu_pytorch_tanh":
        return gelu_tanh
    if name == "relu":
        return torch.relu
    raise ValueError(f"unknown activation {name!r}")


def dropout_mask(generator: torch.Generator, shape, rate: float,
                 dtype=torch.float32, device=None) -> torch.Tensor:
    """Pre-scaled inverted-dropout mask in {0, 1/keep}, for kernels that
    apply dropout inside a fused region (ops/cuda_mlp.py ``m`` operand).
    The draw comes from ``generator``; it does not reproduce JAX's stream,
    so parity tests feed both packages the same mask."""
    keep = 1.0 - rate
    u = torch.rand(shape, generator=generator, device=device)
    return torch.where(u < keep, torch.tensor(1.0 / keep, dtype=dtype,
                                              device=device),
                       torch.zeros((), dtype=dtype, device=device))


def dropout(generator: Optional[torch.Generator], x: torch.Tensor, rate: float,
            deterministic: bool) -> torch.Tensor:
    if deterministic or rate == 0.0:
        return x
    if generator is None:
        raise ValueError("dropout needs a torch.Generator when not deterministic")
    keep = 1.0 - rate
    u = torch.rand(x.shape, generator=generator, device=x.device)
    return torch.where(u < keep, x / keep, torch.zeros_like(x))


# ---------------------------------------------------------------------------
# Initializers (HF-compatible: normal(0, initializer_range), zeros bias,
# LayerNorm ones/zeros — modeling_vilt.py _init_weights, same for BERT).
# They draw on the host from a CPU ``torch.Generator``; the model moves the
# finished parameters to its device.
# ---------------------------------------------------------------------------

def init_linear(generator: torch.Generator, in_dim: int, out_dim: int,
                stddev: float = 0.02, bias: bool = True) -> ParamDict:
    p = {"w": torch.randn((in_dim, out_dim), generator=generator) * stddev}
    if bias:
        p["b"] = torch.zeros(out_dim)
    return ParamDict(**p)


def init_layer_norm(dim: int) -> ParamDict:
    return ParamDict(scale=torch.ones(dim), bias=torch.zeros(dim))


def init_embedding(generator: torch.Generator, num: int, dim: int,
                   stddev: float = 0.02,
                   padding_idx: Optional[int] = None) -> torch.Tensor:
    w = torch.randn((num, dim), generator=generator) * stddev
    if padding_idx is not None:
        w[padding_idx] = 0.0
    return w
