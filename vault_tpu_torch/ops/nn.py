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

import contextlib
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


def _mm_fp32(x2, w, b=None):
    if b is None:
        return torch.mm(x2, w, out_dtype=torch.float32)
    return torch.addmm(b, x2, w, out_dtype=torch.float32)


# The same product as an operator, which the forward calls while
# torch.export traces it: the exported program then runs the same cuBLAS
# call as eager.  (A fake-tensor decomposition of addmm's out_dtype overload
# in torch 2.11 reads out_dtype as beta and fails the trace.)
_mm_fp32_op = torch.library.custom_op(
    "vault_tpu_torch::matmul_fp32", _mm_fp32, mutates_args=(), device_types="cuda",
    schema="(Tensor x2, Tensor w, Tensor? b) -> Tensor")
_mm_fp32_op.register_fake(
    lambda x2, w, b: x2.new_empty((x2.shape[0], w.shape[1]), dtype=torch.float32))


class _MatmulFP32(torch.autograd.Function):
    """``x2 @ w (+ b)`` for a bf16 pair on the card: the tensor cores with an
    fp32 output, the bias added in fp32 by the same call.  PyTorch has no
    derivative for ``mm``/``addmm`` with ``out_dtype``, so the two products
    of the backward are written here, also with fp32 accumulation, cast to
    the operands' dtypes (what XLA does for the JAX package's ``linear``).
    The cotangent is cast to bf16 for them: it arrives from the cast of
    this output to bf16 in :func:`linear` (or :func:`patchify`), so it is
    exact in bf16."""

    @staticmethod
    def forward(ctx, x2, w, b):
        ctx.save_for_backward(x2, w)
        ctx.has_bias = b is not None
        return (_mm_fp32_op if torch.compiler.is_exporting() else _mm_fp32)(x2, w, b)

    @staticmethod
    def backward(ctx, gy):
        x2, w = ctx.saved_tensors
        g = gy.to(x2.dtype)
        dx = dw = db = None
        if ctx.needs_input_grad[0]:
            dx = torch.mm(g, w.t(), out_dtype=torch.float32).to(x2.dtype)
        if ctx.needs_input_grad[1]:
            dw = torch.mm(x2.t(), g, out_dtype=torch.float32).to(w.dtype)
        if ctx.has_bias and ctx.needs_input_grad[2]:
            db = gy.sum(0)
        return dx, dw, db


def matmul_fp32(x: torch.Tensor, w: torch.Tensor,
                b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``x @ w (+ b)`` accumulated and returned in fp32.  On the card a bf16
    pair goes through the tensor cores with an fp32 output and the bias
    added in fp32 by the same call (no rounding to bf16 before the bias),
    differentiable through :class:`_MatmulFP32`; elsewhere both operands
    are upcast, which gives the same exact products."""
    if x.is_cuda and x.dtype == torch.bfloat16 and w.dtype == torch.bfloat16:
        x2 = x.reshape(-1, x.shape[-1])
        y = _MatmulFP32.apply(x2, w, None if b is None else b.float())
        return y.reshape(*x.shape[:-1], w.shape[-1])
    acc = torch.promote_types(x.dtype, torch.float32)  # float64 stays
    y = torch.matmul(x.to(acc), w.to(acc))
    return y if b is None else y + b.to(acc)


# torch._int_mm on the card takes more than 16 rows and both inner and
# output widths in multiples of 8 (PyTorch's CUDA Blas.cpp checks)
_INT_MM_MIN_ROWS = 17


def int8_matmul(xq: torch.Tensor, wq: torch.Tensor) -> torch.Tensor:
    """(..., K) int8 @ (K, N) int8 -> (..., N) int32, exact.  On the card
    fewer than 17 rows are padded with zero rows (their products are
    dropped); widths that are not multiples of 8 raise."""
    k, n = wq.shape
    x2 = xq.reshape(-1, k)
    rows = x2.shape[0]
    if xq.is_cuda:
        if k % 8 or n % 8:
            raise ValueError(f"int8 product on the card: widths {k} -> {n} must "
                             "be multiples of 8 (torch._int_mm)")
        if rows < _INT_MM_MIN_ROWS:
            x2 = torch.cat([x2, x2.new_zeros((_INT_MM_MIN_ROWS - rows, k))])
    y = torch._int_mm(x2, wq)[:rows]
    return y.reshape(*xq.shape[:-1], n)


def linear_w8a8_plain(x: torch.Tensor, w_q8: torch.Tensor, w_scale: torch.Tensor,
                      b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The w8a8 dense layer as a composition: x quantized per row
    (``ops/quantize.py`` ``quantize_activation``), the int8 x int8 -> int32
    product (:func:`int8_matmul`, either layout of the codes), then
    ``y * (x_scale * w_scale) + b`` in fp32 (the two scales multiplied
    first, as the JAX package does), cast to bf16 for bf16 x.  The plain
    version of ``ops/cuda_linear.py``'s kernel, and what every plain version
    and reference composition on w8a8 weights calls by name; differentiable
    through the scales."""
    from vault_tpu_torch.ops.quantize import quantize_activation

    xq, xs = quantize_activation(x)
    y = int8_matmul(xq, w_q8).float() * (xs * w_scale)
    if b is not None:
        y = y + b
    return y.to(x.dtype) if x.dtype == torch.bfloat16 else y


def linear_plain(params, x: torch.Tensor) -> torch.Tensor:
    """:func:`linear` with the w8a8 form on its composition
    (:func:`linear_w8a8_plain`) wherever it runs: the dense layer of the
    plain versions and reference compositions, which never launch a
    kernel."""
    if "w_q8" in params:
        return linear_w8a8_plain(x, params["w_q8"], params["w_scale"], params.get("b"))
    return linear(params, x)


def linear(params, x: torch.Tensor) -> torch.Tensor:
    """Dense layer. params = {"w": (in, out), "b": (out,) [optional]}, the
    int8 weight-only form {"w_q": int8, "w_scale": (1, out) fp32}, or the
    w8a8 form {"w_q8": int8, "w_scale"} (ops/quantize.py).  w8 dequantizes
    the weights to x's type (fp32 for fp32 x) and runs the fp product; w8a8
    quantizes x per row and runs an int8 x int8 -> int32 product, then
    ``y * (x_scale * w_scale) + b`` in fp32 (:func:`linear_w8a8_plain`).
    Where ``ops/cuda_linear.py`` ``kernel_takes`` the call (bf16 on the
    card, no gradient to x, the codes K-major, widths in the kernel's), w8a8
    runs on its kernel, the operator ``vault_tpu_torch::linear_w8a8``,
    which gives the composition's bits."""
    b = params.get("b")
    if "w_q8" in params:
        from vault_tpu_torch.ops import cuda_linear
        from vault_tpu_torch.ops._dispatch import kernel_or_plain

        w, s = params["w_q8"], params["w_scale"]
        if cuda_linear.kernel_takes(x, w, s, b):
            return kernel_or_plain(cuda_linear.LINEAR_W8A8, linear_w8a8_plain, x, w, s, b)
        return linear_w8a8_plain(x, w, s, b)
    if "w_q" in params:
        w = (params["w_q"].float() * params["w_scale"]).to(
            x.dtype if x.dtype == torch.bfloat16 else torch.float32)
    else:
        w = params["w"]
    y = matmul_fp32(x, w, b)
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


def layer_norm_f32(gamma, beta, x: torch.Tensor, eps: float) -> torch.Tensor:
    """LayerNorm over the last dim in fp32 (returned fp32), its mean and
    variance taken in double and rounded to fp32: the correctly rounded
    statistics, which the int8 kernels (csrc/gemm_common.cuh ``ln_row``)
    compute the same way, so both give the same bits and the same int8
    codes.  Then ``(x - mean) * rstd * gamma + beta``, one rounding per
    step, with rstd = 1 / sqrt(var + eps)."""
    xf = x.float()
    mean = xf.double().mean(-1, keepdim=True).float()
    d = xf - mean
    var = d.double().square().mean(-1, keepdim=True).float()
    rstd = torch.reciprocal(torch.sqrt(var + eps))
    return d * rstd * gamma.float() + beta.float()


def rms_norm(weight: torch.Tensor, x: torch.Tensor, eps: float) -> torch.Tensor:
    """RMSNorm over the last dim (the JAX package's Llama ``_rms_norm``):
    fp32 statistics, ``weight * (x * rsqrt(mean(x^2) + eps))``, one cast to
    x's dtype."""
    xf = x.float()
    var = (xf * xf).mean(-1, keepdim=True)
    return (weight * (xf * torch.rsqrt(var + eps))).to(x.dtype)


def silu(x: torch.Tensor) -> torch.Tensor:
    """``x * sigmoid(x)``, in the JAX package's form (``jax.nn.silu``)."""
    return x * torch.sigmoid(x)


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


class _Take(torch.autograd.Function):
    """``table[indices]`` whose backward sums the rows' gradients in fp32
    and rounds the table's gradient once (see :func:`take`)."""

    @staticmethod
    def forward(ctx, table, *indices):
        ctx.save_for_backward(*indices)
        ctx.shape, ctx.dtype = table.shape, table.dtype
        return table[indices]

    @staticmethod
    def backward(ctx, grad):
        g = torch.zeros(ctx.shape, dtype=torch.float32, device=grad.device)
        g.index_put_(tuple(ctx.saved_tensors), grad.float(), accumulate=True)
        return (g.to(ctx.dtype),) + (None,) * len(ctx.saved_tensors)


def take(table: torch.Tensor, *indices: torch.Tensor) -> torch.Tensor:
    """``table[indices]`` (an embedding lookup, a position-grid gather).
    PyTorch's backward of a lookup (``index_put_`` with ``accumulate``) adds
    the rows' gradients one at a time in the table's dtype, so a bf16 table
    whose rows are read many times (the token-type row, by every token of
    the batch) gets a sum rounded to bf16 at each of its terms: on the card
    the token-type row's gradient of a batch-32 step then moved by 6%
    between two data-parallel ranks (640 terms each) and one process
    (1,280).  On the card a bf16 table's lookup sums the rows' gradients
    in fp32 and rounds once.  On the CPU, and for an fp32 table or one without a gradient, the
    plain lookup runs: it rounds as the JAX package's does there (XLA's
    CPU scatter-add), which the parity tests hold the port to.  With the
    fp32 sum on the CPU too, the bf16 parity tests' losses stay within
    their tolerances, but two of them flip one prediction each and their
    exact metrics part: Bloomberg through the CLI (eval accuracy 0.25
    against 0.0 in one window of 4 rows) and the VQA trainer (0.667
    against 0.611)."""
    if (not table.is_cuda or table.dtype == torch.float32
            or not (torch.is_grad_enabled() and table.requires_grad)):
        return table[indices]
    return _Take.apply(table, *indices)


# Where a draw lands when a batch or the heads are split over ranks: each
# rank draws the mask of the whole (global) tensor from the generator every
# rank shares, and keeps its own block, so the masks do not depend on the
# split (the counterpart of the JAX package's threefry streams, which are a
# function of the global element index).  Set by :func:`shard_draws`.
_DRAW_SHARDS = {"rows": None, "heads": None}


@contextlib.contextmanager
def shard_draws(rows=None, heads=None):
    """Within the block, every dropout draw (:func:`uniform`) is made at the
    global shape and cut to this rank's block: ``rows=(index, count)``
    splits the leading (batch-major) axis, as data parallelism does;
    ``heads=(index, count)`` splits the heads axis of the attention
    probabilities, as tensor parallelism does.  A module-level setting, not
    a thread-local one: the backward's recompute under ``remat`` may run on
    another thread and must draw the same masks."""
    saved = dict(_DRAW_SHARDS)
    _DRAW_SHARDS.update(rows=rows, heads=heads)
    try:
        yield
    finally:
        _DRAW_SHARDS.update(saved)


def uniform(generator: torch.Generator, shape, device=None,
            heads_axis: Optional[int] = None) -> torch.Tensor:
    """U[0, 1) draws of ``shape`` from ``generator``, cut from the global
    draw when :func:`shard_draws` is active (``heads_axis`` names the axis
    that the heads split applies to)."""
    shape = list(shape)
    cuts = []
    rows, heads = _DRAW_SHARDS["rows"], _DRAW_SHARDS["heads"]
    if rows is not None and rows[1] > 1:
        cuts.append((0, rows))
    if heads is not None and heads[1] > 1 and heads_axis is not None:
        cuts.append((heads_axis, heads))
    full = list(shape)
    for axis, (_, count) in cuts:
        full[axis] *= count
    u = torch.rand(full, generator=generator, device=device)
    for axis, (index, _) in cuts:
        u = u.narrow(axis, index * shape[axis], shape[axis])
    return u


def dropout_mask(generator: torch.Generator, shape, rate: float,
                 dtype=torch.float32, device=None) -> torch.Tensor:
    """Pre-scaled inverted-dropout mask in {0, 1/keep}, for kernels that
    apply dropout inside a fused region (ops/cuda_mlp.py ``m`` operand).
    The draw comes from ``generator`` (:func:`uniform`); it does not
    reproduce JAX's stream, so parity tests feed both packages the same
    mask."""
    if generator is None:
        raise ValueError("dropout_mask needs a torch.Generator")
    keep = 1.0 - rate
    u = uniform(generator, shape, device)
    return torch.where(u < keep, torch.tensor(1.0 / keep, dtype=dtype,
                                              device=device),
                       torch.zeros((), dtype=dtype, device=device))


def dropout(generator: Optional[torch.Generator], x: torch.Tensor, rate: float,
            deterministic: bool, heads_axis: Optional[int] = None) -> torch.Tensor:
    if deterministic or rate == 0.0:
        return x
    if generator is None:
        raise ValueError("dropout needs a torch.Generator when not deterministic")
    keep = 1.0 - rate
    u = uniform(generator, x.shape, x.device, heads_axis)
    return torch.where(u < keep, x / keep, torch.zeros_like(x))


# The products that remat="dots" keeps: those without batch dimensions
# (jax.checkpoint_policies.dots_with_no_batch_dims_saveable).  A 3-D
# ``x @ w`` reaches the dispatcher as a view and an ``mm``; ``bmm`` and
# ``baddbmm`` (attention's batched products) and the kernels' operators
# recompute, as a ``pallas_call`` is not a dot the JAX policy saves.
_SAVED_PRODUCTS = ("mm", "addmm", "linear")


def _dots_policy(ctx, func, *args, **kwargs):
    from torch.utils.checkpoint import CheckpointPolicy

    if func.namespace == "aten" and func.overloadpacket.__name__ in _SAVED_PRODUCTS:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _dots_contexts():
    from torch.utils.checkpoint import create_selective_checkpoint_contexts

    return create_selective_checkpoint_contexts(_dots_policy)


def remat_apply(fn, remat, generator: Optional[torch.Generator], *args,
                **kwargs):
    """``fn(*args, generator=..., **kwargs)``, one encoder layer, under
    per-layer activation checkpointing when ``remat`` is set and autograd
    records (the counterpart of the JAX package's ``maybe_remat``).
    ``remat=True``: the layer keeps no activations and reruns whole in the
    backward.  ``remat="dots"``: the layer keeps the outputs of its products
    without batch dimensions (the Q/K/V and output projections, the plain
    MLP's halves; ``_SAVED_PRODUCTS``) and reruns everything else, the
    attention's batched products and the kernels included (selective
    checkpointing, ``torch.utils.checkpoint.create_selective_checkpoint_
    contexts``).

    The layer draws its dropout masks from ``generator``, and
    ``torch.utils.checkpoint`` replays only the default generators, so the
    layer runs on a fresh generator started from the state ``generator``
    had when the layer began: the rerun draws the same masks.  ``generator``
    is then moved on to where the layer's first run left it, so the layers
    draw the same stream under every ``remat``."""
    if remat not in (False, True, "dots"):
        raise ValueError(f"remat={remat!r}: expected False, True or 'dots'")
    if not remat or not torch.is_grad_enabled():
        return fn(*args, generator=generator, **kwargs)
    from torch.utils.checkpoint import checkpoint, noop_context_fn

    start = None if generator is None else generator.get_state()
    end = []

    def layer(*a):
        gen = None
        if start is not None:
            gen = torch.Generator(device=generator.device)
            gen.set_state(start)
        out = fn(*a, generator=gen, **kwargs)
        if gen is not None and not end:
            end.append(gen.get_state())
        return out

    out = checkpoint(layer, *args, use_reentrant=False, preserve_rng_state=False,
                     context_fn=_dots_contexts if remat == "dots" else noop_context_fn)
    if end:
        generator.set_state(end[0])
    return out


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
