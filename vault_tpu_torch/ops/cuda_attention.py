"""Attention through the hand-written Hopper kernels: the encoder attention
(``csrc/attention.cu``) and the Llama tower's grouped-query attention
(``csrc/attention_gqa.cu``; both are ``csrc/attention_common.cuh``'s kernels
under another index map), each with its plain PyTorch version beside it.
:func:`attention_route` names the design a call takes on the card: bf16
runs one pass on ``wgmma`` (``attention_wgmma``), fp32 the FMA kernel
(``attention_fma``); both C entries pick it by the dtype they are given.

The encoder kernel replaces the JAX package's three Pallas encoder-attention
kernels (``vault_tpu/ops/pallas_attention.py``: ``fused_attention``,
``fused_attention_batched``, ``fused_attention_dotbatch``); the selector
names "grid", "batched" and "dotbatch" all reach :func:`fused_attention`.

:func:`fused_attention` is differentiable through :class:`_Attention`
(the counterpart of the JAX package's ``_pallas_attend`` custom_vjp, whose
backward recomputes through ``attend_xla``): the forward launches the
serving kernel; the backward launches the backward kernel
(``csrc/attention_bwd.cu``, :func:`fused_attention_bwd`, a kernel the JAX
package does not have) for bf16 CUDA tensors, and recomputes through the
plain composition for fp32 and CPU tensors; the bias gets no gradient.
Only tensors on the CPU run a plain version.  A CUDA tensor launches the
kernels, or the call raises: there is no fallback.
``fused_attention.launches`` and ``fused_attention_bwd.launches`` count
the launches.

:func:`fused_attention_gqa` replaces the JAX package's
``fused_attention_gqa``: H query heads on H // rep unrepeated K/V heads and
a full (B, 1, Lq, Lk) additive bias (causal and padding).  Its plain
version :func:`attention_gqa_plain` is the JAX package's ``_gqa_attend``;
the backward recomputes through it, the bias detached.
``fused_attention_gqa.launches`` counts its launches.

Both kernels take the head dims of :data:`HEAD_DIMS`, every multiple of 4
from 8 to 128 (the JAX package's Pallas kernels take any); a wrapper
refuses any other before it looks at the device, so the contract shows on
any tensor.  The dims of :data:`EXACT_HEAD_DIMS` run instances of their own
width whose K and V come by TMA; any other runs the padded instance of the
next of them (100 on 128), which copies 8 bytes at a time, so its operands
need only 8-byte aligned rows (``attention_common.cuh``).
Each is also the operator ``vault_tpu_torch::attention`` /
``attention_gqa`` (``ops/_dispatch.py`` ``KernelOp``, returning the
(B, L, H, D) tensor), through which the forward launches it, in eager
mode and in an exported program alike; the backward kernel is
``vault_tpu_torch::attention_bwd``, returning dq, dk and dv as (B, L, H, D)
tensors.
"""

from __future__ import annotations

import ctypes
import math

import torch

from vault_tpu_torch.ops import _build
from vault_tpu_torch.ops._dispatch import KernelOp, kernel_or_plain
from vault_tpu_torch.ops.attention import attend_plain, gqa_attend_plain

# The head dims both kernels take: every multiple of 4 from 8 to 128.  The
# exact instances (attention_common.cuh's D): 32 (BERT-small), 64 (BERT-base
# and -large, ViLT-B/32, BERTweet, TinyLlama, SmolLM), 96, 128 (Llama-2,
# Llama-3-8B); the others (100: OpenLLaMA-3B) run padded to the next.
HEAD_DIMS = tuple(range(8, 129, 4))
EXACT_HEAD_DIMS = (32, 64, 96, 128)
_HEAD_DIM_RULE = "D a multiple of 4 from 8 to 128"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_SIGNATURES = {"vt_attention_fwd": (
    [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_longlong] * 6
    + [ctypes.c_int, ctypes.c_void_p], ctypes.c_int)}


def attention_route(dtype: torch.dtype) -> str:
    """Which design an attention call with operands in ``dtype`` runs on the
    card: "wgmma" for bf16 (one pass, scores and probabilities in the
    ``wgmma`` accumulators), "fma" for fp32 (full fp32, the two-pass FMA
    kernel: tf32 ``wgmma`` would not keep the 1e-4 limit).  Both wrappers
    refuse any other dtype."""
    if dtype not in _DTYPES:
        raise TypeError(f"attention_route: dtype {dtype} not supported (bfloat16 or float32)")
    return "wgmma" if dtype == torch.bfloat16 else "fma"


def attention_plain(q, k, v, bias):
    """The kernel's function in plain PyTorch: :func:`attend_plain`
    without dropout."""
    return attend_plain(q, k, v, bias)


def _copy_elements(q) -> int:
    """Elements of one copy into the kernel's tiles: 16 bytes for the exact
    instances, 4 columns (8 bytes in bf16, 16 in fp32) for the padded ones;
    every row, head and batch offset and the base must be whole copies."""
    return 16 // q.element_size() if q.shape[-1] in EXACT_HEAD_DIMS else 4


def _check_rows(what, name, t, vec):
    if t.stride(-1) != 1 or any(st % vec for st in t.stride()[:3]) \
            or t.data_ptr() % (vec * t.element_size()):
        raise ValueError(f"{what}: {name} needs contiguous rows and rows and base aligned "
                         f"to {vec * t.element_size()} bytes at head dim {t.shape[-1]}")


def _check(q, k, v, bias, what="fused_attention"):
    if q.dim() != 4 or q.shape[-1] not in HEAD_DIMS:
        raise ValueError(f"{what}: q must be (B, H, L, D) with {_HEAD_DIM_RULE}, "
                         f"got {tuple(q.shape)}")
    if not q.is_cuda:
        raise ValueError(f"{what}: tensors on {q.device} have no "
                         "kernel; only CPU (plain) and CUDA are supported")
    attention_route(q.dtype)
    vec = _copy_elements(q)
    for name, t in (("q", q), ("k", k), ("v", v)):
        if (t.shape != q.shape or t.dtype != q.dtype or t.device != q.device
                or t.stride() != q.stride()):
            raise ValueError(f"{what}: {name} {tuple(t.shape)} "
                             f"{t.dtype} {t.device} strides {t.stride()} does "
                             "not match q")
        _check_rows(what, name, t, vec)
    b, _, l, _ = q.shape
    if (bias.shape != (b, 1, 1, l) or bias.dtype != torch.float32
            or bias.device != q.device or not bias.is_contiguous()):
        raise ValueError(f"{what}: bias must be contiguous float32 "
                         f"(B, 1, 1, L) = {(b, 1, 1, l)} on {q.device}, got "
                         f"{tuple(bias.shape)} {bias.dtype} {bias.device}")


def _kernel(q, k, v, bias):
    _check(q, k, v, bias)
    b, h, l, d = q.shape
    out = torch.empty((b, l, h, d), dtype=q.dtype, device=q.device)
    lib = _build.load("attention", _SIGNATURES)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    sb, sh, sl, _ = q.stride()
    code = lib.vt_attention_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                bias.data_ptr(), out.data_ptr(), b, h, l, d,
                                sb, sh, sl, l * h * d, d, h * d,
                                _DTYPES[q.dtype], stream)
    _build.check(lib, code, "attention")
    fused_attention.launches += 1
    return out.permute(0, 2, 1, 3)


def _blhd(fn, copy=False):
    """An attention's (B, H, L, D) result as the (B, L, H, D) tensor the
    kernels write (the plain versions' results are copied to that layout):
    the operators' outputs are contiguous, the wrappers return the head
    view of them."""
    if copy:
        return lambda q, k, v, bias: fn(q, k, v, bias).transpose(1, 2).contiguous()
    return lambda q, k, v, bias: fn(q, k, v, bias).transpose(1, 2)


def _fake_blhd(q, k, v, bias):
    b, h, l, d = q.shape
    return q.new_empty((b, l, h, d))


_SCHEMA = "(Tensor q, Tensor k, Tensor v, Tensor bias) -> Tensor"
ATTENTION = KernelOp("attention", _SCHEMA, _blhd(lambda *ts: _kernel(*ts)),
                     _blhd(attention_plain, copy=True), _fake_blhd)


# ---------------------------------------------------------------------------
# The backward kernel (csrc/attention_bwd.cu)
# ---------------------------------------------------------------------------

_BWD_SIGNATURES = {"vt_attention_bwd": (
    [ctypes.c_void_p] * 9 + [ctypes.c_int] * 4 + [ctypes.c_longlong] * 9 + [ctypes.c_void_p],
    ctypes.c_int)}


def attention_bwd_plain(q, k, v, bias, dout):
    """The backward kernel's function in plain PyTorch: the gradients (dq,
    dk, dv) of :func:`attention_plain` for the output gradient ``dout``,
    written out as its autograd computes them (an operator's implementation
    runs below autograd): fp32 scores and softmax, dP = dO V^T rounded to
    v's dtype as the cast of P rounds its gradient, dS = P (dP - rowsum(dP
    P)), the products in fp32, each gradient cast to its input's dtype."""
    d = q.shape[-1]
    qf, kf, vf, gf = q.float(), k.float(), v.float(), dout.float()
    p = torch.softmax(torch.matmul(qf, kf.transpose(-1, -2)) / math.sqrt(d) + bias.float(),
                      dim=-1)
    pb = p.to(v.dtype).float()
    dp = torch.matmul(gf, vf.transpose(-1, -2)).to(v.dtype).float()
    ds = p * (dp - (dp * p).sum(-1, keepdim=True)) / math.sqrt(d)
    return (torch.matmul(ds, kf).to(q.dtype), torch.matmul(ds.transpose(-1, -2), qf).to(k.dtype),
            torch.matmul(pb.transpose(-1, -2), gf).to(v.dtype))


def _check_bwd(q, k, v, bias, dout):
    what = "fused_attention_bwd"
    _check(q, k, v, bias, what)
    if q.dtype != torch.bfloat16:
        raise TypeError(f"{what}: the backward kernel takes bfloat16, got {q.dtype} (fp32 "
                        "recomputes through the plain composition)")
    if dout.shape != q.shape or dout.dtype != q.dtype or dout.device != q.device:
        raise ValueError(f"{what}: dout {tuple(dout.shape)} {dout.dtype} {dout.device} does "
                         f"not match q {tuple(q.shape)} {q.dtype} {q.device}")
    _check_rows(what, "dout", dout, _copy_elements(q))


def _bwd_kernel(q, k, v, bias, dout):
    _check_bwd(q, k, v, bias, dout)
    b, h, l, d = q.shape
    dq, dk, dv = (torch.empty((b, l, h, d), dtype=q.dtype, device=q.device) for _ in range(3))
    stats = torch.empty((3, b, h, l), dtype=torch.float32, device=q.device)
    lib = _build.load("attention_bwd", _BWD_SIGNATURES)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    code = lib.vt_attention_bwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
                                dout.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                                stats.data_ptr(), b, h, l, d, *q.stride()[:3],
                                *dout.stride()[:3], l * h * d, d, h * d, stream)
    _build.check(lib, code, "attention_bwd")
    fused_attention_bwd.launches += 1
    return dq, dk, dv


def _bwd_blhd(q, k, v, bias, dout):
    return tuple(t.transpose(1, 2).contiguous()
                 for t in attention_bwd_plain(q, k, v, bias, dout))


def _fake_bwd(q, k, v, bias, dout):
    return tuple(_fake_blhd(q, k, v, bias) for _ in range(3))


ATTENTION_BWD = KernelOp(
    "attention_bwd", "(Tensor q, Tensor k, Tensor v, Tensor bias, Tensor dout) "
    "-> (Tensor, Tensor, Tensor)", lambda *ts: _bwd_kernel(*ts), _bwd_blhd, _fake_bwd)


def fused_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, bias: torch.Tensor,
                        dout: torch.Tensor):
    """The gradients (dq, dk, dv) of :func:`fused_attention` for the output
    gradient ``dout`` (B, H, L, D), q, k, v and bias as the forward takes
    them, bf16 on the card (one call of ``csrc/attention_bwd.cu``: its
    query pass and its key pass), :func:`attention_bwd_plain` on the CPU.
    Each is (B, H, L, D) in q's dtype, a view of a (B, L, H, D) tensor."""
    return tuple(t.permute(0, 2, 1, 3) for t in ATTENTION_BWD(q, k, v, bias, dout))


fused_attention_bwd.launches = 0


class _Attention(torch.autograd.Function):
    """The encoder attention.  forward: the serving kernel through
    ``ATTENTION`` (the plain version for CPU tensors), the same launch with
    the same arguments whether or not a gradient follows; backward: the
    backward kernel for bf16 CUDA tensors, else the autograd of
    ``ATTENTION.plain`` recomputed from the saved inputs (fp32, and every
    CPU tensor), for the inputs that need a gradient.  The bias is a
    constant."""

    @staticmethod
    def forward(ctx, q, k, v, bias):
        ctx.save_for_backward(q, k, v, bias)
        return ATTENTION(q, k, v, bias)

    @staticmethod
    def backward(ctx, g):
        q, k, v, bias = ctx.saved_tensors
        need = ctx.needs_input_grad[:3]
        if q.is_cuda and q.dtype == torch.bfloat16:
            grads = fused_attention_bwd(q, k, v, bias, g.contiguous().permute(0, 2, 1, 3))
            return (*(t if n else None for t, n in zip(grads, need)), None)
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_() if n else t for t, n in zip((q, k, v), need)]
            out = ATTENTION.plain(*leaves, bias)
            grads = iter(torch.autograd.grad(out, [t for t, n in zip(leaves, need) if n], g,
                                             allow_unused=True))
        return (*(next(grads) if n else None for n in need), None)


def fused_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    bias: torch.Tensor) -> torch.Tensor:
    """q/k/v: (B, H, L, D), D in :data:`HEAD_DIMS`, any strides with
    contiguous, aligned rows (for example head views of one fused
    projection); bias:
    (B, 1, 1, L) float32 additive key bias.  Returns (B, H, L, D) in q's
    dtype, a view of a (B, L, H, D) tensor, so merging the heads back costs
    no copy."""
    # the bias is a constant of the attention mask: no gradient
    return _Attention.apply(q, k, v, bias.detach()).permute(0, 2, 1, 3)


fused_attention.launches = 0


# ---------------------------------------------------------------------------
# Grouped-query attention (csrc/attention_gqa.cu)
# ---------------------------------------------------------------------------

_GQA_SIGNATURES = {"vt_attention_gqa_fwd": (
    [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
    + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_int, ctypes.c_void_p], ctypes.c_int)}


def attention_gqa_plain(q, k, v, bias):
    """The GQA kernel's function in plain PyTorch: :func:`gqa_attend_plain`
    with the group size read off the shapes."""
    return gqa_attend_plain(q, k, v, bias, q.shape[1] // k.shape[1])


def _check_gqa(q, k, v, bias):
    what = "fused_attention_gqa"
    if q.dim() != 4 or q.shape[-1] not in HEAD_DIMS:
        raise ValueError(f"{what}: q must be (B, H, L, D) with {_HEAD_DIM_RULE}, "
                         f"got {tuple(q.shape)}")
    if not q.is_cuda:
        raise ValueError(f"{what}: tensors on {q.device} have no kernel; only "
                         "CPU (plain) and CUDA are supported")
    attention_route(q.dtype)
    b, h, l, d = q.shape
    if (k.dim() != 4 or k.shape != v.shape or k.shape[0] != b or k.shape[2:] != (l, d)
            or k.shape[1] == 0 or h % k.shape[1]):
        raise ValueError(f"{what}: k and v must be (B, G, L, D) with G dividing H = {h}, "
                         f"got {tuple(k.shape)} and {tuple(v.shape)} for q {tuple(q.shape)}")
    vec = _copy_elements(q)
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"{what}: {name} is {t.dtype} on {t.device}, q {q.dtype} "
                             f"on {q.device}")
        _check_rows(what, name, t, vec)
    if (bias.shape != (b, 1, l, l) or bias.dtype != torch.float32
            or bias.device != q.device or not bias.is_contiguous()):
        raise ValueError(f"{what}: bias must be contiguous float32 (B, 1, L, L) = "
                         f"{(b, 1, l, l)} on {q.device}, got {tuple(bias.shape)} "
                         f"{bias.dtype} {bias.device}")


def _gqa_kernel(q, k, v, bias):
    _check_gqa(q, k, v, bias)
    b, h, l, d = q.shape
    out = torch.empty((b, l, h, d), dtype=q.dtype, device=q.device)
    lib = _build.load("attention_gqa", _GQA_SIGNATURES)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    strides = (ctypes.c_longlong * 12)(*q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                                       l * h * d, d, h * d)
    code = lib.vt_attention_gqa_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                    bias.data_ptr(), out.data_ptr(), b, h, k.shape[1], l, d,
                                    strides, _DTYPES[q.dtype], stream)
    _build.check(lib, code, "attention_gqa")
    fused_attention_gqa.launches += 1
    return out.permute(0, 2, 1, 3)


ATTENTION_GQA = KernelOp("attention_gqa", _SCHEMA, _blhd(lambda *ts: _gqa_kernel(*ts)),
                         _blhd(attention_gqa_plain, copy=True), _fake_blhd)


def fused_attention_gqa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        bias: torch.Tensor) -> torch.Tensor:
    """q: (B, H, L, D); k/v: (B, G, L, D) with G dividing H, unrepeated;
    bias: contiguous (B, 1, L, L) float32, additive (causal and padding,
    masked entries at a finite fill).  Returns (B, H, L, D) in q's dtype, a
    view of a (B, L, H, D) tensor."""
    return kernel_or_plain(ATTENTION_GQA, ATTENTION_GQA.plain, q, k, v,
                           bias.detach()).permute(0, 2, 1, 3)


fused_attention_gqa.launches = 0
