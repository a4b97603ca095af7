"""Encoder attention through the hand-written Hopper kernel
(``csrc/attention.cu``), with its plain PyTorch version beside it.

The kernel replaces the JAX package's three Pallas encoder-attention
kernels (``vault_tpu/ops/pallas_attention.py``: ``fused_attention``,
``fused_attention_batched``, ``fused_attention_dotbatch``); the selector
names "grid", "batched" and "dotbatch" all reach :func:`fused_attention`.

:func:`fused_attention` takes the plain version only for tensors on the
CPU.  A CUDA tensor launches the kernel, or the call raises: there is no
fallback.  ``fused_attention.launches`` counts the kernel's launches.
"""

from __future__ import annotations

import ctypes

import torch

from vault_tpu_torch.ops import _build
from vault_tpu_torch.ops.attention import attend_plain

HEAD_DIM = 64  # the kernel's head dim (BERT-base, ViLT-B/32, BERTweet)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_SIGNATURES = {"vt_attention_fwd": (
    [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_longlong] * 6
    + [ctypes.c_int, ctypes.c_void_p], ctypes.c_int)}


def attention_plain(q, k, v, bias):
    """The kernel's function in plain PyTorch: :func:`attend_plain`
    without dropout."""
    return attend_plain(q, k, v, bias)


def _check(q, k, v, bias):
    if not q.is_cuda:
        raise ValueError(f"fused_attention: tensors on {q.device} have no "
                         "kernel; only CPU (plain) and CUDA are supported")
    if q.dtype not in _DTYPES:
        raise TypeError(f"fused_attention: dtype {q.dtype} not supported "
                        "(bfloat16 or float32)")
    if q.dim() != 4 or q.shape[-1] != HEAD_DIM:
        raise ValueError(f"fused_attention: q must be (B, H, L, {HEAD_DIM}), "
                         f"got {tuple(q.shape)}")
    vec = 16 // q.element_size()  # elements per 16-byte copy
    for name, t in (("q", q), ("k", k), ("v", v)):
        if (t.shape != q.shape or t.dtype != q.dtype or t.device != q.device
                or t.stride() != q.stride()):
            raise ValueError(f"fused_attention: {name} {tuple(t.shape)} "
                             f"{t.dtype} {t.device} strides {t.stride()} does "
                             "not match q")
        if t.stride(-1) != 1 or any(st % vec for st in t.stride()[:3]) \
                or t.data_ptr() % 16:
            raise ValueError(f"fused_attention: {name} needs contiguous rows, "
                             "16-byte aligned rows and base")
    b, _, l, _ = q.shape
    if (bias.shape != (b, 1, 1, l) or bias.dtype != torch.float32
            or bias.device != q.device or not bias.is_contiguous()):
        raise ValueError(f"fused_attention: bias must be contiguous float32 "
                         f"(B, 1, 1, L) = {(b, 1, 1, l)} on {q.device}, got "
                         f"{tuple(bias.shape)} {bias.dtype} {bias.device}")


def fused_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    bias: torch.Tensor) -> torch.Tensor:
    """q/k/v: (B, H, L, 64), any strides with contiguous rows (for example
    head views of one fused projection); bias: (B, 1, 1, L) float32 additive
    key bias.  Returns (B, H, L, 64) in q's dtype: on the card a view of a
    (B, L, H, 64) tensor, so merging the heads back costs no copy."""
    if q.device.type == "cpu":
        return attention_plain(q, k, v, bias)
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


fused_attention.launches = 0
