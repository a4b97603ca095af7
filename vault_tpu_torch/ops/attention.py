"""Multi-head self-attention core (port of ``vault_tpu/ops/attention.py``).

Numerics mirror HF BERT/ViLT self-attention and the JAX package:
scores = q k^T / sqrt(head_dim) + additive bias in fp32; softmax in fp32;
probs cast to v's dtype; probs @ v accumulated in fp32.

Two execution paths, selected by ``use_pallas`` (the JAX package's name for
the selector, kept so one setting means the same in both packages):
  * the plain PyTorch composition :func:`attend_plain` (the counterpart of
    the JAX package's ``attend_xla``);
  * the hand-written encoder-attention kernel (ops/cuda_attention.py), which
    stands for all three of the JAX package's Pallas encoder-attention
    kernels ("grid", "batched", "dotbatch").
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from vault_tpu_torch.ops.nn import linear

# What "auto" resolves to for CUDA tensors: the fused (H, 3H) QKV product,
# the fused MLP-block kernels and the attention kernel.  On the CPU "auto"
# is False (the plain composition), as the JAX package resolves it off-TPU.
CUDA_DEFAULT_IMPL = "fuseqkv+fusemlp+batched"


def parse_impl(use_pallas, device: Optional[torch.device] = None):
    """The ``use_pallas`` knob is an implementation selector: False (plain),
    True/"batched"/"grid"/"dotbatch" (the attention kernel; the three names
    of the JAX package all select the one kernel); "+"-combinable modifiers:
    "fuseqkv" computes Q/K/V with one fused (H, 3H) product, "fuselnqkv"
    additionally folds the pre-LN LayerNorm into it (not ported yet: the
    layer raises), "fusemlp" runs the MLP halves through the fused MLP-block
    kernels (ops/cuda_mlp.py).  "auto" resolves to CUDA_DEFAULT_IMPL when
    ``device`` is a CUDA device and to False elsewhere.
    Returns (fuse_qkv, fuse_lnqkv, fuse_mlp, attn_impl)."""
    if use_pallas == "auto":
        on_cuda = device is not None and torch.device(device).type == "cuda"
        use_pallas = CUDA_DEFAULT_IMPL if on_cuda else False
    elif use_pallas in ("false", "False", "0", "none", "off"):
        use_pallas = False  # CLI string forms
    if not isinstance(use_pallas, str):
        return False, False, False, use_pallas
    parts = [p for p in use_pallas.split("+") if p]
    fuse = "fuseqkv" in parts
    fuse_lnqkv = "fuselnqkv" in parts
    fuse_mlp = "fusemlp" in parts
    rest = [p for p in parts
            if p not in ("fuseqkv", "fuselnqkv", "fusemlp")]
    # unknown tokens must FAIL, not silently select another attention core
    bad = [p for p in rest if p not in ("grid", "batched", "dotbatch")]
    if bad:
        raise ValueError(
            f"unknown use_pallas token(s) {bad}; valid: fuseqkv, fuselnqkv, "
            f"fusemlp, grid, batched, dotbatch, auto, false")
    return fuse, fuse_lnqkv, fuse_mlp, (rest[0] if rest else False)


def project_qkv(lp, y: torch.Tensor, num_heads: int, fuse: bool = False):
    """Q/K/V projections -> (B, heads, L, head_dim) each.  With ``fuse``,
    the three (H, H) products run as one (H, 3H) product (same contractions,
    fp32 accumulation, so numerically identical)."""
    if fuse:
        fused = {"w": torch.cat([lp["q"]["w"], lp["k"]["w"], lp["v"]["w"]],
                                dim=1)}
        if "b" in lp["q"]:  # qkv_bias=False models carry no bias leaves
            fused["b"] = torch.cat([lp["q"]["b"], lp["k"]["b"], lp["v"]["b"]])
        q, k, v = torch.chunk(linear(fused, y), 3, dim=-1)
    else:
        q, k, v = linear(lp["q"], y), linear(lp["k"], y), linear(lp["v"], y)
    return (split_heads(q, num_heads), split_heads(k, num_heads),
            split_heads(v, num_heads))


def split_heads(x: torch.Tensor, num_heads: int) -> torch.Tensor:
    """(B, L, H) -> (B, heads, L, head_dim), a view (no copy): the attention
    kernel reads the heads in place."""
    b, l, h = x.shape
    return x.reshape(b, l, num_heads, h // num_heads).permute(0, 2, 1, 3)


def merge_heads(x: torch.Tensor) -> torch.Tensor:
    """(B, heads, L, head_dim) -> (B, L, H); no copy when x is a view of a
    (B, L, heads, head_dim) tensor, as the kernel's output is."""
    b, n, l, d = x.shape
    return x.permute(0, 2, 1, 3).reshape(b, l, n * d)


def attend_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    bias: Optional[torch.Tensor],
    dropout_generator: Optional[torch.Generator] = None,
    dropout_rate: float = 0.0,
    deterministic: bool = True,
) -> torch.Tensor:
    """Plain attention. q/k/v: (B, heads, L, D); bias broadcastable to
    (B, heads, Lq, Lk)."""
    head_dim = q.shape[-1]
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2))
    scores = scores / math.sqrt(head_dim)
    if bias is not None:
        scores = scores + bias.float()
    probs = torch.softmax(scores, dim=-1)
    if not deterministic and dropout_rate > 0.0:
        keep = 1.0 - dropout_rate
        u = torch.rand(probs.shape, generator=dropout_generator,
                       device=probs.device)
        probs = torch.where(u < keep, probs / keep, torch.zeros_like(probs))
    out = torch.matmul(probs.to(v.dtype).float(), v.float())
    return out.to(v.dtype)


def attend(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    bias: Optional[torch.Tensor],
    dropout_generator: Optional[torch.Generator] = None,
    dropout_rate: float = 0.0,
    deterministic: bool = True,
    use_pallas=False,
) -> torch.Tensor:
    """The attention kernel when the selector names one and the call is
    deterministic (the kernel has no dropout, as in the JAX package);
    otherwise the plain composition."""
    _, _, _, impl = parse_impl(use_pallas, q.device)
    if impl and deterministic:
        from vault_tpu_torch.ops.cuda_attention import fused_attention

        if bias is None:
            b, _, l, _ = q.shape
            bias = torch.zeros((b, 1, 1, l), dtype=torch.float32,
                               device=q.device)
        return fused_attention(q, k, v, bias)
    return attend_plain(q, k, v, bias, dropout_generator, dropout_rate,
                        deterministic)
