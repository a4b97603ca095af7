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

from vault_tpu_torch.ops.nn import dropout, linear

# What "auto" resolves to for CUDA tensors: the fused (H, 3H) QKV product,
# the fused MLP-block kernels and the attention kernel.  On the CPU "auto"
# is False (the plain composition), as the JAX package resolves it off-TPU.
CUDA_DEFAULT_IMPL = "fuseqkv+fusemlp+batched"


def parse_impl(use_pallas, device: Optional[torch.device] = None):
    """The ``use_pallas`` knob is an implementation selector: False (plain),
    True/"batched"/"grid"/"dotbatch" (the attention kernel; the three names
    of the JAX package all select the one kernel); "+"-combinable modifiers:
    "fuseqkv" computes Q/K/V with one fused (H, 3H) product, "fuselnqkv"
    additionally folds the pre-LN LayerNorm into it (ops/cuda_ln_qkv.py;
    the pre-LN ViLT layers only, as in the JAX package), "fusemlp" runs the
    MLP halves through the fused MLP-block kernels (ops/cuda_mlp.py).  "auto" resolves to CUDA_DEFAULT_IMPL when
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
    fp32 accumulation, so numerically identical).  Quantized weights
    (ops/quantize.py w8 ``w_q`` / w8a8 ``w_q8``) fuse the same way: weights
    and per-out-channel scales concatenated along out; w8a8 then quantizes
    the activations once (the per-row scale is the same y's either way)."""
    wk = next((k for k in ("w", "w_q", "w_q8") if k in lp["q"]), None)
    if fuse and wk is not None:
        fused = {wk: torch.cat([lp["q"][wk], lp["k"][wk], lp["v"][wk]], dim=1)}
        if wk != "w":
            fused["w_scale"] = torch.cat([lp["q"]["w_scale"], lp["k"]["w_scale"],
                                          lp["v"]["w_scale"]], dim=-1)
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
    # the heads axis: under tensor parallelism each rank keeps its heads'
    # block of the whole layer's mask (ops/nn.py ``shard_draws``)
    probs = dropout(dropout_generator, probs, dropout_rate, deterministic,
                    heads_axis=1)
    out = torch.matmul(probs.to(v.dtype).float(), v.float())
    return out.to(v.dtype)


def gqa_attend_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     bias: Optional[torch.Tensor], rep: int) -> torch.Tensor:
    """Grouped-query attention without repeated K/V (the JAX package's
    ``_gqa_attend``): q (B, H, L, D) against k/v (B, H // rep, L, D), query
    head ``i`` on K/V head ``i // rep``, the group folded into the batch
    dims of the two products.  ``bias``: (B or 1, 1, Lq, Lk), shared by the
    heads, or per head (B, H, Lq, Lk).  fp32 scores and softmax, the
    probabilities cast to v's type before the second product."""
    b, h, l, d = q.shape
    g = h // rep
    qg = q.reshape(b, g, rep, l, d)
    scores = torch.matmul(qg.float(), k.float()[:, :, None].transpose(-1, -2))
    scores = scores / math.sqrt(d)
    if bias is not None:
        if bias.shape[1] == 1:
            bias5 = bias[:, :, None]
        else:
            bias5 = bias.reshape(bias.shape[0], g, rep, *bias.shape[2:])
        scores = scores + bias5.float()
    probs = torch.softmax(scores, dim=-1)
    out = torch.matmul(probs.to(v.dtype).float(), v.float()[:, :, None])
    return out.to(v.dtype).reshape(b, h, l, d)


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
