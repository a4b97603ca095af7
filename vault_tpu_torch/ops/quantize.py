"""Int8 quantization for serving (port of ``vault_tpu/ops/quantize.py``):
weight-only (w8) and weight+activation (w8a8).

  * **w8**: encoder linear weights stored int8 with per-output-channel fp32
    scales; :func:`~vault_tpu_torch.ops.nn.linear` dequantizes them to the
    activation's type and runs the product there.
  * **w8a8**: activations are quantized too, per row (absmax over the
    feature dim) at each linear, and the product is int8 x int8 -> int32.
    Inference only: the round in the activation quantization has zero
    gradient.

Embeddings, LayerNorms, biases, the patch projection, position grids, the
pooler, the heads and the attention core stay in floating point.

The form is encoded in the parameter names, as in the JAX package: ``w_q``
and ``w_scale`` select w8, ``w_q8`` and ``w_scale`` select w8a8.

Layout: every leaf keeps the JAX package's (in, out) shape.  The w8a8
codes of every quantized projection (:data:`K_MAJOR_SUBLAYERS`: the Llama
layer's q/k/v/o and MLP, BERT's and ViLT's q/k/v, ``attn_out``,
``mlp_in``/``mlp_out``) are held K-major: the (in, out) leaf is a
transposed view of contiguous (out, in) storage (:func:`k_major`), the
layout the int8 ``wgmma`` of the w8a8 kernels reads (``ops/cuda_linear.py``,
``ops/cuda_ln_qkv.py``, ``ops/cuda_swiglu.py``, ``ops/cuda_mlp.py``; the
int8 forms have no transpose bit).  They are laid out so once, where they
are quantized (here) or converted (``convert.params_from_jax``), never per
call.  The w8 codes stay row-major.  ``torch._int_mm`` takes either
layout.

Rounding is half to even (``torch.round``, as ``jnp.round``), codes are
clipped to +-127, and both divisions are true divisions.  On the card a
division by a Python number is a multiplication by its reciprocal in
PyTorch, which gives other scales in about one row in twenty, so the
divisor 127 is a tensor there.  (The JAX package divides too when it runs
op by op; under ``jit`` XLA multiplies by 1/127 instead.)
"""

from __future__ import annotations

from typing import Mapping

import torch
from torch import nn

from vault_tpu_torch.ops.nn import ParamDict

# sublayer names whose (in, out)-shaped weights are worth quantizing
QUANT_SUBLAYERS = {"q", "k", "v", "attn_out", "mlp_in", "mlp_out",
                   "o", "gate", "up", "down"}
QUANT_MODES = ("w8", "w8a8")
# sublayers whose w8a8 codes are held K-major, the layout the int8 kernels
# take: every quantized one
K_MAJOR_SUBLAYERS = frozenset(QUANT_SUBLAYERS)


def k_major(q: torch.Tensor) -> torch.Tensor:
    """(..., in, out) codes as a transposed view of a contiguous (..., out,
    in) copy: the same values and shape, K (in) contiguous."""
    return q.transpose(-1, -2).contiguous().transpose(-1, -2)


def is_k_major(q: torch.Tensor) -> bool:
    """A matrix whose first dimension (K) is contiguous: a transposed view
    of contiguous storage."""
    return q.dim() == 2 and q.t().is_contiguous()


def k_major_site(key, mode: str) -> bool:
    """Whether the ``mode`` codes of sublayer ``key`` are held K-major."""
    return mode == "w8a8" and key in K_MAJOR_SUBLAYERS


def _scale(absmax: torch.Tensor) -> torch.Tensor:
    """max(absmax, 1e-8) / 127 as a true division, on any device."""
    m = torch.clamp_min(absmax, 1e-8)
    return m / torch.full_like(m, 127.0)


def _codes(xf: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)


def quantize_weight(w: torch.Tensor):
    """(..., in, out) float -> (int8 values, per-out-channel fp32 scales
    (..., 1, out))."""
    wf = w.detach().float()
    scale = _scale(wf.abs().amax(dim=-2, keepdim=True))
    return _codes(wf, scale), scale


def dequantize_weight(q: torch.Tensor, scale: torch.Tensor,
                      dtype=torch.bfloat16) -> torch.Tensor:
    return (q.float() * scale).to(dtype)


def quantize_activation(x: torch.Tensor):
    """(..., rows, features) float -> (int8 values, per-row fp32 scales
    (..., rows, 1)).  The scale keeps its gradient (through the absmax);
    the codes have none."""
    xf = x.float()
    scale = _scale(xf.abs().amax(dim=-1, keepdim=True))
    return _codes(xf.detach(), scale.detach()), scale


def quantize_linear_params(p, mode: str = "w8", codes_k_major: bool = False) -> dict:
    """{"w", "b"?} -> {"w_q" or "w_q8", "w_scale", "b"?} (a new dict); the
    codes K-major (:func:`k_major`) when ``codes_k_major``."""
    q, scale = quantize_weight(p["w"])
    if codes_k_major:
        q = k_major(q)
    out = {("w_q8" if mode == "w8a8" else "w_q"): q, "w_scale": scale}
    if "b" in p:
        out["b"] = p["b"]
    return out


def _quantize_module(mod: ParamDict, mode: str, codes_k_major: bool) -> None:
    """Replace a linear module's ``w`` parameter by its quantized pair, in
    place: the int8 codes (no gradient) and the fp32 scales."""
    q = quantize_linear_params({"w": mod["w"]}, mode, codes_k_major)
    del mod._parameters["w"]
    for k, v in q.items():
        setattr(mod, k, nn.Parameter(v, requires_grad=v.is_floating_point()))


def quantize_model_params(params, path_filter=None, mode: str = "w8"):
    """Quantize every encoder linear (the sublayers named in
    QUANT_SUBLAYERS) of a parameter tree.  A plain nested dict gives a new
    dict with {w_q, w_scale} (mode "w8") or {w_q8, w_scale} (mode "w8a8")
    in place of {w} at those sites, as the JAX package's function does; a
    module tree (``ParamDict``, ``nn.ModuleList``) is changed in place and
    returned.  The w8a8 codes of :data:`K_MAJOR_SUBLAYERS` come K-major."""
    if mode not in QUANT_MODES:
        raise ValueError(f"unknown quantization mode {mode!r}")

    def take(node, key) -> bool:
        return (key in QUANT_SUBLAYERS and "w" in node and node["w"].ndim >= 2
                and (path_filter is None or path_filter(key)))

    def walk(node, key=None):
        if isinstance(node, ParamDict):
            if take(node, key):
                _quantize_module(node, mode, k_major_site(key, mode))
            else:
                for k, child in node.named_children():
                    walk(child, k)
            return node
        if isinstance(node, nn.Module):  # ModuleList: no key, as a list
            for child in node.children():
                walk(child)
            return node
        if isinstance(node, Mapping):
            if take(node, key):
                return quantize_linear_params(node, mode, k_major_site(key, mode))
            return {k: walk(v, k) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v) for v in node)
        return node

    return walk(params)


def quantized_bytes(params) -> int:
    """Bytes of every tensor in a parameter tree (a module or nested
    dicts, lists and tensors)."""
    if isinstance(params, nn.Module):
        return sum(t.numel() * t.element_size()
                   for t in list(params.parameters()) + list(params.buffers()))
    if isinstance(params, Mapping):
        return sum(quantized_bytes(v) for v in params.values())
    if isinstance(params, (list, tuple)):
        return sum(quantized_bytes(v) for v in params)
    return params.numel() * params.element_size()
