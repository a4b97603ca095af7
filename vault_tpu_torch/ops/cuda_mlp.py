"""Fused MLP blocks through the hand-written Hopper kernels
(``csrc/mlp.cu``), with their plain PyTorch versions beside them.

  * :func:`fused_mlp_block_fwd` (pre-LN, the ViLT layers):
    ``x + m * (act(LN(x) W1 + b1) W2 + b2)``; replaces the JAX package's
    ``fused_mlp_block_fwd`` (``vault_tpu/ops/pallas_mlp.py``).
  * :func:`fused_mlp_postln_fwd` (post-LN, the BERT layers):
    ``LN(x + m * (act(x W1 + b1) W2 + b2))``; replaces
    ``fused_mlp_postln_fwd``.

Both launch their kernel for CUDA tensors and raise on anything the kernel
does not take; they never fall back.  The dispatchers
:func:`fused_mlp_block` and :func:`fused_postln_mlp` take the plain
versions (:func:`_mlp_block_plain`, :func:`_mlp_postln_plain`, the
counterparts of the JAX package's ``_mlp_block_xla`` and
``_mlp_postln_xla``) only for tensors on the CPU.  Each kernel wrapper
counts its launches in ``<wrapper>.launches``.
"""

from __future__ import annotations

import ctypes

import torch

from vault_tpu_torch.ops import _build
from vault_tpu_torch.ops.nn import act_fn, dropout_mask, layer_norm, linear

HIDDEN_SIZES = (768,)  # H the kernels are built for
I_MULTIPLE = 128            # the intermediate size must be a multiple of this
_ACTS = {"gelu": 0, "gelu_new": 1, "gelu_pytorch_tanh": 1, "relu": 2}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_SIGNATURES = {
    "vt_mlp_fwd": ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 3 + [ctypes.c_float]
                   + [ctypes.c_int] * 3 + [ctypes.c_void_p], ctypes.c_int),
    "vt_mlp_workspace": ([ctypes.c_int] * 3, ctypes.c_longlong),
}


def _mlp_block_plain(ln_p, p_in, p_out, x, eps, act, m=None):
    """Plain pre-LN MLP half of a ViLT layer.  ``m``: optional pre-scaled
    dropout mask applied to the MLP output."""
    y = layer_norm(ln_p, x, eps)
    mlp = linear(p_out, act_fn(act)(linear(p_in, y)))
    if m is not None:
        mlp = mlp * m
    return x + mlp


def _mlp_postln_plain(ln_p, p_in, p_out, x, eps, act, m=None):
    """Plain post-LN MLP half of a BERT layer (HF BertIntermediate +
    BertOutput).  ``m``: optional pre-scaled dropout mask."""
    mlp = linear(p_out, act_fn(act)(linear(p_in, x)))
    if m is not None:
        mlp = mlp * m
    return layer_norm(ln_p, x + mlp, eps)


def _launch(postln, gamma, beta, w1, b1, w2, b2, x, m, eps, act):
    what = "fused_mlp_postln_fwd" if postln else "fused_mlp_block_fwd"
    if not x.is_cuda:
        raise ValueError(f"{what}: the kernel takes CUDA tensors, got {x.device}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"{what}: dtype {x.dtype} not supported "
                        "(bfloat16 or float32)")
    if act not in _ACTS:
        raise ValueError(f"{what}: activation {act!r} not supported")
    h = x.shape[-1]
    i = w1.shape[-1]
    if h not in HIDDEN_SIZES or i % I_MULTIPLE:
        raise ValueError(f"{what}: hidden size {h} (supported {HIDDEN_SIZES}) "
                         f"/ intermediate size {i} (a multiple of {I_MULTIPLE})")
    shapes = {"gamma": (h,), "beta": (h,), "w1": (h, i), "b1": (i,),
              "w2": (i, h), "b2": (h,)}
    named = {"gamma": gamma, "beta": beta, "w1": w1, "b1": b1, "w2": w2,
             "b2": b2, "x": x}
    if m is not None:
        shapes["m"] = tuple(x.shape)
        named["m"] = m
    for name, t in named.items():
        if name in shapes and tuple(t.shape) != shapes[name]:
            raise ValueError(f"{what}: {name} has shape {tuple(t.shape)}, "
                             f"expected {shapes[name]}")
        if t.dtype != x.dtype or t.device != x.device:
            raise ValueError(f"{what}: {name} is {t.dtype} on {t.device}; all "
                             f"operands must be {x.dtype} on {x.device}")
        if not t.is_contiguous() or t.data_ptr() % 32:
            raise ValueError(f"{what}: {name} must be contiguous and 32-byte "
                             "aligned")
    rows = x.numel() // h
    lib = _build.load("mlp", _SIGNATURES)
    out = torch.empty_like(x)
    # fp32 partial sums of the I splits (the kernel picks the split count)
    ws = torch.empty(lib.vt_mlp_workspace(rows, h, i), dtype=torch.float32,
                     device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    code = lib.vt_mlp_fwd(x.data_ptr(), gamma.data_ptr(), beta.data_ptr(),
                          w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
                          b2.data_ptr(), None if m is None else m.data_ptr(),
                          out.data_ptr(), ws.data_ptr(), rows, h, i, float(eps),
                          _ACTS[act], int(postln), _DTYPES[x.dtype], stream)
    _build.check(lib, code, what)
    return out


def fused_mlp_block_fwd(gamma, beta, w1, b1, w2, b2, x, m=None,
                        eps: float = 1e-12, act: str = "gelu") -> torch.Tensor:
    """Pre-LN block kernel.  x: (..., H) -> same shape."""
    out = _launch(False, gamma, beta, w1, b1, w2, b2, x, m, eps, act)
    fused_mlp_block_fwd.launches += 1
    return out


def fused_mlp_postln_fwd(gamma, beta, w1, b1, w2, b2, x, m=None,
                         eps: float = 1e-12, act: str = "gelu") -> torch.Tensor:
    """Post-LN block kernel.  x: (..., H) -> same shape."""
    out = _launch(True, gamma, beta, w1, b1, w2, b2, x, m, eps, act)
    fused_mlp_postln_fwd.launches += 1
    return out


fused_mlp_block_fwd.launches = 0
fused_mlp_postln_fwd.launches = 0


def fused_mlp_block(ln_p, p_in, p_out, x, eps: float = 1e-12,
                    act: str = "gelu", drop_mask=None) -> torch.Tensor:
    """The pre-LN MLP half of a ViLT layer: the plain version for a CPU
    tensor, the kernel otherwise.  ``drop_mask``: optional pre-scaled
    dropout mask on the MLP output."""
    if x.device.type == "cpu":
        return _mlp_block_plain(ln_p, p_in, p_out, x, eps, act, drop_mask)
    return fused_mlp_block_fwd(ln_p["scale"], ln_p["bias"], p_in["w"],
                               p_in["b"], p_out["w"], p_out["b"], x,
                               drop_mask, eps=eps, act=act)


def fused_mlp_postln_block(ln_p, p_in, p_out, x, eps: float = 1e-12,
                           act: str = "gelu", drop_mask=None) -> torch.Tensor:
    """The post-LN MLP half of a BERT layer: the plain version for a CPU
    tensor, the kernel otherwise."""
    if x.device.type == "cpu":
        return _mlp_postln_plain(ln_p, p_in, p_out, x, eps, act, drop_mask)
    return fused_mlp_postln_fwd(ln_p["scale"], ln_p["bias"], p_in["w"],
                                p_in["b"], p_out["w"], p_out["b"], x,
                                drop_mask, eps=eps, act=act)


def fused_postln_mlp(lp, cfg, x, generator, deterministic: bool) -> torch.Tensor:
    """The BERT-layer-shaped dispatch: draw the pre-scaled dropout mask (in
    x's dtype) when training, then run the post-LN block."""
    mask = None
    if not deterministic and cfg.hidden_dropout_prob > 0.0:
        mask = dropout_mask(generator, x.shape, cfg.hidden_dropout_prob,
                            x.dtype, x.device)
    return fused_mlp_postln_block(lp["mlp_ln"], lp["mlp_in"], lp["mlp_out"],
                                  x, cfg.layer_norm_eps, cfg.hidden_act,
                                  drop_mask=mask)
