"""Fused MLP blocks through the hand-written Hopper kernels
(``csrc/mlp.cu`` forward, ``csrc/mlp_bwd.cu`` backward), with their plain
PyTorch versions beside them.

  * :func:`fused_mlp_block_fwd` (pre-LN, the ViLT layers):
    ``x + m * (act(LN(x) W1 + b1) W2 + b2)``; replaces the JAX package's
    ``fused_mlp_block_fwd`` (``vault_tpu/ops/pallas_mlp.py``).
  * :func:`fused_mlp_postln_fwd` (post-LN, the BERT layers):
    ``LN(x + m * (act(x W1 + b1) W2 + b2))``; replaces
    ``fused_mlp_postln_fwd``.
  * :func:`fused_mlp_block_bwd` and :func:`fused_mlp_postln_block_bwd`:
    the blocks' gradients (GELU), replacing the JAX package's functions of
    the same names; plain versions :func:`mlp_block_bwd_plain` and
    :func:`mlp_postln_bwd_plain`.

The kernel wrappers launch their kernel for CUDA tensors and raise on
anything the kernel does not take; they never fall back.  The dispatchers
:func:`fused_mlp_block` and :func:`fused_mlp_postln_block` run through one
``torch.autograd.Function`` per block (the counterpart of the JAX package's
``custom_vjp``s): it saves only the inputs, and its backward runs the
backward kernel for GELU and autograd of the plain composition for any
other activation, as the JAX package takes the vjp of its XLA composition
there.  For tensors on the CPU the same Function runs the plain forward
(:func:`_mlp_block_plain`, :func:`_mlp_postln_plain`, the counterparts of
``_mlp_block_xla`` and ``_mlp_postln_xla``) and the plain backward.  The
dropout mask is a constant of the draw and gets no gradient.  Each kernel
wrapper counts its launches in ``<wrapper>.launches``.
"""

from __future__ import annotations

import ctypes
import math

import torch

from vault_tpu_torch.ops import _build
from vault_tpu_torch.ops.nn import (
    act_fn,
    dropout_mask,
    gelu,
    layer_norm,
    linear,
    matmul_fp32,
)

HIDDEN_SIZES = (768,)  # H the kernels are built for
I_MULTIPLE = 128            # the intermediate size must be a multiple of this
_ACTS = {"gelu": 0, "gelu_new": 1, "gelu_pytorch_tanh": 1, "relu": 2}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_SIGNATURES = {
    "vt_mlp_fwd": ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 3 + [ctypes.c_float]
                   + [ctypes.c_int] * 3 + [ctypes.c_void_p], ctypes.c_int),
    "vt_mlp_workspace": ([ctypes.c_int] * 3, ctypes.c_longlong),
}
_BWD_SIGNATURES = {
    "vt_mlp_bwd": ([ctypes.c_void_p] * 16 + [ctypes.c_int] * 3 + [ctypes.c_float]
                   + [ctypes.c_int] * 2 + [ctypes.c_void_p], ctypes.c_int),
    "vt_mlp_bwd_workspace": ([ctypes.c_int] * 5, ctypes.c_longlong),
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


def _check(what, x, named, shapes):
    """Every operand: the shape in ``shapes``, x's dtype and device,
    contiguous and 32-byte aligned; x on the card, in a dtype and at sizes
    the kernels take."""
    if not x.is_cuda:
        raise ValueError(f"{what}: the kernel takes CUDA tensors, got {x.device}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"{what}: dtype {x.dtype} not supported "
                        "(bfloat16 or float32)")
    h, i = shapes["w1"]
    if h not in HIDDEN_SIZES or i % I_MULTIPLE:
        raise ValueError(f"{what}: hidden size {h} (supported {HIDDEN_SIZES}) "
                         f"/ intermediate size {i} (a multiple of {I_MULTIPLE})")
    for name, t in named.items():
        if t is None:
            continue
        if tuple(t.shape) != shapes[name]:
            raise ValueError(f"{what}: {name} has shape {tuple(t.shape)}, "
                             f"expected {shapes[name]}")
        if t.dtype != x.dtype or t.device != x.device:
            raise ValueError(f"{what}: {name} is {t.dtype} on {t.device}; all "
                             f"operands must be {x.dtype} on {x.device}")
        if not t.is_contiguous() or t.data_ptr() % 32:
            raise ValueError(f"{what}: {name} must be contiguous and 32-byte "
                             "aligned")


def _shapes(x, w1):
    h, i = x.shape[-1], w1.shape[-1]
    return {"gamma": (h,), "beta": (h,), "w1": (h, i), "b1": (i,),
            "w2": (i, h), "b2": (h,), "x": tuple(x.shape), "m": tuple(x.shape),
            "g": tuple(x.shape)}


def _launch(postln, gamma, beta, w1, b1, w2, b2, x, m, eps, act):
    what = "fused_mlp_postln_fwd" if postln else "fused_mlp_block_fwd"
    if act not in _ACTS:
        raise ValueError(f"{what}: activation {act!r} not supported")
    _check(what, x, {"gamma": gamma, "beta": beta, "w1": w1, "b1": b1, "w2": w2,
                     "b2": b2, "x": x, "m": m}, _shapes(x, w1))
    h, i = w1.shape
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


# ---------------------------------------------------------------------------
# Backward
# ---------------------------------------------------------------------------

def gelu_grad(h: torch.Tensor) -> torch.Tensor:
    """d/dh of the exact GELU: Phi(h) + h phi(h)."""
    cdf = 0.5 * (1.0 + torch.erf(h * (2.0 ** -0.5)))
    pdf = torch.exp(-0.5 * h * h) * (2.0 * math.pi) ** -0.5
    return cdf + h * pdf


def _weight_grads(w1, b1, w2, b2, a1, dh1, a, gout):
    """dW1 = a1^T dh1, db1, dW2 = a^T gout, db2: products and sums with
    fp32 accumulation, cast to the parameters' dtypes (left to XLA in the
    JAX package, to cuBLAS here)."""
    acc = torch.promote_types(dh1.dtype, torch.float32)
    return (matmul_fp32(a1.t(), dh1).to(w1.dtype),
            dh1.to(acc).sum(0).to(b1.dtype),
            matmul_fp32(a.t(), gout).to(w2.dtype),
            gout.to(acc).sum(0).to(b2.dtype))


def mlp_block_bwd_plain(gamma, beta, w1, b1, w2, b2, x, g, m=None,
                        eps: float = 1e-12):
    """Gradients of ``x + m*(gelu(LN(x) W1 + b1) W2 + b2)`` w.r.t. every
    input but the mask, written out with the Pallas kernel's cast points
    (yc, ac, the masked cotangent gc, dh1c).  Returns (dgamma, dbeta, dw1,
    db1, dw2, db2, dx)."""
    dt, shape, h = x.dtype, x.shape, x.shape[-1]
    acc = torch.promote_types(dt, torch.float32)
    xf = x.reshape(-1, h).to(acc)
    gf = g.reshape(-1, h).to(acc)
    mean = xf.mean(-1, keepdim=True)
    rstd = torch.rsqrt(((xf - mean) ** 2).mean(-1, keepdim=True) + eps)
    xhat = (xf - mean) * rstd
    yc = (xhat * gamma.to(acc) + beta.to(acc)).to(dt)
    h1 = matmul_fp32(yc, w1) + b1.to(acc)
    ac = gelu(h1).to(dt)
    gm = gf if m is None else gf * m.reshape(-1, h).to(acc)
    gc = gm.to(dt)
    dh1c = (matmul_fp32(gc, w2.t()) * gelu_grad(h1)).to(dt)
    dy = matmul_fp32(dh1c, w1.t())
    dxhat = dy * gamma.to(acc)
    m1 = dxhat.mean(-1, keepdim=True)
    m2 = (dxhat * xhat).mean(-1, keepdim=True)
    dx = (gf + (dxhat - m1 - xhat * m2) * rstd).to(dt)
    dgamma, dbeta = (dy * xhat).sum(0), dy.sum(0)
    return (dgamma.to(gamma.dtype), dbeta.to(beta.dtype),
            *_weight_grads(w1, b1, w2, b2, yc, dh1c, ac, gc),
            dx.reshape(shape))


def mlp_postln_bwd_plain(gamma, beta, w1, b1, w2, b2, x, g, m=None,
                         eps: float = 1e-12):
    """Gradients of ``LN(x + m*(gelu(x W1 + b1) W2 + b2))``: the LN
    backward first, then the masked MLP chain, with the Pallas kernel's
    cast points (ac, dmlpc, dh1c).  Returns (dgamma, dbeta, dw1, db1, dw2,
    db2, dx)."""
    dt, shape, h = x.dtype, x.shape, x.shape[-1]
    acc = torch.promote_types(dt, torch.float32)
    x2 = x.reshape(-1, h)
    gf = g.reshape(-1, h).to(acc)
    mf = None if m is None else m.reshape(-1, h).to(acc)
    h1 = matmul_fp32(x2, w1) + b1.to(acc)
    ac = gelu(h1).to(dt)
    mlp = matmul_fp32(ac, w2) + b2.to(acc)
    if mf is not None:
        mlp = mlp * mf
    s = x2.to(acc) + mlp
    mean = s.mean(-1, keepdim=True)
    rstd = torch.rsqrt(((s - mean) ** 2).mean(-1, keepdim=True) + eps)
    shat = (s - mean) * rstd
    dshat = gf * gamma.to(acc)
    m1 = dshat.mean(-1, keepdim=True)
    m2 = (dshat * shat).mean(-1, keepdim=True)
    ds = (dshat - m1 - shat * m2) * rstd
    dmlpc = (ds if mf is None else ds * mf).to(dt)
    dh1c = (matmul_fp32(dmlpc, w2.t()) * gelu_grad(h1)).to(dt)
    dx = (ds + matmul_fp32(dh1c, w1.t())).to(dt)
    dgamma, dbeta = (gf * shat).sum(0), gf.sum(0)
    return (dgamma.to(gamma.dtype), dbeta.to(beta.dtype),
            *_weight_grads(w1, b1, w2, b2, x2, dh1c, ac, dmlpc),
            dx.reshape(shape))


def _launch_bwd(postln, gamma, beta, w1, b1, w2, b2, x, g, m, eps):
    what = "fused_mlp_postln_block_bwd" if postln else "fused_mlp_block_bwd"
    _check(what, x, {"gamma": gamma, "beta": beta, "w1": w1, "b1": b1,
                     "w2": w2, "b2": b2, "x": x, "g": g, "m": m},
           _shapes(x, w1))
    h, i = w1.shape
    rows = x.numel() // h
    lib = _build.load("mlp_bwd", _BWD_SIGNATURES)
    dev, dt = x.device, x.dtype
    dx = torch.empty_like(x)
    dh1 = torch.empty((rows, i), dtype=dt, device=dev)
    a = torch.empty((rows, i), dtype=dt, device=dev)
    yds = torch.empty((rows, h), dtype=dt, device=dev)  # y, or ds post-LN
    dgamma = torch.empty(h, dtype=torch.float32, device=dev)
    dbeta = torch.empty(h, dtype=torch.float32, device=dev)
    ws = torch.empty(lib.vt_mlp_bwd_workspace(rows, h, i, _DTYPES[dt],
                                              int(postln)),
                     dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    code = lib.vt_mlp_bwd(
        x.data_ptr(), g.data_ptr(), gamma.data_ptr(), beta.data_ptr(),
        w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), b2.data_ptr(),
        None if m is None else m.data_ptr(), dx.data_ptr(), dh1.data_ptr(),
        a.data_ptr(), yds.data_ptr(), dgamma.data_ptr(), dbeta.data_ptr(),
        ws.data_ptr(), rows, h, i, float(eps), int(postln), _DTYPES[dt], stream)
    _build.check(lib, code, what)
    return dx, dh1, a, yds, dgamma, dbeta


def fused_mlp_block_bwd(gamma, beta, w1, b1, w2, b2, x, g, m=None,
                        eps: float = 1e-12):
    """Gradients of ``x + m*(gelu(LN(x) W1 + b1) W2 + b2)`` through the
    backward kernel (``m``: optional pre-scaled dropout mask, a constant).
    Returns (dgamma, dbeta, dw1, db1, dw2, db2, dx)."""
    dx, dh1, a, y, dgamma, dbeta = _launch_bwd(False, gamma, beta, w1, b1, w2,
                                               b2, x, g, m, eps)
    fused_mlp_block_bwd.launches += 1
    h = x.shape[-1]
    g2 = g.reshape(-1, h)
    gm = g2 if m is None else (g2.float() * m.reshape(-1, h).float()).to(g.dtype)
    return (dgamma.to(gamma.dtype), dbeta.to(beta.dtype),
            *_weight_grads(w1, b1, w2, b2, y, dh1, a, gm), dx)


def fused_mlp_postln_block_bwd(gamma, beta, w1, b1, w2, b2, x, g, m=None,
                               eps: float = 1e-12):
    """Gradients of ``LN(x + m*(gelu(x W1 + b1) W2 + b2))`` through the
    backward kernel.  Returns (dgamma, dbeta, dw1, db1, dw2, db2, dx)."""
    dx, dh1, a, ds, dgamma, dbeta = _launch_bwd(True, gamma, beta, w1, b1, w2,
                                                b2, x, g, m, eps)
    fused_mlp_postln_block_bwd.launches += 1
    return (dgamma.to(gamma.dtype), dbeta.to(beta.dtype),
            *_weight_grads(w1, b1, w2, b2, x.reshape(-1, x.shape[-1]), dh1, a,
                           ds), dx)


fused_mlp_block_bwd.launches = 0
fused_mlp_postln_block_bwd.launches = 0


class _FusedMLP(torch.autograd.Function):
    """One fused MLP block, pre-LN or post-LN, differentiable.  Forward
    saves only the inputs; backward recomputes inside the backward kernel
    (GELU) or through autograd of the plain composition (other
    activations).  The mask gets no gradient."""

    @staticmethod
    def forward(ctx, gamma, beta, w1, b1, w2, b2, x, m, eps, act, postln):
        ctx.save_for_backward(gamma, beta, w1, b1, w2, b2, x, m)
        ctx.eps, ctx.act, ctx.postln = eps, act, postln
        if x.device.type == "cpu":
            plain = _mlp_postln_plain if postln else _mlp_block_plain
            return plain({"scale": gamma, "bias": beta}, {"w": w1, "b": b1},
                         {"w": w2, "b": b2}, x, eps, act, m)
        kernel = fused_mlp_postln_fwd if postln else fused_mlp_block_fwd
        return kernel(gamma, beta, w1, b1, w2, b2, x, m, eps=eps, act=act)

    @staticmethod
    def backward(ctx, g):
        gamma, beta, w1, b1, w2, b2, x, m = ctx.saved_tensors
        ins = (gamma, beta, w1, b1, w2, b2, x)
        if ctx.act == "gelu":
            g = g.contiguous()
            if x.device.type == "cpu":
                bwd = mlp_postln_bwd_plain if ctx.postln else mlp_block_bwd_plain
            else:
                bwd = (fused_mlp_postln_block_bwd if ctx.postln
                       else fused_mlp_block_bwd)
            grads = bwd(*ins, g, m, eps=ctx.eps)
        else:
            plain = _mlp_postln_plain if ctx.postln else _mlp_block_plain
            with torch.enable_grad():
                leaves = [t.detach().requires_grad_() for t in ins]
                out = plain({"scale": leaves[0], "bias": leaves[1]},
                            {"w": leaves[2], "b": leaves[3]},
                            {"w": leaves[4], "b": leaves[5]}, leaves[6],
                            ctx.eps, ctx.act, m)
                grads = torch.autograd.grad(out, leaves, g)
        return (*grads, None, None, None, None)


def fused_mlp_block(ln_p, p_in, p_out, x, eps: float = 1e-12,
                    act: str = "gelu", drop_mask=None) -> torch.Tensor:
    """The pre-LN MLP half of a ViLT layer, differentiable: the kernels for
    CUDA tensors, the plain versions for CPU tensors.  ``drop_mask``:
    optional pre-scaled dropout mask on the MLP output."""
    return _FusedMLP.apply(ln_p["scale"], ln_p["bias"], p_in["w"], p_in["b"],
                           p_out["w"], p_out["b"], x, drop_mask, eps, act, False)


def fused_mlp_postln_block(ln_p, p_in, p_out, x, eps: float = 1e-12,
                           act: str = "gelu", drop_mask=None) -> torch.Tensor:
    """The post-LN MLP half of a BERT layer, differentiable: the kernels for
    CUDA tensors, the plain versions for CPU tensors."""
    return _FusedMLP.apply(ln_p["scale"], ln_p["bias"], p_in["w"], p_in["b"],
                           p_out["w"], p_out["b"], x, drop_mask, eps, act, True)


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
