"""Fused MLP blocks through the hand-written Hopper kernels
(``csrc/mlp.cu`` forward, fp and int8 weights, ``csrc/mlp_bwd.cu`` backward,
``csrc/mlp_w8a8.cu`` int8 forward), with their plain PyTorch versions beside
them.

Two designs sit behind ``csrc/mlp.cu`` and ``csrc/mlp_bwd.cu``, each
behind its own C entries; :func:`mlp_route` picks one for a block: every
bf16 block with bf16 weights, pre-LN (the ViLT layers) and post-LN (the
BERT layers), runs forward and backward on the wgmma/TMA GEMM core
(``csrc/gemm_sm90.cuh``, ``vt_mlp_fwd_wgmma`` / ``vt_mlp_bwd_wgmma``), its
(rows, I) intermediates through device memory, and so do the bf16 blocks
with int8 weights, pre-LN and post-LN (``vt_mlp_fwd_q8_wgmma``: one pass
dequantizes both weight matrices to bf16 scratch in front of the same
launches); fp32 blocks, int8 weights or not, run the same shape of
launches on fp32 FMA tiles (``csrc/gemm_tiles.cuh`` ``gemm_tiles``:
``vt_mlp_fwd``, ``vt_mlp_fwd_q8``, ``vt_mlp_bwd``).  The w8a8 blocks, bf16 and fp32
alike, run on the int8 instance of the same core (:func:`w8a8_route`,
``vt_mlp_w8a8``), their weight codes held K-major (``ops/quantize.py``
``k_major``).  Each design has its width contract (:func:`_check_sizes`); a
width outside it raises ``ValueError`` before anything is built or
launched.

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
  * :func:`fused_mlp_block_fwd_w8a8` and :func:`fused_mlp_postln_fwd_w8a8`:
    both blocks with int8 weights and activations (ops/quantize.py w8a8),
    replacing the JAX package's functions of the same names; plain versions
    :func:`mlp_block_w8a8_plain` and :func:`mlp_postln_w8a8_plain`, with the
    kernels' cast points, on either layout of the codes.  The kernels take
    the codes K-major only and refuse them otherwise: nothing is transposed
    per call.  Inference serving: their gradient is autograd of the XLA
    composition (``linear``'s w_q8 branch), as in the JAX package.
  * :func:`fused_mlp_block_fwd_q8` and :func:`fused_mlp_postln_fwd_q8`: both
    blocks with int8 weights only (ops/quantize.py w8), replacing the JAX
    package's functions of the same names: the bf16 blocks dequantize both
    matrices in one pass to bf16 scratch in front of the core's launches,
    the fp32 ones to fp32 scratch in front of the tiles' launches; plain versions
    :func:`mlp_block_q8_plain` and :func:`mlp_postln_q8_plain`.  Their gradient is autograd of the plain
    composition with ``w_q`` weights: to the LN, both scales, both biases
    and x, none to the codes.

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
wrapper counts its launches in ``<wrapper>.launches``.  Each forward kernel
with its plain version is also an operator (``ops/_dispatch.py``
``KernelOp``: ``vault_tpu_torch::mlp_block``, ``mlp_postln`` and their
``_q8`` and ``_w8a8`` forms), through which the forward launches it, in
eager mode and in an exported program alike.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from vault_tpu_torch.ops import _build
from vault_tpu_torch.ops._dispatch import KernelOp, check_operands, kernel_or_plain, like
from vault_tpu_torch.ops.nn import (
    act_fn,
    dropout_mask,
    gelu,
    int8_matmul,
    layer_norm,
    layer_norm_f32,
    linear_plain,
    matmul_fp32,
)
from vault_tpu_torch.ops.quantize import is_k_major, quantize_activation

# The widths each design takes.  The wgmma core (its q8 blocks included): H
# a multiple of 64 from 64 to 8,192, I a multiple of 64 (each product's K a
# multiple of the core's 64-deep stage, 16-byte TMA rows, the row kernels'
# 8,192).  The w8a8 blocks on its int8 instance: H and I multiples of 128
# (the int8 stage is 128 deep), H up to 8,192 (the row passes hold a row in
# registers) and I up to 32,768 (so does the requantization pass, a row of
# the activation).  The fp32 tiles: H and I multiples of 128 (both products'
# output widths are tile widths of gemm_tiles), H up to 8,192 (the row
# passes hold a row in registers).
CORE_H_MULTIPLE, CORE_H_MAX, CORE_I_MULTIPLE = 64, 8192, 64
W8A8_MULTIPLE, W8A8_H_MAX, W8A8_I_MAX = 128, 8192, 32768
TILES_MULTIPLE, TILES_H_MAX = 128, 8192
_ACTS = {"gelu": 0, "gelu_new": 1, "gelu_pytorch_tanh": 1, "relu": 2}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_SIGNATURES = {
    "vt_mlp_fwd": ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 3 + [ctypes.c_float]
                   + [ctypes.c_int] * 3 + [ctypes.c_void_p], ctypes.c_int),
    "vt_mlp_fwd_q8": ([ctypes.c_void_p] * 11 + [ctypes.c_int] * 3 + [ctypes.c_float]
                      + [ctypes.c_int] * 3 + [ctypes.c_void_p], ctypes.c_int),
    "vt_mlp_workspace": ([ctypes.c_int] * 5, ctypes.c_longlong),
    "vt_mlp_fwd_wgmma": ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 3 + [ctypes.c_float]
                         + [ctypes.c_int] * 2 + [ctypes.c_void_p], ctypes.c_int),
    "vt_mlp_wgmma_workspace": ([ctypes.c_int] * 4, ctypes.c_longlong),
    "vt_mlp_fwd_q8_wgmma": ([ctypes.c_void_p] * 11 + [ctypes.c_int] * 3 + [ctypes.c_float]
                            + [ctypes.c_int] * 2 + [ctypes.c_void_p], ctypes.c_int),
    "vt_mlp_q8_wgmma_workspace": ([ctypes.c_int] * 4, ctypes.c_longlong),
}
_BWD_SIGNATURES = {
    "vt_mlp_bwd": ([ctypes.c_void_p] * 16 + [ctypes.c_int] * 3 + [ctypes.c_float]
                   + [ctypes.c_int] * 2 + [ctypes.c_void_p], ctypes.c_int),
    "vt_mlp_bwd_workspace": ([ctypes.c_int] * 5, ctypes.c_longlong),
    "vt_mlp_bwd_wgmma": ([ctypes.c_void_p] * 16 + [ctypes.c_int] * 3 + [ctypes.c_float]
                         + [ctypes.c_int, ctypes.c_void_p], ctypes.c_int),
    "vt_mlp_bwd_wgmma_workspace": ([ctypes.c_int] * 4, ctypes.c_longlong),
}


def mlp_route(dtype: torch.dtype, int8_weights: bool = False, postln: bool = False) -> str:
    """Which design runs a block with activations in ``dtype`` on the card:
    "wgmma" (the ``*_wgmma`` C entries) for every bf16 block, forward and
    backward, pre-LN and post-LN, with bf16 weights or int8 ones
    (``vt_mlp_fwd_q8_wgmma``, behind its dequantization pass); "tiles"
    (the same launches on fp32 FMA tiles, ``gemm_tiles``: ``vt_mlp_fwd``,
    ``vt_mlp_bwd``, ``vt_mlp_fwd_q8``) for fp32.  The wrappers launch the entries it names
    and hold a block to its width contract.  ``int8_weights`` and
    ``postln`` name the block; neither moves it off its dtype's design."""
    if dtype not in _DTYPES:
        raise TypeError(f"mlp_route: dtype {dtype} not supported (bfloat16 or float32)")
    return "wgmma" if dtype == torch.bfloat16 else "tiles"


def _mlp_block_plain(ln_p, p_in, p_out, x, eps, act, m=None):
    """Plain pre-LN MLP half of a ViLT layer.  ``m``: optional pre-scaled
    dropout mask applied to the MLP output."""
    y = layer_norm(ln_p, x, eps)
    mlp = linear_plain(p_out, act_fn(act)(linear_plain(p_in, y)))
    if m is not None:
        mlp = mlp * m
    return x + mlp


def _mlp_postln_plain(ln_p, p_in, p_out, x, eps, act, m=None):
    """Plain post-LN MLP half of a BERT layer (HF BertIntermediate +
    BertOutput).  ``m``: optional pre-scaled dropout mask."""
    mlp = linear_plain(p_out, act_fn(act)(linear_plain(p_in, x)))
    if m is not None:
        mlp = mlp * m
    return layer_norm(ln_p, x + mlp, eps)


def w8a8_route(dtype: torch.dtype) -> str:
    """Which design runs a w8a8 block (pre-LN or post-LN) with x in
    ``dtype`` on the card: "wgmma", the int8 instance of the core (s8 x s8
    -> s32 ``wgmma`` through TMA, ``vt_mlp_w8a8``), for bf16 and fp32 alike:
    the products are exact in int32, and only the row passes' and the
    epilogues' casts depend on the type."""
    if dtype not in _DTYPES:
        raise TypeError(f"w8a8_route: dtype {dtype} not supported (bfloat16 or float32)")
    return "wgmma"


def _check_sizes(what, x, w1, design):
    """x in a dtype and w1 (H, I) at widths ``design`` takes ("wgmma",
    "w8a8" or "tiles"); returns (H, I)."""
    if x.dtype not in _DTYPES:
        raise TypeError(f"{what}: dtype {x.dtype} not supported "
                        "(bfloat16 or float32)")
    if w1.dim() != 2:
        raise ValueError(f"{what}: w1 must be (H, I), got {tuple(w1.shape)}")
    h, i = w1.shape
    if design == "wgmma":
        if h % CORE_H_MULTIPLE or not CORE_H_MULTIPLE <= h <= CORE_H_MAX \
                or i % CORE_I_MULTIPLE or i == 0:
            raise ValueError(
                f"{what}: hidden size {h} / intermediate size {i}: the wgmma core "
                f"takes H a multiple of {CORE_H_MULTIPLE} from {CORE_H_MULTIPLE} to "
                f"{CORE_H_MAX} and I a multiple of {CORE_I_MULTIPLE}")
    elif design == "w8a8":
        if h % W8A8_MULTIPLE or not W8A8_MULTIPLE <= h <= W8A8_H_MAX \
                or i % W8A8_MULTIPLE or not W8A8_MULTIPLE <= i <= W8A8_I_MAX:
            raise ValueError(
                f"{what}: hidden size {h} / intermediate size {i}: the int8 core takes "
                f"H a multiple of {W8A8_MULTIPLE} from {W8A8_MULTIPLE} to {W8A8_H_MAX} "
                f"and I a multiple of {W8A8_MULTIPLE} up to {W8A8_I_MAX}")
    elif h % TILES_MULTIPLE or not TILES_MULTIPLE <= h <= TILES_H_MAX \
            or i % TILES_MULTIPLE or i == 0:
        raise ValueError(
            f"{what}: hidden size {h} / intermediate size {i}: the fp32 tiles take H a "
            f"multiple of {TILES_MULTIPLE} from {TILES_MULTIPLE} to {TILES_H_MAX} and I a "
            f"multiple of {TILES_MULTIPLE}")
    return h, i


def _check(what, x, named):
    """Every operand of an fp block kernel at a width of its route, in
    x's dtype, at its shape, on the card (``check_operands``)."""
    if x.dtype not in _DTYPES:
        raise TypeError(f"{what}: dtype {x.dtype} not supported (bfloat16 or float32)")
    h, i = _check_sizes(what, x, named["w1"], mlp_route(x.dtype))
    shapes = {"gamma": (h,), "beta": (h,), "w1": (h, i), "b1": (i,),
              "w2": (i, h), "b2": (h,), "x": (*x.shape[:-1], h)}
    check_operands(what, x, {n: (t, shapes.get(n, shapes["x"]), x.dtype)
                             for n, t in named.items()})


def _launch(postln, gamma, beta, w1, b1, w2, b2, x, m, eps, act):
    what = "fused_mlp_postln_fwd" if postln else "fused_mlp_block_fwd"
    if act not in _ACTS:
        raise ValueError(f"{what}: activation {act!r} not supported")
    _check(what, x, {"gamma": gamma, "beta": beta, "w1": w1, "b1": b1, "w2": w2,
                     "b2": b2, "x": x, "m": m})
    h, i = w1.shape
    rows = x.numel() // h
    lib = _build.load("mlp", _SIGNATURES)
    out = torch.empty_like(x)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    ptrs = (x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), w1.data_ptr(),
            b1.data_ptr(), w2.data_ptr(), b2.data_ptr(),
            None if m is None else m.data_ptr(), out.data_ptr())
    # the route's scratch, sized by the C side: LN(x) or the fp32 split-K
    # slices and the activation, bf16 (wgmma) or fp32 (tiles)
    if mlp_route(x.dtype) == "wgmma":
        ws = torch.empty(lib.vt_mlp_wgmma_workspace(rows, h, i, int(postln)),
                         dtype=torch.float32, device=x.device)
        code = lib.vt_mlp_fwd_wgmma(*ptrs, ws.data_ptr(), rows, h, i, float(eps),
                                    _ACTS[act], int(postln), stream)
    else:
        ws = torch.empty(lib.vt_mlp_workspace(rows, h, i, int(postln), 0),
                         dtype=torch.float32, device=x.device)
        code = lib.vt_mlp_fwd(*ptrs, ws.data_ptr(), rows, h, i, float(eps), _ACTS[act],
                              int(postln), _DTYPES[x.dtype], stream)
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
                     "w2": w2, "b2": b2, "x": x, "g": g, "m": m})
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
    stream = torch.cuda.current_stream(dev).cuda_stream
    mask = None if m is None else m.data_ptr()
    outs = (dx.data_ptr(), dh1.data_ptr(), a.data_ptr(), yds.data_ptr(),
            dgamma.data_ptr(), dbeta.data_ptr())
    if mlp_route(dt) == "wgmma":
        ws = torch.empty(lib.vt_mlp_bwd_wgmma_workspace(rows, h, i, int(postln)),
                         dtype=torch.float32, device=dev)
        code = lib.vt_mlp_bwd_wgmma(
            x.data_ptr(), g.data_ptr(), gamma.data_ptr(), beta.data_ptr(), w1.data_ptr(),
            b1.data_ptr(), w2.data_ptr(), b2.data_ptr(), mask, *outs, ws.data_ptr(), rows,
            h, i, float(eps), int(postln), stream)
    else:
        ws = torch.empty(lib.vt_mlp_bwd_workspace(rows, h, i, _DTYPES[dt], int(postln)),
                         dtype=torch.float32, device=dev)
        code = lib.vt_mlp_bwd(
            x.data_ptr(), g.data_ptr(), gamma.data_ptr(), beta.data_ptr(), w1.data_ptr(),
            b1.data_ptr(), w2.data_ptr(), b2.data_ptr(), mask, *outs, ws.data_ptr(), rows,
            h, i, float(eps), int(postln), _DTYPES[dt], stream)
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


def _fp_plain(postln, gamma, beta, w1, b1, w2, b2, x, m=None, eps=1e-12, act="gelu"):
    """The fp blocks' plain versions with the kernels' flat argument list."""
    plain = _mlp_postln_plain if postln else _mlp_block_plain
    return plain({"scale": gamma, "bias": beta}, {"w": w1, "b": b1}, {"w": w2, "b": b2},
                 x, eps, act, m)


_FP_SCHEMA = ("(Tensor gamma, Tensor beta, Tensor w1, Tensor b1, Tensor w2, Tensor b2, "
              "Tensor x, Tensor? m, *, float eps, str act) -> Tensor")
MLP_BLOCK = KernelOp("mlp_block", _FP_SCHEMA,
                     lambda *ts, **kw: fused_mlp_block_fwd(*ts, **kw),
                     functools.partial(_fp_plain, False), like(6))
MLP_POSTLN = KernelOp("mlp_postln", _FP_SCHEMA,
                      lambda *ts, **kw: fused_mlp_postln_fwd(*ts, **kw),
                      functools.partial(_fp_plain, True), like(6))


class _FusedMLP(torch.autograd.Function):
    """One fused MLP block, pre-LN or post-LN, differentiable.  Forward
    saves only the inputs; backward recomputes inside the backward kernel
    (GELU) or through autograd of the plain composition (other
    activations).  The mask gets no gradient."""

    @staticmethod
    def forward(ctx, gamma, beta, w1, b1, w2, b2, x, m, eps, act, postln):
        ctx.save_for_backward(gamma, beta, w1, b1, w2, b2, x, m)
        ctx.eps, ctx.act, ctx.postln = eps, act, postln
        return (MLP_POSTLN if postln else MLP_BLOCK)(gamma, beta, w1, b1, w2, b2, x, m,
                                                     eps=eps, act=act)

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


# ---------------------------------------------------------------------------
# w8a8: int8 weights and activations (csrc/mlp_w8a8.cu, the int8 core)
# ---------------------------------------------------------------------------

_W8A8_SIGNATURES = {
    "vt_mlp_w8a8": ([ctypes.c_void_p] * 16 + [ctypes.c_int] * 3 + [ctypes.c_float]
                    + [ctypes.c_int] * 3 + [ctypes.c_void_p], ctypes.c_int),
    "vt_mlp_w8a8_slices": ([ctypes.c_int] * 4, ctypes.c_int),
}
_INV_SQRT2 = 0.7071067811865476  # fp32 0.70710677, the kernels' constant


def _act_f32(act):
    """The activation on fp32 values as the w8a8 kernels write it, one
    rounding per step: GELU ``h * (erf(h * 0.70710677) + 1) * 0.5``; the
    tanh form in ``ops/nn.py`` ``gelu_tanh``'s order (the kernels mirror it,
    ``gemm_common.cuh`` ``act_rn``); ReLU."""
    if act == "gelu":
        return lambda h: h * (torch.erf(h * _INV_SQRT2) + 1.0) * 0.5
    return act_fn(act)


def _w8a8_linear_f32(aq, a_scale, wq, s, b):
    """``int32(aq wq) * (a_scale * s) + b`` in fp32."""
    return int8_matmul(aq, wq).float() * (a_scale * s.reshape(-1)) + b


def mlp_block_w8a8_plain(gamma, beta, w1q, s1, b1, w2q, s2, b2, x,
                         eps: float = 1e-12, act: str = "gelu"):
    """The pre-LN w8a8 kernel's function with its cast points: LN
    (``layer_norm_f32``) rounded to x's type, quantized per row, the first
    product dequantized with b1, the activation in fp32 rounded to x's type,
    quantized per row, the second product dequantized with b2, rounded to
    x's type, then the residual."""
    dt = x.dtype
    y = layer_norm_f32(gamma, beta, x, eps).to(dt)
    h = _w8a8_linear_f32(*quantize_activation(y), w1q, s1, b1)
    a = _act_f32(act)(h).to(dt)
    o = _w8a8_linear_f32(*quantize_activation(a), w2q, s2, b2)
    return o.to(dt) + x


def mlp_postln_w8a8_plain(gamma, beta, w1q, s1, b1, w2q, s2, b2, x,
                          eps: float = 1e-12, act: str = "gelu"):
    """The post-LN w8a8 kernel's function: x quantized per row, the two
    products as in :func:`mlp_block_w8a8_plain`, then ``LN(x + mlp)`` in
    fp32 (``layer_norm_f32``), cast to x's type."""
    dt = x.dtype
    h = _w8a8_linear_f32(*quantize_activation(x), w1q, s1, b1)
    a = _act_f32(act)(h).to(dt)
    o = _w8a8_linear_f32(*quantize_activation(a), w2q, s2, b2)
    return layer_norm_f32(gamma, beta, x.float() + o, eps).to(dt)


def _launch_w8a8(postln, gamma, beta, w1q, s1, b1, w2q, s2, b2, x, eps, act):
    what = "fused_mlp_postln_fwd_w8a8" if postln else "fused_mlp_block_fwd_w8a8"
    w8a8_route(x.dtype)  # the one design, for every dtype it takes
    if act not in _ACTS:
        raise ValueError(f"{what}: activation {act!r} not supported")
    h, i = _check_sizes(what, x, w1q, "w8a8")
    for name, q in (("w1q", w1q), ("w2q", w2q)):
        if not is_k_major(q):
            raise ValueError(f"{what}: {name} must be held K-major (a transposed view of "
                             f"contiguous storage, ops/quantize.py k_major), got strides "
                             f"{tuple(q.stride())}")
    dt, dev, rows = x.dtype, x.device, x.numel() // h
    s1, s2 = s1.reshape(-1), s2.reshape(-1)
    # the kernel reads the codes' storage: W1^T (I, H) and W2^T (H, I)
    check_operands(what, x, {
        "x": (x, (*x.shape[:-1], h), dt), "gamma": (gamma, (h,), dt),
        "beta": (beta, (h,), dt), "w1q^T": (w1q.t(), (i, h), torch.int8),
        "s1": (s1, (i,), torch.float32), "b1": (b1, (i,), dt),
        "w2q^T": (w2q.t(), (h, i), torch.int8), "s2": (s2, (h,), torch.float32),
        "b2": (b2, (h,), dt)})
    lib = _build.load("mlp_w8a8", _W8A8_SIGNATURES)
    slices = lib.vt_mlp_w8a8_slices(rows, h, i, int(postln))
    new = lambda shape, t: torch.empty(shape, dtype=t, device=dev)
    scratch = (new((rows, h), torch.int8), new(rows, torch.float32),  # q(x or LN x)
               new((rows, i), dt),                                   # h
               new((rows, i), torch.int8), new(rows, torch.float32),  # q(h)
               new((slices, rows, h), torch.int32))                  # 2nd product
    out = torch.empty_like(x)
    stream = torch.cuda.current_stream(dev).cuda_stream
    code = lib.vt_mlp_w8a8(x.data_ptr(), gamma.data_ptr(), beta.data_ptr(),
                           w1q.data_ptr(), s1.data_ptr(), b1.data_ptr(), w2q.data_ptr(),
                           s2.data_ptr(), b2.data_ptr(), *(t.data_ptr() for t in scratch),
                           out.data_ptr(), rows, h, i, float(eps), _ACTS[act],
                           int(postln), _DTYPES[dt], stream)
    _build.check(lib, code, what)
    return out


def fused_mlp_block_fwd_w8a8(gamma, beta, w1q, s1, b1, w2q, s2, b2, x,
                             eps: float = 1e-12, act: str = "gelu") -> torch.Tensor:
    """Pre-LN w8a8 block kernel.  x: (..., H) -> same shape."""
    out = _launch_w8a8(False, gamma, beta, w1q, s1, b1, w2q, s2, b2, x, eps, act)
    fused_mlp_block_fwd_w8a8.launches += 1
    return out


def fused_mlp_postln_fwd_w8a8(gamma, beta, w1q, s1, b1, w2q, s2, b2, x,
                              eps: float = 1e-12, act: str = "gelu") -> torch.Tensor:
    """Post-LN w8a8 block kernel.  x: (..., H) -> same shape."""
    out = _launch_w8a8(True, gamma, beta, w1q, s1, b1, w2q, s2, b2, x, eps, act)
    fused_mlp_postln_fwd_w8a8.launches += 1
    return out


fused_mlp_block_fwd_w8a8.launches = 0
fused_mlp_postln_fwd_w8a8.launches = 0


# ---------------------------------------------------------------------------
# w8: int8 weights dequantized by a pass in front of the products (csrc/mlp.cu:
# vt_mlp_fwd_q8_wgmma for the bf16 blocks, vt_mlp_fwd_q8 for the fp32 ones)
# ---------------------------------------------------------------------------

def _plain_on_quantized(postln, key, gamma, beta, w1q, s1, b1, w2q, s2, b2, x,
                        eps=1e-12, act="gelu"):
    """The plain composition on quantized weights (``linear``'s ``key``
    branch, "w_q" or "w_q8") with the kernels' flat argument list: the q8
    kernels' plain version, and the function both quantized families'
    gradients are taken of, as the JAX package's vjps."""
    plain = _mlp_postln_plain if postln else _mlp_block_plain
    return plain({"scale": gamma, "bias": beta}, {key: w1q, "w_scale": s1, "b": b1},
                 {key: w2q, "w_scale": s2, "b": b2}, x, eps, act)


def mlp_block_q8_plain(gamma, beta, w1q, s1, b1, w2q, s2, b2, x,
                       eps: float = 1e-12, act: str = "gelu"):
    """The pre-LN q8 kernel's function: the plain block with the weights
    ``(w_q.float() * w_scale)`` rounded to x's type before each product."""
    return _plain_on_quantized(False, "w_q", gamma, beta, w1q, s1, b1, w2q, s2, b2,
                               x, eps, act)


def mlp_postln_q8_plain(gamma, beta, w1q, s1, b1, w2q, s2, b2, x,
                        eps: float = 1e-12, act: str = "gelu"):
    """The post-LN q8 kernel's function: as :func:`mlp_block_q8_plain`."""
    return _plain_on_quantized(True, "w_q", gamma, beta, w1q, s1, b1, w2q, s2, b2,
                               x, eps, act)


def _launch_q8(postln, gamma, beta, w1q, s1, b1, w2q, s2, b2, x, eps, act):
    what = "fused_mlp_postln_fwd_q8" if postln else "fused_mlp_block_fwd_q8"
    if act not in _ACTS:
        raise ValueError(f"{what}: activation {act!r} not supported")
    route = mlp_route(x.dtype, int8_weights=True, postln=postln)
    h, i = _check_sizes(what, x, w1q, route)
    dt, rows = x.dtype, x.numel() // h
    s1, s2 = s1.reshape(-1), s2.reshape(-1)  # (1, out) in the parameter tree
    check_operands(what, x, {
        "x": (x, (*x.shape[:-1], h), dt), "gamma": (gamma, (h,), dt),
        "beta": (beta, (h,), dt), "w1q": (w1q, (h, i), torch.int8),
        "s1": (s1, (i,), torch.float32), "b1": (b1, (i,), dt),
        "w2q": (w2q, (i, h), torch.int8), "s2": (s2, (h,), torch.float32),
        "b2": (b2, (h,), dt)})
    lib = _build.load("mlp", _SIGNATURES)
    out = torch.empty_like(x)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    ptrs = (x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), w1q.data_ptr(), s1.data_ptr(),
            b1.data_ptr(), w2q.data_ptr(), s2.data_ptr(), b2.data_ptr(), out.data_ptr())
    # the route's scratch, sized by the C side: the weights dequantized to
    # bf16 (wgmma) or fp32 (tiles), then the route's block scratch
    if route == "wgmma":
        ws = torch.empty(lib.vt_mlp_q8_wgmma_workspace(rows, h, i, int(postln)),
                         dtype=torch.float32, device=x.device)
        code = lib.vt_mlp_fwd_q8_wgmma(*ptrs, ws.data_ptr(), rows, h, i, float(eps),
                                       _ACTS[act], int(postln), stream)
    else:
        ws = torch.empty(lib.vt_mlp_workspace(rows, h, i, int(postln), 1),
                         dtype=torch.float32, device=x.device)
        code = lib.vt_mlp_fwd_q8(*ptrs, ws.data_ptr(), rows, h, i, float(eps), _ACTS[act],
                                 int(postln), _DTYPES[dt], stream)
    _build.check(lib, code, what)
    return out


def fused_mlp_block_fwd_q8(gamma, beta, w1q, s1, b1, w2q, s2, b2, x,
                           eps: float = 1e-12, act: str = "gelu") -> torch.Tensor:
    """Pre-LN block kernel with int8 weights.  x: (..., H) -> same shape."""
    out = _launch_q8(False, gamma, beta, w1q, s1, b1, w2q, s2, b2, x, eps, act)
    fused_mlp_block_fwd_q8.launches += 1
    return out


def fused_mlp_postln_fwd_q8(gamma, beta, w1q, s1, b1, w2q, s2, b2, x,
                            eps: float = 1e-12, act: str = "gelu") -> torch.Tensor:
    """Post-LN block kernel with int8 weights.  x: (..., H) -> same shape."""
    out = _launch_q8(True, gamma, beta, w1q, s1, b1, w2q, s2, b2, x, eps, act)
    fused_mlp_postln_fwd_q8.launches += 1
    return out


fused_mlp_block_fwd_q8.launches = 0
fused_mlp_postln_fwd_q8.launches = 0


_Q_SCHEMA = ("(Tensor gamma, Tensor beta, Tensor w1q, Tensor s1, Tensor b1, Tensor w2q, "
             "Tensor s2, Tensor b2, Tensor x, *, float eps, str act) -> Tensor")
# per weight key, the (pre-LN, post-LN) operators of that family
_QUANTIZED_OPS = {
    "w_q8": (KernelOp("mlp_block_w8a8", _Q_SCHEMA,
                      lambda *ts, **kw: fused_mlp_block_fwd_w8a8(*ts, **kw),
                      mlp_block_w8a8_plain, like(8)),
             KernelOp("mlp_postln_w8a8", _Q_SCHEMA,
                      lambda *ts, **kw: fused_mlp_postln_fwd_w8a8(*ts, **kw),
                      mlp_postln_w8a8_plain, like(8))),
    "w_q": (KernelOp("mlp_block_q8", _Q_SCHEMA,
                     lambda *ts, **kw: fused_mlp_block_fwd_q8(*ts, **kw),
                     mlp_block_q8_plain, like(8)),
            KernelOp("mlp_postln_q8", _Q_SCHEMA,
                     lambda *ts, **kw: fused_mlp_postln_fwd_q8(*ts, **kw),
                     mlp_postln_q8_plain, like(8)))}


def _quantized_block(postln, ln_p, p_in, p_out, x, eps, act, drop_mask):
    """The JAX package's dispatch of weights that are not both fp: w8a8 or
    w8 on both projections and no mask takes that family's kernel
    (differentiable through the plain composition on the same weights),
    anything else the plain composition."""
    plain = _mlp_postln_plain if postln else _mlp_block_plain
    for key, ops in _QUANTIZED_OPS.items():
        if key in p_in and key in p_out and drop_mask is None:
            return kernel_or_plain(ops[postln],
                                   functools.partial(_plain_on_quantized, postln, key),
                                   ln_p["scale"], ln_p["bias"], p_in[key],
                                   p_in["w_scale"], p_in["b"], p_out[key],
                                   p_out["w_scale"], p_out["b"], x, eps=eps, act=act)
    return plain(ln_p, p_in, p_out, x, eps, act, drop_mask)


def fused_mlp_block(ln_p, p_in, p_out, x, eps: float = 1e-12,
                    act: str = "gelu", drop_mask=None) -> torch.Tensor:
    """The pre-LN MLP half of a ViLT layer, differentiable: the kernels for
    CUDA tensors, the plain versions for CPU tensors.  ``drop_mask``:
    optional pre-scaled dropout mask on the MLP output.  Quantized weights
    (ops/quantize.py) dispatch as in the JAX package (:func:`_quantized_block`)."""
    if "w" not in p_in or "w" not in p_out:
        return _quantized_block(False, ln_p, p_in, p_out, x, eps, act, drop_mask)
    return _FusedMLP.apply(ln_p["scale"], ln_p["bias"], p_in["w"], p_in["b"],
                           p_out["w"], p_out["b"], x, drop_mask, eps, act, False)


def fused_mlp_postln_block(ln_p, p_in, p_out, x, eps: float = 1e-12,
                           act: str = "gelu", drop_mask=None) -> torch.Tensor:
    """The post-LN MLP half of a BERT layer, differentiable: the kernels for
    CUDA tensors, the plain versions for CPU tensors; quantized weights as
    in :func:`fused_mlp_block`."""
    if "w" not in p_in or "w" not in p_out:
        return _quantized_block(True, ln_p, p_in, p_out, x, eps, act, drop_mask)
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
