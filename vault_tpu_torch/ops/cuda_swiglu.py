"""The Llama layer's MLP half, RMSNorm -> SwiGLU -> residual, through the
hand-written w8a8 Hopper kernel (``csrc/swiglu_w8a8.cu``: its three int8
products on the int8 instance of the ``wgmma`` core, ``csrc/gemm_sm90.cuh``),
with its plain PyTorch versions beside it (port of
``vault_tpu/ops/pallas_swiglu.py``).

  * :func:`swiglu_block_plain`: ``x + down(silu(gate(rms(x))) * up(rms(x)))``
    on any weight form ``linear`` takes (the JAX package's
    ``swiglu_block_xla``).
  * :func:`swiglu_block_w8a8_plain`: the kernel's function in plain PyTorch
    (the JAX package's ``swiglu_block_xla_grouped``): the SwiGLU
    intermediate is requantized per (row, I-tile of :data:`I_TILE` columns),
    finer than :func:`swiglu_block_plain`'s per-row quantization over all of
    I, and the down product is summed tile by tile in fp32.  It rounds at
    the kernel's cast points and takes every fp32 step as the kernel does
    (the mean of squares in double, rounded once; ``1 / sqrt``; silu as
    ``g * (1 / (1 + exp(-g)))``), so on the card the two agree bit for bit.
  * :func:`fused_swiglu_block_fwd_w8a8`: the kernel; it launches for CUDA
    tensors and raises on anything it does not take: a width outside its
    contract (:func:`check_widths`) or weight codes not held K-major
    (``ops/quantize.py`` ``k_major``: the int8 ``wgmma`` has no transpose
    bit, and the port lays the codes out so once, never per call).
    ``fused_swiglu_block_fwd_w8a8.launches`` counts its launches;
    :func:`swiglu_route` names its design.
  * :func:`swiglu_block`: the dispatch.  Three ``w_q8`` projections take
    the kernel (CPU tensors its plain version); anything else
    :func:`swiglu_block_plain`.  Inference math: the gradient is autograd of
    :func:`swiglu_block_plain` on the same ``w_q8`` weights (to the norm
    weight, the three scales and x; none to the codes), as the JAX
    package's vjp.

:data:`I_TILE` is a constant of the function, not a tuning knob: it fixes
the requantization groups and so the int8 codes.  The kernel is also the
operator ``vault_tpu_torch::swiglu_w8a8`` (``ops/_dispatch.py``
``KernelOp``), through which the forward launches it, in eager mode and in
an exported program alike.
"""

from __future__ import annotations

import ctypes

import torch

from vault_tpu_torch.ops import _build
from vault_tpu_torch.ops._dispatch import KernelOp, check_operands, kernel_or_plain, like
from vault_tpu_torch.ops.nn import int8_matmul, linear_plain, rms_norm, silu
from vault_tpu_torch.ops.quantize import is_k_major, quantize_activation

I_TILE = 1024        # the largest group of I columns requantized together
# The kernel's widths, those of the JAX package's Pallas kernel at every
# published Llama geometry: H a multiple of 16 (16-byte rows of codes: the
# int8 core reads H in 128-byte stages with zeros past it) from 16 to 8,192
# (its row pass holds a row in registers); I whose tile pick_tile(I, I_TILE)
# is a multiple of 16 (688 for Llama-2-7B: the down product reads each tile
# as a run of its own, zeros past it).  H a multiple of 128 with a tile
# that is one too runs the exact instance (csrc/swiglu_w8a8.cu).
H_MULTIPLE, H_MAX, TILE_MULTIPLE = 16, 8192, 16
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_SIGNATURES = {"vt_swiglu_w8a8": (
    [ctypes.c_void_p] * 14 + [ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_int,
                                                    ctypes.c_void_p], ctypes.c_int)}


def swiglu_route(dtype: torch.dtype) -> str:
    """Which design runs the w8a8 SwiGLU block with x in ``dtype`` on the
    card: "wgmma", the int8 instance of the core (s8 x s8 -> s32 ``wgmma``
    through TMA), for bf16 and fp32 alike: the products are exact in int32,
    and only the row passes and the epilogues' casts depend on the type."""
    if dtype not in _DTYPES:
        raise TypeError(f"swiglu_route: dtype {dtype} not supported (bfloat16 or float32)")
    return "wgmma"


def check_widths(what: str, h: int, i: int) -> int:
    """The kernel's width contract (:data:`H_MULTIPLE`, :data:`H_MAX`,
    :data:`TILE_MULTIPLE`); returns the I-tile.  Raises ``ValueError``
    outside it: nothing falls back."""
    ti = pick_tile(i, I_TILE) if i > 0 else 0
    if h % H_MULTIPLE or not H_MULTIPLE <= h <= H_MAX or ti == 0 or ti % TILE_MULTIPLE:
        raise ValueError(
            f"{what}: hidden size {h} / intermediate size {i}: the kernel takes H a "
            f"multiple of {H_MULTIPLE} from {H_MULTIPLE} to {H_MAX} and I whose tile "
            f"pick_tile(I, {I_TILE}) = {ti} is a multiple of {TILE_MULTIPLE}")
    return ti


def swiglu_block_plain(ln_w, p_gate, p_up, p_down, x, eps: float = 1e-5):
    """The plain composition, any weight form ``linear`` accepts, the w8a8
    one on its composition (``ops/nn.py`` ``linear_plain``)."""
    y = rms_norm(ln_w, x, eps)
    return x + linear_plain(p_down, silu(linear_plain(p_gate, y)) * linear_plain(p_up, y))


def pick_tile(size: int, pref: int) -> int:
    """Largest divisor of ``size`` that is <= ``pref``."""
    if size % pref == 0:
        return pref
    return max(t for t in range(1, min(pref, size) + 1) if size % t == 0)


def _rms_norm_f32(weight, x, eps):
    """RMSNorm rounded to x's dtype and back to fp32, as the kernel computes
    it: the mean of squares taken in double and rounded to fp32 (the
    correctly rounded value), ``1 / sqrt(var + eps)`` with a correctly
    rounded root and division, then ``weight * (x * rstd)``."""
    xf = x.float()
    var = xf.double().square().mean(-1, keepdim=True).float()
    rstd = torch.reciprocal(torch.sqrt(var + eps))
    return (weight.float() * (xf * rstd)).to(x.dtype).float()


def swiglu_block_w8a8_plain(ln_w, wgq, sg, wuq, su, wdq, sd, x,
                            eps: float = 1e-5, i_tile: int = I_TILE):
    """The kernel's function in plain PyTorch (see the module docstring):
    per-(row, I-tile) requantization and per-tile fp32 accumulation, in tile
    order.  Weights: wgq/wuq (H, I) int8 with scales sg/su (1, I) or (I,);
    wdq (I, H) int8 with sd (1, H) or (H,); no biases."""
    shape, h = x.shape, x.shape[-1]
    x2 = x.reshape(-1, h)
    i_dim = wgq.shape[1]
    ti = pick_tile(i_dim, i_tile)
    sg, su, sd = sg.reshape(1, -1), su.reshape(1, -1), sd.reshape(1, -1)
    xq, xs = quantize_activation(_rms_norm_f32(ln_w, x2, eps))
    acc = None
    for t0 in range(0, i_dim, ti):
        g = int8_matmul(xq, wgq[:, t0:t0 + ti].contiguous()).float() * (xs * sg[:, t0:t0 + ti])
        u = int8_matmul(xq, wuq[:, t0:t0 + ti].contiguous()).float() * (xs * su[:, t0:t0 + ti])
        a = (g * torch.reciprocal(1.0 + torch.exp(-g)) * u).to(x.dtype).float()
        aq, a_scale = quantize_activation(a)
        d = int8_matmul(aq, wdq[t0:t0 + ti]).float() * a_scale
        acc = d if acc is None else acc + d
    return (x2 + (acc * sd).to(x.dtype)).reshape(shape)


def fused_swiglu_block_fwd_w8a8(ln_w, wgq, sg, wuq, su, wdq, sd, x,
                                eps: float = 1e-5) -> torch.Tensor:
    """The w8a8 SwiGLU block kernel.  x: (..., H) bf16 or fp32 -> same
    shape; ln_w (H) fp32; wgq, wuq (H, I) and wdq (I, H) int8 held K-major;
    widths as :func:`check_widths`."""
    what = "fused_swiglu_block_fwd_w8a8"
    if x.dtype not in _DTYPES:
        raise TypeError(f"{what}: dtype {x.dtype} not supported (bfloat16 or float32)")
    if wgq.dim() != 2:
        raise ValueError(f"{what}: wgq must be (H, I), got {tuple(wgq.shape)}")
    h, i = wgq.shape
    ti = check_widths(what, h, i)
    for name, q in (("wgq", wgq), ("wuq", wuq), ("wdq", wdq)):
        if not is_k_major(q):
            raise ValueError(f"{what}: {name} must be held K-major (a transposed view of "
                             f"contiguous storage, ops/quantize.py k_major), got strides "
                             f"{tuple(q.stride())}")
    dev, dt, rows = x.device, x.dtype, x.numel() // h
    sg, su, sd = sg.reshape(-1), su.reshape(-1), sd.reshape(-1)
    f32, i8 = torch.float32, torch.int8
    # the kernel reads the codes' storage: Wg^T, Wu^T (I, H) and Wd^T (H, I)
    check_operands(what, x, {
        "x": (x, (*x.shape[:-1], h), dt), "ln_w": (ln_w, (h,), f32),
        "wgq^T": (wgq.t(), (i, h), i8), "sg": (sg, (i,), f32),
        "wuq^T": (wuq.t(), (i, h), i8), "su": (su, (i,), f32),
        "wdq^T": (wdq.t(), (h, i), i8), "sd": (sd, (h,), f32)})
    lib = _build.load("swiglu_w8a8", _SIGNATURES)
    new = lambda shape, t: torch.empty(shape, dtype=t, device=dev)
    scratch = (new((rows, h), i8), new(rows, f32),               # q(rms(x))
               new((rows, i), dt),                                # a
               new((rows, i), i8), new((rows, i // ti), f32))     # q(a) per tile
    out = torch.empty_like(x)
    stream = torch.cuda.current_stream(dev).cuda_stream
    code = lib.vt_swiglu_w8a8(x.data_ptr(), ln_w.data_ptr(), wgq.data_ptr(), sg.data_ptr(),
                              wuq.data_ptr(), su.data_ptr(), wdq.data_ptr(), sd.data_ptr(),
                              *(t.data_ptr() for t in scratch), out.data_ptr(), rows, h, i, ti,
                              float(eps), _DTYPES[dt], stream)
    _build.check(lib, code, what)
    fused_swiglu_block_fwd_w8a8.launches += 1
    return out


fused_swiglu_block_fwd_w8a8.launches = 0

SWIGLU_W8A8 = KernelOp(
    "swiglu_w8a8", "(Tensor ln_w, Tensor wgq, Tensor sg, Tensor wuq, Tensor su, Tensor wdq, "
    "Tensor sd, Tensor x, *, float eps) -> Tensor",
    lambda *ts, **kw: fused_swiglu_block_fwd_w8a8(*ts, **kw), swiglu_block_w8a8_plain,
    like(7))


def _w8a8_ref(ln_w, wgq, sg, wuq, su, wdq, sd, x, eps=1e-5):
    """The composition the kernel's gradient is taken of."""
    return swiglu_block_plain(ln_w, {"w_q8": wgq, "w_scale": sg},
                              {"w_q8": wuq, "w_scale": su},
                              {"w_q8": wdq, "w_scale": sd}, x, eps)


def swiglu_block(ln_w, p_gate, p_up, p_down, x, eps: float = 1e-5) -> torch.Tensor:
    """The Llama layer's MLP half.  w8a8 parameters ({w_q8, w_scale}) on all
    three projections take the fused kernel (its plain version for CPU
    tensors); anything else the plain composition."""
    if "w_q8" in p_gate and "w_q8" in p_up and "w_q8" in p_down:
        return kernel_or_plain(SWIGLU_W8A8, _w8a8_ref, ln_w,
                               p_gate["w_q8"], p_gate["w_scale"], p_up["w_q8"],
                               p_up["w_scale"], p_down["w_q8"], p_down["w_scale"], x,
                               eps=eps)
    return swiglu_block_plain(ln_w, p_gate, p_up, p_down, x, eps)
