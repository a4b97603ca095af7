"""Fused LayerNorm -> QKV projection through the hand-written Hopper kernels
(``csrc/ln_qkv.cu``), with their plain PyTorch versions beside them.

  * :func:`fused_ln_qkv_fwd`: ``LN(x) Wqkv + b`` for fp weights; replaces
    the JAX package's ``fused_ln_qkv_fwd`` (``vault_tpu/ops/pallas_mlp.py``).
    Plain version :func:`ln_qkv_plain` (its ``_ln_qkv_xla``).  bf16 runs on
    the wgmma/TMA GEMM core (``vt_ln_qkv_wgmma``), fp32 on ``gemm_tiles``
    (``vt_ln_qkv``): :func:`ln_qkv_route`.
  * :func:`fused_ln_qkv_fwd_w8a8`: the same with int8 weights and
    per-out-channel scales, the normalised rows quantized to int8 and one
    int8 x int8 -> int32 product on the core's int8 instance
    (``vt_ln_qkv_w8a8``, bf16 and fp32 alike), its codes held K-major
    (``ops/quantize.py`` ``k_major``: the int8 ``wgmma`` has no transpose
    bit); replaces ``fused_ln_qkv_fwd_w8a8``.  Plain version
    :func:`ln_qkv_w8a8_plain` (the kernel's LN, then the w8a8 ``linear``),
    which takes either layout.

The dispatcher :func:`fused_ln_qkv` mirrors the JAX package's: w8a8 q/k/v
run the w8a8 kernel, fp ones the fp kernel, any other form (w8) LayerNorm
and three plain linears.  Both kernels are differentiable through
``ops/_dispatch.py``'s Function, whose backward is autograd of the plain
composition (LN, then one linear over the concatenated weights), as the JAX
package's ``_fused_ln_qkv_bwd``.  The kernel wrappers launch for CUDA
tensors and raise on anything the kernels do not take; CPU tensors take the
plain versions.  Each wrapper counts its launches in ``<wrapper>.launches``.
Both are also operators, ``vault_tpu_torch::ln_qkv`` and ``ln_qkv_w8a8``
(``ops/_dispatch.py`` ``KernelOp``), through which the forward launches
them, in eager mode and in an exported program alike.
"""

from __future__ import annotations

import ctypes

import torch

from vault_tpu_torch.ops import _build
from vault_tpu_torch.ops._dispatch import KernelOp, check_operands, kernel_or_plain
from vault_tpu_torch.ops.nn import layer_norm, layer_norm_f32, linear, linear_w8a8_plain
from vault_tpu_torch.ops.quantize import is_k_major

# The widths each kernel takes, (H multiple, H max, output-width multiple).
# bf16 with fp weights on the wgmma core: H a multiple of 64 from 64 to
# 8,192 (the core's 64-deep K steps, the row kernel's 8,192) and an output
# width (3H) a multiple of 64.  The w8a8 kernel on the core's int8 instance
# and fp32 with fp weights on gemm_tiles: H a multiple of 128 from 128 to
# 8,192 (the row pass's 128 threads, a row in registers; the int8 core's
# 128-byte K steps) and an output width a multiple of 128 (gemm_tiles' tile).
CORE_H_MULTIPLE, CORE_H_MAX, CORE_N_MULTIPLE = 64, 8192, 64
H_MULTIPLE, H_MAX, N_MULTIPLE = 128, 8192, 128
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_SIGNATURES = {
    "vt_ln_qkv_wgmma": ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 3 + [ctypes.c_float]
                        + [ctypes.c_void_p], ctypes.c_int),
    "vt_ln_qkv": ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 3 + [ctypes.c_float]
                  + [ctypes.c_int, ctypes.c_void_p], ctypes.c_int),
    "vt_ln_qkv_w8a8": ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 3 + [ctypes.c_float]
                       + [ctypes.c_int, ctypes.c_void_p], ctypes.c_int),
}


def ln_qkv_plain(gamma, beta, wqkv, bqkv, x, eps: float = 1e-12):
    """``linear(LN(x))``: the JAX package's ``_ln_qkv_xla``."""
    return linear({"w": wqkv, "b": bqkv},
                  layer_norm({"scale": gamma, "bias": beta}, x, eps))


def ln_qkv_w8a8_plain(gamma, beta, wqkv_q, sqkv, bqkv, x, eps: float = 1e-12):
    """The w8a8 kernel's function: LN (``layer_norm_f32``) rounded to x's
    type, then the w8a8 ``linear`` (per-row quantization, int8 product,
    ``acc * (ys * s) + b``, ``linear_w8a8_plain``), cast to x's type."""
    y = layer_norm_f32(gamma, beta, x, eps).to(x.dtype)
    return linear_w8a8_plain(y, wqkv_q, sqkv.reshape(-1), bqkv).to(x.dtype)


def _ln_qkv_w8a8_ref(gamma, beta, wqkv_q, sqkv, bqkv, x, eps: float = 1e-12):
    """The XLA composition the w8a8 gradients are taken of: LN, then the
    w8a8 linear over the concatenated weights (``linear_w8a8_plain``)."""
    return linear_w8a8_plain(layer_norm({"scale": gamma, "bias": beta}, x, eps), wqkv_q,
                             sqkv.reshape(-1), bqkv)


def ln_qkv_route(dtype: torch.dtype, w8a8: bool = False) -> str:
    """Which design runs an LN -> QKV call with activations in ``dtype`` on
    the card: "wgmma", the core (``vt_ln_qkv_wgmma``), for bf16 with fp
    weights, and its int8 instance (``vt_ln_qkv_w8a8``) for int8 weights in
    bf16 and fp32 alike (the product is exact in int32; only the row pass's
    and the epilogue's casts depend on the type); "tiles" (``gemm_tiles``:
    ``vt_ln_qkv``) for fp32 with fp weights.  The wrappers launch its entry
    and hold a call to its width contract."""
    if dtype not in _DTYPES:
        raise TypeError(f"ln_qkv_route: dtype {dtype} not supported (bfloat16 or float32)")
    return "wgmma" if dtype == torch.bfloat16 or w8a8 else "tiles"


def _shapes(what, x, w, bf16_core):
    """(H, 3H, rows) of a call, its widths held to the bf16 core's contract
    (``bf16_core``) or to the one the w8a8 kernel and gemm_tiles share."""
    if x.dtype not in _DTYPES:
        raise TypeError(f"{what}: dtype {x.dtype} not supported (bfloat16 or "
                        "float32)")
    if w.dim() != 2:
        raise ValueError(f"{what}: weights must be (H, 3H), got {tuple(w.shape)}")
    h, n = w.shape
    design, (h_mul, h_max, n_mul) = (
        ("the wgmma core takes", (CORE_H_MULTIPLE, CORE_H_MAX, CORE_N_MULTIPLE)) if bf16_core
        else ("the int8 core and gemm_tiles take", (H_MULTIPLE, H_MAX, N_MULTIPLE)))
    if h % h_mul or not h_mul <= h <= h_max or n % n_mul or n == 0:
        raise ValueError(f"{what}: hidden size {h} / output width {n}: {design} H a "
                         f"multiple of {h_mul} from {h_mul} to {h_max} and an output width "
                         f"a multiple of {n_mul}")
    return h, n, x.numel() // h


def fused_ln_qkv_fwd(gamma, beta, wqkv, bqkv, x, eps: float = 1e-12) -> torch.Tensor:
    """fp LN -> QKV kernel.  x (..., H) -> (..., 3H), all operands in x's
    type."""
    what = "fused_ln_qkv_fwd"
    route = ln_qkv_route(x.dtype)
    h, n, rows = _shapes(what, x, wqkv, route == "wgmma")
    dt = x.dtype
    check_operands(what, x, {
        "x": (x, (*x.shape[:-1], h), dt), "gamma": (gamma, (h,), dt),
        "beta": (beta, (h,), dt), "wqkv": (wqkv, (h, n), dt), "bqkv": (bqkv, (n,), dt)})
    lib = _build.load("ln_qkv", _SIGNATURES)
    y = torch.empty((rows, h), dtype=dt, device=x.device)  # LN(x) in x's type
    out = torch.empty((*x.shape[:-1], n), dtype=dt, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    ptrs = (x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), wqkv.data_ptr(),
            bqkv.data_ptr(), y.data_ptr(), out.data_ptr())
    if route == "wgmma":
        code = lib.vt_ln_qkv_wgmma(*ptrs, rows, h, n, float(eps), stream)
    else:
        code = lib.vt_ln_qkv(*ptrs, rows, h, n, float(eps), _DTYPES[dt], stream)
    _build.check(lib, code, what)
    fused_ln_qkv_fwd.launches += 1
    return out


def fused_ln_qkv_fwd_w8a8(gamma, beta, wqkv_q, sqkv, bqkv, x,
                          eps: float = 1e-12) -> torch.Tensor:
    """w8a8 LN -> QKV kernel.  x (..., H) -> (..., 3H); wqkv_q (H, 3H) int8
    held K-major (a transposed view of contiguous (3H, H) storage), sqkv
    (3H,) fp32, gamma/beta/bqkv in x's type."""
    what = "fused_ln_qkv_fwd_w8a8"
    ln_qkv_route(x.dtype, w8a8=True)  # the one design, for every dtype it takes
    h, n, rows = _shapes(what, x, wqkv_q, False)
    if not is_k_major(wqkv_q):
        raise ValueError(f"{what}: wqkv_q must be held K-major (a transposed view of "
                         f"contiguous storage, ops/quantize.py k_major), got strides "
                         f"{tuple(wqkv_q.stride())}")
    dt, dev = x.dtype, x.device
    sqkv = sqkv.reshape(-1)
    # the kernel reads the codes' storage, Wqkv^T (3H, H)
    check_operands(what, x, {
        "x": (x, (*x.shape[:-1], h), dt), "gamma": (gamma, (h,), dt),
        "beta": (beta, (h,), dt), "wqkv_q^T": (wqkv_q.t(), (n, h), torch.int8),
        "sqkv": (sqkv, (n,), torch.float32), "bqkv": (bqkv, (n,), dt)})
    lib = _build.load("ln_qkv", _SIGNATURES)
    yq = torch.empty((rows, h), dtype=torch.int8, device=dev)  # LN(x)'s codes
    ys = torch.empty(rows, dtype=torch.float32, device=dev)    # and scales
    out = torch.empty((*x.shape[:-1], n), dtype=dt, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    code = lib.vt_ln_qkv_w8a8(x.data_ptr(), gamma.data_ptr(), beta.data_ptr(),
                              wqkv_q.data_ptr(), sqkv.data_ptr(), bqkv.data_ptr(),
                              yq.data_ptr(), ys.data_ptr(), out.data_ptr(), rows, h,
                              n, float(eps), _DTYPES[dt], stream)
    _build.check(lib, code, what)
    fused_ln_qkv_fwd_w8a8.launches += 1
    return out


fused_ln_qkv_fwd.launches = 0
fused_ln_qkv_fwd_w8a8.launches = 0


def _fake(*ts, **kw):
    x, w = ts[-1], ts[2]
    return x.new_empty((*x.shape[:-1], w.shape[1]))


LN_QKV = KernelOp(
    "ln_qkv", "(Tensor gamma, Tensor beta, Tensor wqkv, Tensor bqkv, Tensor x, *, "
    "float eps) -> Tensor", lambda *ts, **kw: fused_ln_qkv_fwd(*ts, **kw), ln_qkv_plain,
    _fake)
LN_QKV_W8A8 = KernelOp(
    "ln_qkv_w8a8", "(Tensor gamma, Tensor beta, Tensor wqkv_q, Tensor sqkv, Tensor bqkv, "
    "Tensor x, *, float eps) -> Tensor",
    lambda *ts, **kw: fused_ln_qkv_fwd_w8a8(*ts, **kw), ln_qkv_w8a8_plain, _fake)


def _zero_bias(ps, key, dtype):
    """Each projection's bias, zeros where a ``qkv_bias=False`` model has
    none (in the type of the biases present, else ``dtype``)."""
    present = [p["b"].dtype for p in ps if "b" in p]
    bdt = present[0] if present else dtype
    return torch.cat([p["b"] if "b" in p else torch.zeros(
        p[key].shape[1], dtype=bdt, device=p[key].device) for p in ps])


def _w8a8_operands(ps, dtype):
    """The w8a8 kernel's (wqkv_q, sqkv, bqkv): q/k/v's int8 weights, scales
    and biases concatenated along out, the weights held K-major (an (H, 3H)
    view of (3H, H) storage, the layout the kernel reads; the concatenation
    is the one copy, from either layout of the sources).  Under
    ``torch.no_grad`` or ``torch.inference_mode``, when the projections are
    modules, the result is kept on the q module (not as a parameter or
    buffer, so no checkpoint sees it) and built again only when a source
    tensor was replaced, moved or written in place: a served forward
    concatenates nothing."""
    def build():
        return (torch.cat([p["w_q8"].t() for p in ps]).t(),
                torch.cat([p["w_scale"] for p in ps], dim=-1).reshape(-1),
                _zero_bias(ps, "w_q8", dtype))

    srcs = [p[k] for p in ps for k in ("w_q8", "w_scale", "b") if k in p]
    if (torch.is_grad_enabled() or not isinstance(ps[0], torch.nn.Module)
            or torch.compiler.is_exporting() or any(t.is_inference() for t in srcs)):
        return build()
    # the sources themselves are held, so an id is never reused while kept
    key = [(id(t), t.data_ptr(), t.device, t._version) for t in srcs]
    kept = ps[0].__dict__.get("_w8a8_qkv")
    if kept is None or kept[0] != key:
        kept = ps[0].__dict__["_w8a8_qkv"] = (key, srcs, build())
    return kept[2]


def fused_ln_qkv(ln_p, pq, pk, pv, x, eps: float = 1e-12) -> torch.Tensor:
    """LN(ln_before) + the Q/K/V projections of a pre-LN layer, returning
    the (..., 3H) concatenation for the caller to split: the w8a8 kernel
    for w8a8 weights ({w_q8, w_scale}), the fp kernel for fp weights, LN
    and three plain linears for any other form."""
    ps = (pq, pk, pv)
    g, b = ln_p["scale"], ln_p["bias"]
    if all("w_q8" in p for p in ps):
        return kernel_or_plain(LN_QKV_W8A8, _ln_qkv_w8a8_ref, g, b,
                               *_w8a8_operands(ps, x.dtype), x, eps=eps)
    if any("w" not in p for p in ps):
        y = layer_norm(ln_p, x, eps)
        return torch.cat([linear(p, y) for p in ps], dim=-1)
    w = torch.cat([p["w"] for p in ps], dim=1)
    return kernel_or_plain(LN_QKV, ln_qkv_plain, g, b, w,
                           _zero_bias(ps, "w", pq["w"].dtype), x, eps=eps)
