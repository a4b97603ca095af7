"""The w8a8 dense layer through the hand-written Hopper kernel
(``csrc/linear_w8a8.cu``: a row-quantize pass, then one int8 x int8 ->
int32 product on the int8 instance of the ``wgmma`` core with the
dequantization and the bias in its epilogue), with its plain version
beside it.

  * :func:`linear_w8a8`: the kernel.  x (..., K) bf16, the codes (K, N)
    int8 held K-major (``ops/quantize.py`` ``k_major``: the int8 ``wgmma``
    has no transpose bit), the scales (1, N) or (N,) fp32, the bias (N,)
    bf16 or None; returns (..., N) bf16, bit-equal to the plain version (the
    int32 products are exact, and the epilogue rounds at its cast points).
    It launches for CUDA tensors and raises on anything it does not take;
    ``linear_w8a8.launches`` counts its launches (two kernels, one call).
  * the plain version is ``ops/nn.py`` :func:`~vault_tpu_torch.ops.nn.
    linear_w8a8_plain`, the composition of ``linear``'s w8a8 branch.
  * :func:`kernel_takes`: whether a call of ``linear``'s w8a8 branch runs
    here.  ``ops/nn.py`` ``linear`` asks it at every call; what it does not
    take (the CPU, fp32, a gradient to x, row-major codes, other widths)
    keeps the composition.

The kernel is also the operator ``vault_tpu_torch::linear_w8a8``
(``ops/_dispatch.py`` ``KernelOp``), through which ``linear`` launches it,
in eager mode and in an exported program alike.
"""

from __future__ import annotations

import ctypes

import torch

from vault_tpu_torch.ops import _build
from vault_tpu_torch.ops._dispatch import KernelOp, check_operands
from vault_tpu_torch.ops.nn import linear_w8a8_plain

# The widths the kernel takes: K a multiple of 128 up to 8,192 (the row
# pass's 128 threads, a row in registers; the int8 core's 128-byte k-steps)
# and N a multiple of 128.
K_MULTIPLE, K_MAX, N_MULTIPLE = 128, 8192, 128
_SIGNATURES = {"vt_linear_w8a8": ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 3
                                  + [ctypes.c_void_p], ctypes.c_int)}


def _widths_fit(k: int, n: int) -> bool:
    return (k % K_MULTIPLE == 0 and K_MULTIPLE <= k <= K_MAX
            and n % N_MULTIPLE == 0 and n > 0)


def _ready(t: torch.Tensor) -> torch.Tensor:
    """``t`` contiguous and 16-byte aligned, as the kernel reads it: a copy
    only where it is neither (a view at an odd offset)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def kernel_takes(x: torch.Tensor, w_q8: torch.Tensor, w_scale: torch.Tensor,
                 b=None) -> bool:
    """Whether the kernel runs ``linear``'s w8a8 branch on these operands:
    x a bf16 tensor on the card with rows, no gradient to x (w8a8 training
    takes its gradient through the scale, on the composition), the codes
    K-major, K and N in the kernel's widths, the scales fp32 and the bias
    bf16.  It reads shapes, types and strides alone, so a program being
    exported asks it as eager code does."""
    if not (x.is_cuda and x.dtype == torch.bfloat16 and w_q8.dim() == 2):
        return False
    if torch.is_grad_enabled() and x.requires_grad:
        return False
    k, n = w_q8.shape
    return (_widths_fit(k, n) and x.shape[-1] == k and x.numel() > 0
            and w_q8.t().is_contiguous()
            and w_scale.dtype == torch.float32 and w_scale.numel() == n
            and (b is None or (b.dtype == torch.bfloat16 and b.numel() == n)))


def linear_w8a8(x, w_q8, w_scale, b=None) -> torch.Tensor:
    """The w8a8 kernel: ``bf16(int32(q(x) W8) * (xs * s) + b)``.  x (..., K)
    bf16; w_q8 (K, N) int8 held K-major; w_scale (1, N) or (N,) fp32; b (N,)
    bf16 or None."""
    what = "linear_w8a8"
    if x.dtype != torch.bfloat16:
        raise TypeError(f"{what}: x is {x.dtype}, the kernel takes bfloat16")
    if w_q8.dim() != 2:
        raise ValueError(f"{what}: codes must be (K, N), got {tuple(w_q8.shape)}")
    k, n = w_q8.shape
    if not _widths_fit(k, n):
        raise ValueError(f"{what}: widths {k} -> {n}: the kernel takes K a multiple of "
                         f"{K_MULTIPLE} from {K_MULTIPLE} to {K_MAX} and N a multiple of "
                         f"{N_MULTIPLE}")
    if not w_q8.t().is_contiguous():
        raise ValueError(f"{what}: w_q8 must be held K-major (a transposed view of "
                         f"contiguous storage, ops/quantize.py k_major), got strides "
                         f"{tuple(w_q8.stride())}")
    rows = x.numel() // k
    s = w_scale.reshape(-1)
    if x.is_cuda:  # a view at an odd offset is copied; any other device is refused below
        x, s = _ready(x), _ready(s)
        b = None if b is None else _ready(b)
    # the kernel reads the codes' storage, W8^T (N, K)
    check_operands(what, x, {
        "x": (x, (*x.shape[:-1], k), torch.bfloat16), "w_q8^T": (w_q8.t(), (n, k), torch.int8),
        "w_scale": (s, (n,), torch.float32), "b": (b, (n,), torch.bfloat16)})
    if rows == 0:
        raise ValueError(f"{what}: x has no rows")
    dev = x.device
    lib = _build.load("linear_w8a8", _SIGNATURES)
    xq = torch.empty((rows, k), dtype=torch.int8, device=dev)  # x's codes
    xs = torch.empty(rows, dtype=torch.float32, device=dev)    # and scales
    out = torch.empty((*x.shape[:-1], n), dtype=torch.bfloat16, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    code = lib.vt_linear_w8a8(x.data_ptr(), w_q8.data_ptr(), s.data_ptr(),
                              None if b is None else b.data_ptr(), xq.data_ptr(),
                              xs.data_ptr(), out.data_ptr(), rows, k, n, stream)
    _build.check(lib, code, what)
    linear_w8a8.launches += 1
    return out


linear_w8a8.launches = 0


def _fake(x, w_q8, w_scale, b):
    return x.new_empty((*x.shape[:-1], w_q8.shape[1]))


LINEAR_W8A8 = KernelOp(
    "linear_w8a8", "(Tensor x, Tensor w_q8, Tensor w_scale, Tensor? b) -> Tensor",
    lambda *ts, **kw: linear_w8a8(*ts, **kw), linear_w8a8_plain, _fake)
