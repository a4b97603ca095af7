"""The routed experts of an MoE layer through the grouped Hopper kernel
(``csrc/moe_experts.cu``, built on the bf16 ``wgmma`` core's pieces,
``csrc/gemm_sm90.cuh``), behind the operator ``vault_tpu_torch::moe_experts``
(``ops/_dispatch.py`` ``KernelOp``: the kernel for CUDA tensors, the plain
version ``ops/moe.py`` :func:`~vault_tpu_torch.ops.moe.moe_experts_plain`
for CPU tensors).

It replaces no kernel of the JAX package, which has no routed experts.  One
call is two launches, each over every expert at once: the gate and up
products with ``silu(g) * u`` in their epilogue into an (R, I) intermediate,
then the down product with the route weight in its epilogue.  The expert
offsets stay on the device: the grid is sized for the worst case, the
kernel reads the offsets and its work items past the real tiles exit, so a
call never synchronises with the host and drops no row.

The operator's inputs give the work from their shapes alone: x (R, H), gate
and up (E, I, H), down (E, H, I), offsets (E + 1,), route weights (R,).
``fused_moe_experts.launches`` counts its calls (two kernels each).
"""

from __future__ import annotations

import ctypes

import torch

from vault_tpu_torch.ops import _build
from vault_tpu_torch.ops._dispatch import KernelOp, check_operands, like
from vault_tpu_torch.ops.moe import moe_experts_plain

# The kernel's widths: H and I multiples of 8 (16-byte rows for TMA), at
# most MAX_EXPERTS experts (their offsets and tile starts sit in shared
# memory).
WIDTH_MULTIPLE, MAX_EXPERTS = 8, 256
_SIGNATURES = {"vt_moe_experts": ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 4
                                  + [ctypes.c_void_p], ctypes.c_int)}


def fused_moe_experts(x, w_gate, w_up, w_down, offsets, route_w) -> torch.Tensor:
    """The grouped kernel: x (R, H) bf16, rows in expert order; w_gate,
    w_up (E, I, H) and w_down (E, H, I) bf16; offsets (E + 1,) int32 on the
    card; route_w (R,) fp32 -> (R, H) bf16.  Raises on anything else."""
    what = "fused_moe_experts"
    if x.dtype != torch.bfloat16:
        raise TypeError(f"{what}: x is {x.dtype}; the kernel takes bfloat16")
    if x.dim() != 2 or w_gate.dim() != 3:
        raise ValueError(f"{what}: x must be (R, H) and w_gate (E, I, H), got "
                         f"{tuple(x.shape)} and {tuple(w_gate.shape)}")
    rows, h = x.shape
    e, i, _ = w_gate.shape
    if h % WIDTH_MULTIPLE or i % WIDTH_MULTIPLE or not 0 < e <= MAX_EXPERTS:
        raise ValueError(f"{what}: H {h} and I {i} must be multiples of {WIDTH_MULTIPLE}, "
                         f"and the experts 1 to {MAX_EXPERTS} (got {e})")
    bf = torch.bfloat16
    check_operands(what, x, {
        "x": (x, (rows, h), bf), "w_gate": (w_gate, (e, i, h), bf),
        "w_up": (w_up, (e, i, h), bf), "w_down": (w_down, (e, h, i), bf),
        "offsets": (offsets, (e + 1,), torch.int32), "route_w": (route_w, (rows,), torch.float32)})
    out = torch.empty_like(x)
    if rows == 0:
        return out
    inter = torch.empty((rows, i), dtype=bf, device=x.device)
    lib = _build.load("moe_experts", _SIGNATURES)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    code = lib.vt_moe_experts(x.data_ptr(), w_gate.data_ptr(), w_up.data_ptr(),
                              w_down.data_ptr(), offsets.data_ptr(), route_w.data_ptr(),
                              inter.data_ptr(), out.data_ptr(), rows, h, i, e, stream)
    _build.check(lib, code, what)
    fused_moe_experts.launches += 1
    return out


fused_moe_experts.launches = 0

MOE_EXPERTS = KernelOp(
    "moe_experts", "(Tensor x, Tensor w_gate, Tensor w_up, Tensor w_down, Tensor offsets, "
    "Tensor route_w) -> Tensor",
    lambda *ts, **kw: fused_moe_experts(*ts, **kw), moe_experts_plain, like(0))
