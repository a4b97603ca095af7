"""The yardstick of a kernel's roofline share: the H100's peaks and the
share of the least time the card could take over the time it took.

A roofline metric (``portbench/metrics/<name>_roofline.*.py``) names its
host operators and the work of one call of them, counted from that call's
input shapes as the algorithm needs it: each input byte read once, each
output byte written once, and the products' operations.  The shapes come
from a one-iteration trace that records them; the kernel time from the
traced window, which does not (recording shapes slows the host).  Both
traces must hold the same calls per iteration, or the metric is silent.

Peaks: NVIDIA's H100 SXM data sheet, dense: 989.4 TFLOP/s bf16, 1,979
TOP/s int8, 3.35 TB/s HBM3, at the full 700 W; a run prints the card's
power limit beside its numbers.
"""

from __future__ import annotations

from typing import Callable, Optional

PEAK_BF16 = 989.4e12
PEAK_INT8 = 1979e12
PEAK_BYTES = 3.35e12

DTYPE_BYTES = {"float": 4, "c10::BFloat16": 2, "signed char": 1}


def least_s(ops: float, nbytes: float, peak: float) -> float:
    """The least time for ``ops`` operations at ``peak`` and ``nbytes``
    bytes at the memory rate."""
    return max(ops / peak, nbytes / PEAK_BYTES)


def tensor_bytes(op: dict, index: int) -> int:
    """Bytes of input ``index`` of a traced operator (0 where absent); a
    type without a size here raises ``ValueError``."""
    dims = op["args"]["Input Dims"][index]
    kind = op["args"]["Input type"][index]
    if not dims:
        return 0
    if kind not in DTYPE_BYTES:
        raise ValueError(f"no byte size for {kind!r}")
    n = 1
    for d in dims:
        n *= d
    return n * DTYPE_BYTES[kind]


def share(ctx, match: Callable[[str], bool], least: Callable) -> Optional[float]:
    """100 × (least time of every matching call) / (time of their kernels)
    in the traced window.  ``least(trace, op_index)`` gives one call's
    least seconds from the shape trace, or None (or ``ValueError``) where
    it cannot; the share is then None."""
    shapes, trace = ctx.shape_trace, ctx.trace
    if shapes is None or trace is None:
        return None
    calls = shapes.instances(match)
    found = trace.instances(match)
    if not calls or len(found) != len(calls) * ctx.traced_iters // ctx.shape_iters:
        return None
    per_iter = 0.0
    for i in calls:
        try:
            t = least(shapes, i)
        except ValueError:
            return None
        if t is None:
            return None
        per_iter += t
    kernel_s = trace.kernel_us(match) / 1e6
    if kernel_s <= 0.0:
        return None
    return 100.0 * per_iter * ctx.traced_iters / ctx.shape_iters / kernel_s
