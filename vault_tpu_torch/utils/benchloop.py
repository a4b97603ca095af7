"""Chained-loop benchmarking helpers (port of ``vault_tpu/utils/benchloop.py``).

The bench CLIs (``cli/bench.py``, ``cli/train_bench.py``,
``cli/perf_sweep.py``, ``cli/ablate_train.py``) time a chain of K forwards
or training steps and report the slope (t(K_hi) - t(K_lo)) / (K_hi - K_lo),
so what a call costs once (the final fetch, the first launch's warm-up)
cancels.  The slope measures the whole model only if every iteration does
the whole model's work.  In the JAX package XLA's loop-invariant code
motion hoisted the text tower out of the timing loop for three rounds,
because only ``pixel_values`` carried the loop (``benchloop.py:1-30``
there).  Eager PyTorch hoists nothing, but work dropped from an iteration
without an error (a CUDA graph captured per input shape, a tower's output
cached, ``torch.compile`` over an unrolled chain) would vanish from the
slope the same way.

:func:`feedback_batch` makes every input of an iteration depend on the last
iteration's output, as in the JAX package: floats get a tiny additive term,
integers (ids, masks) ``isnan(feedback)`` cast to their type, zero at run
time, so their values stay bit-identical.  :func:`make_chained_forward`
builds the chain, :func:`slope_ms` times it.

:func:`product_placement` is the eager counterpart of the JAX package's
``matmul_loop_placement`` / ``chained_hlo_is_sound`` (an HLO walk there):
a dispatch mode counts the product-bearing operators (aten ``mm``,
``addmm``, ``bmm``, ``_int_mm``, ``convolution``, ... and every
``vault_tpu_torch::`` kernel operator) of one direct call and of the chain
at two lengths; every product of the direct call must appear once per
iteration.  On the card it also compares the kernels' launch counters per
iteration.
"""

from __future__ import annotations

import os
import time
import traceback
import warnings
from collections import Counter
from typing import Callable, Dict, NamedTuple, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

Batch = Dict[str, object]


def feedback_batch(batch: Batch, feedback: torch.Tensor,
                   float_scale: float = 1.0) -> Batch:
    """Copy of ``batch`` where every tensor depends on ``feedback``.

    ``feedback`` is a scalar on the batch's device derived from the previous
    iteration's output (callers scale it to be numerically negligible,
    ``out[0, 0] * 1e-9``).  Floats get ``+ feedback * float_scale`` in their
    own dtype; integers get ``isnan(feedback)`` cast to their dtype, zero at
    run time, so their values are bit-identical while still loop-carried.
    No value is read on the host.  Entries that are not tensors pass
    through."""
    fb32 = feedback.to(torch.float32) * float_scale
    zero = torch.isnan(fb32)  # False at run time; only a NaN output makes it 1
    out = {}
    for key, val in batch.items():
        if not isinstance(val, torch.Tensor):
            out[key] = val
        elif val.is_floating_point():
            out[key] = val + fb32.to(val.dtype)
        else:
            out[key] = val + zero.to(val.dtype)
    return out


def next_feedback(out: torch.Tensor) -> torch.Tensor:
    """The next iteration's feedback from an output: ``(out[0, 0] * 1e-9)``
    in bf16, the scale taken in ``out``'s dtype first as the JAX package's
    weakly typed ``1e-9`` is."""
    scale = torch.full((), 1e-9, dtype=out.dtype, device=out.device)
    return (out[0, 0] * scale).to(torch.bfloat16)


def make_chained_forward(apply_fn: Callable[[object, Batch], torch.Tensor],
                         pooled_shape: Tuple[int, ...]
                         ) -> Callable[[object, Batch, int], torch.Tensor]:
    """The chained timing function: ``chained(model, batch, k)`` runs ``k``
    forwards ``apply_fn(model, batch) -> (B, N) output``, iteration ``i + 1``
    reading ``feedback_batch(batch, next_feedback(out_i))``, and returns the
    last output (bf16 zeros of ``pooled_shape`` at ``k == 0``).  The caller
    fetches one element of it: that read is the barrier."""

    def chained(model, batch: Batch, k: int) -> torch.Tensor:
        dev = next(v for v in batch.values() if isinstance(v, torch.Tensor)).device
        fb = torch.zeros((), dtype=torch.bfloat16, device=dev)
        out = torch.zeros(pooled_shape, dtype=torch.bfloat16, device=dev)
        for _ in range(k):
            out = apply_fn(model, feedback_batch(batch, fb))
            fb = next_feedback(out)
        return out

    return chained


def slope_ms(run: Callable[[int], object], k_lo: int, k_hi: int, repeats: int = 3,
             device="cpu") -> Dict[str, float]:
    """Per-iteration ms of ``run(k)`` (a chain of ``k`` iterations ending in
    a fetch to the host), ``(t(k_hi) - t(k_lo)) / (k_hi - k_lo)``, each ``t``
    the best of ``repeats``.  On the card ``t`` is the CUDA-event time
    around the chain, taken after a synchronize that follows the fetch; on
    the CPU the host's clock.  ``run(1)`` runs once first (warm-up).
    Returns {"ms", "t_lo_ms", "t_hi_ms"}."""
    if k_hi <= k_lo:
        raise ValueError(f"k_hi {k_hi} must exceed k_lo {k_lo}")
    cuda = torch.device(device).type == "cuda"
    run(1)

    def t_ms(k: int) -> float:
        best = float("inf")
        for _ in range(repeats):
            if cuda:
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                torch.cuda.synchronize()
                start.record()
                run(k)
                end.record()
                torch.cuda.synchronize()
                best = min(best, start.elapsed_time(end))
            else:
                t0 = time.perf_counter()
                run(k)
                best = min(best, (time.perf_counter() - t0) * 1e3)
        return best

    t_lo, t_hi = t_ms(k_lo), t_ms(k_hi)
    return {"ms": (t_hi - t_lo) / (k_hi - k_lo), "t_lo_ms": t_lo, "t_hi_ms": t_hi}


# ---------------------------------------------------------------------------
# The structural guard
# ---------------------------------------------------------------------------

# aten operators that carry a product (``linear`` and ``matmul`` reach a
# dispatch mode only where they are not decomposed first)
PRODUCT_OPS = frozenset(("mm", "addmm", "bmm", "baddbmm", "addbmm", "_int_mm",
                         "convolution", "linear", "matmul"))
KERNEL_NAMESPACE = "vault_tpu_torch"


class ProductCount(TorchDispatchMode):
    """Counts, by name, the product-bearing operators dispatched under it:
    :data:`PRODUCT_OPS` of aten and every ``vault_tpu_torch::`` kernel
    operator (a kernel is one operator, whatever it launches)."""

    def __init__(self):
        super().__init__()
        self.counts: Counter = Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func.overloadpacket.__name__
        if func.namespace == KERNEL_NAMESPACE or (
                func.namespace == "aten" and name in PRODUCT_OPS):
            self.counts[f"{func.namespace}::{name}"] += 1
        return func(*args, **(kwargs or {}))


def count_products(fn: Callable[[], object]) -> Counter:
    """The product-bearing operators ``fn()`` dispatches, by name."""
    with ProductCount() as mode:
        fn()
    return mode.counts


def launch_counters() -> Dict[str, Callable]:
    """Every kernel wrapper of the model's forward and backward that counts
    its launches (``<wrapper>.launches``), by the kernel's name.  The
    optimizer's kernel (``ops/cuda_adamw.py`` ``fused_adamw.launches``,
    with ``HfAdamW.fused_leaves``) is counted apart: the launch tables
    built from these count the model's kernels, over a whole training step
    too."""
    from vault_tpu_torch.ops import cuda_attention as ca
    from vault_tpu_torch.ops import cuda_linear as clin
    from vault_tpu_torch.ops import cuda_ln_qkv as cl
    from vault_tpu_torch.ops import cuda_mlp as cm
    from vault_tpu_torch.ops import cuda_swiglu as cs

    return {"encoder_attention": ca.fused_attention,
            "attention_bwd": ca.fused_attention_bwd,
            "attention_gqa": ca.fused_attention_gqa,
            "swiglu_w8a8": cs.fused_swiglu_block_fwd_w8a8,
            "mlp_block_q8": cm.fused_mlp_block_fwd_q8,
            "mlp_postln_q8": cm.fused_mlp_postln_fwd_q8,
            "mlp_block": cm.fused_mlp_block_fwd,
            "mlp_postln": cm.fused_mlp_postln_fwd,
            "mlp_block_bwd": cm.fused_mlp_block_bwd,
            "mlp_postln_bwd": cm.fused_mlp_postln_block_bwd,
            "ln_qkv": cl.fused_ln_qkv_fwd,
            "ln_qkv_w8a8": cl.fused_ln_qkv_fwd_w8a8,
            "mlp_block_w8a8": cm.fused_mlp_block_fwd_w8a8,
            "mlp_postln_w8a8": cm.fused_mlp_postln_fwd_w8a8,
            "linear_w8a8": clin.linear_w8a8}


def count_launches(fn: Callable[[], object]) -> Dict[str, int]:
    """The kernel launches ``fn()`` makes, by kernel (the wrappers'
    counters before and after; the counters are not reset)."""
    counters = launch_counters()
    before = {name: w.launches for name, w in counters.items()}
    fn()
    return {name: w.launches - before[name] for name, w in counters.items()}


class Placement(NamedTuple):
    """What :func:`product_placement` found: ``inside``, the products the
    chain runs over its ``k_hi - k_lo`` extra iterations; ``outside``, those
    of as many direct calls that the chain did not run; ``per_call``, the
    products of one direct call; on the card, ``launches_inside`` /
    ``launches_outside`` the same by kernel launch counter (None on the
    CPU)."""

    inside: int
    outside: int
    per_call: int
    launches_inside: Optional[Dict[str, int]] = None
    launches_outside: Optional[Dict[str, int]] = None

    @property
    def sound(self) -> bool:
        launches_ok = self.launches_outside is None or not any(self.launches_outside.values())
        return self.outside == 0 and self.inside > 0 and launches_ok


def product_placement(chained: Callable, one: Callable, model, batch: Batch,
                      k_lo: int = 1, k_hi: int = 3) -> Placement:
    """Count the product-bearing operators of ``one(model, batch)`` and of
    ``chained(model, batch, k)`` at ``k_lo`` and ``k_hi``: ``inside =
    count(k_hi) - count(k_lo)``, ``outside = (k_hi - k_lo) * count(one) -
    inside``.  Sound: ``outside == 0`` and ``inside > 0`` (and, on the card,
    every kernel's launches per iteration equal a direct call's).  A chain
    that computes part of the model once, outside its iterations (the JAX
    package's rounds-1-3 pattern: the text tower's output reused), shows
    that part's products as ``outside``."""
    cuda = any(isinstance(v, torch.Tensor) and v.is_cuda for v in batch.values())
    products = [sum(count_products(f).values()) for f in (
        lambda: one(model, batch), lambda: chained(model, batch, k_lo),
        lambda: chained(model, batch, k_hi))]
    span = k_hi - k_lo
    inside = products[2] - products[1]
    l_in = l_out = None
    if cuda:
        one_l, lo_l, hi_l = (count_launches(f) for f in (
            lambda: one(model, batch), lambda: chained(model, batch, k_lo),
            lambda: chained(model, batch, k_hi)))
        l_in = {k: hi_l[k] - lo_l[k] for k in one_l}
        l_out = {k: span * one_l[k] - l_in[k] for k in one_l}
    return Placement(inside, span * products[0] - inside, products[0], l_in, l_out)


# ---------------------------------------------------------------------------
# Host synchronizations
# ---------------------------------------------------------------------------

def host_syncs(fn: Callable[[], object]) -> Counter:
    """The synchronizing CUDA operations ``fn()`` makes (each a host wait on
    the card), counted under ``torch.cuda.set_sync_debug_mode("warn")`` by
    where they come from: the PyTorch function that synchronized and the
    first caller outside PyTorch (``file:line function``)."""
    torch_dir = os.path.dirname(torch.__file__)
    sites: Counter = Counter()
    inside = [False]  # switching the mode itself synchronizes: not fn's

    def record(message, category, filename, lineno, file=None, line=None):
        if not inside[0] or "synchroniz" not in str(message):
            return
        # without this function and the warnings module's own frames
        stack = [f for f in traceback.extract_stack()[:-1] if f.filename != warnings.__file__]
        inner = stack[-1] if stack else None
        caller = next((f for f in reversed(stack) if not f.filename.startswith(torch_dir)),
                       None)
        where = "?" if caller is None else f"{caller.filename}:{caller.lineno} {caller.name}"
        sites[f"{inner.name if inner else '?'} ({filename}:{lineno}) <- {where}"] += 1

    previous = torch.cuda.get_sync_debug_mode()
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = record
        torch.cuda.set_sync_debug_mode("warn")
        inside[0] = True
        try:
            fn()
        finally:
            inside[0] = False
            torch.cuda.set_sync_debug_mode(previous)
    return sites
