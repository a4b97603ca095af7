"""Step timing, profiler traces and NaN checks (the port's counterpart of
``vault_tpu/utils/profiling.py``; the port imports nothing of that
package).

:class:`StepTimer` is host wall-clock only: a step that ends on the card
must synchronize inside the timed block to count the card's time.
:func:`trace` records the host's operators and the card's kernels with
``torch.profiler`` into a Chrome trace JSON (``chrome://tracing``,
Perfetto), where the JAX package records an xprof trace.
:func:`enable_nan_checks` is the counterpart of ``jax_debug_nans``: a NaN
that an operation of a training step produces raises at that operation.
The forward is checked by :class:`NanCheckMode`, a dispatch mode that the
trainer enters around each step while checks are on, the backward by
autograd's anomaly mode (``check_nan``).
"""

from __future__ import annotations

import contextlib
import os
import statistics
import time
from typing import Dict, List, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode


class StepTimer:
    """Wall-clock step timer with percentile summary."""

    def __init__(self):
        self.times: List[float] = []
        self._t0: Optional[float] = None

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, *exc):
        # only completed steps count: an aborted block's partial time would
        # pollute the percentiles
        if exc_type is None:
            self.times.append(time.perf_counter() - self._t0)
        return False

    def summary(self, items_per_step: Optional[int] = None) -> Dict[str, float]:
        if not self.times:
            return {}
        ts = sorted(self.times)
        out = {
            "steps": len(ts),
            "mean_s": statistics.fmean(ts),
            "p50_s": ts[len(ts) // 2],
            "p90_s": ts[int(len(ts) * 0.9)],
            "max_s": ts[-1],
        }
        if items_per_step:
            out["items_per_sec"] = items_per_step / out["mean_s"]
        return out


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the body (host operators; the card's kernels where a card
    is present) and write one Chrome trace JSON under ``log_dir`` when it
    ends, also when it raises.  Yields the ``torch.profiler.profile``."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield prof
    finally:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.stop()
        prof.export_chrome_trace(os.path.join(
            log_dir, f"trace.{os.getpid()}.{time.time_ns()}.json"))


# ops whose output is uninitialized memory, not a computed value
_UNINITIALIZED = ("empty", "empty_like", "empty_strided", "new_empty",
                  "new_empty_strided")


class NanCheckMode(TorchDispatchMode):
    """Raises ``RuntimeError`` naming the operator as soon as one returns a
    floating-point tensor that holds a NaN (a host read per operation:
    a debugging mode, not a fast one)."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func.overloadpacket.__name__ not in _UNINITIALIZED:
            for t in out if isinstance(out, (tuple, list)) else (out,):
                if (isinstance(t, torch.Tensor) and t.is_floating_point()
                        and bool(torch.isnan(t).any())):
                    raise RuntimeError(f"NaN produced by {func} (enable_nan_checks)")
        return out


_nan_checks = False


def enable_nan_checks(enable: bool = True):
    """Make a NaN that a training step produces raise at the operation
    that produced it: forward operations through :func:`nan_checks` (the
    trainer enters it around each step), backward ones through autograd's
    anomaly mode.  ``False`` turns both off."""
    global _nan_checks
    _nan_checks = bool(enable)
    torch.autograd.set_detect_anomaly(_nan_checks, check_nan=True)


def nan_checks():
    """A :class:`NanCheckMode` while :func:`enable_nan_checks` is on, else
    a context that does nothing."""
    return NanCheckMode() if _nan_checks else contextlib.nullcontext()
