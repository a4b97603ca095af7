"""Step timing, profiler traces and NaN checks (the port's counterpart of
``vault_tpu/utils/profiling.py``; the port imports nothing of that
package).

:class:`StepTimer` is host wall-clock only: a step that ends on the card
must synchronize inside the timed block to count the card's time.
:func:`trace` records the host's operators and the card's kernels with
``torch.profiler`` into a Chrome trace JSON (``chrome://tracing``,
Perfetto), where the JAX package records an xprof trace; :func:`span`
marks the program's layers on the same timeline, and only while a profiler
records.
:func:`enable_nan_checks` is the counterpart of ``jax_debug_nans``: a NaN
that an operation of a forward or a training step produces raises at that
operation.
The forward is checked by :class:`NanCheckMode`, a dispatch mode entered
around every top-level forward while checks are on (each trainer step and
evaluation batch, ``VaultForClassification``, ``VaultWithLlamaTower`` and
``VaultWithDeepseekTower`` calls through :func:`nan_checked`, a
``VaultPipeline`` call, each batch a ``BatchingEngine`` serves on its own
thread, each replica thread of the data-parallel serving forward), the
backward by autograd's anomaly mode (``check_nan``).

The card's clocks (used by ``chip_smoke.py`` and the bench CLIs,
``cli/bench.py`` and its siblings): :func:`time_ms` is the CUDA-event time
of a call, host gaps included; :func:`device_ms` the summed durations of
the kernels it launches, from a CUPTI trace held against the CUDA-event
time of the same calls; :func:`bound_ms` the least time the H100 needs for
given bytes and operations; :func:`host_profile` where a call's host time
goes; :func:`device_record` the card's name and power limit.
"""

from __future__ import annotations

import contextlib
import functools
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional

import torch
from torch.utils._python_dispatch import (
    TorchDispatchMode,
    _get_current_dispatch_mode_stack,
)


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


_NO_SPAN = contextlib.nullcontext()


def span(name: str):
    """A named range on the profiler's clock: ``torch.profiler.
    record_function(name)`` while a profiler records, else one shared
    context that does nothing.  The flag is read at each call, since a
    profiler starts after the model is built; with none running nothing of
    the profiler is entered, so an exported or fake-tensor-traced forward
    holds no profiler node.  The program's spans (``vault.*``: the towers,
    each encoder layer, the DeepSeek tower's attention and expert halves,
    the head, a training step's forward, backward and optimizer) and
    ``train_step:<n>`` go through it; :func:`trace`'s files and
    ``portbench/spans.py`` read them."""
    if torch.autograd.profiler._is_profiler_enabled:
        return torch.profiler.record_function(name)
    return _NO_SPAN


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
    """Make a NaN that a forward or a training step produces raise at the
    operation that produced it, as ``jax_debug_nans`` does under every
    ``jit``: forward operations through :func:`nan_checks` (entered by
    every top-level forward, see the module's docstring), backward ones
    through autograd's anomaly mode.  ``False`` turns both off."""
    global _nan_checks
    _nan_checks = bool(enable)
    torch.autograd.set_detect_anomaly(_nan_checks, check_nan=True)


def nan_checks():
    """A :class:`NanCheckMode` while :func:`enable_nan_checks` is on and
    none is active on this thread yet, else a context that does nothing
    (a served model's forward inside the engine's mode checks each
    operator once)."""
    if _nan_checks and not any(isinstance(m, NanCheckMode)
                               for m in _get_current_dispatch_mode_stack()):
        return NanCheckMode()
    return contextlib.nullcontext()


def nan_checked(fn):
    """``fn`` under :func:`nan_checks` while the checks are on; with them
    off the wrapper costs one call and one ``if``."""

    @functools.wraps(fn)
    def checked(*args, **kwargs):
        if not _nan_checks:
            return fn(*args, **kwargs)
        with nan_checks():
            return fn(*args, **kwargs)

    return checked


# ---------------------------------------------------------------------------
# The card's clocks
# ---------------------------------------------------------------------------

PEAK_BF16_FLOPS = 989e12   # H100 SXM dense bf16 tensor-core rate
PEAK_INT8_OPS = 1979e12    # H100 SXM dense int8 tensor-core rate
PEAK_F32_FLOPS = 67e12     # H100 SXM fp32 without tensor cores
PEAK_BYTES = 3.35e12       # H100 SXM HBM3


def time_ms(fn, iters=20, warmup=3):
    """Wall time per call between CUDA events: includes any gap the host
    leaves between launches."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# A CUPTI trace is held against the CUDA-event time of the same calls.  The
# calls are queued behind a spin kernel long enough for the host to queue
# them all, so the card runs them back to back and the event time is the
# kernels' summed durations plus a launch gap after each kernel.  A trace
# whose sum falls short of the event time by more than LAUNCH_GAP_MS a
# kernel and TRACE_SHORT_SHARE of the event time, or whose sum exceeds the
# event time by more than TRACE_LONG_SHARE (kernels of one stream cannot
# overlap), is bad and is taken again; TRACE_ATTEMPTS bad traces in a row
# raise.  The limits lie between the readings (NVIDIA H100 80GB HBM3):
# good traces left gaps of 0.0012-0.0042 ms a kernel (never more than
# 0.0042), and the short ones seen read 2/3 and 0.73 of it (a 7-kernel
# call of 0.11 ms at 2/3 is short by 0.037 ms, above 7 x 0.003 + 0.011;
# one attention kernel at 0.73 by about 0.019, above 0.003 + 0.007).
# Calls the host could not queue before the spin ended (a call that waits
# on the card) leave idle gaps the check cannot tell from a short trace:
# their traces are kept unchecked.  TRACE_LOG counts both kinds and every
# bad trace's ratio (kernel sum / event time), and per count of kernels a
# call its good traces, their largest gap a kernel and their lowest ratio.
TRACE_SHORT_SHARE = 0.1
TRACE_LONG_SHARE = 0.05
LAUNCH_GAP_MS = 0.003
TRACE_ATTEMPTS = 3
# A trace that holds no device events at all (CUPTI hands one back now and
# then: 4 of 192 traces in one full chip_smoke.py run, three in a row in
# another, on a 16-token attention) is taken again, up to this many times;
# the check of a trace against its event time keeps its TRACE_ATTEMPTS.
# TRACE_LOG["retried"] names each timed function that took more than
# TRACE_ATTEMPTS traces, with the traces it took.
EMPTY_TRACE_ATTEMPTS = 8
SPIN_CYCLES_PER_MS = 1.98e6  # the H100's top SM clock: a spin at least this long
TRACE_LOG = {"checked": 0, "unchecked": 0, "bad_ratios": [], "no_device_time": 0,
             "good_by_kernels": {}, "retried": {}}


def _fn_name(fn) -> str:
    """A timed function's name and the line it is defined on."""
    code = getattr(fn, "__code__", None)
    return f"{fn.__qualname__}:{code.co_firstlineno}" if code else repr(fn)


def _traced(fn, traces: int) -> None:
    if traces > TRACE_ATTEMPTS:
        TRACE_LOG["retried"][_fn_name(fn)] = traces


def device_ms(fn, iters=20, warmup=3):
    """Device time per call: the summed durations of the CUDA kernels the
    call launches, from a torch.profiler trace (CUPTI), each trace held
    against the CUDA-event time of the same calls (``TRACE_SHORT_SHARE``).
    Returns (ms, {kernel name: ms}); raises after ``TRACE_ATTEMPTS`` traces
    that fail the check or ``EMPTY_TRACE_ATTEMPTS`` that hold no device
    time."""
    from torch.profiler import ProfilerActivity, profile

    t0 = time.perf_counter()
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    # the spin: twice the host time the calls took in the warm-up
    spin_ms = min(500.0, 2.0 * iters * (time.perf_counter() - t0) * 1e3 / warmup) if warmup else 0.0
    empty = bad = 0
    while True:
        attempt = empty + bad
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            ev[0].record()
            if spin_ms:
                torch.cuda._sleep(int(spin_ms * SPIN_CYCLES_PER_MS))
            ev[1].record()
            t_host = time.perf_counter()
            for _ in range(iters):
                fn()
            ev[2].record()
            queued_ms = (time.perf_counter() - t_host) * 1e3
            torch.cuda.synchronize()
        by_name, n_kernels = {}, 0
        for e in prof.events():
            if e.device_type == torch.autograd.DeviceType.CUDA and "spin_kernel" not in e.name:
                name = e.name.replace("(anonymous namespace)::", "")
                name = name.removeprefix("void ").split("(")[0]
                # the wgmma core's instances keep their tile width, mode
                # and epilogue
                if "gemm_kernel<" not in name:
                    name = name.split("<")[0][:60]
                by_name[name] = by_name.get(name, 0.0) + e.time_range.elapsed_us() / 1e3 / iters
                n_kernels += 1
        total = sum(by_name.values())
        if total <= 0.0:
            # CUPTI has handed back a trace without device events (once in
            # ten runs, cause not found)
            TRACE_LOG["no_device_time"] += 1
            empty += 1
            print(f"device_ms: profiler trace {attempt + 1} of {_fn_name(fn)} holds no device "
                  f"time ({len(prof.events())} host events)", file=sys.stderr, flush=True)
            if empty >= EMPTY_TRACE_ATTEMPTS:
                raise RuntimeError(f"{empty} profiler traces of {_fn_name(fn)} hold no "
                                   "device time")
            continue
        if not spin_ms or queued_ms >= ev[0].elapsed_time(ev[1]):
            TRACE_LOG["unchecked"] += 1
            _traced(fn, attempt + 1)
            return total, by_name
        event_ms = ev[1].elapsed_time(ev[2]) / iters
        gaps_ms = n_kernels / iters * LAUNCH_GAP_MS
        if (event_ms - total - gaps_ms <= TRACE_SHORT_SHARE * event_ms
                and total <= (1.0 + TRACE_LONG_SHARE) * event_ms):
            TRACE_LOG["checked"] += 1
            good = TRACE_LOG["good_by_kernels"].setdefault(str(round(n_kernels / iters)),
                                                           [0, 0.0, 1.0])
            good[0] += 1
            good[1] = max(good[1], (event_ms - total) * iters / n_kernels)
            good[2] = min(good[2], total / event_ms)
            _traced(fn, attempt + 1)
            return total, by_name
        TRACE_LOG["bad_ratios"].append(total / event_ms)
        bad += 1
        print(f"device_ms: profiler trace {attempt + 1} of {_fn_name(fn)}: kernel sum {total:.4f} ms "
              f"({n_kernels / iters:.0f} kernels) is {total / event_ms:.3f} of the "
              f"CUDA-event time of the same calls", file=sys.stderr, flush=True)
        if bad >= TRACE_ATTEMPTS:
            raise RuntimeError(f"{bad} profiler traces disagree with the CUDA-event time of "
                               f"their calls ({TRACE_LOG['bad_ratios'][-TRACE_ATTEMPTS:]})")


def bound_ms(flops: float, nbytes: float, dtype, peak=None) -> tuple:
    """(ms, "operations" or "bytes"): the larger of ``flops`` over the
    card's peak rate for ``dtype`` (or ``peak``) and ``nbytes`` over its
    memory rate, and which of the two it is."""
    if peak is None:
        peak = PEAK_BF16_FLOPS if dtype == torch.bfloat16 else PEAK_F32_FLOPS
    t_ops, t_bytes = flops / peak, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def host_profile(fn, iters=3, top=10):
    """Where the host time of ``fn`` goes, ms per call: the PyTorch ops by
    self CPU time (torch.profiler CPU trace, with their calls per call), and
    the Python functions by own time (cProfile, which inflates Python time;
    read it for proportions)."""
    import cProfile
    import pstats

    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    ops = sorted(prof.key_averages(), key=lambda e: -e.self_cpu_time_total)[:top]
    pr = cProfile.Profile()
    pr.enable()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    pr.disable()
    st = pstats.Stats(pr).stats  # (file, line, name) -> (cc, nc, tt, ct, callers)
    funcs = sorted(st.items(), key=lambda kv: -kv[1][2])[:top]
    return {
        "torch_ops_self_ms": {e.key[:60]: [e.self_cpu_time_total / 1e3 / iters,
                                           e.count // iters] for e in ops},
        "python_own_ms": {f"{Path(k[0]).name}:{k[2]}": [v[2] * 1e3 / iters,
                                                         v[1] // iters]
                          for k, v in funcs},
    }


def device_record(device) -> Dict[str, Optional[str]]:
    """The card's name and power limit as ``nvidia-smi --query-gpu=name,
    power.limit --format=csv,noheader`` gives them (a device's numbers are
    read beside its limit: a card set below its maximum runs slower under
    load); the host's processor for the CPU."""
    if torch.device(device).type != "cuda":
        import platform

        return {"name": platform.processor() or platform.machine() or "cpu",
                "power_limit": None}
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()
    index = torch.device(device).index or 0
    name, power = (f.strip() for f in smi[index].split(",", 1))
    return {"name": name, "power_limit": power}
