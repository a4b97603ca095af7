"""The device trace of a traced window: ``torch.profiler`` (CUPTI) over a
fixed number of iterations, read from its Chrome trace.

A kernel belongs to the host operators that were open on the launching
thread when its launch call ran (the launch call and the kernel share a
CUPTI correlation id), so a metric finds the kernels of an operator such as
``vault_tpu_torch::attention`` whatever their symbols are.

CUPTI now and then hands back a trace without device events or with
kernels missing.  :meth:`Trace.problem` names such a trace: no device
activity, no window, or a launch call whose kernel is absent; :func:`capture`
takes the window again, and raises after ``ATTEMPTS`` such traces.
"""

from __future__ import annotations

import bisect
import json
import os
import sys
import tempfile
from collections import defaultdict
from typing import Callable, Dict, List, Optional, Tuple

WINDOW = "portbench.window"
SPAN_PREFIX = "portbench."
ATTEMPTS = 4
# launch calls whose kernel may be absent before the trace counts as short
MISSING_SHARE = 0.001
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


def _is_launch(name: str) -> bool:
    return "LaunchKernel" in name or "LaunchCooperativeKernel" in name


def short_name(name: str) -> str:
    """A kernel's symbol without its return type, parameters and the
    anonymous namespace, at most 96 characters."""
    name = name.replace("(anonymous namespace)::", "").removeprefix("void ")
    depth, out = 0, []
    for ch in name:
        if ch == "(" and depth == 0:
            break
        depth += ch == "<"
        depth -= ch == ">"
        out.append(ch)
    return "".join(out)[:96]


class Trace:
    """The events of one Chrome trace (``traceEvents``)."""

    def __init__(self, events: List[dict]):
        xs = [e for e in events if e.get("ph") == "X"]
        self.ops = [e for e in xs if e.get("cat") in ("cpu_op", "user_annotation")]
        self.device = [e for e in xs if e.get("cat") in DEVICE_CATS]
        self.kernels = [e for e in self.device if e["cat"] == "kernel"]
        launches = [e for e in xs if e.get("cat") in LAUNCH_CATS and _is_launch(e["name"])]
        windows = [e for e in self.ops if e["name"] == WINDOW]
        self.window: Optional[Tuple[float, float]] = (
            (windows[0]["ts"], windows[0]["ts"] + windows[0]["dur"]) if windows else None)
        corr = {e["args"].get("correlation") for e in self.device}
        self.missing = sum(e["args"].get("correlation") not in corr for e in launches)
        self.launches = len(launches)
        # the host operators open at each launch call, outermost first
        stacks = self._stacks(launches)
        by_corr = {e["args"].get("correlation"): stacks[i] for i, e in enumerate(launches)}
        self.kernel_ops: List[Tuple[int, ...]] = [
            by_corr.get(k["args"].get("correlation"), ()) for k in self.kernels]

    def _stacks(self, launches: List[dict]) -> List[Tuple[int, ...]]:
        items = defaultdict(list)
        for i, op in enumerate(self.ops):
            items[op["tid"]].append((op["ts"], 0, -op["dur"], i))
        for j, ev in enumerate(launches):
            items[ev["tid"]].append((ev["ts"], 1, 0.0, j))
        out: List[Tuple[int, ...]] = [()] * len(launches)
        for tid_items in items.values():
            tid_items.sort()
            stack: List[int] = []
            for ts, kind, _, idx in tid_items:
                while stack and self.ops[stack[-1]]["ts"] + self.ops[stack[-1]]["dur"] < ts:
                    stack.pop()
                if kind == 0:
                    stack.append(idx)
                else:
                    out[idx] = tuple(stack)
        return out

    def problem(self) -> Optional[str]:
        """Why this trace cannot be read, or None."""
        if self.window is None:
            return f"no {WINDOW} span"
        if not self.kernels:
            return f"no device events ({len(self.ops)} host events)"
        if self.missing > MISSING_SHARE * self.launches:
            return f"{self.missing} of {self.launches} launch calls have no kernel"
        return None

    def busy_intervals(self) -> List[Tuple[float, float]]:
        """The union of the device's activity inside the window (µs)."""
        lo, hi = self.window
        spans = sorted((max(e["ts"], lo), min(e["ts"] + e["dur"], hi)) for e in self.device
                       if e["ts"] + e["dur"] > lo and e["ts"] < hi)
        out: List[List[float]] = []
        for a, b in spans:
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return [(a, b) for a, b in out]

    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e6

    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals()) / 1e6

    def device_ops(self, top: int = 10) -> List[list]:
        """The kernels that took the most time: [name, seconds]."""
        total: Dict[str, float] = defaultdict(float)
        for k in self.kernels:
            total[short_name(k["name"])] += k["dur"] / 1e6
        return [[n, s] for n, s in sorted(total.items(), key=lambda kv: -kv[1])[:top]]

    def idle_gaps(self, top: int = 10) -> List[list]:
        """The device's idle time inside the window by the benchmark span the
        host was in when each gap began: [span, seconds]."""
        lo, hi = self.window
        spans = sorted((e["ts"], e["ts"] + e["dur"], e["name"]) for e in self.ops
                       if e["cat"] == "user_annotation" and e["name"].startswith(SPAN_PREFIX)
                       and e["name"] != WINDOW)
        starts = [s[0] for s in spans]
        gaps, t = [], lo
        for a, b in self.busy_intervals() + [(hi, hi)]:
            if a > t:
                gaps.append((t, a))
            t = max(t, b)
        total: Dict[str, float] = defaultdict(float)
        for a, b in gaps:
            i = bisect.bisect_right(starts, a) - 1
            name = spans[i][2] if i >= 0 and spans[i][1] >= a else "outside any span"
            total[name] += (b - a) / 1e6
        return [[n, s] for n, s in sorted(total.items(), key=lambda kv: -kv[1])[:top]]

    def instances(self, match: Callable[[str], bool]) -> List[int]:
        """Indices of the host operators that ``match`` and lie inside no
        other matching operator, in time order."""
        found = [i for i, op in enumerate(self.ops) if op["cat"] == "cpu_op" and match(op["name"])]
        found.sort(key=lambda i: self.ops[i]["ts"])
        outer, end = [], {}
        for i in found:
            op = self.ops[i]
            last = end.get(op["tid"])
            if last is not None and op["ts"] + op["dur"] <= last:
                continue
            end[op["tid"]] = op["ts"] + op["dur"]
            outer.append(i)
        return outer

    def kernel_us(self, match: Callable[[str], bool]) -> float:
        """Summed duration of the kernels launched under a matching operator."""
        return sum(k["dur"] for k, stack in zip(self.kernels, self.kernel_ops)
                   if any(match(self.ops[i]["name"]) for i in stack))

    def forward_of(self, op_index: int, forward_name: str) -> Optional[dict]:
        """The autograd forward operator ``forward_name`` of a backward
        operator, by the sequence number both carry."""
        back = self.ops[op_index]
        seq = back["args"].get("Sequence number")
        found = [op for op in self.ops if op["name"] == forward_name
                 and op["args"].get("Sequence number") == seq and op["ts"] < back["ts"]]
        return max(found, key=lambda op: op["ts"]) if seq is not None and found else None


def load(path: str) -> Trace:
    with open(path) as f:
        return Trace(json.load(f)["traceEvents"])


def capture(run: Callable[[], None], record_shapes: bool = False) -> Trace:
    """Trace ``run()`` (which ends on a device synchronisation) inside the
    ``portbench.window`` span, taking it again while the trace is empty or
    short."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    for attempt in range(ATTEMPTS):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     record_shapes=record_shapes) as prof:
            with record_function(WINDOW):
                run()
                torch.cuda.synchronize()
        fd, path = tempfile.mkstemp(suffix=".json", prefix="portbench-trace-")
        os.close(fd)
        try:
            prof.export_chrome_trace(path)
            trace = load(path)
        finally:
            os.remove(path)
        why = trace.problem()
        if why is None:
            return trace
        print(f"portbench: trace {attempt + 1} of {ATTEMPTS} unreadable: {why}",
              file=sys.stderr, flush=True)
    raise RuntimeError(f"{ATTEMPTS} profiler traces in a row were empty or short")
