"""The program's own spans in a traced window: the ``vault.*`` ranges that
the port records through ``vault_tpu_torch/utils/profiling.py`` ``span``
(each tower, encoder layer and the head; a training step's forward,
backward and optimizer), read from a :class:`devtrace.Trace`.  They share
the profiler's clock with the device's kernels, so a kernel belongs to the
spans open on its launching thread when it was launched
(``Trace.kernel_ops``), and a device idle gap to the innermost span open on
the host when it began (devtrace's rule for the benchmark's spans, applied
to nested ones).

Every function finds nothing in a trace of a program without these spans;
the readers then return None.
"""

from __future__ import annotations

import bisect
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

PREFIX = "vault."


def in_window(trace, name: Optional[str] = None) -> List[int]:
    """Indices into ``trace.ops`` of the ``vault.*`` spans (only those
    called ``name``, when given) that lie inside the traced window, in time
    order."""
    if trace is None or trace.window is None:
        return []
    lo, hi = trace.window
    found = [i for i, op in enumerate(trace.ops)
             if op["cat"] == "user_annotation" and op["name"].startswith(PREFIX)
             and (name is None or op["name"] == name)
             and lo <= op["ts"] and op["ts"] + op["dur"] <= hi]
    return sorted(found, key=lambda i: trace.ops[i]["ts"])


def durations_us(trace, name: str) -> List[float]:
    """The durations (µs) of the spans called ``name`` in the window."""
    return [trace.ops[i]["dur"] for i in in_window(trace, name)]


def kernels_under(trace, name: str) -> int:
    """The kernels launched while a span called ``name`` (in the window)
    was open on the launching thread."""
    held = set(in_window(trace, name))
    if not held:
        return 0
    return sum(1 for stack in trace.kernel_ops if held.intersection(stack))


def _gaps(trace) -> List[Tuple[float, float]]:
    """The device's idle intervals inside the window (µs)."""
    lo, hi = trace.window
    gaps, t = [], lo
    for a, b in trace.busy_intervals() + [(hi, hi)]:
        if a > t:
            gaps.append((t, a))
        t = max(t, b)
    return gaps


class _Thread:
    """One thread's spans, nested, with each span's parent: the innermost
    one open at a time is found by walking out from the last that began."""

    def __init__(self, trace, ids: List[int]):
        ids = sorted(ids, key=lambda i: (trace.ops[i]["ts"], -trace.ops[i]["dur"]))
        self.ids = ids
        self.starts = [trace.ops[i]["ts"] for i in ids]
        self.ends = [trace.ops[i]["ts"] + trace.ops[i]["dur"] for i in ids]
        self.parent, stack = [], []
        for j, start in enumerate(self.starts):
            while stack and self.ends[stack[-1]] <= start:
                stack.pop()
            self.parent.append(stack[-1] if stack else -1)
            stack.append(j)

    def innermost(self, t: float) -> int:
        """The position of the innermost span open at ``t`` (a span counts
        as open at its end, as in ``Trace.idle_gaps``), or -1."""
        j = bisect.bisect_right(self.starts, t) - 1
        while j >= 0 and self.ends[j] < t:
            j = self.parent[j]
        return j


def idle_by_span(trace) -> Dict[str, float]:
    """The device's idle seconds inside the window by the innermost
    ``vault.*`` span open on the host when each gap began (over every
    thread, the one that began last); gaps that began outside every such
    span are left out."""
    by_tid = defaultdict(list)
    for i in in_window(trace):
        by_tid[trace.ops[i]["tid"]].append(i)
    if not by_tid:
        return {}
    threads = [_Thread(trace, ids) for ids in by_tid.values()]
    total: Dict[str, float] = defaultdict(float)
    for a, b in _gaps(trace):
        best = None
        for th in threads:
            j = th.innermost(a)
            if j >= 0 and (best is None or th.starts[j] > trace.ops[best]["ts"]):
                best = th.ids[j]
        if best is not None:
            total[trace.ops[best]["name"]] += (b - a) / 1e6
    return dict(total)
