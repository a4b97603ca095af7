"""Step timing (a copy of ``StepTimer`` from ``vault_tpu/utils/profiling.py``;
the port imports nothing of that package).  Host wall-clock only: a step
that ends on the card must synchronize inside the timed block to count the
card's time."""

from __future__ import annotations

import statistics
import time
from typing import Dict, List, Optional


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
