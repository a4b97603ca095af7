"""Experiment logging/config subsystem (a copy of
``vault_tpu/training/experiment.py``; the port imports nothing of that
package).

Behavior-compatible rebuild of the reference's ``ExperimentHandler``
(vault/logging_utils.py:12-733) — the layout it writes is part of the public
contract (README.md:162-219):

    <root>/<experiment_name>/<v1,v2,...>_<k>/
        metrics.yml                # per-run series + finals, experiment_N blocks
        params.yml                 # hyperparameter snapshot
        aggregated_metrics.yml     # mean+-std across runs (and median/trimmed)
        obj.pkl                    # pickled handler state
        plots/<metric>.png         # metric curves with std bands

Naming: the folder base is the comma-joined *values* of the name-params with
filesystem-hostile chars swapped ("/"->"√", ","->";", "="->"≈",
vault/logging_utils.py:307-314); the trailing ``_k`` separates runs whose
non-disabled params differ (same params => same folder, extra runs append as
``experiment_N``; vault/logging_utils.py:89-126, 316-372).

PyYAML is imported inside the methods that read or write files, and
matplotlib inside :meth:`ExperimentHandler.plot` (which does nothing
without it), so the module imports where neither is installed.
"""

from __future__ import annotations

import os
import pickle
from typing import Any, Dict, List, Optional, Sequence

import numpy as np


class _ForeignHandlerState:
    """Stand-in for an unimportable pickled handler class: absorbs the
    instance ``__dict__`` (the reference handler's entire state,
    vault/logging_utils.py:78-83)."""

    def __setstate__(self, d):
        self.__dict__ = d


class _TolerantUnpickler(pickle.Unpickler):
    """Unpickler that substitutes :class:`_ForeignHandlerState` for any
    class it cannot import (e.g. the reference's
    ``vault.logging_utils.ExperimentHandler``)."""

    def find_class(self, module, name):
        try:
            return super().find_class(module, name)
        except (ImportError, AttributeError):
            return _ForeignHandlerState


def sanitize(value: Any) -> str:
    return str(value).replace("/", "√").replace(",", ";").replace("=", "≈")


def _fmt(x: float) -> float:
    return float(x)


class ExperimentHandler:
    """Param registry + metric logger + cross-run aggregator."""

    def __init__(self, root: str = "./experiment_logs", experiment_name: str = "run"):
        self._root = root
        self._experiment_name = experiment_name
        self._params: Dict[str, Any] = {}
        self._name_params: List[str] = []
        self._disabled: set = set()
        self._parents: Dict[str, str] = {}
        self._series: Dict[str, List[float]] = {}
        self._finals: Dict[str, float] = {}
        self._dir: Optional[str] = None

    # -- params ------------------------------------------------------------
    def set_param(self, key: str, value: Any, name: bool = False,
                  disabled: bool = False, parent: Optional[str] = None):
        """``parent``: this param only counts toward run identity when the
        parent param's value is truthy (reference parent-param semantics,
        vault/logging_utils.py:150-255)."""
        self._params[key] = value
        if name and key not in self._name_params:
            self._name_params.append(key)
        if disabled:
            self._disabled.add(key)
        if parent is not None:
            self._parents[key] = parent

    def set_params(self, params: Dict[str, Any]):
        for k, v in params.items():
            self.set_param(k, v)

    def set_name_params(self, keys: Sequence[str]):
        self._name_params = list(keys)

    def disable_params(self, keys: Sequence[str]):
        self._disabled.update(keys)

    def __getattr__(self, key):
        params = self.__dict__.get("_params", {})
        if key in params:
            return params[key]
        raise AttributeError(key)

    def effective_params(self) -> Dict[str, Any]:
        out = {}
        for k, v in self._params.items():
            if k in self._disabled:
                continue
            parent = self._parents.get(k)
            if parent is not None and not self._params.get(parent):
                continue  # gated by a disabled/falsy parent feature
            out[k] = v
        return out

    # -- directory resolution ---------------------------------------------
    def _base_name(self) -> str:
        vals = [sanitize(self._params.get(k)) for k in self._name_params]
        return ",".join(vals) if vals else "default"

    def directory(self) -> str:
        if self._dir is not None:
            return self._dir
        import yaml

        parent = os.path.join(self._root, self._experiment_name)
        os.makedirs(parent, exist_ok=True)
        base = self._base_name()
        mine = {k: str(v) for k, v in self.effective_params().items()}
        k = 0
        while True:
            cand = os.path.join(parent, f"{base}_{k}")
            pfile = os.path.join(cand, "params.yml")
            if not os.path.exists(cand):
                os.makedirs(cand, exist_ok=True)
                self._dir = cand
                return cand
            if os.path.exists(pfile):
                with open(pfile) as f:
                    theirs = {kk: str(vv) for kk, vv in (yaml.safe_load(f) or {}).items()}
                if theirs == mine:
                    self._dir = cand
                    return cand
            k += 1

    @property
    def model_save_filename(self) -> str:
        return os.path.join(self.directory(), "model.ckpt")

    # -- metrics -----------------------------------------------------------
    def set_metric(self, key: str, value: float):
        self._series.setdefault(key, []).append(_fmt(value))

    def set_dict_metrics(self, results: Dict[str, float], test: bool = False):
        """Per-eval-window metric series; ``test=True`` stores final scalars
        under a ``test_`` prefix (reference trainer: tmsc_utils/trainer.py:
        386, 419-425)."""
        for k, v in results.items():
            if test:
                self._finals[f"test_{k}"] = _fmt(v)
            else:
                self.set_metric(k, v)

    def set_final(self, key: str, value: float):
        """Record a run-level scalar (written once per experiment block)."""
        self._finals[key] = _fmt(value)

    def set_best(self, best_metrics: Dict[str, Any]):
        """Record the early-stopping best_* scalars (train_utils.py:150-171);
        ``best_step`` selects which series index counts as final."""
        for k, v in best_metrics.items():
            key = k if k.startswith("best_") else f"best_{k}"
            if isinstance(v, (int, float, np.floating, np.integer)):
                self._finals[key] = _fmt(v)

    # -- persistence -------------------------------------------------------
    def log(self):
        import yaml

        d = self.directory()
        with open(os.path.join(d, "params.yml"), "w") as f:
            yaml.safe_dump({k: _yamlable(v) for k, v in self.effective_params().items()}, f)
        mfile = os.path.join(d, "metrics.yml")
        existing = {}
        if os.path.exists(mfile):
            with open(mfile) as f:
                existing = yaml.safe_load(f) or {}
        idx = len(existing)
        block: Dict[str, Any] = {k: list(v) for k, v in self._series.items()}
        block.update(self._finals)
        existing[f"experiment_{idx}"] = block
        with open(mfile, "w") as f:
            yaml.safe_dump(existing, f)
        with open(os.path.join(d, "obj.pkl"), "wb") as f:
            pickle.dump({
                "params": self._params,
                "name_params": self._name_params,
                "disabled": sorted(self._disabled),
                # parent gating must survive the round trip: without it a
                # reloaded handler's effective_params() regains the
                # parent-disabled keys, params.yml stops matching, and the
                # next run splits into a fresh _k+1 folder instead of
                # aggregating (reference pickles the whole instance, so its
                # _parent_param_dict always survives)
                "parents": self._parents,
                "series": self._series,
                "finals": self._finals,
            }, f)

    @classmethod
    def load_existent(cls, directory: str) -> "ExperimentHandler":
        """Load a handler snapshot from ``<directory>/obj.pkl``.

        Reads both this framework's dict snapshot and a *reference-written*
        ``obj.pkl``: the reference pickles its entire handler instance
        (vault/logging_utils.py:481-483, ``pickle.dump(self, fp)`` with
        ``__getstate__ = self.__dict__``), whose class can't be imported
        here — a stub class absorbs the instance ``__dict__`` and the
        reference attribute names (_param_dict/_metric_dict/...,
        vault/logging_utils.py:53-62) are mapped onto ours."""
        with open(os.path.join(directory, "obj.pkl"), "rb") as f:
            state = _TolerantUnpickler(f).load()
        h = cls(os.path.dirname(os.path.dirname(directory)),
                os.path.basename(os.path.dirname(directory)))
        if isinstance(state, _ForeignHandlerState):  # reference format
            d = state.__dict__
            h._params = dict(d.get("_param_dict", {}))
            h._name_params = list(d.get("_name_params", []))
            h._disabled = set(d.get("_disabled_params", ()))
            h._parents = dict(d.get("_parent_param_dict", {}))
            h._series = {k: list(v) for k, v in
                         d.get("_metric_dict", {}).items()}
            finals: Dict[str, float] = {}
            finals.update(d.get("_best_metric_dict", {}))
            # reference stores test metrics unprefixed in their own dict and
            # writes them into the experiment block as-is (logging_utils.py
            # :465-470); our single finals dict uses the test_ prefix
            for k, v in d.get("_test_metric_dict", {}).items():
                finals[k if k.startswith("test_") else f"test_{k}"] = v
            h._finals = {k: _fmt(v) for k, v in finals.items()
                         if isinstance(v, (int, float, np.floating,
                                           np.integer))}
        else:
            h._params = state["params"]
            h._name_params = state["name_params"]
            h._disabled = set(state["disabled"])
            h._parents = dict(state.get("parents", {}))
            h._series = state["series"]
            h._finals = state["finals"]
        h._dir = directory
        return h

    # -- aggregation -------------------------------------------------------
    def _final_value(self, block: Dict[str, Any], key: str):
        v = block[key]
        if isinstance(v, list):
            if not v:
                return None
            step = block.get("best_step")
            if step is not None:
                # eval windows are 1-indexed by eval count
                i = min(len(v) - 1, max(0, int(step) - 1))
                return v[i]
            return v[-1]
        return v

    def aggregate_results(self):
        """mean+-std (plus median and outlier-trimmed mean) of each metric's
        final value across experiment_N runs -> aggregated_metrics.yml
        (vault/logging_utils.py:488-574; format per README.md:212-219)."""
        import yaml

        d = self.directory()
        mfile = os.path.join(d, "metrics.yml")
        if not os.path.exists(mfile):
            return
        with open(mfile) as f:
            runs = yaml.safe_load(f) or {}
        keys: List[str] = sorted({k for b in runs.values() for k in b
                                  if not isinstance(b[k], list) or k == "train_loss"})
        agg: Dict[str, str] = {}
        med: Dict[str, str] = {}
        trim: Dict[str, str] = {}
        for key in keys:
            vals = [self._final_value(b, key) for b in runs.values() if key in b]
            vals = np.asarray([v for v in vals if v is not None], np.float64)
            if vals.size == 0:
                continue
            agg[key] = f"{vals.mean():.4f}+-{vals.std():.4f}"
            med[key] = f"{np.median(vals):.4f}"
            if vals.size > 2:
                inner = np.sort(vals)[1:-1]
                trim[key] = f"{inner.mean():.4f}+-{inner.std():.4f}"
        out: Dict[str, Any] = {"": agg}
        if med:
            out["median"] = med
        if trim:
            out["outlier_trimmed"] = trim
        with open(os.path.join(d, "aggregated_metrics.yml"), "w") as f:
            yaml.safe_dump(out, f)

    def plot(self):
        """Per-metric PNG curves with std bands across runs
        (vault/logging_utils.py:576-733)."""
        try:
            import matplotlib
            matplotlib.use("Agg")
            import matplotlib.pyplot as plt
        except Exception:
            return
        import yaml

        d = self.directory()
        mfile = os.path.join(d, "metrics.yml")
        if not os.path.exists(mfile):
            return
        with open(mfile) as f:
            runs = yaml.safe_load(f) or {}
        series_keys = {k for b in runs.values() for k, v in b.items()
                       if isinstance(v, list)}
        os.makedirs(os.path.join(d, "plots"), exist_ok=True)
        for key in series_keys:
            seqs = [b[key] for b in runs.values() if isinstance(b.get(key), list)]
            if not seqs:
                continue
            n = min(len(s) for s in seqs)
            if n == 0:
                continue
            arr = np.asarray([s[:n] for s in seqs], np.float64)
            mean, std = arr.mean(0), arr.std(0)
            x = np.arange(1, n + 1)
            fig, ax = plt.subplots(figsize=(6, 4))
            ax.plot(x, mean, label=key)
            ax.fill_between(x, mean - std, mean + std, alpha=0.3)
            ax.set_xlabel("eval step")
            ax.set_ylabel(key)
            ax.legend()
            fig.tight_layout()
            fig.savefig(os.path.join(d, "plots", f"{key}.png"))
            plt.close(fig)


def _yamlable(v):
    if isinstance(v, (str, int, float, bool)) or v is None:
        return v
    return str(v)
