"""The numbers that decide ``correct``, each a gap between what the timed
path produced and what the plain reference computes from the same inputs
and weights.  The limits are the configuration's (``checks`` in its file),
set between the sound runs' and the control's readings (``PERF.md``).

Scoring: ``logit_gap``, the largest |program − reference| over every
logit of the sampled batches.

Training, over the first steps: ``loss_gap``, the largest relative gap of
a step's loss; ``grad_gap``, over the leaves, the largest gap between the
program's and the reference's norm of the first step's gradient, over the
larger of that leaf's reference norm and the median leaf's; ``delta_gap``,
the same for each leaf's change over the steps, counting only leaves whose
first gradient in the reference is at least ``MOVED_SHARE`` of the median
leaf's (the others move by round-off alone under Adam); ``grad_diff``,
over the leaves, the norm of the difference of the first step's gradients
over the larger of that leaf's reference norm and the median leaf's.  The
norms' gaps catch a step that loses or repeats work; rounding errors
cancel in a norm, so ``grad_diff`` is the number that tells the
precision the configuration states from the one below it.
"""

from __future__ import annotations

import contextlib
import math
import statistics
from typing import Dict

import numpy as np
import torch

from portbench import families
from portbench.generate import make_weights

MOVED_SHARE = 1e-3


def logit_gap(program: np.ndarray, reference: np.ndarray) -> float:
    if not (np.isfinite(program).all() and np.isfinite(reference).all()):
        return math.inf
    return float(np.abs(program.astype(np.float64) - reference.astype(np.float64)).max())


def _leaf_gap(prog: Dict[str, float], ref: Dict[str, float], keys) -> float:
    keys = list(keys)
    if not keys:
        return math.inf
    floor = statistics.median(ref[k] for k in keys)
    worst = 0.0
    for k in keys:
        if not math.isfinite(prog[k]):
            return math.inf
        den = max(ref[k], floor)
        if den > 0.0:
            worst = max(worst, abs(prog[k] - ref[k]) / den)
    return worst


def _diff_gap(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor],
              ref_norms: Dict[str, float]) -> float:
    floor = statistics.median(ref_norms.values())
    worst = 0.0
    for k, r in ref.items():
        d = float(torch.linalg.vector_norm(prog[k].to(r.device, torch.float64) - r.double()))
        if not math.isfinite(d):
            return math.inf
        den = max(ref_norms[k], floor)
        if den > 0.0:
            worst = max(worst, d / den)
    return worst


def train_gaps(prog: dict, ref: dict) -> Dict[str, float]:
    """``prog`` and ``ref``: {"losses": [...], "grad_norms": {leaf: norm},
    "grads": {leaf: first gradient}, "delta_norms": {leaf: norm}} over the
    same leaves."""
    losses = [abs(p - r) / abs(r) if math.isfinite(p) else math.inf
              for p, r in zip(prog["losses"], ref["losses"])]
    g = ref["grad_norms"]
    floor = statistics.median(g.values())
    moved = [k for k in g if g[k] >= MOVED_SHARE * floor]
    return {"loss_gap": max(losses),
            "grad_gap": _leaf_gap(prog["grad_norms"], g, g),
            "delta_gap": _leaf_gap(prog["delta_norms"], ref["delta_norms"], moved),
            "grad_diff": _diff_gap(prog["grads"], ref["grads"], g)}


def judge(readings: Dict[str, float], limits: Dict[str, float]) -> Dict[str, dict]:
    """Each reading beside its limit; a reading passes at or under it (no
    limit set: it fails)."""
    return {k: {"value": readings[k], "limit": limits[k],
                "ok": limits[k] is not None and bool(readings[k] <= limits[k])}
            for k in limits}


@contextlib.contextmanager
def full_fp32():
    """fp32 products without TF32 (cuBLAS and cuDNN) for the reference."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def reference_weights(cfg: dict, seed: int, dtype, device) -> dict:
    """The run's weights made again from its seed in ``dtype``, as fp32."""
    made = make_weights(cfg, seed, dtype, device)
    return {k: v.to(torch.float32) for k, v in made.items()}


def reference_prec(cfg: dict):
    """The precision the configuration runs its encoder linears in (None: its dtype)."""
    return "int8" if cfg["quantize"] == "w8a8" else None


def score_reference(cfg: dict, traffic: dict, seed: int, indices, device,
                    prec=None) -> Dict[int, np.ndarray]:
    """The reference's logits of the run's batches ``indices``, by the
    configuration's family (``portbench/families/<family>/reference.py``)."""
    return families.load(cfg, "reference").score_reference(cfg, traffic, seed, indices,
                                                            device, prec)


def train_reference(cfg: dict, traffic: dict, seed: int, device, prec=None,
                    ste: bool = False, rows=None) -> dict:
    """The reference's first ``checked_steps`` training steps of the run,
    by the configuration's family."""
    return families.load(cfg, "reference").train_reference(cfg, traffic, seed, device, prec,
                                                            ste=ste, rows=rows)
