"""Host-side evaluation metrics (numpy), a copy of the JAX package's
``vault_tpu/training/metrics.py`` (the port imports nothing of that
package), replacing the reference's sklearn calls
(vault/tmsc_utils/trainer.py:513-549, vault/models/vault/trainer.py:
139-203).  Parity with sklearn.precision_recall_fscore_support(zero_division=0)
is asserted in tests/test_metrics.py.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np


def accuracy(y_true, y_pred) -> float:
    y_true = np.asarray(y_true).ravel()
    y_pred = np.asarray(y_pred).ravel()
    return float(np.mean(y_true == y_pred)) if y_true.size else 0.0


def _counts(y_true, y_pred, labels):
    tp = np.zeros(len(labels)); fp = np.zeros(len(labels)); fn = np.zeros(len(labels))
    for i, lab in enumerate(labels):
        tp[i] = np.sum((y_pred == lab) & (y_true == lab))
        fp[i] = np.sum((y_pred == lab) & (y_true != lab))
        fn[i] = np.sum((y_pred != lab) & (y_true == lab))
    return tp, fp, fn


def precision_recall_fscore(y_true, y_pred, average: str = "macro",
                            labels: Optional[Sequence[int]] = None):
    """sklearn-compatible P/R/F1 with zero_division=0."""
    y_true = np.asarray(y_true).ravel()
    y_pred = np.asarray(y_pred).ravel()
    if labels is None:
        labels = np.unique(np.concatenate([y_true, y_pred]))
    tp, fp, fn = _counts(y_true, y_pred, labels)

    def safe_div(a, b):
        a = np.asarray(a, np.float64)
        b = np.asarray(b, np.float64)
        return np.divide(a, b, out=np.zeros_like(a), where=b > 0)

    prec = safe_div(tp, tp + fp)
    rec = safe_div(tp, tp + fn)
    f1 = safe_div(2 * prec * rec, prec + rec)
    support = tp + fn

    if average == "macro":
        return float(prec.mean()), float(rec.mean()), float(f1.mean())
    if average == "micro":
        p = safe_div(tp.sum(), (tp + fp).sum())
        r = safe_div(tp.sum(), (tp + fn).sum())
        f = safe_div(2 * p * r, p + r)
        return float(p), float(r), float(f)
    if average == "weighted":
        w = support / max(support.sum(), 1)
        return (float((prec * w).sum()), float((rec * w).sum()),
                float((f1 * w).sum()))
    if average is None:
        return prec, rec, f1
    raise ValueError(f"unknown average {average!r}")


def f1_score(y_true, y_pred, average: str = "macro") -> float:
    return precision_recall_fscore(y_true, y_pred, average)[2]


def classification_results(y_true, y_pred) -> Dict[str, float]:
    """The default trainer metric bundle: eval_accuracy + macro_f1_score
    (vault/tmsc_utils/trainer.py:513-549)."""
    return {
        "eval_accuracy": accuracy(y_true, y_pred),
        "macro_f1_score": f1_score(y_true, y_pred, "macro"),
    }
