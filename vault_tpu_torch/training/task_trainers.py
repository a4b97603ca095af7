"""Per-task trainer adapters over the generic Trainer (port of
``vault_tpu/training/task_trainers.py``).

Behavioral rebuilds of the reference's Vault trainers
(vault/models/vault/trainer.py) plus the TMSC default:
  * TMSC: CE, eval_accuracy + macro F1, early-stop on eval_accuracy
    (vault/models/vault/trainer.py:15-36, tmsc_utils/trainer.py:49-50);
  * Bloomberg: BCE-with-logits, sigmoid>=.5 preds, + weighted F1, early-stop
    on eval_loss lower-better (:39-90);
  * MVSA: CE (preprocessed) or dual 3-way CE with per-modality
    acc/macro/micro/weighted F1 (:93-203);
  * Images+Text (NLVR2-style): CE (:206-208);
  * VQA: BCE * n_labels, answer-score accuracy (:211-283);
  * Retrieval: scores over all image-text pairs -> image/text R@{1,5,10}
    (:286-415), evaluated in batches (the reference loops pair at a time;
    same math).

The TomBERT trainer waits for the baselines (``models/resnet.py``).
"""

from __future__ import annotations

import dataclasses
from collections import defaultdict
from typing import Dict

import numpy as np
import torch

from vault_tpu_torch.training import losses
from vault_tpu_torch.training.metrics import accuracy, f1_score
from vault_tpu_torch.training.trainer import Trainer, _progress


class TmscTrainer(Trainer):
    """The base Trainer already matches the reference's TMSC adapter; the
    class exists for symmetry and task-specific extension."""


def _stop_on_eval_loss(trainer: Trainer):
    """Reference VaultTrainerForBloombergTwitterCorpus (and MVSA, which
    inherits it) early-stops on eval_loss, lower-better
    (vault/models/vault/trainer.py:39-40).  The args are copied, not
    mutated: drivers reuse one TrainArgs across trainers and reps, and a
    task's override must not leak into the next trainer."""
    trainer.args = dataclasses.replace(
        trainer.args, early_stopping_metric="eval_loss", higher_better=False)
    trainer.early_stopping.higher_better = False


def _sigmoid_preds(logits) -> np.ndarray:
    return (1.0 / (1.0 + np.exp(-np.asarray(logits))) >= 0.5).astype(int)


class BloombergTrainer(Trainer):
    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        _stop_on_eval_loss(self)

    def calculate_loss(self, logits, labels, weight, train):
        return losses.bce_with_logits(logits, labels, weight)

    def get_eval_preds(self, logits):
        return _sigmoid_preds(logits).reshape(len(logits), -1).tolist()

    def get_eval_true(self, labels):
        return np.asarray(labels).astype(int).reshape(len(labels), -1).tolist()

    def evaluation_metrics(self, y_true, y_pred):
        # multilabel, as the reference computes them on the 2-D prediction
        # lists (vault/models/vault/trainer.py:84-91, vl_utils/trainer.py:
        # 46-50): eval_accuracy is exact match over the label vector, f1 is
        # per-column binary (positive-class) F1, weighted by each column's
        # positive support for "f1_score", unweighted for macro.  Raveling
        # to a flat class sequence gives other numbers.
        yt = np.asarray(y_true, dtype=int).reshape(len(y_true), -1)
        yp = np.asarray(y_pred, dtype=int).reshape(len(y_pred), -1)
        exact = float(np.mean(np.all(yt == yp, axis=1))) if len(yt) else 0.0
        tp = ((yp == 1) & (yt == 1)).sum(0).astype(np.float64)
        fp = ((yp == 1) & (yt == 0)).sum(0).astype(np.float64)
        fn = ((yp == 0) & (yt == 1)).sum(0).astype(np.float64)

        def safe_div(a, b):
            return np.divide(a, b, out=np.zeros_like(a), where=b > 0)

        prec = safe_div(tp, tp + fp)
        rec = safe_div(tp, tp + fn)
        f1 = safe_div(2 * prec * rec, prec + rec)
        support = tp + fn
        w = support / max(support.sum(), 1.0)
        return {
            "eval_accuracy": exact,
            "macro_f1_score": float(f1.mean()),
            "f1_score": float((f1 * w).sum()),
        }


def _acc_f1_bundle(true, preds, prefix=""):
    head = f"{prefix}_" if prefix else ""
    return {
        f"{head}eval_accuracy": accuracy(true, preds),
        f"{head}macro_f1_score": f1_score(true, preds, "macro"),
        f"{head}micro_f1_score": f1_score(true, preds, "micro"),
        f"{head}weighted_f1_score": f1_score(true, preds, "weighted"),
    }


class MvsaTrainer(Trainer):
    def __init__(self, *args, preprocessed: bool = True, **kwargs):
        super().__init__(*args, **kwargs)
        self.preprocessed = preprocessed
        # the reference's MVSA inherits Bloomberg's eval_loss/lower-better
        # early stopping, which the dual-head mode needs: its results carry
        # only text_/image_-prefixed accuracies, so an eval_accuracy metric
        # would never fire
        _stop_on_eval_loss(self)

    def calculate_loss(self, logits, labels, weight, train):
        if self.preprocessed:
            return losses.softmax_cross_entropy(logits, labels, weight)
        return losses.dual_softmax_cross_entropy(logits, labels, weight)

    def get_eval_preds(self, logits):
        logits = np.asarray(logits)
        if self.preprocessed:
            return logits.argmax(-1).tolist()
        n = logits.shape[-1] // 2
        return np.stack([logits[:, :n].argmax(-1),
                         logits[:, n:].argmax(-1)], axis=1).tolist()

    def evaluation_metrics(self, y_true, y_pred):
        if self.preprocessed:
            return _acc_f1_bundle(y_true, y_pred)
        yt, yp = np.asarray(y_true), np.asarray(y_pred)
        out = _acc_f1_bundle(yt[:, 0], yp[:, 0], "text")
        out.update(_acc_f1_bundle(yt[:, 1], yp[:, 1], "image"))
        return out


class ImagesAndTextTrainer(Trainer):
    """CE over the pair classifier (vault/models/vault/trainer.py:206-208)."""


class VqaTrainer(Trainer):
    """Soft answer-score targets.  Rows with no usable annotation (all
    answers outside the label vocab) carry an all-zero score vector; the
    dataset's ``label_weights`` feature zeroes them out of the loss
    (``Trainer._pad`` folds it into the loss weight) and eval skips them:
    the reference's None-label filtering (vault/models/vault/trainer.py:
    215-249)."""

    def calculate_loss(self, logits, labels, weight, train):
        return losses.vqa_bce(logits, labels, weight)

    def get_eval_preds(self, logits):
        return np.asarray(logits).argmax(-1).tolist()

    def evaluation_metrics(self, y_true, y_pred):
        # VQA accuracy = score of the chosen answer; unlabeled rows
        # (all-zero score vectors) are excluded, not counted as 0
        scores = [label[pred] for pred, label in zip(y_pred, y_true)
                  if np.asarray(label).sum() > 0]
        return {"eval_accuracy": float(np.mean(scores)) if scores else 0.0}


class RetrievalTrainer(Trainer):
    """BCE on match logits; eval iterates all image-text pairs and computes
    image/text R@{1,5,10} from per-identifier score pools."""

    def calculate_loss(self, logits, labels, weight, train):
        return losses.bce_with_logits(logits, labels, weight)

    def get_eval_preds(self, logits):
        return _sigmoid_preds(logits).reshape(-1).tolist()

    def get_eval_true(self, labels):
        return np.asarray(labels).astype(int).reshape(-1).tolist()

    @torch.no_grad()
    def evaluate(self, dataset) -> Dict[str, float]:
        """``dataset`` must expose ``all_pairs_batches(batch_size)`` yielding
        (batch, labels, image_ids, text_ids).  One host read per batch: the
        logits and the loss come back together."""
        a = self.args
        tree = self.compute_params({k: v.detach() for k, v in self.params.items()})
        image_scores: Dict = defaultdict(dict)
        text_scores: Dict = defaultdict(dict)
        preds, trues = [], []
        total_loss, n_pairs = 0.0, 0
        for batch, labels, image_ids, text_ids in _progress(
                dataset.all_pairs_batches(a.eval_batch_size), a.disable_tqdm,
                desc="eval", leave=False):
            n = labels.shape[0]
            batch_p, labels_p, weight = self._pad(batch, labels)
            bt, lt, wt = self._to_device(batch_p, labels_p, weight)
            logits = self.apply_fn(tree, bt, True, None)
            loss = self.calculate_loss(logits, lt, wt, train=False)
            out = torch.cat([logits.float().reshape(-1),
                             loss.float().reshape(1)]).cpu().numpy()
            total_loss += float(out[-1]) * n
            n_pairs += n
            logits = out[:-1][:n]
            preds.extend(self.get_eval_preds(logits))
            trues.extend(self.get_eval_true(labels))
            for s, lab, iid, tid in zip(logits.tolist(),
                                        np.asarray(labels).reshape(-1).tolist(),
                                        image_ids, text_ids):
                # max-merge on score ties, so an equal-scored positive is
                # never shadowed (the reference's dict keyed by score loses it)
                image_scores[iid][s] = max(int(lab), image_scores[iid].get(s, 0))
                text_scores[tid][s] = max(int(lab), text_scores[tid].get(s, 0))

        results = {"eval_loss": total_loss / max(n_pairs, 1)}
        results.update({"eval_accuracy": accuracy(trues, preds),
                        "macro_f1_score": f1_score(trues, preds, "macro")})
        for kind, pool in (("image", image_scores), ("text", text_scores)):
            hits = {1: [], 5: [], 10: []}
            for scores in pool.values():
                ranked = [scores[s] for s in sorted(scores, reverse=True)]
                for k in hits:
                    hits[k].append(any(lab == 1 for lab in ranked[:k]))
            results.update({f"{kind}-R@{k}": float(np.mean(v))
                            for k, v in hits.items()})
        return results
