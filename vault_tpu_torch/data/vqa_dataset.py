"""VQAv2-format dataset for the VQA head/trainer (port of
``vault_tpu/data/vqa_dataset.py``).

The reference ships the VQA head, trainer, and answer-normalization tables
but no dataset loader (SURVEY.md §2.1/§2.4); this completes the path.  Reads
the standard VQAv2 annotation format:

  questions json:   {"questions": [{"question_id", "image_id", "question"}]}
  annotations json: {"annotations": [{"question_id", "image_id",
                                      "answers": [{"answer": ...} x10]}]}

Labels are the soft VQA scores min(1, count/3) over a fixed answer vocabulary
(built from the most frequent normalized answers, or supplied).  Rows whose
answers all fall outside the vocabulary keep an all-zero score vector and are
down-weighted by the ``label_weights`` flag the VqaTrainer consumes
(vault/models/vault/trainer.py:215-249 None-label filtering equivalent)."""

from __future__ import annotations

import json
import os
from collections import Counter
from typing import Callable, Dict, Optional, Sequence

import numpy as np

from vault_tpu_torch.data.datasets import load_image_file
from vault_tpu_torch.data.vqa import answer_scores, normalize_word


def build_answer_vocab(annotations: Sequence[dict], top_k: int = 3129
                       ) -> Dict[str, int]:
    """Most frequent normalized answers (ViLT uses 3129 for VQAv2)."""
    counts: Counter = Counter()
    for ann in annotations:
        for a in ann["answers"]:
            counts[normalize_word(a["answer"])] += 1
    return {ans: i for i, (ans, _) in enumerate(counts.most_common(top_k))}


def load_vqa_annotations(questions_file: str, annotations_file: Optional[str]):
    with open(questions_file) as f:
        questions = json.load(f)["questions"]
    annotations = None
    if annotations_file and os.path.exists(annotations_file):
        with open(annotations_file) as f:
            raw = json.load(f)["annotations"]
        annotations = {a["question_id"]: a for a in raw}
    return questions, annotations


class VqaDataset:
    def __init__(self, questions_file: str, annotations_file: Optional[str],
                 image_dir: str, processor,
                 image_name_fn: Optional[Callable[[int], str]] = None,
                 label2id: Optional[Dict[str, int]] = None,
                 max_length: int = 40, name: str = "vqa"):
        self.name = name
        self.processor = processor
        questions, annotations = load_vqa_annotations(questions_file,
                                                      annotations_file)
        if label2id is None:
            if annotations is None:
                raise ValueError("need annotations or label2id")
            self.label2id = build_answer_vocab(annotations.values())
        else:
            self.label2id = dict(label2id)
        self.num_labels = len(self.label2id)

        image_name_fn = image_name_fn or (lambda i: f"{i}.jpg")
        self.question_ids, texts, self.image_paths = [], [], []
        scores, has_label = [], []
        for q in questions:
            self.question_ids.append(q["question_id"])
            texts.append(q["question"])
            self.image_paths.append(os.path.join(image_dir,
                                                 image_name_fn(q["image_id"])))
            if annotations is not None and q["question_id"] in annotations:
                ans = [a["answer"] for a in annotations[q["question_id"]]["answers"]]
                vec = answer_scores(ans, self.label2id, self.num_labels)
                scores.append(vec)
                has_label.append(float(vec.sum() > 0))
            else:
                scores.append(np.zeros((self.num_labels,), np.float32))
                has_label.append(0.0)
        self.labels = np.stack(scores)
        self.label_weights = np.asarray(has_label, np.float32)
        self._text_enc = processor.encode_text(texts, max_length=max_length)

    @property
    def num_examples(self) -> int:
        return len(self.question_ids)

    def num_batches(self, batch_size: int) -> int:
        return (self.num_examples + batch_size - 1) // batch_size

    def batches(self, batch_size: int, shuffle: bool = False,
                rng: Optional[np.random.Generator] = None):
        idx = np.arange(self.num_examples)
        if shuffle:
            (rng or np.random.default_rng()).shuffle(idx)
        for start in range(0, self.num_examples, batch_size):
            sel = idx[start:start + batch_size]
            feats = {k: v[sel] for k, v in self._text_enc.items()}
            images = [load_image_file(self.image_paths[i]) for i in sel]
            pv, pm = self.processor.encode_images(images)
            feats["pixel_values"] = pv
            feats["pixel_mask"] = pm
            # rows without usable annotations get weight 0 (Trainer._pad
            # folds this into the loss weight)
            feats["label_weights"] = self.label_weights[sel]
            yield feats, self.labels[sel]
