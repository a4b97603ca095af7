"""NLVR2-format dataset for the images+text (pair) classifier (port of
``vault_tpu/data/nlvr2.py``).

Completes the data plumbing for ``VaultForImagesAndTextClassification``
(vault/models/vault/model.py:408-464; the reference ships the model + trainer
but no dataset).  Reads the public NLVR2 jsonl format: one record per line
with ``sentence``, ``label`` ("True"/"False"), and an ``identifier``
``<split>-<set_id>-<pair_id>-<sentence_id>`` that maps to two images
``<prefix><set_id>-<pair_id>-img{0,1}.png``."""

from __future__ import annotations

import json
import os
from typing import Callable, Optional

import numpy as np

from vault_tpu_torch.data.datasets import load_image_file


def _default_image_paths(image_dir: str, identifier: str):
    base = "-".join(identifier.split("-")[:-1])
    return [os.path.join(image_dir, f"{base}-img{i}.png") for i in (0, 1)]


class Nlvr2Dataset:
    def __init__(self, jsonl_file: str, image_dir: str, processor,
                 max_length: int = 40, name: str = "nlvr2",
                 image_paths_fn: Optional[Callable] = None):
        self.name = name
        self.processor = processor
        paths_fn = image_paths_fn or _default_image_paths
        texts, self.image_pairs, labels, self.identifiers = [], [], [], []
        with open(jsonl_file) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                rec = json.loads(line)
                texts.append(rec["sentence"])
                self.identifiers.append(rec["identifier"])
                self.image_pairs.append(paths_fn(image_dir, rec["identifier"]))
                labels.append(1 if str(rec["label"]).lower() == "true" else 0)
        self.labels = np.asarray(labels, np.int32)
        self._text_enc = processor.encode_text(texts, max_length=max_length)

    @property
    def num_examples(self) -> int:
        return len(self.identifiers)

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
            # ONE encode over both slots so they share a canvas — with the
            # auto-bucketed default, per-slot encodes could bucket to
            # different shapes and the (B, 2, ...) stack would crash
            images = [load_image_file(self.image_pairs[i][s])
                      for s in (0, 1) for i in sel]
            pv, pm = self.processor.encode_images(images)
            b = len(sel)
            # (B, num_images=2, C, H, W) / (B, 2, H, W)
            feats["pixel_values"] = np.stack([pv[:b], pv[b:]], axis=1)
            feats["pixel_mask"] = np.stack([pm[:b], pm[b:]], axis=1)
            yield feats, self.labels[sel]
