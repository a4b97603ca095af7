"""Image-text retrieval dataset (port of ``vault_tpu/data/retrieval.py``).

The reference's retrieval trainer consumes a duck-typed
``dataset.all_image_text_pairs()`` that no concrete dataset in the repo
implements (vault/models/vault/trainer.py:309-415) — this module supplies the
concrete counterpart: matched pairs (label 1) plus sampled negatives for
training, and an exhaustive text x image product for evaluation, batched (the
reference evaluates pair-at-a-time)."""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np

from vault_tpu_torch.data.datasets import load_image_file


class RetrievalDataset:
    def __init__(self, ids: Sequence, texts: Sequence[str],
                 image_paths: Sequence[str], processor,
                 name: str = "retrieval", max_length: int = 40,
                 negatives_per_positive: int = 1, seed: int = 0):
        self.name = name
        self.processor = processor
        self.ids = list(ids)
        self.texts = list(texts)
        self.image_paths = list(image_paths)
        self.negatives = negatives_per_positive
        self.max_length = max_length
        self._rng = np.random.default_rng(seed)
        self._text_enc = processor.encode_text(self.texts, max_length=max_length)
        self._images = [load_image_file(p) for p in self.image_paths]
        self._pixel_cache: Dict[int, tuple] = {}

    @property
    def num_examples(self) -> int:
        # a single-example dataset has no other image to sample as a
        # negative (batches() skips negatives there)
        neg = self.negatives if len(self.ids) >= 2 else 0
        return len(self.ids) * (1 + neg)

    def num_batches(self, batch_size: int) -> int:
        return (self.num_examples + batch_size - 1) // batch_size

    def _pixels_for(self, img_idx: Sequence[int]):
        """Per-image resize/normalize cached by image index — the all-pairs
        eval visits every image n times (and training once per negative
        reference), so uncached encoding would be O(n^2) host work.  Same
        values as processor.encode_images (no augmentation on this path):
        cached tensors are pre-pad, the batch canvas is applied here."""
        from vault_tpu_torch.data.image import (
            bucket_canvas,
            pad_batch,
            preprocess_image,
        )

        proc = self.processor
        auto = proc.canvas == "auto"
        max_hw = None if auto else proc.canvas
        processed = []
        for i in img_idx:
            arr = self._pixel_cache.get(i)
            if arr is None:
                arr = preprocess_image(self._images[i], safe=proc.safe_images,
                                       shorter=proc.shorter,
                                       longer=proc.longer, max_hw=max_hw,
                                       device=proc.device)
                self._pixel_cache[i] = arr
                # the raw decode is never read again once its processed
                # tensor is cached — keeping both doubled peak memory
                self._images[i] = None
            processed.append(arr)
        canvas = bucket_canvas(processed) if auto else proc.canvas
        pixel_values, pixel_mask = pad_batch(processed, canvas=canvas)
        if proc.device.type == "cpu":  # the processor's host form: numpy
            return pixel_values.numpy(), pixel_mask.numpy()
        return pixel_values, pixel_mask

    def batches(self, batch_size: int, shuffle: bool = False,
                rng: Optional[np.random.Generator] = None):
        """Train batches: each text paired with its own image (label 1) and
        ``negatives`` random other images (label 0)."""
        rng = rng or self._rng
        n = len(self.ids)
        text_idx, img_idx, labels = [], [], []
        for i in range(n):
            text_idx.append(i); img_idx.append(i); labels.append(1.0)
            if n < 2:
                continue  # no other image to sample as a negative
            for _ in range(self.negatives):
                j = int(rng.integers(0, n - 1))
                j = j + 1 if j >= i else j
                text_idx.append(i); img_idx.append(j); labels.append(0.0)
        order = np.arange(len(labels))
        if shuffle:
            rng.shuffle(order)
        for start in range(0, len(order), batch_size):
            sel = order[start:start + batch_size]
            feats = {k: v[[text_idx[s] for s in sel]]
                     for k, v in self._text_enc.items()}
            pv, pm = self._pixels_for([img_idx[s] for s in sel])
            feats["pixel_values"] = pv
            feats["pixel_mask"] = pm
            yield feats, np.asarray([[labels[s]] for s in sel], np.float32)

    def all_pairs_batches(self, batch_size: int):
        """Eval: the full text x image product with identifiers — the
        batched analogue of the reference's all_image_text_pairs loop."""
        n = len(self.ids)
        pairs = [(t, v) for t in range(n) for v in range(n)]
        for start in range(0, len(pairs), batch_size):
            chunk = pairs[start:start + batch_size]
            feats = {k: v[[t for t, _ in chunk]]
                     for k, v in self._text_enc.items()}
            pv, pm = self._pixels_for([v for _, v in chunk])
            feats["pixel_values"] = pv
            feats["pixel_mask"] = pm
            labels = np.asarray([[1.0 if t == v else 0.0] for t, v in chunk],
                                np.float32)
            image_ids = [self.ids[v] for _, v in chunk]
            text_ids = [self.ids[t] for t, _ in chunk]
            yield feats, labels, image_ids, text_ids
