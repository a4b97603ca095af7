"""VaultProcessor: joint text+image preprocessing (port of the JAX package's
``vault_tpu/data/processor.py``).

Reference: ``VaultProcessor.from_pretrained`` builds a ViltProcessor whose
text tokenizer is swapped for the BERT tower's (vault/models/vault/
processor.py:6-18), producing ``input_ids / attention_mask / token_type_ids /
pixel_values / pixel_mask``.  Images are processed on the host (numpy out)
or on a named device (tensors on it out), their resizing spread over
``num_workers`` threads (``data/loader.py`` ``parallel_map``; the same
results for any count).  The tokenizer is the port's own (``batch_encode``)
or an HF tokenizer (called as one).  Training-time augmentation
(``augment_rng``) random-crops each image before its resize.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from vault_tpu_torch.data.image import (
    DEFAULT_CANVAS,
    bucket_canvas,
    crop_stage,
    pad_batch,
    resize_stage,
)


class VaultProcessor:
    def __init__(self, tokenizer, max_length: int = 40,
                 canvas: Union[None, str, Tuple[int, int]] = DEFAULT_CANVAS,
                 safe_images: bool = True, shorter: Optional[int] = None,
                 device="cpu", num_workers: int = 0):
        """``canvas``: a fixed (H, W) pins pixel_values to one shape;
        ``"auto"`` picks the smallest {384,608}-bucketed canvas per batch;
        ``None`` pads to the batch max (the reference's behaviour).
        ``device``: where images are resized and collated.  On the CPU,
        pixel_values and pixel_mask come back as numpy arrays, as from the
        JAX package's processor; on another device, as tensors there (a
        server passes its model's device).  ``num_workers``: threads the
        images' resizing runs on (0: the calling thread); at batch 64 the
        host's preprocessing is what a server waits on."""
        self.tokenizer = tokenizer
        self.num_workers = num_workers
        self.device = torch.device(device)
        self.max_length = max_length
        self.canvas = canvas
        self.safe_images = safe_images
        # the shortest-edge target is min(canvas, 384) unless given
        if shorter is None:
            shorter = (min(canvas) if isinstance(canvas, tuple) else 384)
            shorter = min(shorter, 384)
        self.shorter = shorter
        self.longer = int(1333 / 800 * shorter)

    def encode_text(self, texts: Sequence[str],
                    text_pairs: Optional[Sequence[Optional[str]]] = None,
                    max_length: Optional[int] = None) -> Dict[str, np.ndarray]:
        max_length = max_length or self.max_length
        if hasattr(self.tokenizer, "batch_encode"):
            return self.tokenizer.batch_encode(
                list(texts), text_pairs, max_length=max_length)
        # an HF tokenizer (AutoTokenizer of a checkpoint directory)
        kw = dict(padding="max_length", truncation=True, max_length=max_length,
                  return_tensors="np")
        if text_pairs is not None and any(p is not None for p in text_pairs):
            if any(p is None for p in text_pairs):
                # HF rejects None entries inside a pair list (the native
                # batch_encode handles per-element None); encode row-wise so
                # mixed lists behave identically across tokenizer types
                rows = [self.tokenizer(t, p, **kw) if p is not None
                        else self.tokenizer(t, **kw)
                        for t, p in zip(texts, text_pairs)]
                enc = {k: np.concatenate([np.asarray(r[k]) for r in rows])
                       for k in rows[0].keys()}
            else:
                enc = self.tokenizer(list(texts), list(text_pairs), **kw)
        else:
            enc = self.tokenizer(list(texts), **kw)
        out = {k: np.asarray(v, np.int32) for k, v in enc.items()
               if k in ("input_ids", "attention_mask", "token_type_ids")}
        if "token_type_ids" not in out:
            out["token_type_ids"] = np.zeros_like(out["input_ids"])
        return out

    def encode_images(self, images: Sequence[np.ndarray],
                      augment_rng: Optional[np.random.Generator] = None,
                      num_workers: Optional[int] = None):
        """Crop (serially: the crops consume ``augment_rng``), resize on
        ``num_workers`` threads (default: the processor's), collate."""
        from vault_tpu_torch.data.loader import parallel_map

        auto = self.canvas == "auto"
        max_hw = None if auto else self.canvas
        cropped = [crop_stage(im, safe=self.safe_images, augment_rng=augment_rng)
                   for im in images]
        processed = parallel_map(
            lambda im: resize_stage(im, shorter=self.shorter, longer=self.longer,
                                    max_hw=max_hw, device=self.device),
            cropped, self.num_workers if num_workers is None else num_workers)
        canvas = bucket_canvas(processed) if auto else self.canvas
        pixel_values, pixel_mask = pad_batch(processed, canvas=canvas)
        if self.device.type == "cpu":
            return pixel_values.numpy(), pixel_mask.numpy()
        return pixel_values, pixel_mask

    def __call__(self, images, texts, text_pairs=None,
                 augment_rng: Optional[np.random.Generator] = None,
                 max_length: Optional[int] = None) -> Dict[str, np.ndarray]:
        if isinstance(texts, str):
            texts = [texts]
        if not isinstance(images, (list, tuple)):
            images = [images]
        enc = self.encode_text(texts, text_pairs, max_length)
        pixel_values, pixel_mask = self.encode_images(images, augment_rng)
        enc["pixel_values"] = pixel_values
        enc["pixel_mask"] = pixel_mask
        return enc
