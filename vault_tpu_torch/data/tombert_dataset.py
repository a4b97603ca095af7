"""Twitter-201X dataset for TomBERT and TomViLT (port of
``vault_tpu/data/tombert_dataset.py``).

Rebuild of vault/models/tombert/dataset.py: the target alone
(``max_target_length``, default 16) and the tweet+target pair
(``max_total_length``, longest-first truncation) encoded; images resized so
the short side is the crop size, center-cropped and ImageNet-normalized,
so the fixed ResNet grid gives every image the same region count
(:255-300); the frozen-ResNet cache through
``replace_images_with_embeddings`` (:226-238).

The resize is the JAX package's ``jax.image.resize(method="bilinear",
antialias=True)``, written out on the host in numpy: per axis a weight
matrix built as ``jax.image.scale_and_translate`` builds it (a triangle
kernel widened by the downscale factor, the weights normalised per output
pixel, in fp32), applied as two fp32 products.
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Sequence, Tuple, Union

import numpy as np

from vault_tpu_torch.data.datasets import load_image_with_fallback, read_twitter201x
from vault_tpu_torch.data.loader import parallel_map

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


def resize_weights(in_size: int, out_size: int) -> np.ndarray:
    """(in_size, out_size) fp32 weights of an antialiased bilinear resize
    along one axis, ``jax.image.scale_and_translate``'s
    ``compute_weight_mat`` at translation 0: output pixel j samples
    ``(j + 0.5) / scale - 0.5``; the triangle kernel is widened by
    1 / scale when downscaling; each column is normalised to sum 1 (zeroed
    when its sum is below 1000 fp32 eps, or when the sample lies outside
    the input)."""
    f32 = np.float32
    inv_scale = 1.0 / (out_size / in_size)
    kernel_scale = f32(max(inv_scale, 1.0))
    # one rounding: the JAX package's resize is jitted, and XLA's CPU
    # compile contracts this multiply and add into a fused multiply-add
    centers = (np.arange(out_size, dtype=f32) + f32(0.5)).astype(np.float64)
    sample = (centers * np.float64(f32(inv_scale)) - 0.5).astype(f32)
    x = np.abs(sample[None, :] - np.arange(in_size, dtype=f32)[:, None]) / kernel_scale
    w = np.maximum(f32(0.0), f32(1.0) - np.abs(x))
    total = w.sum(axis=0, keepdims=True, dtype=f32)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                 w / np.where(total != 0, total, f32(1.0)), f32(0.0))
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return np.where(inside[None, :], w, f32(0.0)).astype(f32)


def antialiased_resize(image: np.ndarray, out_hw: Tuple[int, int]) -> np.ndarray:
    """(H, W, C) -> (out_h, out_w, C) fp32, bilinear with antialiasing
    (``jax.image.resize(..., method="bilinear", antialias=True)``); an axis
    whose size does not change is left as it is, as there."""
    x = np.asarray(image, np.float32)
    h, w, c = x.shape
    nh, nw = out_hw
    if nh != h:
        x = (resize_weights(h, nh).T @ x.reshape(h, w * c)).reshape(nh, w, c)
    if nw != w:
        x = (x.transpose(0, 2, 1) @ resize_weights(w, nw)).transpose(0, 2, 1)
    return np.ascontiguousarray(x)


def imagenet_preprocess(image: np.ndarray, crop_size: int = 224) -> np.ndarray:
    """(H, W, 3) uint8 -> (3, crop, crop) float32: the short side resized to
    ``crop_size`` (torchvision ``Resize(int)`` geometry, the long side
    ``int(crop_size * long / short)``, a floor: a pixel more or less moves
    the center-crop window and every cached region embedding), the center
    crop (torchvision ``CenterCrop``: top/left ``int(round((full - crop) /
    2))``), ImageNet normalization."""
    h, w = image.shape[:2]
    if h <= w:
        nh, nw = crop_size, int(crop_size * w / h)
    else:
        nh, nw = int(crop_size * h / w), crop_size
    img = antialiased_resize(image, (nh, nw))
    top = int(round((nh - crop_size) / 2.0))
    left = int(round((nw - crop_size) / 2.0))
    img = img[top:top + crop_size, left:left + crop_size]
    img = (img / 255.0 - IMAGENET_MEAN) / IMAGENET_STD
    return img.transpose(2, 0, 1).astype(np.float32)


class TomBertTmscDataset:
    """The TMSC examples of ``kinds`` with both encodings and the images:
    decoded and transformed up front, or per fetch with
    ``preprocess_on_fetch`` (the reference's flag; its transform is
    deterministic, so this trades memory, not augmentation).  Images decode
    on ``num_workers`` threads (``data/loader.py`` ``parallel_map``).
    ``entity_map``: target -> "[entity]" token, appended to the target
    surface before encoding (vault/tmsc_utils/dataset.py:260-283)."""

    def __init__(self, dir: str, kinds: Union[str, Sequence[str]], processor,
                 image_dir: Optional[str] = None, max_total_length: int = 64,
                 max_target_length: int = 16, crop_size: int = 224,
                 label_mapping: Optional[Dict[str, int]] = None,
                 preprocess_on_fetch: bool = False, num_workers: int = 0,
                 entity_map: Optional[Dict[str, str]] = None):
        if isinstance(kinds, str):
            kinds = [kinds]
        self.name = (os.path.basename(os.path.normpath(dir))
                     + "(" + ",".join(kinds) + ")")
        self.image_dir = image_dir or (os.path.normpath(dir) + "_images")
        self.crop_size = crop_size
        self.examples = read_twitter201x(dir, kinds)
        labels = sorted({e.label for e in self.examples})
        self.label_mapping = label_mapping or {l: i for i, l in enumerate(labels)}
        self.labels = np.asarray(
            [self.label_mapping[e.label] for e in self.examples], np.int32)

        tweets = [e.targetless_tweet for e in self.examples]
        emap = entity_map or {}
        targets = [e.target + "/" + emap[e.target] if e.target in emap
                   else e.target for e in self.examples]
        pair_enc = processor.encode_text(tweets, targets,
                                         max_length=max_total_length)
        tgt_enc = processor.encode_text(targets, max_length=max_target_length)
        self.features = {
            "input_ids": pair_enc["input_ids"],
            "attention_mask": pair_enc["attention_mask"],
            "token_type_ids": pair_enc["token_type_ids"],
            "target_input_ids": tgt_enc["input_ids"],
            "target_attention_mask": tgt_enc["attention_mask"],
            "target_type_ids": tgt_enc["token_type_ids"],
        }
        self._err_count = 0
        self.num_workers = num_workers
        self.images: Optional[np.ndarray] = None
        if not preprocess_on_fetch:
            self.images = self._load(range(self.num_examples))
        self.embeddings: Optional[np.ndarray] = None

    def _load(self, indices) -> np.ndarray:
        def load(i):
            img, err = load_image_with_fallback(self.image_dir,
                                                self.examples[i].image_bn)
            return imagenet_preprocess(img, self.crop_size), err

        pairs = parallel_map(load, list(indices), self.num_workers)
        self._err_count += sum(int(e) for _, e in pairs)
        return np.stack([im for im, _ in pairs])

    @property
    def num_examples(self) -> int:
        return len(self.examples)

    def num_batches(self, batch_size: int) -> int:
        return (self.num_examples + batch_size - 1) // batch_size

    def replace_images_with_embeddings(self, embeddings: np.ndarray):
        """The frozen-ResNet cache: batches serve these region embeddings
        in place of the images."""
        self.embeddings = np.asarray(embeddings)

    def batches(self, batch_size: int, shuffle: bool = False,
                rng: Optional[np.random.Generator] = None):
        idx = np.arange(self.num_examples)
        if shuffle:
            (rng or np.random.default_rng()).shuffle(idx)
        for start in range(0, self.num_examples, batch_size):
            sel = idx[start:start + batch_size]
            feats = {k: v[sel] for k, v in self.features.items()}
            if self.embeddings is not None:
                feats["visual_embeddings"] = self.embeddings[sel]
            elif self.images is not None:
                feats["images"] = self.images[sel]
            else:  # preprocess_on_fetch: decode and transform now
                feats["images"] = self._load(sel)
            yield feats, self.labels[sel]
