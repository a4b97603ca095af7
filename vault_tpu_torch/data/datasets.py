"""Dataset readers: Twitter-201X TMSC, Bloomberg text-image, MVSA (port of
``vault_tpu/data/datasets.py``; numpy and PIL on the host, feeding this
package's processor).

Behavior-equivalent rebuilds of the reference's L2 dataset layer
(SURVEY.md §2.4):
  * Twitter-201X TSV reader with sorted-label mapping and image-load
    fallback (vault/tmsc_utils/dataset.py:21-350);
  * Bloomberg text-image-relationship CSV with the deterministic
    seed-42 dev=564/test=704 split (vault/vl_utils/dataset.py:310-431);
  * MVSA Single/Multiple with corrupt-id exclusion, 3-annotator majority
    vote, literature label preprocessing and seed-42 8:1:1 splits
    (vault/vl_utils/dataset.py:434-635).

The split RNG uses python's ``random.Random(42).sample`` — the exact
generator the reference uses — so split membership is bit-identical.
"""

from __future__ import annotations

import csv
import logging
import os
import random
from collections import Counter
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

logger = logging.getLogger(__name__)

FAIL_IMAGE_BN = "17_06_4705.jpg"  # designated fallback meme (reference
# vault/tmsc_utils/dataset.py:81)


def load_image_file(path: str) -> np.ndarray:
    """Robust image load -> (H, W, 3) uint8 (RGBA->RGB, gray->RGB; truncated
    files tolerated, reference vault/tmsc_utils/dataset.py:285-320).
    RGBA blends onto white like the reference's skimage rgba2rgb —
    PIL .convert('RGB') would drop alpha and expose the under-color of
    transparent pixels instead."""
    from PIL import Image, ImageFile

    from vault_tpu_torch.data.image import rgba_to_rgb

    ImageFile.LOAD_TRUNCATED_IMAGES = True
    with Image.open(path) as im:
        if im.mode in ("RGBA", "LA", "PA", "P"):
            # P(alette) images may carry transparency; go through RGBA
            return rgba_to_rgb(np.asarray(im.convert("RGBA"), np.uint8))
        im = im.convert("RGB")
        return np.asarray(im, np.uint8)


def load_image_with_fallback(image_dir: str, basename: str) -> Tuple[np.ndarray, bool]:
    try:
        return load_image_file(os.path.join(image_dir, basename)), False
    except Exception:
        return load_image_file(os.path.join(image_dir, FAIL_IMAGE_BN)), True


def _grouped_num_batches(keys, batch_size: int) -> int:
    from collections import Counter

    return sum((c + batch_size - 1) // batch_size
               for c in Counter(keys).values())


def _index_batches(n: int, batch_size: int, shuffle: bool,
                   rng: np.random.Generator, keys=None):
    """Batch index stream: uniform shuffle, or canvas-grouped when ``keys``
    is given (orientation-bucketed sampling, data/loader.py)."""
    if keys is not None:
        from vault_tpu_torch.data.loader import grouped_batch_indices

        yield from grouped_batch_indices(keys, batch_size, shuffle, rng)
        return
    idx = np.arange(n)
    if shuffle:
        rng.shuffle(idx)
    for start in range(0, n, batch_size):
        yield idx[start:start + batch_size]


# ---------------------------------------------------------------------------
# Twitter-201X TMSC
# ---------------------------------------------------------------------------

@dataclass
class TmscExample:
    id: str
    label: str
    image_bn: str
    targetless_tweet: str  # target replaced by "$T$"
    target: str


def read_twitter201x(dir: str, kinds: Union[str, Sequence[str]]) -> List[TmscExample]:
    """TSV rows: id, label, image, targetless_tweet, target; header skipped
    (vault/tmsc_utils/dataset.py:322-350)."""
    if isinstance(kinds, str):
        kinds = [kinds]
    examples: List[TmscExample] = []
    for kind in kinds:
        with open(os.path.join(dir, kind + ".tsv")) as fp:
            reader = csv.reader(fp, delimiter="\t")
            next(reader)  # header
            for line in reader:
                examples.append(TmscExample(*line[:5]))
    return examples


class Twitter201XDataset:
    """TMSC dataset for VAuLT: text = targetless_tweet [SEP] target, single
    sequence (vault/models/vault/dataset.py:256-311); images via the
    processor's safe pipeline with optional per-epoch augmentation.
    ``lazy_images``: each batch's images are decoded when it is fetched, on
    the ``num_workers`` pool, with the eager path's fallback image and
    error count."""

    def __init__(self, dir: str, kinds: Union[str, Sequence[str]], processor,
                 image_dir: Optional[str] = None, max_length: int = 40,
                 label_mapping: Optional[Dict[str, int]] = None,
                 augment: bool = False, lazy_images: bool = False,
                 text_preprocessor: Optional[Callable] = None,
                 orientation_buckets: bool = False, num_workers: int = 0,
                 entity_map: Optional[Dict[str, str]] = None):
        if isinstance(kinds, str):
            kinds = [kinds]
        self.kinds = list(kinds)
        self.dir = dir
        self.name = os.path.basename(os.path.normpath(dir)) + "(" + ",".join(kinds) + ")"
        self.image_dir = image_dir or (os.path.normpath(dir) + "_images")
        self.processor = processor
        self.max_length = max_length
        if max_length > 40:  # ViLT's text constraint (vault/models/vault/dataset.py:188)
            raise ValueError(f"max_length {max_length} > 40")
        self.augment = augment
        self.orientation_buckets = orientation_buckets
        self.num_workers = num_workers
        self.examples = read_twitter201x(dir, kinds)
        labels = sorted({e.label for e in self.examples})
        self.label_mapping = label_mapping or {l: i for i, l in enumerate(labels)}
        self.text_preprocessor = text_preprocessor or (lambda x: x)

        sep = getattr(processor.tokenizer, "sep_token", "[SEP]")
        # entity_map: target -> "[entity]" token; linked targets carry their
        # entity token in the encoded text, the reference's
        # ``example.target += "/" + token`` (vault/tmsc_utils/dataset.py:
        # 260-283)
        emap = entity_map or {}

        def _target_text(e):
            t = self.text_preprocessor(e.target)
            tok = emap.get(e.target)
            return t + "/" + tok if tok else t

        self.texts = [
            self.text_preprocessor(e.targetless_tweet) + sep + _target_text(e)
            for e in self.examples
        ]
        self.labels = np.asarray(
            [self.label_mapping[e.label] for e in self.examples], np.int32)
        self._text_enc = processor.encode_text(self.texts, max_length=max_length)
        self._err_count = 0
        self._images: Optional[List[np.ndarray]] = None
        self._canvas_keys_cache = None
        if not lazy_images:
            from vault_tpu_torch.data.loader import parallel_map

            pairs = parallel_map(
                lambda e: load_image_with_fallback(self.image_dir, e.image_bn),
                self.examples, num_workers)
            self._err_count = sum(int(err) for _, err in pairs)
            self._images = [img for img, _ in pairs]
            if self._err_count:
                logger.warning("%d errors occurred whilst loading images",
                               self._err_count)

    @property
    def num_examples(self) -> int:
        return len(self.examples)

    def num_batches(self, batch_size: int) -> int:
        # bucketed sampling yields up to one partial batch per canvas group,
        # so the count (which sizes the LR schedule horizon and eval windows)
        # must sum per group
        if self.orientation_buckets:
            return _grouped_num_batches(self._canvas_keys(), batch_size)
        return (self.num_examples + batch_size - 1) // batch_size

    def _fetch_images(self, sel):
        """The batch's images: held, or (lazy) decoded now on the decode
        pool, a failed decode counted and replaced by the fallback image."""
        if self._images is not None:
            return [self._images[i] for i in sel]
        from vault_tpu_torch.data.loader import parallel_map

        pairs = parallel_map(
            lambda i: load_image_with_fallback(self.image_dir,
                                               self.examples[i].image_bn),
            list(sel), self.num_workers)
        self._err_count += sum(int(err) for _, err in pairs)
        return [img for img, _ in pairs]

    def _canvas_keys(self):
        if self._canvas_keys_cache is None:
            from vault_tpu_torch.data.image import canvas_key

            if self._images is not None:
                sizes = [im.shape[:2] for im in self._images]
            else:
                from vault_tpu_torch.data.loader import peek_image_size

                sizes = []
                for e in self.examples:
                    try:
                        sizes.append(peek_image_size(
                            os.path.join(self.image_dir, e.image_bn)))
                    except Exception:
                        sizes.append(peek_image_size(
                            os.path.join(self.image_dir, FAIL_IMAGE_BN)))
            self._canvas_keys_cache = [canvas_key(h, w) for h, w in sizes]
        return self._canvas_keys_cache

    def batches(self, batch_size: int, shuffle: bool = False,
                rng: Optional[np.random.Generator] = None):
        rng = rng or np.random.default_rng()
        train = shuffle
        keys = self._canvas_keys() if self.orientation_buckets else None
        for sel in _index_batches(self.num_examples, batch_size, shuffle,
                                  rng, keys):
            feats = {k: v[sel] for k, v in self._text_enc.items()}
            images = self._fetch_images(sel)
            aug = rng if (train and self.augment) else None
            pv, pm = self.processor.encode_images(images, augment_rng=aug,
                                                  num_workers=self.num_workers)
            feats["pixel_values"] = pv
            feats["pixel_mask"] = pm
            yield feats, self.labels[sel]


# ---------------------------------------------------------------------------
# Bloomberg text-image relationship
# ---------------------------------------------------------------------------

BLOOMBERG_DEV_SIZE = 564
BLOOMBERG_TEST_SIZE = 704


def _seed42_split(n: int, dev: int, test: int):
    """The reference's split draw (vault/vl_utils/dataset.py:404-426,
    595-616): python-random seed 42 sample of dev+test indices."""
    eval_inds = random.Random(42).sample(range(n), dev + test)
    eval_set = set(eval_inds)
    train = [i for i in range(n) if i not in eval_set]
    return train, eval_inds[:dev], eval_inds[dev:]


def load_bloomberg(root_dir: str, splits: Union[str, Sequence[str]],
                   tasks: Union[str, Sequence[str]] = "text_is_represented",
                   dev_size: int = BLOOMBERG_DEV_SIZE,
                   test_size: int = BLOOMBERG_TEST_SIZE):
    """Returns (ids, texts, image_paths, labels (N, n_tasks) float, label_names)."""
    if isinstance(splits, str):
        splits = [splits]
    if isinstance(tasks, str):
        tasks = [tasks]
    rows = []
    with open(os.path.join(root_dir, "bloomberg-textimage.csv"), newline="") as fp:
        reader = csv.reader(fp, escapechar="\\")
        header = next(reader)
        for r in reader:
            rows.append(r)
    label_names = header[3:]
    task_inds = [label_names.index(t) for t in tasks]
    ids = [r[0] for r in rows]
    texts = [r[1] for r in rows]
    labels = np.asarray([[float(x) for x in r[3:]] for r in rows], np.float32)

    image_dir = os.path.join(root_dir, "Twitter_images")
    image_fns = [os.path.join(image_dir, f"T{_id}.jpg") for _id in ids]

    train, dev, test = _seed42_split(len(ids), dev_size, test_size)
    split_inds = ((train if "train" in splits else [])
                  + (dev if "dev" in splits else [])
                  + (test if "test" in splits else []))
    return ([ids[i] for i in split_inds],
            [texts[i] for i in split_inds],
            [image_fns[i] for i in split_inds],
            labels[split_inds][:, task_inds],
            label_names)


# ---------------------------------------------------------------------------
# MVSA
# ---------------------------------------------------------------------------

MVSA_STR2INT = dict(positive=0, neutral=1, negative=2)


def _majority(annotations: Sequence[int]) -> Optional[int]:
    c = Counter(annotations)
    top, cnt = c.most_common(1)[0]
    return top if cnt >= (len(annotations) + 1) // 2 else None


def _aggregate_modalities(pair: Sequence[int]) -> Optional[int]:
    pos, neu, neg = MVSA_STR2INT["positive"], MVSA_STR2INT["neutral"], MVSA_STR2INT["negative"]
    if pos in pair and neg in pair:
        return None
    if pos in pair:
        return pos
    if neg in pair:
        return neg
    return neu


def load_mvsa(root_dir: str, splits: Union[str, Sequence[str]],
              preprocessed: bool = True,
              dev_ratio: float = 0.1, test_ratio: float = 0.1):
    """Returns (ids, texts, image_paths, labels).  labels: (N,) int if
    preprocessed else (N, 2) int [text, image]."""
    if isinstance(splits, str):
        splits = [splits]
    with open(os.path.join(root_dir, "labelResultAll.txt")) as fp:
        reader = csv.reader(fp, delimiter="\t")
        header = next(reader)
        rows = list(reader)

    ids = [r[0] for r in rows]
    try:
        with open(os.path.join(root_dir, "corrupt_ids.txt")) as fp:
            corrupt = {x.strip() for x in fp if x.strip()}
        keep = [i for i, _id in enumerate(ids) if _id not in corrupt]
    except OSError:
        keep = list(range(len(ids)))
    rows = [rows[i] for i in keep]
    ids = [ids[i] for i in keep]

    multiple = len(header) > 2  # 3 annotator columns
    labels: List = []
    if multiple:
        for r in rows:
            pairs = [[MVSA_STR2INT[s] for s in col.split(",")] for col in r[1:4]]
            labels.append([_majority([p[m] for p in pairs]) for m in range(2)])
        keep2 = [i for i, l in enumerate(labels) if all(x is not None for x in l)]
        logger.info("Removing %d of %d (no annotator majority)",
                    len(labels) - len(keep2), len(labels))
        labels = [labels[i] for i in keep2]
        ids = [ids[i] for i in keep2]
    else:
        labels = [[MVSA_STR2INT[s] for s in r[1].split(",")] for r in rows]

    if preprocessed:
        agg = [_aggregate_modalities(l) for l in labels]
        keep3 = [i for i, a in enumerate(agg) if a is not None]
        logger.info("Removing %d of %d (inconsistent pairs)",
                    len(agg) - len(keep3), len(agg))
        labels_arr = np.asarray([agg[i] for i in keep3], np.int32)
        ids = [ids[i] for i in keep3]
    else:
        labels_arr = np.asarray(labels, np.int32)

    n = len(ids)
    dev_n = max(1, int(dev_ratio * n))
    test_n = max(1, int(test_ratio * n))
    train, dev, test = _seed42_split(n, dev_n, test_n)
    split_inds = ((train if "train" in splits else [])
                  + (dev if "dev" in splits else [])
                  + (test if "test" in splits else []))

    texts, image_fns = [], []
    sel_ids = [ids[i] for i in split_inds]
    for _id in sel_ids:
        with open(os.path.join(root_dir, "data", f"{_id}.txt"),
                  encoding="latin1") as fp:
            texts.append(" ".join(fp.readlines()))
        image_fns.append(os.path.join(root_dir, "data", f"{_id}.jpg"))
    return sel_ids, texts, image_fns, labels_arr[split_inds]


# ---------------------------------------------------------------------------
# Generic (image, text) dataset over file paths
# ---------------------------------------------------------------------------

class VisionLanguageDataset:
    """Eager or lazy (image, text) dataset driving the VaultProcessor — the
    rebuild of VisionAndLanguageDataset (vault/vl_utils/dataset.py:22-307).
    ``lazy``: images are decoded at batch time (on the ``num_workers``
    pool), not held."""

    def __init__(self, ids, texts, image_paths, labels, processor,
                 name: str = "vl", max_length: int = 40, lazy: bool = False,
                 augment: bool = False,
                 text_preprocessor: Optional[Callable] = None,
                 orientation_buckets: bool = False, num_workers: int = 0):
        pre = text_preprocessor or (lambda x: x)
        self.name = name
        self.processor = processor
        self.augment = augment
        self.orientation_buckets = orientation_buckets
        self.num_workers = num_workers
        # multi-text-per-image flattening (the reference's effective_inds,
        # vault/vl_utils/dataset.py:136-141): a list entry per image may be a
        # list of texts; each text becomes an example re-using its image.
        if texts and isinstance(texts[0], (list, tuple)):
            flat_texts, flat_paths, flat_ids, flat_labels = [], [], [], []
            labels_arr = np.asarray(labels)  # once, NOT per flattened row
            for i, group in enumerate(texts):
                for t in group:
                    flat_texts.append(t)
                    flat_paths.append(image_paths[i])
                    flat_ids.append(ids[i])
                    flat_labels.append(labels_arr[i])
            texts, image_paths, ids = flat_texts, flat_paths, flat_ids
            labels = np.asarray(flat_labels)
        self.ids = list(ids)
        self.texts = [pre(t) for t in texts]
        self.image_paths = list(image_paths)
        self.labels = np.asarray(labels)
        self._text_enc = processor.encode_text(self.texts, max_length=max_length)
        self._images: Optional[List[np.ndarray]] = None
        self._canvas_keys_cache = None
        if not lazy:
            from vault_tpu_torch.data.loader import parallel_map

            self._images = parallel_map(load_image_file, self.image_paths,
                                        num_workers)

    @property
    def num_examples(self) -> int:
        return len(self.image_paths)

    def num_batches(self, batch_size: int) -> int:
        if self.orientation_buckets:  # one partial batch per canvas group
            return _grouped_num_batches(self._canvas_keys(), batch_size)
        return (self.num_examples + batch_size - 1) // batch_size

    def _raw_image(self, i: int) -> np.ndarray:
        if self._images is not None:
            return self._images[i]
        return load_image_file(self.image_paths[i])

    def _canvas_keys(self):
        if self._canvas_keys_cache is None:
            from vault_tpu_torch.data.image import canvas_key

            if self._images is not None:
                sizes = [im.shape[:2] for im in self._images]
            else:
                from vault_tpu_torch.data.loader import peek_image_size

                sizes = [peek_image_size(p) for p in self.image_paths]
            self._canvas_keys_cache = [canvas_key(h, w) for h, w in sizes]
        return self._canvas_keys_cache

    def batches(self, batch_size: int, shuffle: bool = False,
                rng: Optional[np.random.Generator] = None):
        from vault_tpu_torch.data.loader import parallel_map

        rng = rng or np.random.default_rng()
        train = shuffle
        keys = self._canvas_keys() if self.orientation_buckets else None
        for sel in _index_batches(self.num_examples, batch_size, shuffle,
                                  rng, keys):
            feats = {k: v[sel] for k, v in self._text_enc.items()}
            images = parallel_map(self._raw_image, list(sel),
                                  0 if self._images is not None else self.num_workers)
            aug = rng if (train and self.augment) else None
            pv, pm = self.processor.encode_images(images, augment_rng=aug,
                                                  num_workers=self.num_workers)
            feats["pixel_values"] = pv
            feats["pixel_mask"] = pm
            yield feats, self.labels[sel]
