"""Dataset protocol, in-memory dataset and background prefetch (a copy of
``InMemoryDataset`` and ``prefetch`` from ``vault_tpu/data/loader.py``; the
port imports nothing of that package).

Trainer contract (replacing torch DataLoader + collate_fn,
vault/tmsc_utils/trainer.py:290-310): a dataset exposes ``num_examples``,
``num_batches(bs)`` and ``batches(bs, shuffle, rng)`` yielding
``(features_dict, labels)`` numpy batches.  :func:`parallel_map` is the
decode pool the processor's ``num_workers`` runs on.  The grouped sampler
and the lazy dataset are not ported yet.
"""

from __future__ import annotations

import threading
from typing import Callable, Dict, Iterator, Optional, Tuple

import numpy as np


class InMemoryDataset:
    """Features pre-encoded as arrays; optional per-batch transform for
    train-time augmentation."""

    def __init__(self, features: Dict[str, np.ndarray], labels: np.ndarray,
                 name: str = "dataset",
                 batch_transform: Optional[Callable] = None):
        self.features = {k: np.asarray(v) for k, v in features.items()}
        self.labels = np.asarray(labels)
        self.name = name
        self.batch_transform = batch_transform
        n = {v.shape[0] for v in self.features.values()} | {self.labels.shape[0]}
        if len(n) != 1:
            raise ValueError(f"inconsistent example counts {n}")

    @property
    def num_examples(self) -> int:
        return self.labels.shape[0]

    def num_batches(self, batch_size: int) -> int:
        return (self.num_examples + batch_size - 1) // batch_size

    def batches(self, batch_size: int, shuffle: bool = False,
                rng: Optional[np.random.Generator] = None
                ) -> Iterator[Tuple[Dict[str, np.ndarray], np.ndarray]]:
        idx = np.arange(self.num_examples)
        if shuffle:
            (rng or np.random.default_rng()).shuffle(idx)
        for start in range(0, self.num_examples, batch_size):
            sel = idx[start:start + batch_size]
            feats = {k: v[sel] for k, v in self.features.items()}
            labels = self.labels[sel]
            if self.batch_transform is not None:
                feats, labels = self.batch_transform(feats, labels)
            yield feats, labels


_decode_pools: dict = {}
_decode_pools_lock = threading.Lock()


def parallel_map(fn, items, num_workers: int = 0):
    """Map ``fn`` over ``items`` in order, on a shared pool of
    ``num_workers`` threads when that is more than 0: the parallel-decode
    role of the reference's ``DataLoader(num_workers=...)``
    (vault/tmsc_utils/trainer.py:290-310).  Image resizing in numpy, PIL and
    PyTorch releases the GIL, so threads suit it.  The results are those of
    the serial map, in the same order, for any worker count."""
    if not num_workers or len(items) <= 1:
        return [fn(x) for x in items]
    with _decode_pools_lock:  # the main and prefetch threads may race here
        pool = _decode_pools.get(num_workers)
        if pool is None:
            from concurrent.futures import ThreadPoolExecutor

            pool = _decode_pools[num_workers] = ThreadPoolExecutor(
                num_workers, thread_name_prefix="vault-decode")
    return list(pool.map(fn, items))


def prefetch(iterator, size: int = 2):
    """Background-thread prefetch: overlaps host-side batch assembly with
    device compute (the role of the reference's
    DataLoader(num_workers=...)).  Errors in the worker surface in the
    consumer; abandoning the generator retires the worker."""
    import queue

    q: "queue.Queue" = queue.Queue(maxsize=size)
    sentinel = object()
    err: list = []
    stop = threading.Event()  # set when the consumer abandons the generator

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.2)
                return True
            except queue.Full:
                continue
        return False

    def worker():
        try:
            for item in iterator:
                if not put(item):
                    return  # consumer gone: drop queued batches, exit thread
        except BaseException as e:  # surface worker errors in the consumer
            err.append(e)
        finally:
            put(sentinel)

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is sentinel:
                if err:
                    raise err[0]
                return
            yield item
    finally:
        stop.set()
