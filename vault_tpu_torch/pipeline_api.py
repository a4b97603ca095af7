"""High-level inference pipeline: processor and model in one object (port of
``vault_tpu/pipeline_api.py``).

The serving-side counterpart of the reference's README quickstart
(README.md:34-58): processor(image, text) -> model forward -> embeddings or
a head's output, every call padded to ``max_batch`` rows (one shape for the
kernels) and cut back to the real rows.  Preprocessing and forward times are
kept (``stats``); the forward's timer ends after the outputs reach the host,
so it holds the card's time too.  While ``utils.profiling.enable_nan_checks``
is on, the forward runs under its NaN checks.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from vault_tpu_torch.config import VaultConfig
from vault_tpu_torch.data.processor import VaultProcessor
from vault_tpu_torch.models.vault import batch_to_device, vault_apply
from vault_tpu_torch.utils.profiling import StepTimer, nan_checks


def _device_of(params) -> torch.device:
    if isinstance(params, torch.nn.Module):
        return next(params.parameters()).device
    return next(t for t in params.values() if isinstance(t, torch.Tensor)).device


class VaultPipeline:
    def __init__(self, params, cfg: VaultConfig, processor: VaultProcessor,
                 max_batch: int = 16, head_fn=None, merge_patches_to=None,
                 merge_at_layer=0):
        """``params``: the model (a ``VaultForClassification`` or a parameter
        tree of the same keys); the pipeline runs where its parameters lie.
        ``head_fn(params, ViltOutput)`` -> task output; by default
        (last_hidden_state, pooler_output).  ``merge_patches_to`` /
        ``merge_at_layer``: ToMe patch-token merging (ops/token_merge.py)."""
        self.params = params
        self.cfg = cfg
        self.processor = processor
        self.max_batch = max_batch
        self.device = _device_of(params)
        self.preprocess_timer = StepTimer()
        self.forward_timer = StepTimer()

        def fwd(p, batch):
            out = vault_apply(p, cfg, merge_patches_to=merge_patches_to,
                              merge_at_layer=merge_at_layer, **batch)
            if head_fn is not None:
                return head_fn(p, out)
            return out.last_hidden_state, out.pooler_output

        self._fwd = fwd

    def _pad(self, enc: Dict[str, np.ndarray], n: int):
        pad_n = self.max_batch - n
        if pad_n == 0:
            return enc
        return {k: np.pad(np.asarray(v), [(0, pad_n)] + [(0, 0)] * (np.ndim(v) - 1))
                for k, v in enc.items()}

    def __call__(self, images, texts):
        if isinstance(texts, str):
            texts = [texts]
        if not isinstance(images, (list, tuple)):
            images = [images]
        n = len(texts)
        if len(images) != n:
            raise ValueError(f"got {len(images)} images for {n} texts: the pipeline "
                             "pairs them elementwise")
        if n > self.max_batch:
            raise ValueError(f"batch {n} > max_batch {self.max_batch}")
        with self.preprocess_timer:
            enc = self.processor(list(images), list(texts))
        enc = self._pad({k: v.cpu().numpy() if isinstance(v, torch.Tensor) else v
                         for k, v in enc.items()}, n)
        with self.forward_timer, torch.inference_mode(), nan_checks():
            out = self._fwd(self.params, batch_to_device(enc, self.device))
            out = tuple(o.float().cpu().numpy()[:n] for o in out) if isinstance(
                out, tuple) else out.float().cpu().numpy()[:n]
        return out

    def stats(self) -> Dict[str, Dict[str, float]]:
        return {"preprocess": self.preprocess_timer.summary(),
                "forward": self.forward_timer.summary()}
