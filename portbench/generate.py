"""What a run makes from its seed: the model's weights (drawn by the
configuration's family) and the traffic's batches, on the device, the
same for the same seed.

Every stream is a generator on the device seeded from the run's seed and a
tag (:func:`derive`), so a batch can be made again from its index alone:
the check after the window remakes the batches it compares.  A traffic mix
is data (``portbench/traffic/<name>.json``); :func:`make_batch` reads it.
"""

from __future__ import annotations

import zlib
from typing import Dict

import numpy as np
import torch

from portbench import families


def derive(seed: int, tag: str, index: int = 0) -> int:
    """A 63-bit seed for the stream ``tag`` / ``index`` of a run."""
    seq = np.random.SeedSequence([int(seed), zlib.crc32(tag.encode()), int(index)])
    return int(seq.generate_state(1, np.uint64)[0] >> np.uint64(1))


def generator(device, seed: int, tag: str, index: int = 0) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(derive(seed, tag, index))


def make_weights(cfg: dict, seed: int, dtype, device) -> Dict[str, torch.Tensor]:
    """Every parameter of the configuration, made on ``device`` in ``dtype``
    by its family (``portbench/families/<family>/weights.py``)."""
    return families.load(cfg, "weights").make_weights(cfg, seed, dtype, device)


def make_batch(traffic: dict, cfg: dict, seed: int, index: int, device):
    """Batch ``index`` of a run: (inputs, labels).  Text: ids drawn from the
    tower's vocabulary without its pad id, each row's length drawn from
    ``text_len`` and padded to ``text_positions`` with the pad id and a
    zero mask, one segment; images: pixel values uniform in [-1, 1] on the
    ``canvas``, every pixel valid; labels drawn from the head's classes."""
    g = generator(device, seed, "batch", index)
    b, l = traffic["batch"], traffic["text_positions"]
    lo, hi = traffic["text_len"]
    tower = cfg["text_tower"]
    pad = tower["pad_token_id"]
    lengths = torch.randint(lo, hi + 1, (b,), generator=g, device=device)
    ids = torch.randint(0, tower["vocab_size"] - 1, (b, l), generator=g, device=device)
    ids = ids + (ids >= pad).long()
    mask = (torch.arange(l, device=device)[None] < lengths[:, None]).long()
    height, width = traffic["canvas"]
    pixels = torch.empty((b, cfg["vilt"]["num_channels"], height, width),
                         dtype=getattr(torch, traffic["pixel_dtype"]), device=device)
    pixels.uniform_(-1.0, 1.0, generator=g)
    labels = torch.randint(0, cfg["head"]["n_classes"], (b,), generator=g, device=device)
    inputs = {
        "input_ids": torch.where(mask.bool(), ids, torch.full_like(ids, pad)),
        "attention_mask": mask,
        "token_type_ids": torch.zeros_like(ids),
        "pixel_values": pixels,
        "pixel_mask": torch.ones((b, height, width), dtype=torch.long, device=device),
    }
    return inputs, labels
