"""What the bench CLIs share (``cli/bench.py``, ``cli/train_bench.py``,
``cli/perf_sweep.py``, ``cli/ablate_train.py``): their knobs read from the
environment (a misspelled name or a bad value raises), the model and the
input batch at the bench geometry, the card's peak rate, and the common
flags."""

from __future__ import annotations

import argparse
import json
import os
from typing import Callable, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

SEQ = 40
# what VaultProcessor(canvas="auto") emits for a landscape batch: the image
# fills the bucketed (384, 608) canvas, mask all valid
CANVAS = (384, 608)
# The H100 SXM's dense bf16 tensor-core rate, TFLOP/s (the JAX package's
# default, 197, is the TPU v5e's); VAULT_BF16_PEAK_TFLOPS overrides it
PEAK_TFLOPS = 989.4
# A reading above this share of the peak cannot be: part of the work was
# left out of what was timed
MFU_SUSPECT_PCT = 95.0
# the classifier's head: TMSC's three classes
N_CLASSES = 3

Knob = Tuple[Callable[[str], object], object]


def flag(raw: str) -> bool:
    if raw not in ("0", "1"):
        raise ValueError("use 0 or 1")
    return raw == "1"


def positive_int(raw: str) -> int:
    v = int(raw)
    if v <= 0:
        raise ValueError("must be positive")
    return v


def nonnegative_int(raw: str) -> int:
    v = int(raw)
    if v < 0:
        raise ValueError("must not be negative")
    return v


def canvas(raw: str) -> Tuple[int, int]:
    h, w = (positive_int(v) for v in raw.split(","))
    return h, w


def read_knobs(environ: Mapping[str, str], prefix: str, spec: Dict[str, Knob]) -> Dict[str, object]:
    """Each knob of ``spec`` (name -> (parse, default)) from ``environ``
    under ``prefix`` + name.  A variable under ``prefix`` that names no knob
    raises, as does a value ``parse`` refuses: a typo must not measure
    another configuration than the one asked for."""
    unknown = sorted(k for k in environ if k.startswith(prefix) and k[len(prefix):] not in spec)
    if unknown:
        raise ValueError(f"unknown knob(s) {unknown}; known: {[prefix + k for k in spec]}")
    out = {}
    for name, (parse, default) in spec.items():
        raw = environ.get(prefix + name)
        try:
            out[name] = default if raw is None or raw == "" else parse(raw)
        except ValueError as e:
            raise ValueError(f"{prefix}{name}={raw!r}: {e}") from None
    return out


def peak_tflops(environ: Mapping[str, str]) -> float:
    raw = environ.get("VAULT_BF16_PEAK_TFLOPS")
    if raw is None or raw == "":
        return PEAK_TFLOPS
    v = float(raw)
    if not v > 0:
        raise ValueError(f"VAULT_BF16_PEAK_TFLOPS={raw!r}: must be positive")
    return v


def mfu_pct(flops: float, ms: Optional[float], peak: float) -> Optional[float]:
    """Share of ``peak`` TFLOP/s that ``flops`` in ``ms`` sustain, %."""
    if ms is None or ms <= 0:
        return None
    return 100.0 * flops / (ms / 1e3) / (peak * 1e12)


def guard_fields(guard, span: int, what: str) -> dict:
    """The guard's part of a record (``utils/benchloop.py`` ``Placement``
    over ``span`` extra iterations, each a ``what``): the products and, on
    the card, the launches of one, and either the products found in the
    loop or a ``suspect`` naming what ran outside it."""
    out = {"guard_sound": guard.sound, f"products_per_{what}": guard.per_call,
           "launches_checked": guard.launches_outside is not None,
           f"launches_per_{what}": guard.launches_inside and {
               k: v // span for k, v in guard.launches_inside.items()}}
    if guard.sound:
        out["products_in_loop"] = guard.inside
    else:
        out["products_outside_loop"] = guard.outside
        out["suspect"] = (f"{guard.outside} products and launches {guard.launches_outside} "
                          f"of a direct {what} ran outside the timed iterations")
    return out


def flag_mfu(rec: dict, keys) -> list:
    """Each MFU of ``keys`` above ``MFU_SUSPECT_PCT`` joins ``rec["suspect"]``;
    returns them."""
    flags = [k for k in keys if rec[k] is not None and rec[k] > MFU_SUSPECT_PCT]
    if flags:
        rec["suspect"] = "; ".join(filter(None, [
            rec.get("suspect"), f"{', '.join(flags)} above {MFU_SUSPECT_PCT}% of the peak"]))
    return flags


def add_common_args(ap: argparse.ArgumentParser, k_lo: int, k_hi: int, repeats: int):
    ap.add_argument("--device", default=None,
                    help="cuda (default: the card; raises without one), cuda:<n>, or cpu")
    ap.add_argument("--debug_tiny", action="store_true",
                    help="the tiny debug geometry (2 + 2 layers, width 32) in place "
                         "of VAuLT-base")
    ap.add_argument("--k_lo", type=int, default=k_lo, help="the shorter chain's length")
    ap.add_argument("--k_hi", type=int, default=k_hi, help="the longer chain's length")
    ap.add_argument("--repeats", type=int, default=repeats,
                    help="timings of each chain; the best counts")


def model_config(debug_tiny: bool):
    from vault_tpu_torch.config import debug_tiny_vault_config
    from vault_tpu_torch.presets import vault_base

    return debug_tiny_vault_config() if debug_tiny else vault_base("bert-base-uncased")


def device_of(args) -> torch.device:
    """``--device``, or the card, as every CLI of the port takes it
    (``cli/args.py`` ``apply_device_arg``, ``models.vault.resolve_device``):
    with no card and no ``--device cpu`` it raises."""
    from vault_tpu_torch.cli.args import apply_device_arg
    from vault_tpu_torch.models.vault import resolve_device

    apply_device_arg(args)
    return resolve_device(args.device)


def bench_batch(cfg, batch: int, dev, pixel_dtype=torch.bfloat16, seq: int = SEQ,
                canvas_hw: Tuple[int, int] = CANVAS, seed: int = 0) -> Dict[str, torch.Tensor]:
    """The bench's inputs (the JAX package's ``entry()`` layout): seeded
    token ids, every text token and pixel valid, seeded normal pixels."""
    rng = np.random.default_rng(seed)
    return {
        "input_ids": torch.as_tensor(rng.integers(0, cfg.text_tower.vocab_size,
                                                  (batch, seq)), device=dev),
        "attention_mask": torch.ones((batch, seq), dtype=torch.int64, device=dev),
        "token_type_ids": torch.zeros((batch, seq), dtype=torch.int64, device=dev),
        "pixel_values": torch.as_tensor(rng.normal(size=(batch, 3, *canvas_hw)),
                                        dtype=torch.float32, device=dev).to(pixel_dtype),
        "pixel_mask": torch.ones((batch, *canvas_hw), dtype=torch.int64, device=dev),
    }


def emit(record: dict) -> dict:
    print(json.dumps(record), flush=True)
    return record


def environ_or(environ: Optional[Mapping[str, str]]) -> Mapping[str, str]:
    return os.environ if environ is None else environ
