"""Training-step throughput of VAuLT-base (bert-base-uncased tower +
ViLT-B/32) on the card: forward, backward and an HF AdamW update, fp32
master weights and bf16 compute, timed as a chain of steps (port of the
JAX package's ``scripts/train_bench.py``).

    python -m vault_tpu_torch.cli.train_bench [--device cpu] [--debug_tiny]

The step is the trainer's own (``training/trainer.py`` ``Trainer.train_step``:
the masters' bf16 compute copy, dropout 0.1 in the head and the encoders,
``classifier_apply_fn``, ``HfAdamW`` from ``training/optimizer.py``
``make_optimizer``), so the bench times the code users train with.  A chain
of K steps carries its dependency through the parameters; the final loss
fetch is the barrier; the reading is the slope between K = 2 and 8
(``utils/benchloop.py`` ``slope_ms``).  Before timing, the guard
(``product_placement``) checks that every product of a direct step runs in
each step of the chain, and, on the card, every kernel launch.

Knobs, from the environment (the JAX script's names; an unknown
``TRAIN_BENCH_*`` name or a bad value raises):
  TRAIN_BENCH_BATCH (16), TRAIN_BENCH_NODROP (0 / 1), TRAIN_BENCH_REMAT
  (0 / 1 / dots), TRAIN_BENCH_OPT_DTYPE (float32, bfloat16, int8 moments),
  TRAIN_BENCH_GRAD_BF16 (0 / 1), TRAIN_BENCH_MERGE_TO (ToMe patch tokens),
  TRAIN_BENCH_MERGE_LAYER (0), TRAIN_BENCH_CANVAS (384,608).
The JAX script's TRAIN_BENCH_RBG (a JAX PRNG implementation) has no
counterpart.

Prints one JSON line: pairs/s, ms per step, busy ms (CUPTI) and idle share,
the step's MFU (``utils/flops.py``, 3× the forward's products, 4× under
remat), the guard's counts and the card's name and power limit.
"""

from __future__ import annotations

import argparse
from typing import Mapping, Optional

import numpy as np
import torch

from vault_tpu_torch.cli._bench import (
    CANVAS,
    N_CLASSES,
    SEQ,
    add_common_args,
    bench_batch,
    canvas,
    device_of,
    emit,
    environ_or,
    flag,
    flag_mfu,
    guard_fields,
    mfu_pct,
    model_config,
    nonnegative_int,
    peak_tflops,
    positive_int,
    read_knobs,
)

K_LO, K_HI = 2, 8
REPEATS = 2
GUARD_K = (1, 2)


def remat_knob(raw: str):
    table = {"0": False, "1": True, "dots": "dots"}
    if raw not in table:
        raise ValueError("use 0, 1 or dots")
    return table[raw]


def opt_dtype_knob(raw: str) -> str:
    if raw not in ("float32", "bfloat16", "int8"):
        raise ValueError("use float32, bfloat16 or int8")
    return raw


def knob_spec(remat_default=False):
    return {"BATCH": (positive_int, 16), "NODROP": (flag, False),
            "REMAT": (remat_knob, remat_default), "OPT_DTYPE": (opt_dtype_knob, "float32"),
            "GRAD_BF16": (flag, False), "MERGE_TO": (positive_int, None),
            "MERGE_LAYER": (nonnegative_int, 0), "CANVAS": (canvas, CANVAS)}


def read_train_knobs(environ: Mapping[str, str], remat_default=False):
    """The ``TRAIN_BENCH_*`` knobs (``cli/ablate_train.py`` reads them too,
    with remat on by default)."""
    return read_knobs(environ, "TRAIN_BENCH_", knob_spec(remat_default))


def default_knobs(**kw):
    """Every knob at its default (the environment not read), then ``kw``."""
    return dict(read_train_knobs({}), **kw)


class StepBench:
    """A ``Trainer`` of the VAuLT classifier at the bench geometry and one
    fixed batch: :meth:`step` is one ``train_step``, :meth:`chain` ``k`` of
    them."""

    def __init__(self, knobs, dev, debug_tiny=False, seq=SEQ):
        from vault_tpu_torch.models.vault import VaultForClassification
        from vault_tpu_torch.training.trainer import (
            TrainArgs,
            Trainer,
            classifier_apply_fn,
        )

        self.knobs, self.dev, self.seq = knobs, torch.device(dev), seq
        self.cfg = cfg = model_config(debug_tiny)
        b = knobs["BATCH"]
        self.args = TrainArgs(
            lr=2e-5, train_batch_size=b, num_train_epochs=10,
            compute_dtype="bfloat16", remat=knobs["REMAT"],
            opt_state_dtype=knobs["OPT_DTYPE"],
            grad_dtype="bfloat16" if knobs["GRAD_BF16"] else None,
            merge_to=knobs["MERGE_TO"], merge_at_layer=knobs["MERGE_LAYER"],
            disable_tqdm=True)
        apply_fn = classifier_apply_fn(cfg, self.args, head_dropout=0.1)
        if knobs["NODROP"]:
            inner = apply_fn

            def apply_fn(params, batch, deterministic, generator):
                return inner(params, batch, True, generator)

            apply_fn.unreached = inner.unreached
        model = VaultForClassification(cfg, n_classes=N_CLASSES, device=self.dev,
                                       dtype=torch.float32, seed=0)
        self.trainer = Trainer(apply_fn, model, self.args, None, device=self.dev)
        del model
        # 100 steps an epoch over 10 epochs: the JAX script's
        # make_optimizer(2e-5, 1000) schedule
        self.trainer._build_optimizer(100)
        self.batch = bench_batch(cfg, b, self.dev, torch.float32, seq, knobs["CANVAS"])
        rng = np.random.default_rng(1)
        self.labels = torch.as_tensor(rng.integers(0, N_CLASSES, b), device=self.dev)
        self.weight = torch.ones(b, dtype=torch.float32, device=self.dev)
        self.steps = 0

    def step(self) -> torch.Tensor:
        """One training step; its on-device [loss * mass, mass]."""
        out = self.trainer.train_step(self.batch, self.labels, self.weight, self.steps)
        self.steps += 1
        return out

    def chain(self, k: int) -> torch.Tensor:
        out = None
        for _ in range(k):
            out = self.step()
        return out

    def run(self, k: int) -> float:
        """``k`` steps, then the last loss read on the host (the barrier)."""
        return self.chain(k)[0].item()


def measure(knobs, dev, debug_tiny=False, k_lo=K_LO, k_hi=K_HI, repeats=REPEATS,
            peak=None, seq=SEQ) -> dict:
    """The train bench's record at ``knobs`` on ``dev``."""
    from vault_tpu_torch.utils.benchloop import product_placement, slope_ms
    from vault_tpu_torch.utils.flops import train_step_flops
    from vault_tpu_torch.utils.profiling import device_ms, device_record

    peak = peak_tflops({}) if peak is None else peak
    bench = StepBench(knobs, dev, debug_tiny, seq)
    dev = bench.dev
    b = knobs["BATCH"]
    guard = product_placement(lambda m, _b, k: m.chain(k), lambda m, _b: m.step(),
                              bench, bench.batch, *GUARD_K)
    slope = slope_ms(bench.run, k_lo, k_hi, repeats, dev)
    ms = slope["ms"]
    busy = device_ms(bench.step, iters=3, warmup=1)[0] if dev.type == "cuda" else None
    flops = train_step_flops(bench.cfg, b, seq, knobs["CANVAS"], knobs["REMAT"],
                             knobs["MERGE_TO"], knobs["MERGE_LAYER"])
    rec = {
        "metric": "vault_train_step_pairs_per_sec_per_card",
        "value": b / ms * 1e3, "unit": "pairs/sec/card",
        "batch": b, "remat": knobs["REMAT"], "nodrop": knobs["NODROP"],
        "opt_dtype": knobs["OPT_DTYPE"], "grad_bf16": knobs["GRAD_BF16"],
        "merge_to": knobs["MERGE_TO"], "merge_at_layer": knobs["MERGE_LAYER"],
        "canvas": list(knobs["CANVAS"]), "seq": seq,
        "config": "debug_tiny" if debug_tiny else "vault_base(bert-base-uncased)",
        "k_lo": k_lo, "k_hi": k_hi, "t_lo_ms": slope["t_lo_ms"], "t_hi_ms": slope["t_hi_ms"],
        "ms_per_train_step": ms, "busy_ms": busy,
        "idle_share": None if busy is None else 1.0 - busy / ms,
        "train_flops": flops, "peak_tflops": peak,
        "train_mfu_pct": mfu_pct(flops, ms, peak),
        "train_busy_mfu_pct": mfu_pct(flops, busy, peak),
        **guard_fields(guard, GUARD_K[1] - GUARD_K[0], "step"),
        "device": device_record(dev),
    }
    flag_mfu(rec, ("train_mfu_pct", "train_busy_mfu_pct"))
    del bench
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return rec


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(
        prog="python -m vault_tpu_torch.cli.train_bench",
        description="Training-step pairs/s of VAuLT-base, slope-timed over a chain "
                    "of steps (knobs: TRAIN_BENCH_* in the environment).")
    add_common_args(ap, K_LO, K_HI, REPEATS)
    return ap.parse_args(argv)


def main(argv=None, environ: Optional[Mapping[str, str]] = None) -> dict:
    import sys

    environ = environ_or(environ)
    args = parse_args(argv)
    knobs = read_train_knobs(environ)
    rec = measure(knobs, device_of(args), args.debug_tiny, args.k_lo, args.k_hi,
                  args.repeats, peak_tflops(environ))
    if "suspect" in rec:
        print(f"WARNING: {rec['suspect']}", file=sys.stderr)
    return emit(rec)


if __name__ == "__main__":
    main()
