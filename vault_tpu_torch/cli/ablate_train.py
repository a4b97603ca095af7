"""Where a VAuLT-base training step's time goes, on the card (port of the
JAX package's ``scripts/ablate_train.py``).

    python -m vault_tpu_torch.cli.ablate_train [--device cpu] [--debug_tiny]

Times, at the train bench's geometry (``cli/train_bench.py``: batch 16,
bf16 compute, fp32 masters, the trainer's own step), each as the slope of
a chain of K = 2 and 8 iterations and as the busy time of one (CUPTI):

  fwd      the training forward and its loss, without gradients
  fwdbwd   the loss and its gradients (``Trainer.loss_and_grads``), remat
           as configured
  opt      the HF AdamW update alone (``HfAdamW.step_``) on fixed
           gradients: elementwise over every parameter
  full     the whole step (``Trainer.train_step``)

so fwdbwd - fwd is the backward (with remat's recompute) and full - fwdbwd
the optimizer, which ``opt`` measures directly: the record holds both.
The forward variants carry the chain through their inputs
(``utils/benchloop.py`` ``feedback_batch`` of the last loss); eager
PyTorch drops no gradient, so fwdbwd needs no reduction over the
gradients to keep them alive, as the JAX script's did.

Knobs: the train bench's ``TRAIN_BENCH_*`` (``TRAIN_BENCH_REMAT``
defaults to 1 here, as in the JAX script) and ``ABLATE_VARIANTS`` (a
comma list of the four).  Prints one JSON line.
"""

from __future__ import annotations

import argparse
from typing import Mapping, Optional

import torch

from vault_tpu_torch.cli._bench import (
    SEQ,
    add_common_args,
    device_of,
    emit,
    environ_or,
    read_knobs,
)

K_LO, K_HI = 2, 8
REPEATS = 2
VARIANTS = ("fwd", "fwdbwd", "opt", "full")


def variants_knob(raw: str):
    names = tuple(v for v in raw.split(",") if v)
    bad = [v for v in names if v not in VARIANTS]
    if bad or not names:
        raise ValueError(f"use a comma list of {VARIANTS}")
    return names


def iterations(bench):
    """One iteration of each variant, as a function of the last one's
    result (None first) returning its own."""
    from vault_tpu_torch.utils.benchloop import feedback_batch

    tr = bench.trainer

    def loss_of(prev):
        fb = torch.zeros((), device=bench.dev) if prev is None else prev * 1e-9
        return feedback_batch(bench.batch, fb)

    def fwd(prev):
        with torch.no_grad():
            logits = tr.apply_fn(tr.compute_params(tr.params), loss_of(prev), False,
                                 tr.step_generator(bench.steps))
            bench.steps += 1
            return tr.calculate_loss(logits, bench.labels, bench.weight, train=True)

    def fwdbwd(prev):
        loss, _ = tr.loss_and_grads(loss_of(prev), bench.labels, bench.weight,
                                    tr.step_generator(bench.steps))
        bench.steps += 1
        return loss

    grad_dtype = torch.bfloat16 if bench.knobs["GRAD_BF16"] else None
    grads = {k: (v.detach() * 1e-3).to(grad_dtype or v.dtype)
             for k, v in tr.trainable.items()}
    probe = next(iter(tr.trainable.values()))

    def opt(prev):
        tr.opt_state = tr.tx.step_(tr.trainable, grads, tr.opt_state)
        return probe.view(-1)[:1]

    def full(prev):
        return bench.step()[0]

    return {"fwd": fwd, "fwdbwd": fwdbwd, "opt": opt, "full": full}


def measure(knobs, variants, dev, debug_tiny=False, k_lo=K_LO, k_hi=K_HI,
            repeats=REPEATS, seq=SEQ) -> dict:
    from vault_tpu_torch.cli.train_bench import StepBench
    from vault_tpu_torch.utils.benchloop import slope_ms
    from vault_tpu_torch.utils.profiling import device_ms, device_record

    bench = StepBench(knobs, dev, debug_tiny, seq)
    dev = bench.dev
    step = iterations(bench)
    split = {}
    for name in variants:
        fn = step[name]

        def run(k, fn=fn):
            out = None
            for _ in range(k):
                out = fn(out)
            return out.float().sum().item()

        slope = slope_ms(run, k_lo, k_hi, repeats, dev)
        busy = device_ms(lambda fn=fn: fn(None), iters=3, warmup=1)[0] \
            if dev.type == "cuda" else None
        split[name] = {"ms": slope["ms"], "busy_ms": busy,
                       "idle_share": None if busy is None else 1.0 - busy / slope["ms"]}
    rec = {"metric": "vault_train_step_split_ms", "batch": knobs["BATCH"],
           "remat": knobs["REMAT"], "opt_dtype": knobs["OPT_DTYPE"],
           "nodrop": knobs["NODROP"], "grad_bf16": knobs["GRAD_BF16"],
           "merge_to": knobs["MERGE_TO"], "merge_at_layer": knobs["MERGE_LAYER"],
           "canvas": list(knobs["CANVAS"]), "seq": seq,
           "config": "debug_tiny" if debug_tiny else "vault_base(bert-base-uncased)",
           "k_lo": k_lo, "k_hi": k_hi, "variants": split}
    if {"fwdbwd", "full"} <= split.keys():
        for key in ("ms", "busy_ms"):
            full, fb = split["full"][key], split["fwdbwd"][key]
            rec[f"full_minus_fwdbwd_{key}"] = None if full is None else full - fb
        if "opt" in split:
            rec["opt_ms"], rec["opt_busy_ms"] = split["opt"]["ms"], split["opt"]["busy_ms"]
    if {"fwd", "fwdbwd"} <= split.keys():
        for key in ("ms", "busy_ms"):
            fb, fw = split["fwdbwd"][key], split["fwd"][key]
            rec[f"fwdbwd_minus_fwd_{key}"] = None if fb is None else fb - fw
    rec["device"] = device_record(dev)
    del bench, step
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return rec


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(
        prog="python -m vault_tpu_torch.cli.ablate_train",
        description="A VAuLT-base training step split into forward, backward and "
                    "optimizer, slope and busy ms each (knobs: TRAIN_BENCH_*, "
                    "ABLATE_VARIANTS).")
    add_common_args(ap, K_LO, K_HI, REPEATS)
    return ap.parse_args(argv)


def main(argv=None, environ: Optional[Mapping[str, str]] = None) -> dict:
    from vault_tpu_torch.cli.train_bench import read_train_knobs

    environ = environ_or(environ)
    args = parse_args(argv)
    knobs = read_train_knobs(environ, remat_default=True)
    variants = read_knobs(environ, "ABLATE_", {"VARIANTS": (variants_knob, VARIANTS)})
    return emit(measure(knobs, variants["VARIANTS"], device_of(args), args.debug_tiny,
                        args.k_lo, args.k_hi, args.repeats))


if __name__ == "__main__":
    main()
