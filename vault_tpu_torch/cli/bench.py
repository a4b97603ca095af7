"""Benchmark: VAuLT forward image-text pairs/s per card on the H100 (port of
the JAX package's ``bench.py``).

    python -m vault_tpu_torch.cli.bench [--device cpu] [--debug_tiny]

VAuLT-base (``vault_base("bert-base-uncased")``: a bert-base-uncased tower
and the ViLT-B/32 co-encoder), seeded bf16 weights, on the default
``use_pallas="auto"`` route (the fused QKV product and the MLP and
attention kernels on the card), batch 16, 40 tokens, a (384, 608) canvas
with every pixel valid: what ``VaultProcessor(canvas="auto")`` makes of a
landscape batch.  In order:
  1. the guard (``utils/benchloop.py`` ``product_placement``): every
     product and, on the card, every kernel launch of a direct forward
     runs in each iteration of the chain; a failure is written in the
     record (``suspect``) and to stderr;
  2. the slope of a chain of K = 2 and 22 forwards, each reading the last
     one's output (``make_chained_forward``, ``slope_ms``): ``value``
     (pairs/s) and ``device_ms_per_step_batch16``;
  3. the busy time of one chained forward (CUPTI, ``utils/profiling.py``
     ``device_ms``), the chain's own adds (``feedback_ms``) apart:
     ``busy_ms``, ``idle_share = 1 - busy / slope``;
  4. the forward's MFU from the slope and from the busy time
     (``utils/flops.py``: 861 GF at this geometry) against the card's dense
     bf16 peak, 989.4 TFLOP/s for the H100 SXM (``VAULT_BF16_PEAK_TFLOPS``
     overrides it); above 95% the reading is flagged ``suspect``;
  5. the baseline: the port's own plain path, fp32, on the host CPU, batch
     4, 3 forwards (``vs_baseline`` divides by it);
  6. ``p50_host_process_encode_ms``: the port's ``VaultProcessor`` on its
     default device (the host) for one 480 × 640 image and a sentence;
  7. with ``VAULT_BENCH_TRAIN=1``, the training leg: ``cli/train_bench.py``
     at the shipped ``TrainArgs`` defaults (batch ``VAULT_BENCH_TRAIN_BATCH``,
     32; remat; bf16 moments), every other knob pinned.
On the card it also counts the host synchronizations of a chained forward
(``torch.cuda.set_sync_debug_mode("warn")``), by the line that made them.

Prints one JSON line.  The JAX bench's outage probe, its flake retry and
the fields it reads from recorded TPU runs have no counterpart here.
"""

from __future__ import annotations

import argparse
import os
import sys
import time
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
    peak_tflops,
    positive_int,
    read_knobs,
)

BATCH = 16
K_LO, K_HI = 2, 22
REPEATS = 3
GUARD_K = (1, 3)
BASELINE_BATCH = 4
BASELINE_ITERS = 3
BASELINE = f"port plain path, fp32, host CPU, batch {BASELINE_BATCH}"
KNOBS = {"TRAIN": (flag, False), "TRAIN_BATCH": (positive_int, 32)}


def forward_leg(model, cfg, batch, dev, k_lo, k_hi, repeats, peak, seq, canvas_hw):
    """The guard, the slope, the busy time and the MFUs of the chained
    forward ``model(batch)``."""
    from vault_tpu_torch.utils.benchloop import (
        host_syncs,
        make_chained_forward,
        product_placement,
        slope_ms,
    )
    from vault_tpu_torch.utils.flops import vault_forward_flops
    from vault_tpu_torch.utils.profiling import device_ms

    b = batch["input_ids"].shape[0]
    shape = (b, N_CLASSES)
    chained = make_chained_forward(lambda m, x: m(x), shape)
    rec = {}
    with torch.inference_mode():
        guard = product_placement(chained, lambda m, x: m(x), model, batch, *GUARD_K)
        slope = slope_ms(lambda k: chained(model, batch, k)[0, 0].item(), k_lo, k_hi,
                         repeats, dev)
        ms = slope["ms"]
        busy = feedback = None
        if dev.type == "cuda":
            busy = device_ms(lambda: chained(model, batch, 1), iters=5, warmup=2)[0]
            # the chain's own kernels: its zeros, the feedback adds and the
            # next feedback, without the forward; 17 small kernels a call,
            # so many calls, or the trace's first kernels (which CUPTI
            # missed in some traces) weigh on its check against event time
            out = torch.zeros(shape, dtype=torch.bfloat16, device=dev)
            bare = make_chained_forward(lambda o, x: o, shape)
            feedback = device_ms(lambda: bare(out, batch, 1), iters=50, warmup=5)[0]
            syncs = host_syncs(lambda: chained(model, batch, 1))
            rec.update(host_syncs_per_forward=sum(syncs.values()),
                       host_sync_sites=dict(syncs))
    flops = vault_forward_flops(cfg, b, seq, canvas_hw)
    rec.update(
        ms_per_step=ms, device_ms_per_step_batch16=ms * BATCH / b,
        t_lo_ms=slope["t_lo_ms"], t_hi_ms=slope["t_hi_ms"],
        busy_ms=busy, feedback_ms=feedback,
        busy_ms_net=None if busy is None else busy - feedback,
        idle_share=None if busy is None else 1.0 - busy / ms,
        fwd_flops=flops, peak_tflops=peak,
        fwd_mfu_pct=mfu_pct(flops, ms, peak),
        fwd_busy_mfu_pct=mfu_pct(flops, busy, peak),
        **guard_fields(guard, GUARD_K[1] - GUARD_K[0], "forward"))
    if not guard.sound:
        print(f"WARNING: {rec['suspect']}: the reading excludes part of the model",
              file=sys.stderr)
    return b / ms * 1e3, rec


def baseline_pairs_per_sec(cfg, seq, canvas_hw) -> float:
    """Pairs/s of the port's plain path in fp32 on the host CPU, batch 4."""
    from vault_tpu_torch.models.vault import VaultForClassification

    threads = torch.get_num_threads()
    torch.set_num_threads(max(threads, os.cpu_count() or 1))
    try:
        model = VaultForClassification(cfg, n_classes=N_CLASSES, device="cpu",
                                       dtype=torch.float32, seed=0, use_pallas=False)
        batch = bench_batch(cfg, BASELINE_BATCH, "cpu", torch.float32, seq, canvas_hw)
        with torch.inference_mode():
            model(batch)  # warm-up
            t0 = time.perf_counter()
            for _ in range(BASELINE_ITERS):
                model(batch)
            dt = time.perf_counter() - t0
    finally:
        torch.set_num_threads(threads)
    return BASELINE_BATCH * BASELINE_ITERS / dt


def host_process_encode_ms():
    """p50 host ms of the processor for one pair (tokenize, resize,
    normalize, pad), the preprocessing half of a served request; and the
    device it ran on."""
    from vault_tpu_torch.data.processor import VaultProcessor
    from vault_tpu_torch.models.pretrained import build_tokenizer

    proc = VaultProcessor(build_tokenizer("bert-base-uncased"))
    rng = np.random.default_rng(0)
    img = rng.integers(0, 255, (480, 640, 3)).astype(np.uint8)
    text = "a bunch of cats laying on a couch"
    proc([img], [text])  # warm-up (the host cores build at first use)
    times = []
    for _ in range(20):
        t0 = time.perf_counter()
        proc([img], [text])
        times.append(time.perf_counter() - t0)
    return sorted(times)[len(times) // 2] * 1e3, str(proc.device)


def train_fields(knobs, dev, debug_tiny, peak, seq, canvas_hw):
    """The live training leg at the shipped ``TrainArgs`` defaults (remat,
    bf16 moments), every other recipe knob at its default."""
    from vault_tpu_torch.cli import train_bench

    rec = train_bench.measure(
        train_bench.default_knobs(BATCH=knobs["TRAIN_BATCH"], REMAT=True,
                                  OPT_DTYPE="bfloat16", CANVAS=canvas_hw),
        dev, debug_tiny, peak=peak, seq=seq)
    return {"train_pairs_per_sec": rec["value"], "train_batch": rec["batch"],
            "train_source": "live", "train": rec}


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(
        prog="python -m vault_tpu_torch.cli.bench",
        description="VAuLT forward pairs/s per card, slope-timed over a chain of "
                    "forwards, with its guard, busy time, MFU and baseline.")
    add_common_args(ap, K_LO, K_HI, REPEATS)
    ap.add_argument("--batch", type=int, default=BATCH)
    ap.add_argument("--seq", type=int, default=SEQ, help="text tokens")
    ap.add_argument("--canvas", type=canvas, default=CANVAS, help="H,W of the image")
    return ap.parse_args(argv)


def main(argv=None, environ: Optional[Mapping[str, str]] = None) -> dict:
    from vault_tpu_torch.models.vault import VaultForClassification
    from vault_tpu_torch.utils.profiling import device_record

    environ = environ_or(environ)
    args = parse_args(argv)
    knobs = read_knobs(environ, "VAULT_BENCH_", KNOBS)
    peak = peak_tflops(environ)
    dev = device_of(args)
    cfg = model_config(args.debug_tiny)
    model = VaultForClassification(cfg, n_classes=N_CLASSES, device=dev,
                                   dtype=torch.bfloat16, seed=0)
    batch = bench_batch(cfg, args.batch, dev, torch.bfloat16, args.seq, args.canvas)
    pps, fwd = forward_leg(model, cfg, batch, dev, args.k_lo, args.k_hi, args.repeats,
                           peak, args.seq, args.canvas)
    del model, batch
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    base_pps = baseline_pairs_per_sec(cfg, args.seq, args.canvas)
    p50_ms, p50_dev = host_process_encode_ms()
    out = {
        "metric": "vault_forward_pairs_per_sec_per_card",
        "value": pps, "unit": "pairs/sec/card",
        "vs_baseline": pps / base_pps, "baseline": BASELINE,
        "baseline_pairs_per_sec": base_pps,
        "p50_host_process_encode_ms": p50_ms, "host_process_encode_device": p50_dev,
        "batch": args.batch, "seq": args.seq, "canvas": list(args.canvas),
        "config": "debug_tiny" if args.debug_tiny else "vault_base(bert-base-uncased)",
        "k_lo": args.k_lo, "k_hi": args.k_hi,
        **fwd,
    }
    if knobs["TRAIN"]:
        out.update(train_fields(knobs, dev, args.debug_tiny, peak, args.seq, args.canvas))
    flags = flag_mfu(out, ("fwd_mfu_pct", "fwd_busy_mfu_pct"))
    if flags:
        print(f"WARNING: {', '.join(flags)} implausible: part of the model was likely "
              "left out of the timed iterations", file=sys.stderr)
    out["device"] = device_record(dev)
    return emit(out)


if __name__ == "__main__":
    main()
