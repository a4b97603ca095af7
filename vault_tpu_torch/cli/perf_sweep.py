"""Forward throughput of VAuLT-base across batch sizes, kernel selectors,
int8 modes and token merging, on the card (port of the JAX package's
``scripts/perf_sweep.py``).

    python -m vault_tpu_torch.cli.perf_sweep [--device cpu] [--debug_tiny]

Each leg times a chain of K = 2 and 12 forwards (``utils/benchloop.py``
``make_chained_forward``, ``slope_ms``) and one chained forward's busy time
(CUPTI), and prints one JSON line.  Knobs, from the environment (an unknown
``PERF_SWEEP_*`` name or a bad value raises):
  PERF_SWEEP_BATCHES (16,32,64), PERF_SWEEP_IMPLS (0,1: 0 the plain path,
  1 the kernels, the model's own selector; or a selector such as
  fuselnqkv+fusemlp+batched), PERF_SWEEP_QUANT (0, w8 or w8a8: the model
  cast to bf16 and quantized), PERF_SWEEP_MERGE_TO / PERF_SWEEP_MERGE_LAYER
  (ToMe), PERF_SWEEP_CANVAS (384,608).
A leg that runs out of the card's memory prints its error and the sweep
goes on; any other error ends the run.
"""

from __future__ import annotations

import argparse
from typing import Mapping, Optional

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
    model_config,
    nonnegative_int,
    positive_int,
    read_knobs,
)

K_LO, K_HI = 2, 12
REPEATS = 3


def batches_knob(raw: str):
    return [positive_int(v) for v in raw.split(",") if v]


def impls_knob(raw: str):
    from vault_tpu_torch.ops.attention import parse_impl

    impls = [v for v in raw.split(",") if v]
    for v in impls:
        if v not in ("0", "1"):
            parse_impl(v)  # an unknown selector token raises
    return impls


def quant_knob(raw: str) -> str:
    if raw not in ("0", "w8", "w8a8"):
        raise ValueError("use 0, w8 or w8a8")
    return raw


KNOBS = {"BATCHES": (batches_knob, [16, 32, 64]), "IMPLS": (impls_knob, ["0", "1"]),
         "QUANT": (quant_knob, "0"), "MERGE_TO": (positive_int, None),
         "MERGE_LAYER": (nonnegative_int, 0), "CANVAS": (canvas, CANVAS)}


def selector(impl: str):
    """``use_pallas`` of a leg: "0" the plain path, "1" the model's own."""
    return {"0": False, "1": None}.get(impl, impl)


def measure_leg(model, cfg, batch_size, impl, dev, canvas_hw, k_lo=K_LO, k_hi=K_HI,
                repeats=REPEATS, seq=SEQ) -> dict:
    from vault_tpu_torch.utils.benchloop import make_chained_forward, slope_ms
    from vault_tpu_torch.utils.profiling import device_ms

    batch = bench_batch(cfg, batch_size, dev, torch.bfloat16, seq, canvas_hw)
    sel = selector(impl)
    chained = make_chained_forward(lambda m, x: m(x, use_pallas=sel),
                                   (batch_size, N_CLASSES))
    with torch.inference_mode():
        slope = slope_ms(lambda k: chained(model, batch, k)[0, 0].item(), k_lo, k_hi,
                         repeats, dev)
        busy = device_ms(lambda: chained(model, batch, 1), iters=3, warmup=1)[0] \
            if dev.type == "cuda" else None
    ms = slope["ms"]
    return {"batch": batch_size, "impl": impl,
            "use_pallas": model.use_pallas if sel is None else sel,
            "pairs_per_sec": batch_size / ms * 1e3, "ms_per_step": ms, "busy_ms": busy,
            "idle_share": None if busy is None else 1.0 - busy / ms}


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(
        prog="python -m vault_tpu_torch.cli.perf_sweep",
        description="VAuLT forward pairs/s over batches, selectors, int8 modes and "
                    "merging, one JSON line a leg (knobs: PERF_SWEEP_*).")
    add_common_args(ap, K_LO, K_HI, REPEATS)
    return ap.parse_args(argv)


def main(argv=None, environ: Optional[Mapping[str, str]] = None) -> list:
    from vault_tpu_torch.models.vault import VaultForClassification
    from vault_tpu_torch.utils.profiling import device_record

    args = parse_args(argv)
    knobs = read_knobs(environ_or(environ), "PERF_SWEEP_", KNOBS)
    dev = device_of(args)
    cfg = model_config(args.debug_tiny)
    model = VaultForClassification(cfg, n_classes=N_CLASSES, device=dev,
                                   dtype=torch.bfloat16, seed=0,
                                   merge_to=knobs["MERGE_TO"],
                                   merge_at_layer=knobs["MERGE_LAYER"])
    if knobs["QUANT"] != "0":
        model.quantize(knobs["QUANT"])
    common = {"quant": knobs["QUANT"], "merge_to": knobs["MERGE_TO"],
              "merge_at_layer": knobs["MERGE_LAYER"], "canvas": list(knobs["CANVAS"]),
              "config": "debug_tiny" if args.debug_tiny else "vault_base(bert-base-uncased)",
              "device": device_record(dev)}
    rows = []
    for impl in knobs["IMPLS"]:
        for bs in knobs["BATCHES"]:
            try:
                row = measure_leg(model, cfg, bs, impl, dev, knobs["CANVAS"], args.k_lo,
                                  args.k_hi, args.repeats)
            except torch.cuda.OutOfMemoryError as e:
                row = {"batch": bs, "impl": impl, "error": repr(e)[:200]}
                torch.cuda.empty_cache()
            rows.append(emit({**row, **common}))
    return rows


if __name__ == "__main__":
    main()
