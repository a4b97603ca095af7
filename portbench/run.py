"""One run of one cell of the benchmark of the PyTorch and CUDA port
``vault_tpu_torch`` on the card:

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The run makes its weights and traffic on the device from ``--seed``
(``portbench/generate.py``), builds the system (the ``system.py`` of the
configuration's family, ``portbench/families/``), warms up the cell's
shapes, measures for ``--seconds``, then compares what the measured window
produced with the plain reference (``portbench/check.py``).  With
``--trace 0`` it reports the cell's end-to-end metrics; with ``--trace 1``
it also traces a short window after the measured one and reports the
per-layer metrics and the breakdown.  Its last line on standard output is
one JSON object; each number compared is printed beside its limit as the
last lines on standard error.

It exits with a code other than 0 and prints no result when no card (or
fewer than the cell asks for) is present, when the program is missing, or
when JAX or the JAX package is loaded in the process.
"""

from __future__ import annotations

import argparse
import gc
import json
import math
import os
import subprocess
import sys
import time
import traceback
from pathlib import Path
from types import SimpleNamespace


def _process_start() -> float:
    """The ``time.perf_counter()`` reading at which this process started
    (from ``/proc/self/stat``; this module's import where it is absent)."""
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        started = int(fields[19]) / os.sysconf("SC_CLK_TCK")
        return time.perf_counter() - (time.clock_gettime(time.CLOCK_BOOTTIME) - started)
    except (OSError, ValueError, IndexError):
        return time.perf_counter()


PROCESS_START = _process_start()
REPO = Path(__file__).resolve().parent.parent
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "vault_tpu"})
MAX_FAILED_IN_A_ROW = 3


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's,
    compared whole (``vault_tpu_torch`` is not ``vault_tpu``)."""
    return sorted({name.split(".")[0] for name in sys.modules} & FORBIDDEN)


def count(n: int):
    return lambda done, elapsed: done >= n


def timed(seconds: float):
    return lambda done, elapsed: elapsed >= seconds


def _failure(what: str) -> None:
    print(f"portbench: {what} raised:\n{traceback.format_exc()}", file=sys.stderr, flush=True)


def score_loop(model, make, first: int, until) -> dict:
    """Closed loop, one client: send batch ``first``, ``first + 1``, ...
    through the model and copy each batch's logits to the host before the
    next is sent, until ``until(batches, seconds)``.  Per batch: the time
    from the call to the logits on the host, and the call's own time."""
    import numpy as np
    import torch
    from torch.profiler import record_function

    out = {"indices": [], "logits": {}, "latency_s": [], "host_s": [], "failed": 0}
    i, in_a_row, t0 = first, 0, time.perf_counter()
    with torch.inference_mode():
        while not until(i - first, time.perf_counter() - t0):
            with record_function("portbench.make_batch"):
                inputs = make(i)
            start = time.perf_counter()
            try:
                with record_function("portbench.forward"):
                    logits = model(inputs)
                sent = time.perf_counter()
                with record_function("portbench.fetch"):
                    host = logits.float().cpu().numpy()
            except Exception:  # the loop's boundary: count the batch as failed
                _failure(f"batch {i}")
                out["failed"] += 1
                out["indices"].append(i)
                i, in_a_row = i + 1, in_a_row + 1
                if in_a_row >= MAX_FAILED_IN_A_ROW:
                    break
                continue
            done = time.perf_counter()
            in_a_row = 0
            out["indices"].append(i)
            out["logits"][i] = host
            out["latency_s"].append(done - start)
            out["host_s"].append(sent - start)
            out["failed"] += int(not np.isfinite(host).all())
            i += 1
        out["seconds"] = time.perf_counter() - t0
    out["iters"], out["next"] = len(out["indices"]), i
    return out


def train_loop(trainer, make, weight, first: int, until, read_every: int) -> dict:
    """Training steps ``first``, ``first + 1``, ... dispatched back to back
    until ``until(steps, seconds)``, the summed loss read to the host every
    ``read_every`` steps and after the last, as ``Trainer.train`` reads it.
    A read whose loss is not finite fails its steps."""
    import torch
    from torch.profiler import record_function

    out = {"host_s": [], "losses": [], "failed": 0, "iters": 0}
    acc, chunk, i, t0 = None, 0, first, time.perf_counter()

    def read():
        with record_function("portbench.read_loss"):
            total, mass = acc.cpu().tolist()
        loss = total / max(mass, 1e-9)
        out["losses"].append(loss)
        out["failed"] += 0 if math.isfinite(loss) else chunk

    while not until(i - first, time.perf_counter() - t0):
        with record_function("portbench.make_batch"):
            inputs, labels = make(i)
        start = time.perf_counter()
        try:
            with record_function("portbench.train_step"):
                step = trainer.train_step(inputs, labels, weight, i)
        except Exception:  # the loop's boundary: the step failed, the state is unknown
            _failure(f"step {i}")
            out["failed"] += 1
            out["iters"] += 1
            i += 1
            break
        out["host_s"].append(time.perf_counter() - start)
        acc = step.clone() if acc is None else acc.add_(step)
        chunk, i = chunk + 1, i + 1
        out["iters"] += 1
        if chunk == read_every:
            read()
            acc, chunk = None, 0
    if chunk:
        read()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    out["seconds"], out["next"] = time.perf_counter() - t0, i
    return out


class GcClock:
    """Seconds the interpreter's cyclic garbage collector ran while
    entered (a reading for the run's log, not a metric)."""

    def __enter__(self):
        self.seconds, self._t = 0.0, None
        gc.callbacks.append(self._tick)
        return self

    def _tick(self, phase, info):
        if phase == "start":
            self._t = time.perf_counter()
        elif self._t is not None:
            self.seconds += time.perf_counter() - self._t

    def __exit__(self, *exc):
        gc.callbacks.remove(self._tick)
        return False


def _log_window(window: dict, gc_s: float) -> None:
    """The measured window's host times per iteration on standard error."""
    host = sorted(window["host_s"])
    if host:
        q = [1e3 * host[int(f * (len(host) - 1))] for f in (0.1, 0.5, 0.9, 1.0)]
        print(f"portbench: window {window['iters']} iterations in {window['seconds']:.3f} s; "
              f"host ms p10 {q[0]:.2f} p50 {q[1]:.2f} p90 {q[2]:.2f} max {q[3]:.2f}; "
              f"garbage collection {gc_s:.3f} s", file=sys.stderr, flush=True)


def _mark(marks: list, name: str, device) -> None:
    """Note the end of a set-up phase, once the device has finished it."""
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)
    marks.append((name, time.perf_counter()))


def _traces(run_iters, shape_iters: int, traced_iters: int) -> dict:
    """A one-iteration trace that records shapes, then the traced window."""
    from portbench import devtrace

    return {"shape_trace": devtrace.capture(lambda: run_iters(shape_iters), record_shapes=True),
            "trace": devtrace.capture(lambda: run_iters(traced_iters)),
            "shape_iters": shape_iters, "traced_iters": traced_iters}


def _phases(marks) -> None:
    """Where set-up went: seconds from the process's start to the first
    mark, then between marks, on standard error."""
    steps, last = [], PROCESS_START
    for name, t in marks:
        steps.append(f"{name} {t - last:.2f}")
        last = t
    print("portbench: set-up s: " + ", ".join(steps), file=sys.stderr, flush=True)


def _free(device) -> int:
    """The device's peak of allocated bytes since the window opened; then
    the program's memory is handed back."""
    import torch

    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return peak


def _open_window(marks, device) -> float:
    """``setup_s``, and the device's memory peak counted from here on."""
    import torch

    _phases(marks)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    return marks[-1][1] - PROCESS_START


def build_scorer(cfg: dict, traffic: dict, seed: int, device, marks: list):
    """The classifier on the run's weights, warmed up on the cell's shapes:
    (model, the batch maker, the first batch after the warm-up)."""
    import torch

    from portbench import families
    from portbench.generate import make_batch, make_weights

    system = families.system(cfg, traffic["mode"])
    weights = make_weights(cfg, seed, getattr(torch, cfg["dtype"]), device)
    _mark(marks, "weights", device)
    model = system.build_scorer(cfg, weights)
    del weights
    _mark(marks, "model", device)

    def make(i):
        return make_batch(traffic, cfg, seed, i, device)[0]

    first = score_loop(model, make, 0, count(traffic["warmup_batches"]))["next"]
    _mark(marks, "warm-up", device)
    return model, make, first


def run_score(cfg: dict, traffic: dict, seed: int, seconds: float, trace: bool, device) -> dict:
    import numpy as np

    from portbench import check
    from portbench.generate import derive

    marks = [("imports", time.perf_counter())]
    model, make, first = build_scorer(cfg, traffic, seed, device, marks)
    setup_s = _open_window(marks, device)
    with GcClock() as clock:
        window = score_loop(model, make, first, timed(seconds))
    _log_window(window, clock.seconds)
    traces = {}
    if trace:
        following = [window["next"]]

        def run_iters(n):
            following[0] = score_loop(model, make, following[0], count(n))["next"]

        traces = _traces(run_iters, 1, traffic["trace_batches"])
    del model
    peak = _free(device)

    answered = [i for i in window["indices"] if i in window["logits"]]
    rng = np.random.default_rng(derive(seed, "check"))
    sample = sorted(int(i) for i in rng.choice(answered, size=min(traffic["check_batches"],
                                                                  len(answered)), replace=False))
    ref = check.score_reference(cfg, traffic, seed, sample, device, check.reference_prec(cfg))
    gap = max((check.logit_gap(window["logits"][i], ref[i]) for i in sample), default=math.inf)
    return {"setup_s": setup_s, "window": window, "peak": peak,
            "readings": {"logit_gap": gap}, **traces}


def program_readings(trainer, make, weight, weights: dict, steps: int, beta1: float) -> dict:
    """The first ``steps`` training steps through ``Trainer.train_step``:
    each step's loss, each leaf's first gradient as the optimizer got it
    (its first moment after one step over ``1 - beta1``, kept on the host)
    and its norm, and each leaf's change from ``weights`` after the last."""
    import torch

    def norm(t):
        return float(torch.linalg.vector_norm(t.double()))

    losses, norms, grads = [], {}, {}
    for s in range(steps):
        inputs, labels = make(s)
        total, mass = trainer.train_step(inputs, labels, weight, s).tolist()
        losses.append(total / max(mass, 1e-9))
        if s == 0:
            for k, m in trainer.opt_state.mu.items():
                norms[k] = norm(m) / (1.0 - beta1)
                grads[k] = m.float().div_(1.0 - beta1).to("cpu")
    delta = {k: norm(trainer.params[k].detach() - w) for k, w in weights.items()}
    return {"losses": losses, "grad_norms": norms, "grads": grads, "delta_norms": delta}


def build_trainer(cfg: dict, traffic: dict, seed: int, device, marks: list):
    """The trainer on the run's weights after its first ``checked_steps``
    steps: (trainer, the batch maker, the loss weights, the program's
    readings of those steps)."""
    import torch

    from portbench import families
    from portbench.generate import make_batch, make_weights

    system = families.system(cfg, traffic["mode"])
    weights = make_weights(cfg, seed, torch.float32, device)
    _mark(marks, "weights", device)
    trainer = system.build_trainer(cfg, traffic, weights, seed)
    weight = torch.ones(traffic["batch"], dtype=torch.float32, device=device)
    _mark(marks, "trainer", device)

    def make(i):
        return make_batch(traffic, cfg, seed, i, device)

    steps = traffic["checked_steps"]
    prog = program_readings(trainer, make, weight, weights, steps,
                            traffic["train_args"]["adam_beta1"])
    _mark(marks, f"first {steps} steps", device)
    return trainer, make, weight, prog


def run_train(cfg: dict, traffic: dict, seed: int, seconds: float, trace: bool, device) -> dict:
    from portbench import check

    marks = [("imports", time.perf_counter())]
    trainer, make, weight, prog = build_trainer(cfg, traffic, seed, device, marks)
    setup_s = _open_window(marks, device)
    with GcClock() as clock:
        window = train_loop(trainer, make, weight, traffic["checked_steps"], timed(seconds),
                            traffic["loss_read_every"])
    _log_window(window, clock.seconds)
    traces = {}
    if trace:
        following = [window["next"]]

        def run_iters(n):
            following[0] = train_loop(trainer, make, weight, following[0], count(n), n)["next"]

        traces = _traces(run_iters, 1, traffic["trace_steps"])
    del trainer
    peak = _free(device)

    ref = check.train_reference(cfg, traffic, seed, device, check.reference_prec(cfg))
    return {"setup_s": setup_s, "window": window, "peak": peak,
            "readings": check.train_gaps(prog, ref), **traces}


def device_record(device, chips: int) -> dict:
    """The card's name, count and power limit (``nvidia-smi``)."""
    import torch

    if device.type != "cuda":
        return {"platform": device.type, "kind": device.type, "count": chips}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    limits = smi.stdout.strip().splitlines()
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": chips,
            "power_limit": limits[device.index or 0].strip() if limits else "not read"}


def run_cell(spec, name: str, seed: int, seconds: float, trace: bool, device) -> dict:
    """One run of cell ``name`` on ``device``: the result object."""
    cell = spec.cell(name)
    cfg, traffic = spec.config(cell["config"]), spec.traffic(cell["traffic"])
    run = {"score": run_score, "train": run_train}[traffic["mode"]]
    got = run(cfg, traffic, seed, seconds, trace, device)
    window = got["window"]
    ctx = SimpleNamespace(cfg=cfg, traffic=traffic, window=window, setup_s=got["setup_s"],
                          trace=got.get("trace"), shape_trace=got.get("shape_trace"),
                          traced_iters=got.get("traced_iters", 0),
                          shape_iters=got.get("shape_iters", 1))
    metrics = {}
    for m in (spec.per_layer(name) if trace else spec.end_to_end(name)):
        value = spec.reader(m["name"]).read(ctx)
        if value is not None and math.isfinite(value):
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    device_info = {**device_record(device, cell["chips"]), "memory_peak_bytes": got["peak"]}
    if ctx.trace is not None:
        device_info.update(busy_s=ctx.trace.busy_s(), window_s=ctx.trace.window_s())
    from portbench import check

    checks = check.judge(got["readings"], cfg["checks"][traffic["mode"]])
    correct = (window["iters"] > 0 and window["failed"] == 0
               and all(c["ok"] for c in checks.values()))
    result = {"correct": correct, "attempted": window["iters"], "failed": window["failed"],
              "metrics": metrics, "device": device_info}
    if ctx.trace is not None:
        result["breakdown"] = {"device_ops": ctx.trace.device_ops(),
                               "idle_gaps": ctx.trace.idle_gaps()}
    result["checks"] = {k: {"value": c["value"], "limit": c["limit"]} for k, c in checks.items()}
    return result


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    import torch

    from portbench.spec import Spec

    spec = Spec()
    chips = spec.cell(args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: the cell needs {chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available",
              file=sys.stderr)
        return 2
    result = run_cell(spec, args.workload, args.seed, args.seconds, bool(args.trace),
                      torch.device("cuda", 0))
    loaded = forbidden_modules()
    if loaded:
        print(f"portbench: the process loaded {', '.join(loaded)}", file=sys.stderr)
        return 3
    print(json.dumps(result))
    sys.stdout.flush()
    for k, c in result["checks"].items():
        print(f"portbench check {k}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
