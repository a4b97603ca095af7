"""Micro-batching HTTP inference server (port of the JAX package's
``vault_tpu/serving.py``).

  * **one batch shape**: requests are padded to a fixed ``max_batch`` by
    repeating row 0 (masked out of the returned results), so the device sees
    one shape whatever the traffic;
  * **micro-batching**: concurrent requests are coalesced into one device
    call (the queue drains up to ``max_batch`` items or waits
    ``max_wait_ms``);
  * the host half (image decode/resize + tokenize) of a request runs in the
    engine's worker, the forward on the card under ``torch.inference_mode``.

:func:`serving_impl` picks the kernel selector a quantized model serves on,
and :func:`check_serving_composition` refuses or warns about (head width,
quantization, token merging) compositions whose divergence the JAX package
measured; :func:`check_composition` applies it where a quantized model is
built (``VaultForClassification.quantize``), raising on a refusal unless
forced.  A merged model (``merge_to``) serves through the engine as any
other: the engine calls the model.

Serving over several devices runs in one process over a list of devices
(the JAX package's single controller; one list may name a device twice,
which is how one card stands in for two): :func:`dp_sharded_forward` splits
the padded batch and runs each shard's single-device forward, kernels
included, on its device; :func:`tp_forward` runs the Megatron layers
(parallel/tensor_parallel.py) on the parameter shards of each device, one
thread per shard, the partial products summed over the list; with both, a
``dp x tp`` list forms a mesh (:func:`mesh_forward`).
"""

from __future__ import annotations

import base64
import io
import json
import queue
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, List, Optional

import numpy as np
import torch


# The JAX package's measured-bad composition guard (vault_tpu/serving.py,
# budgets from its docs/BENCHMARKS.md head-divergence table): narrow pooled
# heads (TMSC 3-way, NLVR2 2-way) flipped <=1 of 48 decisions under every
# lever, but a WIDE argmax (VQA's 3129-way) leaves tiny margins.  Anything
# with >= WIDE_HEAD_CLASSES outputs is treated as that regime.
WIDE_HEAD_CLASSES = 100


def check_serving_composition(n_classes: int, quantize: Optional[str],
                              merge_to: Optional[int],
                              merge_at_layer: int = 0):
    """Validate a (head width, quantize, merge) serving composition against
    the JAX package's measured divergence budgets.  Returns (refusals,
    warnings), lists of readable strings; a non-empty ``refusals`` means the
    composition is measured-bad and a server must not start without an
    explicit force."""
    refusals, warnings = [], []
    wide = n_classes >= WIDE_HEAD_CLASSES
    merged_at_0 = merge_to is not None and merge_at_layer == 0
    merged_mid = merge_to is not None and merge_at_layer > 0
    if wide and quantize and merged_at_0:
        refusals.append(
            f"composing --quantize {quantize} with --merge_to {merge_to} "
            f"at --merge_at_layer 0 on a wide ({n_classes}-way) head "
            "flipped 12.5% (w8) / 16.7% (w8a8) of VQA decisions on the "
            "measured real-photo proxy (docs/BENCHMARKS.md head table); "
            "use --merge_at_layer 4, drop one lever, or pass --force to "
            "serve it anyway")
    elif wide and quantize and merged_mid:
        warnings.append(
            f"--quantize {quantize} composed with --merge_to {merge_to} "
            f"at layer {merge_at_layer} on a wide ({n_classes}-way) head "
            "measured 8.3% (w8) / 10.4% (w8a8) VQA decision flips on the "
            "random-init real-photo proxy — roughly the sum of the single "
            "levers; prefer a single lever for wide heads "
            "(docs/BENCHMARKS.md head table)")
    elif wide and merged_at_0:
        warnings.append(
            f"--merge_to {merge_to} at layer 0 on a wide ({n_classes}-way) "
            "head measured a 4.2% decision-flip rate on the random-init "
            "proxy; --merge_at_layer 4 halves it (2.1%) for 2/3 of the "
            "speedup (docs/BENCHMARKS.md)")
    elif wide and quantize:
        warnings.append(
            f"--quantize {quantize} on a wide ({n_classes}-way) head "
            "measured a 6.2% decision-flip rate on the random-init proxy "
            "(w8 and w8a8 alike); the lowest-divergence single lever is "
            "--merge_to with --merge_at_layer 4 (docs/BENCHMARKS.md)")
    return refusals, warnings


def check_composition(n_classes: int, quantize: Optional[str],
                      merge_to: Optional[int], merge_at_layer: int = 0,
                      force: bool = False):
    """:func:`check_serving_composition` where a server's model is built:
    each warning through ``warnings.warn``; refusals raise ``ValueError``
    unless ``force``, which turns them into warnings."""
    import warnings

    refusals, comp_warnings = check_serving_composition(n_classes, quantize, merge_to,
                                                        merge_at_layer)
    for w in comp_warnings:
        warnings.warn(w, stacklevel=3)
    if refusals and not force:
        raise ValueError("refusing the serving composition: " + "; ".join(refusals))
    for r in refusals:
        warnings.warn(f"forced: {r}", stacklevel=3)


def serving_impl(mode: Optional[str], device=None):
    """The kernel selector a model quantized in ``mode`` serves on, as the
    JAX package's ``scripts/serve.py`` picks it: w8a8 takes the fused
    LN->QKV kernel and the fused MLP blocks ("fuselnqkv+fusemlp", plus the
    port's attention kernel, "+batched", on the card); bf16 and w8 keep
    "auto"."""
    if mode != "w8a8":
        return "auto"
    on_cuda = device is not None and torch.device(device).type == "cuda"
    return "fuselnqkv+fusemlp" + ("+batched" if on_cuda else "")


def _replicas(params, devices):
    """One copy of the state dict ``params`` per distinct device (a device
    named twice shares its copy); strides are kept, so K-major int8 codes
    stay K-major."""
    copies = {}
    for d in devices:
        d = torch.device(d)
        if str(d) not in copies:
            copies[str(d)] = {k: v.to(d) for k, v in params.items()}
    return [copies[str(torch.device(d))] for d in devices]


def _split(batch, n: int):
    """The batch dict's rows in ``n`` equal shards (the rows must divide)."""
    rows = len(next(iter(batch.values())))
    if rows % n:
        raise ValueError(f"a batch of {rows} rows does not split over {n} devices")
    m = rows // n
    return [{k: v[i * m:(i + 1) * m] for k, v in batch.items()} for i in range(n)]


def dp_sharded_forward(apply_fn: Callable, devices, params) -> Callable:
    """Data-parallel serving over ``devices`` (the JAX package's
    ``dp_sharded_forward``, there over a mesh "data" axis under
    ``shard_map``, so its Pallas kernels stay engaged per shard).  The
    parameters are copied to each device, the padded batch is split in
    ``len(devices)`` shards, and each shard's single-device forward
    ``apply_fn(params, batch) -> logits`` is launched on its device with
    its kernels; the logits come back on ``devices[0]``.  The batch rows
    must divide by the device count (the engine pads to ``max_batch``;
    ``cli.serve`` checks ``--max_batch``).  Returns ``fwd(batch)``."""
    devices = [torch.device(d) for d in devices]
    replicas = _replicas(params, devices)

    def fwd(batch):
        from vault_tpu_torch.models.vault import batch_to_device

        outs = [apply_fn(p, batch_to_device(b, d))
                for p, b, d in zip(replicas, _split(batch, len(devices)), devices)]
        return torch.cat([o.to(devices[0]) for o in outs])

    return fwd


def _run_threads(fns):
    """Run each of ``fns`` in a thread of its own; their results in order.
    The first error is raised after every thread ended (a thread's failure
    breaks the others' barriers instead of leaving them waiting)."""
    results, errors = [None] * len(fns), [None] * len(fns)

    def run(i):
        try:
            with torch.no_grad():
                results[i] = fns[i]()
        except BaseException as e:  # noqa: BLE001 (re-raised below)
            errors[i] = e
            for f in fns:
                shared = getattr(f, "shared", None)
                if shared is not None:
                    shared.barrier.abort()

    threads = [threading.Thread(target=run, args=(i,), daemon=True)
               for i in range(len(fns))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    first = next((e for e in errors if e is not None
                  and not isinstance(e, threading.BrokenBarrierError)), None)
    first = first or next((e for e in errors if e is not None), None)
    if first is not None:
        raise first
    return results


def mesh_forward(apply_fn: Callable, devices, params, dp: int = 1, tp: int = 1
                 ) -> Callable:
    """Serving over a ``dp x tp`` list of devices (row-major: data group
    ``d`` holds ``devices[d * tp:(d + 1) * tp]``): each data group takes its
    rows of the batch, and within it each device runs the tensor-parallel
    layers on its parameter shards (parallel/sharding.py), in a thread of
    its own; the row products are summed over the group in shard order, so
    every shard of a group holds the same activations.  ``apply_fn(params,
    batch) -> logits`` is the single-device forward, which takes the
    tensor-parallel path while a group is active.  Returns ``fwd(batch)``
    with the logits on ``devices[0]``."""
    from vault_tpu_torch.parallel.sharding import shard_params
    from vault_tpu_torch.parallel.tensor_parallel import (
        ThreadTP,
        ThreadTPShared,
        thread_tp,
    )

    devices = [torch.device(d) for d in devices]
    if len(devices) != dp * tp:
        raise ValueError(f"a {dp} x {tp} mesh needs {dp * tp} devices, "
                         f"got {len(devices)}")
    shards = [shard_params(params, i % tp, tp) for i in range(len(devices))]
    placed = [{k: v.to(d) for k, v in s.items()} for s, d in zip(shards, devices)]

    def fwd(batch):
        from vault_tpu_torch.models.vault import batch_to_device

        fns, groups = [], []
        for di, rows in enumerate(_split(batch, dp)):
            shared = ThreadTPShared(tp)
            groups.append(shared)
            for mi in range(tp):
                i = di * tp + mi

                def one(i=i, mi=mi, rows=rows, shared=shared):
                    with thread_tp(ThreadTP(mi, shared)):
                        return apply_fn(placed[i], batch_to_device(rows, devices[i]))

                one.shared = shared
                fns.append(one)
        outs = _run_threads(fns)
        return torch.cat([outs[di * tp].to(devices[0]) for di in range(dp)])

    return fwd


def tp_forward(apply_fn: Callable, devices, params) -> Callable:
    """Tensor-parallel serving over ``devices`` (:func:`mesh_forward` with
    one data group)."""
    return mesh_forward(apply_fn, devices, params, dp=1, tp=len(devices))


def decode_image(data: bytes) -> np.ndarray:
    """Image bytes (PNG/JPEG) -> (H, W, 3) uint8.  Needs Pillow, imported
    here so the rest of the module works without it."""
    from PIL import Image

    with Image.open(io.BytesIO(data)) as im:
        return np.asarray(im.convert("RGB"), np.uint8)


def pad_rows(v, n: int):
    """Rows of ``v`` (array or tensor) padded to ``n`` by repeating row 0."""
    if len(v) >= n:
        return v
    if isinstance(v, torch.Tensor):
        return torch.cat([v] + [v[:1]] * (n - len(v)))
    return np.concatenate([v] + [v[:1]] * (n - len(v)))


@dataclass
class _Pending:
    image: np.ndarray
    text: str
    event: threading.Event = field(default_factory=threading.Event)
    result: Optional[np.ndarray] = None
    error: Optional[str] = None


class BatchingEngine:
    """Coalesces concurrent predict() calls into fixed-size device batches.

    ``apply(features_dict) -> logits`` takes a full ``max_batch``-sized
    processor output (numpy arrays, or tensors from a processor that works
    on the card) and returns a tensor or array; it runs under
    ``torch.inference_mode()``.  Short batches are padded by repeating row 0.
    """

    def __init__(self, processor, apply: Callable, max_batch: int = 8,
                 max_wait_ms: float = 5.0):
        self.processor = processor
        self.apply = apply
        self.max_batch = max_batch
        self.max_wait_ms = max_wait_ms
        self._q: "queue.Queue[_Pending]" = queue.Queue()
        self._stop = threading.Event()
        self.batches_run = 0          # observability: device calls made
        self.requests_served = 0
        # stats() iterates these windows while request and worker threads
        # append, so both sides take the lock
        self._stats_lock = threading.Lock()
        self._req_lat_ms = deque(maxlen=1024)
        self._batch_ms = deque(maxlen=1024)
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._worker.start()

    def stats(self) -> dict:
        """Liveness + latency snapshot for /healthz and /metrics."""
        def pct(window, q):
            if not window:
                return None
            xs = sorted(window)
            return round(xs[min(len(xs) - 1, int(q * len(xs)))], 2)

        with self._stats_lock:
            return {
                "batches_run": self.batches_run,
                "requests_served": self.requests_served,
                "queue_depth": self._q.qsize(),
                "request_latency_ms_p50": pct(self._req_lat_ms, 0.50),
                "request_latency_ms_p99": pct(self._req_lat_ms, 0.99),
                "batch_ms_p50": pct(self._batch_ms, 0.50),
            }

    # ------------------------------------------------------------- client
    def predict(self, image: np.ndarray, text: str,
                timeout: float = 30.0) -> np.ndarray:
        t0 = time.perf_counter()
        item = _Pending(image=image, text=text)
        self._q.put(item)
        if not item.event.wait(timeout):
            raise TimeoutError("predict timed out")
        if item.error is not None:
            raise RuntimeError(item.error)
        with self._stats_lock:
            self._req_lat_ms.append((time.perf_counter() - t0) * 1e3)
        return item.result

    def close(self):
        self._stop.set()
        self._worker.join(timeout=5)

    # ------------------------------------------------------------- worker
    def _drain(self) -> List[_Pending]:
        try:
            first = self._q.get(timeout=0.1)
        except queue.Empty:
            return []
        items = [first]
        deadline = self.max_wait_ms / 1e3
        t0 = time.perf_counter()
        while len(items) < self.max_batch:
            remaining = deadline - (time.perf_counter() - t0)
            if remaining <= 0:
                break
            try:
                items.append(self._q.get(timeout=remaining))
            except queue.Empty:
                break
        return items

    def _run(self):
        while not self._stop.is_set():
            items = self._drain()
            if not items:
                continue
            try:
                t0 = time.perf_counter()
                enc = self.processor([it.image for it in items],
                                     [it.text for it in items])
                n = len(items)
                feats = {k: pad_rows(v, self.max_batch) for k, v in enc.items()}
                with torch.inference_mode():
                    out = self.apply(feats)
                    if isinstance(out, torch.Tensor):
                        out = out.float().cpu().numpy()
                out = np.asarray(out)
                with self._stats_lock:
                    self._batch_ms.append((time.perf_counter() - t0) * 1e3)
                    self.batches_run += 1
                    self.requests_served += n
                for i, it in enumerate(items):
                    it.result = out[i]
                    it.event.set()
            except Exception as e:  # surface errors to every waiter
                for it in items:
                    it.error = f"{type(e).__name__}: {e}"
                    it.event.set()


def make_handler(engine: BatchingEngine):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *args):  # quiet
            pass

        def _send(self, code: int, payload: dict):
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                self._send(200, {"ok": True, **engine.stats()})
            elif self.path == "/metrics":
                # Prometheus text exposition
                lines = []
                for k, v in engine.stats().items():
                    if v is None:
                        continue
                    kind = ("counter" if k in ("batches_run",
                                               "requests_served") else "gauge")
                    lines.append(f"# TYPE vault_{k} {kind}")
                    lines.append(f"vault_{k} {v}")
                body = ("\n".join(lines) + "\n").encode()
                self.send_response(200)
                self.send_header("Content-Type", "text/plain; version=0.0.4")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
            else:
                self._send(404, {"error": "not found"})

        def do_POST(self):
            if self.path != "/predict":
                self._send(404, {"error": "not found"})
                return
            # parse/decode problems are the client's (400); engine/device
            # failures are ours (500)
            try:
                length = int(self.headers.get("Content-Length", "0"))
                req = json.loads(self.rfile.read(length))
                image = decode_image(base64.b64decode(req["image_b64"]))
                text = req["text"]
            except Exception as e:
                self._send(400, {"error": f"{type(e).__name__}: {e}"})
                return
            try:
                out = engine.predict(image, text)
                self._send(200, {"output": np.asarray(out).tolist()})
            except Exception as e:
                self._send(500, {"error": f"{type(e).__name__}: {e}"})

    return Handler


class InferenceServer:
    """HTTP wrapper: POST /predict {"text", "image_b64"} -> {"output"};
    GET /healthz -> liveness + batching/latency stats;
    GET /metrics -> the same stats in Prometheus text format."""

    def __init__(self, processor, apply: Callable, host: str = "127.0.0.1",
                 port: int = 0, max_batch: int = 8, max_wait_ms: float = 5.0):
        self.engine = BatchingEngine(processor, apply, max_batch, max_wait_ms)
        self.httpd = ThreadingHTTPServer((host, port),
                                         make_handler(self.engine))
        self.port = self.httpd.server_address[1]
        self._thread = threading.Thread(target=self.httpd.serve_forever,
                                        daemon=True)

    def start(self):
        self._thread.start()
        return self

    def close(self):
        if self._thread.is_alive():  # shutdown() waits for a serve_forever loop
            self.httpd.shutdown()
        self.httpd.server_close()
        self.engine.close()
