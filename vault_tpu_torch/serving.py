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

Data-parallel serving and the serving-composition guard wait for the
parallel and quantization slices of the port.
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
        self.httpd.shutdown()
        self.httpd.server_close()
        self.engine.close()
