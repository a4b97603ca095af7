"""The port's host side and serving layer against the JAX package's.

Tokenizer and processor: the same texts and numpy images go through both
packages.  Text fields and ``pixel_mask`` must match exactly; the port
resizes with PyTorch's antialiased bicubic in PIL's pass order where the JAX
package reproduces PIL bit for bit, so ``pixel_values`` may differ by one
uint8 level, 2/255 after normalization.  Serving: the engine's rows equal a
direct forward of the same padded batch, and the HTTP surface answers.
"""

import base64
import concurrent.futures
import io
import json
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch
from PIL import Image

from vault_tpu.data.processor import VaultProcessor as JProcessor
from vault_tpu.text.wordpiece import WordPieceTokenizer as JTokenizer
from vault_tpu_torch.config import VaultConfig, tiny_text_config, tiny_vilt_config
from vault_tpu_torch.data.image import target_size
from vault_tpu_torch.data.processor import VaultProcessor
from vault_tpu_torch.models.vault import VaultForClassification
from vault_tpu_torch.serving import BatchingEngine, InferenceServer, decode_image
from vault_tpu_torch.text.wordpiece import WordPieceTokenizer

VOCAB = ("[PAD] [UNK] [CLS] [SEP] [MASK] a the cat dog couch on sits un ##der "
         "##s ##ing caf ##e x ! , . ' 東 京").split()
PIXEL_ATOL = 2.0 / 255 + 1e-6
MAX_BATCH = 4

TEXTS = ["a cat sits on the couch", "Dogs sitting under the couch!",
         "Café, x'x.", "東京 cat", "", "unknownword cat dog [SEP] the",
         "the " * 30]


def _vocab():
    return {t: i for i, t in enumerate(VOCAB)}


def _images(seed=0):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:120, 0:200]
    smooth = np.stack([xx, yy, (xx + 2 * yy) % 256], -1).astype(np.uint8)
    return [rng.integers(0, 256, (90, 160, 3), dtype=np.uint8),
            smooth,
            rng.integers(0, 256, (200, 70, 3), dtype=np.uint8),      # portrait
            rng.integers(0, 256, (40, 700, 3), dtype=np.uint8),      # safe-crop
            rng.integers(0, 256, (64, 64), dtype=np.uint8),          # grayscale
            rng.integers(0, 256, (50, 80, 4), dtype=np.uint8),       # RGBA
            rng.integers(0, 256, (33, 47, 3), dtype=np.uint8)]


@pytest.mark.parametrize("pairs", [False, True])
def test_tokenizer_matches_jax(pairs):
    ours, ref = WordPieceTokenizer(_vocab()), JTokenizer(_vocab())
    for t in TEXTS:
        assert ours.tokenize(t) == ref.tokenize(t)
    text_pairs = [TEXTS[-1 - i] for i in range(len(TEXTS))] if pairs else None
    a = ours.batch_encode(TEXTS, text_pairs, max_length=12)
    b = ref.batch_encode(TEXTS, text_pairs, max_length=12)
    for k in b:
        np.testing.assert_array_equal(a[k], b[k])
        assert a[k].dtype == b[k].dtype


@pytest.mark.parametrize("canvas", ["auto", (384, 640), None])
def test_processor_matches_jax(canvas):
    ours = VaultProcessor(WordPieceTokenizer(_vocab()), max_length=10, canvas=canvas)
    ref = JProcessor(JTokenizer(_vocab()), max_length=10, canvas=canvas)
    a = ours(_images(), TEXTS)
    b = ref(_images(), TEXTS)
    assert set(a) == set(b)
    for k in ("input_ids", "attention_mask", "token_type_ids", "pixel_mask"):
        np.testing.assert_array_equal(a[k], b[k])
    assert a["pixel_values"].shape == b["pixel_values"].shape
    assert a["pixel_values"].dtype == np.float32
    np.testing.assert_allclose(a["pixel_values"], b["pixel_values"],
                               atol=PIXEL_ATOL, rtol=0)


@pytest.mark.parametrize("num_workers", [0, 1, 4])
def test_parallel_map_keeps_order(num_workers):
    """The decode pool maps in order for any worker count, as the JAX
    package's ``parallel_map``."""
    from vault_tpu.data.loader import parallel_map as jmap
    from vault_tpu_torch.data.loader import parallel_map

    items = list(range(23))
    fn = lambda i: (i * 7) % 5 + i / 100
    assert parallel_map(fn, items, num_workers) == [fn(i) for i in items]
    assert parallel_map(fn, items, num_workers) == jmap(fn, items, num_workers)
    assert parallel_map(fn, items[:1], num_workers) == [fn(0)]


@pytest.mark.parametrize("canvas", ["auto", (384, 640)])
def test_processor_workers_give_the_serial_result(canvas):
    """``VaultProcessor(num_workers=...)``: 0, 1 and 4 worker threads give
    the same batch, rows in order, bit for bit; and that batch equals the
    JAX processor's (text fields and mask exactly, pixels within
    ``PIXEL_ATOL``) at its own worker counts."""
    images = _images(3)
    outs = [VaultProcessor(WordPieceTokenizer(_vocab()), max_length=10, canvas=canvas,
                           num_workers=n)(images, TEXTS) for n in (0, 1, 4)]
    for out in outs[1:]:
        assert set(out) == set(outs[0])
        for k in out:
            np.testing.assert_array_equal(out[k], outs[0][k])
    ref = JProcessor(JTokenizer(_vocab()), max_length=10, canvas=canvas)
    for n in (0, 4):
        b = {**ref.encode_text(TEXTS)}
        b["pixel_values"], b["pixel_mask"] = ref.encode_images(images, num_workers=n)
        for k in ("input_ids", "attention_mask", "token_type_ids", "pixel_mask"):
            np.testing.assert_array_equal(outs[0][k], b[k])
        np.testing.assert_allclose(outs[0]["pixel_values"], b["pixel_values"],
                                   atol=PIXEL_ATOL, rtol=0)
    # the call's worker count overrides the processor's
    proc = VaultProcessor(WordPieceTokenizer(_vocab()), max_length=10, canvas=canvas)
    pv, pm = proc.encode_images(images, num_workers=4)
    np.testing.assert_array_equal(pv, outs[0]["pixel_values"])
    np.testing.assert_array_equal(pm, outs[0]["pixel_mask"])


def test_target_size_matches_hf_geometry():
    assert target_size(480, 640) == (384, 512)
    assert target_size(640, 480) == (512, 384)
    assert target_size(100, 1000) == (64, 608)


def _setup():
    cfg = VaultConfig(vilt=tiny_vilt_config(image_size=32, patch_size=16,
                                            num_patch_tokens=8),
                      text_tower=tiny_text_config(num_hidden_layers=1))
    model = VaultForClassification(cfg, device="cpu", seed=0)
    proc = VaultProcessor(WordPieceTokenizer(_vocab()), max_length=8,
                          canvas=(32, 32))
    return model, proc


def _img(seed, size=(40, 30)):
    return np.random.default_rng(seed).integers(0, 255, (*size, 3)).astype(np.uint8)


def _direct(model, proc, images, texts):
    enc = proc(images, texts)
    n = len(images)
    feats = {k: np.concatenate([v] + [v[:1]] * (MAX_BATCH - n)) for k, v in enc.items()}
    with torch.inference_mode():
        return model(feats).numpy()[:n]


def test_engine_matches_direct_call_and_pads():
    model, proc = _setup()
    eng = BatchingEngine(proc, model, max_batch=MAX_BATCH, max_wait_ms=1.0)
    try:
        out = eng.predict(_img(0), "a cat on the couch")
        np.testing.assert_array_equal(
            out, _direct(model, proc, [_img(0)], ["a cat on the couch"])[0])
        assert eng.stats()["batches_run"] == 1
        assert eng.stats()["requests_served"] == 1
    finally:
        eng.close()
    assert not eng._worker.is_alive()


def test_engine_coalesces_concurrent_requests():
    model, proc = _setup()
    eng = BatchingEngine(proc, model, max_batch=MAX_BATCH, max_wait_ms=200.0)
    texts = ["a cat", "the dog", "a couch", "cat on the couch", "dog", "a"]
    try:
        with concurrent.futures.ThreadPoolExecutor(len(texts)) as pool:
            futs = [pool.submit(eng.predict, _img(i), t, 30.0)
                    for i, t in enumerate(texts)]
            results = [f.result(timeout=60) for f in futs]
        stats = eng.stats()
    finally:
        eng.close()
    assert stats["requests_served"] == len(texts)
    assert stats["batches_run"] < len(texts)  # requests shared device calls
    # rows are independent: each equals its row in a direct padded batch
    for i, t in enumerate(texts):
        ref = _direct(model, proc, [_img(i)], [t])[0]
        np.testing.assert_allclose(results[i], ref, atol=1e-6)


def test_engine_reports_errors_to_every_waiter():
    _, proc = _setup()

    def broken(feats):
        raise RuntimeError("device lost")

    eng = BatchingEngine(proc, broken, max_batch=MAX_BATCH, max_wait_ms=1.0)
    try:
        with pytest.raises(RuntimeError, match="device lost"):
            eng.predict(_img(0), "a cat")
    finally:
        eng.close()


def _png_b64(arr):
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="PNG")
    return base64.b64encode(buf.getvalue()).decode()


def _post(port, path, payload):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                 data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    return urllib.request.urlopen(req, timeout=30)


def test_http_server_predict_healthz_metrics():
    model, proc = _setup()
    srv = InferenceServer(proc, model, port=0, max_batch=MAX_BATCH,
                          max_wait_ms=1.0).start()
    try:
        img = _img(3)
        with _post(srv.port, "/predict", {"text": "a dog", "image_b64": _png_b64(img)}) as r:
            out = json.loads(r.read())["output"]
        ref = _direct(model, proc, [decode_image(base64.b64decode(_png_b64(img)))],
                      ["a dog"])[0]
        np.testing.assert_allclose(np.asarray(out, np.float32), ref, atol=1e-6)
        with urllib.request.urlopen(f"http://127.0.0.1:{srv.port}/healthz",
                                    timeout=30) as r:
            health = json.loads(r.read())
        assert health["ok"] and health["requests_served"] == 1
        with urllib.request.urlopen(f"http://127.0.0.1:{srv.port}/metrics",
                                    timeout=30) as r:
            assert "vault_requests_served 1" in r.read().decode()
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(srv.port, "/predict", {"text": "a dog", "image_b64": "@@"})
        assert e.value.code == 400
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(f"http://127.0.0.1:{srv.port}/nope", timeout=30)
        assert e.value.code == 404
    finally:
        srv.close()
