"""Chip smoke test of the PyTorch port on one NVIDIA H100.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``vault_tpu_torch/csrc``, holds each
against its plain PyTorch version at the main path's shapes, times it beside
its bound and a PyTorch library call, drives the VAuLT-base classifier
(bert-base-uncased tower + ViLT-B/32, bf16, seeded random weights) through
``VaultForClassification`` and a ``BatchingEngine``, and checks the launch
counts and the outputs.  Each phase prints one JSON line; any failure exits
non-zero.  The last line is ``{"ok": true, "device": {...}}``.  Needs a CUDA
card: without one it exits non-zero and prints no result.  Imports nothing of
JAX or of the JAX package.
"""

from __future__ import annotations

import concurrent.futures
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

PEAK_BF16_FLOPS = 989e12   # H100 SXM dense bf16 tensor-core rate
PEAK_F32_FLOPS = 67e12     # H100 SXM fp32 without tensor cores
PEAK_BYTES = 3.35e12       # H100 SXM HBM3
OUT_DIR = Path("chiprun_out") / "chip_smoke"

# Limits of |kernel - plain| on the same inputs.  bf16: both round the
# activations and the output to bf16 at different points (the kernel keeps
# the GELU input in fp32, the plain composition rounds the first product to
# bf16 first), so they differ by a few bf16 ulps of the output (2^-7
# relative); fp32: only the summation order differs.
LIMITS = {"bfloat16": 6.25e-2, "float32": 1e-4}
# |kernel path - plain path| of the full-width bf16 forward: 24 layers of
# the per-kernel differences above, through the final LN and the tanh pooler.
FORWARD_LIMITS = {"pooler": 6e-2, "logits": 2e-2}


def emit(**kw):
    print(json.dumps(kw), flush=True)


def fail(msg: str):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def time_ms(fn, iters=20, warmup=3):
    """Wall time per call between CUDA events: includes any gap the host
    leaves between launches."""
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters=20, warmup=3):
    """Device time per call: the summed durations of the CUDA kernels the
    call launches, from a torch.profiler trace (CUPTI).  Returns
    (ms, {kernel name: ms}); fails if the trace holds no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    by_name = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            name = e.name.replace("(anonymous namespace)::", "")
            name = name.removeprefix("void ").split("(")[0].split("<")[0][:60]
            by_name[name] = by_name.get(name, 0.0) + e.time_range.elapsed_us() / 1e3 / iters
    total = sum(by_name.values())
    if total <= 0.0:
        fail("the profiler trace holds no device time")
    return total, by_name


def timed(fn, prefix, row, iters=20):
    """Device ms (``<prefix>ms``) and event wall ms (``<prefix>wall_ms``)."""
    row[prefix + "ms"], kernels = device_ms(fn, iters)
    row[prefix + "wall_ms"] = time_ms(fn, iters)
    row[prefix + "device_kernels"] = kernels


def bound_ms(flops: float, nbytes: float, dtype) -> tuple:
    import torch

    peak = PEAK_BF16_FLOPS if dtype == torch.bfloat16 else PEAK_F32_FLOPS
    t_ops, t_bytes = flops / peak, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def host_profile(fn, iters=3, top=10):
    """Where the host time of ``fn`` goes, ms per call: the PyTorch ops by
    self CPU time (torch.profiler CPU trace, with their calls per call), and
    the Python functions by own time (cProfile, which inflates Python time;
    read it for proportions)."""
    import cProfile
    import pstats

    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    ops = sorted(prof.key_averages(), key=lambda e: -e.self_cpu_time_total)[:top]
    pr = cProfile.Profile()
    pr.enable()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    pr.disable()
    st = pstats.Stats(pr).stats  # (file, line, name) -> (cc, nc, tt, ct, callers)
    funcs = sorted(st.items(), key=lambda kv: -kv[1][2])[:top]
    return {
        "torch_ops_self_ms": {e.key[:60]: [e.self_cpu_time_total / 1e3 / iters,
                                           e.count // iters] for e in ops},
        "python_own_ms": {f"{Path(k[0]).name}:{k[2]}": [v[2] * 1e3 / iters,
                                                         v[1] // iters]
                          for k, v in funcs},
    }


# ---------------------------------------------------------------------------
# Kernel checks
# ---------------------------------------------------------------------------

def attention_case(gen, b, h, l, dtype, dev, fused):
    """q, k, v (B, H, L, 64) and a key-padding bias.  ``fused``: the heads
    are views into one (B, L, 3 H 64) projection, as the main path's fused
    QKV product hands them to the kernel."""
    import torch

    from vault_tpu_torch.ops.attention import split_heads
    from vault_tpu_torch.ops.masks import extend_attention_mask

    if fused:
        qkv = torch.randn((b, l, 3 * h * 64), generator=gen, device=dev).to(dtype)
        q, k, v = (split_heads(t, h) for t in torch.chunk(qkv, 3, dim=-1))
    else:
        q, k, v = (torch.randn((b, h, l, 64), generator=gen, device=dev).to(dtype)
                   for _ in range(3))
    lens = torch.randint(max(1, l // 2), l + 1, (b,), generator=gen, device=dev)
    mask = (torch.arange(l, device=dev)[None] < lens[:, None]).to(torch.int32)
    return q, k, v, extend_attention_mask(mask)


def check_attention(gen, dev):
    import torch
    import torch.nn.functional as F

    from vault_tpu_torch.ops import cuda_attention as ca

    rows = []
    for b, h, l, dtype in ((8, 12, 40, torch.bfloat16),
                           (8, 12, 256, torch.bfloat16),
                           (2, 3, 77, torch.float32)):
        q, k, v, bias = attention_case(gen, b, h, l, dtype, dev,
                                       fused=dtype == torch.bfloat16)
        out = ca.fused_attention(q, k, v, bias)
        ref = ca.attention_plain(q, k, v, bias)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        limit = LIMITS[str(dtype).split(".")[-1]]
        if not math.isfinite(err) or err > limit:
            fail(f"attention {(b, h, l)} {dtype}: max |kernel - plain| {err} > {limit}")
        row = dict(kernel="encoder_attention", shape=[b, h, l, 64],
                   dtype=str(dtype).split(".")[-1], max_abs_err=err, limit=limit)
        if dtype == torch.bfloat16:
            allowed = bias > -1.0  # True where a key is attended
            timed(lambda: ca.fused_attention(q, k, v, bias), "", row)
            timed(lambda: ca.attention_plain(q, k, v, bias), "plain_", row)
            timed(lambda: F.scaled_dot_product_attention(
                q, k, v, attn_mask=allowed), "library_", row)
            flops = 4.0 * b * h * l * l * 64
            nbytes = 4.0 * q.numel() * q.element_size() + bias.numel() * 4
            row["bound_ms"], row["bound_by"] = bound_ms(flops, nbytes, dtype)
        emit(phase="kernel_check", **row)
        rows.append(row)
    return rows


def mlp_operands(gen, rows, dtype, dev, with_mask, h=768, i=3072):
    import torch

    def rnd(*shape, std=1.0, mean=0.0):
        return (torch.randn(shape, generator=gen, device=dev) * std + mean).to(dtype)

    x = rnd(rows, h)
    ops = dict(gamma=rnd(h, std=0.1, mean=1.0), beta=rnd(h, std=0.1),
               w1=rnd(h, i, std=0.02), b1=rnd(i, std=0.02),
               w2=rnd(i, h, std=0.02), b2=rnd(h, std=0.02))
    m = None
    if with_mask:
        keep = torch.rand((rows, h), generator=gen, device=dev) < 0.9
        m = torch.where(keep, torch.tensor(1 / 0.9, device=dev),
                        torch.tensor(0.0, device=dev)).to(dtype)
    return x, ops, m


def check_mlp(gen, dev, postln: bool):
    import torch
    import torch.nn.functional as F

    from vault_tpu_torch.ops import cuda_mlp as cm

    name = "mlp_postln" if postln else "mlp_block"
    kernel = cm.fused_mlp_postln_fwd if postln else cm.fused_mlp_block_fwd
    plain = cm._mlp_postln_plain if postln else cm._mlp_block_plain
    main_rows = 8 * 40 if postln else 8 * 256
    rows_out = []
    for rows, dtype, with_mask in ((main_rows, torch.bfloat16, False),
                                   (main_rows, torch.bfloat16, True),
                                   (77, torch.float32, True)):
        x, o, m = mlp_operands(gen, rows, dtype, dev, with_mask)
        ln_p = {"scale": o["gamma"], "bias": o["beta"]}
        p_in = {"w": o["w1"], "b": o["b1"]}
        p_out = {"w": o["w2"], "b": o["b2"]}
        run = lambda: kernel(o["gamma"], o["beta"], o["w1"], o["b1"], o["w2"],
                             o["b2"], x, m, eps=1e-12)
        ref_fn = lambda: plain(ln_p, p_in, p_out, x, 1e-12, "gelu", m)
        out, ref = run(), ref_fn()
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        limit = LIMITS[str(dtype).split(".")[-1]]
        if not math.isfinite(err) or err > limit:
            fail(f"{name} rows={rows} {dtype} mask={with_mask}: "
                 f"max |kernel - plain| {err} > {limit}")
        row = dict(kernel=name, rows=rows, dtype=str(dtype).split(".")[-1],
                   mask=with_mask, max_abs_err=err, limit=limit)
        if dtype == torch.bfloat16 and not with_mask:
            w1t, w2t = o["w1"].t().contiguous(), o["w2"].t().contiguous()
            g, bt, b1, b2 = o["gamma"], o["beta"], o["b1"], o["b2"]
            if postln:
                lib = lambda: F.layer_norm(
                    x + F.linear(F.gelu(F.linear(x, w1t, b1)), w2t, b2),
                    (768,), g, bt, 1e-12)
            else:
                lib = lambda: x + F.linear(F.gelu(F.linear(
                    F.layer_norm(x, (768,), g, bt, 1e-12), w1t, b1)), w2t, b2)
            timed(run, "", row)
            timed(ref_fn, "plain_", row)
            timed(lib, "library_", row)
            h, i = 768, 3072
            flops = 4.0 * rows * h * i
            nbytes = (2 * rows * h + 2 * h * i + 3 * h + i) * x.element_size()
            row["bound_ms"], row["bound_by"] = bound_ms(flops, nbytes, dtype)
        emit(phase="kernel_check", **row)
        rows_out.append(row)
    return rows_out


# ---------------------------------------------------------------------------
# Full-width forward and serving
# ---------------------------------------------------------------------------

def entry_batch(cfg, batch_size, dev, seed=0):
    """The JAX package's ``entry()`` input layout: 40 text tokens, a
    384x608 canvas, bf16 pixels."""
    import torch

    rng = np.random.default_rng(seed)
    seq = 40
    return {
        "input_ids": torch.as_tensor(rng.integers(
            0, cfg.text_tower.vocab_size, (batch_size, seq)), device=dev),
        "attention_mask": torch.ones((batch_size, seq), dtype=torch.int64, device=dev),
        "token_type_ids": torch.zeros((batch_size, seq), dtype=torch.int64, device=dev),
        "pixel_values": torch.as_tensor(rng.normal(size=(batch_size, 3, 384, 608)),
                                        dtype=torch.float32, device=dev).to(torch.bfloat16),
        "pixel_mask": torch.ones((batch_size, 384, 608), dtype=torch.int64, device=dev),
    }


def counters():
    from vault_tpu_torch.ops import cuda_attention as ca
    from vault_tpu_torch.ops import cuda_mlp as cm

    return {"encoder_attention": ca.fused_attention,
            "mlp_block": cm.fused_mlp_block_fwd,
            "mlp_postln": cm.fused_mlp_postln_fwd}


def reset_counts():
    for fn in counters().values():
        fn.launches = 0


def read_counts():
    return {name: fn.launches for name, fn in counters().items()}


def forward_phase(dev):
    import torch

    from vault_tpu_torch.models.vault import (
        VaultForClassification,
        classifier_head_apply,
        vault_apply,
    )
    from vault_tpu_torch.presets import vault_base

    cfg = vault_base("bert-base-uncased")
    t0 = time.perf_counter()
    model = VaultForClassification(cfg, n_classes=3, device=dev,
                                   dtype=torch.bfloat16, seed=0)
    n_params = sum(p.numel() for p in model.parameters())
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    batch = entry_batch(cfg, 8, dev)
    with torch.inference_mode():
        reset_counts()
        logits = model(batch)
        torch.cuda.synchronize()
        counts = read_counts()
    want = {"encoder_attention": 24, "mlp_block": 12, "mlp_postln": 12}
    if counts != want:
        fail(f"launches per forward {counts}, expected {want}")
    if logits.shape != (8, 3) or not torch.isfinite(logits.float()).all():
        fail(f"logits {tuple(logits.shape)} not finite")

    with torch.inference_mode():
        outs = {}
        for impl in ("auto", False):
            out = vault_apply(model, cfg, deterministic=True, use_pallas=impl,
                              **batch)
            outs[impl] = (out.pooler_output.float(),
                          classifier_head_apply(model["head"], out.pooler_output,
                                                deterministic=True).float())
    err_pool = (outs["auto"][0] - outs[False][0]).abs().max().item()
    err_logits = (outs["auto"][1] - outs[False][1]).abs().max().item()
    if (err_logits > FORWARD_LIMITS["logits"] or err_pool > FORWARD_LIMITS["pooler"]
            or (outs["auto"][1] - logits.float()).abs().max().item() != 0.0):
        fail(f"forward kernel path vs plain path: pooler {err_pool}, logits "
             f"{err_logits} (limits {FORWARD_LIMITS})")
    timings = {}
    with torch.inference_mode():
        for bs in (8, 16):
            b = entry_batch(cfg, bs, dev, seed=1)
            kernel_path = lambda: model(b)
            plain_path = lambda: model(b, use_pallas=False)
            # parent-change style alternation: plain, kernel, kernel, plain
            samples = {"kernel": [], "plain": []}
            for path in ("plain", "kernel", "kernel", "plain"):
                fn = kernel_path if path == "kernel" else plain_path
                samples[path] += [time_ms(fn, iters=5, warmup=2) for _ in range(3)]
            ms = float(np.median(samples["kernel"]))
            dev_ms, kernels = device_ms(kernel_path, iters=3, warmup=1)
            top = dict(sorted(kernels.items(), key=lambda kv: -kv[1])[:8])
            timings[bs] = dict(ms=ms, ms_samples=samples["kernel"],
                               pairs_per_s=bs / ms * 1e3,
                               plain_ms=float(np.median(samples["plain"])),
                               plain_ms_samples=samples["plain"],
                               device_busy_ms=dev_ms, idle_share=1.0 - dev_ms / ms,
                               top_kernels_ms=top)
        timings["host_ops_ms"] = host_profile(kernel_path)
    emit(phase="forward", params=n_params, build_s=build_s,
         launches_per_forward=counts, pooler_max_abs_err=err_pool,
         logits_max_abs_err=err_logits, limits=FORWARD_LIMITS,
         peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
         timings={str(k): v for k, v in timings.items()})
    return model, cfg, counts


def synthetic_vocab(size=30522):
    """A WordPiece vocabulary of bert-base-uncased's size: its specials at
    their ids, single characters, the test sentences' words, and filler."""
    vocab = ["[PAD]"] + [f"[unused{i}]" for i in range(99)]
    vocab += ["[UNK]", "[CLS]", "[SEP]", "[MASK]"]
    vocab += list("abcdefghijklmnopqrstuvwxyz0123456789!?.,'")
    vocab += ["##" + c for c in "abcdefghijklmnopqrstuvwxyz"]
    vocab += ("a the cat dog on couch sits next to window red blue small big "
              "photo of happy sad man woman street car").split()
    vocab = list(dict.fromkeys(vocab))
    vocab += [f"tok{i}" for i in range(size - len(vocab))]
    return {t: i for i, t in enumerate(vocab)}


def serving_phase(model):
    import torch

    from vault_tpu_torch.data.processor import VaultProcessor
    from vault_tpu_torch.serving import BatchingEngine, pad_rows
    from vault_tpu_torch.text.wordpiece import WordPieceTokenizer

    vocab = synthetic_vocab()
    tok = WordPieceTokenizer(vocab)
    # the server resizes on its model's device; the host processor is the
    # reference for the pixels and the yardstick for the time
    proc = VaultProcessor(tok, max_length=40, canvas="auto", device=model.device)
    host_proc = VaultProcessor(tok, max_length=40, canvas="auto")
    rng = np.random.default_rng(2)
    n_req = 16
    # landscape photos of assorted sizes: every batch lands on the
    # (384, 608) canvas, so each row can be held against a direct forward
    sizes = [(int(h), int(h * ar)) for h, ar in
             zip(rng.integers(300, 700, n_req), rng.uniform(1.2, 1.55, n_req))]
    images = [rng.integers(0, 256, (h, w, 3), dtype=np.uint8) for h, w in sizes]
    texts = [f"a {a} {b} sits on the couch next to photo{i}" for i, (a, b) in
             enumerate(zip(rng.choice(["red", "small", "happy"], n_req),
                           rng.choice(["cat", "dog", "man"], n_req)))]
    # one untimed pass first: the first resize and forward at a new shape
    # pay one-time set-up that a running server has behind it
    with torch.inference_mode():
        enc = proc(images[:8], texts[:8])
        model(enc)
    host_enc = host_proc(images[:8], texts[:8])
    pixel_err = float(np.abs(torch.as_tensor(enc["pixel_values"]).cpu().numpy()
                             - host_enc["pixel_values"]).max())
    if pixel_err > 2.0 / 255 + 1e-6:
        fail(f"pixel_values on the card vs the host differ by {pixel_err}")
    proc_ms = {}
    for name, p in (("card", proc), ("host", host_proc)):
        samples = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            p(images[:8], texts[:8])
            torch.cuda.synchronize()
            samples.append((time.perf_counter() - t0) * 1e3)
        proc_ms[name] = float(np.median(samples))
    engine = BatchingEngine(proc, model, max_batch=8, max_wait_ms=50.0)
    reset_counts()
    try:
        with concurrent.futures.ThreadPoolExecutor(n_req) as pool:
            futs = [pool.submit(engine.predict, im, t, 120.0)
                    for im, t in zip(images, texts)]
            results = [f.result() for f in futs]
        stats = engine.stats()
    finally:
        engine.close()
    counts = read_counts()
    if engine._worker.is_alive():
        fail("serving worker did not stop")
    per_batch = {"encoder_attention": 24, "mlp_block": 12, "mlp_postln": 12}
    if counts != {k: v * stats["batches_run"] for k, v in per_batch.items()}:
        fail(f"serving launches {counts} for {stats['batches_run']} batches")
    direct = []
    with torch.inference_mode():
        for lo in range(0, n_req, 8):
            enc = proc(images[lo:lo + 8], texts[lo:lo + 8])
            n = len(images[lo:lo + 8])
            enc = {k: pad_rows(v, 8) for k, v in enc.items()}
            if enc["pixel_values"].shape[-2:] != (384, 608):
                fail(f"canvas {enc['pixel_values'].shape[-2:]}, expected (384, 608)")
            direct.append(model(enc).float().cpu().numpy()[:n])
    direct = np.concatenate(direct)
    err = float(np.abs(np.stack(results) - direct).max())
    if not np.isfinite(err) or err > 1e-2:
        fail(f"engine rows vs direct forward: max abs diff {err}")
    if stats["requests_served"] != n_req:
        fail(f"engine served {stats['requests_served']} of {n_req}")
    emit(phase="serving", requests=n_req, max_abs_diff_vs_direct=err,
         results_shape=list(np.stack(results).shape), launches=counts,
         processor_ms_batch8=proc_ms, pixel_max_abs_diff_card_vs_host=pixel_err,
         stats=stats)


def main():
    try:
        import torch
    except ImportError:
        fail("PyTorch is not installed")
    if not torch.cuda.is_available():
        fail("no CUDA device: the chip smoke test runs only on the card")
    try:
        from vault_tpu_torch.ops import _build
    except ImportError as e:
        fail(f"the vault_tpu_torch package is not importable here ({e}); run "
             "from the root of the repository")
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    OUT_DIR.mkdir(parents=True, exist_ok=True)

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    emit(phase="card", nvidia_smi=smi, torch=torch.__version__,
         cuda=torch.version.cuda, device=torch.cuda.get_device_name(0))

    t0 = time.perf_counter()
    built = _build.build_all()
    build_s = time.perf_counter() - t0
    ptxas = {}
    for name, (_, log) in built.items():
        (OUT_DIR / f"nvcc_{name}.log").write_text(log)
        ptxas[name] = [ln.split("ptxas info    : ")[-1] for ln in log.splitlines()
                       if "Used" in ln or "spill" in ln]
    emit(phase="build", seconds=build_s,
         per_source={k: v[0] for k, v in built.items()}, ptxas=ptxas)

    gen = torch.Generator(device=dev).manual_seed(0)
    checks = {"encoder_attention": check_attention(gen, dev),
              "mlp_block": check_mlp(gen, dev, postln=False),
              "mlp_postln": check_mlp(gen, dev, postln=True)}

    model, _, counts = forward_phase(dev)
    serving_phase(model)

    sources = {"encoder_attention": ("vault_tpu_torch/csrc/attention.cu",
                                     "vault_tpu/ops/pallas_attention.py:92"),
               "mlp_block": ("vault_tpu_torch/csrc/mlp.cu",
                             "vault_tpu/ops/pallas_mlp.py:132"),
               "mlp_postln": ("vault_tpu_torch/csrc/mlp.cu",
                              "vault_tpu/ops/pallas_mlp.py:832")}
    kernels = []
    for name, rows in checks.items():
        timed = [r for r in rows if "ms" in r]
        # attention: the main path launches it equally often at L = 40 and
        # L = 256, so its numbers are the mean over those two shapes
        mean = lambda key: sum(r[key] for r in timed) / len(timed)
        entry = dict(name=name, route="cuda", source=sources[name][0],
                     replaces=sources[name][1], launches=counts[name],
                     max_abs_err=max(r["max_abs_err"] for r in timed),
                     ms=mean("ms"), wall_ms=mean("wall_ms"), plain_ms=mean("plain_ms"),
                     bound_ms=mean("bound_ms"),
                     bound_by=max(timed, key=lambda r: r["bound_ms"])["bound_by"],
                     library_ms=mean("library_ms"))
        if name == "encoder_attention":
            entry["replaces_also"] = ["vault_tpu/ops/pallas_attention.py:148",
                                      "vault_tpu/ops/pallas_attention.py:245"]
        kernels.append(entry)
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
