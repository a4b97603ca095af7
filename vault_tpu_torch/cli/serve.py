"""Serve a fine-tuned VAuLT classifier over HTTP with micro-batching (port of
the JAX package's ``scripts/serve.py``).

    python -m vault_tpu_torch.cli.serve --vilt /ckpts/vilt-b32-mlm \\
        --bert /ckpts/bert-base-uncased --ckpt .../model.npz --n_classes 3 \\
        --port 8000

POST /predict {"text": "...", "image_b64": "<png/jpeg base64>"}
  -> {"output": [logit, ...]}
GET  /healthz -> {"ok": true, batching + latency stats}
GET  /metrics -> Prometheus text (request p50/p99, queue depth, counters)

Weights: the ``params`` of ``--ckpt`` when it is given, in their stored
form (fp, or pre-quantized w8 / w8a8, detected from the npz keys); without
it, the backbone of the ``--vilt`` and ``--bert`` checkpoint directories
(``models/pretrained.py`` ``load_vault_backbone``: a name that is not a
directory is drawn at random, with a warning) and a seeded random head.
``--vilt`` and ``--bert`` also give the geometry (their ``config.json``) and
the tokenizer (``build_tokenizer``: WordPiece, BERTweet's fastBPE, byte-level
BPE).  An fp model is cast to bf16, then quantized with ``--quantize``; the
kernel selector is ``serving.serving_impl``'s.  Requests are padded to
``--max_batch``, so the card sees one batch shape.  The forward runs on the
card (``--device cuda``, the default: without a card it raises); ``--device
cpu`` runs the kernels' plain versions.

Several devices, in this one process (``serving.py``): ``--dp N`` splits
each padded batch over N devices, each running the single-device forward
with its kernels; ``--tp N`` runs the Megatron-sharded layers over N
devices (the products in plain PyTorch, the attention kernel on each
device's heads), composing with ``--quantize``; both together form a dp x
tp mesh; ``--pp`` runs the 2-stage pipeline (``parallel/pipeline.py``).
The devices are ``cuda:0`` .. ``cuda:<n-1>`` (fewer cards than asked
raises), or the host named n times with ``--device cpu``.
"""

from __future__ import annotations

import argparse
import sys
import warnings


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(
        prog="python -m vault_tpu_torch.cli.serve",
        description="Serve a fine-tuned VAuLT classifier over HTTP with "
                    "micro-batching.")
    ap.add_argument("--vilt", default="dandelin/vilt-b32-mlm",
                    help="ViLT checkpoint directory (HF layout) or name")
    ap.add_argument("--bert", default="bert-base-uncased",
                    help="language tower checkpoint directory (BERT or BERTweet, "
                         "with its tokenizer files) or name")
    ap.add_argument("--ckpt", help="trained {params,...} npz (training/checkpoint.py, "
                                   "or the quantize_ckpt CLI's output); the "
                                   "checkpoint directories' backbone when omitted")
    ap.add_argument("--n_classes", type=int, default=3)
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8000,
                    help="0 picks a free port")
    ap.add_argument("--max_batch", type=int, default=8)
    ap.add_argument("--max_wait_ms", type=float, default=5.0)
    ap.add_argument("--int8", action="store_true", help="alias for --quantize w8")
    ap.add_argument("--quantize", default=None, choices=["w8", "w8a8"],
                    help="int8 serving: w8 = int8 weights only (bf16 products), "
                         "w8a8 = activations quantized per row too, so the "
                         "products run in int8 (ops/quantize.py)")
    ap.add_argument("--dp", type=int, default=1,
                    help="data-parallel serving over N devices: the padded "
                         "batch is split over them and each shard runs the "
                         "single-device forward, kernels included "
                         "(serving.dp_sharded_forward; --max_batch must "
                         "divide by N).  Composes with --tp as an N x M mesh")
    ap.add_argument("--tp", type=int, default=1,
                    help="tensor-parallel serving over N devices: the encoder "
                         "layers are Megatron-sharded (parallel/sharding.py: "
                         "QKV/MLP-in column, attn-out/MLP-out row) and the "
                         "row products are summed over the devices "
                         "(serving.tp_forward).  Composes with --quantize "
                         "(int8 codes and scales shard the same way).  The "
                         "products run in plain PyTorch, the attention "
                         "kernel on each device's heads")
    ap.add_argument("--pp", action="store_true",
                    help="2-stage pipelined serving (the reference's "
                         "PipelineVaultMixin): LM tower on the first card, "
                         "ViLT and the head on the second (the first again on "
                         "a one-card machine, on a second stream), "
                         "micro-batches overlapped (parallel/pipeline.py).  "
                         "Not with --tp/--dp or --merge_to")
    ap.add_argument("--merge_to", type=int, default=None,
                    help="ToMe patch-token merging (ops/token_merge.py): merge "
                         "the patch tokens down to N before the co-encoder (87 "
                         "makes the joint sequence 128)")
    ap.add_argument("--merge_at_layer", type=int, default=0,
                    help="where to merge: 0 (default) merges the embeddings "
                         "before the encoder; k > 0 after k encoder layers")
    ap.add_argument("--force", action="store_true",
                    help="serve a measured-bad lever composition anyway "
                         "(serving.check_serving_composition; e.g. int8 + "
                         "merge at layer 0 on a wide head flipped 12.5-16.7%% "
                         "of VQA decisions in the JAX package's measurement)")
    ap.add_argument("--canvas", default="608x608",
                    help="fixed HxW canvas (default 608x608: one batch shape "
                         "covering both orientations), or 'auto' (a canvas "
                         "bucket per batch)")
    ap.add_argument("--debug_tiny", action="store_true",
                    help="tiny model geometry + 64x64 canvas (CI smoke; the "
                         "same geometry as the JAX package's)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    if args.int8 and args.quantize and args.quantize != "w8":
        ap.error(f"--int8 (alias for --quantize w8) conflicts with "
                 f"--quantize {args.quantize}")
    if args.dp < 1 or args.tp < 1:
        ap.error("--dp and --tp must be at least 1")
    if args.dp > 1 and args.max_batch % args.dp:
        ap.error(f"--max_batch {args.max_batch} must divide by --dp {args.dp}")
    if args.pp and (args.tp > 1 or args.dp > 1):
        ap.error("--pp is mutually exclusive with --tp/--dp")
    if args.pp and args.merge_to is not None:
        ap.error("--merge_to is not supported with --pp (the pipeline "
                 "stages run without the merge seam)")
    return args


def serving_devices(device, n: int):
    """``n`` devices for ``--dp`` x ``--tp``: ``cuda:0`` .. ``cuda:<n-1>``
    (raising when fewer cards are visible, with no fallback), or the host
    named ``n`` times."""
    import torch

    device = torch.device(device)
    if device.type != "cuda":
        return [device] * n
    have = torch.cuda.device_count()
    if have < n:
        raise RuntimeError(f"--dp x --tp asks for {n} devices; {have} card(s) "
                           "visible")
    return [torch.device("cuda", i) for i in range(n)]


def parallel_forward(model, args, device):
    """The served callable for ``--dp``/``--tp``/``--pp``: ``model`` itself
    when none is set."""
    from vault_tpu_torch.convert import param_tree
    from vault_tpu_torch.models.vault import classifier_head_apply, vault_for_classification

    if args.pp:
        from vault_tpu_torch.parallel.pipeline import PipelineVault

        pipe = PipelineVault(model.state_dict(), model.cfg, lm_device=device,
                             inner_batch_size=max(1, args.max_batch // 2),
                             use_pallas=model.use_pallas)
        head = param_tree({k[5:]: v.to(pipe.vilt_device)
                           for k, v in model.state_dict().items()
                           if k.startswith("head.")})

        def pp_forward(batch):
            pooled = pipe(**{k: v for k, v in batch.items()
                             if k in ("input_ids", "attention_mask", "token_type_ids",
                                      "pixel_values", "pixel_mask")}).pooler_output
            return classifier_head_apply(head, pooled, 0.0, True)

        return pp_forward
    if args.dp == 1 and args.tp == 1:
        return model
    cfg, use_pallas = model.cfg, model.use_pallas

    def apply_fn(params, batch):
        return vault_for_classification(
            param_tree(params), cfg, batch, head_dropout=0.0, deterministic=True,
            use_pallas=use_pallas, merge_patches_to=model.merge_to,
            merge_at_layer=model.merge_at_layer)

    devices = serving_devices(device, args.dp * args.tp)
    if args.tp == 1:
        from vault_tpu_torch.serving import dp_sharded_forward

        return dp_sharded_forward(apply_fn, devices, model.state_dict())
    from vault_tpu_torch.serving import mesh_forward

    return mesh_forward(apply_fn, devices, model.state_dict(), dp=args.dp, tp=args.tp)


def stored_mode(path: str):
    """The quantization a checkpoint stores, from its npz keys: "w8a8"
    (``*/w_q8``), "w8" (``*/w_q``) or None (fp)."""
    import numpy as np

    with np.load(path) as z:
        keys = [k.rsplit("::", 1)[0] for k in z.files]
    return ("w8a8" if any(k.endswith("/w_q8") for k in keys)
            else "w8" if any(k.endswith("/w_q") for k in keys) else None)


def build(args: argparse.Namespace):
    """The served model, its processor and the (not yet started) server,
    from parsed arguments.  Exits with code 2 on a mode that conflicts with
    the checkpoint and on a refused composition (unless ``--force``)."""
    import torch

    from vault_tpu_torch.cli import model_config, restore_params
    from vault_tpu_torch.data.processor import VaultProcessor
    from vault_tpu_torch.models.pretrained import build_tokenizer, load_vault_backbone
    from vault_tpu_torch.models.vault import VaultForClassification, resolve_device
    from vault_tpu_torch.serving import (
        InferenceServer,
        check_serving_composition,
        serving_impl,
    )

    device = resolve_device(args.device)
    cfg = model_config(args)
    canvas = "64x64" if args.debug_tiny else args.canvas
    mode = args.quantize or ("w8" if args.int8 else None)
    # pre-quantized checkpoints (quantize once offline, serve many times):
    # the stored form, from the npz keys, sets the restore target
    ckpt_mode, path = None, None
    if args.ckpt:
        path = args.ckpt if args.ckpt.endswith(".npz") else args.ckpt + ".npz"
        ckpt_mode = stored_mode(path)
        if ckpt_mode and mode and mode != ckpt_mode:
            print(f"serve: error: --quantize {mode} conflicts with the checkpoint, "
                  f"which stores {ckpt_mode} params", file=sys.stderr)
            raise SystemExit(2)
        mode = mode or ckpt_mode

    # the measured-bad composition guard: refuse red combinations unless
    # --force; always print the warnings
    refusals, comp_warnings = check_serving_composition(
        args.n_classes, mode, args.merge_to, args.merge_at_layer)
    for w in comp_warnings:
        print(f"WARNING: {w}", file=sys.stderr)
    if refusals and not args.force:
        for r in refusals:
            print(f"REFUSING: {r}", file=sys.stderr)
        raise SystemExit(2)
    for r in refusals:
        print(f"WARNING (forced): {r}", file=sys.stderr)

    model = VaultForClassification(cfg, n_classes=args.n_classes, device=device,
                                   merge_to=args.merge_to,
                                   merge_at_layer=args.merge_at_layer)

    def quantize(m):
        with warnings.catch_warnings():  # the guard's messages are printed above
            warnings.simplefilter("ignore")
            model.quantize(m, force=True)

    if not args.ckpt:
        backbone = load_vault_backbone(cfg, torch.Generator().manual_seed(0),
                                       args.vilt, args.bert)
        model.load_state_dict({**model.state_dict(), **backbone})
    if ckpt_mode:
        model.to(torch.bfloat16)
        quantize(ckpt_mode)
        restore_params(model, path)
    else:
        if path:
            restore_params(model, path)
        model.to(torch.bfloat16)
        if mode:
            quantize(mode)
    model.use_pallas = serving_impl(mode, device)

    canvas = canvas if canvas == "auto" else tuple(
        int(v) for v in canvas.lower().split("x"))
    processor = VaultProcessor(build_tokenizer(args.bert), canvas=canvas, device=device)
    server = InferenceServer(processor, parallel_forward(model, args, device),
                             host=args.host, port=args.port,
                             max_batch=args.max_batch, max_wait_ms=args.max_wait_ms)
    return model, processor, server


def warm_up(server) -> None:
    """One request through the engine before any traffic: the first batch
    builds the kernels and sets up the card's libraries for its shapes."""
    import numpy as np

    server.engine.predict(np.full((64, 64, 3), 127, np.uint8), "warmup", timeout=900.0)


def serve(server, args: argparse.Namespace) -> None:
    """Warm up, then serve until interrupted."""
    print("warming up (the first batch builds the kernels)...", flush=True)
    warm_up(server)
    server.start()
    print(f"serving on http://{args.host}:{server.port}  "
          f"(max_batch={args.max_batch})", flush=True)
    try:
        server._thread.join()
    except KeyboardInterrupt:
        pass
    finally:
        server.close()


def main(argv=None) -> None:
    args = parse_args(argv)
    _, _, server = build(args)
    serve(server, args)


if __name__ == "__main__":
    main()
