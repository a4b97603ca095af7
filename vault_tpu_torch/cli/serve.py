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

Not offered yet: the JAX script's ``--dp``, ``--tp`` and ``--pp`` (data-,
tensor- and pipeline-parallel serving) wait for the port's parallel modules.
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
    return args


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
    server = InferenceServer(processor, model, host=args.host, port=args.port,
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
