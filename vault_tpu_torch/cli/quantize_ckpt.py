"""Quantize a trained fp checkpoint into an int8 serving checkpoint, offline
(port of the JAX package's ``scripts/quantize_ckpt.py``).

    python -m vault_tpu_torch.cli.quantize_ckpt --ckpt .../model.npz \\
        --out .../model_w8a8.npz --mode w8a8 --n_classes 3

The output stores int8 weights and fp32 per-out-channel scales for every
encoder linear (``ops/quantize.py``) in the JAX package's npz layout, so
either package restores it; ``python -m vault_tpu_torch.cli.serve`` detects
the stored form from the npz keys, so serving skips the per-start
requantization.  The w8a8 MLP codes, which the port holds K-major, are
written in their logical (in, out) layout (``convert.params_to_jax``) and
laid K-major again on restore (``convert.params_from_jax``).  The
quantization runs on the card (``--device cuda``, the default: without a
card it raises); ``--device cpu`` runs it on the host, with the same codes.
"""

from __future__ import annotations

import argparse


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(
        prog="python -m vault_tpu_torch.cli.quantize_ckpt",
        description="Quantize a trained fp checkpoint (npz) into an int8 serving "
                    "checkpoint.")
    ap.add_argument("--vilt", default="dandelin/vilt-b32-mlm",
                    help="ViLT checkpoint directory or name: its config.json "
                         "gives the geometry (ViLT-B/32 without one)")
    ap.add_argument("--bert", default="bert-base-uncased",
                    help="language tower checkpoint directory or name, as --vilt")
    ap.add_argument("--ckpt", required=True,
                    help="trained {params,...} npz (training/checkpoint.py)")
    ap.add_argument("--out", required=True, help="output npz path")
    ap.add_argument("--mode", default="w8a8", choices=["w8", "w8a8"])
    ap.add_argument("--n_classes", type=int, default=3)
    ap.add_argument("--debug_tiny", action="store_true",
                    help="tiny model geometry (CI smoke; matches the serve CLI)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    return ap.parse_args(argv)


def main(argv=None) -> str:
    """Quantize and save; returns the line it prints."""
    import torch

    from vault_tpu_torch.cli import model_config, restore_params
    from vault_tpu_torch.convert import params_to_jax
    from vault_tpu_torch.models.vault import VaultForClassification, resolve_device
    from vault_tpu_torch.ops.quantize import quantize_model_params
    from vault_tpu_torch.training.checkpoint import save_checkpoint

    args = parse_args(argv)
    model = VaultForClassification(model_config(args), n_classes=args.n_classes,
                                   device=resolve_device(args.device))
    restore_params(model, args.ckpt)
    model.to(torch.bfloat16)
    quantize_model_params(model, mode=args.mode)
    save_checkpoint(args.out, {"params": params_to_jax(model.state_dict(), as_numpy=False)})
    n_int8 = sum(t.numel() for t in model.state_dict().values() if t.dtype == torch.int8)
    line = f"wrote {args.out} ({args.mode}; {n_int8 / 1e6:.1f}M int8 weights)"
    print(line)
    return line


if __name__ == "__main__":
    main()
