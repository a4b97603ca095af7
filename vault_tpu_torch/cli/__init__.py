"""Command-line entry points of the port (``python -m vault_tpu_torch.cli.<name>``):
``quantize_ckpt`` and ``serve``, counterparts of the JAX package's
``scripts/quantize_ckpt.py`` and ``scripts/serve.py``, and what they share;
the experiment CLIs ``clsf_vault`` and ``tmsc_tombert``; the bench CLIs
``bench``, ``train_bench``, ``perf_sweep`` and ``ablate_train``
(counterparts of ``bench.py`` and ``scripts/{train_bench,perf_sweep,
ablate_train}.py``; what they share is in ``cli/_bench.py``)."""

from __future__ import annotations


def model_config(args):
    """The VaultConfig both CLIs build: ``--debug_tiny``'s, else the
    geometry of the ``--vilt`` and ``--bert`` checkpoints (their presets
    where a name is not a directory)."""
    from vault_tpu_torch.config import VaultConfig, debug_tiny_vault_config
    from vault_tpu_torch.models.pretrained import (
        text_config_from_name,
        vilt_config_from_name,
    )

    if args.debug_tiny:
        return debug_tiny_vault_config()
    return VaultConfig(vilt=vilt_config_from_name(args.vilt),
                       text_tower=text_config_from_name(args.bert))


def restore_params(model, path: str) -> None:
    """Load the ``params`` of the npz at ``path`` (the JAX package's layout,
    ``training/checkpoint.py``) into ``model`` in place, restored into the
    model's own structure and types: a float leaf saved in another float
    type is cast, with a warning; the w8a8 MLP codes are laid K-major again
    (``convert.params_from_jax``)."""
    from vault_tpu_torch.convert import params_from_jax, params_to_jax
    from vault_tpu_torch.training.checkpoint import restore_checkpoint

    target = {"params": params_to_jax(model.state_dict(), as_numpy=False)}
    params = restore_checkpoint(path, target)["params"]
    model.load_state_dict(params_from_jax(params, model.cfg))
