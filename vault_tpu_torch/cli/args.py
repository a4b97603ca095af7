"""Argparse composition for the experiment CLIs (port of the JAX package's
``experiments/utils.py``).

Every model, dataset and trainer contributes a dict of flags (name ->
argparse kwargs), and the subcommands compose them, as the reference does
(experiments/utils.py:5-36).  The flag names are the JAX package's.  The
mesh flags (``--num_data_shards`` above 1, ``--zero_opt`` and the
multi-host ``--coordinator_address``, ``--num_processes``, ``--process_id``)
wait for the port's parallel modules: :func:`refuse_unported` raises
``NotImplementedError`` naming each one that was set.  Every other flag of
the JAX package's trainer runs, ``--opt_state_dtype int8`` and
``--profile_dir`` included.
"""

from __future__ import annotations

import argparse
from typing import Dict


def add_arguments(parser: argparse.ArgumentParser, spec: Dict[str, dict]):
    for name, kwargs in spec.items():
        parser.add_argument(f"--{name}", **kwargs)


GENERAL_ARGS = dict(
    reps=dict(default=1, type=int, help="times to repeat experiment"),
    description=dict(type=str, help="description of experiment"),
    logging_level=dict(default="warning", type=str, help="logging severity"),
    logging_file=dict(type=str, help="log to this file instead of stderr"),
    experiment_root=dict(default="./experiment_logs", type=str,
                         help="where experiment logs are written"),
)

TRAINER_ARGS = dict(
    early_stopping_patience=dict(type=int, help="early stopping patience"),
    disable_tqdm=dict(action="store_true", help="disable tqdm progress bars"),
    device=dict(default=None, type=str,
                help="cuda (default: the card; raises without one), cuda:<n>, "
                     "or cpu, the only way onto the host"),
    max_num_workers=dict(default=0, type=int,
                         help="worker threads for image decode (reference "
                              "DataLoader num_workers)"),
    early_stopping_delta=dict(default=0.0, type=float,
                              help="min improvement to reset patience"),
    model_save=dict(action="store_true", help="whether to save model"),
    model_load_filename=dict(type=str, help="local checkpoint to load"),
    lr=dict(default=2e-5, type=float, help="learning rate"),
    adam_beta1=dict(default=0.9, type=float, help="Adam beta_1"),
    adam_beta2=dict(default=0.999, type=float, help="Adam beta_2"),
    adam_epsilon=dict(default=1e-8, type=float, help="Adam epsilon"),
    weight_decay=dict(default=0.0, type=float, help="AdamW weight decay"),
    correct_bias=dict(action="store_true", help="correct bias in AdamW"),
    train_batch_size=dict(default=32, type=int, help="train batch size"),
    eval_batch_size=dict(default=32, type=int, help="eval batch size"),
    eval_steps=dict(type=int, help="steps between dev evals (default: epoch)"),
    max_steps=dict(default=-1, type=int, help="max number of steps"),
    num_train_epochs=dict(default=10, type=int, help="training epochs"),
    warmup_ratio=dict(default=0.1, type=float, help="warmup fraction of steps"),
    num_data_shards=dict(type=int, help="data-parallel width (one device only: "
                                        "1 or unset)"),
    use_pallas=dict(default="auto", type=str, nargs="?", const="batched",
                    help="kernel selector: auto (default; the fused QKV "
                         "product and the MLP and attention kernels on the "
                         "card), false (plain PyTorch), or a '+'-combo like "
                         "fuseqkv+fusemlp+batched"),
    no_remat=dict(action="store_true",
                  help="disable encoder-layer rematerialization"),
    merge_to=dict(default=None, type=int,
                  help="trainable ToMe: merge ViLT patch tokens to this count "
                       "in every train/eval forward (ops/token_merge.py); "
                       "default off"),
    merge_at_layer=dict(default=0, type=int,
                        help="merge point: 0 = embeddings, k>0 = after k "
                             "encoder layers"),
    grad_accum_steps=dict(default=1, type=int,
                          help="micro-batches averaged per optimizer step"),
    compute_dtype=dict(default="bfloat16", choices=["float32", "bfloat16"],
                       type=str, help="activation/matmul dtype (fp32 master "
                       "weights either way)"),
    opt_state_dtype=dict(default="bfloat16",
                         choices=["float32", "bfloat16", "int8"], type=str,
                         help="AdamW m/v storage dtype (int8: blockwise codes "
                              "with an fp32 scale per 256 values, the JAX "
                              "package's blocks over stacked layers)"),
    grad_dtype=dict(default=None, choices=["float32", "bfloat16"], type=str,
                    help="grad buffer dtype between backward and optimizer"),
    rng_impl=dict(default="rbg", choices=["threefry2x32", "rbg"], type=str,
                  help="the JAX package's dropout generator kind; the port "
                       "has one torch.Generator kind and ignores it"),
    profile_dir=dict(default=None, type=str,
                     help="write a torch.profiler Chrome trace of the second "
                          "eval window here"),
    zero_opt=dict(action="store_true",
                  help="ZeRO-1 moment sharding (not ported yet: raises)"),
    seed=dict(default=0, type=int, help="base random seed"),
    checkpoint_dir=dict(default=None, type=str,
                        help="write {params, opt_state, step} checkpoints "
                             "here at every eval window"),
    resume=dict(action="store_true",
                help="resume mid-schedule from checkpoint_dir's last "
                     "checkpoint (restores params/opt_state/step)"),
    coordinator_address=dict(default=None, type=str,
                             help="multi-host coordinator (not ported yet: "
                                  "raises)"),
    num_processes=dict(default=None, type=int,
                       help="multi-host process count (not ported yet: raises)"),
    process_id=dict(default=None, type=int,
                    help="multi-host process index (not ported yet: raises)"),
)


def refuse_unported(args) -> None:
    """Raise ``NotImplementedError`` naming every mesh flag that was set
    (they wait for the port's parallel modules)."""
    set_flags = [name for name, on in (
        ("--num_data_shards", (args.num_data_shards or 1) > 1),
        ("--zero_opt", args.zero_opt),
        ("--coordinator_address", args.coordinator_address is not None),
        ("--num_processes", args.num_processes is not None),
        ("--process_id", args.process_id is not None)) if on]
    if set_flags:
        raise NotImplementedError(
            f"{', '.join(set_flags)}: multi-device training is not ported yet "
            "(one device only)")


def trainer_args_from_namespace(args, **overrides):
    from vault_tpu_torch.training.trainer import TrainArgs

    kw = dict(
        lr=args.lr, adam_beta1=args.adam_beta1, adam_beta2=args.adam_beta2,
        adam_epsilon=args.adam_epsilon, weight_decay=args.weight_decay,
        correct_bias=args.correct_bias,
        train_batch_size=args.train_batch_size,
        eval_batch_size=args.eval_batch_size,
        num_train_epochs=args.num_train_epochs,
        warmup_ratio=args.warmup_ratio, eval_steps=args.eval_steps,
        max_steps=args.max_steps,
        early_stopping_patience=args.early_stopping_patience,
        early_stopping_delta=args.early_stopping_delta,
        model_save=args.model_save,
        model_load_filename=args.model_load_filename,
        num_data_shards=args.num_data_shards, use_pallas=args.use_pallas,
        remat=not args.no_remat, compute_dtype=args.compute_dtype,
        merge_to=args.merge_to, merge_at_layer=args.merge_at_layer,
        opt_state_dtype=args.opt_state_dtype, grad_dtype=args.grad_dtype,
        zero_opt=args.zero_opt,
        grad_accum_steps=args.grad_accum_steps, seed=args.seed,
        rng_impl=args.rng_impl, disable_tqdm=args.disable_tqdm,
        profile_dir=args.profile_dir,
        checkpoint_dir=args.checkpoint_dir, resume=args.resume,
    )
    kw.update(overrides)
    return TrainArgs(**kw)
