"""VAuLT fine-tuning CLI (port of the JAX package's ``experiments/clsf_vault.py``).

    python -m vault_tpu_torch.cli.clsf_vault Twitter201X --dir DATA/twitter2015 \\
        --train_split train --dev_split dev --test_split test \\
        --vilt_model_name_or_path CKPTS/vilt-b32-mlm \\
        --bert_model_name_or_path CKPTS/bert-base-uncased -r 5
    python -m vault_tpu_torch.cli.clsf_vault MVSA --root_dir DATA/MVSA_Single --preprocessed
    python -m vault_tpu_torch.cli.clsf_vault Bloomberg --root_dir DATA/bloomberg

A subcommand per task (Twitter201X, Bloomberg, MVSA) composes the model,
dataset and trainer flags of the JAX script; each rep builds a fresh
``ExperimentHandler`` named ``VaultTMSC<task>`` and a fresh model and runs
the task's trainer (reference :52-70, :179-252).  The backbone comes from
local HF checkpoint directories (``models/pretrained.py``
``load_vault_backbone``; a name that is not a directory is drawn at random,
with a warning), the head is drawn from ``--seed`` + rep.  Training runs on
the card (``--device`` unset or ``cuda``; without a card it raises);
``--device cpu`` is the only way onto the host, where the kernels' plain
versions run.  ``--debug_tiny`` takes the JAX script's tiny geometry and a
64x64 canvas.  Twitter201X links its targets to entities with
``--entity_cache`` (and ``--wiki_store`` to build a missing cache,
``text/entity_linking.py``): each linked target carries its entity token,
and each rep's active text tower grows a max-pooled row per entity.

The mesh flags run: ``--coordinator_address`` joins a ``torch.distributed``
group (``cli/args.py`` ``apply_device_arg``), over which the trainer runs
data-parallel (``--num_data_shards``, ``--zero_opt``).  :func:`main` takes an argument list
and returns the trainers it ran.
"""

from __future__ import annotations

import argparse
import dataclasses
import logging
import os
from typing import List, Optional, Sequence

from vault_tpu_torch.cli.args import (
    GENERAL_ARGS,
    TRAINER_ARGS,
    add_arguments,
    apply_device_arg,
    trainer_args_from_namespace,
)

VAULT_MODEL_ARGS = dict(
    vilt_model_name_or_path=dict(default="dandelin/vilt-b32-mlm", type=str,
                                 help="ViLT checkpoint (local HF dir or name)"),
    bert_model_name_or_path=dict(type=str, help="LM tower checkpoint, if any"),
    vilt_dropout_prob=dict(default=0.1, type=float,
                           help="classifier-head dropout (the reference flag "
                                "of the same name; its ViLT-internals "
                                "override was a no-op, so 0.1 only ever "
                                "reached the head)"),
    vilt_internal_dropout_prob=dict(default=0.0, type=float,
                                    help="hidden/attention dropout inside the "
                                         "ViLT encoder layers (the reference's "
                                         "intended override; 0.0, its "
                                         "effective value, by default)"),
    freeze_lm=dict(action="store_true", help="freeze the language tower"),
    use_vilt_position_embeddings=dict(action="store_true",
                                      help="keep ViLT's text position embeds"),
    add_placeholder_token=dict(action="store_true",
                               help="add $T$ to the tokenizer"),
    max_length=dict(default=40, type=int, help="max text tokens (<=40)"),
    image_augmentation=dict(action="store_true",
                            help="random-crop augmentation at fetch"),
    orientation_buckets=dict(action="store_true",
                             help="draw canvas-homogeneous batches, so the auto "
                                  "canvas gives orientation-pure batches the "
                                  "(384, 608) geometry (shuffle stays uniform "
                                  "within buckets)"),
    debug_tiny=dict(action="store_true",
                    help="debug: tiny model geometry + tiny image canvas"),
    entity_cache=dict(type=str,
                      help="JSON entity cache (Twitter201X: target -> [entity, "
                           "description]); adds entity tokens to the tokenizer, "
                           "their embeddings max-pooled"),
    wiki_store=dict(type=str,
                    help="offline alias-store file to link with when "
                         "--entity_cache does not exist yet (Twitter201X)"),
    entity_threshold=dict(default=0.0, type=float,
                          help="linker confidence threshold"),
    canvas=dict(default="default", type=str,
                help="pixel canvas: 'default' (the processor's: 'auto'), 'auto' "
                     "({384,608}-bucketed per batch), or 'HxW'"),
)

TASK_ARGS = {
    "Twitter201X": dict(
        dir=dict(required=True, type=str, help="tweet dataset directory"),
        image_dir=dict(type=str, help="image directory (default <dir>_images)"),
        train_split=dict(required=True, type=str, nargs="+"),
        dev_split=dict(type=str, nargs="+"),
        test_split=dict(type=str, nargs="+"),
        preprocess_on_fetch=dict(
            action="store_true",
            help="re-encode train images on fetch, aka augmentation "
                 "(equivalent to --image_augmentation)"),
    ),
    "Bloomberg": dict(
        root_dir=dict(required=True, type=str, help="bloomberg dataset root"),
        tasks=dict(default=["text_is_represented"], type=str, nargs="+"),
        dev_size=dict(default=564, type=int,
                      help="dev split size (reference default 564)"),
        test_size=dict(default=704, type=int,
                       help="test split size (reference default 704)"),
        train_split=dict(default=["train"], type=str, nargs="+",
                         help="train split(s); the published recipe merges "
                              "train+dev"),
        val_split=dict(type=str, nargs="+",
                       help="development split(s); omit for no dev eval"),
        test_split=dict(type=str, nargs="+"),
    ),
    "MVSA": dict(
        root_dir=dict(required=True, type=str, help="MVSA dataset root"),
        preprocessed=dict(action="store_true",
                          help="literature label preprocessing"),
        train_split=dict(default=["train"], type=str, nargs="+",
                         help="train split(s); the published recipe merges "
                              "train+dev"),
        val_split=dict(type=str, nargs="+",
                       help="development split(s); omit for no dev eval"),
        test_split=dict(type=str, nargs="+"),
    ),
}


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(
        prog="python -m vault_tpu_torch.cli.clsf_vault",
        description="Fine-tune VAuLT on TMSC (Twitter201X), Bloomberg or MVSA.")
    sp = parser.add_subparsers(dest="task", required=True)
    for task, spec in TASK_ARGS.items():
        p = sp.add_parser(task)
        add_arguments(p, VAULT_MODEL_ARGS)
        add_arguments(p, spec)
        add_arguments(p, TRAINER_ARGS)
        add_arguments(p, GENERAL_ARGS)
        p.add_argument("-r", "--reps_short", type=int, dest="reps_short",
                       help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    if getattr(args, "reps_short", None):
        args.reps = args.reps_short
    return args


def model_config(args):
    """The VaultConfig of the run: ``--debug_tiny``'s geometry, else the
    checkpoints' (their presets where a name is not a directory), with the
    ViLT-internal dropout of ``--vilt_internal_dropout_prob``."""
    from vault_tpu_torch.config import (
        VaultConfig,
        tiny_text_config,
        tiny_vilt_config,
    )
    from vault_tpu_torch.models.pretrained import (
        text_config_from_name,
        vilt_config_from_name,
    )

    bert_name = args.bert_model_name_or_path
    if args.debug_tiny:
        vilt_cfg = tiny_vilt_config(image_size=64, patch_size=16,
                                    num_patch_tokens=16, vocab_size=30522)
        text_cfg = tiny_text_config(vocab_size=30522) if bert_name else None
    else:
        vilt_cfg = vilt_config_from_name(args.vilt_model_name_or_path)
        text_cfg = text_config_from_name(bert_name) if bert_name else None
    vilt_cfg = dataclasses.replace(
        vilt_cfg, hidden_dropout_prob=args.vilt_internal_dropout_prob,
        attention_probs_dropout_prob=args.vilt_internal_dropout_prob)
    return VaultConfig(vilt=vilt_cfg, text_tower=text_cfg,
                       use_vilt_position_embeddings=args.use_vilt_position_embeddings,
                       freeze_lm=args.freeze_lm)


def build_params(args, cfg, n_classes: int, seed: int):
    """The state dict of one rep: the checkpoints' backbone (random where a
    name is not a directory) and a classifier head, drawn from ``seed``."""
    import torch

    from vault_tpu_torch.models.pretrained import load_vault_backbone
    from vault_tpu_torch.models.vault import init_classifier_head

    gen = torch.Generator().manual_seed(seed)
    params = load_vault_backbone(cfg, gen, args.vilt_model_name_or_path,
                                 args.bert_model_name_or_path)
    head = init_classifier_head(gen, cfg.vilt.hidden_size, n_classes)
    params.update({f"head.{k}": v for k, v in head.state_dict().items()})
    return params


def _processor(args, tokenizer):
    from vault_tpu_torch.data.processor import VaultProcessor

    kw = {}
    if args.debug_tiny:  # the tiny geometry's canvas wins
        kw["canvas"] = (64, 64)
    elif args.canvas == "auto":
        kw["canvas"] = "auto"
    elif args.canvas != "default":
        h, w = args.canvas.lower().split("x")
        kw["canvas"] = (int(h), int(w))
    return VaultProcessor(tokenizer, max_length=args.max_length, **kw)


def _datasets(args, processor, text_pre, entity_map=None):
    """(train, dev, test, n_classes, trainer class, dataset label,
    experiment name) of the task.  ``entity_map``: Twitter201X's target ->
    entity token."""
    from vault_tpu_torch.data.datasets import (
        Twitter201XDataset,
        VisionLanguageDataset,
        load_bloomberg,
        load_mvsa,
    )
    from vault_tpu_torch.training.task_trainers import (
        BloombergTrainer,
        MvsaTrainer,
        TmscTrainer,
    )

    if args.task == "Twitter201X":
        def mk(kinds, augment=False, label_mapping=None):
            return Twitter201XDataset(
                args.dir, kinds, processor, image_dir=args.image_dir,
                max_length=args.max_length, augment=augment,
                num_workers=args.max_num_workers, entity_map=entity_map or None,
                orientation_buckets=args.orientation_buckets,
                label_mapping=label_mapping)

        train = mk(args.train_split,
                   augment=args.image_augmentation or args.preprocess_on_fetch)
        # dev and test reuse the train mapping: identical when every split
        # carries every class, and safe when a small split misses one
        lm = train.label_mapping
        dev = mk(args.dev_split, label_mapping=lm) if args.dev_split else None
        test = mk(args.test_split, label_mapping=lm) if args.test_split else None
        splits = list(args.train_split) + list(args.dev_split or [])
        label = os.path.basename(os.path.normpath(args.dir)) + "(" + ";".join(splits) + ")"
        return (train, dev, test, len(lm), TmscTrainer, label,
                "VaultTMSCTwitter201X")

    if args.task == "Bloomberg":
        def load(splits):
            ids, texts, fns, labels, _ = load_bloomberg(
                args.root_dir, splits, args.tasks, dev_size=args.dev_size,
                test_size=args.test_size)
            return ids, texts, fns, labels, f"bloomberg-twitter-text-image({';'.join(splits)})"
        n_classes, trainer_cls, exp_name = len(args.tasks), BloombergTrainer, "VaultTMSCBloomberg"
    else:  # MVSA
        def load(splits):
            ids, texts, fns, labels = load_mvsa(args.root_dir, splits, args.preprocessed)
            return (ids, texts, fns, labels,
                    f"{os.path.basename(args.root_dir)}({';'.join(splits)})")
        n_classes = 3 if args.preprocessed else 6
        trainer_cls, exp_name = MvsaTrainer, "VaultTMSCMVSA"

    def mk(splits, augment=False):
        ids, texts, fns, labels, name = load(splits)
        return VisionLanguageDataset(
            ids, texts, fns, labels, processor, name=name,
            max_length=args.max_length, text_preprocessor=text_pre,
            augment=augment, num_workers=args.max_num_workers,
            orientation_buckets=args.orientation_buckets)

    train = mk(args.train_split, augment=args.image_augmentation)
    dev = mk(args.val_split) if args.val_split else None
    test = mk(args.test_split) if args.test_split else None
    return train, dev, test, n_classes, trainer_cls, train.name, exp_name


def main(argv: Optional[Sequence[str]] = None) -> List:
    """Run the experiment of ``argv`` (``sys.argv[1:]`` when None); returns
    the trainer of each rep."""
    import torch

    from vault_tpu_torch.models.pretrained import build_tokenizer
    from vault_tpu_torch.models.vault import resize_token_embeddings, resolve_device
    from vault_tpu_torch.text.entity_linking import integrate_entities_into_vault
    from vault_tpu_torch.text.preprocess import demojizer_selector, twitter_preprocessor
    from vault_tpu_torch.training.experiment import ExperimentHandler
    from vault_tpu_torch.training.trainer import classifier_apply_fn

    args = parse_args(argv)
    apply_device_arg(args)
    device = resolve_device(args.device)
    logging.basicConfig(level=args.logging_level.upper(), filename=args.logging_file)

    cfg = model_config(args)
    bert_name = args.bert_model_name_or_path
    tokenizer = build_tokenizer(bert_name or args.vilt_model_name_or_path,
                                args.max_length)
    processor = _processor(args, tokenizer)
    # the reference recipe's text preprocessing (twitter preprocessor + the
    # LM's demojizer) for the VL datasets; normpath first, or a trailing
    # slash would select the identity demojizer
    demojizer = demojizer_selector(
        os.path.basename(os.path.normpath(bert_name)) if bert_name else "")
    pre = twitter_preprocessor()

    def text_pre(t):
        return pre(demojizer(t))

    # entities resolve before the datasets, so their tokens reach the
    # encoded text (the reference appends "/[entity]" to each linked target,
    # vault/tmsc_utils/dataset.py:260-283)
    entity_map, entity_descriptions = {}, []
    if args.task == "Twitter201X":
        from vault_tpu_torch.data.datasets import read_twitter201x
        from vault_tpu_torch.text.entity_linking import resolve_entities_for_cli

        def read_targets():
            kinds = (list(args.train_split) + list(args.dev_split or [])
                     + list(args.test_split or []))
            return [e.target for e in read_twitter201x(args.dir, kinds)]

        entity_map, entity_descriptions = resolve_entities_for_cli(
            args.entity_cache, args.wiki_store, args.entity_threshold,
            tokenizer, read_targets)
    if args.add_placeholder_token and hasattr(tokenizer, "add_tokens"):
        # after the entity tokens: the rows appended per rep (entity rows,
        # then the random $T$ row) follow the token ids
        tokenizer.add_tokens(["$T$"])
    train_ds, dev_ds, test_ds, n_classes, trainer_cls, dataset_label, exp_name = \
        _datasets(args, processor, text_pre, entity_map)
    targs = trainer_args_from_namespace(args)

    trainers = []
    for rep in range(args.reps):
        handler = ExperimentHandler(args.experiment_root, exp_name)
        handler.set_params({
            "bert_model": bert_name or "None",
            "dataset": dataset_label,
            "vilt_model": os.path.basename(args.vilt_model_name_or_path),
            "freeze_lm": args.freeze_lm,
            "lr": args.lr,
            "train_batch_size": args.train_batch_size,
            "num_train_epochs": args.num_train_epochs,
            "max_length": args.max_length,
        })
        if args.description:
            handler.set_param("description", args.description, disabled=True)
        handler.set_name_params(["bert_model", "dataset", "vilt_model", "freeze_lm"])

        params = build_params(args, cfg, n_classes, args.seed + rep)
        run_cfg = cfg
        if entity_descriptions:
            params, run_cfg = integrate_entities_into_vault(
                params, run_cfg, entity_descriptions, tokenizer)
        if args.add_placeholder_token and hasattr(tokenizer, "__len__"):
            params, run_cfg = resize_token_embeddings(
                params, run_cfg, len(tokenizer),
                torch.Generator().manual_seed(args.seed + rep + 11))
        kw = {"preprocessed": args.preprocessed} if args.task == "MVSA" else {}
        trainer = trainer_cls(
            classifier_apply_fn(run_cfg, targs, head_dropout=args.vilt_dropout_prob),
            params, targs, train_ds, dev_dataset=dev_ds, test_dataset=test_ds,
            exp_handler=handler, device=device, **kw)
        trainer.train()
        trainers.append(trainer)
    return trainers


if __name__ == "__main__":
    main()
