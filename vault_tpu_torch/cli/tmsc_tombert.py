"""TomBERT / TomViLT fine-tuning CLI on Twitter-201X (port of the JAX
package's ``experiments/tmsc_tombert.py``).

    python -m vault_tpu_torch.cli.tmsc_tombert TomBERT --dir DATA/twitter2015 \\
        --train_split train --dev_split dev --test_split test \\
        --model_name_or_path CKPTS/bert-base-uncased \\
        --resnet_weights CKPTS/resnet101.pth -r 5
    python -m vault_tpu_torch.cli.tmsc_tombert TomViLT --dir ... --use_tweet_bert \\
        --vilt_model_name_or_path CKPTS/vilt-b32-mlm

The JAX script's flags (model, dataset, entity linking, trainer, general).
Each rep builds a fresh ``ExperimentHandler`` named ``TomBERTTMSC`` or
``TomViLTTMSC``, fresh weights and a ``TomBertTrainer``, whose frozen-ResNet
cache is computed once per split before training.  The weights: the
reference's surgery from local HF checkpoint directories (TomBERT: one BERT
seeds the tweet, target, multimodal and cross stacks; TomViLT: ViLT and BERT
into VAuLT, BERT into the target tower), the ResNet from a torchvision
``.pth`` (``--resnet_weights``), the rest drawn from ``--seed`` + rep.
Linked entities and ``$T$`` grow the text towers' word tables.  Training
runs on the card (``--device`` unset or ``cuda``; without a card it
raises); ``--device cpu`` is the only way onto the host.  ``--debug_tiny``
takes tiny towers, ResNet-18 and a 64-pixel crop.  ``--merge_to`` is refused,
as in the JAX script; the mesh flags run as in ``cli/clsf_vault.py``
(``cli/args.py`` ``apply_device_arg``).  :func:`main` takes an argument list
and returns the trainers it ran.
"""

from __future__ import annotations

import argparse
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

MODEL_ARGS = dict(
    model_name_or_path=dict(default="bert-base-uncased", type=str,
                            help="BERT checkpoint for the text stacks"),
    tweet_model_name_or_path=dict(type=str,
                                  help="TomBERT: separate checkpoint for the "
                                       "tweet tower (and its tokenizer); "
                                       "default: model_name_or_path"),
    vilt_model_name_or_path=dict(default="dandelin/vilt-b32-mlm", type=str,
                                 help="ViLT checkpoint (TomViLT only)"),
    num_hidden_cross_layers=dict(default=1, type=int,
                                 help="cross-attention layers"),
    pooling=dict(default="first", choices=["first", "cls", "both"], type=str),
    mm_pooling=dict(default="first", choices=["first", "cls", "both"], type=str,
                    help="TomViLT multimodal pooling (accepted as the "
                         "reference's CLI accepts it; the reference never "
                         "threads it into the model, which pools ViLT's "
                         "token 0, and neither does this one)"),
    vilt_dropout_prob=dict(default=0.1, type=float,
                           help="TomViLT: VAuLT classifier-head dropout"),
    tie_target_bert_weights=dict(action="store_true",
                                 help="TomBERT: the target tower shares the "
                                      "tweet tower's weights"),
    resnet_depth=dict(default=101, type=int, choices=[18, 34, 50, 101, 152]),
    resnet_weights=dict(type=str,
                        help="local torchvision state dict (.pth) to seed "
                             "the ResNet"),
    train_image_encoder=dict(action="store_true", help="fine-tune the ResNet"),
    use_tweet_bert=dict(action="store_true",
                        help="TomViLT: use the LM tower inside VAuLT"),
    add_placeholder_token=dict(action="store_true",
                               help="add $T$ to the tokenizer and grow the "
                                    "text towers' word tables"),
    max_total_length=dict(default=64, type=int,
                          help="max tweet+target tokens (40 for TomViLT)"),
    max_target_length=dict(default=16, type=int, help="max target tokens"),
    crop_size=dict(default=224, type=int, help="image crop for the ResNet"),
    debug_tiny=dict(action="store_true",
                    help="debug: tiny model geometry and tiny images"),
)

DATASET_ARGS = dict(
    dir=dict(required=True, type=str, help="tweet dataset directory"),
    image_dir=dict(type=str, help="image directory (default <dir>_images)"),
    train_split=dict(required=True, type=str, nargs="+"),
    dev_split=dict(type=str, nargs="+"),
    test_split=dict(type=str, nargs="+"),
    preprocess_on_fetch=dict(action="store_true",
                             help="decode and transform train images per "
                                  "fetch instead of up front"),
)

ENTITY_ARGS = dict(
    entity_cache=dict(type=str,
                      help="JSON entity cache (target -> [entity, "
                           "description]); adds entity tokens to the "
                           "tokenizer, their embeddings max-pooled"),
    wiki_store=dict(type=str,
                    help="offline alias-store file to link with when "
                         "--entity_cache does not exist yet"),
    entity_threshold=dict(default=0.0, type=float,
                          help="entity-linking confidence threshold"),
)


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(
        prog="python -m vault_tpu_torch.cli.tmsc_tombert",
        description="Fine-tune TomBERT or TomViLT on TMSC (Twitter-201X).")
    sp = parser.add_subparsers(dest="model", required=True)
    for model in ("TomBERT", "TomViLT"):
        p = sp.add_parser(model)
        add_arguments(p, MODEL_ARGS)
        add_arguments(p, DATASET_ARGS)
        add_arguments(p, ENTITY_ARGS)
        add_arguments(p, TRAINER_ARGS)
        add_arguments(p, GENERAL_ARGS)
        p.add_argument("-r", "--reps_short", type=int, dest="reps_short",
                       help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    if getattr(args, "reps_short", None):
        args.reps = args.reps_short
    if args.merge_to is not None:
        # ToMe merges ViLT's patch tokens; TomBERT has no ViLT and TomViLT
        # feeds the attended target-length sequence as image_embeds, so a
        # silently ignored flag would misreport the run
        parser.error("--merge_to is not supported for the TomBERT/TomViLT "
                     "families (no patch-token path to merge); use "
                     "python -m vault_tpu_torch.cli.clsf_vault")
    return args


def text_config(args):
    """The text stacks' config: ``--debug_tiny``'s, else the checkpoint's
    (its preset when the name is not a directory)."""
    from vault_tpu_torch.config import tiny_text_config
    from vault_tpu_torch.models.pretrained import text_config_from_name

    if args.debug_tiny:
        return tiny_text_config(vocab_size=30522)
    return text_config_from_name(args.model_name_or_path)


def vault_config(args, text_cfg):
    """TomViLT's VaultConfig: ViLT (``--debug_tiny``'s tiny geometry, else
    the checkpoint's) with the text tower under ``--use_tweet_bert``."""
    from vault_tpu_torch.config import VaultConfig, tiny_vilt_config
    from vault_tpu_torch.models.pretrained import vilt_config_from_name

    vilt_cfg = (tiny_vilt_config(vocab_size=30522) if args.debug_tiny
                else vilt_config_from_name(args.vilt_model_name_or_path))
    return VaultConfig(vilt=vilt_cfg,
                       text_tower=text_cfg if args.use_tweet_bert else None)


def _prefixed(prefix, sd):
    return {f"{prefix}.{k}": v for k, v in sd.items()}


def _under(prefix, sd):
    return {k[len(prefix) + 1:]: v for k, v in sd.items()
            if k.startswith(prefix + ".")}


def tombert_params(args, text_cfg, n_classes, vis_dim, gen, resnet_params):
    """(state dict, tweet config) of one TomBERT rep: the surgery from
    ``--model_name_or_path`` (and ``--tweet_model_name_or_path``) when it
    is a directory, else random; the ResNet from ``resnet_params`` when
    given, else random."""
    from vault_tpu_torch.models.pretrained import load_bert_tower, text_config_from_name
    from vault_tpu_torch.models.resnet import init_resnet
    from vault_tpu_torch.models.tombert import init_tombert, init_tombert_from_bert

    tweet_cfg = text_cfg
    if os.path.isdir(args.model_name_or_path):
        bert_params = load_bert_tower(args.model_name_or_path, text_cfg)
        tweet_params = None
        if args.tweet_model_name_or_path and os.path.isdir(args.tweet_model_name_or_path):
            tweet_cfg = text_config_from_name(args.tweet_model_name_or_path)
            tweet_params = load_bert_tower(args.tweet_model_name_or_path, tweet_cfg)
        params = init_tombert_from_bert(
            bert_params, gen, text_cfg, n_classes, args.pooling, vis_dim,
            args.num_hidden_cross_layers, resnet_params=resnet_params,
            tweet_params=tweet_params, tie_target_bert=args.tie_target_bert_weights)
        if resnet_params is None:
            params.update(_prefixed("resnet", init_resnet(
                gen, args.resnet_depth).state_dict()))
        return params, tweet_cfg
    params = init_tombert(gen, text_cfg, n_classes, args.pooling, vis_dim,
                          args.num_hidden_cross_layers, resnet_depth=args.resnet_depth,
                          tie_target_bert=args.tie_target_bert_weights).state_dict()
    if resnet_params is not None:
        params = {k: v for k, v in params.items() if not k.startswith("resnet.")}
        params.update(_prefixed("resnet", resnet_params))
    return params, tweet_cfg


def tomvilt_params(args, vault_cfg, text_cfg, n_classes, vis_dim, gen, resnet_params):
    """The state dict of one TomViLT rep: VAuLT from ``--vilt_model_name_or_path``
    (and, under ``--use_tweet_bert``, ``--model_name_or_path``) where they
    are directories, the target tower from ``--model_name_or_path``, the
    ResNet from ``resnet_params``; the rest drawn from ``gen``."""
    from vault_tpu_torch.models.pretrained import load_bert_tower, load_vault_backbone
    from vault_tpu_torch.models.tomvilt import init_tomvilt

    params = init_tomvilt(gen, vault_cfg, text_cfg, n_classes, vis_dim,
                          args.num_hidden_cross_layers,
                          resnet_depth=args.resnet_depth).state_dict()
    vilt_dir = (args.vilt_model_name_or_path
                if os.path.isdir(args.vilt_model_name_or_path) else None)
    bert_dir = args.model_name_or_path if os.path.isdir(args.model_name_or_path) else None
    if vilt_dir or (args.use_tweet_bert and bert_dir):
        backbone = load_vault_backbone(vault_cfg, gen, vilt_dir,
                                       bert_dir if args.use_tweet_bert else None)
        params.update(_prefixed("vault", backbone))
    if bert_dir:
        params = {k: v for k, v in params.items() if not k.startswith("target_bert.")}
        params.update(_prefixed("target_bert", load_bert_tower(bert_dir, text_cfg)))
    if resnet_params is not None:
        params = {k: v for k, v in params.items() if not k.startswith("resnet.")}
        params.update(_prefixed("resnet", resnet_params))
    return params


def main(argv: Optional[Sequence[str]] = None) -> List:
    """Run the experiment of ``argv`` (``sys.argv[1:]`` when None); returns
    the trainer of each rep."""
    import torch

    from vault_tpu_torch.data.datasets import read_twitter201x
    from vault_tpu_torch.data.processor import VaultProcessor
    from vault_tpu_torch.data.tombert_dataset import TomBertTmscDataset
    from vault_tpu_torch.models.bert import grow_rows
    from vault_tpu_torch.models.pretrained import build_tokenizer, load_resnet_tower
    from vault_tpu_torch.models.resnet import RESNET_OUT_DIM
    from vault_tpu_torch.models.vault import resize_token_embeddings, resolve_device
    from vault_tpu_torch.text.entity_linking import (
        integrate_entities_into_embeddings,
        integrate_entities_into_vault,
        resolve_entities_for_cli,
    )
    from vault_tpu_torch.training.experiment import ExperimentHandler
    from vault_tpu_torch.training.task_trainers import (
        TomBertTrainer,
        tombert_apply_fn,
        tomvilt_apply_fn,
    )

    args = parse_args(argv)
    apply_device_arg(args)
    device = resolve_device(args.device)
    logging.basicConfig(level=args.logging_level.upper(), filename=args.logging_file)

    # TomBERT's tokenizer follows the tweet tower when that differs
    # (reference experiments/tmsc_tombert.py:73-78)
    tokenizer_src = args.model_name_or_path
    if args.model == "TomBERT" and args.tweet_model_name_or_path:
        tokenizer_src = args.tweet_model_name_or_path
    if args.debug_tiny:
        args.resnet_depth, args.crop_size = 18, 64
    text_cfg = text_config(args)
    tokenizer = build_tokenizer(tokenizer_src)
    if args.model == "TomBERT" and args.tweet_model_name_or_path and \
            os.path.isdir(tokenizer_src) != os.path.isdir(args.model_name_or_path):
        logging.warning(
            "tokenizer follows %r but tower weights follow %r and only one "
            "is a local checkpoint dir: token ids will not line up with "
            "the pretrained embeddings", tokenizer_src, args.model_name_or_path)
    if not os.path.isdir(tokenizer_src) and os.path.isdir(args.model_name_or_path):
        logging.warning(
            "%r is not a local checkpoint dir: using a minimal fallback "
            "tokenizer while pretrained weights load from %r", tokenizer_src,
            args.model_name_or_path)
    processor = VaultProcessor(tokenizer, max_length=args.max_total_length)
    max_total = args.max_total_length
    if args.model == "TomViLT":
        max_total = min(max_total, 40)  # ViLT's text constraint

    # entities resolve before the datasets, so their tokens reach the
    # encoded targets
    def read_targets():
        kinds = (list(args.train_split) + list(args.dev_split or [])
                 + list(args.test_split or []))
        return [e.target for e in read_twitter201x(args.dir, kinds)]

    entity_map, entity_descriptions = resolve_entities_for_cli(
        args.entity_cache, args.wiki_store, args.entity_threshold, tokenizer,
        read_targets)
    if args.add_placeholder_token and hasattr(tokenizer, "add_tokens"):
        # after the entity tokens: the rows appended per rep (entity rows,
        # then the random $T$ row) follow the token ids
        tokenizer.add_tokens(["$T$"])

    def mk(kinds, on_fetch=False, label_mapping=None):
        return TomBertTmscDataset(
            args.dir, kinds, processor, image_dir=args.image_dir,
            max_total_length=max_total, max_target_length=args.max_target_length,
            crop_size=args.crop_size, preprocess_on_fetch=on_fetch,
            num_workers=args.max_num_workers, entity_map=entity_map or None,
            label_mapping=label_mapping)

    train_ds = mk(args.train_split, on_fetch=args.preprocess_on_fetch)
    lm = train_ds.label_mapping  # dev and test reuse the train mapping
    dev_ds = mk(args.dev_split, label_mapping=lm) if args.dev_split else None
    test_ds = mk(args.test_split, label_mapping=lm) if args.test_split else None
    n_classes = len(lm)
    vis_dim = RESNET_OUT_DIM[args.resnet_depth]
    targs = trainer_args_from_namespace(args)
    tweet_named = args.model == "TomBERT" and bool(args.tweet_model_name_or_path)

    trainers = []
    for rep in range(args.reps):
        handler = ExperimentHandler(args.experiment_root, f"{args.model}TMSC")
        handler.set_params({
            "vilt_model": (os.path.basename(args.vilt_model_name_or_path)
                           if args.model == "TomViLT" else "None"),
            "dataset": train_ds.name,
            "bert_model": os.path.basename(args.model_name_or_path),
            "use_tweet_bert": args.use_tweet_bert,
            "lr": args.lr, "pooling": args.pooling,
            "resnet_depth": args.resnet_depth,
        })
        if tweet_named:
            handler.set_param("tweet_model",
                              os.path.basename(args.tweet_model_name_or_path))
        if args.description:
            handler.set_param("description", args.description, disabled=True)
        name_params = ["vilt_model", "dataset", "bert_model", "use_tweet_bert"]
        if tweet_named:
            name_params.insert(2, "tweet_model")
        handler.set_name_params(name_params)

        seed = args.seed + rep
        gen = torch.Generator().manual_seed(seed)
        resnet_params = (load_resnet_tower(args.resnet_weights, args.resnet_depth)
                         if args.resnet_weights else None)

        def grow_towers(params, towers):
            """Entity max-pool rows, then the random $T$ row, in token-id
            order, for the named BERT towers (reference
            resize_token_embeddings, tombert/model.py:185-187)."""
            for t in towers:
                key = f"{t}.embeddings.word"
                word = params[key]
                if entity_descriptions:
                    word = integrate_entities_into_embeddings(
                        word, entity_descriptions, tokenizer)
                if args.add_placeholder_token and hasattr(tokenizer, "__len__"):
                    word = grow_rows(word, len(tokenizer),
                                     torch.Generator().manual_seed(seed + 11))
                params[key] = word
            return params

        if args.model == "TomBERT":
            params, tweet_cfg = tombert_params(args, text_cfg, n_classes, vis_dim,
                                               gen, resnet_params)
            params = grow_towers(params, ["tweet_bert"] + (
                [] if args.tie_target_bert_weights else ["target_bert"]))
            apply_fn = tombert_apply_fn(
                text_cfg, args.pooling, args.resnet_depth, args.train_image_encoder,
                tweet_cfg=tweet_cfg, use_pallas=targs.use_pallas)
        else:
            vault_cfg = vault_config(args, text_cfg)
            params = tomvilt_params(args, vault_cfg, text_cfg, n_classes, vis_dim,
                                    gen, resnet_params)
            params = grow_towers(params, ["target_bert"])
            run_cfg = vault_cfg
            if entity_descriptions:
                params, run_cfg = integrate_entities_into_vault(
                    params, run_cfg, entity_descriptions, tokenizer, prefix="vault.")
            if args.add_placeholder_token and hasattr(tokenizer, "__len__"):
                vault, run_cfg = resize_token_embeddings(
                    _under("vault", params), run_cfg, len(tokenizer),
                    torch.Generator().manual_seed(seed + 11))
                params.update(_prefixed("vault", vault))
            apply_fn = tomvilt_apply_fn(
                run_cfg, text_cfg, args.resnet_depth, args.train_image_encoder,
                head_dropout=args.vilt_dropout_prob, use_pallas=targs.use_pallas)

        trainer = TomBertTrainer(
            apply_fn, params, targs, train_ds, dev_dataset=dev_ds,
            test_dataset=test_ds, exp_handler=handler,
            resnet_params=_under("resnet", params), resnet_depth=args.resnet_depth,
            train_image_encoder=args.train_image_encoder, device=device)
        trainer.train()
        trainers.append(trainer)
    return trainers


if __name__ == "__main__":
    main()
