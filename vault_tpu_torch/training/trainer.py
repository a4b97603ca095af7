"""The training loop on one device (port of ``vault_tpu/training/trainer.py``).

Behavior mirrors the reference's ``Twitter201XTrainer.train`` /
``evaluate`` (vault/tmsc_utils/trainer.py:282-484) as the JAX package does:
HF AdamW with linear warmup/decay, a train loss per ``eval_steps`` window,
dev evaluation, early stopping with best-weights restore, the ``max_steps``
abort, a final test evaluation, then the ExperimentHandler's
log/aggregate/plot.

How it maps onto PyTorch:
  * the parameters are a state dict of master tensors on the device (the
    dtype they were given, fp32 for the models' init); with
    ``compute_dtype="bfloat16"`` each step casts every float leaf with
    ``.to(torch.bfloat16)`` and hands the model the cast tree
    (``convert.param_tree``), so autograd carries the gradients back into
    the masters, as the JAX package's differentiable ``cast_compute`` does;
  * ``apply_fn(params, batch, deterministic, generator)`` takes a
    ``torch.Generator`` where the JAX package takes a key; the step's
    generator is seeded from (seed, step) alone, so a resumed run draws the
    stream the uninterrupted one would have (micro-batch i of grad
    accumulation from (seed, step, i));
  * the optimizer updates the masters and moments in place
    (training/optimizer.py);
  * the window's [weighted loss sum, valid mass] stays on the device and is
    read once per eval window;
  * early stopping keeps the best weights on the host; checkpoints hold
    {params, opt_state, step} in the JAX package's npz layout
    (training/checkpoint.py), written on a background thread at every eval
    window from host copies taken on the calling thread;
  * a leaf that the loss does not reach gets a zero gradient (as under
    ``jax.grad``) only when ``apply_fn.unreached`` names it
    (:func:`classifier_apply_fn` sets it from the config); any other leaf
    without a gradient raises, since it means the autograd graph was cut.

The task heads have factories of their own beside
:func:`classifier_apply_fn` (:func:`mlm_apply_fn`, :func:`vqa_apply_fn`,
:func:`retrieval_apply_fn`, :func:`images_and_text_apply_fn`), and the task
trainers (training/task_trainers.py) override the hooks at the bottom of
:class:`Trainer`.

Token merging trains as in the JAX package: :func:`classifier_apply_fn`
threads ``merge_to`` and ``merge_at_layer`` into the forward (the
size-weighted average is differentiable, the merge decisions piecewise
constant).  ``remat`` is False, True or "dots" (ops/nn.py ``remat_apply``),
``opt_state_dtype`` "float32", "bfloat16" or "int8" (training/optimizer.py).
``profile_dir`` traces the second eval window (utils/profiling.py
``trace``), as the JAX package does: each step's ``train_step:<n>`` span
holds the ``vault.step.*`` spans of its forward, backward and optimizer,
and the model's ``vault.*`` spans of its towers, encoder layers and head
(utils/profiling.py ``span``); while ``utils.profiling.
enable_nan_checks`` is on, each step and each evaluation batch runs under
its NaN checks.  ``rng_impl`` has no counterpart (the port has one
generator kind) and is ignored.  There is no ``precompile``: PyTorch runs
eagerly.

Several devices: one process per rank over ``torch.distributed``
(parallel/mesh.py), where the JAX package's trainer runs one program over a
mesh.  With a ``mesh`` (or ``num_data_shards > 1``, or an initialized world
of more than one process, which builds one):
  * every process runs the same loop on the same seeded batches and keeps
    its rows of each (``mesh.shard_batch``), padded to ``dp *
    grad_accum_steps``; each rank draws the dropout masks of the whole
    batch from the shared step generator and keeps its rows
    (ops/nn.py ``shard_draws``), so ``dp`` ranks equal one process on the
    same global batch;
  * each rank scales its weighted loss by its share of the global valid
    mass; the gradients are then summed over the "data" group in one fp32
    bucket, once a step (after the last micro-batch), so they are the
    global mean's;
  * ``zero_opt`` splits the moments over the "data" ranks
    (parallel/zero.py); ``tensor_parallel`` splits the encoder layers over
    the "model" ranks (parallel/sharding.py, parallel/tensor_parallel.py);
  * evaluation gathers every rank's logits; only rank 0 writes the
    ExperimentHandler's files and weights; checkpoints go through
    ``torch.distributed.checkpoint``, every rank writing its own shards
    (training/checkpoint.py ``save_checkpoint_multihost``), while a world of
    one keeps the npz that crosses to and from the JAX package.
"""

from __future__ import annotations

import contextlib
import logging
import os
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Mapping, Optional, Union

import numpy as np
import torch

from vault_tpu_torch.convert import (
    opt_state_from_jax,
    opt_state_to_jax,
    param_tree,
    params_from_jax,
    params_to_jax,
)
from vault_tpu_torch.models.vault import (
    batch_to_device,
    mlm_unreached_leaf,
    resolve_device,
    unreached_leaf,
    vault_for_classification,
    vault_for_images_and_text,
    vault_for_mlm,
    vault_for_retrieval,
    vault_for_vqa,
)
from vault_tpu_torch.training import losses as losses_mod
from vault_tpu_torch.training.experiment import ExperimentHandler
from vault_tpu_torch.training.metrics import classification_results
from vault_tpu_torch.training.optimizer import AdamWState, Q8Moment, make_optimizer
from vault_tpu_torch.ops.nn import shard_draws
from vault_tpu_torch.parallel import mesh as mesh_mod
from vault_tpu_torch.parallel.mesh import pad_to_multiple
from vault_tpu_torch.utils import profiling

logger = logging.getLogger(__name__)

HEAD_KEYS = {"head", "vqa", "rank", "pair", "mlm", "classifier"}


def _progress(iterator, disable: bool, **tqdm_kwargs):
    """tqdm-wrapped iterator; plain passthrough when disabled or tqdm is
    not installed."""
    if disable:
        return iterator
    try:
        from tqdm import tqdm
    except ImportError:
        return iterator
    return tqdm(iterator, **tqdm_kwargs)


@dataclass
class TrainArgs:
    """The JAX package's ``TrainArgs``, field for field (reference knobs of
    vault/tmsc_utils/trainer.py:51-91 and vault/train_utils.py:178-285,
    then the accelerator additions)."""

    lr: float = 2e-5
    adam_beta1: float = 0.9
    adam_beta2: float = 0.999
    adam_epsilon: float = 1e-8
    weight_decay: float = 0.0
    correct_bias: bool = False
    train_batch_size: int = 32
    eval_batch_size: int = 32
    num_train_epochs: int = 10
    warmup_ratio: float = 0.1
    eval_steps: Optional[int] = None          # default: once per epoch
    max_steps: int = -1
    early_stopping_patience: Optional[int] = None
    early_stopping_delta: float = 0.0
    early_stopping_metric: str = "eval_accuracy"
    higher_better: bool = True
    model_save: bool = False
    model_load_filename: Optional[str] = None
    discard_classifier: bool = False
    seed: int = 0
    num_data_shards: Optional[int] = None     # default: the world's ranks
    rng_impl: Optional[str] = "rbg"           # no counterpart; ignored
    use_pallas: Any = "auto"                  # read by classifier_apply_fn
    remat: Union[bool, str] = True            # False, True or "dots"
    merge_to: Optional[int] = None            # read by classifier_apply_fn
    merge_at_layer: int = 0
    compute_dtype: str = "float32"
    checkpoint_dir: Optional[str] = None
    resume: bool = False
    prefetch_batches: int = 2
    disable_tqdm: bool = False
    profile_dir: Optional[str] = None
    grad_accum_steps: int = 1
    opt_state_dtype: Optional[str] = "bfloat16"
    grad_dtype: Optional[str] = None
    zero_opt: bool = False


def classifier_apply_fn(cfg, args: TrainArgs,
                        head_dropout: float = 0.1) -> Callable:
    """``apply_fn`` of the VAuLT classifier for :class:`Trainer`, with
    ``args.use_pallas``, ``args.remat``, ``args.merge_to`` and
    ``args.merge_at_layer`` threaded in as the JAX package's experiments
    thread them (``experiments/clsf_vault.py``).  Its ``unreached`` names
    the leaves the loss never reads
    (:func:`~vault_tpu_torch.models.vault.unreached_leaf`)."""
    use_pallas, remat = args.use_pallas, args.remat
    merge_to, merge_at_layer = args.merge_to, args.merge_at_layer

    def apply_fn(params, batch, deterministic, generator):
        return vault_for_classification(
            params, cfg, batch, head_dropout=head_dropout,
            deterministic=deterministic, generator=generator,
            use_pallas=use_pallas, remat=remat, merge_patches_to=merge_to,
            merge_at_layer=merge_at_layer)

    apply_fn.unreached = unreached_leaf(cfg)
    return apply_fn


def _head_apply_fn(forward, cfg, args: TrainArgs, unreached) -> Callable:
    """``apply_fn`` of a task head's forward (``vault_for_mlm``, ...) with
    ``args.use_pallas``, ``args.remat`` and ``args.merge_to`` threaded in.
    The head forwards merge patch tokens at the embeddings only, as the JAX
    package's do, so a ``merge_at_layer`` past 0 raises."""
    if args.merge_at_layer:
        raise ValueError("the task heads merge patch tokens at the embeddings "
                         f"only; merge_at_layer={args.merge_at_layer}")
    use_pallas, remat, merge_to = args.use_pallas, args.remat, args.merge_to

    def apply_fn(params, batch, deterministic, generator):
        return forward(params, cfg, batch, deterministic=deterministic,
                       generator=generator, use_pallas=use_pallas, remat=remat,
                       merge_patches_to=merge_to)

    apply_fn.unreached = unreached
    return apply_fn


def mlm_apply_fn(cfg, args: TrainArgs) -> Callable:
    """``apply_fn`` of the MLM head (``vault_for_mlm``).  ViLT's text word
    table is read by the tied decoder, so it is not among the unreached
    leaves (:func:`~vault_tpu_torch.models.vault.mlm_unreached_leaf`)."""
    return _head_apply_fn(vault_for_mlm, cfg, args, mlm_unreached_leaf(cfg))


def vqa_apply_fn(cfg, args: TrainArgs) -> Callable:
    """``apply_fn`` of the VQA head (``vault_for_vqa``)."""
    return _head_apply_fn(vault_for_vqa, cfg, args, unreached_leaf(cfg))


def retrieval_apply_fn(cfg, args: TrainArgs) -> Callable:
    """``apply_fn`` of the retrieval rank head (``vault_for_retrieval``)."""
    return _head_apply_fn(vault_for_retrieval, cfg, args, unreached_leaf(cfg))


def images_and_text_apply_fn(cfg, args: TrainArgs) -> Callable:
    """``apply_fn`` of the pair head (``vault_for_images_and_text``, two
    backbone passes).  Every row of the resized modality-type table is
    read (text 0, image slots 1 and 2)."""
    return _head_apply_fn(vault_for_images_and_text, cfg, args, unreached_leaf(cfg))


class EarlyStopping:
    """Patience/delta/higher-better tracking with a best-weights snapshot on
    the host (vault/train_utils.py:13-171)."""

    def __init__(self, patience: Optional[int], delta: float = 0.0,
                 higher_better: bool = False, keep_weights: bool = True):
        self.patience = patience
        self.delta = delta
        self.higher_better = higher_better
        self.keep_weights = keep_weights
        self.cnt = 0
        self.best: Optional[float] = None
        self.best_metrics: Dict[str, Any] = {}
        self.best_params = None

    def new_best(self, metric: float) -> bool:
        if self.best is None:
            return True
        if self.higher_better:
            return metric > self.best + self.delta
        return metric < self.best - self.delta

    def step(self, metric: Optional[float], params=None, **metrics) -> bool:
        if metric is None and self.patience is not None:
            # a misspelled early_stopping_metric would otherwise disable
            # early stopping and the best-weights restore without a word
            logger.warning(
                "early stopping is configured (patience=%d) but the eval "
                "results have no value for the early-stopping metric; "
                "early stop and best-weights restore are INACTIVE this "
                "window (available keys: %s)",
                self.patience, sorted(metrics.keys()))
        if metric is None or self.patience is None:
            # no snapshot: training ends on the live final params
            return False
        if self.new_best(metric):
            self.best = metric
            self.best_metrics = {f"best_{k}": v for k, v in metrics.items()}
            self.cnt = 0
            if params is not None and self.keep_weights:
                self.best_params = {k: v.detach().to("cpu", copy=True)
                                    for k, v in params.items()}
        else:
            self.cnt += 1
        return self.cnt >= self.patience

    def get_metrics(self) -> Optional[Dict[str, Any]]:
        return self.best_metrics if self.best is not None else None


class Trainer:
    """Generic task trainer.  Task adapters override the hooks at the
    bottom (the reference's calculate_loss / get_eval_preds /
    evaluation_metrics pattern).

    ``params``: a state dict (or a module, whose state dict is taken), the
    whole model on every process; the trainer keeps its own copies (this
    rank's shards under ``tensor_parallel``) on ``device`` (the card unless
    named).  ``mesh``: a :class:`~vault_tpu_torch.parallel.mesh.Mesh`; by
    default one is built over the initialized world when it has more than
    one process or ``num_data_shards > 1`` asks for one (which raises
    without an initialized group)."""

    def __init__(self, apply_fn: Callable, params, args: TrainArgs,
                 train_dataset, dev_dataset=None, test_dataset=None,
                 exp_handler: Optional[ExperimentHandler] = None,
                 mesh=None, tensor_parallel: bool = False, device=None):
        if mesh is None and ((args.num_data_shards or 1) > 1
                             or mesh_mod.world_size() > 1):
            mesh = mesh_mod.make_mesh(args.num_data_shards)
        self.mesh = mesh
        self.dp = mesh.num_data if mesh is not None else 1
        self.tp = mesh.num_model if mesh is not None and tensor_parallel else 1
        self.p0 = mesh_mod.process_index() == 0
        self._tp_group = None
        if self.tp > 1:
            from vault_tpu_torch.parallel.tensor_parallel import ProcessTP

            self._tp_group = ProcessTP(mesh.model_group)
        self.apply_fn = apply_fn
        self.args = args
        self.train_dataset = train_dataset
        self.dev_dataset = dev_dataset
        self.test_dataset = test_dataset
        self.exp_handler = exp_handler or ExperimentHandler()
        self.device = resolve_device(device)
        if mesh is not None and self.device.type == "cuda":
            # NCCL's barrier and its communicators take the current device
            torch.cuda.set_device(self.device)
        if isinstance(params, torch.nn.Module):
            params = params.state_dict()
        self.params = {k: v.detach().to(self.device, copy=True)
                       .requires_grad_(v.is_floating_point())
                       for k, v in self._shard(params).items()}
        self.early_stopping = EarlyStopping(
            args.early_stopping_patience, delta=args.early_stopping_delta,
            higher_better=args.higher_better)
        self.tx = None
        self.opt_state: Optional[AdamWState] = None
        self._built_for = None
        self._ckpt_pool = None
        self._ckpt_future = None
        # (wall_seconds, pairs) per completed eval window
        self.window_times: List[tuple] = []

    @property
    def trainable(self) -> Dict[str, torch.Tensor]:
        return {k: v for k, v in self.params.items() if v.requires_grad}

    # ------------------------------------------------------------ parallel
    def _shard(self, params: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """This rank's tensor-parallel shards of whole parameters."""
        if self.tp == 1:
            return dict(params)
        from vault_tpu_torch.parallel.sharding import shard_params

        return shard_params(params, self.mesh.model_index, self.tp)

    def full_params(self) -> Dict[str, torch.Tensor]:
        """The whole parameters on the device (the tensor-parallel shards
        gathered over the "model" group; the parameters themselves
        otherwise)."""
        if self.tp == 1:
            return self.params
        from vault_tpu_torch.parallel.mesh import all_gather
        from vault_tpu_torch.parallel.sharding import shard_dim, vault_param_specs

        specs = vault_param_specs(self.params)
        out = {}
        for k, v in self.params.items():
            d = shard_dim(specs[k])
            out[k] = v.detach() if d is None else torch.cat(
                all_gather(v.detach(), self.mesh.model_group), dim=d)
        return out

    def _parallel(self):
        """The block's dropout draws cut to this rank's rows and heads, and
        the tensor-parallel group active."""
        stack = contextlib.ExitStack()
        if self.mesh is not None:
            from vault_tpu_torch.parallel.tensor_parallel import use_tp

            stack.enter_context(shard_draws(
                rows=(self.mesh.data_index, self.dp),
                heads=(self.mesh.model_index, self.tp) if self.tp > 1 else None))
            stack.enter_context(use_tp(self._tp_group))
        return stack

    def _rows(self, batch, labels, weight):
        """This rank's rows of a padded host batch (all of it on one
        process), cut per micro-batch (``mesh.shard_batch``)."""
        if self.mesh is None:
            return batch, labels, weight
        k = max(1, self.args.grad_accum_steps)
        return (mesh_mod.shard_batch(self.mesh, batch, k),
                mesh_mod.shard_batch(self.mesh, labels, k),
                mesh_mod.shard_batch(self.mesh, weight, k))

    # --------------------------------------------------------------- steps
    def _build_optimizer(self, steps_per_epoch: int):
        self._built_for = steps_per_epoch
        a = self.args
        num_steps = max(1, steps_per_epoch * int(a.num_train_epochs))
        self.tx, self._schedule = make_optimizer(
            a.lr, num_steps, a.warmup_ratio, a.adam_beta1, a.adam_beta2,
            a.adam_epsilon, a.weight_decay, a.correct_bias,
            state_dtype=a.opt_state_dtype)
        if a.zero_opt and self.mesh is not None:
            from vault_tpu_torch.parallel.zero import ZeroAdamW

            self.tx = ZeroAdamW(self.tx, self.mesh.data_group)
        self.opt_state = self.tx.init(self.trainable)

    def compute_params(self, params: Mapping[str, torch.Tensor]):
        """The tree the model runs on: the masters, or their bf16 casts
        (differentiable back to the masters) under compute_dtype
        "bfloat16"."""
        if self.args.compute_dtype == "bfloat16":
            params = {k: v.to(torch.bfloat16) if v.is_floating_point() else v
                      for k, v in params.items()}
        return param_tree(params)

    def step_generator(self, step: int, micro: Optional[int] = None
                       ) -> torch.Generator:
        """The dropout generator of one step: a pure function of (seed,
        step[, micro-batch])."""
        seq = np.random.SeedSequence(
            [int(self.args.seed), int(step)],
            spawn_key=() if micro is None else (int(micro),))
        seed = int(seq.generate_state(1, np.uint64)[0] >> 1)
        return torch.Generator(device=self.device).manual_seed(seed)

    def loss_and_grads(self, batch, labels, weight, generator, reduce=True):
        """(loss, {name: gradient}) of one training forward; ``self._mass``
        is left at the valid mass the loss averages over.  Over several
        ranks, the loss is scaled by this rank's share of the global mass
        and, with ``reduce``, the gradients (and the loss) are summed over
        the "data" group: the global mean's.  Without it they stay this
        rank's share, for a caller that sums several before one
        reduction.  Spans (utils/profiling.py ``span``):
        ``vault.step.forward`` holds the cast of the masters
        (``vault.step.cast_params``), the forward and the loss;
        ``vault.step.backward`` the backward and the zero gradients of the
        unreached leaves."""
        trainable = self.trainable
        mass = weight.sum().float()
        with self._parallel():
            with profiling.span("vault.step.forward"):
                with profiling.span("vault.step.cast_params"):
                    params = self.compute_params(self.params)
                logits = self.apply_fn(params, batch, False, generator)
                loss = self.calculate_loss(logits, labels, weight, train=True)
                if self.mesh is not None:
                    total = mesh_mod.all_reduce_(mass.clone(), self.mesh.data_group)
                    loss = loss * (mass / torch.clamp(total, min=1.0))
                    mass = total
            with profiling.span("vault.step.backward"):
                grads = torch.autograd.grad(loss, list(trainable.values()),
                                            allow_unused=True)
                unreached = getattr(self.apply_fn, "unreached", lambda key: False)
                cut = [k for k, g in zip(trainable, grads)
                       if g is None and not unreached(k)]
                if cut:
                    raise RuntimeError(
                        f"no gradient reached {len(cut)} parameter leaves (first: "
                        f"{cut[:4]}): the autograd graph is cut above them")
                grads = {k: torch.zeros_like(p) if g is None else g
                         for (k, p), g in zip(trainable.items(), grads)}
        self._mass = mass
        loss = loss.detach()
        return self._sum_over_data(loss, grads) if reduce else (loss, grads)

    def _sum_over_data(self, loss, grads):
        """The loss and every gradient summed over the "data" group, through
        one fp32 bucket (as they are on one process)."""
        if self.mesh is None:
            return loss, grads
        *summed, loss = mesh_mod.all_reduce_bucket(
            list(grads.values()) + [loss], self.mesh.data_group)
        return loss, {k: v.to(grads[k].dtype) for k, v in zip(grads, summed)}

    def train_step(self, batch, labels, weight, step: int) -> torch.Tensor:
        """Forward, backward and one optimizer update on device tensors,
        under the NaN checks while ``utils.profiling.enable_nan_checks`` is
        on, in a ``train_step:<step>`` span (utils/profiling.py ``span``:
        only while a profiler records, as in a ``profile_dir`` trace), the
        optimizer's update in a ``vault.step.optimizer`` span.  Returns the
        on-device pair [loss * valid mass, valid mass]."""
        with profiling.nan_checks(), profiling.span(f"train_step:{step}"):
            return self._train_step(batch, labels, weight, step)

    def _train_step(self, batch, labels, weight, step: int) -> torch.Tensor:
        k = self.args.grad_accum_steps
        if k <= 1:
            loss, grads = self.loss_and_grads(batch, labels, weight,
                                              self.step_generator(step))
        else:
            # k micro-batches, each weighted by its valid-row mass so padded
            # rows keep contributing nothing; over several ranks the shares
            # are summed here and reduced once, after the last micro-batch
            n = labels.shape[0] // k
            grads, loss_sum, mass = None, 0.0, 0.0
            for i in range(k):
                sl = slice(i * n, (i + 1) * n)
                w = weight[sl]
                loss, g = self.loss_and_grads(
                    {kk: v[sl] for kk, v in batch.items()}, labels[sl], w,
                    self.step_generator(step, i), reduce=False)
                wsum = self._mass
                g = {kk: v.float() * wsum for kk, v in g.items()}
                grads = g if grads is None else {
                    kk: grads[kk] + g[kk] for kk in grads}
                loss_sum, mass = loss_sum + loss * wsum, mass + wsum
            loss_sum, grads = self._sum_over_data(loss_sum, grads)
            denom = torch.clamp(mass, min=1.0)
            loss = loss_sum / denom
            grads = {kk: (v / denom).to(self.params[kk].dtype)
                     for kk, v in grads.items()}
            self._mass = mass
        with profiling.span("vault.step.optimizer"):
            if self.args.grad_dtype == "bfloat16":
                # halves the gradient buffers' traffic; drops mantissa bits
                grads = {kk: v.to(torch.bfloat16) for kk, v in grads.items()}
            self.opt_state = self.tx.step_(self.trainable, grads, self.opt_state)
        wsum = self._mass
        return torch.stack([loss.float() * wsum, wsum])

    def _to_device(self, batch, labels, weight):
        return (batch_to_device(batch, self.device),
                torch.as_tensor(np.asarray(labels)).to(self.device),
                torch.as_tensor(weight).to(self.device))

    # ---------------------------------------------------------------- loop
    def train(self):
        a = self.args
        if a.model_load_filename:
            self.load_weights(a.model_load_filename)
        steps_per_epoch = max(1, self.train_dataset.num_batches(a.train_batch_size))
        eval_steps = a.eval_steps or steps_per_epoch
        self._build_optimizer(steps_per_epoch)

        data_rng = np.random.default_rng(a.seed)
        early_stop = False
        step = 0
        window_acc, window_n, window_t0 = None, 0, time.perf_counter()
        start_step = self._maybe_resume() if a.resume else 0
        # several processes: every one has built its optimizer and restored
        # its state before any enters the first step's collectives
        mesh_mod.coord_barrier("trainer_start")
        # profile_dir: one trace of the first whole eval window after the
        # first (which holds the kernel builds and the allocator's warm-up);
        # closed at that window's end, or where training ends, or raises
        profile, profiled, profile_stop = contextlib.ExitStack(), False, 0
        with profile:
            for epoch in range(int(a.num_train_epochs)):
                if early_stop:
                    break
                batch_iter = self.train_dataset.batches(
                    a.train_batch_size, shuffle=True, rng=data_rng)
                if a.prefetch_batches > 0:
                    from vault_tpu_torch.data.loader import prefetch

                    batch_iter = prefetch(batch_iter, a.prefetch_batches)
                pbar = _progress(batch_iter, a.disable_tqdm or not self.p0,
                                 total=steps_per_epoch,
                                 desc=f"epoch {epoch + 1}/{int(a.num_train_epochs)}")
                for batch, labels in pbar:
                    if step < start_step:  # resume: fast-forward the schedule
                        step += 1
                        continue
                    if a.max_steps > 0 and step >= a.max_steps:
                        logger.info("Forcibly stopping training")
                        early_stop = True
                        break
                    if window_acc is None or step % eval_steps == 0:
                        window_acc = torch.zeros(2, dtype=torch.float32,
                                                 device=self.device)
                        window_n, window_t0 = 0, time.perf_counter()
                        if (a.profile_dir and not profiled
                                and step >= start_step + eval_steps):
                            profile.enter_context(profiling.trace(a.profile_dir))
                            profiled, profile_stop = True, step + eval_steps
                    n = labels.shape[0]
                    batch, labels, weight = self._pad(batch, labels)
                    window_acc += self.train_step(
                        *self._to_device(*self._rows(batch, labels, weight)), step)
                    window_n += n

                    if (step + 1) % eval_steps == 0:
                        # the one host read of the window: it waits for every
                        # step of the window, so the elapsed time is real
                        window_sum, window_mass = window_acc.cpu().numpy()
                        if profile_stop and step + 1 >= profile_stop:
                            profile.close()
                            profile_stop = 0
                            logger.info("profiler trace written to %s", a.profile_dir)
                        self.window_times.append(
                            (time.perf_counter() - window_t0, window_n))
                        results = dict(
                            train_loss=float(window_sum) / max(float(window_mass), 1e-9))
                        if hasattr(pbar, "set_postfix"):
                            pbar.set_postfix(train_loss=f"{results['train_loss']:.4f}")
                        if self.dev_dataset is not None:
                            results.update(self.evaluate(self.dev_dataset))
                        self.exp_handler.set_dict_metrics(results)
                        logger.info("step %d (epoch %d): %s", step + 1, epoch + 1,
                                    results)
                        early_stop = self.early_stopping.step(
                            results.get(a.early_stopping_metric), params=self.params,
                            **{**results, "epoch": epoch + 1,
                               "step": (step + 1) // eval_steps})
                        if early_stop:
                            logger.info("Early stopping at step %d", step + 1)
                            break
                        self._maybe_checkpoint(step + 1)
                    step += 1
                if hasattr(pbar, "close"):
                    pbar.close()

        self._flush_checkpoint()
        if self._ckpt_pool is not None:
            self._ckpt_pool.shutdown()
            self._ckpt_pool = None

        # pairs/s over the windows after the first (which holds the kernel
        # builds and the allocator's warm-up)
        if len(self.window_times) > 1:
            steady = self.window_times[1:]
            self.exp_handler.set_final(
                "train_pairs_per_sec",
                sum(n for _, n in steady) / max(sum(t for t, _ in steady), 1e-9))

        best = self.early_stopping.get_metrics()
        if best is not None:
            self.exp_handler.set_best(best)
        if self.early_stopping.best_params is not None:
            self._assign(self.early_stopping.best_params)

        if self.test_dataset is not None:
            results = self.evaluate(self.test_dataset)
            self.exp_handler.set_dict_metrics(results, test=True)
            logger.info("test: %s", results)

        self.train_end()
        return self.params

    def train_end(self):
        if not self.p0:
            if self.args.model_save:
                self.full_params()  # the shards' gather that rank 0's save enters
            return  # every process holds the same results; only rank 0 writes
        self.exp_handler.log()
        if self.args.model_save:
            self.save_weights(self.exp_handler.model_save_filename)
        self.exp_handler.aggregate_results()
        self.exp_handler.plot()

    @torch.no_grad()
    def eval_forward(self, tree, batch_p, labels_p, weight):
        """Logits (host, every row of the padded batch) and the weighted
        loss sum of one evaluation batch, under the NaN checks while
        ``utils.profiling.enable_nan_checks`` is on (as the JAX package's
        eval step runs under ``jax_debug_nans``).  Over several ranks each
        runs its rows and the logits of every rank are gathered.  One host
        read per batch: the loss rides with the logits."""
        bt, lt, wt = self._to_device(*self._rows(batch_p, labels_p, weight))
        with profiling.nan_checks(), self._parallel():
            logits = self.apply_fn(tree, bt, True, None)
            loss = self.calculate_loss(logits, lt, wt, train=False)
        # the loss is a weighted mean over the valid mass; re-weight by it
        out = torch.cat([logits.float().reshape(-1), loss.float().reshape(1),
                         wt.sum().float().reshape(1)])
        parts = ([out] if self.mesh is None
                 else mesh_mod.all_gather(out, self.mesh.data_group))
        host = [p.cpu().numpy() for p in parts]
        shape = tuple(logits.shape)
        rows = np.concatenate([h[:-2].reshape(shape) for h in host])
        if self.mesh is not None and max(1, self.args.grad_accum_steps) > 1:
            # rows were cut per micro-batch: put them back in batch order
            k = self.args.grad_accum_steps
            rows = rows.reshape(self.dp, k, -1, *shape[1:]).swapaxes(0, 1
                                                                    ).reshape(-1, *shape[1:])
        return rows, sum(float(h[-2]) * float(h[-1]) for h in host)

    @torch.no_grad()
    def evaluate(self, dataset) -> Dict[str, float]:
        a = self.args
        tree = self.compute_params({k: v.detach() for k, v in self.params.items()})
        total_loss, total_mass, preds, trues = 0.0, 0.0, [], []
        for batch, labels in _progress(
                dataset.batches(a.eval_batch_size, shuffle=False),
                a.disable_tqdm or not self.p0,
                total=dataset.num_batches(a.eval_batch_size),
                desc="eval", leave=False):
            n = labels.shape[0]
            batch_p, labels_p, weight = self._pad(batch, labels)
            logits, loss_sum = self.eval_forward(tree, batch_p, labels_p, weight)
            total_loss += loss_sum
            total_mass += float(weight.sum())
            preds.extend(self.get_eval_preds(logits[:n]))
            trues.extend(self.get_eval_true(labels))
        results = dict(eval_loss=total_loss / max(total_mass, 1e-9))
        results.update(self.evaluation_metrics(trues, preds))
        return results

    # ------------------------------------------------------------- helpers
    def _pad(self, batch, labels):
        # rows must split evenly into grad_accum_steps micro-batches, each
        # over the data ranks; padded rows carry weight 0
        multiple = self.dp * max(1, self.args.grad_accum_steps)
        padded, n = pad_to_multiple({**batch, "__labels__": labels}, multiple)
        labels_p = padded.pop("__labels__")
        total = labels_p.shape[0]
        weight = (np.arange(total) < n).astype(np.float32)
        # per-row validity from the dataset folds into the loss weight and
        # never reaches apply_fn
        lw = padded.pop("label_weights", None)
        if lw is not None:
            weight = weight * np.asarray(lw, np.float32)
        return padded, labels_p, weight

    @torch.no_grad()
    def _assign(self, flat: Mapping[str, torch.Tensor]):
        for k, v in flat.items():
            self.params[k].copy_(v)

    # --------------------------------------------------- failure recovery
    @property
    def _ckpt_path(self) -> Optional[str]:
        if self.args.checkpoint_dir is None:
            return None
        return os.path.join(self.args.checkpoint_dir, "last.ckpt")

    def checkpoint_state(self, step: int, as_numpy: bool = False):
        """{params, opt_state, step} in the JAX package's layout, on the
        host."""
        return {"params": params_to_jax(self.params, as_numpy),
                "opt_state": opt_state_to_jax(self.opt_state, as_numpy),
                "step": np.asarray(step)}

    def multihost_state(self, step: int) -> Dict[str, torch.Tensor]:
        """{name: tensor} of this rank for ``torch.distributed.checkpoint``
        (training/checkpoint.py ``save_checkpoint_multihost``): the live
        parameters, moments, count and step, a tensor-parallel rank's names
        tagged ``@m<index>`` and a ZeRO rank's moments ``@d<index>``, so a
        tensor that differs between ranks has a name of its own."""
        m = self.mesh
        tp = f"@m{m.model_index}" if self.tp > 1 else ""
        zero = f"@d{m.data_index}" if self.args.zero_opt else ""
        out = {f"params/{k}{tp}": v for k, v in self.params.items()}
        for name, moments in (("mu", self.opt_state.mu), ("nu", self.opt_state.nu)):
            for k, v in moments.items():
                if isinstance(v, Q8Moment):
                    out[f"{name}/{k}/q{tp}{zero}"] = v.q
                    out[f"{name}/{k}/scale{tp}{zero}"] = v.scale
                else:
                    out[f"{name}/{k}{tp}{zero}"] = v
        dev = next(iter(self.params.values())).device
        out["count"] = torch.tensor([self.opt_state.count], device=dev)
        out["step"] = torch.tensor([step], device=dev)
        return out

    def _maybe_checkpoint(self, step: int):
        path = self._ckpt_path
        if path is None:
            return
        if mesh_mod.world_size() > 1:
            # every rank enters the coordinated save with its own shards
            from vault_tpu_torch.training.checkpoint import save_checkpoint_multihost

            save_checkpoint_multihost(path, self.multihost_state(step))
            return
        from vault_tpu_torch.training.checkpoint import save_checkpoint

        # the copy to the host happens here; the npz write on a background
        # thread (one slot: the previous write finishes first)
        state = self.checkpoint_state(step)
        self._flush_checkpoint()
        if self._ckpt_pool is None:
            from concurrent.futures import ThreadPoolExecutor

            self._ckpt_pool = ThreadPoolExecutor(1, thread_name_prefix="vault-ckpt")
        self._ckpt_future = self._ckpt_pool.submit(save_checkpoint, path, state)

    def _flush_checkpoint(self):
        """Wait for the background checkpoint write (re-raising its
        error)."""
        if self._ckpt_future is not None:
            self._ckpt_future.result()
            self._ckpt_future = None

    def _maybe_resume(self) -> int:
        path = self._ckpt_path
        if path is not None and mesh_mod.world_size() > 1:
            if not os.path.isdir(path):
                return 0
            from vault_tpu_torch.training.checkpoint import restore_checkpoint_multihost

            state = self.multihost_state(0)
            restore_checkpoint_multihost(path, state)
            self.opt_state = AdamWState(int(state["count"].item()),
                                        self.opt_state.mu, self.opt_state.nu)
            step = int(state["step"].item())
            logger.info("resumed (multihost) from %s at step %d", path, step)
            return step
        if path is None or not os.path.exists(path + ".npz"):
            return 0
        from vault_tpu_torch.training.checkpoint import restore_checkpoint

        state = restore_checkpoint(path, self.checkpoint_state(0))
        self._assign(params_from_jax(state["params"]))
        opt = opt_state_from_jax(state["opt_state"])
        with torch.no_grad():
            for mine, theirs in ((self.opt_state.mu, opt.mu),
                                 (self.opt_state.nu, opt.nu)):
                for k, v in mine.items():
                    if isinstance(v, Q8Moment):
                        v.q.copy_(theirs[k].q)
                        v.scale.copy_(theirs[k].scale)
                    else:
                        v.copy_(theirs[k])
        self.opt_state = AdamWState(opt.count, self.opt_state.mu,
                                    self.opt_state.nu)
        step = int(state["step"])
        logger.info("resumed from %s at step %d", path, step)
        return step

    def save_weights(self, path: str):
        """The whole weights as an npz (rank 0 writes; the tensor-parallel
        shards are gathered first, which every rank enters)."""
        from vault_tpu_torch.training.checkpoint import save_checkpoint

        full = self.full_params()
        if self.p0:
            save_checkpoint(path, params_to_jax(full, as_numpy=False))

    def load_weights(self, path: str):
        """Weights from a checkpoint of either package; with
        ``discard_classifier`` the heads keep their current values."""
        from vault_tpu_torch.training.checkpoint import restore_checkpoint

        target = params_to_jax(self.full_params(), as_numpy=False)
        if self.args.discard_classifier:
            target = {k: v for k, v in target.items() if k not in HEAD_KEYS}
        self._assign(self._shard(params_from_jax(restore_checkpoint(path, target))))

    # ---------------------------------------------------------- task hooks
    def calculate_loss(self, logits, labels, weight, train: bool):
        return losses_mod.softmax_cross_entropy(logits, labels, weight)

    def get_eval_preds(self, logits) -> List[int]:
        return np.argmax(logits, axis=-1).tolist()

    def get_eval_true(self, labels) -> List[int]:
        return np.asarray(labels).tolist()

    def evaluation_metrics(self, y_true, y_pred) -> Dict[str, float]:
        return classification_results(y_true, y_pred)
