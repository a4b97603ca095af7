"""The trainer across OS processes (port of ``vault_tpu/parallel/
multihost.py``): the real ``Trainer.train()`` loop, one process per rank
over ``torch.distributed``.

  * every process runs the same deterministic loop (the seeded shuffle gives
    every one the same host batches) and keeps its rows
    (``mesh.shard_batch``);
  * the gradients are summed over the "data" group; only rank 0 writes the
    ExperimentHandler's files; checkpoints go through
    ``torch.distributed.checkpoint``, which every rank enters.

Run a worker by hand (one per rank, the same port):

    python -m vault_tpu_torch.parallel.multihost <rank> <ranks> <port> <outdir> \\
        [--scenario train|ckpt] [--device cpu|cuda:0] [--backend gloo|nccl]

``gloo`` on the CPU (the default), ``gloo`` for ranks that share one card,
``nccl`` across cards.  :func:`spawn_workers` launches them all against a
free local port and waits, with a timeout that kills every worker.
"""

from __future__ import annotations

import json
import os
import sys
import time
from typing import List, Optional


def build_toy(seed: int = 0, dropout: Optional[float] = None,
              params_npz: Optional[str] = None):
    """The tiny deterministic VAuLT setup the workers and their
    single-process reference share: (cfg, params, apply_fn, train_feats,
    train_labels, dev_feats, dev_labels), with the JAX package's geometry
    and the same numpy data.  ``dropout`` overrides every dropout rate (the
    towers' and the head's); ``params_npz`` loads the weights from an npz in
    the JAX package's layout (``training/checkpoint.py``) instead of the
    port's seeded init."""
    import dataclasses

    import numpy as np
    import torch

    from vault_tpu_torch.config import VaultConfig, tiny_text_config, tiny_vilt_config
    from vault_tpu_torch.models.vault import (
        init_classifier_head,
        init_vault,
        vault_for_classification,
    )

    vilt = tiny_vilt_config(image_size=32, patch_size=16, num_patch_tokens=8)
    text = tiny_text_config(num_hidden_layers=1)
    head_dropout = 0.1
    if dropout is not None:
        vilt = dataclasses.replace(vilt, hidden_dropout_prob=dropout,
                                   attention_probs_dropout_prob=dropout)
        text = dataclasses.replace(text, hidden_dropout_prob=dropout,
                                   attention_probs_dropout_prob=dropout)
        head_dropout = dropout
    cfg = VaultConfig(vilt=vilt, text_tower=text)
    gen = torch.Generator().manual_seed(seed)
    params = dict(init_vault(gen, cfg).state_dict())
    params.update({f"head.{k}": v for k, v in init_classifier_head(
        gen, cfg.vilt.hidden_size, 3).state_dict().items()})
    if params_npz is not None:
        from vault_tpu_torch.convert import params_from_jax, params_to_jax
        from vault_tpu_torch.training.checkpoint import restore_checkpoint

        tree = restore_checkpoint(params_npz, params_to_jax(params, as_numpy=False))
        params = params_from_jax(tree, cfg)

    rng = np.random.default_rng(seed)

    def synth(n):
        return {
            "input_ids": rng.integers(0, cfg.text_tower.vocab_size,
                                      (n, 8)).astype(np.int32),
            "attention_mask": np.ones((n, 8), np.int32),
            "token_type_ids": np.zeros((n, 8), np.int32),
            "pixel_values": rng.normal(size=(n, 3, 32, 32)).astype(np.float32),
            "pixel_mask": np.ones((n, 32, 32), np.int32),
        }, rng.integers(0, 3, n)

    train_feats, train_labels = synth(32)
    dev_feats, dev_labels = synth(8)

    def apply_fn(p, batch, deterministic, generator):
        return vault_for_classification(p, cfg, batch, head_dropout=head_dropout,
                                        deterministic=deterministic,
                                        generator=generator)

    from vault_tpu_torch.models.vault import unreached_leaf

    apply_fn.unreached = unreached_leaf(cfg)
    return cfg, params, apply_fn, train_feats, train_labels, dev_feats, dev_labels


def make_trainer(logdir: str, *, num_data: Optional[int] = None, seed: int = 0,
                 max_steps: int = -1, checkpoint_dir=None, resume: bool = False,
                 zero_opt: bool = False, name: str = "multihost", device="cpu",
                 dropout: Optional[float] = None, params_npz: Optional[str] = None,
                 opt_state_dtype: str = "float32", mesh=None,
                 tensor_parallel: bool = False, batch_size: int = 8,
                 grad_accum_steps: int = 1):
    """The toy setup's ``Trainer`` (fp32 moments by default, the JAX
    harness's parity pin) over the initialized world, or ``mesh``."""
    from vault_tpu_torch.data.loader import InMemoryDataset
    from vault_tpu_torch.training.experiment import ExperimentHandler
    from vault_tpu_torch.training.trainer import TrainArgs, Trainer

    (cfg, params, apply_fn, train_feats, train_labels,
     dev_feats, dev_labels) = build_toy(seed, dropout, params_npz)
    args = TrainArgs(lr=1e-3, train_batch_size=batch_size, eval_batch_size=batch_size,
                     num_train_epochs=2, num_data_shards=num_data, seed=seed,
                     max_steps=max_steps, checkpoint_dir=checkpoint_dir,
                     resume=resume, zero_opt=zero_opt, disable_tqdm=True,
                     prefetch_batches=0, opt_state_dtype=opt_state_dtype,
                     grad_accum_steps=grad_accum_steps, remat=False,
                     use_pallas=False)
    return Trainer(apply_fn, params, args,
                   InMemoryDataset(train_feats, train_labels),
                   dev_dataset=InMemoryDataset(dev_feats, dev_labels),
                   exp_handler=ExperimentHandler(logdir, name), device=device,
                   mesh=mesh, tensor_parallel=tensor_parallel)


def run_training(logdir: str, **kw):
    """One whole ``Trainer.train()`` on the toy setup (:func:`make_trainer`'s
    arguments) over the initialized world (one process when there is
    none).  Returns (metric series, the whole final parameters on the
    host).  Deterministic in ``seed``: the dropout masks are drawn over the
    global batch (ops/nn.py ``shard_draws``), so a 2-process run equals one
    process on the same global batches."""
    series, final, _ = _train(logdir, **kw)
    return series, final


def _train(logdir: str, **kw):
    """:func:`run_training`'s (series, final parameters), and the trainer."""
    trainer = make_trainer(logdir, **kw)
    trainer.train()
    final = {k: v.detach().to("cpu", copy=True)
             for k, v in trainer.full_params().items()}
    return dict(trainer.exp_handler._series), final, trainer


def dev_logits(trainer):
    """The logits of the trainer's dev set through its own evaluation path
    (padding, the row cut, the gather and the row order), in the dataset's
    order.  Every rank enters the gather."""
    import numpy as np

    a = trainer.args
    tree = trainer.compute_params({k: v.detach() for k, v in trainer.params.items()})
    out = []
    for batch, labels in trainer.dev_dataset.batches(a.eval_batch_size, shuffle=False):
        logits, _ = trainer.eval_forward(tree, *trainer._pad(batch, labels))
        out.append(logits[:labels.shape[0]])
    return np.concatenate(out)


def _flag(argv: List[str], name: str, default=None):
    return argv[argv.index(name) + 1] if name in argv else default


def worker_main(argv=None):
    """Subprocess entry: ``<rank> <ranks> <port> <outdir> [--scenario
    train|ckpt] [--device D] [--backend B] [--dropout R] [--params NPZ]
    [--batch_size B] [--grad_accum_steps K] [--atol A] [--timeout S]``.

    Joins the group at ``localhost:<port>``, runs the scenario, and (rank
    0) writes ``results.json``, ``params.npz`` and ``dev_logits.npy``
    (:func:`dev_logits`) to ``outdir``.  Scenario
    "ckpt" also runs an interrupted ZeRO run that checkpoints mid-schedule
    through ``torch.distributed.checkpoint`` and a resumed one that
    finishes it; the resumed finals must equal the uninterrupted run's
    within ``--atol`` (default 2e-6, the JAX package's)."""
    argv = list(sys.argv[1:] if argv is None else argv)
    rank, nproc, port, outdir = int(argv[0]), int(argv[1]), argv[2], argv[3]
    scenario = _flag(argv, "--scenario", "train")
    device = _flag(argv, "--device", "cpu")
    backend = _flag(argv, "--backend", "gloo")
    dropout = _flag(argv, "--dropout")
    dropout = None if dropout is None else float(dropout)
    params_npz = _flag(argv, "--params")
    atol = float(_flag(argv, "--atol", "2e-6"))
    timeout = float(_flag(argv, "--timeout", "600"))

    import numpy as np
    import torch

    from vault_tpu_torch.parallel.mesh import coord_barrier, init_distributed

    torch.set_num_threads(max(1, (os.cpu_count() or 2) // max(nproc, 1)))
    init_distributed(f"localhost:{port}", nproc, rank, backend=backend,
                     timeout_s=timeout)
    kw = dict(device=device, dropout=dropout, params_npz=params_npz,
              batch_size=int(_flag(argv, "--batch_size", "8")),
              grad_accum_steps=int(_flag(argv, "--grad_accum_steps", "1")))
    series, final, trainer = _train(os.path.join(outdir, "logs"), **kw)
    logits = dev_logits(trainer)

    if scenario == "ckpt":
        coord_barrier("after_train")
        ckpt = os.path.join(outdir, "ckpt")
        # 2 eval windows in 8 steps: stop after 5 so the step-4 checkpoint is
        # mid-schedule, then resume to the end; ZeRO splits the moments, so
        # each rank holds and writes only its half of them
        run_training(os.path.join(outdir, "logs_int"), max_steps=5,
                     checkpoint_dir=ckpt, zero_opt=True, name="interrupted", **kw)
        coord_barrier("after_interrupted")
        _, resumed = run_training(os.path.join(outdir, "logs_res"),
                                  checkpoint_dir=ckpt, zero_opt=True, resume=True,
                                  name="resumed", **kw)
        worst = max(float((final[k].float() - resumed[k].float()).abs().max())
                    for k in final)
        print(f"RESUME max_abs_diff {worst!r}", flush=True)
        for k, a in final.items():
            np.testing.assert_allclose(a.float().numpy(), resumed[k].float().numpy(),
                                       atol=atol, rtol=0, err_msg=k)

    if rank == 0:
        from vault_tpu_torch.convert import params_to_jax
        from vault_tpu_torch.training.checkpoint import save_checkpoint

        save_checkpoint(os.path.join(outdir, "params.npz"),
                        params_to_jax(final, as_numpy=False))
        np.save(os.path.join(outdir, "dev_logits.npy"), logits)
        with open(os.path.join(outdir, "results.json"), "w") as f:
            json.dump({"series": series}, f)
    coord_barrier("done")
    torch.distributed.destroy_process_group()
    print(f"RESULT {rank} ok", flush=True)


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def spawn_workers(outdir: str, *, num_processes: int = 2, scenario: str = "train",
                  timeout: int = 600, extra: Optional[List[str]] = None,
                  module: str = "vault_tpu_torch.parallel.multihost") -> List[str]:
    """Launch ``num_processes`` workers (``python -m <module> <rank> ...``)
    against a free local port and wait; returns their logs.  Their output
    goes to files, not pipes (a worker that filled a pipe would block
    mid-collective).  On a timeout every worker is killed and the error
    carries their logs; a worker that fails raises with its log.  Build the
    kernels before calling (``ops._build.build_all``) when the workers run
    on the card, so they do not all build them."""
    import subprocess

    os.makedirs(outdir, exist_ok=True)
    port = free_port()
    repo = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    env = dict(os.environ)
    env["PYTHONPATH"] = repo + os.pathsep + env.get("PYTHONPATH", "")
    logs = [open(os.path.join(outdir, f"worker{i}.log"), "w+")
            for i in range(num_processes)]
    procs = [subprocess.Popen(
        [sys.executable, "-m", module, str(i), str(num_processes), str(port), outdir,
         "--scenario", scenario, "--timeout", str(timeout)] + list(extra or []),
        env=env, stdout=logs[i], stderr=subprocess.STDOUT, text=True)
        for i in range(num_processes)]
    timed_out = False
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            try:
                p.wait(timeout=max(0.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                timed_out = True
                break
    finally:
        for p in procs:  # never leave a worker holding the port
            if p.poll() is None:
                p.kill()
                p.wait()
    outs = []
    for f in logs:
        f.seek(0)
        outs.append(f.read())
        f.close()
    if timed_out:
        raise RuntimeError(
            f"workers timed out after {timeout}s (a deadlocked collective?); "
            "worker logs:\n" + "\n---\n".join(o[-2000:] for o in outs))
    for i, (p, out) in enumerate(zip(procs, outs)):
        if p.returncode != 0 or f"RESULT {i} ok" not in out:
            raise RuntimeError(f"worker {i} failed (exit {p.returncode}):\n{out[-4000:]}")
    return outs


if __name__ == "__main__":
    worker_main()
