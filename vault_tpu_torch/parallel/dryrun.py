"""The multi-rank dry run (port of ``__graft_entry__.dryrun_multichip``):
``n`` gloo ranks on the CPU, tiny shapes, four legs.

  1. one DP x TP x ZeRO train step (data n/2, model 2; ToMe merging to 5
     patch tokens, dropout on) against one process on the same global
     batch;
  2. the trainable 2-stage pipeline against a one-device step;
  3. the multi-process ``Trainer.train()`` (parallel/multihost.py, 2
     ranks);
  4. the tensor-parallel forward of the Llama tower against its unsharded
     forward.

    python -m vault_tpu_torch.parallel.dryrun 4

Legs 1 and 4 run in the spawned ranks (``python -m
vault_tpu_torch.parallel.dryrun <rank> <ranks> <port> <outdir>``); the
parent compares leg 1 with its own one-process step and runs legs 2 and 3.
"""

from __future__ import annotations

import os
import sys
import tempfile

STEP_ATOL = 2e-5


def _setup(n: int):
    """(cfg, params, apply_fn, feats, labels): the multihost toy, a global
    batch of ``2 n`` rows, and an ``apply_fn`` that merges the 8 patch
    tokens to 5 (trainable ToMe under the sharded step)."""
    import numpy as np

    from vault_tpu_torch.models.vault import unreached_leaf, vault_for_classification
    from vault_tpu_torch.parallel.multihost import build_toy

    cfg, params, _, _, _, _, _ = build_toy(0)
    rng = np.random.default_rng(0)
    rows = 2 * n
    feats = {
        "input_ids": rng.integers(0, cfg.text_tower.vocab_size, (rows, 8)).astype(np.int32),
        "attention_mask": np.ones((rows, 8), np.int32),
        "token_type_ids": np.zeros((rows, 8), np.int32),
        "pixel_values": rng.normal(size=(rows, 3, 32, 32)).astype(np.float32),
        "pixel_mask": np.ones((rows, 32, 32), np.int32),
    }
    labels = rng.integers(0, 3, rows)

    def apply_fn(p, batch, deterministic, generator):
        return vault_for_classification(p, cfg, batch, head_dropout=0.1,
                                        deterministic=deterministic,
                                        generator=generator, merge_patches_to=5)

    apply_fn.unreached = unreached_leaf(cfg)
    return cfg, params, apply_fn, feats, labels


def one_step(n: int, mesh=None, tensor_parallel: bool = False):
    """Leg 1's step: a Trainer on ``mesh`` (one process when None) takes
    one optimizer step on the global batch.  Returns (loss, the whole
    parameters on the host)."""
    import numpy as np

    from vault_tpu_torch.data.loader import InMemoryDataset
    from vault_tpu_torch.training.experiment import ExperimentHandler
    from vault_tpu_torch.training.trainer import TrainArgs, Trainer

    cfg, params, apply_fn, feats, labels = _setup(n)
    args = TrainArgs(lr=1e-3, train_batch_size=2 * n, num_train_epochs=1, max_steps=1,
                     zero_opt=mesh is not None and mesh.num_data > 1,
                     opt_state_dtype="float32", remat=True, use_pallas=False,
                     disable_tqdm=True, prefetch_batches=0)
    trainer = Trainer(apply_fn, params, args, InMemoryDataset(feats, labels),
                      exp_handler=ExperimentHandler(tempfile.gettempdir(), "dryrun"),
                      mesh=mesh, tensor_parallel=tensor_parallel, device="cpu")
    trainer._build_optimizer(1)
    b, lab, w = trainer._pad(feats, labels)
    acc = trainer.train_step(*trainer._to_device(*trainer._rows(b, lab, w)), 0)
    loss = float(acc[0] / acc[1])
    assert np.isfinite(loss), loss
    return loss, {k: v.detach().to("cpu", copy=True)
                  for k, v in trainer.full_params().items()}


def llama_tp_check(mesh):
    """Leg 4: the Llama tower feeding ViLT, its layers sharded over the
    mesh's "model" group, against the unsharded forward on this rank."""
    import numpy as np
    import torch

    from vault_tpu_torch.config import tiny_vilt_config
    from vault_tpu_torch.convert import param_tree
    from vault_tpu_torch.models import llama as llama_mod
    from vault_tpu_torch.models import vilt as vilt_mod
    from vault_tpu_torch.models.vault import vault_with_llama_tower
    from vault_tpu_torch.parallel.sharding import shard_params
    from vault_tpu_torch.parallel.tensor_parallel import ProcessTP, use_tp

    lcfg = llama_mod.tiny_llama_config()
    vcfg = tiny_vilt_config(image_size=32, patch_size=16, num_patch_tokens=8)
    gen = torch.Generator().manual_seed(2)
    params = {f"llama.{k}": v for k, v in
              llama_mod.init_llama(gen, lcfg).state_dict().items()}
    params.update({f"lm_proj.{k}": v for k, v in llama_mod.init_lm_projection(
        gen, lcfg.hidden_size, vcfg.hidden_size).state_dict().items()})
    params.update({f"vilt.{k}": v for k, v in vilt_mod.init_vilt(gen, vcfg)
                   .state_dict().items()})
    rng = np.random.default_rng(3)
    batch = dict(input_ids=torch.as_tensor(rng.integers(0, lcfg.vocab_size, (4, 8))),
                 attention_mask=torch.ones((4, 8), dtype=torch.int64),
                 pixel_values=torch.as_tensor(rng.normal(size=(4, 3, 32, 32)),
                                              dtype=torch.float32),
                 pixel_mask=torch.ones((4, 32, 32), dtype=torch.int64))
    with torch.no_grad():
        full = vault_with_llama_tower(param_tree(params), vcfg, lcfg,
                                      use_pallas=False, **batch).pooler_output
        shards = shard_params(params, mesh.model_index, mesh.num_model)
        with use_tp(ProcessTP(mesh.model_group)):
            tp = vault_with_llama_tower(param_tree(shards), vcfg, lcfg,
                                        use_pallas=False, **batch).pooler_output
    diff = float((full - tp).abs().max())
    assert diff <= 1e-5, f"Llama TP forward differs from the unsharded one by {diff}"
    return diff


def worker_main(argv=None):
    """A rank of legs 1 and 4: ``<rank> <ranks> <port> <outdir>``."""
    argv = list(sys.argv[1:] if argv is None else argv)
    rank, nproc, port, outdir = int(argv[0]), int(argv[1]), argv[2], argv[3]
    timeout = float(argv[argv.index("--timeout") + 1]) if "--timeout" in argv else 600.0

    import torch

    from vault_tpu_torch.convert import params_to_jax
    from vault_tpu_torch.parallel.mesh import coord_barrier, init_distributed, make_mesh
    from vault_tpu_torch.training.checkpoint import save_checkpoint

    torch.set_num_threads(1)
    init_distributed(f"localhost:{port}", nproc, rank, backend="gloo", timeout_s=timeout)
    num_model = 2 if nproc % 2 == 0 else 1
    mesh = make_mesh(nproc // num_model, num_model)
    loss, final = one_step(nproc, mesh, tensor_parallel=num_model > 1)
    if num_model > 1:
        diff = llama_tp_check(mesh)
        print(f"LLAMA_TP max_abs_diff {diff!r}", flush=True)
    if rank == 0:
        save_checkpoint(os.path.join(outdir, "step.npz"),
                        {"loss": torch.tensor(loss),
                         "params": params_to_jax(final, as_numpy=False)})
    coord_barrier("done")
    torch.distributed.destroy_process_group()
    print(f"RESULT {rank} ok", flush=True)


def pipeline_check():
    """Leg 2: the trainable pipeline on two stages (both on the CPU)
    against one device's loss and gradients."""
    import numpy as np
    import torch

    from vault_tpu_torch.convert import param_tree
    from vault_tpu_torch.models.vault import vault_for_classification
    from vault_tpu_torch.parallel.pipeline import (
        make_pipeline_train_fn,
        place_pipeline_params,
    )
    from vault_tpu_torch.training.losses import softmax_cross_entropy

    cfg, params, _, feats, labels = _setup(2)
    cpu = torch.device("cpu")
    placed = place_pipeline_params(params, cpu, cpu)
    fn = make_pipeline_train_fn(cfg, softmax_cross_entropy, lm_device=cpu,
                                vilt_device=cpu, num_micro=2, use_pallas=False)
    batch = {k: v[:4] for k, v in feats.items()}
    weight = np.ones(4, np.float32)
    loss, grads = fn(placed, batch, labels[:4], weight)
    ref = {k: v.detach().clone().requires_grad_(v.is_floating_point())
           for k, v in params.items()}
    logits = vault_for_classification(
        param_tree(ref), cfg, {k: torch.as_tensor(v) for k, v in batch.items()},
        head_dropout=0.0, deterministic=True, use_pallas=False)
    ref_loss = softmax_cross_entropy(logits, torch.as_tensor(labels[:4]),
                                     torch.as_tensor(weight))
    ref_grads = torch.autograd.grad(ref_loss, [ref[k] for k in grads],
                                    allow_unused=True)
    worst = max(float((g - (0.0 if r is None else r)).abs().max())
                for g, r in zip(grads.values(), ref_grads))
    assert abs(float(loss) - float(ref_loss)) <= 1e-5 and worst <= 1e-5, (
        float(loss), float(ref_loss), worst)
    return worst


def dryrun_multichip(n: int, timeout: int = 600) -> dict:
    """The four legs over ``n`` gloo CPU ranks; raises on any failure.
    Returns each leg's largest difference."""
    import numpy as np

    from vault_tpu_torch.parallel.multihost import spawn_workers
    from vault_tpu_torch.training.checkpoint import _flatten

    out = {}
    with tempfile.TemporaryDirectory(prefix="dryrun_") as tmp:
        logs = spawn_workers(os.path.join(tmp, "ranks"), num_processes=n,
                             scenario="step", timeout=timeout,
                             module="vault_tpu_torch.parallel.dryrun")
        data = np.load(os.path.join(tmp, "ranks", "step.npz"))
        from vault_tpu_torch.convert import params_to_jax

        loss, ref = one_step(n)
        ref_flat = _flatten(params_to_jax(ref))
        worst = max(float(np.abs(data[f"params/{k}"] - v).max())
                    for k, v in ref_flat.items())
        assert worst <= STEP_ATOL, f"DP x TP x ZeRO step differs by {worst}"
        assert abs(float(data["loss"]) - loss) <= STEP_ATOL, (float(data["loss"]), loss)
        out["dp_tp_zero_step"] = worst
        out["llama_tp"] = max((float(line.split()[-1]) for log in logs
                               for line in log.splitlines()
                               if line.startswith("LLAMA_TP")), default=None)
        out["pipeline"] = pipeline_check()
        spawn_workers(os.path.join(tmp, "multihost"), num_processes=2,
                      scenario="train", timeout=timeout)
        out["multihost"] = "ok"
    return out


if __name__ == "__main__":
    args = sys.argv[1:]
    if len(args) >= 4:
        worker_main(args)
    else:
        print(dryrun_multichip(int(args[0]) if args else 4), flush=True)
