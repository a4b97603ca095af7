"""Rank processes for tests/test_torch_parallel_ranks.py (not a test file:
it imports neither JAX nor pytest).

    python -m torch_parallel_worker <rank> <ranks> <port> <outdir> \\
        --scenario <name> --timeout <s> [--params NPZ] [--dtypes a,b]

Each rank joins a gloo group on the CPU (its own timeout), runs the
scenario, and rank 0 writes the results to ``<outdir>``.  The toy setup is
``vault_tpu_torch.parallel.multihost``'s.
"""

import json
import os
import sys
import time

import torch


def _flag(argv, name, default=None):
    return argv[argv.index(name) + 1] if name in argv else default


def shard_map(rank, outdir, argv):
    """Two explicit-collective steps on 8 rows (4 a rank), fp32 moments,
    without dropout."""
    from vault_tpu_torch.convert import params_to_jax
    from vault_tpu_torch.parallel.mesh import make_mesh, shard_batch
    from vault_tpu_torch.parallel.multihost import build_toy
    from vault_tpu_torch.parallel.shard_map_step import make_shard_map_train_step
    from vault_tpu_torch.training.checkpoint import save_checkpoint
    from vault_tpu_torch.training.optimizer import hf_adamw

    cfg, params, apply_fn, feats, labels, _, _ = build_toy(0, 0.0, _flag(argv, "--params"))
    mesh = make_mesh(2)
    params = {k: v.clone().requires_grad_(v.is_floating_point()) for k, v in params.items()}
    tx = hf_adamw(1e-3, state_dtype=torch.float32)
    opt = tx.init({k: v for k, v in params.items() if v.requires_grad})

    def per_example(logits, lab):
        return -torch.log_softmax(logits.float(), -1).gather(1, lab[:, None])[:, 0]

    step = make_shard_map_train_step(apply_fn, per_example, tx, mesh)
    losses = []
    for i in range(2):
        sl = slice(8 * i, 8 * i + 8)
        b = {k: torch.as_tensor(v) for k, v in
             shard_batch(mesh, {k: v[sl] for k, v in feats.items()}).items()}
        lab = torch.as_tensor(shard_batch(mesh, labels[sl]))
        w = torch.ones(lab.shape[0])
        params, opt, loss = step(params, opt, b, lab, w)
        losses.append(float(loss))
    if rank == 0:
        save_checkpoint(os.path.join(outdir, "params.npz"), params_to_jax(params))
        with open(os.path.join(outdir, "losses.json"), "w") as f:
            json.dump(losses, f)


def zero(rank, outdir, argv):
    """Plain data parallelism, then ZeRO-1, each a whole ``Trainer.train()``
    with dropout, per moment dtype: parameters and this rank's moment
    slices compared bit for bit, and the moment bytes of each."""
    from vault_tpu_torch.parallel.multihost import make_trainer
    from vault_tpu_torch.parallel.zero import block_range, moment_bytes
    from vault_tpu_torch.training.optimizer import Q8Moment

    out = {}
    for dtype in _flag(argv, "--dtypes").split(","):
        trs = {}
        for z in (False, True):
            trs[z] = make_trainer(os.path.join(outdir, f"{dtype}_{z}"), zero_opt=z,
                                  opt_state_dtype=dtype, dropout=0.1)
            trs[z].train()
        dp, zr = trs[False], trs[True]
        unequal = [k for k, v in dp.params.items() if not torch.equal(v, zr.params[k])]
        for name in ("mu", "nu"):
            for k, full in getattr(dp.opt_state, name).items():
                part = getattr(zr.opt_state, name)[k]
                if isinstance(full, Q8Moment):
                    lo, hi = block_range(full.q.shape[0], zr.tx.index, zr.tx.dp)
                    same = (torch.equal(part.q, full.q[lo:hi])
                            and torch.equal(part.scale, full.scale[lo:hi]))
                else:
                    same = torch.equal(part, zr.tx._slice(full))
                if not same:
                    unequal.append(f"{name}/{k}")
        out[dtype] = dict(unequal=unequal, leaves=len(dp.params),
                          dp_bytes=moment_bytes(dp.opt_state),
                          zero_bytes=moment_bytes(zr.opt_state),
                          steps=zr.opt_state.count)
    with open(os.path.join(outdir, f"zero_rank{rank}.json"), "w") as f:
        json.dump(out, f)


def tp_step(rank, outdir, argv):
    """One tensor-parallel step (a 1 x 2 mesh) on 8 rows without dropout;
    rank 0 writes the whole parameters and the loss."""
    from vault_tpu_torch.convert import params_to_jax
    from vault_tpu_torch.parallel.mesh import make_mesh
    from vault_tpu_torch.parallel.multihost import make_trainer
    from vault_tpu_torch.training.checkpoint import save_checkpoint

    tr = make_trainer(os.path.join(outdir, "logs"), dropout=0.0,
                      params_npz=_flag(argv, "--params"), mesh=make_mesh(1, 2),
                      tensor_parallel=True)
    tr.args.num_train_epochs = 1
    tr._build_optimizer(1)
    feats, labels = next(iter(tr.train_dataset.batches(8, shuffle=False)))
    b, lab, w = tr._pad(feats, labels)
    acc = tr.train_step(*tr._to_device(*tr._rows(b, lab, w)), 0)
    full = tr.full_params()
    if rank == 0:
        save_checkpoint(os.path.join(outdir, "params.npz"), params_to_jax(full))
        with open(os.path.join(outdir, "loss.json"), "w") as f:
            json.dump(float(acc[0] / acc[1]), f)


SCENARIOS = {"shard_map": shard_map, "zero": zero, "tp_step": tp_step}


def main(argv):
    rank, nproc, port, outdir = int(argv[0]), int(argv[1]), argv[2], argv[3]
    from vault_tpu_torch.parallel.mesh import coord_barrier, init_distributed

    torch.set_num_threads(1)
    if "--never-joins" in argv and rank == 1:
        time.sleep(3600)  # a rank that never reaches the group
    init_distributed(f"localhost:{port}", nproc, rank, backend="gloo",
                     timeout_s=float(_flag(argv, "--timeout", "300")))
    SCENARIOS[_flag(argv, "--scenario")](rank, outdir, argv)
    coord_barrier("done", timeout_ms=60_000)
    torch.distributed.destroy_process_group()
    print(f"RESULT {rank} ok", flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
