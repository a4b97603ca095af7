"""The port's parallel layer across processes: gloo ranks on the CPU at tiny
size, each case with its own group timeout and join timeout (a deadlocked
collective fails instead of hanging) on a port found by binding port 0.

Against the JAX package (on the 8 virtual CPU devices, without dropout,
which the JAX package draws its own way): the explicit-collective step on
2 ranks against ``make_shard_map_train_step`` on a 2-device mesh, the
data-parallel trainer on 2 ranks against the JAX trainer with
``num_data_shards=2``, and one tensor-parallel step on a 1 x 2 mesh.
Against the port's own single process: 2 ranks with dropout equal one
process on the same global batch; ZeRO-1 equals data parallelism bit for
bit with fp32, bf16 and int8 moments; a resume through
``torch.distributed.checkpoint`` equals the uninterrupted run; and the
four-leg dry run.
"""

import json
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from vault_tpu.config import VaultConfig as JVaultConfig
from vault_tpu.config import tiny_text_config as j_tiny_text
from vault_tpu.config import tiny_vilt_config as j_tiny_vilt
from vault_tpu.data.loader import InMemoryDataset as JDataset
from vault_tpu.models import vault as jvault
from vault_tpu.parallel import mesh as jmesh
from vault_tpu.parallel.shard_map_step import make_shard_map_train_step as j_shard_map_step
from vault_tpu.training import checkpoint as jckpt
from vault_tpu.training import optimizer as jopt
from vault_tpu.training.experiment import ExperimentHandler as JHandler
from vault_tpu.training.trainer import TrainArgs as JTrainArgs
from vault_tpu.training.trainer import Trainer as JTrainer
from vault_tpu_torch.parallel.multihost import build_toy, run_training, spawn_workers
from vault_tpu_torch.training.checkpoint import _flatten

TESTS = os.path.dirname(os.path.abspath(__file__))
TIMEOUT = 300  # seconds: each worker's group timeout and the join timeout


@pytest.fixture
def workers(monkeypatch, tmp_path):
    """``run(scenario, n=2, module=..., extra=[...])``: spawn the ranks and
    return their output directory."""
    monkeypatch.setenv("PYTHONPATH", TESTS + os.pathsep + os.environ.get("PYTHONPATH", ""))

    def run(scenario, n=2, module="torch_parallel_worker", extra=()):
        out = tmp_path / scenario
        spawn_workers(str(out), num_processes=n, scenario=scenario, timeout=TIMEOUT,
                      extra=list(extra), module=module)
        return out

    return run


def _jax_toy():
    """The JAX package's counterpart of ``multihost.build_toy(dropout=0)``:
    its config, its seeded weights, an apply_fn, and the toy's numpy data."""
    text = dict(num_hidden_layers=1, hidden_dropout_prob=0.0,
                attention_probs_dropout_prob=0.0)
    vilt = dict(image_size=32, patch_size=16, num_patch_tokens=8,
                hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
    cfg = JVaultConfig(vilt=j_tiny_vilt(**vilt), text_tower=j_tiny_text(**text))
    params = jvault.init_vault(jax.random.PRNGKey(0), cfg)
    params["head"] = jvault.init_classifier_head(jax.random.PRNGKey(1),
                                                 cfg.vilt.hidden_size, 3)
    params = jax.tree.map(np.asarray, params)

    def apply_fn(p, batch, deterministic, rng):
        return jvault.vault_for_classification(p, cfg, batch, head_dropout=0.0,
                                               deterministic=deterministic, rng=rng,
                                               use_pallas=False)

    _, _, _, feats, labels, dev_feats, dev_labels = build_toy(0, dropout=0.0)
    return cfg, params, apply_fn, feats, labels, dev_feats, dev_labels


def _save_params(tmp_path, params):
    path = str(tmp_path / "jax_params.npz")
    jckpt.save_checkpoint(path, params)
    return path


def _assert_params_close(npz, ref_tree, atol):
    data = np.load(npz)
    flat = _flatten(jax.tree.map(np.asarray, ref_tree))
    worst = max(float(np.abs(np.asarray(data[k], np.float32) - np.asarray(v, np.float32)).max())
                for k, v in flat.items())
    assert worst <= atol, worst


# ------------------------------------------------------ against the JAX package

def test_shard_map_step_matches_jax(tmp_path, workers):
    """Two explicit-collective steps, 4 rows a rank, against the JAX
    package's ``make_shard_map_train_step`` on a 2-device mesh (fp32 moments,
    no dropout): losses atol 1e-6, parameters atol 2e-6 (two Adam steps of
    lr 1e-3; the gradient sums in other orders)."""
    cfg, params, apply_fn, feats, labels, _, _ = _jax_toy()
    mesh = jmesh.make_mesh(num_data=2)
    tx = jopt.hf_adamw(1e-3, state_dtype=jnp.float32)

    def per_example(logits, lab):
        return -jnp.take_along_axis(jax.nn.log_softmax(logits.astype(jnp.float32)),
                                    lab[:, None], axis=-1)[:, 0]

    step = j_shard_map_step(apply_fn, per_example, tx, mesh)
    p = jax.tree.map(jnp.asarray, params)
    opt = tx.init(p)
    losses = []
    for i in range(2):
        sl = slice(8 * i, 8 * i + 8)
        b = jmesh.shard_batch(mesh, {k: v[sl] for k, v in feats.items()})
        lab = jmesh.shard_batch(mesh, labels[sl])
        w = jmesh.shard_batch(mesh, np.ones(8, np.float32))
        p, opt, loss = step(p, opt, b, lab, w, jax.random.PRNGKey(i))
        losses.append(float(loss))

    out = workers("shard_map", extra=["--params", _save_params(tmp_path, params)])
    ours = json.loads((out / "losses.json").read_text())
    np.testing.assert_allclose(ours, losses, atol=1e-6)
    _assert_params_close(out / "params.npz", p, atol=2e-6)


def test_dp_trainer_matches_jax(tmp_path, workers):
    """``Trainer.train()`` on 2 ranks (the multihost harness, 8 steps of 8
    rows, a dev evaluation per epoch) against the JAX trainer with
    ``num_data_shards=2`` on the same weights, data and shuffle, fp32
    moments, no dropout: train and eval losses atol 1e-6, parameters atol
    2e-6 (measured 1.2e-7 and 2.5e-7: the gradient sums in other
    orders)."""
    cfg, params, apply_fn, feats, labels, dev_feats, dev_labels = _jax_toy()
    handler = JHandler(str(tmp_path / "jax"), "toy")
    args = JTrainArgs(lr=1e-3, train_batch_size=8, eval_batch_size=8, num_train_epochs=2,
                      num_data_shards=2, seed=0, disable_tqdm=True, prefetch_batches=0,
                      opt_state_dtype="float32")
    final = JTrainer(apply_fn, jax.tree.map(jnp.asarray, params), args,
                     JDataset(feats, labels), dev_dataset=JDataset(dev_feats, dev_labels),
                     exp_handler=handler).train()

    out = workers("train", module="vault_tpu_torch.parallel.multihost",
                  extra=["--dropout", "0", "--params", _save_params(tmp_path, params)])
    series = json.loads((out / "results.json").read_text())["series"]
    for key in ("train_loss", "eval_loss"):
        assert len(series[key]) == len(handler._series[key]) == 2
        np.testing.assert_allclose(series[key], handler._series[key], atol=1e-6)
    _assert_params_close(out / "params.npz", final, atol=2e-6)


def test_dp_trainer_grad_accum_matches_jax(tmp_path, workers):
    """As ``test_dp_trainer_matches_jax`` with 2 micro-batches a step and
    batches of 6 rows (the last train and dev batches padded: to 4 rows, 2
    micro-batches of 1 row a rank), so the per-micro-batch row cut, the one
    all-reduce after the micro-batches and the evaluation's row order are
    held against the JAX trainer with ``num_data_shards=2`` and
    ``grad_accum_steps=2``: train and eval losses and the eval metrics atol
    1e-6, parameters atol 2e-6, and the dev logits from the port's
    evaluation path against the JAX forward of the final parameters, row
    for row, atol 1e-5."""
    cfg, params, apply_fn, feats, labels, dev_feats, dev_labels = _jax_toy()
    handler = JHandler(str(tmp_path / "jax"), "toy")
    args = JTrainArgs(lr=1e-3, train_batch_size=6, eval_batch_size=6, num_train_epochs=2,
                      num_data_shards=2, grad_accum_steps=2, seed=0, disable_tqdm=True,
                      prefetch_batches=0, opt_state_dtype="float32")
    final = JTrainer(apply_fn, jax.tree.map(jnp.asarray, params), args,
                     JDataset(feats, labels), dev_dataset=JDataset(dev_feats, dev_labels),
                     exp_handler=handler).train()

    out = workers("train", module="vault_tpu_torch.parallel.multihost",
                  extra=["--dropout", "0", "--params", _save_params(tmp_path, params),
                         "--batch_size", "6", "--grad_accum_steps", "2"])
    results = json.loads((out / "results.json").read_text())["series"]
    for key in ("train_loss", "eval_loss", "eval_accuracy", "macro_f1_score"):
        assert len(results[key]) == len(handler._series[key]) == 2, key
        np.testing.assert_allclose(results[key], handler._series[key], atol=1e-6)
    _assert_params_close(out / "params.npz", final, atol=2e-6)
    # the trainer's evaluation path, row for row, against the final
    # parameters' forward: atol 1e-5
    want = np.asarray(apply_fn(final, dev_feats, deterministic=True, rng=None))
    np.testing.assert_allclose(np.load(out / "dev_logits.npy"), want, atol=1e-5)


def test_tp_step_matches_jax(tmp_path, workers):
    """One step with the encoder layers Megatron-sharded over 2 ranks (a
    1 x 2 mesh; column shards with the conjugate all-reduce, row shards
    summed before the bias) against the JAX trainer's step on a 1 x 2 mesh
    with ``tensor_parallel=True``: loss atol 1e-6, parameters atol 2e-6."""
    cfg, params, apply_fn, feats, labels, _, _ = _jax_toy()
    mesh = jmesh.make_mesh(num_data=1, num_model=2)
    args = JTrainArgs(lr=1e-3, train_batch_size=8, num_train_epochs=1, seed=0,
                      opt_state_dtype="float32", disable_tqdm=True)
    tr = JTrainer(apply_fn, jax.tree.map(jnp.asarray, params), args,
                  JDataset(feats, labels), exp_handler=JHandler(str(tmp_path / "j"), "t"),
                  mesh=mesh, tensor_parallel=True)
    tr._build_steps(1)
    b, lab, w = tr._pad({k: v[:8] for k, v in feats.items()}, labels[:8])
    new, _, acc = tr._train_step(tr.params, tr.opt_state, jnp.zeros((2,), jnp.float32),
                                 jmesh.shard_batch(mesh, b), jmesh.shard_batch(mesh, lab),
                                 jmesh.shard_batch(mesh, w), jax.random.PRNGKey(0))
    out = workers("tp_step", extra=["--params", _save_params(tmp_path, params)])
    loss = json.loads((out / "loss.json").read_text())
    np.testing.assert_allclose(loss, float(acc[0] / acc[1]), atol=1e-6)
    _assert_params_close(out / "params.npz", new, atol=2e-6)


# ------------------------------------------------------ against one process

def test_two_ranks_with_dropout_equal_one_process(tmp_path, workers):
    """Dropout 0.1 everywhere: each rank draws the masks of the whole batch
    and keeps its rows, so 2 ranks equal one process on the same global
    batches (fp32, atol 1e-6), and the masks matter (the run without
    dropout ends more than 1e-4 away)."""
    out = workers("train", module="vault_tpu_torch.parallel.multihost",
                  extra=["--dropout", "0.1"])
    series, final = run_training(str(tmp_path / "one"), dropout=0.1)
    _, plain = run_training(str(tmp_path / "none"), dropout=0.0)
    data = np.load(out / "params.npz")
    from vault_tpu_torch.convert import params_to_jax

    flat = _flatten(params_to_jax(final))
    worst = max(float(np.abs(data[k] - v).max()) for k, v in flat.items())
    assert worst <= 1e-6, worst
    ranks = json.loads((out / "results.json").read_text())["series"]
    np.testing.assert_allclose(ranks["train_loss"], series["train_loss"], atol=1e-6)
    assert max(float((final[k] - plain[k]).abs().max()) for k in final) > 1e-4


def test_zero_equals_dp_bit_for_bit(workers):
    """ZeRO-1 against plain data parallelism, a whole ``Trainer.train()``
    each (8 steps, dropout on), with fp32, bf16 and int8 moments: every
    parameter and each rank's moment slices bit-equal; each rank holds
    0.4-0.6 of the moment bytes (about half: at this size a leaf that the
    split does not divide, or an int8 leaf of one block, stays on one
    rank)."""
    out = workers("zero", extra=["--dtypes", "float32,bfloat16,int8"])
    for rank in (0, 1):
        res = json.loads((out / f"zero_rank{rank}.json").read_text())
        assert set(res) == {"float32", "bfloat16", "int8"}
        for dtype, r in res.items():
            assert r["unequal"] == [], (rank, dtype, r["unequal"][:4])
            assert r["steps"] == 8
            assert 0.4 <= r["zero_bytes"] / r["dp_bytes"] <= 0.6, (dtype, r)


def test_checkpoint_resume_equals_uninterrupted(workers):
    """The multihost ``ckpt`` scenario: an interrupted ZeRO run
    checkpoints at step 4 through ``torch.distributed.checkpoint`` (each
    rank writing its moment halves), a resumed run finishes; its finals
    equal the uninterrupted run's within atol 2e-6 (the JAX package's)."""
    out = workers("ckpt", module="vault_tpu_torch.parallel.multihost")
    logs = [(out / f"worker{i}.log").read_text() for i in (0, 1)]
    diffs = [float(line.split()[-1]) for log in logs for line in log.splitlines()
             if line.startswith("RESUME max_abs_diff")]
    assert len(diffs) == 2 and max(diffs) <= 2e-6, diffs
    assert (out / "ckpt" / "last.ckpt" / ".metadata").exists()


def test_worker_timeout_kills_and_reports(tmp_path, monkeypatch):
    """A rank that never joins leaves the other waiting: the join timeout
    kills every worker and the error carries their logs."""
    monkeypatch.setenv("PYTHONPATH", TESTS + os.pathsep + os.environ.get("PYTHONPATH", ""))
    with pytest.raises(RuntimeError, match="timed out"):
        spawn_workers(str(tmp_path / "hang"), num_processes=2, scenario="shard_map",
                      timeout=15, module="torch_parallel_worker",
                      extra=["--never-joins"])


def test_dryrun_multichip_4():
    """``parallel.dryrun.dryrun_multichip(4)``: the DP x TP x ZeRO step on
    4 gloo ranks against one process (atol 2e-5), the pipeline, the
    multihost trainer and the Llama TP forward (atol 1e-5)."""
    from vault_tpu_torch.parallel.dryrun import STEP_ATOL, dryrun_multichip

    res = dryrun_multichip(4, timeout=TIMEOUT)
    assert res["dp_tp_zero_step"] <= STEP_ATOL
    assert res["llama_tp"] is not None and res["llama_tp"] <= 1e-5
    assert res["pipeline"] <= 1e-5 and res["multihost"] == "ok"
