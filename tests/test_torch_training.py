"""The port's training stack against the JAX package's, on the CPU at tiny
size: optimizer and schedule, losses, metrics, the Trainer's loss curve,
gradient accumulation, remat with dropout, checkpoints across the two
packages, resume, and the experiment handler's files.

Inputs are made with numpy from a seed and handed to both packages.
Tolerances are stated at each test.
"""

import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from vault_tpu.config import VaultConfig as JVaultConfig
from vault_tpu.config import tiny_text_config as j_tiny_text
from vault_tpu.config import tiny_vilt_config as j_tiny_vilt
from vault_tpu.data.loader import InMemoryDataset as JDataset
from vault_tpu.models import vault as jvault
from vault_tpu.training import checkpoint as jckpt
from vault_tpu.training import losses as jlosses
from vault_tpu.training import metrics as jmetrics
from vault_tpu.training import optimizer as jopt
from vault_tpu.training.experiment import ExperimentHandler as JHandler
from vault_tpu.training.trainer import TrainArgs as JTrainArgs
from vault_tpu.training.trainer import Trainer as JTrainer
from vault_tpu_torch.config import VaultConfig, tiny_text_config, tiny_vilt_config
from vault_tpu_torch.convert import (
    opt_state_from_jax,
    opt_state_to_jax,
    params_from_jax,
    to_numpy,
)
from vault_tpu_torch.data.loader import InMemoryDataset, prefetch
from vault_tpu_torch.models import vault as tvault
from vault_tpu_torch.training import checkpoint as tckpt
from vault_tpu_torch.training import losses as tlosses
from vault_tpu_torch.training import metrics as tmetrics
from vault_tpu_torch.training import optimizer as topt
from vault_tpu_torch.training.experiment import ExperimentHandler
from vault_tpu_torch.training.trainer import (
    TrainArgs,
    Trainer,
    classifier_apply_fn,
)

N_CLASSES = 3


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


# ------------------------------------------------------------- optimizer

def test_schedule_matches_jax():
    ours = topt.linear_warmup_linear_decay(3e-4, 4, 23)
    ref = jopt.linear_warmup_linear_decay(3e-4, 4, 23)
    for step in range(26):
        assert ours(step) == float(ref(step)), step  # both in float32


@pytest.mark.parametrize("state_dtype", [None, "bfloat16"])
@pytest.mark.parametrize("correct_bias", [False, True])
@pytest.mark.parametrize("weight_decay", [0.0, 0.01])
def test_hf_adamw_matches_jax(state_dtype, correct_bias, weight_decay):
    """Six steps on a schedule with warmup: parameters and stored moments
    equal the JAX hf_adamw's within fp32 rounding (atol 1e-7 on parameters
    of magnitude ~1; the same operations in the same order)."""
    rng = np.random.default_rng(0)
    p0 = {"w": rng.normal(size=(5, 4)).astype(np.float32),
          "b": rng.normal(size=(4,)).astype(np.float32)}
    sched = (topt.linear_warmup_linear_decay(1e-2, 2, 6),
             jopt.linear_warmup_linear_decay(1e-2, 2, 6))
    tx_t = topt.hf_adamw(sched[0], weight_decay=weight_decay,
                         correct_bias=correct_bias, state_dtype=state_dtype)
    tx_j = jopt.hf_adamw(sched[1], weight_decay=weight_decay,
                         correct_bias=correct_bias,
                         state_dtype=None if state_dtype is None else jnp.bfloat16)
    tp = {k: torch.tensor(v) for k, v in p0.items()}
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    st_t, st_j = tx_t.init(tp), tx_j.init(jp)
    for i in range(6):
        g = {k: rng.normal(size=v.shape).astype(np.float32) for k, v in p0.items()}
        st_t = tx_t.step_(tp, {k: torch.tensor(v) for k, v in g.items()}, st_t)
        upd, st_j = tx_j.update({k: jnp.asarray(v) for k, v in g.items()}, st_j, jp)
        jp = jax.tree.map(lambda a, b: a + b, jp, upd)
    assert st_t.count == int(st_j.count) == 6
    for k in p0:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), atol=1e-7,
                                   rtol=0)
        for ours, ref in ((st_t.mu[k], st_j.mu[k]), (st_t.nu[k], st_j.nu[k])):
            assert str(ours.dtype).endswith(str(ref.dtype))
            np.testing.assert_allclose(_np(ours), _np(ref), rtol=1e-6, atol=1e-12)


def test_hf_adamw_int8_moments_wait():
    """The int8 moments no longer wait: ``state_dtype="int8"`` builds
    fresh blockwise moments, the JAX package's ``_q8_encode(zeros)`` (codes
    0, scales float32(1e-12), one block row per 256 values)."""
    tx = topt.hf_adamw(1e-3, state_dtype="int8")
    state = tx.init({"b": torch.zeros(300)})
    for m in (state.mu["b"], state.nu["b"]):
        assert m.q.dtype == torch.int8 and tuple(m.q.shape) == (2, topt.INT8_BLOCK)
        assert not m.q.any() and torch.equal(m.scale, torch.full((2, 1), 1e-12))


def test_make_optimizer_warmup_from_ratio():
    tx, sched = topt.make_optimizer(1e-3, 20, warmup_ratio=0.1)
    assert sched(0) == 0.0 and sched(2) == pytest.approx(1e-3)
    assert tx.step_sizes(1) == (0.0, 0.0)  # step 1 runs at schedule(0)


# ---------------------------------------------------------- losses, metrics

@pytest.mark.parametrize("name", ["softmax_cross_entropy", "bce_with_logits",
                                  "dual_softmax_cross_entropy", "vqa_bce"])
@pytest.mark.parametrize("weighted", [False, True])
def test_losses_match_jax(name, weighted):
    """fp32 on both sides: atol 1e-6.  The weights zero padded rows, which
    then carry garbage logits."""
    rng = np.random.default_rng(1)
    b = 6
    width = {"dual_softmax_cross_entropy": 6, "vqa_bce": 5}.get(name, 3)
    logits = rng.normal(size=(b, width)).astype(np.float32) * 3
    if name == "softmax_cross_entropy":
        labels = rng.integers(0, 3, b)
    elif name == "dual_softmax_cross_entropy":
        labels = rng.integers(0, 3, (b, 2))
    else:
        labels = rng.random((b, width)).astype(np.float32)
    weight = np.array([1, 1, 1, 1, 0, 0], np.float32) if weighted else None
    if weighted:
        logits[4:] = 1e3
    ref = getattr(jlosses, name)(jnp.asarray(logits), jnp.asarray(labels),
                                 None if weight is None else jnp.asarray(weight))
    out = getattr(tlosses, name)(torch.tensor(logits), torch.tensor(labels),
                                 None if weight is None else torch.tensor(weight))
    assert out.dtype == torch.float32 and out.shape == ()
    np.testing.assert_allclose(out.item(), float(ref), atol=1e-6)


def test_metrics_match_jax():
    rng = np.random.default_rng(2)
    y, p = rng.integers(0, 3, 50), rng.integers(0, 3, 50)
    assert tmetrics.classification_results(y, p) == jmetrics.classification_results(y, p)
    for avg in ("macro", "micro", "weighted"):
        assert tmetrics.precision_recall_fscore(y, p, avg) == \
            jmetrics.precision_recall_fscore(y, p, avg)


def test_prefetch_yields_in_order_and_raises_worker_errors():
    assert list(prefetch(iter(range(7)), 2)) == list(range(7))

    def bad():
        yield 1
        raise RuntimeError("boom")

    with pytest.raises(RuntimeError, match="boom"):
        list(prefetch(bad(), 1))


# ------------------------------------------------------------ toy setup

def _cfgs(dropout: float):
    """Tiny VAuLT: one BERT layer, two ViLT layers, 32x32 images."""
    text = dict(num_hidden_layers=1, hidden_dropout_prob=dropout,
                attention_probs_dropout_prob=dropout)
    vilt = dict(image_size=32, patch_size=16, num_patch_tokens=8,
                hidden_dropout_prob=dropout, attention_probs_dropout_prob=dropout)
    return (JVaultConfig(vilt=j_tiny_vilt(**vilt), text_tower=j_tiny_text(**text)),
            VaultConfig(vilt=tiny_vilt_config(**vilt), text_tower=tiny_text_config(**text)))


def _toy_data(cfg, n=24, seed=0):
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, N_CLASSES, n)
    ids = rng.integers(5, cfg.text_tower.vocab_size, (n, 8))
    ids[:, 0] = labels + 1  # learnable: the class sets the first token
    am = np.ones((n, 8), np.int32)
    am[::3, 6:] = 0
    feats = {"input_ids": ids.astype(np.int32), "attention_mask": am,
             "token_type_ids": np.zeros((n, 8), np.int32),
             "pixel_values": rng.normal(size=(n, 3, 32, 32)).astype(np.float32),
             "pixel_mask": np.ones((n, 32, 32), np.int32)}
    return feats, labels


def _jax_params(jcfg, seed=0):
    p = jvault.init_vault(jax.random.PRNGKey(seed), jcfg)
    p["head"] = jvault.init_classifier_head(jax.random.PRNGKey(seed + 1),
                                            jcfg.vilt.hidden_size, N_CLASSES)
    return jax.tree.map(np.asarray, p)


def _port_trainer(tcfg, params, args, ds, **kw):
    apply_fn = classifier_apply_fn(tcfg, args, head_dropout=kw.pop("head_dropout", 0.0))
    return Trainer(apply_fn, params, args, ds, device="cpu", **kw)


def _handler(tmp_path, name):
    return ExperimentHandler(str(tmp_path / name), "Toy")


# ------------------------------------------------------------ the trainer

@pytest.mark.parametrize("impl", [False, "fuseqkv+fusemlp+batched"])
def test_trainer_loss_curve_matches_jax(tmp_path, impl):
    """Eight steps of the port's Trainer against the JAX package's on the
    same dataset, parameters and shuffle, fp32, dropout off, fp32 moments,
    a train-loss window per step.  Mirrors
    tests/test_training_dynamics_parity.py: first loss atol 1e-5 (one
    forward), the curve atol 5e-3 (fp32 drift compounds over the steps)."""
    jcfg, tcfg = _cfgs(0.0)
    feats, labels = _toy_data(tcfg, n=32)
    jp = _jax_params(jcfg)
    kw = dict(lr=1e-3, train_batch_size=8, eval_batch_size=8, num_train_epochs=2,
              eval_steps=1, seed=3, opt_state_dtype="float32", disable_tqdm=True,
              use_pallas=impl, remat=True)
    jh = JHandler(str(tmp_path / "jax"), "Toy")

    def japply(p, batch, deterministic, rng):
        return jvault.vault_for_classification(p, jcfg, batch, head_dropout=0.0,
                                               deterministic=deterministic,
                                               rng=rng, use_pallas=impl, remat=True)

    JTrainer(japply, jax.tree.map(jnp.asarray, jp),
             JTrainArgs(num_data_shards=1, **kw), JDataset(feats, labels),
             exp_handler=jh).train()
    th = _handler(tmp_path, "torch")
    tr = _port_trainer(tcfg, params_from_jax(jp, tcfg), TrainArgs(**kw),
                       InMemoryDataset(feats, labels), exp_handler=th)
    tr.train()
    ours, ref = th._series["train_loss"], jh._series["train_loss"]
    assert len(ours) == len(ref) == 8
    np.testing.assert_allclose(ours[0], ref[0], atol=1e-5)
    np.testing.assert_allclose(ours, ref, atol=5e-3)
    assert ours[-1] < ours[0]


def test_trainer_descends_logs_and_evaluates(tmp_path):
    """bf16 compute and moments, dropout on: the loss falls, the dev and
    test evaluations run, and the handler writes its files."""
    _, tcfg = _cfgs(0.1)
    feats, labels = _toy_data(tcfg, n=48)
    ds = InMemoryDataset(feats, labels)
    h = _handler(tmp_path, "run")
    h.set_params({"lr": 5e-3, "dataset": "toy(train,dev)"})
    h.set_name_params(["dataset"])
    args = TrainArgs(lr=5e-3, train_batch_size=16, eval_batch_size=16,
                     num_train_epochs=5, compute_dtype="bfloat16",
                     disable_tqdm=True)
    tr = _port_trainer(tcfg, tvault.VaultForClassification(tcfg, device="cpu"),
                       args, ds, dev_dataset=ds, test_dataset=ds, exp_handler=h,
                       head_dropout=0.1)
    tr.train()
    losses = h._series["train_loss"]
    assert len(losses) == 5 and losses[-1] < 0.7 * losses[0], losses
    assert all(v.dtype == torch.float32 for v in tr.params.values())
    assert all(m.dtype == torch.bfloat16 for m in tr.opt_state.mu.values())
    assert "test_eval_accuracy" in h._finals and "train_pairs_per_sec" in h._finals
    d = h.directory()
    assert os.path.basename(d) == "toy(train;dev)_0"
    for name in ("metrics.yml", "params.yml", "aggregated_metrics.yml", "obj.pkl"):
        assert os.path.exists(os.path.join(d, name)), name
    # the JAX package's handler reads the port's snapshot
    assert JHandler.load_existent(d)._series["train_loss"] == losses


def test_grad_accumulation_equals_one_large_step(tmp_path):
    """grad_accum_steps=2 over batches of 8 equals one step over the 8 rows,
    dropout off, fp32: atol 1e-6 (sums in another order).  The trailing
    batch of 5 rows pads to 6 with a weight-0 row."""
    _, tcfg = _cfgs(0.0)
    feats, labels = _toy_data(tcfg, n=21)
    params = tvault.VaultForClassification(tcfg, device="cpu", seed=5).state_dict()
    out = []
    for k in (1, 2):
        args = TrainArgs(lr=1e-3, train_batch_size=8, num_train_epochs=1,
                         grad_accum_steps=k, opt_state_dtype="float32",
                         disable_tqdm=True)
        tr = _port_trainer(tcfg, params, args, InMemoryDataset(feats, labels),
                           exp_handler=_handler(tmp_path, f"k{k}"))
        tr.train()
        out.append(tr.params)
    for name in out[0]:
        torch.testing.assert_close(out[0][name], out[1][name], atol=1e-6, rtol=0)


@pytest.mark.parametrize("impl", [False, "fuseqkv+fusemlp+batched"])
def test_remat_equals_no_remat_with_dropout(impl):
    """Dropout 0.1 everywhere: with remat the layers rerun in the backward
    and must draw the same masks, so the gradients equal those without
    remat (atol 1e-6: the same operations on the same values)."""
    _, tcfg = _cfgs(0.1)
    feats, labels = _toy_data(tcfg, n=4)
    model = tvault.VaultForClassification(tcfg, device="cpu", seed=1)
    batch = tvault.batch_to_device(feats, "cpu")
    y = torch.as_tensor(labels)
    grads, ends = {}, {}
    for remat in (False, True):
        model.zero_grad()
        gen = torch.Generator().manual_seed(11)
        logits = tvault.vault_for_classification(
            model, tcfg, batch, head_dropout=0.1, deterministic=False,
            generator=gen, use_pallas=impl, remat=remat)
        tlosses.softmax_cross_entropy(logits, y).backward()
        grads[remat] = {k: p.grad.clone() for k, p in model.named_parameters()
                        if p.grad is not None}  # ViLT's word table is unused
        ends[remat] = gen.get_state()
    # the generator ends where the run without remat left it
    assert torch.equal(ends[True], ends[False])
    assert set(grads[True]) == set(grads[False])
    for k in grads[False]:
        torch.testing.assert_close(grads[True][k], grads[False][k], atol=1e-6,
                                   rtol=0)
    assert grads[False]["bert.layers.0.mlp_in.w"].abs().sum() > 0


def test_step_generator_is_a_function_of_seed_and_step():
    _, tcfg = _cfgs(0.0)
    tr = _port_trainer(tcfg, {"w": torch.zeros(2)}, TrainArgs(seed=4), None)
    draw = lambda g: torch.rand(3, generator=g)
    assert torch.equal(draw(tr.step_generator(7)), draw(tr.step_generator(7)))
    assert not torch.equal(draw(tr.step_generator(7)), draw(tr.step_generator(8)))
    assert not torch.equal(draw(tr.step_generator(7)), draw(tr.step_generator(7, 0)))


def test_unported_knobs_raise():
    # merge_to is ported (tests/test_torch_token_merge.py trains with it)
    # profile_dir is ported (tests/test_torch_trainer_options.py)
    for kw in (dict(zero_opt=True), dict(num_data_shards=2)):
        with pytest.raises(NotImplementedError):
            Trainer(None, {}, TrainArgs(**kw), None, device="cpu")


def test_classifier_apply_fn_reads_the_train_args(monkeypatch):
    """``use_pallas``, ``remat`` and the merge knobs have one home, the
    TrainArgs."""
    import vault_tpu_torch.training.trainer as trainer_mod

    seen = {}
    monkeypatch.setattr(trainer_mod, "vault_for_classification",
                        lambda *a, **kw: seen.update(kw))
    _, tcfg = _cfgs(0.0)
    for use_pallas, remat in ((False, False), ("auto", True)):
        fn = classifier_apply_fn(tcfg, TrainArgs(use_pallas=use_pallas, remat=remat))
        fn({}, {}, True, None)
        assert (seen["use_pallas"], seen["remat"]) == (use_pallas, remat)
        assert (seen["merge_patches_to"], seen["merge_at_layer"]) == (None, 0)
    fn = classifier_apply_fn(tcfg, TrainArgs(merge_to=87, merge_at_layer=4))
    fn({}, {}, True, None)
    assert (seen["merge_patches_to"], seen["merge_at_layer"]) == (87, 4)


def test_a_cut_graph_raises_and_only_unread_leaves_get_zeros():
    """ViLT's text word and position tables are never read under a text
    tower: they get zero gradients, as under jax.grad.  Any other leaf
    without a gradient means the autograd graph was cut, and the step
    raises instead of training on zeros."""
    _, tcfg = _cfgs(0.0)
    feats, labels = _toy_data(tcfg, n=4)
    tr = _port_trainer(tcfg, tvault.VaultForClassification(tcfg, device="cpu"),
                       TrainArgs(disable_tqdm=True), None)
    batch, y, w = tr._to_device(*tr._pad(feats, labels))
    _, grads = tr.loss_and_grads(batch, y, w, tr.step_generator(0))
    unread = {k for k in grads if tr.apply_fn.unreached(k)}
    assert unread == {"vilt.text_embeddings.word", "vilt.text_embeddings.position"}
    assert all(not grads[k].any() for k in unread)
    assert grads["bert.layers.0.mlp_in.w"].abs().sum() > 0
    kernel_path = tr.apply_fn
    # ViLT's CLS token and patch positions behind a detach, as a forward
    # kernel without a backward would leave what lies below it
    tr.apply_fn = lambda p, b, d, g: kernel_path(
        {**p, "vilt": {k: (v.detach() if torch.is_tensor(v) else v)
                       for k, v in p["vilt"].items()}}, b, d, g)
    with pytest.raises(RuntimeError, match="graph is cut"):
        tr.loss_and_grads(batch, y, w, tr.step_generator(0))
    # without a predicate even the unread tables count as cut
    tr.apply_fn = lambda *a: kernel_path(*a)
    with pytest.raises(RuntimeError, match="vilt.text_embeddings"):
        tr.loss_and_grads(batch, y, w, tr.step_generator(0))


# ------------------------------------------------------------ checkpoints

def _jax_opt_state(jp, seed=0):
    """A JAX hf_adamw state with nonzero bf16 moments."""
    tx = jopt.hf_adamw(1e-3, state_dtype=jnp.bfloat16)
    state = tx.init(jp)
    rng = np.random.default_rng(seed)
    grads = jax.tree.map(lambda a: jnp.asarray(rng.normal(size=a.shape), a.dtype), jp)
    _, state = tx.update(grads, state, jp)
    return state


def test_jax_checkpoint_restores_in_the_port(tmp_path):
    jcfg, tcfg = _cfgs(0.0)
    feats, labels = _toy_data(tcfg)
    jp = _jax_params(jcfg, seed=2)
    jstate = _jax_opt_state(jp)
    path = str(tmp_path / "last.ckpt")
    jckpt.save_checkpoint(path, {"params": jp, "opt_state": jstate,
                                 "step": np.asarray(5)})
    tr = _port_trainer(tcfg, tvault.VaultForClassification(tcfg, device="cpu"),
                       TrainArgs(checkpoint_dir=str(tmp_path)),
                       InMemoryDataset(feats, labels))
    tr._build_optimizer(3)
    assert tr._maybe_resume() == 5
    want = params_from_jax(jp, tcfg)
    assert set(want) == set(tr.params)
    for k, v in want.items():
        assert torch.equal(tr.params[k], v), k
    assert tr.opt_state.count == 1
    mu = params_from_jax(jax.tree.map(np.asarray, jstate.mu), tcfg)
    for k, v in mu.items():
        assert tr.opt_state.mu[k].dtype == torch.bfloat16
        assert torch.equal(tr.opt_state.mu[k], v), k


def test_port_checkpoint_restores_in_jax(tmp_path):
    jcfg, tcfg = _cfgs(0.1)
    feats, labels = _toy_data(tcfg)
    args = TrainArgs(lr=1e-3, train_batch_size=8, num_train_epochs=1,
                     eval_steps=3, checkpoint_dir=str(tmp_path), disable_tqdm=True)
    tr = _port_trainer(tcfg, tvault.VaultForClassification(tcfg, device="cpu"),
                       args, InMemoryDataset(feats, labels),
                       exp_handler=_handler(tmp_path, "h"))
    tr.train()
    jp = _jax_params(jcfg)
    target = {"params": jp,
              "opt_state": jopt.hf_adamw(1e-3, state_dtype=jnp.bfloat16).init(jp),
              "step": np.asarray(0)}
    got = jckpt.restore_checkpoint(str(tmp_path / "last.ckpt"), target)
    assert int(got["step"]) == 3 and int(got["opt_state"].count) == 3
    mine = tr.checkpoint_state(3, as_numpy=True)
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(got),
                            jax.tree_util.tree_leaves(mine)):
        assert np.asarray(a).dtype == np.asarray(b).dtype, path
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=str(path))


def test_checkpoint_holds_its_step_while_the_next_one_runs(tmp_path):
    """Host masters (device "cpu"): the checkpoint's tree is a copy taken on
    the calling thread, so the step that runs while the background thread
    writes the file does not reach it.  Parameters and moments must match
    the snapshot bit for bit."""
    _, tcfg = _cfgs(0.0)
    feats, labels = _toy_data(tcfg, n=8)
    tr = _port_trainer(tcfg, tvault.VaultForClassification(tcfg, device="cpu"),
                       TrainArgs(lr=1e-2, warmup_ratio=0.0,
                                 checkpoint_dir=str(tmp_path), disable_tqdm=True),
                       None)
    tr._build_optimizer(4)
    batch = tr._to_device(*tr._pad(feats, labels))
    tr.train_step(*batch, 0)
    snap = {k: v.detach().clone() for k, v in tr.params.items()}
    snap_mu = {k: v.clone() for k, v in tr.opt_state.mu.items()}
    state = tr.checkpoint_state(1)
    tr._maybe_checkpoint(1)
    tr.train_step(*batch, 1)
    tr._flush_checkpoint()
    moved = [k for k in snap if not torch.equal(tr.params[k], snap[k])]
    assert "head.out.w" in moved and "bert.layers.0.mlp_in.w" in moved
    saved = tckpt.restore_checkpoint(tr._ckpt_path, tr.checkpoint_state(0))
    for tree in (state, saved):
        params = params_from_jax(tree["params"])
        mu = opt_state_from_jax(tree["opt_state"]).mu
        for k in snap:
            assert torch.equal(params[k], snap[k]), k
            assert torch.equal(mu[k], snap_mu[k]), k


def test_opt_state_bridge_round_trips():
    jcfg, tcfg = _cfgs(0.0)
    jstate = _jax_opt_state(_jax_params(jcfg))
    ours = opt_state_from_jax(jax.tree.map(np.asarray, jstate), tcfg)
    back = opt_state_to_jax(ours)
    assert int(back[0]) == int(jstate.count)
    for a, b in zip(jax.tree.leaves((jstate.mu, jstate.nu)), jax.tree.leaves(back[1:])):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(np.asarray(a), b)


def test_checkpoint_casts_floats_and_refuses_kinds(tmp_path):
    path = str(tmp_path / "c")
    tckpt.save_checkpoint(path, {"a": torch.arange(4.0).to(torch.bfloat16),
                                 "n": np.asarray(3)})
    got = tckpt.restore_checkpoint(path, {"a": torch.zeros(4), "n": np.asarray(0)})
    assert got["a"].dtype == torch.float32 and got["a"].tolist() == [0, 1, 2, 3]
    assert int(got["n"]) == 3
    with pytest.raises(ValueError, match="dtype mismatch"):
        tckpt.restore_checkpoint(path, {"a": torch.zeros(4, dtype=torch.int32),
                                        "n": np.asarray(0)})
    with pytest.raises(ValueError, match="shape mismatch"):
        tckpt.restore_checkpoint(path, {"a": torch.zeros(5), "n": np.asarray(0)})


def test_resume_reproduces_the_uninterrupted_run(tmp_path):
    """Dropout on, bf16 moments, a checkpoint per step: a run stopped by
    max_steps and resumed ends on the same bits as the uninterrupted run
    (the step generator depends on (seed, step) only)."""
    _, tcfg = _cfgs(0.1)
    feats, labels = _toy_data(tcfg, n=24)
    params = tvault.VaultForClassification(tcfg, device="cpu", seed=2).state_dict()

    def run(name, **kw):
        args = TrainArgs(lr=1e-3, train_batch_size=8, num_train_epochs=2,
                         eval_steps=1, disable_tqdm=True,
                         checkpoint_dir=str(tmp_path / name), **kw)
        tr = _port_trainer(tcfg, params, args, InMemoryDataset(feats, labels),
                           exp_handler=_handler(tmp_path, name), head_dropout=0.1)
        tr.train()
        return tr

    full = run("full")
    run("cut", max_steps=4)
    resumed = run("cut", resume=True)
    assert resumed.opt_state.count == full.opt_state.count == 6
    for k in full.params:
        assert torch.equal(full.params[k], resumed.params[k]), k


def test_save_and_load_weights_discard_classifier(tmp_path):
    _, tcfg = _cfgs(0.0)
    a = tvault.VaultForClassification(tcfg, device="cpu", seed=1).state_dict()
    b = tvault.VaultForClassification(tcfg, device="cpu", seed=2).state_dict()
    src = _port_trainer(tcfg, a, TrainArgs(), None)
    path = str(tmp_path / "model.ckpt")
    src.save_weights(path)
    dst = _port_trainer(tcfg, b, TrainArgs(discard_classifier=True), None)
    dst.load_weights(path)
    for k in a:
        assert torch.equal(dst.params[k], (b if k.startswith("head.") else a)[k]), k
    # the file is the JAX package's weights layout
    jcfg, _ = _cfgs(0.0)
    jp = jckpt.restore_checkpoint(path, _jax_params(jcfg))
    np.testing.assert_array_equal(jp["bert"]["layers"]["mlp_in"]["w"][0],
                                  to_numpy(a["bert.layers.0.mlp_in.w"]))


def test_early_stopping_restores_best(tmp_path):
    """A lr large enough to overshoot: the dev loss rises after its best
    window, patience 1 stops the run, and the best window's weights come
    back."""
    _, tcfg = _cfgs(0.0)
    feats, labels = _toy_data(tcfg, n=16)
    ds = InMemoryDataset(feats, labels)
    args = TrainArgs(lr=3e-1, train_batch_size=8, eval_batch_size=8,
                     num_train_epochs=6, eval_steps=1, warmup_ratio=0.0,
                     early_stopping_patience=1, early_stopping_metric="eval_loss",
                     higher_better=False, disable_tqdm=True)
    tr = _port_trainer(tcfg, tvault.VaultForClassification(tcfg, device="cpu"),
                       args, ds, dev_dataset=ds, exp_handler=_handler(tmp_path, "e"))
    tr.train()
    series = tr.exp_handler._series["eval_loss"]
    assert len(series) < 12  # it stopped early
    best = min(series)
    assert tr.early_stopping.best == best
    assert tr.evaluate(ds)["eval_loss"] == pytest.approx(best, abs=1e-6)
