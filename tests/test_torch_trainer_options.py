"""The training core's options that the port took over last from the JAX
package: ``remat="dots"`` (ops/nn.py ``remat_apply``), the blockwise int8
AdamW moments (training/optimizer.py) and their checkpoints
(convert.py, training/checkpoint.py), ``profile_dir`` and the NaN checks
(utils/profiling.py), each held to the JAX package on the CPU at a tiny
size (one BERT layer, two ViLT layers, H 32), inputs from seeded numpy.
Tolerances are stated at each test."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from vault_tpu.config import VaultConfig as JVaultConfig
from vault_tpu.config import tiny_text_config as j_tiny_text
from vault_tpu.config import tiny_vilt_config as j_tiny_vilt
from vault_tpu.data.loader import InMemoryDataset as JDataset
from vault_tpu.models import vault as jvault
from vault_tpu.training import checkpoint as jckpt
from vault_tpu.training import optimizer as jopt
from vault_tpu.training.experiment import ExperimentHandler as JHandler
from vault_tpu.training.trainer import TrainArgs as JTrainArgs
from vault_tpu.training.trainer import Trainer as JTrainer
from vault_tpu_torch.config import VaultConfig, tiny_text_config, tiny_vilt_config
from vault_tpu_torch.convert import (
    opt_state_to_jax,
    param_tree,
    params_from_jax,
    params_to_jax,
)
from vault_tpu_torch.data.loader import InMemoryDataset
from vault_tpu_torch.models import vault as tvault
from vault_tpu_torch.training import checkpoint as tckpt
from vault_tpu_torch.training import optimizer as topt
from vault_tpu_torch.training.experiment import ExperimentHandler
from vault_tpu_torch.training.losses import softmax_cross_entropy
from vault_tpu_torch.training.trainer import Trainer, TrainArgs, classifier_apply_fn
from vault_tpu_torch.utils import profiling

N_CLASSES = 3
IMPLS = [False, "fuseqkv+fusemlp+batched"]


def _cfgs(dropout: float = 0.0):
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
    ids[:, 0] = labels + 1
    am = np.ones((n, 8), np.int32)
    am[::3, 6:] = 0
    feats = {"input_ids": ids.astype(np.int32), "attention_mask": am,
             "token_type_ids": np.zeros((n, 8), np.int32),
             "pixel_values": rng.normal(size=(n, 3, 32, 32)).astype(np.float32),
             "pixel_mask": np.ones((n, 32, 32), np.int32)}
    return feats, labels


def _jax_params(tcfg, seed=0):
    """The classifier's parameters in the JAX package's layout (the port's
    seeded init through ``params_to_jax``), every leaf moved off its init
    (zero biases, unit LayerNorm scales) by seeded noise; host arrays."""
    sd = tvault.VaultForClassification(tcfg, device="cpu", seed=seed).state_dict()
    rng = np.random.default_rng(seed + 7)
    return jax.tree.map(lambda a: a + (0.02 * rng.normal(size=a.shape)).astype(np.float32),
                        params_to_jax(sd))


def _handler(tmp_path, name):
    return ExperimentHandler(str(tmp_path / name), "Toy")


def _trainer(tcfg, params, args, ds, **kw):
    return Trainer(classifier_apply_fn(tcfg, args, head_dropout=kw.pop("head_dropout", 0.0)),
                   params, args, ds, device="cpu", **kw)


# ------------------------------------------------------------ remat="dots"

# bf16: both packages round every activation to bf16, at other points in
# places (the XLA composition fuses); per leaf max|port - jax| <= 2^-6 of
# max(1, max|jax|), a few bf16 ulps of the leaf's scale.
GRAD_LIMITS = {"float32": 1e-5, "bfloat16": 2.0 ** -6}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("impl", IMPLS)
def test_dots_gradients_match_jax(impl, dtype):
    """Every leaf's gradient of the classifier's CE loss under
    ``remat="dots"`` against ``jax.grad`` of the JAX package's
    ``vault_for_classification`` under ``remat="dots"`` (its Pallas kernels
    interpreted), dropout off: fp32 atol 1e-5 of max(1, max|jax|) (the JAX
    package's own test_remat_modes_same_grads tolerance), bf16 as
    ``GRAD_LIMITS``."""
    jcfg, tcfg = _cfgs()
    jp = jax.tree.map(lambda a: jnp.asarray(a, getattr(jnp, dtype)), _jax_params(tcfg))
    feats, labels = _toy_data(tcfg, n=3, seed=4)
    jb = {k: jnp.asarray(v) for k, v in feats.items()}
    jb["pixel_values"] = jb["pixel_values"].astype(getattr(jnp, dtype))

    def jloss(p):
        logits = jvault.vault_for_classification(p, jcfg, jb, head_dropout=0.0,
                                                 deterministic=True, use_pallas=impl,
                                                 remat="dots")
        logp = jax.nn.log_softmax(logits.astype(jnp.float32), axis=-1)
        return -jnp.take_along_axis(logp, jnp.asarray(labels)[:, None], -1).mean()

    jg = jax.jit(jax.grad(jloss))(jp)
    sd = {k: v.requires_grad_() for k, v in
          params_from_jax(jax.tree.map(np.asarray, jp), tcfg).items()}
    tb = tvault.batch_to_device(feats, "cpu")
    tb["pixel_values"] = tb["pixel_values"].to(getattr(torch, dtype))
    logits = tvault.vault_for_classification(param_tree(sd), tcfg, tb, head_dropout=0.0,
                                             deterministic=True, use_pallas=impl,
                                             remat="dots")
    softmax_cross_entropy(logits.float(), torch.as_tensor(labels)).backward()
    want = params_from_jax(jax.tree.map(np.asarray, jg), tcfg)
    for k, g in want.items():
        got = sd[k].grad
        got = torch.zeros_like(g) if got is None else got
        scale = max(1.0, g.float().abs().max().item())
        err = (got.float() - g.float()).abs().max().item()
        assert err <= GRAD_LIMITS[dtype] * scale, (k, err, scale)


def _grads_with_dropout(tcfg, remat, impl, seed=11):
    feats, labels = _toy_data(tcfg, n=4)
    model = tvault.VaultForClassification(tcfg, device="cpu", seed=1)
    gen = torch.Generator().manual_seed(seed)
    logits = tvault.vault_for_classification(
        model, tcfg, tvault.batch_to_device(feats, "cpu"), head_dropout=0.1,
        deterministic=False, generator=gen, use_pallas=impl, remat=remat)
    softmax_cross_entropy(logits, torch.as_tensor(labels)).backward()
    return ({k: p.grad for k, p in model.named_parameters() if p.grad is not None},
            gen.get_state())


@pytest.mark.parametrize("impl", IMPLS)
def test_dots_equals_true_and_false_with_dropout(impl):
    """Dropout 0.1 everywhere, one generator: the recomputed layers draw
    the first run's masks, so the gradients under "dots" equal those under
    True and False (atol 1e-6: the same operations on the same values),
    and the generator ends where the run without remat left it."""
    _, tcfg = _cfgs(0.1)
    ref, ref_end = _grads_with_dropout(tcfg, False, impl)
    for remat in (True, "dots"):
        got, end = _grads_with_dropout(tcfg, remat, impl)
        assert torch.equal(end, ref_end) and set(got) == set(ref)
        for k in ref:
            torch.testing.assert_close(got[k], ref[k], atol=1e-6, rtol=0)
    assert ref["bert.layers.0.mlp_in.w"].abs().sum() > 0
    with pytest.raises(ValueError, match="remat"):
        _grads_with_dropout(tcfg, "everything", impl)


class _CountProducts(TorchDispatchMode):
    """Counts the 2-D products (``mm``, ``addmm``) dispatched under it."""

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.namespace == "aten" and func.overloadpacket.__name__ in ("mm", "addmm"):
            self.n += 1
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("impl,per_layer", [(False, 6), ("fuseqkv+fusemlp+batched", 2)])
def test_dots_backward_recomputes_no_product(impl, per_layer):
    """The backward's 2-D products under each ``remat``: "dots" runs
    exactly those of ``remat=False`` (it recomputes none of the forward's),
    True those plus every product of every layer's forward: Q, K, V, the
    output projection and the MLP's two halves on the plain path (6), the
    fused QKV and the output projection where the MLP is one kernel (2)."""
    _, tcfg = _cfgs(0.1)
    feats, labels = _toy_data(tcfg, n=4)
    model = tvault.VaultForClassification(tcfg, device="cpu", seed=1)
    counts = {}
    for remat in (False, True, "dots"):
        logits = tvault.vault_for_classification(
            model, tcfg, tvault.batch_to_device(feats, "cpu"), head_dropout=0.1,
            deterministic=False, generator=torch.Generator().manual_seed(3),
            use_pallas=impl, remat=remat)
        loss = softmax_cross_entropy(logits, torch.as_tensor(labels))
        with _CountProducts() as c:
            loss.backward()
        counts[remat] = c.n
    layers = tcfg.text_tower.num_hidden_layers + tcfg.vilt.num_hidden_layers
    assert counts["dots"] == counts[False] > 0
    assert counts[True] == counts[False] + per_layer * layers


# ------------------------------------------------------------ int8 moments

def _adamw_problem():
    """The JAX package's test_adamw_int8_state_tracks_fp32 problem: an 8x8
    matrix and a 300-value vector (not a multiple of the 256-value block)."""
    return {"w": np.linspace(-1, 1, 64, dtype=np.float32).reshape(8, 8),
            "b": np.linspace(0.5, -0.5, 300, dtype=np.float32)}


@pytest.mark.parametrize("weight_decay", [0.0, 0.01])
def test_int8_adamw_matches_jax_over_20_steps(weight_decay):
    """20 steps of ``HfAdamW(state_dtype="int8")`` against the JAX
    package's ``hf_adamw(state_dtype="int8")`` on the JAX package's test
    problem, both fed the same gradients (JAX's, at its parameters): codes
    and scales equal, parameters within 1e-6 (the two sides' fp32 updates
    differ by an ulp now and then: XLA contracts products into FMAs)."""
    params = _adamw_problem()

    def jloss(p):
        return jnp.sum((p["w"] @ p["w"] - jnp.eye(8)) ** 2) + jnp.sum(p["b"] ** 2)

    jtx = jopt.hf_adamw(1e-2, state_dtype="int8", weight_decay=weight_decay)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    js = jtx.init(jp)
    ttx = topt.hf_adamw(1e-2, state_dtype="int8", weight_decay=weight_decay)
    tp = {k: torch.tensor(v) for k, v in params.items()}
    ts = ttx.init(tp)
    for _ in range(20):
        g = jax.grad(jloss)(jp)
        u, js = jtx.update(g, js, jp)
        jp = jax.tree.map(lambda a, b: a + b, jp, u)
        ts = ttx.step_(tp, {k: torch.tensor(np.asarray(v)) for k, v in g.items()}, ts)
    assert ts.count == 20 and int(js.count) == 20
    for k in params:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), atol=1e-6,
                                   rtol=0)
        for ours, ref in ((ts.mu[k], js.mu[k]), (ts.nu[k], js.nu[k])):
            assert ours.q.dtype == torch.int8 and ours.scale.dtype == torch.float32
            np.testing.assert_array_equal(ours.q.numpy(), np.asarray(ref.q))
            np.testing.assert_array_equal(ours.scale.numpy(), np.asarray(ref.scale))


def test_int8_blocks_span_the_stacked_layers():
    """The tiny VAuLT's ``layers.<i>`` leaves (the vectors: 32 or 64 values
    a layer, no multiple of 256) share the blocks of the JAX package's stacked leaf:
    after two steps on the same seeded gradients the port's state, in the
    JAX layout, equals the JAX package's code for code and scale for
    scale; the parameters are within 1e-6."""
    _, tcfg = _cfgs()
    full = _jax_params(tcfg, seed=3)
    # the two-layer ViLT stack and the head (the JAX optimizer runs op by
    # op here: jitted, XLA would contract its products into FMAs)
    jp = {"vilt": {"layers": full["vilt"]["layers"]}, "head": full["head"]}
    rng = np.random.default_rng(9)
    jgrads = [jax.tree.map(lambda a: rng.normal(size=a.shape).astype(np.float32), jp)
              for _ in range(2)]
    jtx = jopt.hf_adamw(1e-3, state_dtype="int8", weight_decay=0.01)
    p = jax.tree.map(jnp.asarray, jp)
    js = jtx.init(p)
    ttx = topt.hf_adamw(1e-3, state_dtype="int8", weight_decay=0.01)
    tp = params_from_jax(jp)
    ts = ttx.init(tp)
    # per layer, the ViLT LN scales would take a block each; stacked, their
    # 64 values share one
    assert tuple(ts.mu["vilt.layers.ln_before.scale"].q.shape) == (1, 256)
    for g in jgrads:
        u, js = jtx.update(jax.tree.map(jnp.asarray, g), js, p)
        p = jax.tree.map(lambda a, b: a + b, p, u)
        ts = ttx.step_(tp, params_from_jax(g), ts)
    ours = opt_state_to_jax(ts)
    ref = jax.tree.map(np.asarray, js)
    for a, b in zip(jax.tree.leaves(ours[1:]), jax.tree.leaves((ref.mu, ref.nu))):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    for a, b in zip(jax.tree.leaves(params_to_jax(tp)), jax.tree.leaves(p)):
        np.testing.assert_allclose(a, np.asarray(b), atol=1e-6, rtol=0)


def _int8_args(tmp_path, name, **kw):
    return dict(lr=1e-3, train_batch_size=8, eval_batch_size=8, num_train_epochs=1,
                eval_steps=1, seed=3, opt_state_dtype="int8", disable_tqdm=True,
                checkpoint_dir=str(tmp_path / name), **kw)


def test_int8_checkpoints_cross_both_ways_and_refuse_the_other_kind(tmp_path):
    """A JAX ``Trainer`` run with int8 moments resumes in the port, whose
    own checkpoint then holds the JAX file's keys and arrays bit for bit;
    a port run's checkpoint restores in the JAX package equal to the port's
    state.  Int8 moments restored into float moments, or float into int8,
    are refused by kind in both directions."""
    jcfg, tcfg = _cfgs()
    feats, labels = _toy_data(tcfg, n=16)
    jp = _jax_params(tcfg)
    def japply(p, batch, deterministic, rng):
        return jvault.vault_for_classification(p, jcfg, batch, head_dropout=0.0,
                                               deterministic=deterministic, rng=rng,
                                               use_pallas=False)

    kw = _int8_args(tmp_path, "jax")
    JTrainer(japply, jax.tree.map(jnp.asarray, jp), JTrainArgs(num_data_shards=1, **kw),
             JDataset(feats, labels), exp_handler=JHandler(str(tmp_path / "jh"), "T")).train()
    jfile = tmp_path / "jax" / "last.ckpt.npz"
    tr = _trainer(tcfg, params_from_jax(jp, tcfg), TrainArgs(resume=True, **kw),
                  InMemoryDataset(feats, labels))
    tr._build_optimizer(2)
    assert tr._maybe_resume() == 2 and tr.opt_state.count == 2
    tckpt.save_checkpoint(str(tmp_path / "back"), tr.checkpoint_state(2))
    with np.load(jfile) as a, np.load(tmp_path / "back.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        assert "opt_state/1/vilt/layers/mlp_in/w/0" in a.files
        for k in a.files:
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)

    kw = _int8_args(tmp_path, "port")
    tr = _trainer(tcfg, params_from_jax(jp, tcfg), TrainArgs(**kw),
                  InMemoryDataset(feats, labels), exp_handler=_handler(tmp_path, "p"))
    tr.train()
    target = {"params": jp, "opt_state": jopt.hf_adamw(1e-3, state_dtype="int8").init(jp),
              "step": np.asarray(0)}
    got = jckpt.restore_checkpoint(str(tmp_path / "port" / "last.ckpt"), target)
    mine = tr.checkpoint_state(2, as_numpy=True)
    assert int(got["step"]) == 2 and int(got["opt_state"].count) == 2
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(mine)):
        assert np.asarray(a).dtype == np.asarray(b).dtype
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))

    float_tr = _trainer(tcfg, params_from_jax(jp, tcfg),
                        TrainArgs(**{**kw, "opt_state_dtype": "float32"}), None)
    float_tr._build_optimizer(2)
    with pytest.raises(ValueError, match="int8 moments"):
        tckpt.restore_checkpoint(str(tmp_path / "port" / "last.ckpt"),
                                 float_tr.checkpoint_state(0))
    tckpt.save_checkpoint(str(tmp_path / "float"), float_tr.checkpoint_state(0))
    with pytest.raises(ValueError, match="int8 moments"):
        tckpt.restore_checkpoint(str(tmp_path / "float"), tr.checkpoint_state(0))
    with pytest.raises(KeyError):  # the JAX package refuses both as well
        jckpt.restore_checkpoint(str(tmp_path / "float"), target)


def test_int8_trainer_resumes_the_uninterrupted_run(tmp_path):
    """``opt_state_dtype="int8"`` with ``remat="dots"``, dropout on and a
    checkpoint per step: a run cut by ``max_steps`` and resumed ends on the
    uninterrupted run's parameters and codes bit for bit, and the loss
    descends."""
    _, tcfg = _cfgs(0.1)
    feats, labels = _toy_data(tcfg, n=24)
    params = tvault.VaultForClassification(tcfg, device="cpu", seed=2).state_dict()

    def run(name, **kw):
        args = TrainArgs(lr=3e-3, train_batch_size=8, num_train_epochs=2, eval_steps=1,
                         disable_tqdm=True, opt_state_dtype="int8", remat="dots",
                         checkpoint_dir=str(tmp_path / name), **kw)
        tr = _trainer(tcfg, params, args, InMemoryDataset(feats, labels),
                      exp_handler=_handler(tmp_path, name), head_dropout=0.1)
        tr.train()
        return tr

    full = run("full")
    run("cut", max_steps=4)
    resumed = run("cut", resume=True)
    assert resumed.opt_state.count == full.opt_state.count == 6
    for k in full.params:
        assert torch.equal(full.params[k], resumed.params[k]), k
    for a, b in ((full.opt_state.mu, resumed.opt_state.mu),
                 (full.opt_state.nu, resumed.opt_state.nu)):
        assert set(a) == set(b) and "bert.layers.mlp_in.w" in a
        for k in a:
            assert torch.equal(a[k].q, b[k].q) and torch.equal(a[k].scale, b[k].scale), k
    losses = full.exp_handler._series["train_loss"]
    assert np.mean(losses[-2:]) < np.mean(losses[:2])


# ------------------------------------------------------------ profile_dir

def _trace_steps(profile_dir):
    """The ``train_step:<n>`` spans of each trace file under the dir."""
    out = []
    for name in sorted(os.listdir(profile_dir)):
        with open(os.path.join(profile_dir, name)) as f:
            events = json.load(f)["traceEvents"]
        out.append(sorted({int(e["name"].split(":")[1]) for e in events
                           if str(e.get("name", "")).startswith("train_step:")}))
    return out


@pytest.mark.parametrize("stop", ["none", "max_steps", "early_stop"])
def test_profile_dir_traces_the_second_window_once(tmp_path, stop):
    """eval_steps 2 over 8 steps: one trace, of steps 2 and 3 only (the
    first window holds the warm-up).  Cut by ``max_steps`` 3 mid-window,
    the trace holds step 2 and is written all the same; an early stop at
    the end of the second window leaves the same trace as a full run."""
    _, tcfg = _cfgs()
    feats, labels = _toy_data(tcfg, n=16)
    kw = dict(lr=1e-3, train_batch_size=2, num_train_epochs=1, eval_steps=2,
              disable_tqdm=True, profile_dir=str(tmp_path / "trace"))
    if stop == "max_steps":
        kw["max_steps"] = 3
    if stop == "early_stop":  # the dev loss never improves on its first value
        kw.update(early_stopping_patience=1, early_stopping_metric="eval_loss",
                  higher_better=True, early_stopping_delta=1e9)
    tr = _trainer(tcfg, tvault.VaultForClassification(tcfg, device="cpu"),
                  TrainArgs(**kw), InMemoryDataset(feats, labels),
                  dev_dataset=InMemoryDataset({k: v[:4] for k, v in feats.items()},
                                              labels[:4]),
                  exp_handler=_handler(tmp_path, "h"))
    tr.train()
    assert _trace_steps(tmp_path / "trace") == [[2] if stop == "max_steps" else [2, 3]]
    if stop == "early_stop":
        assert len(tr.exp_handler._series["train_loss"]) == 2


def test_trace_writes_its_file_when_the_body_raises(tmp_path):
    with pytest.raises(ZeroDivisionError):
        with profiling.trace(str(tmp_path)):
            torch.ones(3).sum()
            1 / 0
    (name,) = os.listdir(tmp_path)
    with open(tmp_path / name) as f:
        assert any("aten::sum" == e.get("name") for e in json.load(f)["traceEvents"])


# ------------------------------------------------------------ NaN checks

class _NanGrad(torch.autograd.Function):
    """The identity forward; a NaN gradient backward."""

    @staticmethod
    def forward(ctx, x):
        return x.clone()

    @staticmethod
    def backward(ctx, g):
        return g * float("nan")


def test_nan_checks_raise_forward_and_backward_and_turn_off():
    """Under ``enable_nan_checks(True)`` a step raises at a forward
    operation that makes a NaN (a NaN pixel) and at a backward function
    that returns one; after ``enable_nan_checks(False)`` the same steps run
    through (NaN parameters, a NaN loss)."""
    _, tcfg = _cfgs()
    feats, labels = _toy_data(tcfg, n=4)
    bad = dict(feats, pixel_values=feats["pixel_values"].copy())
    bad["pixel_values"][1, 0, 3, 3] = np.nan
    tr = _trainer(tcfg, tvault.VaultForClassification(tcfg, device="cpu"),
                  TrainArgs(lr=1e-3, disable_tqdm=True), None)
    tr._build_optimizer(4)
    inner = tr.apply_fn

    def nan_grad_apply(*a):
        return _NanGrad.apply(inner(*a))

    nan_grad_apply.unreached = inner.unreached
    ok = tr._to_device(*tr._pad(feats, labels))
    fwd = tr._to_device(*tr._pad(bad, labels))
    try:
        profiling.enable_nan_checks(True)
        tr.train_step(*ok, 0)  # finite: no false alarm
        with pytest.raises(RuntimeError, match="NaN produced by"):
            tr.train_step(*fwd, 1)
        tr.apply_fn = nan_grad_apply
        with pytest.raises(RuntimeError, match="nan"):
            tr.train_step(*ok, 2)
    finally:
        profiling.enable_nan_checks(False)
    assert not torch.is_anomaly_enabled()
    tr.train_step(*ok, 3)  # the NaN gradient reaches the parameters
    assert torch.isnan(tr.params["head.out.w"]).all()
    tr.apply_fn = inner
    assert torch.isnan(tr.train_step(*fwd, 4)[0])


def test_nan_checks_cover_the_evaluation():
    """The trainer's evaluation batches run under the NaN checks too, as
    the JAX package's jitted eval step runs under ``jax_debug_nans``: a NaN
    pixel in a dev batch raises at the first operator that makes a NaN
    (``aten``'s cast of the pixels), naming it; with the checks off the
    evaluation returns a NaN loss.  A forward the caller runs outside the
    trainer stays outside the checks."""
    _, tcfg = _cfgs()
    feats, labels = _toy_data(tcfg, n=4)
    bad = dict(feats, pixel_values=feats["pixel_values"].copy())
    bad["pixel_values"][2, 1, 5, 5] = np.nan
    model = tvault.VaultForClassification(tcfg, device="cpu")
    tr = _trainer(tcfg, model, TrainArgs(lr=1e-3, eval_batch_size=4, disable_tqdm=True),
                  None)
    try:
        profiling.enable_nan_checks(True)
        assert np.isfinite(tr.evaluate(InMemoryDataset(feats, labels))["eval_loss"])
        with pytest.raises(RuntimeError, match="NaN produced by aten"):
            tr.evaluate(InMemoryDataset(bad, labels))
        with torch.no_grad():  # the user's own forward: not checked
            out = model(tvault.batch_to_device(bad, "cpu"))
        assert torch.isnan(out).any()
    finally:
        profiling.enable_nan_checks(False)
    assert np.isnan(tr.evaluate(InMemoryDataset(bad, labels))["eval_loss"])
