"""The port's task trainers (``training/task_trainers.py``, the head
factories of ``training/trainer.py``) against the JAX package's, on the CPU
at tiny size (2 layers a tower, H 32, 32x32 images).

Each task runs two optimizer steps, each followed by a dev evaluation, in
both packages from the same weights (the JAX package's init, bridged), on
the same batches (the same shuffle), dropout off, fp32 moments,
``use_pallas=False`` (the kernel route's trainer is held in
tests/test_torch_training.py).

Tolerances:
  * losses (the train window and eval_loss): fp32 atol 1e-5; bf16 compute
    atol 2e-2 (XLA and torch round the bf16 chains at other points);
  * the discrete metrics (accuracies, F1, R@k): equal; R@k in fp32 only
    (under bf16 compute, scores closer than a bf16 rounding can swap
    ranks), bf16 R@k lie in [0, 1];
  * the parameters: per leaf ||Δp_port - Δp_jax|| <= tol * ||Δp_jax||, Δp
    the change over the two steps, fp32 tol 1e-3; and over all leaves
    together, fp32 1e-3, bf16 0.1.  HF AdamW's first steps move each
    element by about lr * sign(gradient), so an element whose gradient is
    rounding noise moves either way: the key projections' biases (gradient
    0 in exact arithmetic) are held finite only, and under bf16 compute the
    noise reaches whole leaves whose gradients are small (LayerNorm scales
    0.26 and 0.29, BERT's token-type table 0.50 measured), so bf16 is held
    in total only.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vault_tpu.config import VaultConfig as JVaultConfig
from vault_tpu.config import tiny_text_config as j_tiny_text
from vault_tpu.config import tiny_vilt_config as j_tiny_vilt
from vault_tpu.data.loader import InMemoryDataset as JDataset
from vault_tpu.models import vault as jvault
from vault_tpu.training import mlm as jmlm
from vault_tpu.training import task_trainers as jtt
from vault_tpu.training.experiment import ExperimentHandler as JHandler
from vault_tpu.training.trainer import TrainArgs as JTrainArgs
from vault_tpu.training.trainer import Trainer as JTrainer
from vault_tpu_torch.config import VaultConfig, tiny_text_config, tiny_vilt_config
from vault_tpu_torch.convert import params_from_jax
from vault_tpu_torch.data.loader import InMemoryDataset
from vault_tpu_torch.training import mlm as tmlm
from vault_tpu_torch.training import task_trainers as ttt
from vault_tpu_torch.training import trainer as ttrainer
from vault_tpu_torch.training.experiment import ExperimentHandler
from vault_tpu_torch.training.trainer import TrainArgs, Trainer

N = 8
SEQ = 8
HW = (32, 32)
N_ANSWERS = 5
LOSS_ATOL = {"float32": 1e-5, "bfloat16": 2e-2}
PARAM_TOL = {"float32": 1e-3, "bfloat16": None}
PARAM_TOTAL_TOL = {"float32": 1e-3, "bfloat16": 0.1}


def _cfgs():
    text = dict(hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
    vilt = dict(image_size=32, patch_size=16, num_patch_tokens=8)
    return (JVaultConfig(vilt=j_tiny_vilt(**vilt), text_tower=j_tiny_text(**text)),
            VaultConfig(vilt=tiny_vilt_config(**vilt), text_tower=tiny_text_config(**text)))


def _feats(rng, n=N, images=None):
    am = np.ones((n, SEQ), np.int32)
    am[::3, 6:] = 0
    img = (n, 3, *HW) if images is None else (n, images, 3, *HW)
    return {"input_ids": rng.integers(5, 99, (n, SEQ)).astype(np.int32),
            "attention_mask": am,
            "token_type_ids": np.zeros((n, SEQ), np.int32),
            "pixel_values": rng.normal(size=img).astype(np.float32),
            "pixel_mask": np.ones(img[:-3] + HW, np.int32)}


def _mlm_accuracy(y_true, y_pred):
    t, p = np.asarray(y_true), np.asarray(y_pred)
    valid = t != jmlm.IGNORE
    return {"eval_accuracy": float((p == t)[valid].mean())}


class JMlmTrainer(JTrainer):
    def calculate_loss(self, logits, labels, weight, train):
        return jmlm.mlm_loss(logits, labels, weight)

    def evaluation_metrics(self, y_true, y_pred):
        return _mlm_accuracy(y_true, y_pred)


class TMlmTrainer(Trainer):
    def calculate_loss(self, logits, labels, weight, train):
        return tmlm.mlm_loss(logits, labels, weight)

    def evaluation_metrics(self, y_true, y_pred):
        return _mlm_accuracy(y_true, y_pred)


class PairsDataset:
    """Retrieval data with ``all_pairs_batches``, numpy only: four texts and
    their images (label 1), one negative each in training; images 1 and 2
    are the same pixels, so every text scores them equally (a tie in each
    text's pool, one of them its positive for texts 1 and 2)."""

    def __init__(self, rng, n=4):
        self.f = _feats(rng, n)
        self.f["pixel_values"][2] = self.f["pixel_values"][1]
        self.n = n
        self.neg = [(i + 1) % n for i in range(n)]

    @property
    def num_examples(self):
        return 2 * self.n

    def num_batches(self, bs):
        return (self.num_examples + bs - 1) // bs

    def _rows(self, texts, images):
        out = {k: v[texts] for k, v in self.f.items() if k.startswith(("input", "att", "tok"))}
        out["pixel_values"] = self.f["pixel_values"][images]
        out["pixel_mask"] = self.f["pixel_mask"][images]
        return out

    def batches(self, bs, shuffle=False, rng=None):
        t = [i for i in range(self.n) for _ in (0, 1)]
        v = [j for i in range(self.n) for j in (i, self.neg[i])]
        lab = np.asarray([[1.0], [0.0]] * self.n, np.float32)
        order = np.arange(len(t))
        if shuffle:
            rng.shuffle(order)
        for s in range(0, len(order), bs):
            sel = order[s:s + bs]
            yield self._rows([t[i] for i in sel], [v[i] for i in sel]), lab[sel]

    def all_pairs_batches(self, bs):
        pairs = [(t, v) for t in range(self.n) for v in range(self.n)]
        for s in range(0, len(pairs), bs):
            chunk = pairs[s:s + bs]
            feats = self._rows([t for t, _ in chunk], [v for _, v in chunk])
            labels = np.asarray([[float(t == v)] for t, v in chunk], np.float32)
            yield feats, labels, [f"i{v}" for _, v in chunk], [f"t{t}" for t, _ in chunk]


def _task(name, jcfg):
    """(features, labels or a dataset, JAX head init, JAX forward, JAX
    trainer class, port factory, port trainer class, trainer kwargs)."""
    rng = np.random.default_rng(11)
    key = jax.random.PRNGKey(1)
    vcfg = jcfg.resolved_vilt()
    if name == "mlm":
        f = _feats(rng)
        pos = (np.arange(SEQ) % 3 == 1)[None] & (f["attention_mask"] == 1)
        labels = np.where(pos, f["input_ids"], jmlm.IGNORE).astype(np.int32)
        f["input_ids"] = np.where(pos, 4, f["input_ids"]).astype(np.int32)
        return (f, labels, ("mlm", jvault.init_mlm_head(key, vcfg)), jvault.vault_for_mlm,
                JMlmTrainer, ttrainer.mlm_apply_fn, TMlmTrainer, {})
    if name == "vqa":
        f = _feats(rng)
        labels = (rng.integers(0, 4, (N, N_ANSWERS)) / 3.0).astype(np.float32)
        labels[[2, 5]] = 0.0  # no usable annotation: weight 0
        f["label_weights"] = (labels.sum(-1) > 0).astype(np.float32)
        return (f, labels, ("vqa", jvault.init_vqa_head(key, vcfg, N_ANSWERS)),
                jvault.vault_for_vqa, jtt.VqaTrainer, ttrainer.vqa_apply_fn,
                ttt.VqaTrainer, {})
    if name == "retrieval":
        return (None, PairsDataset(rng), ("rank", jvault.init_rank_head(key, vcfg)),
                jvault.vault_for_retrieval, jtt.RetrievalTrainer,
                ttrainer.retrieval_apply_fn, ttt.RetrievalTrainer, {})
    if name == "nlvr2":
        return (_feats(rng, images=2), rng.integers(0, 2, N).astype(np.int32),
                ("pair", jvault.init_pair_head(key, vcfg)),
                jvault.vault_for_images_and_text, jtt.ImagesAndTextTrainer,
                ttrainer.images_and_text_apply_fn, ttt.ImagesAndTextTrainer, {})
    cls = lambda p, c, b, **kw: jvault.vault_for_classification(p, c, b, head_dropout=0.0, **kw)
    if name == "bloomberg":
        labels = rng.integers(0, 2, (N, 2)).astype(np.float32)
        return (_feats(rng), labels, ("head", jvault.init_classifier_head(key, 32, 2)),
                cls, jtt.BloombergTrainer, "classifier", ttt.BloombergTrainer, {})
    preprocessed = name == "mvsa_preprocessed"
    labels = rng.integers(0, 3, N if preprocessed else (N, 2)).astype(np.int32)
    return (_feats(rng), labels,
            ("head", jvault.init_classifier_head(key, 32, 3 if preprocessed else 6)),
            cls, jtt.MvsaTrainer, "classifier", ttt.MvsaTrainer,
            {"preprocessed": preprocessed})


TASKS = ["mlm", "vqa", "retrieval", "nlvr2", "bloomberg", "mvsa_dual",
         "mvsa_preprocessed"]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("task", TASKS)
def test_task_trainer_matches_jax(tmp_path, task, dtype):
    jcfg, tcfg = _cfgs()
    feats, data, (head_key, head), jforward, jcls, factory, tcls, kw = _task(task, jcfg)
    jp = jvault.init_vault(jax.random.PRNGKey(0), jcfg)
    jp[head_key] = head
    if task == "nlvr2":
        jp["vilt"] = jvault.resize_modality_type_embeddings(jp["vilt"], 2)
    jp = jax.tree.map(np.asarray, jp)
    if feats is None:
        jds = tds = data
    else:
        jds, tds = JDataset(feats, data), InMemoryDataset(feats, data)
    # eval_steps=1: a dev evaluation after each step, and a fresh loss
    # window for each, so the JAX trainer compiles its step once (a window's
    # second step takes the first's sharded accumulator and compiles again)
    args = dict(lr=1e-3, train_batch_size=4, eval_batch_size=4, num_train_epochs=1,
                eval_steps=1, seed=3, opt_state_dtype="float32", compute_dtype=dtype,
                use_pallas=False, remat=False, disable_tqdm=True)

    def japply(p, batch, deterministic, rng):
        return jforward(p, jcfg, batch, deterministic=deterministic, rng=rng,
                        use_pallas=False, remat=False)

    jh = JHandler(str(tmp_path / "jax"), "Toy")
    jtr = jcls(japply, jax.tree.map(jnp.asarray, jp), JTrainArgs(num_data_shards=1, **args),
               jds, dev_dataset=jds, exp_handler=jh, **kw)
    jtr.train()
    targs = TrainArgs(**args)
    apply_fn = (ttrainer.classifier_apply_fn(tcfg, targs, head_dropout=0.0)
                if factory == "classifier" else factory(tcfg, targs))
    th = ExperimentHandler(str(tmp_path / "torch"), "Toy")
    p0 = params_from_jax(jp, tcfg)
    ttr = tcls(apply_fn, p0, targs, tds, dev_dataset=tds, exp_handler=th,
               device="cpu", **kw)
    ttr.train()

    ours, ref = th._series, jh._series
    assert ours.keys() == ref.keys() and len(ours["train_loss"]) == 2
    for k in ref:
        if "loss" in k:
            np.testing.assert_allclose(ours[k], ref[k], atol=LOSS_ATOL[dtype], err_msg=k)
        elif "-R@" in k and dtype == "bfloat16":
            assert all(0.0 <= v <= 1.0 for v in ours[k]), k
        else:
            assert ours[k] == pytest.approx(ref[k], abs=1e-12), k
    if task == "retrieval":
        assert {"image-R@1", "text-R@5", "text-R@10"} <= ref.keys()
    if task in ("bloomberg", "mvsa_dual", "mvsa_preprocessed"):
        assert ttr.args.early_stopping_metric == "eval_loss" and not ttr.args.higher_better
    want = params_from_jax(jax.tree.map(np.asarray, jtr.params), tcfg)
    err2 = ref2 = 0.0
    for k, w in want.items():
        got = ttr.params[k].detach()
        assert torch.isfinite(got).all(), k
        if k.endswith(".k.b"):
            continue
        d_ref, d_ours = w - p0[k], got - p0[k]
        err = torch.linalg.vector_norm(d_ours - d_ref).item()
        norm = torch.linalg.vector_norm(d_ref).item()
        if PARAM_TOL[dtype] is not None:
            assert err <= PARAM_TOL[dtype] * norm + 1e-12, (k, err, norm)
        err2, ref2 = err2 + err ** 2, ref2 + norm ** 2
    assert err2 ** 0.5 <= PARAM_TOTAL_TOL[dtype] * ref2 ** 0.5, (err2, ref2)


def test_stop_on_eval_loss_copies_the_args():
    """Bloomberg and MVSA stop on eval_loss, lower-better, on a copy of the
    args: the caller's TrainArgs keep their values."""
    _, tcfg = _cfgs()
    args = TrainArgs(disable_tqdm=True)
    feats = _feats(np.random.default_rng(0))
    ds = InMemoryDataset(feats, np.zeros(N, np.int32))
    for cls in (ttt.BloombergTrainer, ttt.MvsaTrainer):
        tr = cls(ttrainer.classifier_apply_fn(tcfg, args), {"w": torch.zeros(1)}, args, ds,
                 device="cpu")
        assert tr.args is not args and tr.args.early_stopping_metric == "eval_loss"
        assert not tr.early_stopping.higher_better
    assert args.early_stopping_metric == "eval_accuracy" and args.higher_better


def test_bloomberg_metrics_are_exact_match_and_per_column_f1():
    """Multi-label metrics equal the JAX package's, exact match over the
    label vector (raveling would give 0.75 here, not 0.5)."""
    y = [[1, 0], [0, 1], [1, 1], [0, 0]]
    p = [[1, 0], [0, 0], [1, 1], [0, 1]]
    ours = ttt.BloombergTrainer.evaluation_metrics(None, y, p)
    assert ours == jtt.BloombergTrainer.evaluation_metrics(None, y, p)
    assert ours["eval_accuracy"] == 0.5


def test_head_factories_refuse_a_late_merge():
    _, tcfg = _cfgs()
    with pytest.raises(ValueError, match="merge_at_layer"):
        ttrainer.vqa_apply_fn(tcfg, TrainArgs(merge_to=4, merge_at_layer=1))


class ScoredPairs:
    """All-pairs batches whose score is a feature (``s``), for a stub
    forward: text 0's positive ties a negative at 0.9 that comes after it,
    text 1's at 0.5, text 2's positive ranks third."""

    SCORES = np.array([[0.9, 0.9, 0.1, 0.2],
                       [0.3, 0.5, 0.2, 0.5],
                       [0.8, 0.7, 0.6, 0.1],
                       [0.0, 0.1, 0.2, 0.3]], np.float32)

    def all_pairs_batches(self, bs):
        pairs = [(t, v) for t in range(4) for v in range(4)]
        for s in range(0, len(pairs), bs):
            chunk = pairs[s:s + bs]
            feats = {"s": np.asarray([[self.SCORES[t, v]] for t, v in chunk])}
            labels = np.asarray([[float(t == v)] for t, v in chunk], np.float32)
            yield feats, labels, [f"i{v}" for _, v in chunk], [f"t{t}" for t, _ in chunk]


def test_retrieval_recall_keeps_a_tied_positive():
    """R@k from the score pools: an equal-scored positive is never lost
    (max-merge on ties), as in the JAX package; text R@1 counts texts 0, 1
    and 3, R@5 all four."""
    args = dict(eval_batch_size=3, disable_tqdm=True)
    ds = InMemoryDataset({"s": np.zeros((4, 1), np.float32)}, np.zeros((4, 1), np.float32))
    jtr = jtt.RetrievalTrainer(lambda p, b, deterministic, rng: b["s"] + 0 * p["w"],
                               {"w": jnp.zeros(())},
                               JTrainArgs(num_data_shards=1, **args),
                               JDataset({"s": np.zeros((4, 1), np.float32)},
                                        np.zeros((4, 1), np.float32)))
    ttr = ttt.RetrievalTrainer(lambda p, b, deterministic, gen: b["s"], {"w": torch.zeros(())},
                               TrainArgs(**args), ds, device="cpu")
    ours, ref = ttr.evaluate(ScoredPairs()), jtr.evaluate(ScoredPairs())
    assert ours.keys() == ref.keys()
    for k in ref:
        assert ours[k] == pytest.approx(ref[k], abs=1e-6), k
    assert ours["text-R@1"] == 0.75 and ours["text-R@5"] == 1.0
