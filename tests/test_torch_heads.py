"""The port's task heads against the JAX package's (``vault_tpu/models/vault.py``
heads, ``vault_for_{mlm,vqa,retrieval,images_and_text}``, the resizes, the
itm surgery and the head converters of ``models/convert.py``).

One parameter pytree (the JAX package's init, every leaf moved off its init
value) is bridged with ``params_from_jax`` and fed, with the same numpy
inputs, to both sides at tiny size (2 layers a tower, H 32).  Forwards run
on "fuseqkv+fusemlp+batched": on the JAX side the Pallas kernels are
interpreted, on the port's side the kernel wrappers take their plain
versions for CPU tensors.

Tolerances (those of tests/test_torch_models.py): fp32 atol 5e-5; bf16
atol 3e-2 plus rtol 2^-7 (XLA and torch round bf16 elementwise chains at
other points).  The MLM logits are fp32 sums of bf16 products under bf16
(atol 3e-2 + rtol 2^-7 as well).  Gradients: per leaf max|port - jax| <=
1e-4 * max(1, max|jax|), fp32 (summation order), on the plain route
(``use_pallas=False``: the XLA composition against the plain PyTorch one;
tests/test_torch_models.py holds the kernel route's gradients).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vault_tpu.config import VaultConfig as JVaultConfig
from vault_tpu.config import tiny_text_config as j_tiny_text
from vault_tpu.config import tiny_vilt_config as j_tiny_vilt
from vault_tpu.models import bert as jbert
from vault_tpu.models import convert as jconvert
from vault_tpu.models import vault as jvault
from vault_tpu.training import mlm as jmlm
from vault_tpu_torch.config import VaultConfig, tiny_text_config, tiny_vilt_config
from vault_tpu_torch.convert import param_tree, params_from_jax, params_to_jax
from vault_tpu_torch.models import bert as tbert
from vault_tpu_torch.models import convert as tconvert
from vault_tpu_torch.models import vault as tvault
from vault_tpu_torch.training import mlm as tmlm

IMPL = "fuseqkv+fusemlp+batched"
DTYPES = ["float32", "bfloat16"]
ATOL = {"float32": 5e-5, "bfloat16": 3e-2}
RTOL = {"float32": 0.0, "bfloat16": 2.0 ** -7}
N_ANSWERS = 7


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _cfgs(text=True):
    vilt = dict(image_size=32, patch_size=16, num_patch_tokens=8)
    jcfg = JVaultConfig(vilt=j_tiny_vilt(**vilt),
                        text_tower=j_tiny_text() if text else None)
    tcfg = VaultConfig(vilt=tiny_vilt_config(**vilt),
                       text_tower=tiny_text_config() if text else None)
    return jcfg, tcfg


def _jax_params(jcfg, dtype="float32", seed=0):
    """Backbone and every head; ViLT's modality table resized to 3 rows
    for the pair head; every leaf moved off its init value."""
    keys = jax.random.split(jax.random.PRNGKey(seed), 5)
    p = jvault.init_vault(keys[0], jcfg)
    vcfg = jcfg.resolved_vilt()
    p["mlm"] = jvault.init_mlm_head(keys[1], vcfg)
    p["vqa"] = jvault.init_vqa_head(keys[2], vcfg, N_ANSWERS)
    p["rank"] = jvault.init_rank_head(keys[3], vcfg)
    p["pair"] = jvault.init_pair_head(keys[4], vcfg)
    p["vilt"] = jvault.resize_modality_type_embeddings(p["vilt"], 2)
    leaves, tree = jax.tree.flatten(p)
    rng = np.random.default_rng(7 + seed)
    leaves = [l + jnp.asarray(0.02 * rng.normal(size=l.shape), l.dtype) for l in leaves]
    p = jax.tree.unflatten(tree, leaves)
    return jax.tree.map(lambda x: x.astype(getattr(jnp, dtype)), p)


def _batch(b=3, seq=8, hw=(32, 32), seed=0, pair=False):
    rng = np.random.default_rng(seed)
    am = np.ones((b, seq), np.int32)
    am[1, 5:] = 0
    img = (b, 2, 3, *hw) if pair else (b, 3, *hw)
    pm = np.ones(img[:-3] + hw, np.int32)
    pm[1, ..., 20:] = 0
    return {"input_ids": rng.integers(1, 99, (b, seq)).astype(np.int32),
            "attention_mask": am,
            "token_type_ids": (rng.random((b, seq)) > 0.5).astype(np.int32),
            "pixel_values": rng.normal(size=img).astype(np.float32),
            "pixel_mask": pm}


def _sides(batch, dtype):
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: torch.from_numpy(v) if v.dtype.kind == "f" else torch.from_numpy(
        v.astype(np.int64)) for k, v in batch.items()}
    jb["pixel_values"] = jb["pixel_values"].astype(getattr(jnp, dtype))
    tb["pixel_values"] = tb["pixel_values"].to(getattr(torch, dtype))
    return jb, tb


def _port_params(jp, tcfg):
    return params_from_jax(jax.tree.map(np.asarray, jp), tcfg)


FORWARDS = {"mlm": "vault_for_mlm", "vqa": "vault_for_vqa",
            "retrieval": "vault_for_retrieval", "pair": "vault_for_images_and_text"}


@pytest.mark.parametrize("task", list(FORWARDS))
@pytest.mark.parametrize("dtype", DTYPES)
def test_task_forwards_match_jax(dtype, task):
    """Each ``vault_for_*`` forward, deterministic, on the kernel route."""
    jcfg, tcfg = _cfgs()
    jp = _jax_params(jcfg, dtype)
    batch = _batch(seed=3, pair=task == "pair")
    jb, tb = _sides(batch, dtype)
    ref = jax.jit(lambda p, b: getattr(jvault, FORWARDS[task])(
        p, jcfg, b, use_pallas=IMPL))(jp, jb)
    with torch.inference_mode():
        out = getattr(tvault, FORWARDS[task])(param_tree(_port_params(jp, tcfg)), tcfg,
                                              tb, use_pallas=IMPL)
    shape = {"mlm": (3, 8, 99), "vqa": (3, N_ANSWERS), "retrieval": (3, 1),
             "pair": (3, 2)}[task]
    want_dtype = torch.float32 if task == "mlm" else getattr(torch, dtype)
    assert tuple(out.shape) == shape and out.dtype == want_dtype
    assert ref.dtype == getattr(jnp, "float32" if task == "mlm" else dtype)
    np.testing.assert_allclose(_np(out), _np(ref), atol=ATOL[dtype], rtol=RTOL[dtype])


@pytest.mark.parametrize("dtype", DTYPES)
def test_heads_alone_match_jax(dtype):
    """The four head applies on the same pooled / hidden inputs; the bare
    LayerNorms of the VQA and pair heads take eps 1e-5, the MLM transform
    the config's."""
    jcfg, tcfg = _cfgs()
    jp = _jax_params(jcfg, dtype)
    tp = param_tree(_port_params(jp, tcfg))
    rng = np.random.default_rng(4)
    h = tcfg.vilt.hidden_size
    pooled = rng.normal(size=(5, h)).astype(np.float32) * 3
    hidden = rng.normal(size=(5, 6, h)).astype(np.float32) * 3
    concat = rng.normal(size=(5, 2 * h)).astype(np.float32) * 3
    J = lambda a: jnp.asarray(a, getattr(jnp, dtype))
    T = lambda a: torch.from_numpy(a).to(getattr(torch, dtype))
    vj, vt = jcfg.resolved_vilt(), tcfg.resolved_vilt()
    pairs = [
        (jvault.mlm_head_apply(jp["mlm"], jp["vilt"], vj, J(hidden)),
         tvault.mlm_head_apply(tp["mlm"], tp["vilt"], vt, T(hidden))),
        (jvault.vqa_head_apply(jp["vqa"], vj, J(pooled)),
         tvault.vqa_head_apply(tp["vqa"], vt, T(pooled))),
        (jvault.rank_head_apply(jp["rank"], J(pooled)),
         tvault.rank_head_apply(tp["rank"], T(pooled))),
        (jvault.pair_head_apply(jp["pair"], vj, J(concat)),
         tvault.pair_head_apply(tp["pair"], vt, T(concat))),
    ]
    for ref, out in pairs:
        assert out.shape == ref.shape
        np.testing.assert_allclose(_np(out), _np(ref), atol=ATOL[dtype], rtol=RTOL[dtype])
    # bf16 operands, fp32 logits
    assert pairs[0][1].dtype == torch.float32


def test_head_inits_have_the_jax_shapes_and_draws():
    jcfg, tcfg = _cfgs()
    gen = torch.Generator().manual_seed(0)
    vt, vj = tcfg.vilt, jcfg.vilt
    key = jax.random.PRNGKey(0)
    for ours, ref in (
            (tvault.init_mlm_head(gen, vt), jvault.init_mlm_head(key, vj)),
            (tvault.init_vqa_head(gen, vt, 5), jvault.init_vqa_head(key, vj, 5)),
            (tvault.init_rank_head(gen, vt), jvault.init_rank_head(key, vj)),
            (tvault.init_pair_head(gen, vt, 3, 2), jvault.init_pair_head(key, vj, 3, 2))):
        sd = ours.state_dict()
        want = params_from_jax(jax.tree.map(np.asarray, ref))
        assert {k: tuple(v.shape) for k, v in sd.items()} == \
            {k: tuple(v.shape) for k, v in want.items()}
        for k, v in sd.items():
            if k.endswith(".w"):
                assert 0.01 < v.std().item() < 0.03, k  # normal(0, 0.02)
            else:  # biases 0, LayerNorms 1 / 0
                np.testing.assert_array_equal(v.numpy(), want[k].numpy())


def test_renew_vqa_classifier():
    jcfg, tcfg = _cfgs()
    gen = torch.Generator().manual_seed(1)
    head = tvault.init_vqa_head(gen, tcfg.vilt, 5)
    new = tvault.renew_vqa_classifier(gen, head, 11)
    ref = jvault.renew_vqa_classifier(jax.random.PRNGKey(0),
                                      jvault.init_vqa_head(jax.random.PRNGKey(1),
                                                           jcfg.vilt, 5), 11)
    assert tuple(new["out"]["w"].shape) == ref["out"]["w"].shape == (64, 11)
    assert new["in"] is head["in"] and new["ln"] is head["ln"]
    assert not new["out"]["b"].any()
    as_dict = tvault.renew_vqa_classifier(gen, {"in": head["in"], "ln": head["ln"],
                                                "out": head["out"]}, 4)
    assert isinstance(as_dict, dict) and as_dict["out"]["w"].shape == (64, 4)


@pytest.mark.parametrize("text", [True, False])
def test_resize_token_embeddings(text):
    """The LM tower's table grows when there is one, else ViLT's; old rows
    unchanged and the config's vocabulary follows, as in the JAX package."""
    jcfg, tcfg = _cfgs(text)
    jp = _jax_params(jcfg)
    jnew, jcfg2 = jvault.resize_token_embeddings(jp, jcfg, 130, jax.random.PRNGKey(3))
    sd, tcfg2 = tvault.resize_token_embeddings(
        _port_params(jp, tcfg), tcfg, 130, torch.Generator().manual_seed(3))
    key = "bert.embeddings.word" if text else "vilt.text_embeddings.word"
    want = params_from_jax(jax.tree.map(np.asarray, jnew))[key]
    assert sd[key].shape == want.shape == (130, 32)
    np.testing.assert_array_equal(sd[key][:99].numpy(), want[:99].numpy())
    assert 0.01 < sd[key][99:].std().item() < 0.03
    assert (tcfg2.text_tower or tcfg2.vilt).vocab_size == 130
    assert dataclasses.asdict(tcfg2) == dataclasses.asdict(jcfg2)
    same, cfg3 = tvault.resize_token_embeddings(sd, tcfg2, 100)
    assert same is sd and cfg3 is tcfg2
    grown = tbert.grow_word_embeddings({"embeddings.word": torch.zeros(3, 4)}, 5)
    assert grown["embeddings.word"].shape == (5, 4)


def test_resize_modality_type_embeddings_and_itm_surgery():
    jcfg, tcfg = _cfgs()
    jv = jvault.init_vault(jax.random.PRNGKey(0), jcfg)["vilt"]
    tv = params_from_jax(jax.tree.map(np.asarray, jv))
    for n in (1, 2, 3):
        want = np.asarray(jvault.resize_modality_type_embeddings(jv, n)["modality_type"])
        got = tvault.resize_modality_type_embeddings(tv, n)["modality_type"]
        np.testing.assert_array_equal(got.numpy(), want)
    rng = np.random.default_rng(0)
    itm = {"w": rng.normal(size=(32, 2)).astype(np.float32),
           "b": rng.normal(size=(2,)).astype(np.float32)}
    want = jvault.rank_head_from_itm({k: jnp.asarray(v) for k, v in itm.items()})
    got = tvault.rank_head_from_itm({k: torch.from_numpy(v) for k, v in itm.items()})
    for leaf in ("w", "b"):
        np.testing.assert_array_equal(got["out"][leaf].detach().numpy(),
                                      np.asarray(want["out"][leaf]))


def _hf_heads(rng, h=32, vocab=99, n=5):
    r = lambda *s: torch.from_numpy(rng.normal(size=s).astype(np.float32))
    return {
        "mlm": {"mlm_score.transform.dense.weight": r(h, h),
                "mlm_score.transform.dense.bias": r(h),
                "mlm_score.transform.LayerNorm.weight": r(h),
                "mlm_score.transform.LayerNorm.bias": r(h),
                "mlm_score.bias": r(vocab)},
        "vqa": {"classifier.0.weight": r(2 * h, h), "classifier.0.bias": r(2 * h),
                "classifier.1.weight": r(2 * h), "classifier.1.bias": r(2 * h),
                "classifier.3.weight": r(n, 2 * h), "classifier.3.bias": r(n)},
        "rank": {"rank_output.weight": r(1, h), "rank_output.bias": r(1)},
        "pair": {"classifier.0.weight": r(2 * h, 2 * h), "classifier.0.bias": r(2 * h),
                 "classifier.1.weight": r(2 * h), "classifier.1.bias": r(2 * h),
                 "classifier.3.weight": r(2, 2 * h), "classifier.3.bias": r(2)},
    }


@pytest.mark.parametrize("head", ["mlm", "vqa", "rank", "pair"])
def test_head_converters_both_ways(head):
    """HF head state dict -> the port's head equals the JAX converter's
    tree; through the bridge the head keys go to the JAX layout (the JAX
    converter's tree structure) and back unchanged."""
    sd = _hf_heads(np.random.default_rng(1))[head]
    ours = getattr(tconvert, f"{head}_head_from_torch")(sd)
    ref = getattr(jconvert, f"{head}_head_from_torch")(sd)
    want = params_from_jax(jax.tree.map(np.asarray, ref))
    assert ours.keys() == want.keys()
    for k in ours:
        np.testing.assert_array_equal(ours[k].numpy(), want[k].numpy())
    full = {f"{head}.{k}": v for k, v in ours.items()}
    tree = params_to_jax(full)
    assert jax.tree.structure(tree[head]) == jax.tree.structure(
        jax.tree.map(np.asarray, ref))
    again = params_from_jax(tree)
    assert all(torch.equal(again[k], full[k]) for k in full)


@pytest.mark.parametrize("prefix", ["", "vilt_model."])
def test_rank_head_from_itm_checkpoint(prefix):
    """An itm checkpoint's 2-way head (``itm_score`` or ``itm_score.fc``):
    its row 1 becomes the rank head, as in the JAX converter."""
    rng = np.random.default_rng(2)
    w = torch.from_numpy(rng.normal(size=(2, 32)).astype(np.float32))
    b = torch.from_numpy(rng.normal(size=(2,)).astype(np.float32))
    for name in ("itm_score", "itm_score.fc"):
        sd = {f"{prefix}{name}.weight": w, f"{prefix}{name}.bias": b}
        ours = tconvert.rank_head_from_torch(sd, prefix)
        ref = jconvert.rank_head_from_torch(sd, prefix)
        np.testing.assert_array_equal(ours["out.w"].numpy(), np.asarray(ref["out"]["w"]))
        np.testing.assert_array_equal(ours["out.b"].numpy(), np.asarray(ref["out"]["b"]))


def _grads_vs_jax(jcfg, tcfg, jp, jloss, tloss):
    jl, jg = jax.jit(jax.value_and_grad(jloss))(jp)
    sd = {k: v.requires_grad_() for k, v in _port_params(jp, tcfg).items()}
    loss = tloss(param_tree(sd))
    np.testing.assert_allclose(loss.item(), float(jl), atol=1e-6)
    loss.backward()
    want = params_from_jax(jax.tree.map(np.asarray, jg), tcfg)
    for k, g in want.items():
        got = sd[k].grad
        got = torch.zeros_like(g) if got is None else got
        scale = max(1.0, g.abs().max().item())
        err = (got - g).abs().max().item()
        assert err <= 1e-4 * scale, (k, err, scale)
    return sd, want


def test_mlm_word_table_gradient_matches_jax():
    """Hazard of the tied decoder: with a text tower ViLT reads embeddings,
    not ids, yet the MLM decoder reads its word table, so that table gets a
    gradient, equal to ``jax.grad``'s, as does every other leaf; ViLT's
    pooler gets none (the MLM predicate names it)."""
    jcfg, tcfg = _cfgs()
    jp = _jax_params(jcfg)
    batch = _batch(seed=6)
    jb, tb = _sides(batch, "float32")
    labels = np.where(np.arange(8) % 3 == 0, batch["input_ids"], jmlm.IGNORE)
    sd, want = _grads_vs_jax(
        jcfg, tcfg, jp,
        lambda p: jmlm.mlm_loss(jvault.vault_for_mlm(p, jcfg, jb, use_pallas=False),
                                jnp.asarray(labels)),
        lambda p: tmlm.mlm_loss(tvault.vault_for_mlm(p, tcfg, tb, use_pallas=False),
                                torch.from_numpy(labels)))
    word = "vilt.text_embeddings.word"
    assert want[word].abs().max() > 0 and sd[word].grad is not None
    unreached = tvault.mlm_unreached_leaf(tcfg)
    assert not unreached(word) and unreached("vilt.pooler.w")
    assert sd["vilt.pooler.w"].grad is None and not want["vilt.pooler.w"].any()
    # the other heads are not part of an MLM model
    no_grad = {k for k, v in sd.items() if v.grad is None
               and k.split(".")[0] in ("bert", "vilt", "mlm")}
    assert all(unreached(k) for k in no_grad), no_grad


def test_pair_head_gradient_reaches_every_modality_row():
    """The pair forward runs the backbone with modality slots 1 and 2: the
    resized 3-row table gets a gradient in every row, equal to JAX's."""
    jcfg, tcfg = _cfgs()
    jp = _jax_params(jcfg)
    batch = _batch(seed=7, pair=True)
    jb, tb = _sides(batch, "float32")
    labels = np.array([0, 1, 1])

    def jloss(p):
        logits = jvault.vault_for_images_and_text(p, jcfg, jb, use_pallas=False)
        logp = jax.nn.log_softmax(logits, axis=-1)
        return -jnp.take_along_axis(logp, jnp.asarray(labels)[:, None], -1).mean()

    def tloss(p):
        from vault_tpu_torch.training.losses import softmax_cross_entropy

        logits = tvault.vault_for_images_and_text(p, tcfg, tb, use_pallas=False)
        return softmax_cross_entropy(logits, torch.from_numpy(labels))

    sd, _ = _grads_vs_jax(jcfg, tcfg, jp, jloss, tloss)
    g = sd["vilt.modality_type"].grad
    assert g.shape == (3, 32) and bool((g.abs().sum(-1) > 0).all())
