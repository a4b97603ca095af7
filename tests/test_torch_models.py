"""The port's towers and the VAuLT classifier against the JAX package.

One parameter pytree (the JAX package's init) is bridged with
``params_from_jax`` and fed, with the same numpy inputs, to both sides, in
the ``entry()`` input layout at tiny size.  Each model runs under
``use_pallas=False`` and under "fuseqkv+fusemlp+batched": on the JAX side
that interprets the Pallas kernels, on the port's side it goes through the
kernel wrappers, which take their plain versions for CPU tensors.

Tolerances: fp32 atol 5e-5 (measured max 3.8e-6, ViLT hidden state); bf16
atol 3e-2 plus rtol 2^-7 (one bf16 ulp): XLA and torch round bf16
elementwise chains at different points, so hidden states of magnitude ~2
differ by up to two bf16 ulps (measured max 3.1e-2 on the BERT hidden
state, 4.0e-3 on logits and pooler).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from vault_tpu.config import VaultConfig as JVaultConfig
from vault_tpu.config import tiny_text_config as j_tiny_text
from vault_tpu.config import tiny_vilt_config as j_tiny_vilt
from vault_tpu.models import bert as jbert
from vault_tpu.models import vilt as jvilt
from vault_tpu.models import vault as jvault
from vault_tpu_torch.config import VaultConfig, tiny_text_config, tiny_vilt_config
from vault_tpu_torch.convert import params_from_jax
from vault_tpu_torch.models import bert as tbert
from vault_tpu_torch.models import vilt as tvilt
from vault_tpu_torch.models import vault as tvault

IMPLS = [False, "fuseqkv+fusemlp+batched"]
DTYPES = ["float32", "bfloat16"]
ATOL = {"float32": 5e-5, "bfloat16": 3e-2}
RTOL = {"float32": 0.0, "bfloat16": 2.0 ** -7}


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _cfgs(**text_kw):
    jcfg = JVaultConfig(vilt=j_tiny_vilt(), text_tower=j_tiny_text(**text_kw))
    tcfg = VaultConfig(vilt=tiny_vilt_config(), text_tower=tiny_text_config(**text_kw))
    return jcfg, tcfg


def _jax_params(jcfg, dtype):
    p = jvault.init_vault(jax.random.PRNGKey(0), jcfg)
    p["head"] = jvault.init_classifier_head(jax.random.PRNGKey(1),
                                            jcfg.vilt.hidden_size, 3)
    # give the zero-initialised leaves (biases, CLS, position grid) values
    leaves, tree = jax.tree.flatten(p)
    rng = np.random.default_rng(7)
    leaves = [l + jnp.asarray(0.02 * rng.normal(size=l.shape), l.dtype)
              for l in leaves]
    p = jax.tree.unflatten(tree, leaves)
    return jax.tree.map(lambda x: x.astype(getattr(jnp, dtype)), p)


def _model(tcfg, jparams, dtype):
    m = tvault.VaultForClassification(tcfg, device="cpu",
                                      dtype=getattr(torch, dtype))
    m.load_state_dict(params_from_jax(jax.tree.map(np.asarray, jparams), tcfg))
    return m


def _batch(cfg_vocab=99, b=3, seq=8, hw=(64, 64), seed=0):
    """entry() layout at tiny size, with ragged text and image masks."""
    rng = np.random.default_rng(seed)
    am = np.ones((b, seq), np.int32)
    am[1 % b, 5:] = 0
    pm = np.ones((b, *hw), np.int32)
    pm[1 % b, :, 40:] = 0
    pm[2 % b, 33:, :] = 0
    return {"input_ids": rng.integers(1, cfg_vocab, (b, seq)).astype(np.int32),
            "attention_mask": am,
            "token_type_ids": (rng.random((b, seq)) > 0.5).astype(np.int32),
            "pixel_values": rng.normal(size=(b, 3, *hw)).astype(np.float32),
            "pixel_mask": pm}


def _sides(batch, dtype):
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: torch.from_numpy(v) if v.dtype.kind == "f" else torch.from_numpy(
        v.astype(np.int64)) for k, v in batch.items()}
    jb["pixel_values"] = jb["pixel_values"].astype(getattr(jnp, dtype))
    tb["pixel_values"] = tb["pixel_values"].to(getattr(torch, dtype))
    return jb, tb


@pytest.mark.parametrize("dtype", DTYPES)
def test_params_from_jax_round_trips_every_leaf(dtype):
    jcfg, tcfg = _cfgs()
    jp = jax.tree.map(np.asarray, _jax_params(jcfg, dtype))
    sd = params_from_jax(jp, tcfg)
    model = tvault.VaultForClassification(tcfg, device="cpu",
                                          dtype=getattr(torch, dtype))
    assert set(sd) == set(model.state_dict())
    n = 0
    for path, leaf in jax.tree_util.tree_leaves_with_path(jp):
        keys = [k.key for k in path]
        if "layers" in keys:
            cut = keys.index("layers") + 1
            for i in range(leaf.shape[0]):
                t = sd[".".join(keys[:cut] + [str(i)] + keys[cut:])]
                np.testing.assert_array_equal(_np(t), leaf[i].astype(np.float32))
                n += 1
        else:
            np.testing.assert_array_equal(_np(sd[".".join(keys)]),
                                          leaf.astype(np.float32))
            n += 1
    assert n == len(sd)
    model.load_state_dict(sd)
    assert model["bert"]["layers"][1]["mlp_in"]["w"].dtype == getattr(torch, dtype)


def test_params_from_jax_rejects_wrong_depth():
    jcfg, tcfg = _cfgs()
    jp = jax.tree.map(np.asarray, _jax_params(jcfg, "float32"))
    _, deeper = _cfgs(num_hidden_layers=3)
    with pytest.raises(ValueError, match="layer axis"):
        params_from_jax(jp, deeper)


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_bert_apply_matches_jax(dtype, impl):
    jcfg, tcfg = _cfgs()
    jp = _jax_params(jcfg, dtype)
    model = _model(tcfg, jp, dtype)
    jb, tb = _sides(_batch(), dtype)
    ref = jbert.bert_apply(jp["bert"], jcfg.text_tower, jb["input_ids"],
                           jb["attention_mask"], jb["token_type_ids"],
                           use_pallas=impl)
    with torch.inference_mode():
        out = tbert.bert_apply(model["bert"], tcfg.text_tower, tb["input_ids"],
                               tb["attention_mask"], tb["token_type_ids"],
                               use_pallas=impl)
    assert out.dtype == getattr(torch, dtype) and out.shape == (3, 8, 32)
    np.testing.assert_allclose(_np(out), _np(ref), atol=ATOL[dtype],
                               rtol=RTOL[dtype])


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_vilt_apply_matches_jax_ragged_pixels(dtype, impl):
    """ViLT alone on its own text ids, with ragged pixel masks: exercises
    the valid-first patch order and the per-image position interpolation."""
    jcfg, tcfg = _cfgs()
    jp = _jax_params(jcfg, dtype)
    model = _model(tcfg, jp, dtype)
    jb, tb = _sides(_batch(seed=1), dtype)
    ref = jvilt.vilt_apply(jp["vilt"], jcfg.vilt, use_pallas=impl, **jb)
    with torch.inference_mode():
        out = tvilt.vilt_apply(model["vilt"], tcfg.vilt, use_pallas=impl, **tb)
    np.testing.assert_array_equal(out.attention_mask.numpy(),
                                  np.asarray(ref.attention_mask))
    assert out.last_hidden_state.shape == (3, 8 + 1 + 16, 32)
    for o, r in ((out.last_hidden_state, ref.last_hidden_state),
                 (out.pooler_output, ref.pooler_output)):
        np.testing.assert_allclose(_np(o), _np(r), atol=ATOL[dtype],
                                   rtol=RTOL[dtype])


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_vault_for_classification_matches_jax(dtype, impl):
    jcfg, tcfg = _cfgs()
    jp = _jax_params(jcfg, dtype)
    model = _model(tcfg, jp, dtype)
    batch = _batch(seed=2)
    jb, tb = _sides(batch, dtype)
    ref_logits = jvault.vault_for_classification(jp, jcfg, jb, head_dropout=0.0,
                                                 deterministic=True,
                                                 use_pallas=impl)
    ref_pool = jvault.vault_apply(jp, jcfg, use_pallas=impl, **jb).pooler_output
    with torch.inference_mode():
        logits = model(tb, use_pallas=impl)
        pool = tvault.vault_apply(model, tcfg, use_pallas=impl, **tb).pooler_output
    assert logits.shape == (3, 3) and logits.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(_np(logits), _np(ref_logits), atol=ATOL[dtype],
                               rtol=RTOL[dtype])
    np.testing.assert_allclose(_np(pool), _np(ref_pool), atol=ATOL[dtype],
                               rtol=RTOL[dtype])


def test_bertweet_tower_matches_jax():
    """RoBERTa-style tower: position ids from the mask, one token type (the
    guard zeroes incoming token_type_ids), pad id 1."""
    kw = dict(type_vocab_size=1, pad_token_id=1, position_embedding_style="roberta")
    jcfg, tcfg = _cfgs(**kw)
    jp = _jax_params(jcfg, "float32")
    model = _model(tcfg, jp, "float32")
    jb, tb = _sides(_batch(seed=3), "float32")
    ref = jvault.vault_for_classification(jp, jcfg, jb, head_dropout=0.0,
                                          deterministic=True, use_pallas=False)
    with torch.inference_mode():
        out = model(tb)
    np.testing.assert_allclose(_np(out), _np(ref), atol=ATOL["float32"])


def test_model_init_is_seeded():
    _, tcfg = _cfgs()
    a = tvault.VaultForClassification(tcfg, device="cpu", seed=3).state_dict()
    b = tvault.VaultForClassification(tcfg, device="cpu", seed=3).state_dict()
    c = tvault.VaultForClassification(tcfg, device="cpu", seed=4).state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["vilt.layers.0.q.w"], c["vilt.layers.0.q.w"])
    assert torch.all(a["bert.embeddings.word"][0] == 0)  # padding row


def test_unported_paths_raise():
    _, tcfg = _cfgs()
    model = tvault.VaultForClassification(tcfg, device="cpu")
    _, tb = _sides(_batch(), "float32")
    with pytest.raises(ValueError, match="remat"):
        tvault.vault_for_classification(model, tcfg, tb, remat="everything")
    # remat="dots" is ported (tests/test_torch_trainer_options.py)
    logits = tvault.vault_for_classification(model, tcfg, tb, remat="dots")
    assert logits.requires_grad and bool(torch.isfinite(logits).all())
    # token merging is ported (tests/test_torch_token_merge.py): the 16
    # patch tokens merge down to 4, the mask follows
    with torch.inference_mode():
        out = tvault.vault_apply(model, tcfg, merge_patches_to=4, **tb)
    assert out.last_hidden_state.shape == (3, 8 + 1 + 4, 32)
    assert out.attention_mask.shape == (3, 8 + 1 + 4)


@pytest.mark.slow
def test_vault_base_geometry_matches_jax_fp32():
    """Full published widths (bert-base-uncased + ViLT-B/32), batch 1, fp32."""
    from vault_tpu.presets import vault_base as j_vault_base
    from vault_tpu_torch.presets import vault_base

    jcfg, tcfg = j_vault_base("bert-base-uncased"), vault_base("bert-base-uncased")
    jp = jvault.init_vault(jax.random.PRNGKey(0), jcfg)
    jp["head"] = jvault.init_classifier_head(jax.random.PRNGKey(1), 768, 3)
    model = _model(tcfg, jp, "float32")
    batch = _batch(cfg_vocab=30522, b=1, seq=40, hw=(384, 608), seed=4)
    jb, tb = _sides(batch, "float32")
    ref = jax.jit(lambda p, b: jvault.vault_apply(p, jcfg, use_pallas=False,
                                                  **b).pooler_output)(jp, jb)
    with torch.inference_mode():
        out = tvault.vault_apply(model, tcfg, use_pallas=False, **tb).pooler_output
    np.testing.assert_allclose(_np(out), _np(ref), atol=ATOL["float32"])


def test_params_to_jax_inverts_params_from_jax():
    from vault_tpu_torch.convert import param_tree, params_to_jax

    jcfg, tcfg = _cfgs()
    jp = jax.tree.map(np.asarray, _jax_params(jcfg, "bfloat16"))
    sd = params_from_jax(jp, tcfg)
    back = params_to_jax(sd)
    assert jax.tree.structure(back) == jax.tree.structure(jp)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jp)):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    tree = param_tree(sd)
    assert tree["bert"]["layers"][1]["mlp_in"]["w"] is sd["bert.layers.1.mlp_in.w"]
    assert len(tree["vilt"]["layers"]) == tcfg.vilt.num_hidden_layers


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("impl", IMPLS)
def test_vault_gradients_match_jax(impl, remat):
    """Gradients of the classifier's CE loss with respect to every
    parameter: port autograd (through the kernels' Functions, which run
    their plain versions on the CPU) against jax.value_and_grad of the JAX
    package's vault_for_classification (Pallas kernels interpreted), fp32,
    dropout off.  Per leaf, max|port - jax| <= 1e-4 * max(1, max|jax|):
    summation order and the Pallas kernels' A&S erf (measured max 3e-6)."""
    from vault_tpu_torch.convert import param_tree
    from vault_tpu_torch.training.losses import softmax_cross_entropy

    jcfg, tcfg = _cfgs()
    jp = _jax_params(jcfg, "float32")
    batch = _batch(seed=5)
    jb, tb = _sides(batch, "float32")
    labels = np.array([0, 2, 1])

    def jloss(p):
        logits = jvault.vault_for_classification(p, jcfg, jb, head_dropout=0.0,
                                                 deterministic=True,
                                                 use_pallas=impl, remat=remat)
        logp = jax.nn.log_softmax(logits, axis=-1)
        return -jnp.take_along_axis(logp, jnp.asarray(labels)[:, None], -1).mean()

    jl, jg = jax.value_and_grad(jloss)(jp)
    sd = {k: v.requires_grad_() for k, v in
          params_from_jax(jax.tree.map(np.asarray, jp), tcfg).items()}
    logits = tvault.vault_for_classification(param_tree(sd), tcfg, tb,
                                             head_dropout=0.0, deterministic=True,
                                             use_pallas=impl, remat=remat)
    loss = softmax_cross_entropy(logits, torch.as_tensor(labels))
    np.testing.assert_allclose(loss.item(), float(jl), atol=1e-6)
    loss.backward()
    want = params_from_jax(jax.tree.map(np.asarray, jg), tcfg)
    for k, g in want.items():
        got = sd[k].grad
        got = torch.zeros_like(g) if got is None else got
        scale = max(1.0, g.abs().max().item())
        err = (got - g).abs().max().item()
        assert err <= 1e-4 * scale, (k, err, scale)


# ---------------------------------------------------------------------------
# int8 serving and the fused LN->QKV path.  The JAX side quantizes its tree
# (``quantize_model_params``), the port its model (``quantize``) from the
# same fp weights: equal codes and scales (tests/test_torch_quantize.py).
# "fuselnqkv+fusemlp" interprets the Pallas kernels on the JAX side and takes
# the kernels' plain versions on the port's.  Tolerances as above: fp32
# atol 5e-5 (measured <= 1.8e-7 on the w8a8 pooler and logits; a code could
# flip where the two sides' fp32 values differ by an ulp at a rounding
# boundary, which these inputs do not meet), bf16 atol 3e-2 + rtol 2^-7
# (measured <= 2.9e-3 w8a8, 3.1e-2 on the fp fuselnqkv hidden state).
# ---------------------------------------------------------------------------

W8A8_IMPLS = [False, "fuselnqkv+fusemlp"]


@pytest.mark.parametrize("impl", W8A8_IMPLS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_vault_w8a8_matches_jax(dtype, impl):
    from vault_tpu.ops.quantize import quantize_model_params

    jcfg, tcfg = _cfgs()
    jp = _jax_params(jcfg, dtype)
    jqp = quantize_model_params(jp, mode="w8a8")
    model = _model(tcfg, jp, dtype).quantize("w8a8")
    assert model.use_pallas == "fuselnqkv+fusemlp"
    # the MLP codes K-major, as the int8 MLP kernels take them
    from vault_tpu_torch.ops.quantize import is_k_major

    assert all(is_k_major(lp[n]["w_q8"]) for tower in ("vilt", "bert")
               for lp in model[tower]["layers"] for n in ("mlp_in", "mlp_out"))
    jb, tb = _sides(_batch(seed=6), dtype)
    ref_logits = jvault.vault_for_classification(jqp, jcfg, jb, head_dropout=0.0,
                                                 deterministic=True, use_pallas=impl)
    ref_pool = jvault.vault_apply(jqp, jcfg, use_pallas=impl, **jb).pooler_output
    with torch.inference_mode():
        logits = model(tb, use_pallas=impl)
        pool = tvault.vault_apply(model, tcfg, use_pallas=impl, **tb).pooler_output
    assert logits.shape == (3, 3) and logits.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(_np(logits), _np(ref_logits), atol=ATOL[dtype],
                               rtol=RTOL[dtype])
    np.testing.assert_allclose(_np(pool), _np(ref_pool), atol=ATOL[dtype],
                               rtol=RTOL[dtype])


@pytest.mark.parametrize("impl", [False, "fusemlp", "fuseqkv+fusemlp+batched"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_vault_w8_matches_jax(dtype, impl):
    """int8 weights only: "fusemlp" interprets the q8 Pallas kernels on the
    JAX side and takes the q8 kernels' plain versions on the port's; the
    last selector is what "auto" (``serving_impl("w8")``) is on the card."""
    from vault_tpu.ops.quantize import quantize_model_params

    jcfg, tcfg = _cfgs()
    jp = _jax_params(jcfg, dtype)
    jqp = quantize_model_params(jp, mode="w8")
    model = _model(tcfg, jp, dtype).quantize("w8")
    assert model.use_pallas == "auto" and model.quant_mode == "w8"
    jb, tb = _sides(_batch(seed=9), dtype)
    ref_logits = jvault.vault_for_classification(jqp, jcfg, jb, head_dropout=0.0,
                                                 deterministic=True, use_pallas=impl)
    ref_pool = jvault.vault_apply(jqp, jcfg, use_pallas=impl, **jb).pooler_output
    with torch.inference_mode():
        logits = model(tb, use_pallas=impl)
        pool = tvault.vault_apply(model, tcfg, use_pallas=impl, **tb).pooler_output
    assert logits.shape == (3, 3) and logits.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(_np(logits), _np(ref_logits), atol=ATOL[dtype],
                               rtol=RTOL[dtype])
    np.testing.assert_allclose(_np(pool), _np(ref_pool), atol=ATOL[dtype],
                               rtol=RTOL[dtype])


@pytest.mark.parametrize("dtype", DTYPES)
def test_vault_fuselnqkv_fp_matches_jax(dtype):
    """The bf16/fp32 serving selector with the fused LN->QKV kernel."""
    impl = "fuselnqkv+fusemlp+batched"
    jcfg, tcfg = _cfgs()
    jp = _jax_params(jcfg, dtype)
    model = _model(tcfg, jp, dtype)
    jb, tb = _sides(_batch(seed=7), dtype)
    ref = jvault.vault_apply(jp, jcfg, use_pallas=impl, **jb)
    with torch.inference_mode():
        out = tvault.vault_apply(model, tcfg, use_pallas=impl, **tb)
    for o, r in ((out.last_hidden_state, ref.last_hidden_state),
                 (out.pooler_output, ref.pooler_output)):
        np.testing.assert_allclose(_np(o), _np(r), atol=ATOL[dtype],
                                   rtol=RTOL[dtype])


def test_w8a8_model_stays_close_to_the_fp_model():
    """The quantized classifier against its own fp32 weights: the pooler
    within the JAX package's w8a8 budget (0.05, test_quantize.py)."""
    jcfg, tcfg = _cfgs()
    jp = _jax_params(jcfg, "float32")
    fp, q = _model(tcfg, jp, "float32"), _model(tcfg, jp, "float32").quantize("w8a8")
    _, tb = _sides(_batch(seed=8), "float32")
    with torch.inference_mode():
        a = tvault.vault_apply(fp, tcfg, **tb).pooler_output
        b = tvault.vault_apply(q, tcfg, use_pallas=q.use_pallas, **tb).pooler_output
    assert 0.0 < (a - b).abs().max().item() < 0.05
