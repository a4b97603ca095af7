"""The port's token merging (ToMe) against the JAX package's, on the CPU at
tiny size: ``ops/token_merge.py`` step by step (the merge decisions
themselves, the indices each step merges and keeps, ``order[:, :r]``, and
the B slots they land in, ``dst``, compared directly), ``vilt_apply`` and
``vault_for_classification`` merged at the embeddings and mid-stack,
``VaultPipeline``, and training through the merge (gradients against
``jax.grad`` and central differences, a few ``Trainer`` steps against the
JAX trainer).  Mirrors tests/test_token_merge.py and
tests/test_token_merge_train.py case by case, each case on the port alone
and against the JAX package on the same numpy inputs and parameters
(``convert.params_from_jax``).

Tolerances: the merge step in fp32, atol 1e-6 (the port adds a target's
merged rows with ``scatter_add_``, the JAX package with a one-hot product:
the same fp32 terms in another order); in bf16 the step's output is the
same bf16 rounding of those fp32 sums, so equal within one bf16 ulp
(rtol 2^-7).  Models: the model tests' tolerances (fp32 atol 5e-5; bf16
atol 3e-2 plus rtol 2^-7, tests/test_torch_models.py).  Trainer: the first
loss atol 1e-5, the curve atol 5e-3 (tests/test_torch_training.py).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from vault_tpu.config import VaultConfig as JVaultConfig
from vault_tpu.config import tiny_text_config as j_tiny_text
from vault_tpu.config import tiny_vilt_config as j_tiny_vilt
from vault_tpu.models import vault as jvault
from vault_tpu.models import vilt as jvilt
from vault_tpu.ops import token_merge as jtm
from vault_tpu_torch.config import VaultConfig, tiny_text_config, tiny_vilt_config
from vault_tpu_torch.convert import params_from_jax
from vault_tpu_torch.models import vault as tvault
from vault_tpu_torch.models import vilt as tvilt
from vault_tpu_torch.ops import token_merge as ttm

DTYPES = ["float32", "bfloat16"]
ATOL = {"float32": 5e-5, "bfloat16": 3e-2}
RTOL = {"float32": 0.0, "bfloat16": 2.0 ** -7}
IMPLS = [False, "fuseqkv+fusemlp+batched"]


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _jax_decisions(x, sizes, mask, r):
    """The JAX package's decisions of one step (order, dst), in its own
    operations (vault_tpu/ops/token_merge.py bipartite_merge_step, the lines
    before the merge): the function returns only the merged tokens."""
    xa, xb = x[:, 0::2], x[:, 1::2]
    ma = mask[:, 0::2].astype(jnp.float32)
    mb = mask[:, 1::2].astype(jnp.float32)
    fa, fb = xa.astype(jnp.float32), xb.astype(jnp.float32)
    na = fa / jnp.maximum(jnp.linalg.norm(fa, axis=-1, keepdims=True), 1e-6)
    nb = fb / jnp.maximum(jnp.linalg.norm(fb, axis=-1, keepdims=True), 1e-6)
    sim_raw = jnp.einsum("bah,bkh->bak", na, nb, preferred_element_type=jnp.float32)
    sim = jnp.where(mb[:, None, :] > 0, sim_raw, jtm._NEG)
    best, val = jnp.argmax(sim, axis=-1), jnp.max(sim, axis=-1)
    pair_ok = val > jtm._NEG / 2
    best_inv = jnp.argmax(jnp.where(mb[:, None, :] > 0, jtm._NEG, sim_raw), axis=-1)
    rank_val = jnp.where(ma > 0, val, jnp.inf)
    order = jnp.argsort(-rank_val, axis=1)
    dst = jnp.take_along_axis(jnp.where(pair_ok, best, best_inv), order[:, :r], axis=1)
    return np.asarray(order), np.asarray(dst)


def _both(x, mask, dtype):
    jx = jnp.asarray(x).astype(getattr(jnp, dtype))
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    return jx, jnp.asarray(mask), tx, torch.from_numpy(mask.astype(np.int64))


def _assert_step_equal(ours, ref, dtype):
    (y, s, m), (jy, js, jm) = ours, ref
    np.testing.assert_array_equal(m.numpy(), np.asarray(jm))
    np.testing.assert_allclose(s.numpy(), np.asarray(js), atol=1e-6, rtol=0)
    tol = dict(atol=1e-6, rtol=0) if dtype == "float32" else dict(atol=0, rtol=2.0 ** -7)
    np.testing.assert_allclose(_np(y), _np(jy), **tol)


# ---------------------------------------------------------------------------
# The merge step
# ---------------------------------------------------------------------------

def test_merge_schedule_215_to_87():
    assert ttm.merge_schedule(215, 87) == [108, 20]
    assert ttm.merge_schedule(16, 16) == [] and ttm.merge_schedule(16, 0) == [8, 4, 2, 1]


@pytest.mark.parametrize("dtype", DTYPES)
def test_merge_tokens_to_shapes_and_sizes(dtype):
    """215 -> 87 (two steps), every original token represented once; equal
    to the JAX package's cascade."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 215, 8)).astype(np.float32)
    mask = np.ones((2, 215), np.int32)
    jx, jm, tx, tm = _both(x, mask, dtype)
    y, sizes, m = ttm.merge_tokens_to(tx, tm, 87)
    assert y.shape == (2, 87, 8) and y.dtype == getattr(torch, dtype)
    assert sizes.shape == (2, 87) and m.shape == (2, 87)
    np.testing.assert_allclose(sizes.sum(1).numpy(), 215.0, rtol=1e-6)
    assert bool(m.all()) and float(sizes.min()) >= 1.0
    _assert_step_equal((y, sizes, m), jtm.merge_tokens_to(jx, jm, 87), dtype)


@pytest.mark.parametrize("invalid", [0, 30, 214])
@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("dtype", DTYPES)
def test_merge_decisions_match_jax(dtype, seed, invalid):
    """The indices each step of 215 -> 87 merges (``order[:, :r]``) and
    keeps, and the B slots the merged rows land in (``dst``), equal the
    JAX package's, on random Gaussian features with ``invalid`` padded
    tokens at the end of each row (214: one valid token, so the no-target
    transfer runs); then the step's outputs."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(2, 215, 16)).astype(np.float32)
    mask = np.ones((2, 215), np.int32)
    if invalid:
        mask[:, -invalid:] = 0
    jx, jm, tx, tm = _both(x, mask, dtype)
    js, ts = jnp.ones((2, 215), jnp.float32), torch.ones((2, 215))
    for r in ttm.merge_schedule(215, 87):
        order, dst = ttm.merge_decisions(tx, tm, r)
        j_order, j_dst = _jax_decisions(jx, js, jm, r)
        np.testing.assert_array_equal(order[:, :r].numpy(), j_order[:, :r])
        np.testing.assert_array_equal(order.numpy(), j_order)
        np.testing.assert_array_equal(dst.numpy(), j_dst)
        ours = ttm.bipartite_merge_step(tx, ts, tm, r)
        ref = jtm.bipartite_merge_step(jx, js, jm, r)
        _assert_step_equal(ours, ref, dtype)
        (tx, ts, tm), (jx, js, jm) = ours, ref


def test_step_never_merges_valid_into_invalid():
    """With one valid B, every merged valid A lands there; the invalid B
    slots stay untouched (content, size, mask); the JAX step agrees."""
    rng = np.random.default_rng(1)
    x = rng.normal(size=(1, 8, 4)).astype(np.float32)
    mask = np.asarray([[1, 1, 1, 0, 1, 0, 1, 0]], np.int32)
    jx, jm, tx, tm = _both(x, mask, "float32")
    y, s, m = ttm.bipartite_merge_step(tx, torch.ones((1, 8)), tm, r=2)
    np.testing.assert_array_equal(m.numpy()[0, -3:], 0)
    np.testing.assert_array_equal(y.numpy()[0, -3:], x[0, 3::2])
    np.testing.assert_allclose(s.numpy()[0, -3:], 1.0)
    assert float(s[0, -4]) == 3.0
    assert float((s * m).sum()) == 5.0
    _assert_step_equal((y, s, m), jtm.bipartite_merge_step(
        jx, jnp.ones((1, 8), jnp.float32), jm, r=2), "float32")


def test_no_valid_target_transfers_instead_of_discarding():
    """Every B invalid: the merged valid A rows transfer content, size and
    validity into invalid B slots, which flip valid; nothing is lost."""
    rng = np.random.default_rng(1)
    x = rng.normal(size=(1, 8, 4)).astype(np.float32)
    mask = np.asarray([[1, 0, 1, 0, 1, 0, 1, 0]], np.int32)
    jx, jm, tx, tm = _both(x, mask, "float32")
    y, s, m = ttm.bipartite_merge_step(tx, torch.ones((1, 8)), tm, r=2)
    assert float((s * m).sum()) == 4.0 and int(m.sum()) == 4
    out_rows = {tuple(np.round(y.numpy()[0, i], 6)) for i in range(6) if m[0, i]}
    for i in (0, 2, 4, 6):
        assert tuple(np.round(x[0, i], 6)) in out_rows
    _assert_step_equal((y, s, m), jtm.bipartite_merge_step(
        jx, jnp.ones((1, 8), jnp.float32), jm, r=2), "float32")


# ---------------------------------------------------------------------------
# ViLT and the classifier
# ---------------------------------------------------------------------------

def _setup(seed=0, dtype="float32"):
    """tests/test_token_merge.py's setup: a 4x4-patch tiny ViLT, its
    parameters from the JAX init, and a batch for both sides."""
    jcfg = j_tiny_vilt(image_size=64, patch_size=16)
    tcfg = tiny_vilt_config(image_size=64, patch_size=16)
    jp = jvilt.init_vilt(jax.random.PRNGKey(seed), jcfg)
    rng = np.random.default_rng(seed)
    b, l = 2, 6
    batch = dict(
        input_ids=rng.integers(0, jcfg.vocab_size, (b, l)).astype(np.int32),
        attention_mask=np.ones((b, l), np.int32),
        token_type_ids=np.zeros((b, l), np.int32),
        pixel_values=rng.normal(size=(b, 3, 64, 64)).astype(np.float32),
        pixel_mask=np.ones((b, 64, 64), np.int32))
    return jcfg, tcfg, jp, batch


def _vilt_module(tcfg, jp, dtype):
    model = tvilt.init_vilt(torch.Generator().manual_seed(0), tcfg)
    sd = params_from_jax({"vilt": jax.tree.map(np.asarray, jp)},
                         VaultConfig(vilt=tcfg, text_tower=None))
    model.load_state_dict({k.removeprefix("vilt."): v for k, v in sd.items()})
    return model.to(getattr(torch, dtype))


def _sides(batch, dtype):
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: torch.from_numpy(v) if v.dtype.kind == "f" else torch.from_numpy(
        v.astype(np.int64)) for k, v in batch.items()}
    jb["pixel_values"] = jb["pixel_values"].astype(getattr(jnp, dtype))
    tb["pixel_values"] = tb["pixel_values"].to(getattr(torch, dtype))
    return jb, tb


def _flat_pos_embeddings(jp):
    """Every position embedding row the same, so pixel-identical patches
    give identical tokens (the duplicate-exactness precondition)."""
    pe = jp["pos_embeddings"]
    return dict(jp, pos_embeddings=jnp.concatenate([pe[1:2]] * pe.shape[0], axis=0))


def _run(model, tcfg, tb, **kw):
    with torch.inference_mode():
        return tvilt.vilt_apply(model, tcfg, **kw, **tb)


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("layer", [0, 1])
@pytest.mark.parametrize("dtype", DTYPES)
def test_vilt_apply_merged_matches_jax(dtype, layer, impl):
    """16 patch tokens merged to 8, at the embeddings and after layer 1 of
    2: hidden states, pooler and the merged mask equal the JAX package's."""
    jcfg, tcfg, jp, batch = _setup()
    jp = jax.tree.map(lambda t: t.astype(getattr(jnp, dtype)), jp)
    model = _vilt_module(tcfg, jp, dtype)
    jb, tb = _sides(batch, dtype)
    ref = jvilt.vilt_apply(jp, jcfg, merge_patches_to=8, merge_at_layer=layer,
                           use_pallas=impl, **jb)
    out = _run(model, tcfg, tb, merge_patches_to=8, merge_at_layer=layer, use_pallas=impl)
    assert out.last_hidden_state.shape == (2, 6 + 1 + 8, 32)
    np.testing.assert_array_equal(out.attention_mask.numpy(), np.asarray(ref.attention_mask))
    for o, r in ((out.last_hidden_state, ref.last_hidden_state),
                 (out.pooler_output, ref.pooler_output)):
        np.testing.assert_allclose(_np(o), _np(r), atol=ATOL[dtype], rtol=RTOL[dtype])


def test_merge_noop_when_target_not_smaller():
    jcfg, tcfg, jp, batch = _setup()
    model = _vilt_module(tcfg, jp, "float32")
    _, tb = _sides(batch, "float32")
    base, same = _run(model, tcfg, tb), _run(model, tcfg, tb, merge_patches_to=16)
    assert torch.equal(base.pooler_output, same.pooler_output)


def _duplicate_batch(batch):
    """Raster patches 2 (A set) and 3 (B set) made pixel-identical."""
    pv = batch["pixel_values"].copy()
    pv[:, :, 0:16, 48:64] = pv[:, :, 0:16, 32:48]
    return dict(batch, pixel_values=pv)


@pytest.mark.parametrize("layer", [0, 1])
def test_duplicate_patches_merge_exactly(layer):
    """Two identical patch tokens merge into one size-2 token whose
    proportional attention reproduces the unmerged forward up to fp32
    noise, at the embeddings and mid-stack (identical tokens stay identical
    through the layers); the mask tracks the merged length."""
    jcfg, tcfg, jp, batch = _setup()
    jp = _flat_pos_embeddings(jp)
    model = _vilt_module(tcfg, jp, "float32")
    jb, tb = _sides(_duplicate_batch(batch), "float32")
    base = _run(model, tcfg, tb)
    merged = _run(model, tcfg, tb, merge_patches_to=15, merge_at_layer=layer)
    assert merged.last_hidden_state.shape[1] == base.last_hidden_state.shape[1] - 1
    assert merged.attention_mask.shape[1] == base.attention_mask.shape[1] - 1
    np.testing.assert_allclose(merged.pooler_output.numpy(), base.pooler_output.numpy(),
                               atol=2e-5, rtol=1e-5)
    ref = jvilt.vilt_apply(jp, jcfg, merge_patches_to=15, merge_at_layer=layer, **jb)
    np.testing.assert_allclose(merged.pooler_output.numpy(), _np(ref.pooler_output),
                               atol=ATOL["float32"])


def test_invalid_patches_consumed_first_exactly():
    """Four invalid patch slots (the bottom row): merging two tokens away
    removes invalid ones at weight 0, so the output equals the unmerged
    forward and the valid count is unchanged."""
    jcfg, tcfg, jp, batch = _setup()
    pm = np.ones((2, 64, 64), np.int32)
    pm[:, 48:, :] = 0
    batch = dict(batch, pixel_mask=pm)
    model = _vilt_module(tcfg, jp, "float32")
    jb, tb = _sides(batch, "float32")
    base = _run(model, tcfg, tb)
    merged = _run(model, tcfg, tb, merge_patches_to=14)
    np.testing.assert_allclose(merged.pooler_output.numpy(), base.pooler_output.numpy(),
                               atol=1e-6, rtol=1e-6)
    assert int(merged.attention_mask.sum()) == int(base.attention_mask.sum())
    assert merged.attention_mask.shape[1] == base.attention_mask.shape[1] - 2
    ref = jvilt.vilt_apply(jp, jcfg, merge_patches_to=14, **jb)
    np.testing.assert_array_equal(merged.attention_mask.numpy(),
                                  np.asarray(ref.attention_mask))


def test_midstack_diverges_less_than_embed_merge():
    """On non-duplicate inputs, merging after layer 1 of 2 tracks the
    unmerged forward at least as well as merging the embeddings."""
    _, tcfg, jp, batch = _setup()
    model = _vilt_module(tcfg, jp, "float32")
    _, tb = _sides(batch, "float32")
    base = _run(model, tcfg, tb).pooler_output
    at_embed = _run(model, tcfg, tb, merge_patches_to=8).pooler_output
    at_mid = _run(model, tcfg, tb, merge_patches_to=8, merge_at_layer=1).pooler_output
    d_embed = (at_embed - base).abs().max().item()
    d_mid = (at_mid - base).abs().max().item()
    assert d_mid <= d_embed * 1.05, (d_mid, d_embed)


def _vault(dtype, seed=0):
    jcfg = JVaultConfig(vilt=j_tiny_vilt(image_size=64, patch_size=16),
                        text_tower=j_tiny_text(num_hidden_layers=1))
    tcfg = VaultConfig(vilt=tiny_vilt_config(image_size=64, patch_size=16),
                       text_tower=tiny_text_config(num_hidden_layers=1))
    jp = jvault.init_vault(jax.random.PRNGKey(seed), jcfg)
    jp["head"] = jvault.init_classifier_head(jax.random.PRNGKey(1), jcfg.vilt.hidden_size, 3)
    jp = jax.tree.map(lambda t: t.astype(getattr(jnp, dtype)), jp)
    model = tvault.VaultForClassification(tcfg, device="cpu", dtype=getattr(torch, dtype))
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, jp), tcfg))
    rng = np.random.default_rng(0)
    batch = dict(
        input_ids=rng.integers(0, jcfg.text_tower.vocab_size, (2, 6)).astype(np.int32),
        attention_mask=np.ones((2, 6), np.int32),
        token_type_ids=np.zeros((2, 6), np.int32),
        pixel_values=rng.normal(size=(2, 3, 64, 64)).astype(np.float32),
        pixel_mask=np.ones((2, 64, 64), np.int32))
    return jcfg, tcfg, jp, model, batch


@pytest.mark.parametrize("layer", [0, 1])
@pytest.mark.parametrize("dtype", DTYPES)
def test_merge_composes_with_vault_classifier(dtype, layer):
    """The classifier merged to 8 patch tokens: finite (2, 3) logits equal
    to the JAX package's, through ``vault_for_classification`` and through
    the module's own ``merge_to`` / ``merge_at_layer``."""
    jcfg, tcfg, jp, model, batch = _vault(dtype)
    jb, tb = _sides(batch, dtype)
    ref = jvault.vault_for_classification(jp, jcfg, jb, head_dropout=0.0,
                                          deterministic=True, merge_patches_to=8,
                                          merge_at_layer=layer)
    with torch.inference_mode():
        logits = tvault.vault_for_classification(model, tcfg, tb, head_dropout=0.0,
                                                 merge_patches_to=8, merge_at_layer=layer)
        model.merge_to, model.merge_at_layer = 8, layer
        again = model(tb)
    assert logits.shape == (2, 3) and torch.isfinite(logits.float()).all()
    assert torch.equal(logits, again)
    np.testing.assert_allclose(_np(logits), _np(ref), atol=ATOL[dtype], rtol=RTOL[dtype])


def test_quantized_merged_composition_is_checked():
    """``quantize`` holds a merged model to the JAX package's serving
    composition rules (scripts/serve.py): a wide head quantized and merged
    at layer 0 is refused unless forced; a narrow one serves."""
    _, tcfg, _, _, _ = _vault("float32")
    wide = tvault.VaultForClassification(tcfg, n_classes=3129, device="cpu",
                                         merge_to=8, merge_at_layer=0)
    with pytest.raises(ValueError, match="refusing"):
        wide.quantize("w8a8")
    assert wide.quant_mode is None
    with pytest.warns(UserWarning, match="forced"):
        wide.quantize("w8a8", force=True)
    assert wide.quant_mode == "w8a8"
    narrow = tvault.VaultForClassification(tcfg, device="cpu", merge_to=8).quantize("w8")
    assert narrow.quant_mode == "w8"


# ---------------------------------------------------------------------------
# The pipeline
# ---------------------------------------------------------------------------

def _tokenizers():
    from vault_tpu.text.wordpiece import WordPieceTokenizer as JTok
    from vault_tpu_torch.text.wordpiece import WordPieceTokenizer as TTok

    words = "a the cat dog on couch sits red small photo".split()
    vocab = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"] + words
    vocab += [f"tok{i}" for i in range(99 - len(vocab))]
    vocab = {t: i for i, t in enumerate(vocab)}
    return JTok(vocab), TTok(vocab)


@pytest.mark.parametrize("layer", [0, 1])
def test_pipeline_merged_matches_jax(layer):
    """``VaultPipeline`` with ``merge_patches_to``: the same images and
    texts, encoded by the JAX package's processor, through both pipelines
    (padded to ``max_batch``, cut back to the real rows) give the same
    hidden states and pooler, fp32.  (The port's own processor resizes with
    PyTorch's bicubic, one uint8 level from PIL's, tests/test_torch_serving.py,
    which can move a merge decision, so it is run for shapes only.)  The
    timers count the calls."""
    from vault_tpu.data.processor import VaultProcessor as JProc
    from vault_tpu.pipeline_api import VaultPipeline as JPipe
    from vault_tpu_torch.data.processor import VaultProcessor as TProc
    from vault_tpu_torch.pipeline_api import VaultPipeline

    jcfg, tcfg, jp, model, _ = _vault("float32")
    jtok, ttok = _tokenizers()
    rng = np.random.default_rng(4)
    images = [rng.integers(0, 256, (40 + 9 * i, 70, 3), dtype=np.uint8) for i in range(3)]
    texts = ["a red cat sits on the couch", "the dog", "small photo of a dog"]
    kw = dict(max_batch=4, merge_patches_to=8, merge_at_layer=layer)
    jproc = JProc(jtok, max_length=8, canvas=(64, 64))
    ref = JPipe(jp, jcfg, jproc, **kw)(images, texts)
    out = VaultPipeline(model, tcfg, jproc, **kw)(images, texts)
    for o, r in zip(out, ref):
        np.testing.assert_allclose(o, np.asarray(r), atol=ATOL["float32"])
    pipe = VaultPipeline(model, tcfg, TProc(ttok, max_length=8, canvas=(64, 64)), **kw)
    own = pipe(images, texts)
    assert own[0].shape == (3, 8 + 1 + 8, 32) and own[1].shape == (3, 32)
    assert np.isfinite(own[1]).all()
    assert pipe.stats()["forward"]["steps"] == 1
    with pytest.raises(ValueError, match="max_batch"):
        pipe(images * 2, texts * 2)


# ---------------------------------------------------------------------------
# Training through the merge
# ---------------------------------------------------------------------------

def test_merge_step_grads_match_jax_and_finite_differences():
    """d(loss)/d(x) through one merge step (r = 3 of 10), content and sizes
    both in the loss: the port's autograd equals ``jax.grad`` of the same
    loss (atol 1e-5, fp32), and matches central differences (the JAX test's
    tolerance, 5e-2 of the scale: the decisions stay fixed under the
    perturbation)."""
    rng = np.random.default_rng(0)
    x0 = rng.normal(size=(2, 10, 6)).astype(np.float32)
    probe = rng.normal(size=(2, 7, 6)).astype(np.float32)
    mask = np.ones((2, 10), np.int32)

    def jloss(x):
        y, s, _ = jtm.bipartite_merge_step(x, jnp.ones((2, 10), jnp.float32),
                                           jnp.asarray(mask), r=3)
        return jnp.sum(y * probe) + jnp.sum(jnp.log(s))

    def tloss(x):
        y, s, _ = ttm.bipartite_merge_step(x, torch.ones((2, 10)),
                                           torch.from_numpy(mask.astype(np.int64)), r=3)
        return (y * torch.from_numpy(probe)).sum() + torch.log(s).sum()

    xt = torch.from_numpy(x0).requires_grad_()
    g, = torch.autograd.grad(tloss(xt), xt)
    np.testing.assert_allclose(g.numpy(), np.asarray(jax.grad(jloss)(jnp.asarray(x0))),
                               atol=1e-5)
    eps = 1e-3
    for d in rng.normal(size=(4, *x0.shape)).astype(np.float32):
        with torch.no_grad():
            fd = (tloss(torch.from_numpy(x0 + eps * d)).item()
                  - tloss(torch.from_numpy(x0 - eps * d)).item()) / (2 * eps)
        ad = float((g.numpy() * d).sum())
        assert abs(fd - ad) <= 5e-2 * max(1.0, abs(fd), abs(ad)), (fd, ad)


def _toy(n=48, seed=0, patches=16, dropout=None):
    """tests/test_token_merge_train.py's toy task: the class sets the first
    text token; 32x32 images of 16 patch tokens.  ``dropout``: the towers'
    dropout rates (the configs' defaults when None)."""
    drop = {} if dropout is None else dict(hidden_dropout_prob=dropout,
                                           attention_probs_dropout_prob=dropout)
    vilt = dict(image_size=32, patch_size=8, num_patch_tokens=patches, **drop)
    text = dict(num_hidden_layers=1, **drop)
    jcfg = JVaultConfig(vilt=j_tiny_vilt(**vilt), text_tower=j_tiny_text(**text))
    tcfg = VaultConfig(vilt=tiny_vilt_config(**vilt), text_tower=tiny_text_config(**text))
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, 3, n)
    ids = rng.integers(5, jcfg.text_tower.vocab_size, (n, 8))
    ids[:, 0] = labels + 1
    feats = {"input_ids": ids.astype(np.int32),
             "attention_mask": np.ones((n, 8), np.int32),
             "token_type_ids": np.zeros((n, 8), np.int32),
             "pixel_values": rng.normal(size=(n, 3, 32, 32)).astype(np.float32),
             "pixel_mask": np.ones((n, 32, 32), np.int32)}
    jp = jvault.init_vault(jax.random.PRNGKey(seed), jcfg)
    jp["head"] = jvault.init_classifier_head(jax.random.PRNGKey(seed + 1),
                                             jcfg.vilt.hidden_size, 3)
    return jcfg, tcfg, jax.tree.map(np.asarray, jp), feats, labels


@pytest.mark.parametrize("layer", [0, 1])
def test_merged_model_grads_match_jax(layer):
    """Gradients of the classifier's loss through a merged forward (16 -> 7
    patch tokens), every parameter leaf, against ``jax.grad`` of the same
    loss on the same parameters and batch (fp32, dropout off): per leaf
    ||g_port - g_jax|| <= 1e-4 ||g_jax|| + 1e-6 (summation order through
    the whole forward and backward).  One central difference along a
    random direction of the head's weight agrees too (5e-2 of the scale)."""
    from vault_tpu_torch.convert import params_to_jax

    jcfg, tcfg, jp, feats, labels = _toy(n=4)
    jb = {k: jnp.asarray(v) for k, v in feats.items()}
    y = labels[:4]

    def jloss(p):
        logits = jvault.vault_for_classification(p, jcfg, jb, head_dropout=0.0,
                                                 deterministic=True, merge_patches_to=7,
                                                 merge_at_layer=layer)
        logp = jax.nn.log_softmax(logits)
        return -jnp.take_along_axis(logp, jnp.asarray(y)[:, None], axis=-1).mean()

    jg = jax.grad(jloss)(jax.tree.map(jnp.asarray, jp))
    model = tvault.VaultForClassification(tcfg, device="cpu")
    model.load_state_dict(params_from_jax(jp, tcfg))
    tb = tvault.batch_to_device(feats, "cpu")

    def tloss():
        logits = tvault.vault_for_classification(model, tcfg, tb, head_dropout=0.0,
                                                 merge_patches_to=7, merge_at_layer=layer)
        return torch.nn.functional.cross_entropy(logits, torch.as_tensor(y))

    loss = tloss()
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss(jax.tree.map(jnp.asarray, jp))),
                               atol=1e-5)
    ours = params_to_jax({k: (p.grad if p.grad is not None else torch.zeros_like(p))
                          for k, p in model.named_parameters()}, as_numpy=True)
    flat_ref = dict(jax.tree_util.tree_leaves_with_path(jg))
    flat_ours = dict(jax.tree_util.tree_leaves_with_path(ours))
    assert set(flat_ref) == set(flat_ours)
    for key, r in flat_ref.items():
        r, o = np.asarray(r, np.float64), np.asarray(flat_ours[key], np.float64)
        assert np.linalg.norm(o - r) <= 1e-4 * np.linalg.norm(r) + 1e-6, key
    w = model.head.out.w
    d = torch.from_numpy(np.random.default_rng(layer).normal(size=w.shape).astype(np.float32))
    eps = 1e-3
    with torch.no_grad():
        w0 = w.clone()
        w.copy_(w0 + eps * d)
        up = tloss().item()
        w.copy_(w0 - eps * d)
        down = tloss().item()
        w.copy_(w0)
    fd, ad = (up - down) / (2 * eps), float((w.grad * d).sum())
    assert abs(fd - ad) <= 5e-2 * max(1.0, abs(fd), abs(ad)), (fd, ad)


@pytest.mark.parametrize("layer", [0, 1])
def test_trainer_with_merge_matches_jax(tmp_path, layer):
    """Six steps of the port's Trainer with ``TrainArgs(merge_to=7)`` against
    the JAX trainer on the same data, parameters and shuffle (fp32, dropout
    off, fp32 moments, remat, a loss window per step): the first loss atol
    1e-5, the curve atol 5e-3 (tests/test_torch_training.py's tolerances)."""
    from vault_tpu.data.loader import InMemoryDataset as JDataset
    from vault_tpu.training.experiment import ExperimentHandler as JHandler
    from vault_tpu.training.trainer import TrainArgs as JTrainArgs
    from vault_tpu.training.trainer import Trainer as JTrainer
    from vault_tpu_torch.data.loader import InMemoryDataset
    from vault_tpu_torch.training.experiment import ExperimentHandler
    from vault_tpu_torch.training.trainer import TrainArgs, Trainer, classifier_apply_fn

    jcfg, tcfg, jp, feats, labels = _toy(n=24, dropout=0.0)
    kw = dict(lr=1e-3, train_batch_size=8, eval_batch_size=8, num_train_epochs=2,
              eval_steps=1, seed=3, opt_state_dtype="float32", disable_tqdm=True,
              remat=True, merge_to=7, merge_at_layer=layer)
    jh = JHandler(str(tmp_path / "jax"), "Toy")

    def japply(p, batch, deterministic, rng):
        return jvault.vault_for_classification(p, jcfg, batch, head_dropout=0.0,
                                               deterministic=deterministic, rng=rng,
                                               remat=True, merge_patches_to=7,
                                               merge_at_layer=layer)

    JTrainer(japply, jax.tree.map(jnp.asarray, jp), JTrainArgs(num_data_shards=1, **kw),
             JDataset(feats, labels), exp_handler=jh).train()
    th = ExperimentHandler(str(tmp_path / "torch"), "Toy")
    args = TrainArgs(**kw)
    Trainer(classifier_apply_fn(tcfg, args, head_dropout=0.0), params_from_jax(jp, tcfg),
            args, InMemoryDataset(feats, labels), exp_handler=th, device="cpu").train()
    ours, ref = th._series["train_loss"], jh._series["train_loss"]
    assert len(ours) == len(ref) == 6
    np.testing.assert_allclose(ours[0], ref[0], atol=1e-5)
    np.testing.assert_allclose(ours, ref, atol=5e-3)


@pytest.mark.slow
def test_train_descends_with_merge():
    """The toy task trained through the merge (16 -> 7 patch tokens, dropout
    0.1, remat): the loss descends and the dev accuracy clears 0.6 (the
    signal lives in the text tokens, which merging never touches)."""
    from vault_tpu_torch.data.loader import InMemoryDataset
    from vault_tpu_torch.training.trainer import TrainArgs, Trainer, classifier_apply_fn

    _, tcfg, jp, feats, labels = _toy()
    ds = InMemoryDataset(feats, labels, name="toy(train)")
    args = TrainArgs(lr=5e-3, train_batch_size=16, eval_batch_size=16, num_train_epochs=6,
                     seed=0, merge_to=7, disable_tqdm=True)
    tr = Trainer(classifier_apply_fn(tcfg, args), params_from_jax(jp, tcfg), args, ds,
                 dev_dataset=ds, device="cpu")
    tr.train()
    losses = tr.exp_handler._series["train_loss"]
    assert losses[-1] < losses[0] * 0.7, losses
    assert tr.exp_handler._series["eval_accuracy"][-1] > 0.6
