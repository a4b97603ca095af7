"""The port's baselines (``models/modules.py``, ``models/resnet.py``,
``models/tombert.py``, ``models/tomvilt.py``) and the bridge of their trees
against the JAX package, on the CPU at tiny size (text towers of 2 layers,
H 32; ResNet-18 and -50 on 64x64 images, 4 regions).

One parameter pytree (the JAX package's init, every leaf moved off its
init values by seeded noise) is bridged with ``params_from_jax`` and fed,
with the same numpy inputs, to both sides.  The port runs on the
selector "fuseqkv+fusemlp+batched" (the kernel wrappers, which take their
plain versions for CPU tensors) and on ``use_pallas=False``; the JAX
package on its default, which is XLA on the CPU.

Tolerances: fp32 atol 5e-5; bf16 atol 2e-2 plus rtol 2^-7 (one bf16 ulp of
the reference), as the port's other model tests state them.  Gradients
(fp32, every leaf): atol 5e-5 plus rtol 1e-4 of the leaf's largest
gradient.
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vault_tpu.config import VaultConfig as JVaultConfig
from vault_tpu.config import tiny_text_config as j_tiny_text
from vault_tpu.config import tiny_vilt_config as j_tiny_vilt
from vault_tpu.models import bert as jbert
from vault_tpu.models import modules as jmodules
from vault_tpu.models import resnet as jresnet
from vault_tpu.models import tombert as jtombert
from vault_tpu.models import tomvilt as jtomvilt
from vault_tpu.ops.masks import extend_attention_mask as j_extend
from vault_tpu.training import checkpoint as jckpt
from vault_tpu_torch.config import VaultConfig, tiny_text_config, tiny_vilt_config
from vault_tpu_torch.convert import param_tree, params_from_jax, params_to_jax
from vault_tpu_torch.models import modules as tmodules
from vault_tpu_torch.models import resnet as tresnet
from vault_tpu_torch.models import tombert as ttombert
from vault_tpu_torch.models import tomvilt as ttomvilt
from vault_tpu_torch.ops.masks import extend_attention_mask
from vault_tpu_torch.training import checkpoint as tckpt

from tests.test_tom_models import _torch_resnet

DTYPES = ["float32", "bfloat16"]
ATOL = {"float32": 5e-5, "bfloat16": 2e-2}
RTOL = {"float32": 0.0, "bfloat16": 2.0 ** -7}
IMPLS = [False, "fuseqkv+fusemlp+batched"]
B, L, LT, REGIONS = 3, 10, 5, 4
NO_DROP = dict(hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close(ours, ref, dtype):
    np.testing.assert_allclose(_np(ours), _np(ref), atol=ATOL[dtype], rtol=RTOL[dtype])


def _moved(tree, seed=7, dtype="float32"):
    """``tree`` with seeded noise (std 0.02) on every float leaf, cast to
    ``dtype``: zero-initialised biases and LayerNorms get values."""
    leaves, treedef = jax.tree.flatten(tree)
    rng = np.random.default_rng(seed)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    leaves = [(l + jnp.asarray(0.02 * rng.normal(size=l.shape), l.dtype)).astype(jdt)
              for l in leaves]
    return jax.tree.map(np.asarray, jax.tree.unflatten(treedef, leaves))


def _torch(x):
    x = np.asarray(x)
    return torch.from_numpy(x).long() if x.dtype.kind in "iu" else torch.from_numpy(x)


def _feats(rng, images=False, vis_dim=512):
    am = np.ones((B, L), np.int32)
    am[0, 7:] = 0
    tm = np.ones((B, LT), np.int32)
    tm[1, 3:] = 0
    f = {"input_ids": rng.integers(5, 99, (B, L)).astype(np.int32),
         "attention_mask": am,
         "token_type_ids": (np.arange(L)[None] >= 6).repeat(B, 0).astype(np.int32),
         "target_input_ids": rng.integers(5, 99, (B, LT)).astype(np.int32),
         "target_attention_mask": tm,
         "target_type_ids": np.zeros((B, LT), np.int32)}
    if images:
        f["images"] = rng.normal(size=(B, 3, 64, 64)).astype(np.float32)
    else:
        f["visual_embeddings"] = rng.normal(size=(B, REGIONS, vis_dim)).astype(np.float32)
    return f


# ---------------------------------------------------------------------------
# modules.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("dtype", DTYPES)
def test_cross_layer_and_encoder_match_jax(dtype, masked):
    """One cross layer and a two-layer cross encoder: 5 target tokens
    querying 7 region tokens (K/V longer than Q), the key bias None or a
    padding mask."""
    jcfg, tcfg = j_tiny_text(**NO_DROP), tiny_text_config(**NO_DROP)
    jp = _moved(jmodules.init_cross_encoder(jax.random.PRNGKey(0), jcfg, 2), dtype=dtype)
    sd = params_from_jax(jp)
    rng = np.random.default_rng(1)
    q = rng.normal(size=(B, LT, 32)).astype(np.float32)
    kv = rng.normal(size=(B, 7, 32)).astype(np.float32)
    mask = np.ones((B, 7), np.int32)
    mask[2, 4:] = 0
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    jb = j_extend(jnp.asarray(mask), jnp.float32) if masked else None
    tb = extend_attention_mask(torch.from_numpy(mask), torch.float32) if masked else None
    jq, jkv = jnp.asarray(q, jdt), jnp.asarray(kv, jdt)
    tq, tkv = torch.from_numpy(q).to(tdt), torch.from_numpy(kv).to(tdt)
    tree = param_tree(sd)
    jlayer = jax.tree.map(lambda x: x[0], jp["layers"])
    ref1 = jax.jit(lambda p, a, b: jmodules.cross_layer_apply(p, jcfg, a, b, jb))(
        jlayer, jq, jkv)
    ref = jax.jit(lambda p, a, b: jmodules.cross_encoder_apply(p, jcfg, a, b, jb))(
        jp, jq, jkv)
    for impl in IMPLS:
        out1 = tmodules.cross_layer_apply(tree["layers"][0], tcfg, tq, tkv, tb,
                                          use_pallas=impl)
        out = tmodules.cross_encoder_apply(tree, tcfg, tq, tkv, tb, use_pallas=impl)
        assert out.dtype == tdt and tuple(out.shape) == (B, LT, 32)
        _close(out1, ref1, dtype)
        _close(out, ref, dtype)


@pytest.mark.parametrize("tokens", [0, [0, 1]])
@pytest.mark.parametrize("dtype", DTYPES)
def test_pooler_dim_matches_jax(dtype, tokens):
    jp = _moved(jmodules.init_pooler_dim(jax.random.PRNGKey(2), 32), dtype=dtype)
    h = np.random.default_rng(3).normal(size=(B, L, 32)).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    ref = jmodules.pooler_dim_apply(jax.tree.map(jnp.asarray, jp), jnp.asarray(h, jdt), tokens)
    out = tmodules.pooler_dim_apply(param_tree(params_from_jax(jp)),
                                    torch.from_numpy(h).to(tdt), tokens)
    assert tuple(out.shape) == tuple(ref.shape)
    _close(out, ref, dtype)


# ---------------------------------------------------------------------------
# resnet.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("depth", [18, 50])
@pytest.mark.parametrize("dtype", DTYPES)
def test_resnet_features_match_jax(depth, dtype):
    """Region tokens of 64x64 images (a 2x2 grid): the JAX tree bridged,
    its stages lists of blocks; ``resnet_embed`` passes embeddings through
    and cuts a frozen ResNet from the graph."""
    jp = _moved(jresnet.init_resnet(jax.random.PRNGKey(depth), depth), dtype=dtype)
    sd = params_from_jax(jp)
    assert f"layer1.{jresnet.RESNET_LAYERS[depth][1][0] - 1}.conv1" in sd
    x = np.random.default_rng(4).normal(size=(2, 3, 64, 64)).astype(np.float32)
    ref = jax.jit(lambda p, x: jresnet.resnet_features(p, depth, x))(jp, x)
    tree = param_tree(sd)
    out = tresnet.resnet_features(tree, depth, torch.from_numpy(x))
    assert tuple(out.shape) == (2, 4, tresnet.RESNET_OUT_DIM[depth])
    # the features grow with depth (up to ~40 at depth 50): held to the
    # tolerance relative to their scale
    scale = max(1.0, float(np.abs(_np(ref)).max()))
    np.testing.assert_allclose(_np(out) / scale, _np(ref) / scale,
                               atol=ATOL[dtype], rtol=RTOL[dtype])
    emb = torch.randn(2, 4, 8)
    assert tresnet.resnet_embed(tree, depth, emb) is emb
    leaf = {k: v.requires_grad_(v.is_floating_point()) for k, v in params_from_jax(jp).items()}
    frozen = tresnet.resnet_embed(param_tree(leaf), depth, torch.from_numpy(x))
    trained = tresnet.resnet_embed(param_tree(leaf), depth, torch.from_numpy(x), train=True)
    assert not frozen.requires_grad and trained.requires_grad


@pytest.mark.parametrize("depth", [18, 50])
def test_resnet_params_from_torchvision_layout(tmp_path, depth):
    """A torchvision-layout state dict (``conv1``, ``bn1``,
    ``layer<s>.<b>.downsample.{0,1}``) with moved BatchNorm statistics:
    converted by both packages to the same tree, the features equal to the
    torch module's in eval mode; ``load_resnet_tower`` reads the ``.pth``."""
    from vault_tpu_torch.models.pretrained import load_resnet_tower

    torch.manual_seed(depth)
    net = _torch_resnet(depth).eval()
    with torch.no_grad():
        for m in net.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.normal_(0, 0.1)
                m.running_var.uniform_(0.5, 1.5)
                m.weight.normal_(1, 0.1)
                m.bias.normal_(0, 0.1)
    sd = net.state_dict()
    ours = tresnet.resnet_params_from_torch(sd, depth)
    ref = params_from_jax(jax.tree.map(np.asarray, jresnet.resnet_params_from_torch(sd, depth)))
    assert ours.keys() == ref.keys()
    for k in ref:
        assert torch.equal(ours[k], ref[k]), k
    torch.save(sd, tmp_path / "r.pth")
    loaded = load_resnet_tower(str(tmp_path / "r.pth"), depth)
    assert all(torch.equal(loaded[k], ours[k]) for k in ours)
    x = torch.randn(2, 3, 64, 64)
    with torch.no_grad():
        want = net(x)  # the stem and the four stages, no pooling
        got = tresnet.resnet_features(param_tree(ours), depth, x)
    want = want.reshape(2, want.shape[1], -1).transpose(1, 2)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=5e-5 * max(1.0, want.abs().max().item()))


# ---------------------------------------------------------------------------
# tombert.py
# ---------------------------------------------------------------------------

def _tombert(pooling="first", tie=False, dtype="float32", resnet_depth=None, seed=0):
    jcfg = j_tiny_text(**NO_DROP)
    jp = jtombert.init_tombert(jax.random.PRNGKey(seed), jcfg, 3, pooling, 512, 1,
                               resnet_depth=resnet_depth, tie_target_bert=tie)
    return jcfg, tiny_text_config(**NO_DROP), _moved(jp, dtype=dtype)


@pytest.mark.parametrize("pooling", ["first", "cls", "both"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_tombert_apply_matches_jax(dtype, pooling):
    jcfg, tcfg, jp = _tombert(pooling, dtype=dtype)
    f = _feats(np.random.default_rng(5))
    ref = jax.jit(lambda p, f: jtombert.tombert_apply(p, jcfg, pooling=pooling, **f))(jp, f)
    tree = param_tree(params_from_jax(jp))
    for impl in IMPLS:
        out = ttombert.tombert_apply(tree, tcfg, pooling=pooling, use_pallas=impl,
                                     **{k: _torch(v) for k, v in f.items()})
        assert tuple(out.shape) == (B, 3)
        _close(out, ref, dtype)


def test_tombert_tied_and_tweet_config_match_jax():
    """``tie_target_bert`` (no ``target_bert`` subtree: the tweet tower
    serves both streams) and a separate tweet checkpoint's config (3
    layers, another vocabulary) through ``tweet_cfg``."""
    jcfg, tcfg, jp = _tombert(tie=True)
    assert "target_bert" not in jp
    f = _feats(np.random.default_rng(6))
    jf = {k: jnp.asarray(v) for k, v in f.items()}
    tf = {k: _torch(v) for k, v in f.items()}
    ref = jax.jit(lambda p, f: jtombert.tombert_apply(p, jcfg, **f))(jp, jf)
    sd = params_from_jax(jp)
    assert not any(k.startswith("target_bert.") for k in sd)
    _close(ttombert.tombert_apply(param_tree(sd), tcfg, **tf), ref, "float32")
    assert "target_bert" not in ttombert.init_tombert(torch.Generator().manual_seed(0), tcfg,
                                                      tie_target_bert=True)

    jtweet = j_tiny_text(num_hidden_layers=3, vocab_size=120, **NO_DROP)
    ttweet = tiny_text_config(num_hidden_layers=3, vocab_size=120, **NO_DROP)
    jp = jtombert.init_tombert_from_bert(
        jbert.init_bert(jax.random.PRNGKey(8), jcfg), jax.random.PRNGKey(9), jcfg, 3,
        vis_emb_dim=512, num_hidden_cross_layers=1,
        tweet_params=jbert.init_bert(jax.random.PRNGKey(10), jtweet))
    jp = _moved(jp, seed=11)
    ref = jax.jit(lambda p, f: jtombert.tombert_apply(p, jcfg, tweet_cfg=jtweet, **f))(jp, jf)
    out = ttombert.tombert_apply(param_tree(params_from_jax(jp)), tcfg, tweet_cfg=ttweet, **tf)
    _close(out, ref, "float32")


@pytest.mark.parametrize("dtype", DTYPES)
def test_tombert_images_against_cached_embeddings(dtype):
    """The ResNet-18 path from images equals the same model fed the
    regions ``resnet_features`` computed (the trainer's cache), and both
    equal the JAX package's; ``return_embeddings`` gives those regions."""
    jcfg, tcfg, jp = _tombert(dtype=dtype, resnet_depth=18)
    f = _feats(np.random.default_rng(12), images=True)
    ref, ref_emb = jax.jit(lambda p, f: jtombert.tombert_apply(
        p, jcfg, resnet_depth=18, return_embeddings=True, **f))(jp, f)
    tree = param_tree(params_from_jax(jp))
    tf = {k: _torch(v) for k, v in f.items()}
    out, emb = ttombert.tombert_apply(tree, tcfg, resnet_depth=18, return_embeddings=True,
                                      use_pallas=IMPLS[1], **tf)
    assert tuple(emb.shape) == (B, 4, 512)
    scale = max(1.0, float(np.abs(_np(ref_emb)).max()))
    np.testing.assert_allclose(_np(emb) / scale, _np(ref_emb) / scale,
                               atol=ATOL[dtype], rtol=RTOL[dtype])
    _close(out, ref, dtype)
    cached = {k: v for k, v in tf.items() if k != "images"}
    cached["visual_embeddings"] = tresnet.resnet_features(tree["resnet"], 18, tf["images"])
    again = ttombert.tombert_apply(tree, tcfg, resnet_depth=18, use_pallas=IMPLS[1], **cached)
    assert torch.equal(again, out)


@pytest.mark.parametrize("n_cross", [1, 3])
def test_init_tombert_from_bert_matches_jax(n_cross):
    """The surgery with a 2-layer donor: a 1-layer cross encoder takes the
    donor's first layer, a 3-layer one the donor's two and a random third;
    the tweet and target towers and the multimodal stack are the donor's."""
    jcfg, tcfg = j_tiny_text(), tiny_text_config()
    donor = jax.tree.map(np.asarray, jbert.init_bert(jax.random.PRNGKey(13), jcfg))
    ref = params_from_jax(jax.tree.map(np.asarray, jtombert.init_tombert_from_bert(
        donor, jax.random.PRNGKey(14), jcfg, 3, "both", 512, n_cross)))
    dsd = params_from_jax(donor)
    ours = ttombert.init_tombert_from_bert(dsd, torch.Generator().manual_seed(0), tcfg, 3,
                                           "both", 512, n_cross)
    assert ours.keys() == ref.keys()
    for k, v in ours.items():
        assert v.shape == ref[k].shape, k
        group, rest = k.split(".", 1)
        if group in ("tweet_bert", "target_bert"):
            assert torch.equal(v, dsd[rest]) and torch.equal(ref[k], dsd[rest]), k
        elif group == "mm_encoder" or (group == "cross" and int(rest.split(".")[1]) < 2):
            assert torch.equal(v, dsd[rest]) and torch.equal(ref[k], dsd[rest]), k
        elif group == "cross" and k.endswith(".w"):
            assert not torch.equal(v, dsd[rest.replace("layers.2", "layers.1")]), k
    if n_cross == 3:
        assert "cross.layers.2.q.w" in ours
    r18 = params_from_jax(jax.tree.map(np.asarray, jresnet.init_resnet(jax.random.PRNGKey(1), 18)))
    with_r = ttombert.init_tombert_from_bert(dsd, torch.Generator().manual_seed(0), tcfg,
                                             resnet_params=r18, tie_target_bert=True)
    assert all(torch.equal(with_r[f"resnet.{k}"], v) for k, v in r18.items())
    assert not any(k.startswith("target_bert.") for k in with_r)


# ---------------------------------------------------------------------------
# tomvilt.py
# ---------------------------------------------------------------------------

def _tomvilt(tweet, dtype="float32", resnet_depth=None):
    jtext, ttext = j_tiny_text(**NO_DROP), tiny_text_config(**NO_DROP)
    jv = JVaultConfig(vilt=j_tiny_vilt(), text_tower=jtext if tweet else None)
    tv = VaultConfig(vilt=tiny_vilt_config(), text_tower=ttext if tweet else None)
    jp = jtomvilt.init_tomvilt(jax.random.PRNGKey(15), jv, jtext, 3, 512, 1,
                               resnet_depth=resnet_depth)
    return jv, tv, jtext, ttext, _moved(jp, dtype=dtype)


@pytest.mark.parametrize("tweet", [True, False])
@pytest.mark.parametrize("dtype", DTYPES)
def test_tomvilt_apply_matches_jax(dtype, tweet):
    """With and without the tweet tower (VAuLT's LM tower), the attended
    target-length sequence through ViLT's ``image_embeds``, an image
    attention mask on the regions, head dropout off."""
    jv, tv, jtext, ttext, jp = _tomvilt(tweet, dtype)
    f = _feats(np.random.default_rng(16))
    f["image_attention_mask"] = np.array([[1, 1, 1, 0]] * B, np.int32)
    ref = jax.jit(lambda p, f: jtomvilt.tomvilt_apply(p, jv, jtext, head_dropout=0.0, **f))(
        jp, f)
    tree = param_tree(params_from_jax(jp))
    for impl in IMPLS:
        out = ttomvilt.tomvilt_apply(tree, tv, ttext, head_dropout=0.0, use_pallas=impl,
                                     **{k: _torch(v) for k, v in f.items()})
        assert tuple(out.shape) == (B, 3)
        _close(out, ref, dtype)


# ---------------------------------------------------------------------------
# Gradients, the bridge and checkpoints
# ---------------------------------------------------------------------------

def _grads_match(jg, jp, tloss, unreached=lambda k: False):
    """Every leaf's gradient of ``tloss`` against ``jg``, the JAX package's
    (bridged); a leaf without one must be ``unreached`` and zero there."""
    sd = {k: v.requires_grad_() for k, v in params_from_jax(jp).items()}
    grads = torch.autograd.grad(tloss(param_tree(sd)), list(sd.values()), allow_unused=True)
    for (k, p), g in zip(sd.items(), grads):
        want = jg[k].numpy()
        if g is None:
            assert unreached(k), k
            assert not want.any(), k
            continue
        assert not unreached(k), k
        tol = 5e-5 + 1e-4 * float(np.abs(want).max())
        np.testing.assert_allclose(g.numpy(), want, atol=tol, err_msg=k)


@functools.lru_cache(maxsize=None)
def _tombert_grad_case():
    """(JAX tree, inputs, projection, the JAX package's gradients) of the
    TomBERT gradient test, computed once for both selectors."""
    jcfg, _, jp = _tombert("both", resnet_depth=18)
    f = _feats(np.random.default_rng(17), images=True)
    w = np.random.default_rng(18).normal(size=(B, 3)).astype(np.float32)

    def jloss(p, f):
        out = jtombert.tombert_apply(p, jcfg, pooling="both", resnet_depth=18,
                                     train_image_encoder=True, **f)
        return jnp.sum(out * w)

    jg = params_from_jax(jax.tree.map(np.asarray, jax.jit(jax.grad(jloss))(jp, f)))
    return jp, f, w, jg


@pytest.mark.parametrize("impl", IMPLS)
def test_tombert_gradients_match_jax(impl):
    """Every leaf's gradient of a fixed projection of the logits, the
    ResNet-18 trained from images (its BatchNorm statistics are leaves that
    get gradients, as under ``jax.grad``)."""
    tcfg = tiny_text_config(**NO_DROP)
    jp, f, w, jg = _tombert_grad_case()

    def tloss(tree):
        out = ttombert.tombert_apply(tree, tcfg, pooling="both", resnet_depth=18,
                                     train_image_encoder=True, use_pallas=impl,
                                     **{k: _torch(v) for k, v in f.items()})
        return (out * torch.from_numpy(w)).sum()

    _grads_match(jg, jp, tloss, ttombert.tombert_unreached_leaf(True))


@pytest.mark.parametrize("tweet", [True, False])
def test_tomvilt_gradients_match_jax(tweet):
    """Every leaf's gradient, the ResNet-18 frozen: the leaves autograd
    leaves without a gradient are exactly ``tomvilt_unreached_leaf``'s,
    and ``jax.grad`` gives them zeros."""
    jv, tv, jtext, ttext, jp = _tomvilt(tweet, resnet_depth=18)
    f = _feats(np.random.default_rng(19), images=True)
    w = np.random.default_rng(20).normal(size=(B, 3)).astype(np.float32)

    def jloss(p, f):
        out = jtomvilt.tomvilt_apply(p, jv, jtext, resnet_depth=18, head_dropout=0.0, **f)
        return jnp.sum(out * w)

    jg = params_from_jax(jax.tree.map(np.asarray, jax.jit(jax.grad(jloss))(jp, f)))

    def tloss(tree):
        out = ttomvilt.tomvilt_apply(tree, tv, ttext, resnet_depth=18, head_dropout=0.0,
                                     use_pallas=IMPLS[1],
                                     **{k: _torch(v) for k, v in f.items()})
        return (out * torch.from_numpy(w)).sum()

    _grads_match(jg, jp, tloss, ttomvilt.tomvilt_unreached_leaf(tv))


@pytest.mark.parametrize("family", ["tombert", "tomvilt"])
def test_bridge_and_checkpoints_round_trip(tmp_path, family):
    """Both trees, ResNet lists included, through ``params_from_jax`` and
    ``params_to_jax`` (lists back as lists, stacks as stacks); a checkpoint
    the port writes restores in the JAX package equal, and one the JAX
    package writes restores in the port equal."""
    if family == "tombert":
        jp = _tombert(resnet_depth=18)[2]
        stacks = ("tweet_bert", "target_bert", "cross", "mm_encoder")
    else:
        jp = _tomvilt(True, resnet_depth=18)[4]
        stacks = ("target_bert", "cross")
    sd = params_from_jax(jp)
    assert "resnet.layer2.1.conv2" in sd and "resnet.stem.bn.var" in sd
    for s in stacks:
        assert f"{s}.layers.0.mlp_in.w" in sd
    back = params_to_jax(sd)
    assert jax.tree.structure(back) == jax.tree.structure(jp)
    assert isinstance(back["resnet"]["layer2"], list) and len(back["resnet"]["layer2"]) == 2
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jp)):
        np.testing.assert_array_equal(a, b)
    own = ttombert.init_tombert(torch.Generator().manual_seed(0), tiny_text_config(),
                                resnet_depth=18, vis_emb_dim=512).state_dict()
    assert jax.tree.structure(params_to_jax(own)) == jax.tree.structure(
        _tombert(resnet_depth=18)[2])

    tckpt.save_checkpoint(str(tmp_path / "port"), params_to_jax(sd, as_numpy=False))
    restored = jckpt.restore_checkpoint(str(tmp_path / "port"), jp)
    for a, b in zip(jax.tree.leaves(restored), jax.tree.leaves(jp)):
        np.testing.assert_array_equal(np.asarray(a), b)
    jckpt.save_checkpoint(str(tmp_path / "jax"), jp)
    target = params_to_jax({k: torch.zeros_like(v) for k, v in sd.items()}, as_numpy=False)
    ours = params_from_jax(tckpt.restore_checkpoint(str(tmp_path / "jax"), target))
    assert ours.keys() == sd.keys()
    assert all(torch.equal(ours[k], sd[k]) for k in sd)
    assert os.path.exists(str(tmp_path / "jax.npz"))


def test_hygiene_covers_the_baselines_modules():
    """tests/test_torch_hygiene.py's import checks reach every module of
    the baselines (it walks the package and reads every source file)."""
    from tests import test_torch_hygiene as hygiene

    names = {"vault_tpu_torch.models.modules", "vault_tpu_torch.models.resnet",
             "vault_tpu_torch.models.tombert", "vault_tpu_torch.models.tomvilt",
             "vault_tpu_torch.data.tombert_dataset", "vault_tpu_torch.text.entity_linking",
             "vault_tpu_torch.cli.tmsc_tombert"}
    assert names <= set(hygiene._port_modules())
    files = {str(p.relative_to(hygiene.ROOT)) for p in hygiene.PORT_FILES}
    assert {n.replace(".", "/") + ".py" for n in names} <= files
