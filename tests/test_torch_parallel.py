"""The port's parallel layer against the JAX package's, in one process, on
the CPU at tiny size: the tensor-parallel sharding rules leaf for leaf, the
ZeRO leaf specs, ``pad_to_multiple``, the tensor-parallel forward (VAuLT,
its int8 forms and the Llama tower) against the JAX package's on a 1 x 2
mesh of the 8 virtual CPU devices, the 2-stage pipeline's forward and
gradients against ``vault_tpu/parallel/pipeline.py``, and the serving
forwards over a device list that names the host more than once.

Inputs are made with numpy from a seed and handed to both packages; the
comparisons run without dropout (the JAX package draws its own masks).
Tolerances are stated at each test.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from vault_tpu.config import VaultConfig as JVaultConfig
from vault_tpu.config import tiny_text_config as j_tiny_text
from vault_tpu.config import tiny_vilt_config as j_tiny_vilt
from vault_tpu.models import llama as jllama
from vault_tpu.models import vault as jvault
from vault_tpu.ops.quantize import quantize_model_params as j_quantize
from vault_tpu.parallel import mesh as jmesh
from vault_tpu.parallel import pipeline as jpipe
from vault_tpu.parallel import sharding as jsharding
from vault_tpu.parallel import zero as jzero
from vault_tpu.training import losses as jlosses
from vault_tpu_torch.config import VaultConfig, tiny_text_config, tiny_vilt_config
from vault_tpu_torch.convert import param_tree, params_from_jax, stacked_leaf
from vault_tpu_torch.models import llama as tllama
from vault_tpu_torch.models.vault import (
    VaultForClassification,
    VaultWithLlamaTower,
    vault_for_classification,
    vault_with_llama_tower,
)
from vault_tpu_torch.ops import nn as tnn
from vault_tpu_torch.ops.nn import shard_draws, take, uniform
from vault_tpu_torch.parallel import mesh as tmesh
from vault_tpu_torch.parallel import pipeline as tpipe
from vault_tpu_torch.parallel import sharding as tsharding
from vault_tpu_torch.parallel import zero as tzero
from vault_tpu_torch.parallel.tensor_parallel import TPGroup, use_tp
from vault_tpu_torch.serving import dp_sharded_forward, mesh_forward, tp_forward
from vault_tpu_torch.training import losses as tlosses

CPU = torch.device("cpu")


def _cfgs():
    text = dict(num_hidden_layers=2, hidden_dropout_prob=0.0,
                attention_probs_dropout_prob=0.0)
    vilt = dict(image_size=32, patch_size=16, num_patch_tokens=8)
    return (JVaultConfig(vilt=j_tiny_vilt(**vilt), text_tower=j_tiny_text(**text)),
            VaultConfig(vilt=tiny_vilt_config(**vilt), text_tower=tiny_text_config(**text)))


def _jax_params(jcfg, seed=0):
    p = jvault.init_vault(jax.random.PRNGKey(seed), jcfg)
    p["head"] = jvault.init_classifier_head(jax.random.PRNGKey(seed + 1),
                                            jcfg.vilt.hidden_size, 3)
    return jax.tree.map(np.asarray, p)


def _batch(cfg, n=8, seed=0):
    rng = np.random.default_rng(seed)
    am = np.ones((n, 8), np.int32)
    am[::3, 6:] = 0
    return {"input_ids": rng.integers(1, cfg.text_tower.vocab_size, (n, 8)).astype(np.int32),
            "attention_mask": am, "token_type_ids": np.zeros((n, 8), np.int32),
            "pixel_values": rng.normal(size=(n, 3, 32, 32)).astype(np.float32),
            "pixel_mask": np.ones((n, 32, 32), np.int32)}


def _tensors(batch):
    return {k: torch.as_tensor(v) for k, v in batch.items()}


def _cast_bf16(tree):
    return jax.tree.map(lambda x: x.astype(jnp.bfloat16)
                        if jnp.issubdtype(x.dtype, jnp.floating) else x, tree)


def _llama_params(seed=2):
    lcfg = jllama.tiny_llama_config()
    vcfg = j_tiny_vilt(image_size=32, patch_size=16, num_patch_tokens=8)
    p = {"llama": jllama.init_llama(jax.random.PRNGKey(seed), lcfg),
         "vilt": jvault.init_vault(jax.random.PRNGKey(seed + 1),
                                   JVaultConfig(vilt=vcfg))["vilt"],
         "lm_proj": {"w": 0.02 * jax.random.normal(jax.random.PRNGKey(seed + 2),
                                                   (lcfg.hidden_size, vcfg.hidden_size)),
                     "b": jnp.zeros((vcfg.hidden_size,))}}
    return lcfg, vcfg, jax.tree.map(np.asarray, p)


# ------------------------------------------------------------ the rules

def _jax_specs_by_key(tree):
    """{slash path: spec tuple} of the JAX package's rules."""
    specs = jsharding.vault_param_specs(tree)
    flat = jax.tree_util.tree_flatten_with_path(
        specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path): tuple(spec)
            for path, spec in flat}


@pytest.mark.parametrize("form", ["vault", "w8a8", "w8", "llama"])
def test_vault_param_specs_match_jax(form):
    """Every leaf's shard dim equals the JAX rules' through the bridge's key
    map: a stacked JAX leaf's spec without its layer axis; the K-major w8a8
    codes have the JAX shape, so the same dims."""
    if form == "llama":
        lcfg, _, tree = _llama_params()
        ours = params_from_jax(tree, llama_cfg=lcfg)
    else:
        jcfg, tcfg = _cfgs()
        tree = _jax_params(jcfg)
        if form != "vault":
            tree = jax.tree.map(np.asarray, j_quantize(_cast_bf16(tree), mode=form))
        ours = params_from_jax(tree, tcfg)
    ref = _jax_specs_by_key(tree)
    specs = tsharding.vault_param_specs(ours)
    sharded = 0
    for key, spec in specs.items():
        stacked = stacked_leaf(key)
        path = (stacked[0] if stacked else key).replace(".", "/")
        want = ref[path]
        want = want + (None,) * (len(np.shape(tree_leaf(tree, path))) - len(want))
        if stacked:
            want = want[1:]
        assert spec == want, (key, spec, want)
        sharded += tsharding.shard_dim(spec) is not None
    assert sharded > 0


def tree_leaf(tree, path):
    for part in path.split("/"):
        tree = tree[int(part)] if isinstance(tree, list) else tree[part]
    return tree


@pytest.mark.parametrize("dp", [1, 2, 3, 4, 8])
def test_leaf_spec_matches_jax(dp):
    """ZeRO's leaf rule over a sweep of shapes: the largest axis ``dp``
    divides (ties: the first), whole when none does."""
    rng = np.random.default_rng(dp)
    shapes = [(), (1,), (3,), (768,), (12, 768), (768, 768), (7, 5), (16, 16, 4),
              (2, 3, 12)] + [tuple(rng.integers(1, 40, rng.integers(1, 4)))
                             for _ in range(40)]
    for shape in shapes:
        assert tzero._leaf_spec(shape, dp) == tuple(jzero._leaf_spec(shape, dp)), shape


@pytest.mark.parametrize("multiple", [1, 2, 3, 8])
@pytest.mark.parametrize("n", [1, 5, 8, 19])
def test_pad_to_multiple_matches_jax(n, multiple):
    rng = np.random.default_rng(n)
    batch = {"a": rng.normal(size=(n, 3)).astype(np.float32),
             "b": rng.integers(0, 9, (n,)).astype(np.int32)}
    ours, n_ours = tmesh.pad_to_multiple(batch, multiple)
    ref, n_ref = jmesh.pad_to_multiple(batch, multiple)
    assert n_ours == n_ref == n
    for k in batch:
        np.testing.assert_array_equal(np.asarray(ours[k]), np.asarray(ref[k]))


def test_shard_batch_cuts_rows_per_micro_batch():
    """Rank d of a mesh keeps [:, d] of the rows read as (micro, ranks,
    m): micro-batch i of every rank comes from global micro-batch i."""
    x = np.arange(24)
    for d in range(3):
        mesh = tmesh.Mesh(3, 1, d, 0, None, None)
        assert tmesh.shard_batch(mesh, x).tolist() == list(range(8 * d, 8 * d + 8))
        assert tmesh.shard_batch(mesh, {"x": x}, micro=2)["x"].tolist() == (
            list(range(4 * d, 4 * d + 4)) + list(range(12 + 4 * d, 16 + 4 * d)))
    with pytest.raises(ValueError, match="do not split"):
        tmesh.shard_batch(tmesh.Mesh(5, 1, 0, 0, None, None), x)


def test_make_mesh_needs_a_group():
    with pytest.raises(RuntimeError, match="initialized torch.distributed"):
        tmesh.make_mesh(2)


def test_default_backend_follows_the_device(monkeypatch):
    """One rule for the group's backend: NCCL for ranks on a visible card,
    gloo for CPU ranks or where no card is visible."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert tmesh.default_backend() == tmesh.default_backend("cuda:1") == "nccl"
    assert tmesh.default_backend("cpu") == "gloo"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert tmesh.default_backend() == tmesh.default_backend("cuda:0") == "gloo"


def test_sharded_draws_are_blocks_of_the_global_draw():
    """Under ``shard_draws`` each rank's draw is its block of the draw the
    whole tensor would get: rows of the leading axis, heads of the named
    axis, both at once."""
    shape = (4, 6, 5, 5)
    full = uniform(torch.Generator().manual_seed(3), (8, 12, 5, 5))
    for r in range(2):
        for h in range(2):
            with shard_draws(rows=(r, 2), heads=(h, 2)):
                part = uniform(torch.Generator().manual_seed(3), shape, heads_axis=1)
            assert torch.equal(part, full[4 * r:4 * r + 4, 6 * h:6 * h + 6])
    with shard_draws(rows=(1, 2)):
        rows_only = uniform(torch.Generator().manual_seed(3), (4, 12, 5, 5), heads_axis=1)
    assert torch.equal(rows_only, full[4:])


def test_take_sums_lookup_gradients_in_fp32():
    """``ops.nn.take``'s card path (``_Take``, run here on the host): a bf16
    row read 3,000 times gets the fp32 sum of its gradients rounded once
    (within a bf16 ulp of the exact sum), where the plain lookup's
    backward rounds at every term (more than 10 ulps off).  On the host
    ``take`` is the plain lookup, the JAX package's rounding."""
    table = torch.randn(4, 8, dtype=torch.bfloat16)
    ids = torch.zeros(3000, dtype=torch.long)
    g = torch.randn(3000, 8, generator=torch.Generator().manual_seed(0))
    exact = g.double().sum(0)
    grads = {}
    for name, fn in (("fp32", lambda t: tnn._Take.apply(t, ids)),
                     ("plain", lambda t: t[ids])):
        t = table.clone().requires_grad_(True)
        (fn(t).float() * g).sum().backward()
        grads[name] = t.grad
    ulp = exact.abs().max().item() * 2.0 ** -8
    assert (grads["fp32"][0].double() - exact).abs().max().item() <= ulp
    assert (grads["plain"][0].double() - exact).abs().max().item() > 10 * ulp
    assert grads["fp32"][1:].abs().max() == 0
    t = table.clone().requires_grad_(True)
    assert take(t, ids).grad_fn.name() != "_TakeBackward"


# ------------------------------------------------------------ TP forward

def _jax_tp_forward(fn, params, batch):
    mesh = jmesh.make_mesh(num_data=1, num_model=2)
    sharded = jsharding.shard_params(mesh, params)
    return np.asarray(jax.jit(fn)(sharded, jax.device_put(batch, jmesh.replicated(mesh))),
                      np.float32)


_TP_CASES = [pytest.param(mode, False, id=str(mode)) for mode in (None, "w8", "w8a8")] + [
    pytest.param(mode, impl, id=f"{mode}-{impl}") for mode in (None, "w8a8")
    for impl in ("fuseqkv+fusemlp", "fuselnqkv+fusemlp")]


@pytest.mark.parametrize("mode,impl", _TP_CASES)
def test_tp_forward_matches_jax(mode, impl):
    """The VAuLT classifier on 2 shards (``serving.tp_forward``, one thread
    a shard) against the JAX package's forward on a 1 x 2 mesh, fp32
    activations: atol 2e-5 (the row products' partial sums and the LN
    statistics in other orders; w8a8 sums its int32 partials, exact).  The
    port runs under the fused selectors too: under a group a layer takes
    the plain composition where the selector names a fused block, so the
    reference stays ``use_pallas=False``."""
    jcfg, tcfg = _cfgs()
    params = _jax_params(jcfg)
    if mode is not None:
        params = jax.tree.map(np.asarray, j_quantize(params, mode=mode))
    batch = _batch(tcfg)
    ref = _jax_tp_forward(lambda p, b: jvault.vault_for_classification(
        p, jcfg, b, head_dropout=0.0, deterministic=True, use_pallas=False), params, batch)
    ours = params_from_jax(params, tcfg)
    fwd = tp_forward(lambda p, b: vault_for_classification(
        param_tree(p), tcfg, b, head_dropout=0.0, use_pallas=impl), [CPU, CPU], ours)
    with torch.no_grad():
        out = fwd(_tensors(batch)).float().numpy()
    np.testing.assert_allclose(out, ref, atol=2e-5, rtol=0)


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_llama_tp_forward_matches_jax(impl):
    """The Llama tower feeding ViLT on 2 shards (query and K/V heads split
    alike; gate/up column, o/down row) against the JAX package's 1 x 2
    mesh forward: atol 2e-5.  With ``attn_impl`` and ``mlp_impl`` "pallas"
    the shards still run the plain composition, so the reference is the
    same."""
    lcfg_j, vcfg_j, params = _llama_params()
    lcfg = tllama.tiny_llama_config(attn_impl=impl, mlp_impl=impl)
    vcfg = tiny_vilt_config(image_size=32, patch_size=16, num_patch_tokens=8)
    rng = np.random.default_rng(4)
    batch = {"input_ids": rng.integers(0, lcfg.vocab_size, (4, 8)).astype(np.int32),
             "attention_mask": np.ones((4, 8), np.int32),
             "pixel_values": rng.normal(size=(4, 3, 32, 32)).astype(np.float32),
             "pixel_mask": np.ones((4, 32, 32), np.int32)}
    ref = _jax_tp_forward(lambda p, b: jvault.vault_with_llama_tower(
        p, vcfg_j, lcfg_j, **b).pooler_output, params, batch)
    ours = params_from_jax(params, llama_cfg=lcfg)
    fwd = tp_forward(lambda p, b: vault_with_llama_tower(
        param_tree(p), vcfg, lcfg, use_pallas=False, **b).pooler_output, [CPU, CPU], ours)
    with torch.no_grad():
        out = fwd(_tensors(batch)).numpy()
    np.testing.assert_allclose(out, ref, atol=2e-5, rtol=0)


class _CountingTP(TPGroup):
    """A group of one shard that counts the inputs entering column products."""

    def __init__(self):
        self.entered = 0

    def enter(self, x):
        self.entered += 1
        return x

    def reduce(self, x):
        return x

    def reduce_max(self, x):
        return x


@pytest.mark.parametrize("case", ["fuseqkv+fusemlp", "fuselnqkv+fusemlp+batched", "llama"])
def test_layers_enter_their_column_products_under_a_group(case):
    """Under a group every BERT, ViLT and Llama layer passes the input of
    each of its two column products (Q/K/V; ``mlp_in`` or gate/up) through
    the group's ``enter``, whatever the selector or the Llama impls name: a
    fused LN->QKV, MLP or SwiGLU block would skip it, and with it the
    backward's all-reduce, which the forward cases above cannot see.  A
    group of one shard computes the unsharded layers: within 1e-5 of the
    same forward at ``use_pallas=False`` under the group."""
    _, tcfg = _cfgs()
    if case == "llama":
        lcfg = tllama.tiny_llama_config(attn_impl="pallas", mlp_impl="pallas")
        vcfg = tiny_vilt_config(image_size=32, patch_size=16, num_patch_tokens=8)
        model = VaultWithLlamaTower(vcfg, lcfg, device="cpu", seed=3)
        layers = lcfg.num_hidden_layers + vcfg.num_hidden_layers
        batch = {k: v for k, v in _tensors(_batch(tcfg)).items() if k != "token_type_ids"}
        impls = (False, "fuselnqkv+fusemlp")
    else:
        model = VaultForClassification(tcfg, device="cpu", seed=3)
        layers = tcfg.text_tower.num_hidden_layers + tcfg.vilt.num_hidden_layers
        batch = _tensors(_batch(tcfg))
        impls = (False, case)
    outs = []
    for impl in impls:
        tp = _CountingTP()
        with torch.no_grad(), use_tp(tp):
            out = model(batch, use_pallas=impl)
        outs.append((out.pooler_output if case == "llama" else out).numpy())
        assert tp.entered == 2 * layers, (impl, tp.entered)
    np.testing.assert_allclose(outs[1], outs[0], atol=1e-5, rtol=0)


@pytest.mark.parametrize("mode", [None, "w8a8"])
def test_dp_and_mesh_serving_match_the_direct_forward(mode):
    """``dp_sharded_forward`` over the host named twice equals each half's
    direct forward exactly; a 2 x 2 ``mesh_forward`` (data halves, each on
    2 tensor-parallel shards) is within 2e-5 of the direct forward (w8a8
    exactly: its row products sum int32 partials)."""
    jcfg, tcfg = _cfgs()
    params = _jax_params(jcfg)
    if mode is not None:
        params = jax.tree.map(np.asarray, j_quantize(params, mode=mode))
    ours = params_from_jax(params, tcfg)
    apply = lambda p, b: vault_for_classification(param_tree(p), tcfg, b,
                                                  head_dropout=0.0, use_pallas=False)
    batch = _tensors(_batch(tcfg))
    with torch.no_grad():
        direct = torch.cat([apply(ours, {k: v[i:i + 4] for k, v in batch.items()})
                            for i in (0, 4)])
        dp = dp_sharded_forward(apply, [CPU, CPU], ours)(batch)
        grid = mesh_forward(apply, [CPU] * 4, ours, dp=2, tp=2)(batch)
    assert torch.equal(dp, direct)
    np.testing.assert_allclose(grid.numpy(), direct.numpy(), atol=0 if mode else 2e-5,
                               rtol=0)
    with pytest.raises(ValueError, match="does not split"):
        dp_sharded_forward(apply, [CPU] * 3, ours)(batch)


def test_thread_tp_failure_does_not_hang():
    """A shard that fails breaks the other shards' barriers: the error
    comes back instead of a hang."""
    jcfg, tcfg = _cfgs()
    ours = params_from_jax(_jax_params(jcfg), tcfg)
    calls = []

    def apply(p, b):
        calls.append(1)
        if len(calls) == 1:
            raise RuntimeError("shard failed")
        return vault_for_classification(param_tree(p), tcfg, b, head_dropout=0.0,
                                        use_pallas=False)

    with pytest.raises(RuntimeError, match="shard failed"), torch.no_grad():
        tp_forward(apply, [CPU, CPU], ours)(_tensors(_batch(tcfg)))


# ------------------------------------------------------------ the pipeline

def test_pipeline_forward_matches_jax():
    """``PipelineVault`` (both stages on the host, micro-batches of 3 over
    8 rows) against the JAX package's on two CPU devices: atol 2e-5."""
    jcfg, tcfg = _cfgs()
    params = _jax_params(jcfg)
    batch = _batch(tcfg)
    devs = jax.devices()[:2]
    ref = jpipe.PipelineVault(params, jcfg, lm_device=devs[0], vilt_device=devs[1],
                              inner_batch_size=3)(**batch)
    pipe = tpipe.PipelineVault(params_from_jax(params, tcfg), tcfg, lm_device=CPU,
                               vilt_device=CPU, inner_batch_size=3, use_pallas=False)
    out = pipe(**_tensors(batch))
    for ours, theirs in ((out.last_hidden_state, ref.last_hidden_state),
                         (out.pooler_output, ref.pooler_output)):
        np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), atol=2e-5, rtol=0)


@pytest.mark.parametrize("n,num_micro", [(8, 2), (9, 4)])
def test_pipeline_grads_match_jax(n, num_micro):
    """The trainable pipeline's loss and every leaf's gradient against
    ``vault_tpu/parallel/pipeline.py`` (the ceil split: 9 rows in 4 asks
    gives 3 micro-batches of 3), weighted-sum micro losses, the LM backward
    by recompute: atol 1e-5 on the loss and 2e-6 on gradients of scale
    ~1e-2."""
    jcfg, tcfg = _cfgs()
    params = _jax_params(jcfg)
    batch = _batch(tcfg, n=n, seed=n)
    labels = np.random.default_rng(n).integers(0, 3, n)
    weight = np.ones(n, np.float32)
    weight[1] = 0.0
    devs = jax.devices()[:2]
    placed = jpipe.place_pipeline_params(params, devs[0], devs[1])
    jfn = jpipe.make_pipeline_train_fn(jcfg, jlosses.softmax_cross_entropy, params,
                                       lm_device=devs[0], vilt_device=devs[1],
                                       num_micro=num_micro)
    jloss, jgrads = jfn(placed, {k: jnp.asarray(v) for k, v in batch.items()},
                        jnp.asarray(labels), jnp.asarray(weight))
    ref = params_from_jax(jax.tree.map(np.asarray, jgrads), tcfg)

    assert len(tpipe._micro_slices(n, num_micro)) == (3 if n == 9 else 2)
    ours_p = tpipe.place_pipeline_params(params_from_jax(params, tcfg), CPU, CPU)
    fn = tpipe.make_pipeline_train_fn(tcfg, tlosses.softmax_cross_entropy,
                                      lm_device=CPU, vilt_device=CPU,
                                      num_micro=num_micro, use_pallas=False)
    loss, grads = fn(ours_p, batch, labels, weight)
    np.testing.assert_allclose(float(loss), float(jloss), atol=1e-5)
    assert set(grads) <= set(ref)
    for k, g in grads.items():
        np.testing.assert_allclose(g.numpy(), ref[k].numpy(), atol=2e-6, rtol=0,
                                   err_msg=k)


def test_pipeline_with_dropout_redraws_the_lm_masks():
    """With a seed the pipeline draws dropout; the LM backward by recompute
    redraws the forward's masks, so its gradients equal autograd through
    the same forward kept whole, drawn from the same micro-batch
    generators (atol 1e-6), and another seed gives other gradients."""
    import dataclasses

    from vault_tpu_torch.models import vilt as tvilt
    from vault_tpu_torch.models.vault import classifier_head_apply, lm_encode

    jcfg, tcfg = _cfgs()
    tcfg = dataclasses.replace(tcfg, text_tower=dataclasses.replace(
        tcfg.text_tower, hidden_dropout_prob=0.3, attention_probs_dropout_prob=0.3))
    params = params_from_jax(_jax_params(jcfg), tcfg)
    batch = _batch(tcfg, n=4)
    labels = np.array([0, 1, 2, 0])
    weight = np.ones(4, np.float32)
    placed = tpipe.place_pipeline_params(params, CPU, CPU)
    fn = tpipe.make_pipeline_train_fn(tcfg, tlosses.softmax_cross_entropy, lm_device=CPU,
                                      vilt_device=CPU, num_micro=1, use_pallas=False)
    loss, grads = fn(placed, batch, labels, weight, seed=5)
    _, other = fn(placed, batch, labels, weight, seed=6)

    ref = {k: v.detach().clone().requires_grad_(v.is_floating_point())
           for k, v in params.items()}
    tree, b = param_tree(ref), _tensors(batch)
    g_lm, g_s2 = (tpipe._generator(5, stage, 0, CPU) for stage in (0, 1))
    hidden = lm_encode(tree, tcfg, b["input_ids"], b["attention_mask"], b["token_type_ids"],
                       deterministic=False, generator=g_lm, use_pallas=False)
    out = tvilt.vilt_apply(tree["vilt"], tcfg.resolved_vilt(),
                           attention_mask=b["attention_mask"],
                           token_type_ids=b["token_type_ids"],
                           pixel_values=b["pixel_values"], pixel_mask=b["pixel_mask"],
                           inputs_embeds=hidden, deterministic=False, generator=g_s2,
                           use_pallas=False)
    logits = classifier_head_apply(tree["head"], out.pooler_output, 0.0, False, g_s2)
    ref_loss = tlosses.softmax_cross_entropy(logits, torch.as_tensor(labels),
                                             torch.as_tensor(weight))
    ref_grads = dict(zip(grads, torch.autograd.grad(
        ref_loss, [ref[k] for k in grads], allow_unused=True)))
    np.testing.assert_allclose(float(loss), float(ref_loss), atol=1e-6)
    for k, g in grads.items():
        want = torch.zeros_like(g) if ref_grads[k] is None else ref_grads[k]
        np.testing.assert_allclose(g.numpy(), want.numpy(), atol=1e-6, rtol=0, err_msg=k)
    k = "bert.layers.0.mlp_in.w"
    assert not torch.allclose(grads[k], other[k])
