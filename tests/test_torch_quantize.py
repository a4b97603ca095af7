"""The port's int8 quantization (``vault_tpu_torch/ops/quantize.py``, the
quantized ``linear`` and ``project_qkv``, the parameter bridge and the
checkpoints of quantized trees, the serving helpers) against the JAX
package's, on the same numpy inputs.

Tolerances: codes and scales equal exactly (the JAX functions run op by op,
where they divide as the port does); w8a8 ``linear`` fp32 atol 1e-6 (the
same int32 sums and the same fp32 dequantization steps; measured 0), bf16
one bf16 ulp (rtol 2^-7: XLA and torch round the fp32 result to bf16 from
the same value, measured 0); w8 ``linear`` fp32 atol 1e-5 (the fp product's
summation order), bf16 atol 1e-2 plus rtol 2^-7.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from vault_tpu import serving as jserving
from vault_tpu.ops import attention as jattn
from vault_tpu.ops import nn as jnn
from vault_tpu.ops import quantize as jq
from vault_tpu.training import checkpoint as jckpt
from vault_tpu_torch import serving as tserving
from vault_tpu_torch.convert import params_from_jax, params_to_jax
from vault_tpu_torch.ops import attention as tattn
from vault_tpu_torch.ops import nn as tnn
from vault_tpu_torch.ops import quantize as tq
from vault_tpu_torch.training import checkpoint as tckpt

from tests.test_torch_models import _cfgs, _jax_params, _model


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _weights(dtype, shape=(48, 40), seed=0):
    """Normal weights, plus columns built to land on half-way codes: a
    column whose absmax is 127 has scale 1, so 0.5, 2.5, -1.5 are ties."""
    rng = np.random.default_rng(seed)
    w = rng.normal(size=shape).astype(np.float32) * 0.05
    w[..., :, 0] = 0.0
    w[..., :6, 0] = [127.0, 0.5, 1.5, 2.5, -0.5, -2.5]
    w[..., :, 1] = 0.0  # all-zero column: the 1e-8 floor
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    return jnp.asarray(w, jd), torch.from_numpy(w).to(td)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_weight_matches_jax_exactly(dtype):
    jw, tw = _weights(dtype)
    jqv, js = jq.quantize_weight(jw)
    tqv, ts = tq.quantize_weight(tw)
    assert tqv.dtype == torch.int8 and ts.dtype == torch.float32
    assert tuple(ts.shape) == (1, 40)
    np.testing.assert_array_equal(tqv.numpy(), np.asarray(jqv))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    # the ties rounded half to even
    assert tqv[:6, 0].tolist() == [127, 0, 2, 2, 0, -2]
    # stacked layers: the scales are per layer and per column
    stack = jnp.stack([jw, 2 * jw])
    jqv, js = jq.quantize_weight(stack)
    tqv, ts = tq.quantize_weight(torch.stack([tw, 2 * tw]))
    np.testing.assert_array_equal(tqv.numpy(), np.asarray(jqv))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(
        _np(tq.dequantize_weight(tqv, ts)), _np(jq.dequantize_weight(jqv, js)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_activation_matches_jax_exactly(dtype):
    jw, tw = _weights(dtype, shape=(3, 40, 48), seed=1)
    jx, tx = jnp.swapaxes(jw, -1, -2), tw.transpose(-1, -2)  # ties along rows
    jqv, js = jq.quantize_activation(jx)
    tqv, ts = tq.quantize_activation(tx)
    assert tuple(ts.shape) == (3, 48, 1)
    np.testing.assert_array_equal(tqv.numpy(), np.asarray(jqv))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert tqv[0, 0, :6].tolist() == [127, 0, 2, 2, 0, -2]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", ["w8", "w8a8"])
def test_quantized_linear_matches_jax(mode, dtype):
    rng = np.random.default_rng(2)
    w = rng.normal(size=(64, 40)).astype(np.float32) * 0.05
    b = rng.normal(size=40).astype(np.float32) * 0.02
    x = rng.normal(size=(2, 9, 64)).astype(np.float32)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    jp = jq.quantize_linear_params({"w": jnp.asarray(w, jd), "b": jnp.asarray(b, jd)},
                                   mode=mode)
    tp = tq.quantize_linear_params({"w": torch.from_numpy(w).to(td),
                                    "b": torch.from_numpy(b).to(td)}, mode=mode)
    assert set(tp) == set(jp)
    ref = jnn.linear(jp, jnp.asarray(x, jd))
    out = tnn.linear(tp, torch.from_numpy(x).to(td))
    assert out.dtype == td and out.shape == (2, 9, 40)
    if dtype == "bfloat16":
        atol, rtol = (1e-2 if mode == "w8" else 0.0), 2.0 ** -7
    else:
        atol, rtol = (1e-5 if mode == "w8" else 1e-6), 0.0
    np.testing.assert_allclose(_np(out), _np(ref), atol=atol, rtol=rtol)


def test_int8_matmul_is_exact_at_the_largest_sums():
    """127 * 127 * 3072 passes 2^24: an fp32 product would round, the int
    product does not."""
    xq = torch.full((3, 3072), 127, dtype=torch.int8)
    wq = torch.full((3072, 8), 127, dtype=torch.int8)
    wq[0, 1] = 126
    y = tnn.int8_matmul(xq, wq)
    assert y.dtype == torch.int32
    assert y[0, 0].item() == 127 * 127 * 3072
    assert y[0, 1].item() == 127 * 127 * 3072 - 127


@pytest.mark.parametrize("mode", ["w8", "w8a8"])
def test_project_qkv_fused_quantized_matches_unfused_and_jax(mode):
    rng = np.random.default_rng(3)
    h = 64
    fp = {k: {"w": rng.normal(size=(h, h)).astype(np.float32) * 0.05,
              "b": rng.normal(size=h).astype(np.float32) * 0.02} for k in "qkv"}
    y = rng.normal(size=(2, 6, h)).astype(np.float32)
    jlp = {k: jq.quantize_linear_params({n: jnp.asarray(a) for n, a in p.items()},
                                        mode=mode) for k, p in fp.items()}
    tlp = {k: tq.quantize_linear_params({n: torch.from_numpy(a) for n, a in p.items()},
                                        mode=mode) for k, p in fp.items()}
    ref = tattn.project_qkv(tlp, torch.from_numpy(y), num_heads=4, fuse=False)
    out = tattn.project_qkv(tlp, torch.from_numpy(y), num_heads=4, fuse=True)
    jout = jattn.project_qkv(jlp, jnp.asarray(y), num_heads=4, fuse=True)
    for a, b, j in zip(ref, out, jout):
        np.testing.assert_allclose(_np(b), _np(a), rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(_np(b), _np(j), rtol=1e-5, atol=1e-6)


def _quantized_trees(mode, dtype="bfloat16"):
    jcfg, tcfg = _cfgs()
    jp = _jax_params(jcfg, dtype)
    jqp = jq.quantize_model_params(jp, mode=mode)
    model = _model(tcfg, jp, dtype).quantize(mode)
    return jcfg, tcfg, jp, jqp, model


@pytest.mark.parametrize("mode", ["w8", "w8a8"])
def test_quantize_model_params_matches_jax_through_the_bridge(mode):
    """The JAX package's quantized tree, bridged, equals the port's own
    quantization of the same fp weights leaf for leaf; int8 stays int8 and
    the scales fp32; it loads into the port model quantized the same way."""
    _, tcfg, jp, jqp, model = _quantized_trees(mode)
    sd = params_from_jax(jax.tree.map(np.asarray, jqp), tcfg)
    mine = model.state_dict()
    assert set(sd) == set(mine)
    key = "w_q8" if mode == "w8a8" else "w_q"
    n_int8 = 0
    for k, t in sd.items():
        assert t.dtype == mine[k].dtype and t.shape == mine[k].shape, k
        assert torch.equal(t, mine[k]), k
        if k.endswith(key):
            assert t.dtype == torch.int8
            assert sd[k[:-len(key)] + "w_scale"].dtype == torch.float32
            n_int8 += 1
    # 6 linears in each of the 2 + 2 layers
    assert n_int8 == 6 * (tcfg.vilt.num_hidden_layers
                          + tcfg.text_tower.num_hidden_layers)
    assert not model["vilt"]["layers"][0]["q"][key].requires_grad
    fresh = _model(tcfg, jp, "bfloat16").quantize(mode)
    fresh.load_state_dict(sd)
    assert all(torch.equal(a, b) for a, b in zip(fresh.state_dict().values(),
                                                  mine.values()))
    back = params_to_jax(sd)
    assert jax.tree.structure(back) == jax.tree.structure(
        jax.tree.map(np.asarray, jqp))
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jqp)):
        assert a.dtype == np.asarray(b).dtype
        np.testing.assert_array_equal(a, np.asarray(b))
    assert tq.quantized_bytes(model) == jq.quantized_bytes(jqp)
    assert tq.quantized_bytes(model) < jq.quantized_bytes(jp)


@pytest.mark.parametrize("mode", ["w8", "w8a8"])
def test_quantize_model_params_walks_the_llama_tree(mode):
    """The Llama tower's seven projections (q, k, v, o, gate, up, down) are
    quantized in a module tree and in a plain stacked dict, to the JAX
    package's codes and scales; the table and the norms stay as they are."""
    from vault_tpu.models import llama as jllama
    from vault_tpu_torch.convert import params_from_jax, params_to_jax
    from vault_tpu_torch.models import llama as tllama
    from vault_tpu_torch.ops.nn import ParamDict

    jcfg, tcfg = jllama.tiny_llama_config(), tllama.tiny_llama_config()
    jp = jllama.init_llama(jax.random.PRNGKey(4), jcfg)
    ref = jax.tree.map(np.asarray, jq.quantize_model_params(jp, mode=mode))
    host = jax.tree.map(np.asarray, jp)
    tower = ParamDict(llama=tllama.init_llama(torch.Generator().manual_seed(0), tcfg))
    tower.load_state_dict(params_from_jax({"llama": host}, llama_cfg=tcfg))
    tq.quantize_model_params(tower, mode=mode)
    back = params_to_jax(tower.state_dict())["llama"]
    as_dict = tq.quantize_model_params(
        jax.tree.map(lambda a: torch.from_numpy(np.array(a)), host), mode=mode)
    key = "w_q8" if mode == "w8a8" else "w_q"
    assert jax.tree.structure(back) == jax.tree.structure(ref)
    for name in ("q", "k", "v", "o", "gate", "up", "down"):
        assert set(back["layers"][name]) == {key, "w_scale"}
        for leaf in (key, "w_scale"):
            np.testing.assert_array_equal(back["layers"][name][leaf],
                                          ref["layers"][name][leaf])
            np.testing.assert_array_equal(as_dict["layers"][name][leaf].numpy(),
                                          ref["layers"][name][leaf])
    for name in ("input_ln", "post_ln"):
        np.testing.assert_array_equal(back["layers"][name], ref["layers"][name])
    np.testing.assert_array_equal(back["embed"], ref["embed"])


def test_quantize_model_params_on_a_plain_dict_returns_a_new_tree():
    rng = np.random.default_rng(4)
    tree = {"enc": {"q": {"w": torch.from_numpy(rng.normal(size=(8, 8)).astype(
        np.float32))}, "pooler": {"w": torch.ones(8, 8)}}, "n": torch.ones(3)}
    out = tq.quantize_model_params(tree, mode="w8a8")
    assert set(out["enc"]["q"]) == {"w_q8", "w_scale"} and "w" in tree["enc"]["q"]
    # not a QUANT_SUBLAYER: the same leaf
    assert out["enc"]["pooler"]["w"] is tree["enc"]["pooler"]["w"]
    with pytest.raises(ValueError, match="unknown quantization mode"):
        tq.quantize_model_params(tree, mode="int4")


def _k_major(q):
    """K (the second-to-last dimension, ``in``) contiguous: a transposed view
    of contiguous storage, for a matrix or a stack of them."""
    return q.transpose(-1, -2).is_contiguous() and not q.is_contiguous()


@pytest.mark.parametrize("form", ["module", "dict", "bridge"])
@pytest.mark.parametrize("mode", ["w8", "w8a8"])
def test_mlp_codes_are_held_k_major_in_w8a8_alone(mode, form):
    """Every w8a8 code matrix, in both towers (mlp_in / mlp_out, and
    q/k/v/attn_out, which the w8a8 linear kernel reads so), is held K-major
    (the int8 kernels' layout) after ``quantize``, after
    ``quantize_model_params`` on a plain stacked dict and after
    ``params_from_jax``; the w8 codes stay contiguous; ``params_to_jax``
    returns the JAX package's arrays."""
    _, tcfg, jp, jqp, model = _quantized_trees(mode)
    key = "w_q8" if mode == "w8a8" else "w_q"
    if form == "module":
        leaves = model.state_dict()
    elif form == "dict":
        tree = tq.quantize_model_params(
            jax.tree.map(lambda a: torch.from_numpy(np.array(a, np.float32)), jp), mode=mode)
        leaves = {f"{tower}.layers.{name}.{key}": tree[tower]["layers"][name][key]
                  for tower in ("vilt", "bert")
                  for name in ("q", "k", "v", "attn_out", "mlp_in", "mlp_out")}
    else:
        leaves = params_from_jax(jax.tree.map(np.asarray, jqp), tcfg)
        back = params_to_jax(leaves)
        for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jqp)):
            assert a.dtype == np.asarray(b).dtype and a.shape == np.asarray(b).shape
            np.testing.assert_array_equal(a, np.asarray(b))
    codes = {k: t for k, t in leaves.items() if k.endswith("." + key)}
    mlp = [k for k in codes if k.split(".")[-2] in ("mlp_in", "mlp_out")]
    # two per layer, or two stacks per tower in the dict
    assert len(mlp) == (4 if form == "dict" else
                        2 * (tcfg.vilt.num_hidden_layers + tcfg.text_tower.num_hidden_layers))
    for k, t in codes.items():
        assert t.dtype == torch.int8, k
        if mode == "w8a8":
            assert _k_major(t), (k, t.stride())
        else:
            assert t.is_contiguous(), (k, t.stride())


def test_quantized_checkpoints_cross_both_ways(tmp_path):
    """scripts/quantize_ckpt.py's flow: the JAX package quantizes and saves;
    the port restores the npz into its quantized model bit-equal, and the
    port's own save restores in the JAX package bit-equal."""
    _, tcfg, _, jqp, model = _quantized_trees("w8a8")
    path = str(tmp_path / "jax_w8a8")
    jckpt.save_checkpoint(path, {"params": jqp})
    target = {"params": params_to_jax(model.state_dict(), as_numpy=False)}
    got = tckpt.restore_checkpoint(path, target)["params"]
    sd = params_from_jax(got, tcfg)
    mine = model.state_dict()
    assert all(sd[k].dtype == mine[k].dtype and torch.equal(sd[k], mine[k])
               for k in mine)

    path = str(tmp_path / "port_w8a8")
    tckpt.save_checkpoint(path, {"params": params_to_jax(mine)})
    back = jckpt.restore_checkpoint(path, {"params": jqp})["params"]
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jqp)):
        assert np.asarray(a).dtype == np.asarray(b).dtype
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_a_quantized_model_refuses_casts():
    _, tcfg = _cfgs()
    from vault_tpu_torch.models.vault import VaultForClassification

    model = VaultForClassification(tcfg, device="cpu", dtype=torch.bfloat16)
    model.quantize("w8a8")
    for cast in (lambda m: m.float(), lambda m: m.to(torch.float32),
                 lambda m: m.to("cpu", torch.bfloat16).half()):
        with pytest.raises(RuntimeError, match="keeps its dtypes"):
            cast(model)
    assert model.vilt.layers[0].q.w_scale.dtype == torch.float32
    model.to("cpu")  # a move keeps the dtypes
    with pytest.raises(RuntimeError, match="already quantized"):
        model.quantize("w8")


def test_served_forwards_keep_the_fused_qkv_operands():
    """Without autograd a ViLT layer's w8a8 Q/K/V operands are concatenated
    once and kept on its q module, where no checkpoint sees them; a weight
    written in place (as a restore into the model writes it) builds them
    again; with autograd on nothing is kept."""
    from tests.test_torch_models import _batch, _sides
    from vault_tpu_torch.models.vault import VaultForClassification

    _, tcfg = _cfgs()
    model = VaultForClassification(tcfg, device="cpu", dtype=torch.bfloat16,
                                   seed=0).quantize("w8a8")
    _, batch = _sides(_batch(), "bfloat16")
    layer = model.vilt.layers[0]
    kept = lambda: layer.q.__dict__.get("_w8a8_qkv")
    assert kept() is None
    with torch.inference_mode():
        first = model(batch)
        wqkv, sqkv, bqkv = ops = kept()[2]
        assert torch.equal(model(batch), first) and kept()[2] is ops
    assert not any("qkv" in k for k in model.state_dict())
    h = layer.q.w_q8.shape[0]
    assert torch.equal(wqkv[:, h:2 * h], layer.k.w_q8)
    assert torch.equal(sqkv[2 * h:], layer.v.w_scale.reshape(-1))
    assert torch.equal(bqkv[:h], layer.q.b)
    with torch.no_grad():
        layer.k.w_q8.neg_()
        changed = model(batch)
    assert kept()[2] is not ops and torch.equal(kept()[2][0][:, h:2 * h], layer.k.w_q8)
    assert not torch.equal(changed, first)
    fresh = kept()
    assert torch.equal(model(batch), changed) and kept() is fresh


def test_serving_impl_matches_the_jax_serve_script():
    assert tserving.serving_impl("w8a8") == "fuselnqkv+fusemlp"
    assert tserving.serving_impl("w8a8", "cpu") == "fuselnqkv+fusemlp"
    assert tserving.serving_impl("w8a8", "cuda") == "fuselnqkv+fusemlp+batched"
    for mode in (None, "w8"):
        assert tserving.serving_impl(mode, "cuda") == "auto"
    _, tcfg = _cfgs()
    from vault_tpu_torch.models.vault import VaultForClassification

    kept = VaultForClassification(tcfg, device="cpu", use_pallas=False)
    assert kept.quantize("w8a8").use_pallas is False  # an explicit choice stays


@pytest.mark.parametrize("n_classes", [2, 3, 99, 100, 3129])
def test_check_serving_composition_matches_jax(n_classes):
    for mode in (None, "w8", "w8a8"):
        for merge_to in (None, 64, 120):
            for layer in (0, 1, 4):
                args = (n_classes, mode, merge_to, layer)
                assert (tserving.check_serving_composition(*args)
                        == jserving.check_serving_composition(*args)), args
