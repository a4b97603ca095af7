"""The port's Llama tower and its composition with ViLT against the JAX
package, at ``tiny_llama_config``.

One parameter pytree (the JAX package's init) is bridged with
``params_from_jax`` and fed, with the same numpy inputs, to both sides.
``attn_impl`` / ``mlp_impl`` "pallas" interpret the Pallas kernels on the JAX
side and go through the kernel wrappers on the port's, which take their
plain versions for CPU tensors.

Tolerances: fp32 atol 5e-5 (measured max 7.2e-7 on the tower's hidden
state); bf16 atol 3e-2 plus rtol 2^-7 (one bf16 ulp), as
tests/test_torch_models.py: XLA and torch round bf16 elementwise chains at
different points.  The w8a8 tower in fp32 keeps atol 5e-5: a code could flip
where the two sides differ by an ulp at a rounding boundary, which these
inputs do not meet.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from vault_tpu.config import tiny_vilt_config as j_tiny_vilt
from vault_tpu.models import llama as jllama
from vault_tpu.models import vault as jvault
from vault_tpu.models import vilt as jvilt
from vault_tpu.ops.quantize import quantize_model_params as j_quantize
from vault_tpu_torch.config import tiny_vilt_config
from vault_tpu_torch.convert import params_from_jax, params_to_jax
from vault_tpu_torch.models import llama as tllama
from vault_tpu_torch.models import vault as tvault
from vault_tpu_torch.ops.nn import ParamDict
from vault_tpu_torch.ops.quantize import is_k_major, quantize_model_params

DTYPES = ["float32", "bfloat16"]
IMPLS = ["xla", "pallas"]
ATOL = {"float32": 5e-5, "bfloat16": 3e-2}
RTOL = {"float32": 0.0, "bfloat16": 2.0 ** -7}


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close(out, ref, dtype):
    np.testing.assert_allclose(_np(out), _np(ref), atol=ATOL[dtype], rtol=RTOL[dtype])


def _jax_tower(dtype, seed=0, **cfg_kw):
    """The JAX package's tiny tower with its norm weights moved off 1; the
    norms stay fp32 whatever ``dtype`` is, as the serving probe keeps them."""
    jcfg = jllama.tiny_llama_config(**cfg_kw)
    p = jllama.init_llama(jax.random.PRNGKey(seed), jcfg)
    rng = np.random.default_rng(7)
    jd = getattr(jnp, dtype)
    cast = lambda t: jax.tree.map(lambda x: x.astype(jd), t)
    layers = {k: (v + jnp.asarray(0.1 * rng.normal(size=v.shape), jnp.float32)
                  if k.endswith("_ln") else cast(v)) for k, v in p["layers"].items()}
    return jcfg, {"embed": p["embed"].astype(jd), "layers": layers,
                  "final_ln": p["final_ln"] + jnp.asarray(
                      0.1 * rng.normal(size=p["final_ln"].shape), jnp.float32)}


def _port_tower(jp, tcfg):
    m = ParamDict(llama=tllama.init_llama(torch.Generator().manual_seed(0), tcfg))
    m.load_state_dict(params_from_jax({"llama": jax.tree.map(np.asarray, jp)},
                                      llama_cfg=tcfg), assign=True)
    return m["llama"]


def _ids(vocab=99, b=3, l=9, padded=True, seed=0):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, vocab, (b, l))
    mask = np.ones((b, l), np.int32)
    if padded:
        mask[1, 6:] = 0   # padded on the right
        mask[2, :2] = 0   # and on the left: its first queries see no key
    return ids, mask


def test_llama_config_defaults_match_jax():
    assert dataclasses.asdict(tllama.LlamaConfig()) == dataclasses.asdict(jllama.LlamaConfig())
    assert dataclasses.asdict(tllama.tiny_llama_config(attn_impl="pallas")) == \
        dataclasses.asdict(jllama.tiny_llama_config(attn_impl="pallas"))
    assert tllama.LlamaConfig().head_dim == 128


@pytest.mark.parametrize("dtype", DTYPES)
def test_rms_norm_matches_jax(dtype):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 5, 32)).astype(np.float32) * 3
    w = (1 + 0.1 * rng.normal(size=32)).astype(np.float32)
    ref = jllama._rms_norm(jnp.asarray(w), jnp.asarray(x, getattr(jnp, dtype)), 1e-5)
    out = tllama._rms_norm(torch.from_numpy(w),
                           torch.from_numpy(x).to(getattr(torch, dtype)), 1e-5)
    assert out.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(_np(out), _np(ref), atol=1e-6 if dtype == "float32" else 0,
                               rtol=RTOL[dtype])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("theta,d", [(10000.0, 8), (500000.0, 128)])
def test_rope_matches_jax(dtype, theta, d):
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 3, 40, d)).astype(np.float32)
    pos = np.stack([np.arange(40), np.arange(40) + 5000])
    ref = jllama._rope(jnp.asarray(x, getattr(jnp, dtype)), jnp.asarray(pos), theta, d)
    out = tllama._rope(torch.from_numpy(x).to(getattr(torch, dtype)),
                       torch.from_numpy(pos), theta, d)
    assert out.dtype == getattr(torch, dtype) and out.shape == x.shape
    # angles up to 5e3 rad: cos and sin of fp32 angles, a few ulps of 1 apart
    np.testing.assert_allclose(_np(out), _np(ref), atol=2e-6 if dtype == "float32" else 4e-2,
                               rtol=RTOL[dtype])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("padded", [False, True])
@pytest.mark.parametrize("attn_impl", IMPLS)
@pytest.mark.parametrize("mlp_impl", IMPLS)
def test_llama_apply_matches_jax(dtype, padded, attn_impl, mlp_impl):
    jcfg, jp = _jax_tower(dtype, attn_impl=attn_impl, mlp_impl=mlp_impl)
    tcfg = tllama.tiny_llama_config(attn_impl=attn_impl, mlp_impl=mlp_impl)
    tower = _port_tower(jp, tcfg)
    ids, mask = _ids(padded=padded)
    jmask = jnp.asarray(mask) if padded else None
    tmask = torch.from_numpy(mask) if padded else None
    ref = jllama.llama_apply(jp, jcfg, jnp.asarray(ids), jmask)
    with torch.inference_mode():
        out = tllama.llama_apply(tower, tcfg, torch.from_numpy(ids), tmask)
    assert out.shape == (3, 9, 32) and out.dtype == getattr(torch, dtype)
    assert torch.isfinite(out.float()).all()
    _close(out, ref, dtype)


def test_llama_apply_multi_head_and_unknown_impl():
    """num_key_value_heads == num_attention_heads takes plain multi-head
    attention; an unknown selector raises."""
    jcfg, jp = _jax_tower("float32", num_key_value_heads=4)
    tcfg = tllama.tiny_llama_config(num_key_value_heads=4)
    ids, mask = _ids()
    ref = jllama.llama_apply(jp, jcfg, jnp.asarray(ids), jnp.asarray(mask))
    out = tllama.llama_apply(_port_tower(jp, tcfg), tcfg, torch.from_numpy(ids),
                             torch.from_numpy(mask))
    _close(out, ref, "float32")
    bad = tllama.tiny_llama_config(attn_impl="flash")
    with pytest.raises(ValueError, match="attn_impl"):
        tllama.llama_apply(_port_tower(jp, tcfg), bad, torch.from_numpy(ids))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("mode", ["w8", "w8a8"])
@pytest.mark.parametrize("impl", IMPLS)
def test_quantized_llama_apply_matches_jax(dtype, mode, impl):
    """Both sides quantize the same fp weights (equal codes and scales);
    "pallas" takes the SwiGLU kernel's function for w8a8 (one I-tile at this
    size) and the plain composition for w8, as the JAX package's dispatch."""
    jcfg, jp = _jax_tower(dtype, attn_impl=impl, mlp_impl=impl)
    tcfg = tllama.tiny_llama_config(attn_impl=impl, mlp_impl=impl)
    tower = quantize_model_params(_port_tower(jp, tcfg), mode=mode)
    jqp = j_quantize(jp, mode=mode)
    key = "w_q8" if mode == "w8a8" else "w_q"
    np.testing.assert_array_equal(_np(tower["layers"][1]["gate"][key]),
                                  np.asarray(jqp["layers"]["gate"][key][1]))
    assert is_k_major(tower["layers"][1]["gate"][key]) == (mode == "w8a8")
    ids, mask = _ids(seed=3)
    ref = jllama.llama_apply(jqp, jcfg, jnp.asarray(ids), jnp.asarray(mask))
    with torch.inference_mode():
        out = tllama.llama_apply(tower, tcfg, torch.from_numpy(ids), torch.from_numpy(mask))
    _close(out, ref, dtype)


@pytest.mark.parametrize("mode", [None, "w8", "w8a8"])
def test_llama_tree_crosses_the_bridge_both_ways(mode):
    """``embed`` and the norms are bare arrays, the layers stacked on axis
    0; quantized leaves keep int8 and fp32."""
    jcfg, jp = _jax_tower("bfloat16")
    if mode:
        jp = j_quantize(jp, mode=mode)
    host = {"llama": jax.tree.map(np.asarray, jp)}
    sd = params_from_jax(host, llama_cfg=tllama.tiny_llama_config())
    assert sd["llama.embed"].dtype == torch.bfloat16
    assert sd["llama.layers.1.input_ln"].dtype == torch.float32
    if mode:
        key = "w_q8" if mode == "w8a8" else "w_q"
        assert sd[f"llama.layers.0.down.{key}"].dtype == torch.int8
        assert sd["llama.layers.0.down.w_scale"].dtype == torch.float32
        assert sd["llama.layers.0.down.w_scale"].shape == (1, 32)
    back = params_to_jax(sd)
    assert jax.tree.structure(back) == jax.tree.structure(host)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(host)):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="layer axis"):
        params_from_jax(host, llama_cfg=tllama.tiny_llama_config(num_hidden_layers=3))


@pytest.mark.parametrize("impl", IMPLS)
def test_k_major_swiglu_codes_cross_the_bridge_both_ways(impl):
    """The Llama layer's w8a8 codes arrive K-major (the same (in, out)
    values, K contiguous: the SwiGLU kernel's layout for the MLP's, the
    w8a8 linear kernel's for the attention projections'); loaded into a
    tower built quantized they stay K-major; they
    leave as the JAX package's arrays, shapes unchanged; the tower on them
    matches the JAX package's."""
    jcfg, jp = _jax_tower("float32", attn_impl=impl, mlp_impl=impl)
    jqp = j_quantize(jp, mode="w8a8")
    tcfg = tllama.tiny_llama_config(attn_impl=impl, mlp_impl=impl)
    host = {"llama": jax.tree.map(np.asarray, jqp)}
    sd = params_from_jax(host, llama_cfg=tcfg)
    for name in ("gate", "up", "down", "q", "k", "v", "o"):
        leaf = sd[f"llama.layers.1.{name}.w_q8"]
        assert is_k_major(leaf) and not leaf.is_contiguous()
        assert leaf.shape == host["llama"]["layers"][name]["w_q8"].shape[1:]
    tower = ParamDict(llama=tllama.init_llama(torch.Generator().manual_seed(0), tcfg,
                                              quantize="w8a8"))
    assert is_k_major(tower["llama"]["layers"][0]["down"]["w_q8"])
    tower.load_state_dict(sd)
    assert all(is_k_major(lp[n]["w_q8"]) for lp in tower["llama"]["layers"]
               for n in ("gate", "up", "down", "q", "k", "v", "o"))
    back = params_to_jax(tower.state_dict())
    assert jax.tree.structure(back) == jax.tree.structure(host)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(host)):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    ids, mask = _ids(seed=4)
    ref = jllama.llama_apply(jqp, jcfg, jnp.asarray(ids), jnp.asarray(mask))
    with torch.inference_mode():
        out = tllama.llama_apply(tower["llama"], tcfg, torch.from_numpy(ids),
                                 torch.from_numpy(mask))
    _close(out, ref, "float32")


def test_init_llama_quantized_layer_by_layer_equals_quantizing_afterwards():
    cfg = tllama.tiny_llama_config()
    for mode in ("w8", "w8a8"):
        built = tllama.init_llama(torch.Generator().manual_seed(5), cfg, torch.bfloat16, mode)
        fp = tllama.init_llama(torch.Generator().manual_seed(5), cfg, torch.float32)
        after = quantize_model_params(fp, mode=mode).state_dict()
        sd = built.state_dict()
        assert set(sd) == set(after)
        for k, v in sd.items():
            if k == "embed":
                assert v.dtype == torch.bfloat16
                assert torch.equal(v, after[k].to(torch.bfloat16))
            else:
                assert v.dtype == after[k].dtype and torch.equal(v, after[k]), k
    with pytest.raises(ValueError, match="quantization mode"):
        tllama.init_llama(torch.Generator().manual_seed(5), cfg, quantize="w4")


# ---------------------------------------------------------------------------
# The tower feeding ViLT
# ---------------------------------------------------------------------------

def _jax_vault(dtype, **cfg_kw):
    jcfg, jl = _jax_tower(dtype, **cfg_kw)
    vcfg = j_tiny_vilt()
    jd = getattr(jnp, dtype)
    k1, k2 = jax.random.split(jax.random.PRNGKey(3))
    rest = {"lm_proj": jllama.init_lm_projection(k1, jcfg.hidden_size, vcfg.hidden_size),
            "vilt": jvilt.init_vilt(k2, vcfg)}
    leaves, tree = jax.tree.flatten(rest)
    rng = np.random.default_rng(8)
    rest = jax.tree.unflatten(tree, [(l + jnp.asarray(0.02 * rng.normal(size=l.shape),
                                                      l.dtype)).astype(jd) for l in leaves])
    return jcfg, vcfg, {"llama": jl, **rest}


def _batch(b=3, seq=8, hw=(64, 64), seed=0):
    rng = np.random.default_rng(seed)
    am = np.ones((b, seq), np.int32)
    am[1, 5:] = 0
    pm = np.ones((b, *hw), np.int32)
    pm[1, :, 40:] = 0
    return {"input_ids": rng.integers(1, 99, (b, seq)).astype(np.int32),
            "attention_mask": am,
            "token_type_ids": (rng.random((b, seq)) > 0.5).astype(np.int32),
            "pixel_values": rng.normal(size=(b, 3, *hw)).astype(np.float32),
            "pixel_mask": pm}


def _port_vault(jp, tcfg, dtype):
    m = tvault.VaultWithLlamaTower(tiny_vilt_config(), tcfg, device="cpu",
                                   dtype=getattr(torch, dtype))
    m.load_state_dict(params_from_jax(jax.tree.map(np.asarray, jp), llama_cfg=tcfg))
    return m


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("mode", [None, "w8a8"])
@pytest.mark.parametrize("impl", IMPLS)
def test_vault_with_llama_tower_matches_jax(dtype, mode, impl):
    """End to end, fp and w8a8 tower, the tower's kernels off and on; the
    ViLT half on its kernel selector when the tower's are on."""
    jcfg, vcfg, jp = _jax_vault(dtype, attn_impl=impl, mlp_impl=impl)
    tcfg = tllama.tiny_llama_config(attn_impl=impl, mlp_impl=impl)
    model = _port_vault(jp, tcfg, dtype)
    if mode:
        jp = {**jp, "llama": j_quantize(jp["llama"], mode=mode)}
        model.quantize(mode)
    use_pallas = "fuseqkv+fusemlp+batched" if impl == "pallas" else False
    batch = _batch()
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jb["pixel_values"] = jb["pixel_values"].astype(getattr(jnp, dtype))
    ref = jvault.vault_with_llama_tower(jp, vcfg, jcfg, use_pallas=use_pallas, **jb)
    with torch.inference_mode():
        out = model(batch, use_pallas=use_pallas)
    assert out.pooler_output.shape == (3, vcfg.hidden_size)
    _close(out.last_hidden_state, ref.last_hidden_state, dtype)
    _close(out.pooler_output, ref.pooler_output, dtype)


def test_vault_with_llama_tower_module():
    """Seeded; quantizes the tower only; refuses a cast afterwards; built
    already quantized it equals quantize() on the built model; raises with
    neither a card nor a device."""
    vcfg, tcfg = tiny_vilt_config(), tllama.tiny_llama_config()
    a = tvault.VaultWithLlamaTower(vcfg, tcfg, device="cpu", seed=3)
    b = tvault.VaultWithLlamaTower(vcfg, tcfg, device="cpu", seed=3, quantize="w8a8")
    assert a.device.type == "cpu" and a.quant_mode is None and b.quant_mode == "w8a8"
    a.quantize("w8a8")
    sa, sb = a.state_dict(), b.state_dict()
    assert set(sa) == set(sb) and all(torch.equal(sa[k], sb[k]) for k in sa)
    assert "llama.layers.0.gate.w_q8" in sa and "vilt.layers.0.mlp_in.w" in sa
    assert "lm_proj.w" in sa and sa["llama.layers.0.input_ln"].dtype == torch.float32
    with pytest.raises(RuntimeError, match="already quantized"):
        a.quantize("w8")
    with pytest.raises(RuntimeError, match="keeps its dtypes"):
        a.bfloat16()
    c = tvault.VaultWithLlamaTower(vcfg, tcfg, device="cpu", seed=4)
    assert not torch.equal(c.state_dict()["llama.embed"], sa["llama.embed"])
    out = b(_batch())
    assert out.pooler_output.shape == (3, vcfg.hidden_size)


def test_vault_with_llama_tower_needs_a_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tvault.VaultWithLlamaTower(tiny_vilt_config(), tllama.tiny_llama_config())
