"""The PyTorch port's ops (vault_tpu_torch/ops) against the JAX package's.

Inputs are made with numpy from a seed and fed to both sides.  Tolerances:
fp32 atol 1e-5 (summation order only); bf16 results may differ by one bf16
rounding step (relative 2^-8) where the fp32 sums before the cast differ in
their last bits.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from vault_tpu.ops import attention as jattn
from vault_tpu.ops import interpolate as jinterp
from vault_tpu.ops import masks as jmasks
from vault_tpu.ops import nn as jnn
from vault_tpu_torch.ops import attention as tattn
from vault_tpu_torch.ops import interpolate as tinterp
from vault_tpu_torch.ops import masks as tmasks
from vault_tpu_torch.ops import nn as tnn

ATOL = 1e-5
BF16_RTOL = 2.0 ** -8


def _t(a, dtype=None):
    t = torch.from_numpy(np.ascontiguousarray(a))
    return t if dtype is None else t.to(dtype)


def _j(a, dtype=None):
    return jnp.asarray(a) if dtype is None else jnp.asarray(a, dtype)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _linear_params(rng, din, dout, bias=True):
    p = {"w": rng.normal(size=(din, dout)).astype(np.float32) * 0.2}
    if bias:
        p["b"] = rng.normal(size=(dout,)).astype(np.float32)
    return p


@pytest.mark.parametrize("bias", [True, False])
def test_linear_fp32(bias):
    rng = np.random.default_rng(0)
    p = _linear_params(rng, 16, 8, bias)
    x = rng.normal(size=(3, 5, 16)).astype(np.float32)
    ref = jnn.linear({k: _j(v) for k, v in p.items()}, _j(x))
    out = tnn.linear({k: _t(v) for k, v in p.items()}, _t(x))
    assert out.dtype == torch.float32
    np.testing.assert_allclose(_np(out), _np(ref), atol=ATOL)


def test_linear_bf16_single_rounding():
    """bf16 in: fp32 products and bias add, ONE cast to bf16 (nn.py:44-48)."""
    rng = np.random.default_rng(1)
    p = _linear_params(rng, 64, 32)
    x = rng.normal(size=(4, 64)).astype(np.float32)
    jp = {k: _j(v, jnp.bfloat16) for k, v in p.items()}
    tp = {k: _t(v, torch.bfloat16) for k, v in p.items()}
    ref = jnn.linear(jp, _j(x, jnp.bfloat16))
    out = tnn.linear(tp, _t(x, torch.bfloat16))
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(out), _np(ref), rtol=BF16_RTOL, atol=1e-6)
    # the single rounding, computed independently in float64
    want = (tp["w"].double().numpy().T @ _t(x, torch.bfloat16).double().numpy().T).T
    want = torch.from_numpy(want + tp["b"].double().numpy()).to(torch.bfloat16)
    assert (out.float() == want.float()).float().mean() > 0.99


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layer_norm(dtype):
    rng = np.random.default_rng(2)
    x = (rng.normal(size=(3, 7, 32)) * 3 + 1).astype(np.float32)
    p = {"scale": rng.normal(size=32).astype(np.float32),
         "bias": rng.normal(size=32).astype(np.float32)}
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    ref = jnn.layer_norm({k: _j(v, jd) for k, v in p.items()}, _j(x, jd), 1e-12)
    out = tnn.layer_norm({k: _t(v, td) for k, v in p.items()}, _t(x, td), 1e-12)
    assert out.dtype == td
    if dtype == "float32":
        np.testing.assert_allclose(_np(out), _np(ref), atol=ATOL)
    else:
        np.testing.assert_allclose(_np(out), _np(ref), rtol=BF16_RTOL, atol=1e-2)


@pytest.mark.parametrize("name", ["gelu", "gelu_new", "gelu_pytorch_tanh", "relu"])
def test_act_fn(name):
    x = np.linspace(-6, 6, 257).astype(np.float32)
    np.testing.assert_allclose(_np(tnn.act_fn(name)(_t(x))),
                               _np(jnn.act_fn(name)(_j(x))), atol=ATOL)


def test_act_fn_unknown():
    with pytest.raises(ValueError):
        tnn.act_fn("swish")


def test_dropout_and_mask():
    x = torch.ones(1000)
    assert tnn.dropout(None, x, 0.1, deterministic=True) is x
    with pytest.raises(ValueError):
        tnn.dropout(None, x, 0.1, deterministic=False)
    g = torch.Generator().manual_seed(0)
    y = tnn.dropout(g, x, 0.25, deterministic=False)
    assert set(np.unique(y.numpy()).tolist()) <= {0.0, float(np.float32(1 / 0.75))}
    m1 = tnn.dropout_mask(torch.Generator().manual_seed(3), (50, 4), 0.1)
    m2 = tnn.dropout_mask(torch.Generator().manual_seed(3), (50, 4), 0.1)
    assert torch.equal(m1, m2)
    assert set(np.unique(m1.numpy()).tolist()) <= {0.0, float(np.float32(1 / 0.9))}



def test_dropout_mask_needs_a_generator():
    """Like dropout, the mask never draws from the global generator: a
    missing generator raises instead of drawing an unreproducible mask."""
    state = torch.random.get_rng_state()
    with pytest.raises(ValueError, match="Generator"):
        tnn.dropout_mask(None, (4, 4), 0.1)
    assert torch.equal(state, torch.random.get_rng_state())

def test_extend_attention_mask():
    mask = np.array([[1, 1, 0], [1, 0, 0]], np.int32)
    ref = jmasks.extend_attention_mask(_j(mask))
    out = tmasks.extend_attention_mask(_t(mask))
    assert out.shape == (2, 1, 1, 3) and out.dtype == torch.float32
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    assert np.isfinite(out.numpy()).all()


@pytest.mark.parametrize("in_hw,out_hw", [((64, 64), (4, 4)), ((50, 70), (7, 9)),
                                          ((384, 608), (12, 19))])
def test_downsample_mask_nearest(in_hw, out_hw):
    rng = np.random.default_rng(3)
    mask = (rng.random((2, *in_hw)) > 0.3).astype(np.int32)
    ref = jinterp.downsample_mask_nearest(_j(mask), *out_hw)
    out = tinterp.downsample_mask_nearest(_t(mask), *out_hw)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def test_interpolate_pos_grid_ragged_extents():
    rng = np.random.default_rng(4)
    grid = rng.normal(size=(12, 12, 8)).astype(np.float32)
    h = np.array([12, 7, 1, 3], np.int32)
    w = np.array([19, 5, 4, 1], np.int32)
    ref = jinterp.interpolate_pos_grid(_j(grid), _j(h), _j(w), 12, 19)
    out = tinterp.interpolate_pos_grid(_t(grid), _t(h), _t(w), 12, 19)
    assert out.shape == (4, 12, 19, 8)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL)
    assert (out.numpy()[1, 7:] == 0).all() and (out.numpy()[1, :, 5:] == 0).all()


@pytest.mark.parametrize("sel", [False, True, "batched", "grid", "dotbatch",
                                 "fuseqkv", "fuseqkv+fusemlp",
                                 "fuseqkv+fusemlp+batched", "fuselnqkv+grid",
                                 "false", "off"])
def test_parse_impl_matches_jax(sel):
    assert tattn.parse_impl(sel) == jattn.parse_impl(sel)


def test_parse_impl_auto_by_device():
    assert tattn.parse_impl("auto", torch.device("cpu")) == (False, False, False, False)
    assert tattn.parse_impl("auto") == (False, False, False, False)
    assert (tattn.parse_impl("auto", torch.device("cuda"))
            == tattn.parse_impl(tattn.CUDA_DEFAULT_IMPL)
            == (True, False, True, "batched"))


@pytest.mark.parametrize("bad", ["fuse_mlp", "fusemlp+flash", "batched+bogus"])
def test_parse_impl_rejects_unknown(bad):
    with pytest.raises(ValueError):
        tattn.parse_impl(bad)


@pytest.mark.parametrize("fuse", [False, True])
@pytest.mark.parametrize("bias", [True, False])
def test_project_qkv(fuse, bias):
    rng = np.random.default_rng(5)
    lp = {n: _linear_params(rng, 32, 32, bias) for n in ("q", "k", "v")}
    y = rng.normal(size=(2, 6, 32)).astype(np.float32)
    ref = jattn.project_qkv({n: {k: _j(v) for k, v in p.items()}
                             for n, p in lp.items()}, _j(y), 4, fuse)
    out = tattn.project_qkv({n: {k: _t(v) for k, v in p.items()}
                             for n, p in lp.items()}, _t(y), 4, fuse)
    for o, r in zip(out, ref):
        assert o.shape == (2, 4, 6, 8)
        np.testing.assert_allclose(_np(o), _np(r), atol=ATOL)
    np.testing.assert_allclose(_np(tattn.merge_heads(out[0])),
                               _np(jattn.merge_heads(ref[0])), atol=ATOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("with_bias", [True, False])
def test_attend_plain_matches_attend_xla(dtype, with_bias):
    rng = np.random.default_rng(6)
    q, k, v = (rng.normal(size=(2, 3, 11, 8)).astype(np.float32)
               for _ in range(3))
    mask = np.ones((2, 11), np.int32)
    mask[1, 6:] = 0
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    jb = jmasks.extend_attention_mask(_j(mask)) if with_bias else None
    tb = tmasks.extend_attention_mask(_t(mask)) if with_bias else None
    ref = jattn.attend_xla(_j(q, jd), _j(k, jd), _j(v, jd), jb)
    out = tattn.attend_plain(_t(q, td), _t(k, td), _t(v, td), tb)
    assert out.dtype == td
    if dtype == "float32":
        np.testing.assert_allclose(_np(out), _np(ref), atol=ATOL)
    else:
        np.testing.assert_allclose(_np(out), _np(ref), atol=2e-2)
