"""The plain versions of the port's CUDA kernels against the JAX package's
Pallas kernels (interpret mode on the CPU) and the XLA compositions they
mirror.

On the CPU the wrappers take their plain versions, so these tests hold the
arithmetic the kernels are compared with on the card (chip_smoke.py).
Tolerances: fp32 atol 2e-5 (the Pallas GELU is the A&S erf approximation,
|err| <= 1.5e-7, and summation orders differ); bf16 compares in fp32 after
the cast, atol 2e-2 plus rtol 2^-7 (one bf16 ulp): the Pallas kernels keep
the GELU input in fp32 where the compositions round it to bf16 first, and
torch and XLA round bf16 elementwise chains at different points, so
outputs of magnitude ~2-4 differ by up to two bf16 ulps.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from vault_tpu.ops import pallas_attention as pa
from vault_tpu.ops import pallas_mlp as pm
from vault_tpu.ops.attention import attend_xla
from vault_tpu.ops.masks import extend_attention_mask as j_extend
from vault_tpu_torch.ops import cuda_attention as ca
from vault_tpu_torch.ops import cuda_mlp as cm
from vault_tpu_torch.ops.masks import extend_attention_mask as t_extend

ATOL = {"float32": 2e-5, "bfloat16": 2e-2}
RTOL = {"float32": 0.0, "bfloat16": 2.0 ** -7}


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _attn_inputs(dtype, b=2, h=3, l=13, d=8, seed=0):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.normal(size=(b, h, l, d)).astype(np.float32) for _ in range(3))
    mask = np.ones((b, l), np.int32)
    mask[0, l // 2:] = 0
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    jx = [jnp.asarray(a, jd) for a in (q, k, v)] + [j_extend(jnp.asarray(mask))]
    tx = [torch.from_numpy(a).to(td) for a in (q, k, v)] + [
        t_extend(torch.from_numpy(mask))]
    return jx, tx


# Key lengths: 13 and 11 (below one 64-key tile of the card's kernels), 21,
# and 257 and 300, past 256: where the bf16 kernel's softmax runs online
# over several key tiles, the plain versions it is held against on the card
# are held here to the Pallas kernels and the XLA compositions.
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("pallas_fn", ["fused_attention", "fused_attention_batched",
                                       "fused_attention_dotbatch"])
@pytest.mark.parametrize("l", [13, 21, 257, 300])
def test_attention_plain_vs_pallas(dtype, pallas_fn, l):
    jx, tx = _attn_inputs(dtype, l=l)
    ref = getattr(pa, pallas_fn)(*jx, interpret=True)
    out = ca.fused_attention(*tx)          # CPU tensors: the plain version
    assert out.dtype == tx[0].dtype and out.shape == tx[0].shape
    np.testing.assert_allclose(_np(out), _np(ref), atol=ATOL[dtype],
                               rtol=RTOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attention_plain_vs_xla(dtype):
    jx, tx = _attn_inputs(dtype, l=21, seed=1)
    np.testing.assert_allclose(_np(ca.attention_plain(*tx)),
                               _np(attend_xla(*jx)), atol=ATOL[dtype],
                               rtol=RTOL[dtype])


def _mlp_inputs(dtype, with_mask, rows=(2, 9), h=32, i=64, seed=0):
    rng = np.random.default_rng(seed)
    a = dict(gamma=1 + 0.1 * rng.normal(size=h), beta=0.1 * rng.normal(size=h),
             w1=0.2 * rng.normal(size=(h, i)), b1=0.1 * rng.normal(size=i),
             w2=0.2 * rng.normal(size=(i, h)), b2=0.1 * rng.normal(size=h),
             x=rng.normal(size=(*rows, h)))
    if with_mask:
        a["m"] = np.where(rng.random((*rows, h)) < 0.9, 1 / 0.9, 0.0)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    j = {k: jnp.asarray(v.astype(np.float32), jd) for k, v in a.items()}
    t = {k: torch.from_numpy(v.astype(np.float32)).to(td) for k, v in a.items()}
    return j, t


def _plain_args(t):
    return ({"scale": t["gamma"], "bias": t["beta"]}, {"w": t["w1"], "b": t["b1"]},
            {"w": t["w2"], "b": t["b2"]})


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("with_mask", [False, True])
@pytest.mark.parametrize("postln", [False, True])
def test_mlp_plain_vs_pallas(dtype, with_mask, postln):
    j, t = _mlp_inputs(dtype, with_mask)
    pallas = pm.fused_mlp_postln_fwd if postln else pm.fused_mlp_block_fwd
    plain = cm._mlp_postln_plain if postln else cm._mlp_block_plain
    ref = pallas(j["gamma"], j["beta"], j["w1"], j["b1"], j["w2"], j["b2"],
                 j["x"], j.get("m"), eps=1e-12, interpret=True)
    out = plain(*_plain_args(t), t["x"], 1e-12, "gelu", t.get("m"))
    assert out.dtype == t["x"].dtype and out.shape == t["x"].shape
    np.testing.assert_allclose(_np(out), _np(ref), atol=ATOL[dtype],
                               rtol=RTOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("with_mask", [False, True])
@pytest.mark.parametrize("postln", [False, True])
def test_mlp_plain_vs_xla(dtype, with_mask, postln):
    j, t = _mlp_inputs(dtype, with_mask, seed=1)
    xla = pm._mlp_postln_xla if postln else pm._mlp_block_xla
    ref = xla({"scale": j["gamma"], "bias": j["beta"]}, {"w": j["w1"], "b": j["b1"]},
              {"w": j["w2"], "b": j["b2"]}, j["x"], 1e-12, "gelu", j.get("m"))
    # the dispatchers take the plain versions for CPU tensors
    if postln:
        out = cm.fused_mlp_postln_block(*_plain_args(t), t["x"], 1e-12, "gelu",
                                        t.get("m"))
    else:
        out = cm.fused_mlp_block(*_plain_args(t), t["x"], 1e-12, "gelu", t.get("m"))
    tol = 1e-5 if dtype == "float32" else ATOL[dtype]
    np.testing.assert_allclose(_np(out), _np(ref), atol=tol, rtol=RTOL[dtype])


def test_kernel_wrappers_never_fall_back():
    """A tensor that is not on the CPU reaches the kernel or raises: the
    kernel wrappers refuse CPU tensors, and a meta tensor is refused before
    anything is built or counted."""
    _, t = _mlp_inputs("float32", False, rows=(4,), h=768, i=256)
    counts = (cm.fused_mlp_block_fwd.launches, cm.fused_mlp_postln_fwd.launches,
              ca.fused_attention.launches)
    for fn in (cm.fused_mlp_block_fwd, cm.fused_mlp_postln_fwd):
        with pytest.raises(ValueError, match="CUDA"):
            fn(t["gamma"], t["beta"], t["w1"], t["b1"], t["w2"], t["b2"], t["x"])
    q = torch.empty((1, 2, 5, 64), device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        ca.fused_attention(q, q, q, torch.empty((1, 1, 1, 5), device="meta"))
    assert counts == (cm.fused_mlp_block_fwd.launches,
                      cm.fused_mlp_postln_fwd.launches, ca.fused_attention.launches)


def test_postln_dispatch_draws_mask_in_x_dtype():
    from vault_tpu_torch.config import tiny_text_config

    cfg = tiny_text_config()
    _, t = _mlp_inputs("bfloat16", False)
    lp = {"mlp_ln": {"scale": t["gamma"], "bias": t["beta"]},
          "mlp_in": {"w": t["w1"], "b": t["b1"]}, "mlp_out": {"w": t["w2"], "b": t["b2"]}}
    det = cm.fused_postln_mlp(lp, cfg, t["x"], None, deterministic=True)
    np.testing.assert_array_equal(
        _np(det), _np(cm._mlp_postln_plain(*_plain_args(t), t["x"], 1e-12, "gelu")))
    g1, g2 = torch.Generator().manual_seed(7), torch.Generator().manual_seed(7)
    tr1 = cm.fused_postln_mlp(lp, cfg, t["x"], g1, deterministic=False)
    tr2 = cm.fused_postln_mlp(lp, cfg, t["x"], g2, deterministic=False)
    assert tr1.dtype == torch.bfloat16 and torch.equal(tr1, tr2)
    assert not torch.equal(tr1, det)


# ---------------------------------------------------------------------------
# Backward: the plain versions against the Pallas backward kernels
# (interpret mode) and against jax.vjp of the XLA compositions.  fp32
# tolerances are the JAX package's own test's (atol 3e-5, rtol 2e-4: the
# Pallas kernels use the A&S erf and another summation order).  bf16 compares
# in fp32 after the cast, per output, at 2^-6 * max(1, max|reference|) (two
# bf16 ulps at the output's scale): the outputs are sums of products of
# bf16-rounded activations (dh1, a, y, ds) that the two sides round at
# different points, and where such a sum cancels, the difference of an ulp
# in its terms stays at the scale of the terms, not of the result.
# ---------------------------------------------------------------------------

BWD_ATOL = {"float32": 3e-5, "bfloat16": 2.0 ** -6}
BWD_RTOL = {"float32": 2e-4, "bfloat16": 0.0}
BWD_NAMES = ("dgamma", "dbeta", "dw1", "db1", "dw2", "db2", "dx")


def _bwd_inputs(dtype, with_mask, seed):
    j, t = _mlp_inputs(dtype, with_mask, rows=(2, 12), seed=seed)
    g = np.random.default_rng(seed + 100).normal(size=(2, 12, 32)).astype(np.float32)
    j["g"] = jnp.asarray(g, getattr(jnp, dtype))
    t["g"] = torch.from_numpy(g).to(getattr(torch, dtype))
    return j, t


_ORDER = ("gamma", "beta", "w1", "b1", "w2", "b2", "x", "g")


def _assert_grads(out, ref, dtype):
    assert len(out) == 7
    for name, o, r in zip(BWD_NAMES, out, ref):
        r = _np(r)
        scale = max(1.0, float(np.abs(r).max())) if dtype == "bfloat16" else 1.0
        np.testing.assert_allclose(_np(o), r, atol=BWD_ATOL[dtype] * scale,
                                   rtol=BWD_RTOL[dtype], err_msg=name)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("with_mask", [False, True])
@pytest.mark.parametrize("postln", [False, True])
def test_mlp_bwd_plain_vs_pallas(dtype, with_mask, postln):
    j, t = _bwd_inputs(dtype, with_mask, seed=3)
    pallas = pm.fused_mlp_postln_block_bwd if postln else pm.fused_mlp_block_bwd
    plain = cm.mlp_postln_bwd_plain if postln else cm.mlp_block_bwd_plain
    ref = pallas(*(j[k] for k in _ORDER), j.get("m"), eps=1e-12, interpret=True,
                 row_tile=8)
    out = plain(*(t[k] for k in _ORDER), t.get("m"), eps=1e-12)
    for o, name in zip(out, BWD_NAMES):
        want = t["x"] if name == "dx" else t[name[1:]]
        assert o.shape == want.shape and o.dtype == want.dtype, name
    _assert_grads(out, ref, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("with_mask", [False, True])
@pytest.mark.parametrize("postln", [False, True])
def test_mlp_bwd_plain_vs_xla_vjp(dtype, with_mask, postln):
    import jax

    j, t = _bwd_inputs(dtype, with_mask, seed=4)
    xla = pm._mlp_postln_xla if postln else pm._mlp_block_xla
    m = j.get("m")

    def f(gamma, beta, w1, b1, w2, b2, x):
        return xla({"scale": gamma, "bias": beta}, {"w": w1, "b": b1},
                   {"w": w2, "b": b2}, x, 1e-12, "gelu", m)

    _, vjp = jax.vjp(f, *(j[k] for k in _ORDER[:-1]))
    ref = vjp(j["g"])
    plain = cm.mlp_postln_bwd_plain if postln else cm.mlp_block_bwd_plain
    _assert_grads(plain(*(t[k] for k in _ORDER), t.get("m"), eps=1e-12), ref,
                  dtype)


@pytest.mark.parametrize("h,i", [(32, 64), (64, 128)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("with_mask", [False, True])
def test_mlp_postln_plain_at_a_second_width(dtype, with_mask, h, i):
    """The post-LN block's plain forward and backward at two widths (the
    kernels on the card take any H a multiple of 64 and I a multiple of
    64): the forward against _mlp_postln_xla, the backward against the JAX
    package's fused_mlp_postln_block_bwd in interpret mode."""
    j, t = _mlp_inputs(dtype, with_mask, rows=(2, 12), h=h, i=i, seed=5)
    ref = pm._mlp_postln_xla({"scale": j["gamma"], "bias": j["beta"]},
                             {"w": j["w1"], "b": j["b1"]}, {"w": j["w2"], "b": j["b2"]},
                             j["x"], 1e-12, "gelu", j.get("m"))
    out = cm._mlp_postln_plain(*_plain_args(t), t["x"], 1e-12, "gelu", t.get("m"))
    tol = 1e-5 if dtype == "float32" else ATOL[dtype]
    np.testing.assert_allclose(_np(out), _np(ref), atol=tol, rtol=RTOL[dtype])
    g = np.random.default_rng(105).normal(size=(2, 12, h)).astype(np.float32)
    j["g"], t["g"] = jnp.asarray(g, getattr(jnp, dtype)), torch.from_numpy(g).to(
        getattr(torch, dtype))
    ref = pm.fused_mlp_postln_block_bwd(*(j[k] for k in _ORDER), j.get("m"), eps=1e-12,
                                        interpret=True, row_tile=8)
    _assert_grads(cm.mlp_postln_bwd_plain(*(t[k] for k in _ORDER), t.get("m"), eps=1e-12),
                  ref, dtype)


@pytest.mark.parametrize("postln", [False, True])
def test_mlp_bwd_plain_vs_autograd_of_plain_forward(postln):
    """The second reference: autograd through the plain forward
    composition, fp32 (summation order only: atol 1e-5)."""
    _, t = _bwd_inputs("float32", True, seed=5)
    fwd = cm._mlp_postln_plain if postln else cm._mlp_block_plain
    leaves = [t[k].clone().requires_grad_() for k in _ORDER[:-1]]
    out = fwd({"scale": leaves[0], "bias": leaves[1]}, {"w": leaves[2], "b": leaves[3]},
              {"w": leaves[4], "b": leaves[5]}, leaves[6], 1e-12, "gelu", t["m"])
    ref = torch.autograd.grad(out, leaves, t["g"])
    plain = cm.mlp_postln_bwd_plain if postln else cm.mlp_block_bwd_plain
    for name, o, r in zip(BWD_NAMES, plain(*(t[k] for k in _ORDER), t["m"]), ref):
        np.testing.assert_allclose(_np(o), _np(r), atol=1e-5, err_msg=name)


@pytest.mark.parametrize("postln", [False, True])
@pytest.mark.parametrize("act", ["gelu", "relu"])
def test_fused_mlp_function_gradcheck(postln, act):
    """The autograd Function (plain forward and backward on the CPU) in
    float64: torch.autograd.gradcheck against finite differences; the mask
    is a constant of the draw and receives no gradient."""
    rng = np.random.default_rng(6)
    h, i, rows = 8, 16, 5

    def t(*shape, std=1.0, mean=0.0):
        return torch.tensor(rng.normal(size=shape) * std + mean,
                            dtype=torch.float64, requires_grad=True)

    args = [t(h, std=0.2, mean=1.0), t(h, std=0.1), t(h, i, std=0.3), t(i, std=0.1),
            t(i, h, std=0.3), t(h, std=0.1), t(rows, h)]
    m = torch.tensor(np.where(rng.random((rows, h)) < 0.8, 1.25, 0.0),
                     requires_grad=True)
    block = cm.fused_mlp_postln_block if postln else cm.fused_mlp_block

    def f(gamma, beta, w1, b1, w2, b2, x):
        return block({"scale": gamma, "bias": beta}, {"w": w1, "b": b1},
                     {"w": w2, "b": b2}, x, 1e-12, act, m)

    assert torch.autograd.gradcheck(f, args, eps=1e-6, atol=1e-6)
    f(*args).sum().backward()
    assert m.grad is None
    assert all(a.grad is not None for a in args)


def test_fused_mlp_function_grads_keep_input_dtypes():
    _, t = _bwd_inputs("bfloat16", True, seed=7)
    leaves = [t[k].clone().requires_grad_() for k in _ORDER[:-1]]
    out = cm.fused_mlp_block({"scale": leaves[0], "bias": leaves[1]},
                             {"w": leaves[2], "b": leaves[3]},
                             {"w": leaves[4], "b": leaves[5]}, leaves[6],
                             1e-12, "gelu", t["m"])
    assert out.dtype == torch.bfloat16
    out.backward(t["g"])
    assert all(l.grad.dtype == torch.bfloat16 and l.grad.shape == l.shape
               for l in leaves)


def test_attention_function_grads_match_plain_autograd():
    """fused_attention's Function recomputes through the plain composition:
    its gradients equal autograd of attention_plain; the bias gets none."""
    _, tx = _attn_inputs("float32", seed=2)
    q, k, v = (a.clone().requires_grad_() for a in tx[:3])
    bias = tx[3].clone().requires_grad_()
    g = torch.randn(q.shape, generator=torch.Generator().manual_seed(0))
    ca.fused_attention(q, k, v, bias).backward(g)
    leaves = [a.clone().requires_grad_() for a in tx[:3]]
    ref = torch.autograd.grad(ca.attention_plain(*leaves, tx[3]), leaves, g)
    for a, r in zip((q, k, v), ref):
        torch.testing.assert_close(a.grad, r, atol=1e-6, rtol=0)
    assert bias.grad is None


def test_backward_wrappers_never_fall_back():
    """The backward kernel wrappers take CUDA tensors only: CPU tensors
    raise before anything is built or counted."""
    _, t = _mlp_inputs("float32", False, rows=(4,), h=768, i=256)
    counts = (cm.fused_mlp_block_bwd.launches, cm.fused_mlp_postln_block_bwd.launches)
    for fn in (cm.fused_mlp_block_bwd, cm.fused_mlp_postln_block_bwd):
        with pytest.raises(ValueError, match="CUDA"):
            fn(t["gamma"], t["beta"], t["w1"], t["b1"], t["w2"], t["b2"], t["x"],
               t["x"])
    assert counts == (cm.fused_mlp_block_bwd.launches,
                      cm.fused_mlp_postln_block_bwd.launches)


# ---------------------------------------------------------------------------
# LN -> QKV and the w8a8 MLP blocks: the plain versions of csrc/ln_qkv.cu and
# csrc/mlp_w8a8.cu against the Pallas kernels (interpret mode) and the XLA
# compositions with w_q8 parameters.  fp32: the JAX package's own budgets
# (test_quantize.py: atol 2e-5 LN->QKV, 3e-5 pre-LN, 5e-5 post-LN, rtol
# 1e-4; the int8 sums are exact, so what differs is the erf (A&S in Pallas)
# and the fp32 LN statistics).  bf16: the bf16 budget of ATOL/RTOL above.
# ---------------------------------------------------------------------------

from vault_tpu.ops import quantize as jq
from vault_tpu_torch.ops import cuda_ln_qkv as cl
from vault_tpu_torch.ops import quantize as tq

W8A8_ATOL = {"ln_qkv": 2e-5, "preln": 3e-5, "postln": 5e-5}


def _q_inputs(dtype, h=128, inner=256, rows=(2, 24), seed=21):
    """test_quantize.py's operands: fp weights quantized on both sides
    (equal codes and scales, tests/test_torch_quantize.py)."""
    rng = np.random.default_rng(seed)
    a = dict(x=rng.normal(size=(*rows, h)), gamma=rng.normal(size=h) * 0.1 + 1,
             beta=rng.normal(size=h) * 0.1, w1=rng.normal(size=(h, inner)) * 0.05,
             b1=rng.normal(size=inner) * 0.02, w2=rng.normal(size=(inner, h)) * 0.05,
             b2=rng.normal(size=h) * 0.02,
             wqkv=rng.normal(size=(h, 3 * h)) * 0.05, bqkv=rng.normal(size=3 * h) * 0.02)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    j = {k: jnp.asarray(v.astype(np.float32), jd) for k, v in a.items()}
    t = {k: torch.from_numpy(v.astype(np.float32)).to(td) for k, v in a.items()}
    for side, quant, lib in ((j, jq, jnp), (t, tq, torch)):
        for name in ("w1", "w2", "wqkv"):
            side[name + "q"], side["s" + name[1:]] = quant.quantize_weight(side[name])
    return j, t


def _w8a8_params(s, postln=False):
    """The w8a8 MLP parameters; the port's codes K-major, as it holds the
    MLP's (ops/quantize.py)."""
    codes = lambda q: tq.k_major(q) if isinstance(q, torch.Tensor) else q
    return ({"scale": s["gamma"], "bias": s["beta"]},
            {"w_q8": codes(s["w1q"]), "w_scale": s["s1"], "b": s["b1"]},
            {"w_q8": codes(s["w2q"]), "w_scale": s["s2"], "b": s["b2"]})


def _close(out, ref, dtype, atol):
    if dtype == "bfloat16":
        atol = ATOL[dtype]
    np.testing.assert_allclose(_np(out), _np(ref), atol=atol, rtol=RTOL[dtype]
                               if dtype == "bfloat16" else 1e-4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ln_qkv_plain_vs_pallas_and_xla(dtype):
    j, t = _q_inputs(dtype)
    args = ("gamma", "beta", "wqkv", "bqkv", "x")
    ref = pm.fused_ln_qkv_fwd(*(j[k] for k in args), eps=1e-12, interpret=True)
    xla = pm._ln_qkv_xla({"scale": j["gamma"], "bias": j["beta"]}, j["wqkv"],
                         j["bqkv"], j["x"], 1e-12)
    out = cl.ln_qkv_plain(*(t[k] for k in args))
    assert out.dtype == t["x"].dtype and out.shape == (2, 24, 384)
    _close(out, ref, dtype, W8A8_ATOL["ln_qkv"])
    _close(out, xla, dtype, 1e-5)


@pytest.mark.parametrize("h", [64, 128])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ln_qkv_plain_at_a_second_width(dtype, h):
    """The LN->QKV plain version at widths the bf16 kernel on the wgmma core
    newly takes (H a multiple of 64): against the Pallas kernel
    (interpret mode) and its XLA composition."""
    j, t = _q_inputs(dtype, h=h, inner=2 * h, rows=(2, 12), seed=22)
    args = ("gamma", "beta", "wqkv", "bqkv", "x")
    out = cl.ln_qkv_plain(*(t[k] for k in args))
    assert out.dtype == t["x"].dtype and out.shape == (2, 12, 3 * h)
    ref = pm.fused_ln_qkv_fwd(*(j[k] for k in args), eps=1e-12, interpret=True)
    xla = pm._ln_qkv_xla({"scale": j["gamma"], "bias": j["beta"]}, j["wqkv"],
                         j["bqkv"], j["x"], 1e-12)
    _close(out, ref, dtype, W8A8_ATOL["ln_qkv"])
    _close(out, xla, dtype, 1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ln_qkv_w8a8_plain_vs_pallas_and_xla(dtype):
    j, t = _q_inputs(dtype, seed=7)
    args = ("gamma", "beta", "wqkvq", "sqkv", "bqkv", "x")
    ref = pm.fused_ln_qkv_fwd_w8a8(*(j[k] for k in args), eps=1e-12, interpret=True)
    y = pm.layer_norm({"scale": j["gamma"], "bias": j["beta"]}, j["x"], 1e-12)
    xla = pm.linear({"w_q8": j["wqkvq"], "w_scale": j["sqkv"], "b": j["bqkv"]}, y)
    out = cl.ln_qkv_w8a8_plain(*(t[k] for k in args))
    assert out.dtype == t["x"].dtype and out.shape == (2, 24, 384)
    _close(out, ref, dtype, W8A8_ATOL["ln_qkv"])
    _close(out, xla, dtype, W8A8_ATOL["ln_qkv"])


@pytest.mark.parametrize("h", [256, 384])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ln_qkv_w8a8_plain_at_a_second_width(dtype, h):
    """The w8a8 LN->QKV plain version at widths the kernel on the int8 core
    newly takes (H a multiple of 128), on K-major codes as the kernel reads
    them: bit-equal to the same call on row-major codes, and against the
    Pallas kernel (interpret mode) and the XLA composition."""
    j, t = _q_inputs(dtype, h=h, inner=128, rows=(2, 12), seed=27)
    args = ("gamma", "beta", "wqkvq", "sqkv", "bqkv", "x")
    codes = dict(t, wqkvq=tq.k_major(t["wqkvq"]))
    assert tq.is_k_major(codes["wqkvq"]) and not tq.is_k_major(t["wqkvq"])
    out = cl.ln_qkv_w8a8_plain(*(codes[k] for k in args))
    assert out.dtype == t["x"].dtype and out.shape == (2, 12, 3 * h)
    assert torch.equal(out, cl.ln_qkv_w8a8_plain(*(t[k] for k in args)))
    ref = pm.fused_ln_qkv_fwd_w8a8(*(j[k] for k in args), eps=1e-12, interpret=True)
    y = pm.layer_norm({"scale": j["gamma"], "bias": j["beta"]}, j["x"], 1e-12)
    xla = pm.linear({"w_q8": j["wqkvq"], "w_scale": j["sqkv"], "b": j["bqkv"]}, y)
    _close(out, ref, dtype, W8A8_ATOL["ln_qkv"])
    _close(out, xla, dtype, W8A8_ATOL["ln_qkv"])


def test_w8a8_qkv_operand_is_held_k_major_and_kept():
    """The dispatch's concatenated w8a8 operand: (3H, H) contiguous storage
    seen as (H, 3H), equal to q/k/v's codes side by side; kept on the q
    module across two calls without autograd, built again after a source is
    written in place, and never kept with autograd on."""
    from vault_tpu_torch.ops.nn import ParamDict

    _, t = _q_inputs("float32", h=128, seed=28)
    h = 128
    cols = [slice(i * h, (i + 1) * h) for i in range(3)]
    mods = [ParamDict(w_q8=t["wqkvq"][:, c].contiguous(), w_scale=t["sqkv"][:, c],
                      b=t["bqkv"][c]) for c in cols]
    with torch.no_grad():
        wq, sq, bq = first = cl._w8a8_operands(mods, torch.float32)
        assert cl._w8a8_operands(mods, torch.float32) is first
    assert tq.is_k_major(wq) and wq.shape == (h, 3 * h) and wq.t().shape == (3 * h, h)
    assert torch.equal(wq, t["wqkvq"]) and torch.equal(sq, t["sqkv"].reshape(-1))
    assert torch.equal(bq, t["bqkv"])
    with torch.no_grad():
        mods[1].w_q8.neg_()
        again = cl._w8a8_operands(mods, torch.float32)
    assert again is not first and tq.is_k_major(again[0])
    assert torch.equal(again[0][:, h:2 * h], mods[1].w_q8)
    built = cl._w8a8_operands(mods, torch.float32)  # autograd on: a fresh copy
    assert built is not again and torch.equal(built[0], again[0])
    assert tq.is_k_major(built[0])


@pytest.mark.parametrize("act", ["gelu", "gelu_new", "relu"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("postln", [False, True])
def test_mlp_w8a8_plain_vs_pallas(dtype, postln, act):
    """Each activation the w8a8 kernels take, against the JAX package's
    kernel in interpret mode (its GELU through the A&S erf)."""
    j, t = _q_inputs(dtype)
    args = ("gamma", "beta", "w1q", "s1", "b1", "w2q", "s2", "b2", "x")
    pallas = pm.fused_mlp_postln_fwd_w8a8 if postln else pm.fused_mlp_block_fwd_w8a8
    plain = cm.mlp_postln_w8a8_plain if postln else cm.mlp_block_w8a8_plain
    ref = pallas(*(j[k] for k in args), eps=1e-12, act=act, interpret=True)
    out = plain(*(t[k] for k in args), act=act)
    assert out.dtype == t["x"].dtype and out.shape == t["x"].shape
    _close(out, ref, dtype, W8A8_ATOL["postln" if postln else "preln"])


def _w8a8_inside(t, postln, eps=1e-12):
    """The plain versions' steps up to the second product: h (its input,
    in x's type) and the post-LN block's LN input x + o2 in fp32."""
    x = t["x"]
    y = x if postln else cm.layer_norm_f32(t["gamma"], t["beta"], x, eps).to(x.dtype)
    h = cm._w8a8_linear_f32(*tq.quantize_activation(y), t["w1q"], t["s1"], t["b1"])
    h = cm._act_f32("gelu")(h).to(x.dtype)
    o2 = cm._w8a8_linear_f32(*tq.quantize_activation(h), t["w2q"], t["s2"], t["b2"])
    return h, x.float() + o2


def _code_step(t, postln):
    """Per row, the most that one code of q(h) one step off moves the
    output: h's scale times the largest |W2|; post-LN also times the LN's
    1 / std and the largest |gamma|."""
    h, s = _w8a8_inside(t, postln)
    w2 = (t["w2q"].float() * t["s2"].float().reshape(1, -1)).abs().max()
    step = h.float().abs().amax(-1) / 127 * w2
    if postln:
        step = step * torch.rsqrt(s.var(-1, unbiased=False) + 1e-12) * t["gamma"].float().abs().max()
    return _np(step).reshape(-1).astype(np.float64)


def _close_but_one_row(out, ref, dtype, atol, step):
    """:func:`_close`'s tolerance on every row but at most one, and that
    row past it by at most one code step (``_code_step``): a code of q(h)
    flips where the two sides' h lie either side of a rounding point."""
    out = _np(out).astype(np.float64).reshape(len(step), -1)
    ref = _np(ref).astype(np.float64).reshape(len(step), -1)
    atol, rtol = (ATOL[dtype], RTOL[dtype]) if dtype == "bfloat16" else (atol, 1e-4)
    over = (np.abs(out - ref) - atol - rtol * np.abs(ref)).max(-1)
    assert (over > 0).sum() <= 1 and (over <= step).all(), (over, step)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("postln", [False, True])
@pytest.mark.parametrize("h,i", [(256, 1024), (128, 384)])
def test_mlp_w8a8_plain_at_a_second_width(dtype, postln, h, i):
    """Both w8a8 plain versions at widths the kernels on the int8 core
    newly take (H and I multiples of 128), on K-major codes as the model
    holds them, against the Pallas kernel (interpret mode) and the XLA
    composition at the file's tolerances, with an allowance for flipped
    codes of q(h): at most one row past the tolerance, by at most one code
    step.  bf16 against XLA is held in two halves, each at the file's
    tolerance: h against the composition's activation, and the output
    against the composition's second half fed the plain version's h.  The
    composition rounds the first product to bf16 before the activation
    (nn.linear), so at I = 1,024 a tenth of h's codes differ by one step
    and several rows of the whole output lie past the tolerance."""
    j, t = _q_inputs(dtype, h=h, inner=i, rows=(2, 12))
    args = ("gamma", "beta", "w1q", "s1", "b1", "w2q", "s2", "b2", "x")
    plain = cm.mlp_postln_w8a8_plain if postln else cm.mlp_block_w8a8_plain
    pallas = pm.fused_mlp_postln_fwd_w8a8 if postln else pm.fused_mlp_block_fwd_w8a8
    xla = pm._mlp_postln_xla if postln else pm._mlp_block_xla
    codes = {k: tq.k_major(t[k]) if k in ("w1q", "w2q") else t[k] for k in args}
    out = plain(*(codes[k] for k in args))
    assert out.dtype == t["x"].dtype and out.shape == (2, 12, h)
    assert torch.equal(out, plain(*(t[k] for k in args)))  # either layout
    atol, step = W8A8_ATOL["postln" if postln else "preln"], _code_step(t, postln)
    ref = pallas(*(j[k] for k in args), eps=1e-12, interpret=True)
    _close_but_one_row(out, ref, dtype, atol, step)
    if dtype == "float32":
        _close_but_one_row(out, xla(*_w8a8_params(j), j["x"], 1e-12, "gelu"), dtype, atol, step)
        return
    ln_p, p_in, p_out = _w8a8_params(j)
    y = j["x"] if postln else pm.layer_norm(ln_p, j["x"], 1e-12)
    th, _ = _w8a8_inside(t, postln)
    _close(th, pm.act_fn("gelu")(pm.linear(p_in, y)), dtype, atol)
    mlp = pm.linear(p_out, jnp.asarray(_np(th), jnp.bfloat16))
    ref = pm.layer_norm(ln_p, j["x"] + mlp, 1e-12) if postln else j["x"] + mlp
    _close(out, ref, dtype, atol)


@pytest.mark.parametrize("act", ["gelu", "gelu_new", "relu"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("postln", [False, True])
def test_mlp_w8a8_dispatch_vs_jax(dtype, postln, act):
    """The dispatchers with w_q8 parameters (the plain versions on the CPU)
    against the JAX package's dispatchers (the Pallas kernels) and its XLA
    compositions, for each activation the kernels take."""
    j, t = _q_inputs(dtype, seed=22)
    jblock = pm.fused_mlp_postln_block if postln else pm.fused_mlp_block
    tblock = cm.fused_mlp_postln_block if postln else cm.fused_mlp_block
    xla = pm._mlp_postln_xla if postln else pm._mlp_block_xla
    out = tblock(*_w8a8_params(t), t["x"], 1e-12, act)
    atol = W8A8_ATOL["postln" if postln else "preln"]
    _close(out, jblock(*_w8a8_params(j), j["x"], 1e-12, act), dtype, atol)
    _close(out, xla(*_w8a8_params(j), j["x"], 1e-12, act), dtype, atol)


@pytest.mark.parametrize("postln", [False, True])
def test_mlp_w8a8_grads_match_jax(postln):
    """Gradients with respect to the float leaves (LN, scales, biases, x)
    through the w8a8 dispatch: autograd of the XLA composition, as the JAX
    package's vjp (test_quantize.py's budget, atol/rtol 1e-3)."""
    import jax

    j, t = _q_inputs("float32", seed=23)
    jblock = pm.fused_mlp_postln_block if postln else pm.fused_mlp_block
    tblock = cm.fused_mlp_postln_block if postln else cm.fused_mlp_block
    names = ("gamma", "beta", "s1", "b1", "s2", "b2", "x")

    def jloss(gamma, beta, s1, b1, s2, b2, x):
        p = dict(j, gamma=gamma, beta=beta, s1=s1, b1=b1, s2=s2, b2=b2)
        return jnp.sum(jblock(*_w8a8_params(p), x) ** 2)

    ref = jax.grad(jloss, argnums=tuple(range(7)))(*(j[k] for k in names))
    leaves = {k: t[k].clone().requires_grad_() for k in names}
    out = tblock(*_w8a8_params(dict(t, **leaves)), leaves["x"])
    (out ** 2).sum().backward()
    for k, r in zip(names, ref):
        np.testing.assert_allclose(_np(leaves[k].grad).reshape(np.shape(r)), _np(r),
                                   atol=1e-3, rtol=1e-3, err_msg=k)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_ln_qkv_dispatch_vs_jax(dtype):
    """fused_ln_qkv with fp, w8a8 and w8 q/k/v, one without biases, against
    the JAX package's dispatcher."""
    j, t = _q_inputs(dtype, seed=24)
    h = 128
    for mode in (None, "w8a8", "w8"):
        ps = {}
        for side, quant in ((j, jq), (t, tq)):
            lin = [{"w": side["wqkv"][:, i * h:(i + 1) * h], "b": side["bqkv"][i * h:(i + 1) * h]}
                   for i in range(3)]
            del lin[1]["b"]
            ps[id(side)] = [quant.quantize_linear_params(p, mode) if mode else p
                            for p in lin]
        ref = pm.fused_ln_qkv({"scale": j["gamma"], "bias": j["beta"]}, *ps[id(j)],
                              j["x"], 1e-12)
        out = cl.fused_ln_qkv({"scale": t["gamma"], "bias": t["beta"]}, *ps[id(t)],
                              t["x"], 1e-12)
        assert out.shape == (2, 24, 3 * h)
        _close(out, ref, dtype, W8A8_ATOL["ln_qkv"])


def test_fused_ln_qkv_grads_match_jax():
    """The fp LN->QKV Function's gradient is autograd of the plain
    composition, as the JAX package's _fused_ln_qkv_bwd (fp32, atol 1e-5)."""
    import jax

    j, t = _q_inputs("float32", seed=25)
    h = 128
    names = ("gamma", "beta", "wqkv", "bqkv", "x")

    def split(s):
        return [{"w": s["wqkv"][:, i * h:(i + 1) * h], "b": s["bqkv"][i * h:(i + 1) * h]}
                for i in range(3)]

    def jloss(*vals):
        p = dict(zip(names, vals))
        return jnp.sum(pm.fused_ln_qkv({"scale": p["gamma"], "bias": p["beta"]},
                                       *split(p), p["x"]) ** 2)

    ref = jax.grad(jloss, argnums=tuple(range(5)))(*(j[k] for k in names))
    leaves = {k: t[k].clone().requires_grad_() for k in names}
    out = cl.fused_ln_qkv({"scale": leaves["gamma"], "bias": leaves["beta"]},
                          *split(leaves), leaves["x"])
    (out ** 2).sum().backward()
    for k, r in zip(names, ref):
        np.testing.assert_allclose(_np(leaves[k].grad), _np(r), atol=1e-5,
                                   rtol=1e-5, err_msg=k)


def test_quantized_blocks_dispatch_like_jax():
    """A w8a8 block with a dropout mask takes the plain composition, as the
    JAX package falls back to XLA; a w8 block goes through its dispatch (on
    the CPU the q8 kernels' plain versions) and matches the JAX package's."""
    j, t = _q_inputs("float32", seed=26)
    m = torch.from_numpy(np.where(np.random.default_rng(0).random((2, 24, 128)) < 0.9,
                                  1 / 0.9, 0.0).astype(np.float32))
    p = _w8a8_params(t)
    np.testing.assert_array_equal(
        _np(cm.fused_mlp_block(*p, t["x"], 1e-12, "gelu", m)),
        _np(cm._mlp_block_plain(*p, t["x"], 1e-12, "gelu", m)))
    w8 = [{"w_q": t[k + "q"], "w_scale": t["s" + k[1:]], "b": t["b" + k[1:]]}
          for k in ("w1", "w2")]
    for postln, jblock in ((False, pm.fused_mlp_block), (True, pm.fused_mlp_postln_block)):
        block = cm.fused_mlp_postln_block if postln else cm.fused_mlp_block
        jw8 = [{"w_q": j[k + "q"], "w_scale": j["s" + k[1:]], "b": j["b" + k[1:]]}
               for k in ("w1", "w2")]
        out = block(p[0], *w8, t["x"], 1e-12, "gelu")
        ref = jblock({"scale": j["gamma"], "bias": j["beta"]}, *jw8, j["x"], 1e-12, "gelu")
        np.testing.assert_allclose(_np(out), _np(ref), atol=3e-5, rtol=1e-4)


def test_int8_kernel_wrappers_never_fall_back():
    """The LN->QKV and w8a8 kernel wrappers refuse CPU tensors before
    anything is built or counted."""
    _, t = _q_inputs("float32", h=768, inner=256, rows=(4,))
    counts = lambda: (cl.fused_ln_qkv_fwd.launches, cl.fused_ln_qkv_fwd_w8a8.launches,
                      cm.fused_mlp_block_fwd_w8a8.launches,
                      cm.fused_mlp_postln_fwd_w8a8.launches)
    before = counts()
    with pytest.raises(ValueError, match="CUDA"):
        cl.fused_ln_qkv_fwd(t["gamma"], t["beta"], t["wqkv"], t["bqkv"], t["x"])
    with pytest.raises(ValueError, match="CUDA"):
        cl.fused_ln_qkv_fwd_w8a8(t["gamma"], t["beta"], tq.k_major(t["wqkvq"]), t["sqkv"],
                                 t["bqkv"], t["x"])
    codes = {k: tq.k_major(t[k]) if k in ("w1q", "w2q") else t[k] for k in t}
    for fn in (cm.fused_mlp_block_fwd_w8a8, cm.fused_mlp_postln_fwd_w8a8):
        with pytest.raises(ValueError, match="CUDA"):
            fn(*(codes[k] for k in ("gamma", "beta", "w1q", "s1", "b1", "w2q", "s2",
                                    "b2", "x")))
    assert counts() == before


# ---------------------------------------------------------------------------
# The w8 (int8 weight-only) MLP blocks, the GQA attention and the w8a8
# SwiGLU block.  Tolerances: q8 and GQA fp32 atol 5e-5 + rtol 1e-4, bf16
# atol 2e-2 + rtol 2^-7 (as above); SwiGLU against swiglu_block_xla_grouped
# fp32 atol 2e-5 (the JAX test's own), bf16 atol 2e-2 + rtol 2^-7.
# ---------------------------------------------------------------------------

from vault_tpu.models import llama as jllama
from vault_tpu.ops import pallas_swiglu as ps
from vault_tpu_torch.ops import cuda_swiglu as cs

Q8_ARGS = ("gamma", "beta", "w1q", "s1", "b1", "w2q", "s2", "b2", "x")


def _w8_params(s):
    return ({"scale": s["gamma"], "bias": s["beta"]},
            {"w_q": s["w1q"], "w_scale": s["s1"], "b": s["b1"]},
            {"w_q": s["w2q"], "w_scale": s["s2"], "b": s["b2"]})


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("postln", [False, True])
def test_mlp_q8_plain_vs_pallas_and_xla(dtype, postln):
    j, t = _q_inputs(dtype, seed=31)
    pallas = pm.fused_mlp_postln_fwd_q8 if postln else pm.fused_mlp_block_fwd_q8
    xla = pm._mlp_postln_xla if postln else pm._mlp_block_xla
    plain = cm.mlp_postln_q8_plain if postln else cm.mlp_block_q8_plain
    out = plain(*(t[k] for k in Q8_ARGS))
    assert out.dtype == t["x"].dtype and out.shape == t["x"].shape
    _close(out, pallas(*(j[k] for k in Q8_ARGS), eps=1e-12, interpret=True), dtype, 5e-5)
    _close(out, xla(*_w8_params(j), j["x"], 1e-12, "gelu"), dtype, 5e-5)


@pytest.mark.parametrize("act", ["gelu", "relu"])
@pytest.mark.parametrize("h,i", [(64, 128), (128, 256)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mlp_q8_plain_at_a_second_width(dtype, h, i, act):
    """The pre-LN q8 block's plain version at widths the kernel on the
    wgmma core newly takes (H a multiple of 64, I a multiple of 64): against
    the Pallas kernel (interpret mode) and its XLA composition."""
    j, t = _q_inputs(dtype, h=h, inner=i, rows=(2, 12), seed=34)
    out = cm.mlp_block_q8_plain(*(t[k] for k in Q8_ARGS), act=act)
    assert out.dtype == t["x"].dtype and out.shape == (2, 12, h)
    ref = pm.fused_mlp_block_fwd_q8(*(j[k] for k in Q8_ARGS), eps=1e-12, act=act,
                                    interpret=True)
    _close(out, ref, dtype, 5e-5)
    _close(out, pm._mlp_block_xla(*_w8_params(j), j["x"], 1e-12, act), dtype, 5e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("postln", [False, True])
def test_mlp_q8_dispatch_vs_jax(dtype, postln):
    """The dispatchers with w_q parameters against the JAX package's (its
    q8 Pallas kernels, interpreted)."""
    j, t = _q_inputs(dtype, seed=32)
    jblock = pm.fused_mlp_postln_block if postln else pm.fused_mlp_block
    tblock = cm.fused_mlp_postln_block if postln else cm.fused_mlp_block
    out = tblock(*_w8_params(t), t["x"], 1e-12, "gelu")
    _close(out, jblock(*_w8_params(j), j["x"], 1e-12, "gelu"), dtype, 5e-5)


@pytest.mark.parametrize("postln", [False, True])
def test_mlp_q8_grads_match_jax(postln):
    """Gradients through the q8 dispatch: to the LN, both scales, both
    biases and x, none to the codes, as the JAX package's vjp."""
    import jax

    j, t = _q_inputs("float32", seed=33)
    jblock = pm.fused_mlp_postln_block if postln else pm.fused_mlp_block
    tblock = cm.fused_mlp_postln_block if postln else cm.fused_mlp_block
    names = ("gamma", "beta", "s1", "b1", "s2", "b2", "x")

    def jloss(gamma, beta, s1, b1, s2, b2, x):
        p = dict(j, gamma=gamma, beta=beta, s1=s1, b1=b1, s2=s2, b2=b2)
        return jnp.sum(jblock(*_w8_params(p), x) ** 2)

    ref = jax.grad(jloss, argnums=tuple(range(7)))(*(j[k] for k in names))
    leaves = {k: t[k].clone().requires_grad_() for k in names}
    out = tblock(*_w8_params(dict(t, **leaves)), leaves["x"])
    (out ** 2).sum().backward()
    assert t["w1q"].grad is None and t["w2q"].grad is None
    for k, r in zip(names, ref):
        np.testing.assert_allclose(_np(leaves[k].grad).reshape(np.shape(r)), _np(r),
                                   atol=1e-3, rtol=1e-3, err_msg=k)


def _gqa_inputs(dtype, rep, padded, b=3, g=2, l=11, d=8, seed=41):
    """q (B, G rep, L, D), k/v (B, G, L, D) and the tower's (B, 1, L, L)
    causal and padding bias; with ``padded`` row 1 is padded on the right
    and row 2 on the left (its first queries see no key)."""
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, g * rep, l, d)).astype(np.float32)
    k, v = (rng.normal(size=(b, g, l, d)).astype(np.float32) for _ in range(2))
    pad = np.ones((b, l), np.float32)
    if padded:
        pad[1, 7:] = 0
        pad[2, :4] = 0
    keep = np.tril(np.ones((l, l), np.float32))[None, None] * pad[:, None, None, :]
    bias = (1.0 - keep) * np.finfo(np.float32).min
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    return ([jnp.asarray(a, jd) for a in (q, k, v)] + [jnp.asarray(bias)],
            [torch.from_numpy(a).to(td) for a in (q, k, v)] + [torch.from_numpy(bias)])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rep", [1, 2, 4])
@pytest.mark.parametrize("padded", [False, True])
@pytest.mark.parametrize("l", [11, 21, 257, 300])
def test_attention_gqa_plain_vs_pallas_and_xla(dtype, rep, padded, l):
    jx, tx = _gqa_inputs(dtype, rep, padded, l=l)
    out = ca.fused_attention_gqa(*tx)       # CPU tensors: the plain version
    assert out.dtype == tx[0].dtype and out.shape == tx[0].shape
    assert torch.isfinite(out.float()).all()
    _close(out, pa.fused_attention_gqa(*jx, interpret=True), dtype, 5e-5)
    _close(out, jllama._gqa_attend(*jx, rep), dtype, 5e-5)


@pytest.mark.parametrize("gqa", [False, True])
@pytest.mark.parametrize("l", [40, 77, 257])
def test_attention_row_limit_passes_bf16_p_and_catches_fp8_p(gqa, l):
    """chip_smoke.py's per-row bf16 attention gate, on the case functions it
    runs on the card (here on the CPU, head dim 64): the attention with its
    unnormalised probabilities cast to bf16 before P V (the one-pass
    kernel's rounding over several key tiles) stays within
    ATTENTION_ROW_LIMIT of the plain version; cast to fp8 (the control that
    every bf16 row on the card reads), it exceeds it."""
    import chip_smoke

    gen = torch.Generator().manual_seed(l)
    cpu, bf = torch.device("cpu"), torch.bfloat16
    if gqa:
        ops = chip_smoke.gqa_case(gen, 3, 8, 2, l, 64, bf, cpu)
        ref = ca.fused_attention_gqa(*ops)
    else:
        ops = chip_smoke.attention_case(gen, 3, 4, l, bf, cpu, fused=True, masked_row=True)
        ref = ca.fused_attention(*ops)
    limit = chip_smoke.ATTENTION_ROW_LIMIT
    sound = chip_smoke.attention_row_err(chip_smoke.attention_p_cast(*ops, bf), ref)
    control = chip_smoke.attention_row_err(
        chip_smoke.attention_p_cast(*ops, torch.float8_e4m3fn), ref)
    assert sound <= limit / 2 and control > limit, (sound, control)


def test_attention_gqa_function_grads_match_plain_autograd():
    _, tx = _gqa_inputs("float32", 2, True)
    leaves = [t.clone().requires_grad_() for t in tx[:3]]
    ca.fused_attention_gqa(*leaves, tx[3]).square().sum().backward()
    ref = [t.clone().requires_grad_() for t in tx[:3]]
    ca.attention_gqa_plain(*ref, tx[3]).square().sum().backward()
    for a, b in zip(leaves, ref):
        np.testing.assert_allclose(_np(a.grad), _np(b.grad), atol=1e-6)


def _swiglu_inputs(dtype, rows=8, h=64, i=64, seed=51):
    """tests/test_pallas_swiglu.py's operands, quantized on both sides; the
    port's codes K-major, as it holds the Llama MLP's (ops/quantize.py)."""
    rng = np.random.default_rng(seed)
    w = {n: (rng.normal(size=shape) * 0.05).astype(np.float32)
         for n, shape in (("g", (h, i)), ("u", (h, i)), ("d", (i, h)))}
    ln = (1.0 + 0.1 * rng.normal(size=h)).astype(np.float32)
    x = (rng.normal(size=(rows, h)) * 0.5).astype(np.float32)
    j = {"ln": jnp.asarray(ln), "x": jnp.asarray(x, getattr(jnp, dtype))}
    t = {"ln": torch.from_numpy(ln), "x": torch.from_numpy(x).to(getattr(torch, dtype))}
    for side, quant, conv in ((j, jq, jnp.asarray), (t, tq, torch.from_numpy)):
        for n, a in w.items():
            side["w" + n + "q"], side["s" + n] = quant.quantize_weight(conv(a))
    for n in w:
        t["w" + n + "q"] = tq.k_major(t["w" + n + "q"])
    return j, t


SWIGLU_ARGS = ("ln", "wgq", "sg", "wuq", "su", "wdq", "sd", "x")


def _swiglu_params(s, key="w_q8"):
    return (s["ln"], *({key: s["w" + n + "q"], "w_scale": s["s" + n]} for n in "gud"))


def _swiglu_close(out, ref, dtype):
    np.testing.assert_allclose(_np(out), _np(ref), atol=2e-5 if dtype == "float32" else 2e-2,
                               rtol=RTOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("i_tile", [16, 32, 48, 64])
def test_swiglu_w8a8_plain_vs_grouped_xla_and_pallas(dtype, i_tile):
    """48 does not divide I = 64: both sides then tile at 32 (the largest
    divisor below it); 64 is the single-tile case."""
    j, t = _swiglu_inputs(dtype)
    out = cs.swiglu_block_w8a8_plain(*(t[k] for k in SWIGLU_ARGS), eps=1e-5, i_tile=i_tile)
    assert out.dtype == t["x"].dtype and out.shape == t["x"].shape
    jargs = [j[k] for k in SWIGLU_ARGS]
    _swiglu_close(out, ps.swiglu_block_xla_grouped(*jargs, eps=1e-5, i_tile=i_tile), dtype)
    _swiglu_close(out, ps.fused_swiglu_block_fwd_w8a8(*jargs, eps=1e-5, interpret=True,
                                                      row_tile=4, i_tile=i_tile), dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("i_tile", [256, 1024])
def test_swiglu_w8a8_plain_at_a_second_width(dtype, i_tile):
    """H 256, I 768, the kernel's widths (H a multiple of 128; its I-tile
    pick_tile(768, 1024) = 768, a multiple of 128): one tile of 768, or
    three of 256, against both of the JAX package's functions."""
    j, t = _swiglu_inputs(dtype, h=256, i=768, seed=54)
    out = cs.swiglu_block_w8a8_plain(*(t[k] for k in SWIGLU_ARGS), eps=1e-5, i_tile=i_tile)
    assert out.dtype == t["x"].dtype and out.shape == t["x"].shape
    jargs = [j[k] for k in SWIGLU_ARGS]
    _swiglu_close(out, ps.swiglu_block_xla_grouped(*jargs, eps=1e-5, i_tile=i_tile), dtype)
    _swiglu_close(out, ps.fused_swiglu_block_fwd_w8a8(*jargs, eps=1e-5, interpret=True,
                                                      row_tile=4, i_tile=i_tile), dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("form", ["w", "w_q", "w_q8"])
def test_swiglu_dispatch_vs_jax(dtype, form):
    """``swiglu_block``: three w_q8 projections take the kernel's function
    (one I-tile at this size, so the grouping equals the per-row one),
    anything else the plain composition, as the JAX package's dispatch."""
    j, t = _swiglu_inputs(dtype, seed=52)
    if form == "w":
        for side, quant in ((j, jq), (t, tq)):
            for n in "gud":
                side["w" + n + "q"] = quant.dequantize_weight(
                    side["w" + n + "q"], side["s" + n], side["x"].dtype)
        jp = (j["ln"], *({"w": j["w" + n + "q"]} for n in "gud"))
        tp = (t["ln"], *({"w": t["w" + n + "q"]} for n in "gud"))
    else:
        jp, tp = _swiglu_params(j, form), _swiglu_params(t, form)
    out = cs.swiglu_block(*tp, t["x"], 1e-5)
    _swiglu_close(out, ps.swiglu_block(*jp, j["x"], 1e-5), dtype)
    _swiglu_close(out, ps.swiglu_block_xla(*jp, j["x"], 1e-5), dtype)
    mixed = (tp[0], tp[1], tp[2], {"w": tq.dequantize_weight(
        t["wdq"], t["sd"], t["x"].dtype)} if form != "w" else tp[3])
    np.testing.assert_array_equal(_np(cs.swiglu_block(*mixed, t["x"], 1e-5)),
                                  _np(cs.swiglu_block_plain(*mixed, t["x"], 1e-5)))


def test_swiglu_grads_match_jax():
    """The w8a8 dispatch's gradient is autograd of the per-row composition
    on the same weights: to the norm weight, the three scales and x."""
    import jax

    j, t = _swiglu_inputs("float32", seed=53)
    names = ("ln", "sg", "su", "sd", "x")

    def jloss(ln, sg, su, sd, x):
        p = dict(j, ln=ln, sg=sg, su=su, sd=sd)
        return jnp.sum(ps.swiglu_block(*_swiglu_params(p), x, 1e-5) ** 2)

    ref = jax.grad(jloss, argnums=tuple(range(5)))(*(j[k] for k in names))
    leaves = {k: t[k].clone().requires_grad_() for k in names}
    out = cs.swiglu_block(*_swiglu_params(dict(t, **leaves)), leaves["x"], 1e-5)
    (out ** 2).sum().backward()
    assert t["wgq"].grad is None
    for k, r in zip(names, ref):
        np.testing.assert_allclose(_np(leaves[k].grad).reshape(np.shape(r)), _np(r),
                                   atol=1e-3, rtol=1e-3, err_msg=k)


def test_new_kernel_wrappers_never_fall_back():
    """The q8, GQA and SwiGLU kernel wrappers refuse CPU tensors before
    anything is built or counted."""
    _, t = _q_inputs("float32", h=768, inner=256, rows=(4,))
    counts = lambda: (cm.fused_mlp_block_fwd_q8.launches, cm.fused_mlp_postln_fwd_q8.launches,
                      ca.fused_attention_gqa.launches, cs.fused_swiglu_block_fwd_w8a8.launches)
    before = counts()
    for fn in (cm.fused_mlp_block_fwd_q8, cm.fused_mlp_postln_fwd_q8):
        with pytest.raises(ValueError, match="CUDA"):
            fn(*(t[k] for k in Q8_ARGS))
    _, tx = _gqa_inputs("float32", 2, False, d=128)
    with pytest.raises(ValueError, match="no kernel"):
        ca._gqa_kernel(*tx)
    _, s = _swiglu_inputs("float32", rows=2, h=4096, i=1024)
    with pytest.raises(ValueError, match="CUDA"):
        cs.fused_swiglu_block_fwd_w8a8(*(s[k] for k in SWIGLU_ARGS))
    _, s = _swiglu_inputs("float32", rows=2, h=72, i=64)   # H not a multiple of 16
    with pytest.raises(ValueError, match="hidden size"):
        cs.fused_swiglu_block_fwd_w8a8(*(s[k] for k in SWIGLU_ARGS))
    assert counts() == before
