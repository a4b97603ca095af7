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


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("pallas_fn", ["fused_attention", "fused_attention_batched",
                                       "fused_attention_dotbatch"])
def test_attention_plain_vs_pallas(dtype, pallas_fn):
    jx, tx = _attn_inputs(dtype)
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
