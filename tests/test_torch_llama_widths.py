"""The widths the Llama tower's two kernels take beyond Llama-3-8B's, held to
the JAX package on the CPU: the w8a8 SwiGLU block at hidden sizes that are
not a multiple of 128 and I-tiles that are not (688, 704, 864, 960), the
GQA attention at head dim 100 (OpenLLaMA-3B), and ``VaultWithLlamaTower``
at SmolLM-135M's widths and at a head dim of 100.

The same numpy inputs go through the JAX function (its Pallas kernels
interpreted, as its own tests run them) and through the port's, whose
kernel wrappers take their plain versions for CPU tensors.

Tolerances, those of the tests these extend: the SwiGLU block as
``tests/test_torch_kernels_plain.py``'s ``_swiglu_close`` (fp32 atol 2e-5,
bf16 atol 2e-2 plus rtol 2^-7); the GQA attention as its
``test_attention_gqa_plain_vs_pallas_and_xla`` (fp32 atol 5e-5 plus rtol
1e-4, bf16 atol 2e-2 plus rtol 2^-7); the tower as
``tests/test_torch_llama.py``'s ``test_vault_with_llama_tower_matches_jax``
(fp32 atol 5e-5, bf16 atol 3e-2 plus rtol 2^-7).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from vault_tpu.config import tiny_vilt_config as j_tiny_vilt
from vault_tpu.models import llama as jllama
from vault_tpu.models import vault as jvault
from vault_tpu.models import vilt as jvilt
from vault_tpu.ops import pallas_attention as pa
from vault_tpu.ops import pallas_swiglu as ps
from vault_tpu.ops import quantize as jq
from vault_tpu.ops.quantize import quantize_model_params as j_quantize
from vault_tpu_torch.config import tiny_vilt_config
from vault_tpu_torch.convert import params_from_jax
from vault_tpu_torch.models import llama as tllama
from vault_tpu_torch.models import vault as tvault
from vault_tpu_torch.ops import cuda_attention as ca
from vault_tpu_torch.ops import cuda_swiglu as cs
from vault_tpu_torch.ops import quantize as tq

RTOL = {"float32": 0.0, "bfloat16": 2.0 ** -7}


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


# ---------------------------------------------------------------------------
# The SwiGLU block
# ---------------------------------------------------------------------------

SWIGLU_ARGS = ("ln", "wgq", "sg", "wuq", "su", "wdq", "sd", "x")


def _swiglu_inputs(dtype, h, i, rows=8, seed=61):
    """Seeded operands quantized on both sides; the port's codes K-major."""
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


# (H, I): SmolLM-135M's own widths (H 576, two tiles of 768), I-tiles of 688
# (Llama-2-7B's), 704 (TinyLlama's) and 864 (Llama-2-13B's) under H 128,
# and H 400 with OpenLLaMA-3B's tile of 960
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("h,i,tile", [(576, 1536, 768), (128, 1376, 688), (128, 1408, 704),
                                      (128, 1728, 864), (400, 960, 960)])
def test_swiglu_w8a8_plain_vs_pallas_at_llama_widths(dtype, h, i, tile):
    j, t = _swiglu_inputs(dtype, h, i)
    assert cs.check_widths("test", h, i) == tile == cs.pick_tile(i, cs.I_TILE)
    out = cs.swiglu_block_w8a8_plain(*(t[k] for k in SWIGLU_ARGS), eps=1e-5)
    assert out.dtype == t["x"].dtype and out.shape == t["x"].shape
    ref = ps.fused_swiglu_block_fwd_w8a8(*(j[k] for k in SWIGLU_ARGS), eps=1e-5,
                                         interpret=True, row_tile=4)
    np.testing.assert_allclose(_np(out), _np(ref), atol=2e-5 if dtype == "float32" else 2e-2,
                               rtol=RTOL[dtype])


# ---------------------------------------------------------------------------
# The GQA attention at head dim 100
# ---------------------------------------------------------------------------

def _gqa_inputs(dtype, rep, padded, b=3, g=2, l=11, d=100, seed=62):
    """q (B, G rep, L, D), k/v (B, G, L, D) and the tower's (B, 1, L, L)
    causal and padding bias (``padded``: row 1 padded on the right, row 2
    on the left, its first queries seeing no key)."""
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
@pytest.mark.parametrize("rep", [1, 4])
@pytest.mark.parametrize("padded", [False, True])
def test_attention_gqa_plain_vs_pallas_at_head_dim_100(dtype, rep, padded):
    jx, tx = _gqa_inputs(dtype, rep, padded)
    assert 100 in ca.HEAD_DIMS and 100 not in ca.EXACT_HEAD_DIMS
    out = ca.attention_gqa_plain(*tx)
    assert out.dtype == tx[0].dtype and out.shape == tx[0].shape
    assert torch.isfinite(out.float()).all()
    # the wrapper on CPU tensors: the plain version, bit for bit
    assert torch.equal(ca.fused_attention_gqa(*tx), out)
    ref = pa.fused_attention_gqa(*jx, interpret=True)
    atol, rtol = (5e-5, 1e-4) if dtype == "float32" else (2e-2, RTOL[dtype])
    np.testing.assert_allclose(_np(out), _np(ref), atol=atol, rtol=rtol)


# ---------------------------------------------------------------------------
# The tower feeding ViLT at the new widths
# ---------------------------------------------------------------------------

# SmolLM-135M's widths (H 576, 9 query heads on 3, I 1,536) and a head dim
# of 100 (H 400, 4 heads, I 960: OpenLLaMA-3B's head dim and I-tile)
GEOMETRIES = {"smollm_135m": dict(hidden_size=576, num_attention_heads=9,
                                  num_key_value_heads=3, intermediate_size=1536),
              "head_dim_100": dict(hidden_size=400, num_attention_heads=4,
                                   num_key_value_heads=4, intermediate_size=960)}
ATOL = {"float32": 5e-5, "bfloat16": 3e-2}


def _jax_vault(dtype, geometry):
    """The JAX package's two-layer tower at ``geometry`` (vocabulary 99, its
    norm weights moved off 1 and kept fp32, its GQA and SwiGLU kernels on)
    feeding its tiny ViLT."""
    jcfg = jllama.tiny_llama_config(attn_impl="pallas", mlp_impl="pallas",
                                    **GEOMETRIES[geometry])
    p = jllama.init_llama(jax.random.PRNGKey(0), jcfg)
    rng = np.random.default_rng(7)
    jd = getattr(jnp, dtype)
    layers = {k: (v + jnp.asarray(0.1 * rng.normal(size=v.shape), jnp.float32)
                  if k.endswith("_ln") else jax.tree.map(lambda a: a.astype(jd), v))
              for k, v in p["layers"].items()}
    tower = {"embed": p["embed"].astype(jd), "layers": layers,
             "final_ln": p["final_ln"] + jnp.asarray(
                 0.1 * rng.normal(size=p["final_ln"].shape), jnp.float32)}
    vcfg = j_tiny_vilt()
    k1, k2 = jax.random.split(jax.random.PRNGKey(3))
    rest = {"lm_proj": jllama.init_lm_projection(k1, jcfg.hidden_size, vcfg.hidden_size),
            "vilt": jvilt.init_vilt(k2, vcfg)}
    leaves, tree = jax.tree.flatten(rest)
    rest = jax.tree.unflatten(tree, [(l + jnp.asarray(0.02 * rng.normal(size=l.shape),
                                                      l.dtype)).astype(jd) for l in leaves])
    return jcfg, vcfg, {"llama": tower, **rest}


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


def _port_and_jax(geometry, mode, dtype):
    """The port's ``VaultWithLlamaTower`` and the JAX package's
    ``vault_with_llama_tower`` on the same weights and batch, quantized
    ``mode``."""
    jcfg, vcfg, jp = _jax_vault(dtype, geometry)
    tcfg = tllama.tiny_llama_config(attn_impl="pallas", mlp_impl="pallas",
                                    **GEOMETRIES[geometry])
    assert tcfg.head_dim == jcfg.head_dim in (64, 100)
    model = tvault.VaultWithLlamaTower(tiny_vilt_config(), tcfg, device="cpu",
                                       dtype=getattr(torch, dtype))
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, jp), llama_cfg=tcfg))
    if mode:
        jp = {**jp, "llama": j_quantize(jp["llama"], mode=mode)}
        model.quantize(mode)
    batch = _batch()
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jb["pixel_values"] = jb["pixel_values"].astype(getattr(jnp, dtype))
    # the tower's kernels (attn_impl, mlp_impl) on; ViLT's plain path, whose
    # kernels tests/test_torch_llama.py holds at these ViLT widths
    ref = jvault.vault_with_llama_tower(jp, vcfg, jcfg, use_pallas=False, **jb)
    with torch.inference_mode():
        out = model(batch, use_pallas=False)
    assert out.pooler_output.shape == (3, vcfg.hidden_size)
    return out, ref


@pytest.mark.parametrize("dtype,mode", [("float32", None), ("bfloat16", None),
                                        ("float32", "w8a8")])
@pytest.mark.parametrize("geometry", list(GEOMETRIES))
def test_vault_with_llama_tower_matches_jax_at_new_widths(geometry, mode, dtype):
    out, ref = _port_and_jax(geometry, mode, dtype)
    for a, b in ((out.last_hidden_state, ref.last_hidden_state),
                 (out.pooler_output, ref.pooler_output)):
        np.testing.assert_allclose(_np(a), _np(b), atol=ATOL[dtype], rtol=RTOL[dtype])


@pytest.mark.parametrize("geometry", list(GEOMETRIES))
def test_vault_with_llama_tower_w8a8_bf16_at_new_widths(geometry):
    """The w8a8 tower in bf16.  Its pooler is held to the bf16 tolerance
    above.  Its last hidden state misses it at these widths (ROADMAP.md
    Queue C: at most 0.078125 on 52 of 2,400 elements at SmolLM-135M's, on
    the CPU): the two sides round bf16 chains at different points (the bf16
    tower without quantization differs by up to 0.047 after two layers), and
    where a normalised activation lies a bf16 ulp either side of a rounding
    point its int8 code flips.  The miss is held below what w8a8 itself
    moves the JAX package's output (its w8a8 tower against its bf16 one),
    element for element in count and at the maximum."""
    out, ref = _port_and_jax(geometry, "w8a8", "bfloat16")
    np.testing.assert_allclose(_np(out.pooler_output), _np(ref.pooler_output),
                               atol=ATOL["bfloat16"], rtol=RTOL["bfloat16"])
    _, unquantized = _port_and_jax(geometry, None, "bfloat16")
    o, r, u = (_np(t) for t in (out.last_hidden_state, ref.last_hidden_state,
                                unquantized.last_hidden_state))
    over = lambda a, b: int((np.abs(a - b) > ATOL["bfloat16"] + RTOL["bfloat16"] * np.abs(b)).sum())
    assert np.abs(o - r).max() < np.abs(r - u).max()
    assert over(o, r) < over(r, u)
