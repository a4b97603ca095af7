"""``torch.export`` round trip of the port's served forward
(``vault_tpu_torch/export.py``), mirroring tests/test_export.py's
``jax.export`` round trip of the JAX package's.

The model runs on the kernel selectors ("fuseqkv+fusemlp+batched"; w8a8 on
"fuselnqkv+fusemlp+batched"), so every kernel site is an operator of the
``vault_tpu_torch`` namespace in the exported graph; on the CPU the
operators run the kernels' plain versions.  The loaded program must give
the eager port's logits within 1e-6 (measured 0) and hold one node per
kernel launch; the eager port is held against the JAX package's forward on
the same parameters at tests/test_torch_models.py's fp32 tolerance (5e-5).
"""

import collections

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vault_tpu.config import VaultConfig as JVaultConfig
from vault_tpu.config import tiny_text_config as j_tiny_text
from vault_tpu.config import tiny_vilt_config as j_tiny_vilt
from vault_tpu.models import vault as jvault
from vault_tpu.ops import quantize as jq
from vault_tpu_torch.config import VaultConfig, tiny_text_config, tiny_vilt_config
from vault_tpu_torch.convert import params_from_jax
from vault_tpu_torch.export import export_forward, exported_ops, load_forward
from vault_tpu_torch.models.vault import VaultForClassification, vault_apply

FP32_ATOL = 5e-5
VILT = dict(image_size=32, patch_size=16, num_patch_tokens=4)
SELECTORS = {None: "fuseqkv+fusemlp+batched", "w8": "fuseqkv+fusemlp+batched",
             "w8a8": "fuselnqkv+fusemlp+batched"}
# the kernel launches of one forward: attention in every layer, one MLP
# block in every layer, and on w8a8 the LN->QKV kernel in ViLT's
OPS = {None: ("attention", "mlp_postln", "mlp_block"),
       "w8": ("attention", "mlp_postln_q8", "mlp_block_q8"),
       "w8a8": ("attention", "mlp_postln_w8a8", "mlp_block_w8a8", "ln_qkv_w8a8")}


def _setup(mode, seed=0):
    jcfg = JVaultConfig(vilt=j_tiny_vilt(**VILT), text_tower=j_tiny_text(num_hidden_layers=1))
    tcfg = VaultConfig(vilt=tiny_vilt_config(**VILT),
                       text_tower=tiny_text_config(num_hidden_layers=1))
    p = jvault.init_vault(jax.random.PRNGKey(seed), jcfg)
    p["head"] = jvault.init_classifier_head(jax.random.PRNGKey(1), jcfg.vilt.hidden_size, 3)
    leaves, tree = jax.tree.flatten(p)
    rng = np.random.default_rng(seed)
    p = jax.tree.unflatten(tree, [l + jnp.asarray(0.02 * rng.normal(size=l.shape), l.dtype)
                                  for l in leaves])
    if mode:
        p = jq.quantize_model_params(p, mode=mode)
    model = VaultForClassification(tcfg, device="cpu", use_pallas=SELECTORS[mode])
    if mode:
        model.quantize(mode)
        model.use_pallas = SELECTORS[mode]
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, p), tcfg))
    rng = np.random.default_rng(seed)
    batch = dict(input_ids=rng.integers(0, tcfg.text_tower.vocab_size, (2, 6)),
                 attention_mask=np.ones((2, 6), np.int64),
                 token_type_ids=np.zeros((2, 6), np.int64),
                 pixel_values=rng.normal(size=(2, 3, 32, 32)).astype(np.float32),
                 pixel_mask=np.ones((2, 32, 32), np.int64))
    return jcfg, p, model, batch


def _launches(model, mode):
    n = {"attention": model.cfg.vilt.num_hidden_layers + model.cfg.text_tower.num_hidden_layers,
         "ln_qkv_w8a8": model.cfg.vilt.num_hidden_layers}
    n.update({op: model.cfg.text_tower.num_hidden_layers for op in OPS[mode] if "postln" in op})
    n.update({op: model.cfg.vilt.num_hidden_layers for op in OPS[mode] if "block" in op})
    return {f"vault_tpu_torch.{op}.default": n[op] for op in OPS[mode]}


@pytest.mark.parametrize("mode", [None, "w8", "w8a8"])
def test_export_roundtrip(tmp_path, mode):
    jcfg, jp, model, batch = _setup(mode)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    with torch.inference_mode():
        eager = model(tb)
    path = str(tmp_path / "vault_fwd.pt2")
    program = export_forward(model, (tb,), path)
    assert (tmp_path / "vault_fwd.pt2").stat().st_size > 1000
    assert collections.Counter(exported_ops(program)) == _launches(model, mode)
    loaded = load_forward(path)
    assert collections.Counter(exported_ops(loaded)) == _launches(model, mode)
    with torch.inference_mode():
        out = loaded(tb)
    assert out.shape == eager.shape == (2, 3)
    np.testing.assert_allclose(out.numpy(), eager.numpy(), atol=1e-6)
    ref = jvault.vault_for_classification(jp, jcfg, {k: jnp.asarray(v) for k, v in batch.items()},
                                          head_dropout=0.0, deterministic=True,
                                          use_pallas=SELECTORS[mode].replace("+batched", ""))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=FP32_ATOL)
    if mode == "w8a8":  # the K-major codes come back K-major
        from vault_tpu_torch.ops.quantize import is_k_major

        params = dict(loaded.named_parameters())
        assert all(is_k_major(t) for k, t in params.items()
                   if k.endswith(("mlp_in.w_q8", "mlp_out.w_q8")))


def test_export_a_function_of_the_model(tmp_path):
    """A function (the pooled output of ``vault_apply``) exports too, its
    closed-over parameters held as constants, and matches the JAX
    package's ``vault_apply`` as tests/test_export.py holds its own."""
    jcfg, jp, model, batch = _setup(None, seed=1)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}

    def fwd(b):
        return vault_apply(model, model.cfg, use_pallas=model.use_pallas, **b).pooler_output

    path = str(tmp_path / "pool.pt2")
    program = export_forward(fwd, (tb,), path)
    assert "vault_tpu_torch.attention.default" in exported_ops(program)
    with torch.inference_mode():
        out = load_forward(path)(tb)
        eager = fwd(tb)
    np.testing.assert_allclose(out.numpy(), eager.numpy(), atol=1e-6)
    ref = jvault.vault_apply(jp, jcfg, **{k: jnp.asarray(v) for k, v in batch.items()})
    np.testing.assert_allclose(out.numpy(), np.asarray(ref.pooler_output), atol=FP32_ATOL)


def test_operators_run_the_plain_versions_on_the_cpu():
    """Called directly, each operator's CPU implementation is its kernel's
    plain version (the attention ones in the kernels' (B, L, H, D) layout)."""
    from vault_tpu_torch.ops import cuda_attention as ca
    from vault_tpu_torch.ops import cuda_mlp as cm

    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn((2, 4, 5, 32), generator=g) for _ in range(3))
    bias = torch.zeros((2, 1, 1, 5))
    out = torch.ops.vault_tpu_torch.attention(q, k, v, bias)
    assert out.shape == (2, 5, 4, 32) and out.is_contiguous()
    assert torch.equal(out.permute(0, 2, 1, 3), ca.attention_plain(q, k, v, bias))
    assert torch.equal(ca.fused_attention(q, k, v, bias), ca.attention_plain(q, k, v, bias))
    h, i = 64, 128
    x = torch.randn((3, 7, h), generator=g)
    gamma, beta, b1, b2 = (torch.randn(n, generator=g) for n in (h, h, i, h))
    w1, w2 = torch.randn((h, i), generator=g), torch.randn((i, h), generator=g)
    got = torch.ops.vault_tpu_torch.mlp_block(gamma, beta, w1, b1, w2, b2, x, None,
                                              eps=1e-12, act="gelu")
    want = cm._mlp_block_plain({"scale": gamma, "bias": beta}, {"w": w1, "b": b1},
                               {"w": w2, "b": b2}, x, 1e-12, "gelu")
    assert torch.equal(got, want)
