"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: without a CUDA device every test here skips (a skip is not
verification; ``python3 chip_smoke.py`` holds the kernels at the main
path's shapes).  On a machine with a card: ``python -m pytest -m cuda
tests/test_torch_cuda.py``.  Limits as in chip_smoke.py: bf16 6.25e-2 (a few
bf16 ulps of outputs of magnitude ~4), fp32 1e-4 (summation order).
"""

import pytest
import torch

pytestmark = pytest.mark.cuda

LIMITS = {torch.bfloat16: 6.25e-2, torch.float32: 1e-4}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("l", [1, 40, 77, 256, 300])
@pytest.mark.parametrize("fused", [False, True])
def test_attention_kernel_matches_plain(dev, dtype, l, fused):
    from vault_tpu_torch.ops import cuda_attention as ca
    from vault_tpu_torch.ops.attention import split_heads
    from vault_tpu_torch.ops.masks import extend_attention_mask

    g = torch.Generator(device=dev).manual_seed(l)
    if fused:  # head views into one (B, L, 3 H D) projection
        qkv = torch.randn((3, l, 3 * 4 * 64), generator=g, device=dev).to(dtype)
        q, k, v = (split_heads(t, 4) for t in torch.chunk(qkv, 3, dim=-1))
    else:
        q, k, v = (torch.randn((3, 4, l, 64), generator=g, device=dev).to(dtype)
                   for _ in range(3))
    mask = torch.ones((3, l), dtype=torch.int32, device=dev)
    mask[1, (l + 1) // 2:] = 0
    bias = extend_attention_mask(mask)
    n = ca.fused_attention.launches
    out = ca.fused_attention(q, k, v, bias)
    torch.cuda.synchronize()
    assert ca.fused_attention.launches == n + 1
    err = (out.float() - ca.attention_plain(q, k, v, bias).float()).abs().max().item()
    assert err <= LIMITS[dtype], err


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("postln", [False, True])
@pytest.mark.parametrize("with_mask", [False, True])
def test_mlp_kernels_match_plain(dev, dtype, postln, with_mask):
    from vault_tpu_torch.ops import cuda_mlp as cm

    g = torch.Generator(device=dev).manual_seed(1)
    h, i, rows = 768, 384, 37

    def rnd(*shape, std=1.0, mean=0.0):
        return (torch.randn(shape, generator=g, device=dev) * std + mean).to(dtype)

    x = rnd(rows, h)
    gamma, beta = rnd(h, std=0.1, mean=1.0), rnd(h, std=0.1)
    w1, b1, w2, b2 = rnd(h, i, std=0.05), rnd(i, std=0.05), rnd(i, h, std=0.05), rnd(h, std=0.05)
    m = None
    if with_mask:
        m = torch.where(torch.rand((rows, h), generator=g, device=dev) < 0.9,
                        1 / 0.9, 0.0).to(dtype)
    kernel = cm.fused_mlp_postln_fwd if postln else cm.fused_mlp_block_fwd
    plain = cm._mlp_postln_plain if postln else cm._mlp_block_plain
    out = kernel(gamma, beta, w1, b1, w2, b2, x, m)
    ref = plain({"scale": gamma, "bias": beta}, {"w": w1, "b": b1},
                {"w": w2, "b": b2}, x, 1e-12, "gelu", m)
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs().max().item()
    assert err <= LIMITS[dtype], err


def test_wrappers_reject_what_the_kernels_do_not_take(dev):
    from vault_tpu_torch.ops import cuda_attention as ca
    from vault_tpu_torch.ops import cuda_mlp as cm

    q = torch.zeros((1, 2, 8, 32), device=dev)
    with pytest.raises(ValueError):
        ca.fused_attention(q, q, q, torch.zeros((1, 1, 1, 8), device=dev))
    x = torch.zeros((4, 32), device=dev)
    w = torch.zeros((32, 128), device=dev)
    with pytest.raises(ValueError):
        cm.fused_mlp_block_fwd(x[0], x[0], w, w[0], w.t().contiguous(), x[0], x)


def test_model_forward_launches_each_kernel_per_layer(dev):
    from vault_tpu_torch.config import VaultConfig, tiny_text_config, tiny_vilt_config
    from vault_tpu_torch.models.vault import VaultForClassification
    from vault_tpu_torch.ops import cuda_attention as ca
    from vault_tpu_torch.ops import cuda_mlp as cm

    wide = dict(hidden_size=768, num_attention_heads=12, intermediate_size=1536)
    cfg = VaultConfig(vilt=tiny_vilt_config(**wide),
                      text_tower=tiny_text_config(**wide))
    model = VaultForClassification(cfg, dtype=torch.bfloat16)
    assert model.device.type == "cuda"
    batch = {"input_ids": torch.randint(1, 99, (2, 8)),
             "attention_mask": torch.ones((2, 8), dtype=torch.int64),
             "token_type_ids": torch.zeros((2, 8), dtype=torch.int64),
             "pixel_values": torch.randn((2, 3, 64, 64)),
             "pixel_mask": torch.ones((2, 64, 64), dtype=torch.int64)}
    before = (ca.fused_attention.launches, cm.fused_mlp_block_fwd.launches,
              cm.fused_mlp_postln_fwd.launches)
    with torch.inference_mode():
        out = model(batch)
        plain = model(batch, use_pallas=False)
    after = (ca.fused_attention.launches, cm.fused_mlp_block_fwd.launches,
             cm.fused_mlp_postln_fwd.launches)
    assert [a - b for a, b in zip(after, before)] == [4, 2, 2]
    assert (out.float() - plain.float()).abs().max().item() < 2e-2


def test_processor_on_the_card_matches_the_host(dev):
    """Resizing on the card gives the host's pixels within one uint8 level
    (the two devices' bicubic sums may round a half-level differently)."""
    import numpy as np

    from vault_tpu_torch.data.processor import VaultProcessor
    from vault_tpu_torch.text.wordpiece import WordPieceTokenizer

    tok = WordPieceTokenizer({t: i for i, t in enumerate(
        "[PAD] [UNK] [CLS] [SEP] [MASK] a cat".split())})
    rng = np.random.default_rng(0)
    images = [rng.integers(0, 256, s, dtype=np.uint8)
              for s in ((300, 500, 3), (480, 640, 3), (700, 300, 3), (64, 64))]
    host = VaultProcessor(tok, max_length=8)(images, ["a cat"] * 4)
    card = VaultProcessor(tok, max_length=8, device=dev)(images, ["a cat"] * 4)
    assert card["pixel_values"].device.type == "cuda"
    np.testing.assert_array_equal(card["pixel_mask"].cpu().numpy(), host["pixel_mask"])
    np.testing.assert_array_equal(card["input_ids"], host["input_ids"])
    err = np.abs(card["pixel_values"].cpu().numpy() - host["pixel_values"]).max()
    assert err <= 2.0 / 255 + 1e-6, err
