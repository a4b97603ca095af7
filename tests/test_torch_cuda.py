"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: without a CUDA device every test here skips (a skip is not
verification; ``python3 chip_smoke.py`` holds the kernels at the main
path's shapes).  On a machine with a card: ``python3 -m pytest --noconftest -m cuda
tests/test_torch_cuda.py`` (the repository's conftest imports JAX).  Limits
as in chip_smoke.py: forward bf16 6.25e-2 (a few bf16 ulps of outputs of
magnitude ~4), fp32 1e-4 (summation order); backward, per output, 2^-5
(bf16) or 1e-4 (fp32) of max(1, max|plain|); the w8a8 kernels (the SwiGLU
block included) bit-equal, the fp LN->QKV kernel in bf16 2^-7 of max(1,
max|plain|); the q8 MLP blocks and the GQA attention at the forward limits,
bf16 attention also per query row, 2^-5 of the row's max|plain|; the
dequantizing stage of the GEMM core exact.
"""

import pytest
import torch

pytestmark = pytest.mark.cuda

LIMITS = {torch.bfloat16: 6.25e-2, torch.float32: 1e-4}
ATTENTION_ROW_LIMIT = 2.0 ** -5


def _attention_row_err(out, ref):
    """Max over query rows of max |out - ref| / max |ref| in that row."""
    ref = ref.float()
    err = (out.float() - ref).abs().amax(-1)
    return (err / ref.abs().amax(-1).clamp_min(1e-30)).max().item()


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("l", [1, 40, 77, 256, 257, 300, 512])
@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("d", [32, 64, 96, 128])
def test_attention_kernel_matches_plain(dev, dtype, l, fused, d):
    from vault_tpu_torch.ops import cuda_attention as ca
    from vault_tpu_torch.ops.attention import split_heads
    from vault_tpu_torch.ops.masks import extend_attention_mask

    g = torch.Generator(device=dev).manual_seed(l)
    if fused:  # head views into one (B, L, 3 H D) projection
        qkv = torch.randn((3, l, 3 * 4 * d), generator=g, device=dev).to(dtype)
        q, k, v = (split_heads(t, 4) for t in torch.chunk(qkv, 3, dim=-1))
    else:
        q, k, v = (torch.randn((3, 4, l, d), generator=g, device=dev).to(dtype)
                   for _ in range(3))
    mask = torch.ones((3, l), dtype=torch.int32, device=dev)
    mask[1, (l + 1) // 2:] = 0
    bias = extend_attention_mask(mask)
    n = ca.fused_attention.launches
    out = ca.fused_attention(q, k, v, bias)
    torch.cuda.synchronize()
    assert ca.fused_attention.launches == n + 1
    ref = ca.attention_plain(q, k, v, bias)
    err = (out.float() - ref.float()).abs().max().item()
    assert err <= LIMITS[dtype], err
    if dtype == torch.bfloat16:
        assert _attention_row_err(out, ref) <= ATTENTION_ROW_LIMIT


# Row counts at the edges of the tiles: 64-row fp32 tiles, 128-row wgmma
# tiles (1, 77, 130, 2,048 + 5), the serving and training rows of the BERT
# blocks (320, 1,280) and of the ViLT blocks (8,192).
MLP_ROWS = [37, 1, 77, 130, 320, 1280, 2048 + 5, 8192]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("postln", [False, True])
@pytest.mark.parametrize("with_mask", [False, True])
@pytest.mark.parametrize("rows", MLP_ROWS)
def test_mlp_kernels_match_plain(dev, dtype, postln, with_mask, rows):
    from vault_tpu_torch.ops import cuda_mlp as cm

    g = torch.Generator(device=dev).manual_seed(1)
    h, i = 768, 384

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

    q = torch.zeros((1, 2, 8, 48), device=dev)  # head dim 48: not 32, 64, 96, 128
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


BWD_LIMITS = {torch.bfloat16: 2.0 ** -5, torch.float32: 1e-4}


def _mlp_operands(dev, rows, dtype, with_mask, i=3072, seed=2):
    g = torch.Generator(device=dev).manual_seed(seed)

    def rnd(*shape, std=1.0, mean=0.0):
        return (torch.randn(shape, generator=g, device=dev) * std + mean).to(dtype)

    ops = dict(gamma=rnd(768, std=0.1, mean=1.0), beta=rnd(768, std=0.1),
               w1=rnd(768, i, std=0.02), b1=rnd(i, std=0.02),
               w2=rnd(i, 768, std=0.02), b2=rnd(768, std=0.02), x=rnd(rows, 768),
               g=rnd(rows, 768))
    ops["m"] = None
    if with_mask:
        ops["m"] = torch.where(torch.rand((rows, 768), generator=g, device=dev) < 0.9,
                               1 / 0.9, 0.0).to(dtype)
    return ops


_ARGS = ("gamma", "beta", "w1", "b1", "w2", "b2", "x", "g", "m")


def _assert_close_scaled(out, ref, dtype):
    for n, a, b in zip(("dgamma", "dbeta", "dw1", "db1", "dw2", "db2", "dx"), out, ref):
        assert a.shape == b.shape and a.dtype == b.dtype, n
        scale = max(1.0, b.float().abs().max().item())
        err = (a.float() - b.float()).abs().max().item() / scale
        assert err <= BWD_LIMITS[dtype], (n, err)


BWD_CASES = [(False, 8192, torch.bfloat16), (True, 1280, torch.bfloat16),
             (False, 77, torch.bfloat16), (True, 77, torch.bfloat16),
             (False, 77, torch.float32), (True, 1280, torch.float32),
             (False, 1, torch.bfloat16), (False, 130, torch.bfloat16),
             (False, 2048 + 5, torch.bfloat16)]


@pytest.mark.parametrize("postln,rows,dtype", BWD_CASES)
@pytest.mark.parametrize("with_mask", [False, True])
def test_mlp_bwd_kernels_match_plain(dev, postln, rows, dtype, with_mask):
    """The backward kernels at the training main path's rows (batch 32:
    8192 ViLT rows, 1280 BERT rows) and at a ragged 77; two launches give
    the same bits."""
    from vault_tpu_torch.ops import cuda_mlp as cm

    o = _mlp_operands(dev, rows, dtype, with_mask)
    args = [o[k] for k in _ARGS]
    kernel = cm.fused_mlp_postln_block_bwd if postln else cm.fused_mlp_block_bwd
    plain = cm.mlp_postln_bwd_plain if postln else cm.mlp_block_bwd_plain
    n = kernel.launches
    out, again = kernel(*args), kernel(*args)
    ref = plain(*args)
    torch.cuda.synchronize()
    assert kernel.launches == n + 2
    _assert_close_scaled(out, ref, dtype)
    assert all(torch.equal(a, b) for a, b in zip(out, again))


@pytest.mark.parametrize("postln", [False, True])
@pytest.mark.parametrize("with_mask", [False, True])
def test_gradients_flow_through_the_forward_kernels(dev, postln, with_mask):
    """Before the forward kernels were autograd Functions their outputs had
    no grad_fn and cut the graph.  Through the dispatcher on the card (the
    forward kernel, then the backward kernel) every input but the mask gets
    the gradient that autograd of the plain composition gives."""
    from vault_tpu_torch.ops import cuda_mlp as cm

    o = _mlp_operands(dev, 300, torch.bfloat16, with_mask, i=768)
    names = _ARGS[:7]
    grads = []
    for path in ("kernel", "plain"):
        leaves = [o[k].clone().requires_grad_() for k in names]
        ln_p = {"scale": leaves[0], "bias": leaves[1]}
        p_in, p_out = {"w": leaves[2], "b": leaves[3]}, {"w": leaves[4], "b": leaves[5]}
        if path == "kernel":
            block = cm.fused_mlp_postln_block if postln else cm.fused_mlp_block
            n = (cm.fused_mlp_postln_block_bwd if postln else cm.fused_mlp_block_bwd).launches
            out = block(ln_p, p_in, p_out, leaves[6], 1e-12, "gelu", o["m"])
            assert out.grad_fn is not None
        else:
            fwd = cm._mlp_postln_plain if postln else cm._mlp_block_plain
            out = fwd(ln_p, p_in, p_out, leaves[6], 1e-12, "gelu", o["m"])
        out.backward(o["g"])
        grads.append([l.grad for l in leaves])
    assert (cm.fused_mlp_postln_block_bwd if postln else cm.fused_mlp_block_bwd).launches == n + 1
    torch.cuda.synchronize()
    _assert_close_scaled(grads[0], grads[1], torch.bfloat16)


# The post-LN block on the wgmma core at the main path's rows (the BERT
# layers: 320 at batch 8, 1,280 with a mask at batch 32) and ragged ones,
# at BERT-base's widths; two launches give the same bits (split-K slices
# are added in a fixed order, no float atomics).
@pytest.mark.parametrize("rows,with_mask", [(320, False), (320, True), (1280, True),
                                            (77, True), (37, False)])
def test_postln_block_on_the_core_at_the_main_rows(dev, rows, with_mask):
    from vault_tpu_torch.ops import cuda_mlp as cm

    o = _mlp_operands(dev, rows, torch.bfloat16, with_mask)
    args = [o[k] for k in _ARGS]
    fwd_args = args[:7] + [args[8]]
    n = cm.fused_mlp_postln_fwd.launches, cm.fused_mlp_postln_block_bwd.launches
    out, again = cm.fused_mlp_postln_fwd(*fwd_args), cm.fused_mlp_postln_fwd(*fwd_args)
    ref = cm._mlp_postln_plain({"scale": o["gamma"], "bias": o["beta"]},
                               {"w": o["w1"], "b": o["b1"]}, {"w": o["w2"], "b": o["b2"]},
                               o["x"], 1e-12, "gelu", o["m"])
    grads, grads_again = cm.fused_mlp_postln_block_bwd(*args), cm.fused_mlp_postln_block_bwd(*args)
    torch.cuda.synchronize()
    assert (cm.fused_mlp_postln_fwd.launches, cm.fused_mlp_postln_block_bwd.launches) == (
        n[0] + 2, n[1] + 2)
    assert (out.float() - ref.float()).abs().max().item() <= LIMITS[torch.bfloat16]
    assert torch.equal(out, again)
    _assert_close_scaled(grads, cm.mlp_postln_bwd_plain(*args), torch.bfloat16)
    assert all(torch.equal(a, b) for a, b in zip(grads, grads_again))


# Second geometries of the bf16 blocks (the wgmma core's width contract):
# BERT-large (H 1,024, I 4,096), H 512 / I 2,048, the smallest (64, 64) and
# an I that is a multiple of 64 but not of 128.
@pytest.mark.parametrize("h,i", [(1024, 4096), (512, 2048), (64, 64), (768, 1088)])
@pytest.mark.parametrize("postln", [False, True])
@pytest.mark.parametrize("rows", [77, 320])
def test_bf16_blocks_at_other_widths(dev, h, i, postln, rows):
    from vault_tpu_torch.ops import cuda_mlp as cm

    g = torch.Generator(device=dev).manual_seed(h + i + rows)
    rnd = lambda *s, std=1.0, mean=0.0: (torch.randn(s, generator=g, device=dev) * std
                                         + mean).to(torch.bfloat16)
    o = dict(gamma=rnd(h, std=0.1, mean=1.0), beta=rnd(h, std=0.1), w1=rnd(h, i, std=0.02),
             b1=rnd(i, std=0.02), w2=rnd(i, h, std=0.02), b2=rnd(h, std=0.02), x=rnd(rows, h),
             g=rnd(rows, h))
    o["m"] = torch.where(torch.rand((rows, h), generator=g, device=dev) < 0.9, 1 / 0.9,
                         0.0).to(torch.bfloat16)
    args = [o[k] for k in _ARGS]
    kernel = cm.fused_mlp_postln_fwd if postln else cm.fused_mlp_block_fwd
    plain = cm._mlp_postln_plain if postln else cm._mlp_block_plain
    out = kernel(*args[:7], o["m"])
    ref = plain({"scale": o["gamma"], "bias": o["beta"]}, {"w": o["w1"], "b": o["b1"]},
                {"w": o["w2"], "b": o["b2"]}, o["x"], 1e-12, "gelu", o["m"])
    bwd = cm.fused_mlp_postln_block_bwd if postln else cm.fused_mlp_block_bwd
    bwd_plain = cm.mlp_postln_bwd_plain if postln else cm.mlp_block_bwd_plain
    grads, grads_again = bwd(*args), bwd(*args)
    torch.cuda.synchronize()
    assert (out.float() - ref.float()).abs().max().item() <= LIMITS[torch.bfloat16]
    _assert_close_scaled(grads, bwd_plain(*args), torch.bfloat16)
    assert all(torch.equal(a, b) for a, b in zip(grads, grads_again))


@pytest.mark.parametrize("h,i", [(768, 3072), (1024, 4096), (512, 2048), (128, 384)])
@pytest.mark.parametrize("postln", [False, True])
@pytest.mark.parametrize("rows", [77, 37])
def test_fp32_blocks_on_the_tiles_at_their_widths(dev, h, i, postln, rows):
    """The fp32 blocks (``mlp_route`` "tiles"), forward with fp32 and int8
    weights and backward, at the widths of their contract: within 1e-4 of
    their plain versions (backward per output of max(1, max|plain|)),
    repeats bit-equal."""
    from vault_tpu_torch.ops import cuda_mlp as cm
    from vault_tpu_torch.ops.quantize import quantize_weight

    g = torch.Generator(device=dev).manual_seed(h + i + rows)
    rnd = lambda *s, std=1.0, mean=0.0: torch.randn(s, generator=g, device=dev) * std + mean
    o = dict(gamma=rnd(h, std=0.1, mean=1.0), beta=rnd(h, std=0.1), w1=rnd(h, i, std=0.02),
             b1=rnd(i, std=0.02), w2=rnd(i, h, std=0.02), b2=rnd(h, std=0.02), x=rnd(rows, h),
             g=rnd(rows, h))
    o["m"] = torch.where(torch.rand((rows, h), generator=g, device=dev) < 0.9, 1 / 0.9, 0.0)
    args = [o[k] for k in _ARGS]
    kernel = cm.fused_mlp_postln_fwd if postln else cm.fused_mlp_block_fwd
    plain = cm._mlp_postln_plain if postln else cm._mlp_block_plain
    out, again = kernel(*args[:7], o["m"]), kernel(*args[:7], o["m"])
    ref = plain({"scale": o["gamma"], "bias": o["beta"]}, {"w": o["w1"], "b": o["b1"]},
                {"w": o["w2"], "b": o["b2"]}, o["x"], 1e-12, "gelu", o["m"])
    (w1q, s1), (w2q, s2) = quantize_weight(o["w1"]), quantize_weight(o["w2"])
    q8 = (o["gamma"], o["beta"], w1q, s1.reshape(-1), o["b1"], w2q, s2.reshape(-1), o["b2"],
          o["x"])
    q8_kernel = cm.fused_mlp_postln_fwd_q8 if postln else cm.fused_mlp_block_fwd_q8
    q8_plain = cm.mlp_postln_q8_plain if postln else cm.mlp_block_q8_plain
    q8_out = q8_kernel(*q8)
    bwd = cm.fused_mlp_postln_block_bwd if postln else cm.fused_mlp_block_bwd
    bwd_plain = cm.mlp_postln_bwd_plain if postln else cm.mlp_block_bwd_plain
    grads, grads_again = bwd(*args), bwd(*args)
    torch.cuda.synchronize()
    assert cm.mlp_route(torch.float32) == "tiles"
    assert (out - ref).abs().max().item() <= LIMITS[torch.float32]
    assert torch.equal(out, again)
    assert (q8_out - q8_plain(*q8)).abs().max().item() <= LIMITS[torch.float32]
    _assert_close_scaled(grads, bwd_plain(*args), torch.float32)
    assert all(torch.equal(a, b) for a, b in zip(grads, grads_again))


# The wgmma core alone: fp32 sums of the same exact bf16 products in other
# orders, within 1e-4 of max(1, max|plain|) (a bf16 ulp of the output is
# 2^-8 of it).
GEMM_CORE_LIMIT = 1e-4


@pytest.mark.parametrize("layout,tile_width", [
    ("n_contiguous", 192), ("n_contiguous", 128), ("k_contiguous", 192),
    ("k_contiguous", 128), ("dual", 128)])
@pytest.mark.parametrize("rows", [2048, 77])
def test_gemm_core_matches_plain(dev, layout, tile_width, rows):
    """Each B layout of csrc/gemm_sm90.cuh at the blocks' shapes, 768 x
    3,072 weights: y W1 (W1 N-contiguous), dh1 W1^T (W1 K-contiguous) and
    the dual (y W1, gc W2^T), against matmul_fp32."""
    from vault_tpu_torch.ops import cuda_gemm as cg

    g = torch.Generator(device=dev).manual_seed(rows)
    rnd = lambda *s, std=1.0: (torch.randn(s, generator=g, device=dev) * std).to(torch.bfloat16)
    w1, w2 = rnd(768, 3072, std=0.02), rnd(3072, 768, std=0.02)
    y, d, gc = rnd(rows, 768), rnd(rows, 3072), rnd(rows, 768)
    if layout == "n_contiguous":
        outs, refs = (cg.gemm_bf16(y, w1, tile_width=tile_width),), (cg.gemm_plain(y, w1),)
    elif layout == "k_contiguous":
        outs = (cg.gemm_bf16(d, w1, True, tile_width),)
        refs = (cg.gemm_plain(d, w1, True),)
    else:
        outs, refs = cg.gemm_dual_bf16(y, w1, gc, w2), cg.gemm_dual_plain(y, w1, gc, w2)
    torch.cuda.synchronize()
    for a, b in zip(outs, refs):
        assert a.shape == b.shape and a.dtype == torch.float32
        err = (a - b).abs().max().item() / max(1.0, b.abs().max().item())
        assert err <= GEMM_CORE_LIMIT, err


def test_gradients_flow_through_the_attention_kernel(dev):
    from vault_tpu_torch.ops import cuda_attention as ca
    from vault_tpu_torch.ops.masks import extend_attention_mask

    g = torch.Generator(device=dev).manual_seed(3)
    q, k, v = (torch.randn((2, 4, 40, 64), generator=g, device=dev)
               .to(torch.bfloat16).requires_grad_() for _ in range(3))
    mask = torch.ones((2, 40), dtype=torch.int32, device=dev)
    mask[1, 25:] = 0
    bias = extend_attention_mask(mask)
    cot = torch.randn((2, 4, 40, 64), generator=g, device=dev).to(torch.bfloat16)
    n = ca.fused_attention.launches
    out = ca.fused_attention(q, k, v, bias)
    assert out.grad_fn is not None and ca.fused_attention.launches == n + 1
    got = torch.autograd.grad(out, (q, k, v), cot)
    ref = torch.autograd.grad(ca.attention_plain(q, k, v, bias), (q, k, v), cot)
    for a, b in zip(got, ref):
        assert torch.equal(a, b)  # the backward recomputes the plain version


def test_training_gradients_reach_every_layer(dev):
    """A wide two-layer VAuLT, bf16, dropout on: one loss.backward() on the
    kernel path gives every parameter read by the model a nonzero gradient
    within 5e-2 (relative norm) of the plain path's.  The key biases are
    the exception: the softmax is invariant to the shift q . b_k they add
    to a query's scores, so their gradient is 0 in exact arithmetic and
    only its finiteness is checked."""
    from vault_tpu_torch.config import VaultConfig, tiny_text_config, tiny_vilt_config
    from vault_tpu_torch.convert import param_tree
    from vault_tpu_torch.models.vault import (
        VaultForClassification,
        batch_to_device,
        vault_for_classification,
    )

    wide = dict(hidden_size=768, num_attention_heads=12, intermediate_size=1536,
                hidden_dropout_prob=0.1)
    cfg = VaultConfig(vilt=tiny_vilt_config(**wide), text_tower=tiny_text_config(**wide))
    sd = VaultForClassification(cfg, dtype=torch.bfloat16).state_dict()
    batch = batch_to_device({
        "input_ids": torch.randint(1, 99, (4, 8)),
        "attention_mask": torch.ones((4, 8), dtype=torch.int64),
        "token_type_ids": torch.zeros((4, 8), dtype=torch.int64),
        "pixel_values": torch.randn((4, 3, 64, 64)),
        "pixel_mask": torch.ones((4, 64, 64), dtype=torch.int64)}, dev)
    grads = {}
    for impl in ("auto", False):
        leaves = {k: v.detach().clone().requires_grad_() for k, v in sd.items()}
        out = vault_for_classification(
            param_tree(leaves), cfg, batch, deterministic=False,
            generator=torch.Generator(device=dev).manual_seed(0), use_pallas=impl,
            remat=True)
        out.float().logsumexp(-1).sum().backward()
        grads[impl] = {k: v.grad for k, v in leaves.items()}
    unused = {"vilt.text_embeddings.word", "vilt.text_embeddings.position"}
    for k, gp in grads[False].items():
        gk = grads["auto"][k]
        if k in unused:
            assert gk is None and gp is None, k
            continue
        assert gk is not None and torch.isfinite(gk).all(), k
        if k.endswith(".k.b"):
            continue  # 0 in exact arithmetic (softmax shift): rounding noise
        assert gk.float().abs().sum() > 0, k
        rel = ((gk.float() - gp.float()).norm() / gp.float().norm()).item()
        assert rel <= 5e-2, (k, rel)


def test_backward_wrappers_reject_what_the_kernels_do_not_take(dev):
    from vault_tpu_torch.ops import cuda_mlp as cm

    o = _mlp_operands(dev, 16, torch.bfloat16, False, i=256)
    args = [o[k] for k in _ARGS]
    n = cm.fused_mlp_block_bwd.launches
    small = [t[..., :32] if t is not None and t.shape[-1] == 768 else t for t in args]
    bad = {
        "hidden size": [a.contiguous() if a is not None else a for a in small],
        "I multiple": [o["gamma"], o["beta"], o["w1"][:, :200].contiguous(),
                       o["b1"][:200].contiguous(), o["w2"][:200].contiguous(),
                       o["b2"], o["x"], o["g"], None],
        "g not contiguous": args[:7] + [o["g"].t().contiguous().t(), None],
        "g dtype": args[:7] + [o["g"].float(), None],
    }
    for fn in (cm.fused_mlp_block_bwd, cm.fused_mlp_postln_block_bwd):
        for what, a in bad.items():
            with pytest.raises((ValueError, TypeError)):
                fn(*a)
    assert cm.fused_mlp_block_bwd.launches == n


# ---------------------------------------------------------------------------
# LN -> QKV (csrc/ln_qkv.cu) and the w8a8 MLP blocks (csrc/mlp_w8a8.cu)
# ---------------------------------------------------------------------------

def _int8_operands(dev, rows, dtype, i=3072, seed=4, h=768, w8a8=False):
    """x, the LN and bias vectors and the quantized QKV and MLP weights; the
    QKV codes K-major, as the w8a8 LN->QKV kernel reads them; ``w8a8``: the
    MLP codes K-major too, as a w8a8 model holds them (the w8 codes stay
    row-major)."""
    from vault_tpu_torch.ops.quantize import k_major, quantize_weight

    g = torch.Generator(device=dev).manual_seed(seed)

    def rnd(*shape, std=1.0, mean=0.0):
        return (torch.randn(shape, generator=g, device=dev) * std + mean).to(dtype)

    o = dict(gamma=rnd(h, std=0.1, mean=1.0), beta=rnd(h, std=0.1),
             b1=rnd(i, std=0.02), b2=rnd(h, std=0.02), bqkv=rnd(3 * h, std=0.02),
             x=rnd(rows, h), wqkv=rnd(h, 3 * h, std=0.02))
    for name, shape in (("w1", (h, i)), ("w2", (i, h)), ("wqkv", None)):
        w = o["wqkv"] if shape is None else rnd(*shape, std=0.02)
        q, s = quantize_weight(w)
        o[name + "q"], o["s" + name[1:]] = (k_major(q) if w8a8 or shape is None else q,
                                            s.reshape(-1))
    return o


W8A8_ARGS = ("gamma", "beta", "w1q", "s1", "b1", "w2q", "s2", "b2", "x")
# The w8a8 kernels equal their plain versions bit for bit (same cast points,
# LN statistics in double, every fp32 step in the same order); the fp
# LN->QKV kernel differs from its plain version, the XLA composition, in the
# LN statistics' rounding and the summation order: in bf16 by at most 2^-7
# of the output's scale, one or two bf16 ulps there.
LNQKV_BF16_LIMIT = 2.0 ** -7


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("rows", [1, 77, 320, 2048])
def test_ln_qkv_kernels_match_plain(dev, dtype, rows):
    from vault_tpu_torch.ops import cuda_ln_qkv as cl

    o = _int8_operands(dev, rows, dtype)
    cases = ((cl.fused_ln_qkv_fwd, cl.ln_qkv_plain, ("gamma", "beta", "wqkv", "bqkv", "x")),
             (cl.fused_ln_qkv_fwd_w8a8, cl.ln_qkv_w8a8_plain,
              ("gamma", "beta", "wqkvq", "sqkv", "bqkv", "x")))
    for kernel, plain, names in cases:
        args = [o[k] for k in names]
        n = kernel.launches
        out, again = kernel(*args), kernel(*args)
        ref = plain(*args)
        torch.cuda.synchronize()
        assert kernel.launches == n + 2
        assert out.shape == (rows, 2304) and out.dtype == dtype
        if kernel is cl.fused_ln_qkv_fwd_w8a8:
            assert torch.equal(out, ref), (out.float() - ref.float()).abs().max().item()
        else:
            limit = LIMITS[dtype] if dtype == torch.float32 else (
                LNQKV_BF16_LIMIT * max(1.0, ref.float().abs().max().item()))
            err = (out.float() - ref.float()).abs().max().item()
            assert err <= limit, (err, limit)
        assert torch.equal(out, again)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("rows", [2048, 77, 37])
@pytest.mark.parametrize("h", [768, 1024, 512])
def test_ln_qkv_kernels_at_other_widths(dev, dtype, rows, h):
    """The w8a8 LN->QKV kernel on the int8 core bit-equal to its plain
    version, and the fp32 one (gemm_tiles) within the fp32 limit of its
    plain version, at ViLT-B/32's width, BERT-large's and H 512; repeats
    bit-equal."""
    from vault_tpu_torch.ops import cuda_ln_qkv as cl

    assert cl.ln_qkv_route(dtype, w8a8=True) == "wgmma"
    o = _int8_operands(dev, rows, dtype, i=256, seed=h + rows, h=h)
    args = [o[k] for k in ("gamma", "beta", "wqkvq", "sqkv", "bqkv", "x")]
    n = cl.fused_ln_qkv_fwd_w8a8.launches
    out, again = cl.fused_ln_qkv_fwd_w8a8(*args), cl.fused_ln_qkv_fwd_w8a8(*args)
    ref = cl.ln_qkv_w8a8_plain(*args)
    torch.cuda.synchronize()
    assert cl.fused_ln_qkv_fwd_w8a8.launches == n + 2
    assert out.shape == (rows, 3 * h) and out.dtype == dtype
    assert torch.equal(out, ref), (out.float() - ref.float()).abs().max().item()
    assert torch.equal(out, again)
    if dtype == torch.float32:
        args = [o[k] for k in ("gamma", "beta", "wqkv", "bqkv", "x")]
        out, again = cl.fused_ln_qkv_fwd(*args), cl.fused_ln_qkv_fwd(*args)
        ref = cl.ln_qkv_plain(*args)
        torch.cuda.synchronize()
        assert (out - ref).abs().max().item() <= LIMITS[dtype]
        assert torch.equal(out, again)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("rows", [1, 37, 77, 320, 2048])
@pytest.mark.parametrize("postln", [False, True])
@pytest.mark.parametrize("act", ["gelu", "gelu_new", "relu"])
@pytest.mark.parametrize("h,i", [(768, 3072), (1024, 4096), (512, 2048)])
def test_mlp_w8a8_kernels_match_plain(dev, dtype, rows, postln, act, h, i):
    """Both w8a8 blocks on the int8 core, K-major codes, bit-equal to
    their plain versions and across two launches, at BERT-base/ViLT-B
    widths, BERT-large's and H 512 / I 2,048."""
    from vault_tpu_torch.ops import cuda_mlp as cm

    o = _int8_operands(dev, rows, dtype, i=i, h=h, w8a8=True)
    args = [o[k] for k in W8A8_ARGS]
    kernel = cm.fused_mlp_postln_fwd_w8a8 if postln else cm.fused_mlp_block_fwd_w8a8
    plain = cm.mlp_postln_w8a8_plain if postln else cm.mlp_block_w8a8_plain
    n = kernel.launches
    out, again = kernel(*args, act=act), kernel(*args, act=act)
    ref = plain(*args, act=act)
    torch.cuda.synchronize()
    assert kernel.launches == n + 2
    assert torch.equal(out, ref), (out.float() - ref.float()).abs().max().item()
    assert torch.equal(out, again)


def test_int8_matmul_on_the_card_is_exact(dev):
    """torch._int_mm on the card (the plain linear's product), with the
    short inputs padded to its 17-row minimum, against an int64 product."""
    from vault_tpu_torch.ops.nn import int8_matmul

    g = torch.Generator(device=dev).manual_seed(5)
    for rows in (1, 16, 17, 320):
        xq = torch.randint(-127, 128, (rows, 3072), generator=g, device=dev).to(torch.int8)
        wq = torch.randint(-127, 128, (3072, 768), generator=g, device=dev).to(torch.int8)
        ref = (xq.cpu().long() @ wq.cpu().long())
        assert torch.equal(int8_matmul(xq, wq).cpu().long(), ref), rows
    with pytest.raises(ValueError, match="multiples of 8"):
        int8_matmul(xq[:, :20], wq[:20, :12])


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("rows", [1, 77, 320, 2048])
@pytest.mark.parametrize("postln", [False, True])
def test_mlp_q8_kernels_match_plain(dev, dtype, rows, postln):
    """The w8 blocks (int8 weights dequantized in the kernel) against the
    plain composition on the same ``w_q`` weights, through the wrappers and
    through the dispatch a w8 model takes."""
    from vault_tpu_torch.ops import cuda_mlp as cm

    o = _int8_operands(dev, rows, dtype)
    args = [o[k] for k in W8A8_ARGS]
    kernel = cm.fused_mlp_postln_fwd_q8 if postln else cm.fused_mlp_block_fwd_q8
    plain = cm.mlp_postln_q8_plain if postln else cm.mlp_block_q8_plain
    block = cm.fused_mlp_postln_block if postln else cm.fused_mlp_block
    n = kernel.launches
    out, again = kernel(*args), kernel(*args)
    via_block = block({"scale": o["gamma"], "bias": o["beta"]},
                      {"w_q": o["w1q"], "w_scale": o["s1"][None], "b": o["b1"]},
                      {"w_q": o["w2q"], "w_scale": o["s2"][None], "b": o["b2"]}, o["x"])
    ref = plain(*args)
    torch.cuda.synchronize()
    assert kernel.launches == n + 3
    err = (out.float() - ref.float()).abs().max().item()
    assert err <= LIMITS[dtype], err
    assert torch.equal(out, again) and torch.equal(out, via_block)


# The kernels on the wgmma core: the bf16 pre-LN q8 block (behind its
# dequantization pass) and the bf16 LN->QKV projection, at the ViLT rows of a
# batch-8 forward (2,048) and ragged ones, at ViLT-B/32's widths, BERT-large's
# (H 1,024, I 4,096) and H 512 / I 2,048; two launches give the same bits.
CORE_Q8_WIDTHS = [(768, 3072), (1024, 4096), (512, 2048)]


def _core_operands(dev, rows, h, i, seed):
    from vault_tpu_torch.ops.quantize import quantize_weight

    g = torch.Generator(device=dev).manual_seed(seed)
    rnd = lambda *s, std=1.0, mean=0.0: (torch.randn(s, generator=g, device=dev) * std
                                         + mean).to(torch.bfloat16)
    o = dict(gamma=rnd(h, std=0.1, mean=1.0), beta=rnd(h, std=0.1), b1=rnd(i, std=0.02),
             b2=rnd(h, std=0.02), x=rnd(rows, h), wqkv=rnd(h, 3 * h, std=0.02),
             bqkv=rnd(3 * h, std=0.02))
    for name, shape in (("w1", (h, i)), ("w2", (i, h))):
        q, sc = quantize_weight(rnd(*shape, std=0.02))
        o[name + "q"], o["s" + name[1:]] = q, sc.reshape(-1)
    return o


@pytest.mark.parametrize("act", ["gelu", "gelu_new", "gelu_pytorch_tanh", "relu"])
@pytest.mark.parametrize("h,i", CORE_Q8_WIDTHS)
@pytest.mark.parametrize("rows", [2048, 77, 37])
def test_q8_preln_block_on_the_core(dev, act, h, i, rows):
    """The bf16 pre-LN q8 block against mlp_block_q8_plain within the bf16
    forward limit, its repeat bit-equal, and bit-equal to the bf16 block on
    the same weights dequantized by a pass of their own (the same tiles, the
    same bf16 weights: the route is the pass, then the bf16 block)."""
    from vault_tpu_torch.ops import cuda_gemm as cg
    from vault_tpu_torch.ops import cuda_mlp as cm

    assert cm.mlp_route(torch.bfloat16, True, False) == "wgmma"
    o = _core_operands(dev, rows, h, i, seed=h + i + rows)
    args = [o[k] for k in W8A8_ARGS]
    n = cm.fused_mlp_block_fwd_q8.launches
    out, again = cm.fused_mlp_block_fwd_q8(*args, act=act), cm.fused_mlp_block_fwd_q8(*args, act=act)
    ref = cm.mlp_block_q8_plain(*args, act=act)
    via_pass = cm.fused_mlp_block_fwd(o["gamma"], o["beta"], cg.dequant_bf16(o["w1q"], o["s1"]),
                                      o["b1"], cg.dequant_bf16(o["w2q"], o["s2"]), o["b2"],
                                      o["x"], act=act)
    torch.cuda.synchronize()
    assert cm.fused_mlp_block_fwd_q8.launches == n + 2
    assert out.shape == (rows, h) and out.dtype == torch.bfloat16
    err = (out.float() - ref.float()).abs().max().item()
    assert err <= LIMITS[torch.bfloat16], err
    assert torch.equal(out, again)
    assert torch.equal(out, via_pass)


@pytest.mark.parametrize("act", ["gelu", "gelu_new", "gelu_pytorch_tanh", "relu"])
@pytest.mark.parametrize("h,i", CORE_Q8_WIDTHS)
@pytest.mark.parametrize("rows", [320, 77, 37])
def test_q8_postln_block_on_the_core(dev, act, h, i, rows):
    """The bf16 post-LN q8 block (BERT's layers in a w8 model; 320 rows at
    batch 8) against mlp_postln_q8_plain within the bf16 forward limit, its
    repeat bit-equal, and bit-equal to the bf16 post-LN block on the same
    weights dequantized by a pass of their own."""
    from vault_tpu_torch.ops import cuda_gemm as cg
    from vault_tpu_torch.ops import cuda_mlp as cm

    assert cm.mlp_route(torch.bfloat16, True, True) == "wgmma"
    o = _core_operands(dev, rows, h, i, seed=h + i + rows + 1)
    args = [o[k] for k in W8A8_ARGS]
    fn = cm.fused_mlp_postln_fwd_q8
    n = fn.launches
    out, again = fn(*args, act=act), fn(*args, act=act)
    ref = cm.mlp_postln_q8_plain(*args, act=act)
    via_pass = cm.fused_mlp_postln_fwd(o["gamma"], o["beta"],
                                       cg.dequant_bf16(o["w1q"], o["s1"]), o["b1"],
                                       cg.dequant_bf16(o["w2q"], o["s2"]), o["b2"], o["x"],
                                       act=act)
    torch.cuda.synchronize()
    assert fn.launches == n + 2
    assert out.shape == (rows, h) and out.dtype == torch.bfloat16
    err = (out.float() - ref.float()).abs().max().item()
    assert err <= LIMITS[torch.bfloat16], err
    assert torch.equal(out, again)
    assert torch.equal(out, via_pass)


@pytest.mark.parametrize("h", [768, 1024, 512])
@pytest.mark.parametrize("rows", [2048, 77, 37])
def test_ln_qkv_on_the_core(dev, h, rows):
    """The bf16 LN->QKV kernel on the core against ln_qkv_plain within 2^-7
    of the output's scale; its repeat bit-equal."""
    from vault_tpu_torch.ops import cuda_ln_qkv as cl

    assert cl.ln_qkv_route(torch.bfloat16) == "wgmma"
    o = _core_operands(dev, rows, h, 64, seed=h + rows)
    args = [o[k] for k in ("gamma", "beta", "wqkv", "bqkv", "x")]
    n = cl.fused_ln_qkv_fwd.launches
    out, again = cl.fused_ln_qkv_fwd(*args), cl.fused_ln_qkv_fwd(*args)
    ref = cl.ln_qkv_plain(*args)
    torch.cuda.synchronize()
    assert cl.fused_ln_qkv_fwd.launches == n + 2
    assert out.shape == (rows, 3 * h) and out.dtype == torch.bfloat16
    err = (out.float() - ref.float()).abs().max().item()
    assert err <= LNQKV_BF16_LIMIT * max(1.0, ref.float().abs().max().item()), err
    assert torch.equal(out, again)


@pytest.mark.parametrize("k,n", [(256, 192), (256, 208), (768, 3072), (3072, 768)])
def test_dequantizing_stage_is_exact(dev, k, n):
    """The dequantization pass the w8 pre-LN block runs must equal
    bf16(float(q) * s) bit for bit.  Each column has its own scale and every
    code from -128 to 127 occurs (-128 in the first row of every column), so
    a slip in the chunk order or the scale index shows; N = 208 is not a
    multiple of 32 or 64; (768, 3,072) and (3,072, 768) are W1 and W2 of
    ViLT-B/32."""
    from vault_tpu_torch.ops import cuda_gemm as cg

    g = torch.Generator(device=dev).manual_seed(k + n)
    q = torch.randint(-128, 128, (k, n), generator=g, device=dev).to(torch.int8)
    q[0] = -128
    q[1] = 127
    s = (2.0 ** -7) * (1.0 + torch.arange(n, device=dev, dtype=torch.float32) / n)
    n0 = cg.dequant_bf16.launches
    out = cg.dequant_bf16(q, s)
    torch.cuda.synchronize()
    assert cg.dequant_bf16.launches == n0 + 1
    assert torch.equal(out, cg.dequant_plain(q, s))


def test_gradients_flow_through_the_q8_kernels(dev):
    """The q8 dispatch's backward is autograd of the plain composition on
    the same weights: gradients to the LN, scales, biases and x."""
    from vault_tpu_torch.ops import cuda_mlp as cm

    o = _int8_operands(dev, 64, torch.float32, i=256)
    for postln in (False, True):
        block = cm.fused_mlp_postln_block if postln else cm.fused_mlp_block
        plain = cm._mlp_postln_plain if postln else cm._mlp_block_plain
        grads = []
        for fn in (block, plain):
            leaves = {k: o[k].clone().requires_grad_()
                      for k in ("gamma", "beta", "s1", "b1", "s2", "b2", "x")}
            out = fn({"scale": leaves["gamma"], "bias": leaves["beta"]},
                     {"w_q": o["w1q"], "w_scale": leaves["s1"], "b": leaves["b1"]},
                     {"w_q": o["w2q"], "w_scale": leaves["s2"], "b": leaves["b2"]},
                     leaves["x"], 1e-12, "gelu")
            out.square().sum().backward()
            grads.append({k: v.grad for k, v in leaves.items()})
        for k in grads[0]:
            scale = max(1.0, grads[1][k].abs().max().item())
            assert (grads[0][k] - grads[1][k]).abs().max().item() <= 1e-3 * scale, k


def _gqa_case(dev, b, h, g, l, d, dtype, seed):
    """Head views of (B, L, heads D) projections and a causal and padding
    bias: row 1 padded on the right, row 2 on the left."""
    from vault_tpu_torch.ops.attention import split_heads

    gen = torch.Generator(device=dev).manual_seed(seed)
    q = split_heads(torch.randn((b, l, h * d), generator=gen, device=dev).to(dtype), h)
    k, v = (split_heads(torch.randn((b, l, g * d), generator=gen, device=dev).to(dtype), g)
            for _ in range(2))
    pad = torch.ones((b, l), device=dev)
    pad[1, (l + 1) // 2:] = 0
    pad[2, :l // 3] = 0
    keep = torch.tril(torch.ones((l, l), device=dev))[None, None] * pad[:, None, None, :]
    return q, k, v, ((1.0 - keep) * torch.finfo(torch.float32).min).contiguous()


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("l", [1, 40, 77, 256, 300])
@pytest.mark.parametrize("rep", [1, 4])
@pytest.mark.parametrize("d", [32, 64, 96, 128])
def test_attention_gqa_kernel_matches_plain(dev, dtype, l, rep, d):
    from vault_tpu_torch.ops import cuda_attention as ca

    q, k, v, bias = _gqa_case(dev, 3, 2 * rep, 2, l, d, dtype, seed=l)
    n = ca.fused_attention_gqa.launches
    out, again = ca.fused_attention_gqa(q, k, v, bias), ca.fused_attention_gqa(q, k, v, bias)
    ref = ca.attention_gqa_plain(q, k, v, bias)
    torch.cuda.synchronize()
    assert ca.fused_attention_gqa.launches == n + 2
    assert out.shape == q.shape and torch.isfinite(out.float()).all()
    err = (out.float() - ref.float()).abs().max().item()
    assert err <= LIMITS[dtype], err
    if dtype == torch.bfloat16:
        assert _attention_row_err(out, ref) <= ATTENTION_ROW_LIMIT
    assert torch.equal(out, again)


def test_attention_gqa_wrapper_rejects_and_differentiates(dev):
    from vault_tpu_torch.ops import cuda_attention as ca

    q, k, v, bias = _gqa_case(dev, 3, 8, 2, 40, 128, torch.float32, seed=9)
    n = ca.fused_attention_gqa.launches
    for bad in ((q[..., :48], k[..., :48], v[..., :48], bias),        # head dim 48
                (q, k[:, :1].expand(3, 3, 40, 128), v, bias),          # 3 does not divide 8
                (q, k, v, bias[:, :, :1]),                             # a key bias
                (q, k, v, bias.to(torch.bfloat16)),
                (q.to(torch.float16), k.to(torch.float16), v.to(torch.float16), bias)):
        with pytest.raises((ValueError, TypeError)):
            ca.fused_attention_gqa(*bad)
    assert ca.fused_attention_gqa.launches == n
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    ca.fused_attention_gqa(*leaves, bias).square().sum().backward()
    ref = [t.clone().requires_grad_() for t in (q, k, v)]
    ca.attention_gqa_plain(*ref, bias).square().sum().backward()
    for a, b in zip(leaves, ref):
        assert (a.grad - b.grad).abs().max().item() <= 1e-3


def _swiglu_operands(dev, i=2048, seed=6, h=4096):
    """The block's weights as the tower holds them: int8 codes K-major
    (ops/quantize.py k_major), fp32 scales."""
    from vault_tpu_torch.ops.quantize import k_major, quantize_weight

    g = torch.Generator(device=dev).manual_seed(seed)
    o = {"ln_w": 1.0 + 0.1 * torch.randn(h, generator=g, device=dev)}
    for name, shape in (("g", (h, i)), ("u", (h, i)), ("d", (i, h))):
        q, s = quantize_weight(torch.randn(shape, generator=g, device=dev) * 0.02)
        o["w" + name + "q"], o["s" + name] = k_major(q), s
    return o, g


SWIGLU_ARGS = ("ln_w", "wgq", "sg", "wuq", "su", "wdq", "sd")


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("rows", [1, 77, 320, 640])
@pytest.mark.parametrize("h,i", [(4096, 2048), (2048, 8192), (512, 1536)])
def test_swiglu_w8a8_kernel_matches_plain(dev, dtype, rows, h, i):
    """Bit-equal to ``swiglu_block_w8a8_plain`` (two I-tiles at H 4,096,
    fourteen at the tower's width in chip_smoke.py; Llama-3.2-1B's widths,
    eight; H 512 / I 1,536, two tiles of 768), through the wrapper and
    through the dispatch; the gradient is that of the per-row composition."""
    from vault_tpu_torch.ops import cuda_swiglu as cs

    o, g = _swiglu_operands(dev, i=i, h=h)
    x = torch.randn((rows, h), generator=g, device=dev).to(dtype)
    args = [o[k] for k in SWIGLU_ARGS] + [x]
    n = cs.fused_swiglu_block_fwd_w8a8.launches
    out, again = cs.fused_swiglu_block_fwd_w8a8(*args), cs.fused_swiglu_block_fwd_w8a8(*args)
    params = [{"w_q8": o["w" + k + "q"], "w_scale": o["s" + k]} for k in "gud"]
    xg = x.clone().requires_grad_()
    via_block = cs.swiglu_block(o["ln_w"], *params, xg)
    ref = cs.swiglu_block_w8a8_plain(*args)
    torch.cuda.synchronize()
    assert cs.fused_swiglu_block_fwd_w8a8.launches == n + 3
    assert torch.equal(out, ref), (out.float() - ref.float()).abs().max().item()
    assert torch.equal(out, again) and torch.equal(out, via_block)
    via_block.float().square().sum().backward()
    xr = x.clone().requires_grad_()
    cs.swiglu_block_plain(o["ln_w"], *params, xr).float().square().sum().backward()
    assert torch.isfinite(xg.grad.float()).all() and xg.grad.abs().max() > 0
    scale = max(1.0, xr.grad.float().abs().max().item())
    assert (xg.grad.float() - xr.grad.float()).abs().max().item() <= 0.25 * scale


def test_swiglu_wrapper_rejects_what_the_kernel_does_not_take(dev):
    from vault_tpu_torch.ops import cuda_swiglu as cs

    o, g = _swiglu_operands(dev, i=1024)
    x = torch.randn((8, 4096), generator=g, device=dev).to(torch.bfloat16)
    args = [o[k] for k in SWIGLU_ARGS] + [x]
    # a K-major slice: the first `cols` output columns of a code matrix
    cols = lambda q, c: q[:, :c].t().contiguous().t()
    bad = {"bf16 norm weight": [o["ln_w"].to(torch.bfloat16)] + args[1:],
           "fp weights": [args[0], o["wgq"].float()] + args[2:],
           "row-major codes": [args[0], o["wgq"].contiguous()] + args[2:],
           "I-tile not a multiple of 128": [args[0], cols(o["wgq"], 1000),
                                            o["sg"][:, :1000].contiguous(),
                                            cols(o["wuq"], 1000), o["su"][:, :1000].contiguous(),
                                            o["wdq"][:1000], args[6], x],
           "H 704": [args[0][:704].contiguous(), o["wgq"][:704], args[2], o["wuq"][:704],
                     args[4], cols(o["wdq"], 704), o["sd"][:, :704].contiguous(),
                     x[:, :704].contiguous()],
           "fp16 x": args[:7] + [x.to(torch.float16)],
           "cpu x": args[:7] + [x.cpu()]}
    n = cs.fused_swiglu_block_fwd_w8a8.launches
    for what, a in bad.items():
        with pytest.raises((ValueError, TypeError)):
            cs.fused_swiglu_block_fwd_w8a8(*a)
    assert cs.fused_swiglu_block_fwd_w8a8.launches == n


def test_llama_tower_forward_launches_each_kernel_per_layer(dev, monkeypatch):
    """Two layers at the Llama-3-8B widths over a small vocabulary, w8a8,
    feeding a tiny ViLT: one forward launches the GQA and SwiGLU kernels
    once per layer, and equals the same forward with the SwiGLU wrapper
    swapped for its plain version."""
    from vault_tpu_torch.config import tiny_vilt_config
    from vault_tpu_torch.models.llama import LlamaConfig
    from vault_tpu_torch.models.vault import VaultWithLlamaTower
    from vault_tpu_torch.ops import cuda_attention as ca
    from vault_tpu_torch.ops import cuda_swiglu as cs

    cfg = LlamaConfig(vocab_size=512, num_hidden_layers=2, attn_impl="pallas",
                      mlp_impl="pallas")
    model = VaultWithLlamaTower(tiny_vilt_config(), cfg, dtype=torch.bfloat16,
                                quantize="w8a8", use_pallas=False)
    batch = {"input_ids": torch.randint(1, 512, (3, 8)),
             "attention_mask": torch.ones((3, 8), dtype=torch.int64),
             "token_type_ids": torch.zeros((3, 8), dtype=torch.int64),
             "pixel_values": torch.randn((3, 3, 64, 64)),
             "pixel_mask": torch.ones((3, 64, 64), dtype=torch.int64)}
    batch["attention_mask"][1, 5:] = 0
    fns = (ca.fused_attention_gqa, cs.fused_swiglu_block_fwd_w8a8, ca.fused_attention)
    before = [f.launches for f in fns]
    with torch.inference_mode():
        out = model(batch)
    assert [f.launches - b for f, b in zip(fns, before)] == [2, 2, 0]
    assert torch.isfinite(out.pooler_output.float()).all()
    monkeypatch.setattr(cs, "fused_swiglu_block_fwd_w8a8", cs.swiglu_block_w8a8_plain)
    with torch.inference_mode():
        assert torch.equal(model(batch).last_hidden_state, out.last_hidden_state)


def test_w8_model_forward_launches_each_kernel_per_layer(dev):
    """A wide two-layer VAuLT, bf16, quantized w8: "auto" launches each q8
    kernel once per layer of its tower and stays close to the plain path."""
    from vault_tpu_torch.config import VaultConfig, tiny_text_config, tiny_vilt_config
    from vault_tpu_torch.models.vault import VaultForClassification
    from vault_tpu_torch.ops import cuda_attention as ca
    from vault_tpu_torch.ops import cuda_mlp as cm

    wide = dict(hidden_size=768, num_attention_heads=12, intermediate_size=1536)
    cfg = VaultConfig(vilt=tiny_vilt_config(**wide), text_tower=tiny_text_config(**wide))
    model = VaultForClassification(cfg, dtype=torch.bfloat16).quantize("w8")
    assert model.use_pallas == "auto"
    batch = {"input_ids": torch.randint(1, 99, (2, 8)),
             "attention_mask": torch.ones((2, 8), dtype=torch.int64),
             "token_type_ids": torch.zeros((2, 8), dtype=torch.int64),
             "pixel_values": torch.randn((2, 3, 64, 64)),
             "pixel_mask": torch.ones((2, 64, 64), dtype=torch.int64)}
    fns = (ca.fused_attention, cm.fused_mlp_block_fwd_q8, cm.fused_mlp_postln_fwd_q8,
           cm.fused_mlp_block_fwd, cm.fused_mlp_postln_fwd)
    before = [f.launches for f in fns]
    with torch.inference_mode():
        out = model(batch)
        plain = model(batch, use_pallas=False)
    assert [f.launches - b for f, b in zip(fns, before)] == [4, 2, 2, 0, 0]
    assert (out.float() - plain.float()).abs().max().item() < 2e-2


def test_int8_wrappers_reject_what_the_kernels_do_not_take(dev):
    from vault_tpu_torch.ops import cuda_ln_qkv as cl
    from vault_tpu_torch.ops import cuda_mlp as cm

    o = _int8_operands(dev, 16, torch.bfloat16, i=256, w8a8=True)
    args = [o[k] for k in W8A8_ARGS]
    bad = {
        "row-major codes": args[:2] + [o["w1q"].contiguous()] + args[3:],
        "fp weights": [o["gamma"], o["beta"], o["w1q"].to(torch.bfloat16)] + args[3:],
        "bf16 scales": args[:3] + [o["s1"].to(torch.bfloat16)] + args[4:],
        "fp32 x": args[:8] + [o["x"].float()],
        "x not contiguous": args[:8] + [o["x"].t().contiguous().t()],
        "I multiple": args[:2] + [o["w1q"][:, :200].contiguous(), o["s1"][:200].contiguous(),
                                  o["b1"][:200].contiguous(), o["w2q"][:200].contiguous()]
        + args[6:],
        "cpu x": args[:8] + [o["x"].cpu()],
    }
    counts = (cm.fused_mlp_block_fwd_w8a8.launches, cm.fused_mlp_postln_fwd_w8a8.launches)
    for fn in (cm.fused_mlp_block_fwd_w8a8, cm.fused_mlp_postln_fwd_w8a8):
        for what, a in bad.items():
            with pytest.raises((ValueError, TypeError)):
                fn(*a)
        with pytest.raises(ValueError, match="activation"):
            fn(*args, act="swish")
    assert counts == (cm.fused_mlp_block_fwd_w8a8.launches,
                      cm.fused_mlp_postln_fwd_w8a8.launches)
    n = cl.fused_ln_qkv_fwd_w8a8.launches
    for a in ([o["gamma"], o["beta"], o["wqkv"], o["sqkv"], o["bqkv"], o["x"]],
              [o["gamma"], o["beta"], o["wqkvq"].contiguous(), o["sqkv"], o["bqkv"], o["x"]],
              [o["gamma"], o["beta"], o["wqkvq"], o["sqkv"], o["bqkv"].float(), o["x"]],
              [o["gamma"], o["beta"], o["wqkvq"], o["sqkv"], o["bqkv"], o["x"].cpu()]):
        with pytest.raises((ValueError, TypeError)):
            cl.fused_ln_qkv_fwd_w8a8(*a)
    with pytest.raises((ValueError, TypeError)):
        cl.fused_ln_qkv_fwd(o["gamma"], o["beta"], o["wqkvq"], o["bqkv"], o["x"])
    assert cl.fused_ln_qkv_fwd_w8a8.launches == n


def test_w8a8_model_forward_launches_each_kernel_per_layer(dev, monkeypatch):
    """A wide two-layer VAuLT, bf16, quantized w8a8: one forward launches
    each int8 kernel once per layer of its tower, equals the same forward
    with the int8 kernels' plain versions in their wrappers' place, and
    stays close to the plain path of the same quantized model."""
    from vault_tpu_torch.config import VaultConfig, tiny_text_config, tiny_vilt_config
    from vault_tpu_torch.models.vault import VaultForClassification
    from vault_tpu_torch.ops import cuda_attention as ca
    from vault_tpu_torch.ops import cuda_ln_qkv as cl
    from vault_tpu_torch.ops import cuda_mlp as cm

    wide = dict(hidden_size=768, num_attention_heads=12, intermediate_size=1536)
    cfg = VaultConfig(vilt=tiny_vilt_config(**wide), text_tower=tiny_text_config(**wide))
    model = VaultForClassification(cfg, dtype=torch.bfloat16).quantize("w8a8")
    assert model.use_pallas == "fuselnqkv+fusemlp+batched"
    batch = {"input_ids": torch.randint(1, 99, (2, 8)),
             "attention_mask": torch.ones((2, 8), dtype=torch.int64),
             "token_type_ids": torch.zeros((2, 8), dtype=torch.int64),
             "pixel_values": torch.randn((2, 3, 64, 64)),
             "pixel_mask": torch.ones((2, 64, 64), dtype=torch.int64)}
    fns = (ca.fused_attention, cl.fused_ln_qkv_fwd_w8a8, cm.fused_mlp_block_fwd_w8a8,
           cm.fused_mlp_postln_fwd_w8a8, cm.fused_mlp_block_fwd, cm.fused_mlp_postln_fwd)
    before = [f.launches for f in fns]
    with torch.inference_mode():
        out = model(batch)
        plain = model(batch, use_pallas=False)
    assert [f.launches - b for f, b in zip(fns, before)] == [4, 2, 2, 2, 0, 0]
    assert (out.float() - plain.float()).abs().max().item() < 2e-2
    monkeypatch.setattr(cl, "fused_ln_qkv_fwd_w8a8", cl.ln_qkv_w8a8_plain)
    monkeypatch.setattr(cm, "fused_mlp_block_fwd_w8a8", cm.mlp_block_w8a8_plain)
    monkeypatch.setattr(cm, "fused_mlp_postln_fwd_w8a8", cm.mlp_postln_w8a8_plain)
    with torch.inference_mode():
        assert torch.equal(model(batch), out)
