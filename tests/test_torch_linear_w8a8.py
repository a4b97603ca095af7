"""The w8a8 dense layer's dispatch (``ops/nn.py`` ``linear`` ->
``ops/cuda_linear.py``) and the K-major layout of every w8a8 code matrix
(``ops/quantize.py`` ``K_MAJOR_SUBLAYERS``), on the CPU.

The kernel itself runs only on the card (``tests/test_torch_cuda.py``
holds it bit-equal to :func:`~vault_tpu_torch.ops.nn.linear_w8a8_plain`).
Here: which calls it would take (:func:`cuda_linear.kernel_takes`, on a
stand-in for a card tensor); that the CPU, a gradient to x and every plain
version and reference composition keep the composition, whatever the
predicate says; that quantizing lays the attention projections' codes out
K-major with the row-major quantization's values; and that the VAuLT and
Llama forwards give the same bits on either layout.
"""

import contextlib
from types import SimpleNamespace

import pytest
import torch

from vault_tpu_torch.config import VaultConfig, tiny_text_config, tiny_vilt_config
from vault_tpu_torch.models import llama as tllama
from vault_tpu_torch.models.vault import VaultForClassification
from vault_tpu_torch.ops import cuda_linear as clin
from vault_tpu_torch.ops import cuda_ln_qkv as cl
from vault_tpu_torch.ops import cuda_mlp as cm
from vault_tpu_torch.ops import cuda_swiglu as cs
from vault_tpu_torch.ops import nn as tnn
from vault_tpu_torch.ops import quantize as tq

BF = torch.bfloat16


def _codes(k, n, seed=0, k_major=True):
    g = torch.Generator().manual_seed(seed)
    q, s = tq.quantize_weight(torch.randn((k, n), generator=g) * 0.05)
    return (tq.k_major(q) if k_major else q), s


def _card_x(k=256, rows=4, dtype=BF, requires_grad=False):
    """What ``kernel_takes`` reads of x, as a tensor on the card shows it."""
    return SimpleNamespace(is_cuda=True, dtype=dtype, requires_grad=requires_grad,
                           shape=(rows, k), numel=lambda: rows * k)


@contextlib.contextmanager
def _operator_refused(monkeypatch):
    """``kernel_takes`` says yes to every call and the operator raises: a
    function that reaches the operator through ``linear`` fails."""
    def refuse(*ts, **kw):
        raise AssertionError("reached vault_tpu_torch::linear_w8a8")

    monkeypatch.setattr(clin, "kernel_takes", lambda *a: True)
    monkeypatch.setattr(clin, "LINEAR_W8A8", refuse)
    yield


# (what changes from a call the kernel takes, whether it then takes it)
TAKES = {
    "bf16 x, no gradient": ({}, True),
    "no bias": (dict(b=None), True),
    "K 8,192": (dict(k=8192), True),
    "x needs a gradient": (dict(requires_grad=True), False),
    "fp32 x": (dict(dtype=torch.float32), False),
    "row-major codes": (dict(k_major=False), False),
    "K 576 (SmolLM)": (dict(k=576), False),
    "K 8,320": (dict(k=8320), False),
    "N 200": (dict(n=200), False),
    "fp32 bias": (dict(b=torch.float32), False),
    "fp32 x on the host": (dict(on_host=True), False),
}


@pytest.mark.parametrize("case", list(TAKES))
def test_kernel_takes_only_what_it_reads(case):
    """bf16 on the card with no gradient to x, K-major codes, K a multiple
    of 128 up to 8,192 and N a multiple of 128, fp32 scales and a bf16 bias
    or none; anything else keeps the composition."""
    change, want = TAKES[case]
    k, n = change.get("k", 256), change.get("n", 128)
    w, s = _codes(k, n, k_major=change.get("k_major", True))
    b = change.get("b", BF)
    b = None if b is None else torch.zeros(n, dtype=b)
    x = _card_x(k, dtype=change.get("dtype", BF), requires_grad=change.get("requires_grad", False))
    if change.get("on_host"):
        x = torch.zeros((4, k), dtype=BF)
    assert clin.kernel_takes(x, w, s, b) is want
    if change.get("requires_grad"):
        with torch.no_grad():  # no gradient is taken: the kernel runs
            assert clin.kernel_takes(x, w, s, b) is True


@pytest.mark.parametrize("dtype", [BF, torch.float32])
@pytest.mark.parametrize("bias", [True, False])
@pytest.mark.parametrize("k_major", [True, False])
def test_linear_keeps_the_composition_on_the_cpu(monkeypatch, dtype, bias, k_major):
    """On the CPU ``linear``'s w8a8 branch is ``linear_w8a8_plain`` bit for
    bit, on either layout, and never calls the operator."""
    w, s = _codes(256, 128, seed=1, k_major=k_major)
    g = torch.Generator().manual_seed(2)
    x = torch.randn((3, 5, 256), generator=g).to(dtype)
    b = (torch.randn(128, generator=g) * 0.1).to(dtype) if bias else None
    params = {"w_q8": w, "w_scale": s, **({"b": b} if bias else {})}
    monkeypatch.setattr(clin, "LINEAR_W8A8", None)  # calling it would raise
    out = tnn.linear(params, x)
    assert out.dtype == dtype and out.shape == (3, 5, 128)
    assert torch.equal(out, tnn.linear_w8a8_plain(x, w, s, b))
    assert torch.equal(out, tnn.linear_plain(params, x))


def test_linear_keeps_the_composition_under_gradient(monkeypatch):
    """A gradient through the scales and to x comes from the composition;
    the result and the gradients are the plain version's."""
    w, s = _codes(256, 128, seed=3)
    g = torch.Generator().manual_seed(4)
    x = torch.randn((6, 256), generator=g).requires_grad_()
    s = s.clone().requires_grad_()
    monkeypatch.setattr(clin, "LINEAR_W8A8", None)
    out = tnn.linear({"w_q8": w, "w_scale": s}, x)
    gx, gs = torch.autograd.grad(out.square().sum(), (x, s))
    x2, s2 = x.detach().requires_grad_(), s.detach().requires_grad_()
    ref = tnn.linear_w8a8_plain(x2, w, s2)
    rx, rs = torch.autograd.grad(ref.square().sum(), (x2, s2))
    assert torch.equal(out, ref) and torch.equal(gx, rx) and torch.equal(gs, rs)


# what the kernel wrapper refuses before any launch, and the error it raises
REFUSED = {
    "CPU tensors": (dict(), ValueError, "CUDA tensors"),
    "fp32 x": (dict(dtype=torch.float32), TypeError, "bfloat16"),
    "row-major codes": (dict(k_major=False), ValueError, "K-major"),
    "K 576": (dict(k=576), ValueError, "multiple of 128"),
    "a bias of another width": (dict(b=64), ValueError, "b has shape"),
}


@pytest.mark.parametrize("case", list(REFUSED))
def test_kernel_wrapper_never_falls_back(case):
    """``linear_w8a8`` raises on anything its kernel does not take; only
    ``linear`` chooses the composition."""
    change, error, match = REFUSED[case]
    k = change.get("k", 256)
    w, s = _codes(k, 128, k_major=change.get("k_major", True))
    x = torch.zeros((5, k), dtype=change.get("dtype", BF))
    b = torch.zeros(change.get("b", 128), dtype=BF)
    with pytest.raises(error, match=match):
        clin.linear_w8a8(x, w, s, b)


def _qkv_operands(h=128, rows=7, seed=5):
    g = torch.Generator().manual_seed(seed)
    wq, sq = _codes(h, 3 * h, seed=seed)
    return dict(gamma=torch.ones(h, dtype=BF), beta=torch.zeros(h, dtype=BF), wqkv_q=wq,
                sqkv=sq, bqkv=(torch.randn(3 * h, generator=g) * 0.1).to(BF),
                x=torch.randn((rows, h), generator=g).to(BF))


def _mlp_operands(h=128, i=256, rows=7, seed=6):
    g = torch.Generator().manual_seed(seed)
    w1q, s1 = _codes(h, i, seed=seed)
    w2q, s2 = _codes(i, h, seed=seed + 1)
    return dict(gamma=torch.ones(h, dtype=BF), beta=torch.zeros(h, dtype=BF), w1q=w1q, s1=s1,
                b1=torch.zeros(i, dtype=BF), w2q=w2q, s2=s2, b2=torch.zeros(h, dtype=BF),
                x=torch.randn((rows, h), generator=g).to(BF))


def _swiglu_operands(h=128, i=256, rows=7, seed=7):
    g = torch.Generator().manual_seed(seed)
    (wgq, sg), (wuq, su), (wdq, sd) = (_codes(h, i, seed=seed), _codes(h, i, seed=seed + 1),
                                       _codes(i, h, seed=seed + 2))
    return dict(ln_w=torch.ones(h), wgq=wgq, sg=sg, wuq=wuq, su=su, wdq=wdq, sd=sd,
                x=torch.randn((rows, h), generator=g).to(BF))


def _params(w, s, b=None):
    return {"w_q8": w, "w_scale": s, **({} if b is None else {"b": b})}


# Every plain version and reference composition that reaches linear's w8a8
# branch, called on bf16 operands the kernel would take on the card.
PLAIN = {
    "ln_qkv_w8a8_plain": lambda: cl.ln_qkv_w8a8_plain(**_qkv_operands()),
    "_ln_qkv_w8a8_ref": lambda: cl._ln_qkv_w8a8_ref(**_qkv_operands()),
    "swiglu _w8a8_ref": lambda: cs._w8a8_ref(**_swiglu_operands()),
    "swiglu_block_plain": lambda: (lambda o: cs.swiglu_block_plain(
        o["ln_w"], _params(o["wgq"], o["sg"]), _params(o["wuq"], o["su"]),
        _params(o["wdq"], o["sd"]), o["x"]))(_swiglu_operands()),
    "swiglu_block_w8a8_plain": lambda: cs.swiglu_block_w8a8_plain(**_swiglu_operands()),
    "mlp_block_w8a8_plain": lambda: cm.mlp_block_w8a8_plain(**_mlp_operands()),
    "mlp_postln_w8a8_plain": lambda: cm.mlp_postln_w8a8_plain(**_mlp_operands()),
    "mlp w8a8 reference, pre-LN": lambda: cm._plain_on_quantized(
        False, "w_q8", *_mlp_operands().values()),
    "mlp w8a8 reference, post-LN": lambda: cm._plain_on_quantized(
        True, "w_q8", *_mlp_operands().values()),
    "linear_w8a8_plain": lambda: tnn.linear_w8a8_plain(
        torch.ones((7, 128), dtype=BF), *_codes(128, 128)),
}


@pytest.mark.parametrize("name", list(PLAIN))
def test_plain_versions_never_reach_the_operator(monkeypatch, name):
    """With the operator refused and every call admitted, the plain versions
    and references still run: they call the composition by name."""
    with _operator_refused(monkeypatch):
        out = PLAIN[name]()
    assert torch.isfinite(out.float()).all()


def test_linear_reaches_the_operator_where_the_kernel_takes_the_call(monkeypatch):
    """The control of the test above: ``linear`` itself does reach it."""
    w, s = _codes(128, 128)
    with _operator_refused(monkeypatch), pytest.raises(AssertionError, match="reached"):
        tnn.linear(_params(w, s), torch.ones((7, 128), dtype=BF))


def _tree(names, shape=(128, 256), seed=8):
    g = torch.Generator().manual_seed(seed)
    return {n: {"w": torch.randn(shape, generator=g) * 0.05,
                "b": torch.zeros(shape[1])} for n in names}


@pytest.mark.parametrize("form", ["dict", "module"])
@pytest.mark.parametrize("name", ["q", "k", "v", "attn_out", "o"])
def test_w8a8_attention_codes_are_held_k_major_with_the_same_values(form, name):
    """``quantize_model_params(..., "w8a8")`` holds the attention
    projections' codes K-major (a transposed view of contiguous storage),
    with the values and scales of the row-major quantization; w8 keeps
    them row-major."""
    tree = _tree([name])
    want_q, want_s = tq.quantize_weight(tree[name]["w"])
    if form == "module":
        tree = tnn.ParamDict(**{name: tnn.ParamDict(**tree[name])})
    out = tq.quantize_model_params(tree, mode="w8a8")
    q, s = out[name]["w_q8"], out[name]["w_scale"]
    assert tq.is_k_major(q) and not q.is_contiguous()
    assert q.dtype == torch.int8 and q.shape == want_q.shape
    assert torch.equal(q, want_q) and torch.equal(s, want_s)
    w8 = tq.quantize_model_params(_tree([name]), mode="w8")[name]["w_q"]
    assert w8.is_contiguous() and torch.equal(w8, want_q)


def _row_major(module):
    """Every w8a8 code matrix of ``module`` replaced, in place, by a
    row-major copy (the layout before the attention projections were held
    K-major); returns how many."""
    n = 0
    for mod in module.modules():
        if isinstance(mod, tnn.ParamDict) and "w_q8" in mod:
            mod.w_q8 = torch.nn.Parameter(mod.w_q8.contiguous(), requires_grad=False)
            n += 1
    return n


def test_w8a8_vault_forward_is_bit_equal_on_either_layout():
    cfg = VaultConfig(vilt=tiny_vilt_config(), text_tower=tiny_text_config())
    model = VaultForClassification(cfg, device="cpu", dtype=BF, seed=0).quantize("w8a8")
    layers = model.vilt.layers[0]
    assert all(tq.is_k_major(layers[n].w_q8) for n in ("q", "k", "v", "attn_out"))
    g = torch.Generator().manual_seed(9)
    am = torch.ones((3, 8), dtype=torch.int64)
    am[1, 5:] = 0
    batch = {"input_ids": torch.randint(1, 99, (3, 8), generator=g),
             "attention_mask": am,
             "token_type_ids": torch.randint(0, 2, (3, 8), generator=g),
             "pixel_values": torch.randn((3, 3, 64, 64), generator=g).to(BF),
             "pixel_mask": torch.ones((3, 64, 64), dtype=torch.int64)}
    with torch.inference_mode():
        k_major = model(batch)
    assert _row_major(model) == 6 * (cfg.vilt.num_hidden_layers
                                     + cfg.text_tower.num_hidden_layers)
    with torch.inference_mode():
        row_major = model(batch)
    assert torch.isfinite(k_major.float()).all() and torch.equal(k_major, row_major)


def test_w8a8_llama_forward_is_bit_equal_on_either_layout():
    cfg = tllama.tiny_llama_config()
    tower = tllama.init_llama(torch.Generator().manual_seed(10), cfg, BF, "w8a8")
    assert all(tq.is_k_major(lp[n]["w_q8"]) for lp in tower["layers"]
               for n in ("q", "k", "v", "o", "gate", "up", "down"))
    g = torch.Generator().manual_seed(11)
    ids = torch.randint(1, cfg.vocab_size, (3, 9), generator=g)
    mask = torch.ones((3, 9), dtype=torch.int64)
    mask[2, 6:] = 0
    with torch.inference_mode():
        k_major = tllama.llama_apply(tower, cfg, ids, mask)
    assert _row_major(tower) == 7 * cfg.num_hidden_layers
    with torch.inference_mode():
        row_major = tllama.llama_apply(tower, cfg, ids, mask)
    assert torch.isfinite(k_major.float()).all() and torch.equal(k_major, row_major)
