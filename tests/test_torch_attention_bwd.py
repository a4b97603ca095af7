"""The encoder attention's training route and its backward, on the CPU.

``attend`` takes the attention kernels for a call that draws no dropout: a
deterministic call, or a bf16 call at rate 0 (the backward kernel's dtype);
a call that draws a mask, and fp32 training, stay on the plain composition
and draw what they drew before.  On the CPU the kernel path runs the plain
versions, so its gradients are the plain composition's bit for bit; the
backward operator's plain version (``attention_bwd_plain``, written out
below autograd) agrees with the autograd of ``attention_plain``.  The
kernel itself is held on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py --phases attn_bwd``).
"""

import pytest
import torch

from vault_tpu_torch.ops import attention as att
from vault_tpu_torch.ops import cuda_attention as ca
from vault_tpu_torch.ops.masks import extend_attention_mask


def _case(dtype, b=3, h=2, l=11, d=8, seed=0):
    g = torch.Generator().manual_seed(seed)
    q, k, v = (torch.randn((b, h, l, d), generator=g).to(dtype) for _ in range(3))
    mask = torch.ones((b, l), dtype=torch.int32)
    mask[1, l // 2:] = 0
    mask[2] = 0  # a row whose keys are all masked
    dout = torch.randn((b, h, l, d), generator=g).to(dtype)
    return q, k, v, extend_attention_mask(mask), dout


@pytest.fixture
def operator_calls(monkeypatch):
    """Each call of the forward operator ``vault_tpu_torch::attention``
    (its CPU implementation, looked up at every call), recorded."""
    calls = []
    plain = ca.ATTENTION.plain

    def recorded(*ts):
        calls.append(ts[0].dtype)
        return plain(*ts)

    monkeypatch.setattr(ca.ATTENTION, "plain", recorded)
    return calls


def _attend(q, k, v, bias, rate, seed=5):
    g = torch.Generator().manual_seed(seed)
    out = att.attend(q, k, v, bias, g, rate, deterministic=False, use_pallas=True)
    return out, g.get_state()


def test_rate_zero_bf16_training_reaches_the_operator(operator_calls):
    q, k, v, bias, _ = _case(torch.bfloat16)
    out, state = _attend(q, k, v, bias, 0.0)
    assert operator_calls == [torch.bfloat16]
    g = torch.Generator().manual_seed(5)
    ref = att.attend_plain(q, k, v, bias, g, 0.0, deterministic=False)
    assert torch.equal(out, ref)
    # rate 0 draws nothing: the generator's stream is where it was
    assert torch.equal(state, g.get_state())
    assert torch.equal(state, torch.Generator().manual_seed(5).get_state())


@pytest.mark.parametrize("dtype, rate", [(torch.bfloat16, 0.1), (torch.float32, 0.1),
                                         (torch.float32, 0.0)])
def test_dropout_and_fp32_training_stay_on_the_plain_composition(operator_calls, dtype, rate):
    q, k, v, bias, _ = _case(dtype)
    out, state = _attend(q, k, v, bias, rate)
    assert operator_calls == []
    g = torch.Generator().manual_seed(5)
    ref = att.attend_plain(q, k, v, bias, g, rate, deterministic=False)
    assert torch.equal(out, ref)
    assert torch.equal(state, g.get_state())  # the same draws, in the same order


def test_deterministic_calls_keep_the_operator(operator_calls):
    for dtype in (torch.bfloat16, torch.float32):
        q, k, v, bias, _ = _case(dtype)
        att.attend(q, k, v, bias, None, 0.1, deterministic=True, use_pallas=True)
    assert operator_calls == [torch.bfloat16, torch.float32]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("need", [(True, True, True), (True, False, False),
                                  (False, True, True)])
def test_the_function_on_the_cpu_gives_the_plain_gradients_bit_for_bit(dtype, need):
    q, k, v, bias, dout = _case(dtype, seed=1)
    leaves = [t.clone().requires_grad_(n) for t, n in zip((q, k, v), need)]
    refs = [t.clone().requires_grad_(n) for t, n in zip((q, k, v), need)]
    out = ca.fused_attention(*leaves, bias)
    ref = att.attend_plain(*refs, bias)
    assert torch.equal(out, ref)
    got = torch.autograd.grad(out, [t for t in leaves if t.requires_grad], dout)
    want = torch.autograd.grad(ref, [t for t in refs if t.requires_grad], dout)
    for a, b in zip(got, want):
        assert a.dtype == dtype and torch.equal(a, b)


def test_the_function_under_remat_gives_the_plain_gradients():
    from torch.utils.checkpoint import checkpoint

    q, k, v, bias, dout = _case(torch.bfloat16, seed=2)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    refs = [t.clone().requires_grad_() for t in (q, k, v)]
    out = checkpoint(lambda *ts: ca.fused_attention(*ts, bias), *leaves, use_reentrant=False)
    got = torch.autograd.grad(out, leaves, dout)
    want = torch.autograd.grad(att.attend_plain(*refs, bias), refs, dout)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("dtype, tol", [(torch.float32, 1e-5), (torch.bfloat16, 2.0 ** -8)])
@pytest.mark.parametrize("l", [1, 11, 70])
def test_backward_plain_version_matches_the_autograd(dtype, tol, l):
    q, k, v, bias, dout = _case(dtype, l=l, seed=l)
    got = ca.attention_bwd_plain(q, k, v, bias, dout)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    want = torch.autograd.grad(ca.attention_plain(*leaves, bias), leaves, dout)
    for a, b in zip(got, want):
        assert a.shape == b.shape and a.dtype == dtype
        err = ((a.float() - b.float()).norm() / b.float().norm().clamp_min(1e-30)).item()
        assert err <= tol, err


def test_backward_operator_on_the_cpu_is_the_plain_version():
    q, k, v, bias, dout = _case(torch.bfloat16, seed=4)
    n = ca.fused_attention_bwd.launches
    got = ca.fused_attention_bwd(q, k, v, bias, dout)
    want = ca.attention_bwd_plain(q, k, v, bias, dout)
    raw = ca.ATTENTION_BWD.op(q, k, v, bias, dout)
    for a, b, r in zip(got, want, raw):
        assert torch.equal(a, b)
        assert r.shape == (3, 11, 2, 8) and r.is_contiguous()  # (B, L, H, D)
        assert torch.equal(r.permute(0, 2, 1, 3), b)
    assert ca.fused_attention_bwd.launches == n  # the plain version counts nothing


def test_backward_operator_fake_shapes():
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode():
        q = torch.empty((2, 4, 9, 16), dtype=torch.bfloat16)
        outs = ca.ATTENTION_BWD.op(q, q, q, torch.empty((2, 1, 1, 9)), q)
        assert [tuple(t.shape) for t in outs] == [(2, 9, 4, 16)] * 3


@pytest.mark.parametrize("d", [6, 66, 132])
def test_backward_kernel_refuses_other_head_dims_before_the_device(d):
    q = torch.zeros((2, 4, 9, d), dtype=torch.bfloat16)
    bias = torch.zeros((2, 1, 1, 9))
    with pytest.raises(ValueError, match="multiple of 4 from 8 to 128"):
        ca.ATTENTION_BWD.kernel(q, q, q, bias, q)


def test_backward_kernel_refuses_cpu_and_fp32_tensors():
    q = torch.zeros((2, 4, 9, 64), dtype=torch.bfloat16)
    bias = torch.zeros((2, 1, 1, 9))
    n = ca.fused_attention_bwd.launches
    with pytest.raises(ValueError, match="no kernel"):
        ca.ATTENTION_BWD.kernel(q, q, q, bias, q)
    m = torch.zeros((2, 4, 9, 64), device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        ca.fused_attention_bwd(m, m, m, torch.zeros((2, 1, 1, 9), device="meta"), m)
    assert ca.fused_attention_bwd.launches == n
