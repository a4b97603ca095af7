"""The Python side of the wgmma route of the MLP blocks, without a card:
which design a block takes (``cuda_mlp.mlp_route``) and which C entries
the wrappers launch for it, the GEMM core's plain versions (``cuda_gemm``)
against numpy, and the wrappers refusing operands the kernels do not take
(checked before the device, so here on the CPU) without counting a
launch.  The kernels themselves are held against these plain versions on
the card (``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""

import types

import numpy as np
import pytest
import torch

from vault_tpu_torch.ops import cuda_gemm as cg
from vault_tpu_torch.ops import cuda_mlp as cm


@pytest.mark.parametrize("dtype,postln,route", [
    (torch.bfloat16, False, "wgmma"),
    (torch.bfloat16, True, "walk"),
    (torch.float32, False, "walk"),
    (torch.float32, True, "walk"),
])
def test_mlp_route(dtype, postln, route):
    """bf16 pre-LN blocks go to the wgmma core; fp32 and post-LN blocks stay
    on the walk (int8-weight blocks: the q8 case of the test below)."""
    assert cm.mlp_route(dtype, postln) == route


def test_mlp_route_refuses_other_dtypes():
    with pytest.raises(TypeError):
        cm.mlp_route(torch.float16, False)


class _EntryRecorder:
    """Stands in for a kernel library: records which C entry a wrapper
    called, sizes every workspace at 16 floats, and launches nothing."""

    def __init__(self):
        self.called = []

    def __getattr__(self, name):
        def entry(*args):
            self.called.append(name)
            return 16 if name.endswith("workspace") else 0
        return entry


@pytest.mark.parametrize("wrapper,dtype,postln,entry", [
    ("fwd", torch.bfloat16, False, "vt_mlp_fwd_wgmma"),
    ("fwd", torch.bfloat16, True, "vt_mlp_fwd"),
    ("fwd", torch.float32, False, "vt_mlp_fwd"),
    ("bwd", torch.bfloat16, False, "vt_mlp_bwd_wgmma"),
    ("bwd", torch.bfloat16, True, "vt_mlp_bwd"),
    ("bwd", torch.float32, False, "vt_mlp_bwd"),
    ("q8", torch.bfloat16, False, "vt_mlp_fwd_q8"),
    ("q8", torch.bfloat16, True, "vt_mlp_fwd_q8"),
])
def test_wrappers_launch_the_entries_of_their_route(monkeypatch, wrapper, dtype, postln,
                                                    entry):
    """The wrappers launch the C entries of the design ``mlp_route`` names,
    with the workspace of that design."""
    lib = _EntryRecorder()
    monkeypatch.setattr(cm._build, "load", lambda name, signatures: lib)
    monkeypatch.setattr(cm, "_check", lambda *a: None)
    monkeypatch.setattr(cm, "check_operands", lambda *a: None)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(cuda_stream=None))
    a = {k: v.to(dtype) for k, v in _mlp_args().items()}
    if wrapper == "fwd":
        cm._launch(postln, a["gamma"], a["beta"], a["w1"], a["b1"], a["w2"], a["b2"],
                   a["x"], None, 1e-12, "gelu")
    elif wrapper == "bwd":
        cm._launch_bwd(postln, a["gamma"], a["beta"], a["w1"], a["b1"], a["w2"], a["b2"],
                       a["x"], a["g"], None, 1e-12)
    else:
        i = a["w1"].shape[1]
        cm._launch_q8(postln, a["gamma"], a["beta"], a["w1"].to(torch.int8),
                      torch.ones(i), a["b1"], a["w2"].to(torch.int8), torch.ones(768),
                      a["b2"], a["x"], 1e-12, "gelu")
    design = "_wgmma" if entry.endswith("_wgmma") else ""
    workspace = {"fwd": f"vt_mlp{design}_workspace", "q8": "vt_mlp_workspace",
                 "bwd": f"vt_mlp_bwd{design}_workspace"}[wrapper]
    assert lib.called == [workspace, entry]


def _rnd(rng, *shape, std=1.0):
    return torch.from_numpy((rng.standard_normal(shape) * std).astype(np.float32))


@pytest.mark.parametrize("k_contiguous", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gemm_plain_matches_numpy(k_contiguous, dtype):
    rng = np.random.default_rng(0)
    a = _rnd(rng, 37, 128).to(dtype)
    b = _rnd(rng, 96, 128, std=0.05).to(dtype) if k_contiguous else \
        _rnd(rng, 128, 96, std=0.05).to(dtype)
    out = cg.gemm_plain(a, b, k_contiguous)
    bn = b.double().numpy()
    ref = a.double().numpy() @ (bn.T if k_contiguous else bn)
    assert out.dtype == torch.float32 and out.shape == (37, 96)
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-5, rtol=1e-5)


def test_gemm_dual_plain_matches_numpy():
    rng = np.random.default_rng(1)
    a1, a2 = _rnd(rng, 20, 64), _rnd(rng, 20, 64)
    b1, b2 = _rnd(rng, 64, 256, std=0.05), _rnd(rng, 256, 64, std=0.05)
    c1, c2 = cg.gemm_dual_plain(a1, b1, a2, b2)
    np.testing.assert_allclose(c1.numpy(), a1.double().numpy() @ b1.double().numpy(),
                               atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(c2.numpy(), a2.double().numpy() @ b2.double().numpy().T,
                               atol=1e-5, rtol=1e-5)


def _misaligned(t):
    """t's values in a tensor whose storage starts one element past a
    16-byte boundary."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype)
    out = buf[1:].view(t.shape)
    out.copy_(t)
    return out


def _strided(t):
    """t's values in a non-contiguous view."""
    return t.t().contiguous().t() if t.dim() == 2 else t.repeat(2)[::2]


def _mlp_args(dtype=torch.bfloat16, rows=4, h=768, i=256):
    rng = np.random.default_rng(2)
    return dict(gamma=_rnd(rng, h).to(dtype), beta=_rnd(rng, h).to(dtype),
                w1=_rnd(rng, h, i).to(dtype), b1=_rnd(rng, i).to(dtype),
                w2=_rnd(rng, i, h).to(dtype), b2=_rnd(rng, h).to(dtype),
                x=_rnd(rng, rows, h).to(dtype), g=_rnd(rng, rows, h).to(dtype))


_MLP_WRAPPERS = {
    "fused_mlp_block_fwd": ("gamma", "beta", "w1", "b1", "w2", "b2", "x"),
    "fused_mlp_block_bwd": ("gamma", "beta", "w1", "b1", "w2", "b2", "x", "g"),
}


@pytest.mark.parametrize("wrapper", sorted(_MLP_WRAPPERS))
@pytest.mark.parametrize("operand", ["w1", "w2", "x"])
@pytest.mark.parametrize("defect", [_misaligned, _strided])
def test_mlp_wrappers_refuse_misaligned_or_strided_operands(wrapper, operand, defect):
    fn = getattr(cm, wrapper)
    args = _mlp_args()
    args[operand] = defect(args[operand])
    assert not args[operand].is_contiguous() or args[operand].data_ptr() % 16
    before = fn.launches
    with pytest.raises(ValueError, match=f"{operand} must be contiguous and 16-byte aligned"):
        fn(*(args[k] for k in _MLP_WRAPPERS[wrapper]))
    assert fn.launches == before


def test_mlp_wrapper_with_good_operands_still_wants_the_card():
    args = _mlp_args()
    with pytest.raises(ValueError, match="CUDA"):
        cm.fused_mlp_block_fwd(*(args[k] for k in _MLP_WRAPPERS["fused_mlp_block_fwd"]))


@pytest.mark.parametrize("defect", [_misaligned, _strided])
@pytest.mark.parametrize("operand", ["a", "b"])
def test_gemm_wrapper_refuses_misaligned_or_strided_operands(defect, operand):
    rng = np.random.default_rng(3)
    ops = {"a": _rnd(rng, 16, 128).bfloat16(), "b": _rnd(rng, 128, 192).bfloat16()}
    ops[operand] = defect(ops[operand])
    before = cg.gemm_bf16.launches
    with pytest.raises(ValueError, match=f"{operand} must be contiguous"):
        cg.gemm_bf16(ops["a"], ops["b"])
    assert cg.gemm_bf16.launches == before


@pytest.mark.parametrize("bad", ["k", "tile", "dtype"])
def test_gemm_wrappers_refuse_shapes_the_core_does_not_take(bad):
    rng = np.random.default_rng(4)
    a, b = _rnd(rng, 16, 128).bfloat16(), _rnd(rng, 128, 192).bfloat16()
    before = cg.gemm_bf16.launches, cg.gemm_dual_bf16.launches
    with pytest.raises((ValueError, TypeError)):
        if bad == "k":
            cg.gemm_bf16(a[:, :96].contiguous(), b[:96].contiguous())
        elif bad == "tile":
            cg.gemm_bf16(a, b, tile_width=256)
        else:
            cg.gemm_dual_bf16(a, b, a.float(), b.t().contiguous())
    assert (cg.gemm_bf16.launches, cg.gemm_dual_bf16.launches) == before
