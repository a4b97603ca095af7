"""The Python side of the wgmma route of the MLP blocks, without a card:
which design a block takes (``cuda_mlp.mlp_route``) and which C entries
the wrappers launch for it, the GEMM core's plain versions (``cuda_gemm``,
split-K included) against numpy, the width contract of each wrapper, and
the wrappers refusing operands the kernels do not take (checked before the
device, so here on the CPU) without counting a launch.  The kernels
themselves are held against these plain versions on the card: the tests
marked ``cuda`` here (the core's split-K) and in ``tests/test_torch_cuda.py``
skip without a card and run there with ``python3 -m pytest --noconftest -m
cuda tests/test_torch_gemm.py tests/test_torch_cuda.py``; ``chip_smoke.py``.
"""

import types

import numpy as np
import pytest
import torch

from vault_tpu_torch.ops import cuda_gemm as cg
from vault_tpu_torch.ops import cuda_mlp as cm
from vault_tpu_torch.ops.quantize import k_major


@pytest.mark.parametrize("dtype,int8_weights,postln,route", [
    (torch.bfloat16, False, False, "wgmma"),
    (torch.bfloat16, False, True, "wgmma"),
    (torch.bfloat16, True, False, "wgmma"),
    (torch.bfloat16, True, True, "wgmma"),
    (torch.float32, False, False, "tiles"),
    (torch.float32, False, True, "tiles"),
    (torch.float32, True, False, "tiles"),
    (torch.float32, True, True, "tiles"),
])
def test_mlp_route(dtype, int8_weights, postln, route):
    """Every bf16 block, pre-LN and post-LN alike, with bf16 weights or int8
    ones (behind the dequantization pass), goes to the wgmma core; fp32
    blocks run the same launches on the fp32 tiles.  Which entries each wrapper launches: the test
    below."""
    assert cm.mlp_route(dtype, int8_weights, postln) == route


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_w8a8_route(dtype):
    """The w8a8 MLP blocks, pre-LN and post-LN, run on the int8 core for
    both dtypes: their products are exact in int32, only their casts depend
    on the dtype."""
    assert cm.w8a8_route(dtype) == "wgmma"


@pytest.mark.parametrize("dtype", [torch.float16, torch.int8, torch.float64])
def test_w8a8_route_refuses_other_dtypes(dtype):
    with pytest.raises(TypeError, match="w8a8_route"):
        cm.w8a8_route(dtype)


@pytest.mark.parametrize("dtype,w8a8,route", [
    (torch.bfloat16, False, "wgmma"), (torch.float32, False, "tiles"),
    (torch.bfloat16, True, "wgmma"), (torch.float32, True, "wgmma")])
def test_ln_qkv_route(dtype, w8a8, route):
    """bf16 LN->QKV with fp weights goes to the wgmma core and the w8a8
    kernel, in both dtypes, to its int8 instance; fp32 with fp weights stays
    on gemm_tiles."""
    from vault_tpu_torch.ops import cuda_ln_qkv as cl

    assert cl.ln_qkv_route(dtype, w8a8) == route


@pytest.mark.parametrize("dtype,route", [(torch.bfloat16, "wgmma"), (torch.float32, "fma")])
def test_attention_route(dtype, route):
    """bf16 attention runs the one-pass wgmma kernel, fp32 the FMA kernel
    (both attention wrappers, one C entry each)."""
    from vault_tpu_torch.ops import cuda_attention as ca

    assert ca.attention_route(dtype) == route


@pytest.mark.parametrize("dtype", [torch.float16, torch.int8, torch.float64])
def test_attention_route_refuses_other_dtypes(dtype):
    from vault_tpu_torch.ops import cuda_attention as ca

    with pytest.raises(TypeError, match="attention_route"):
        ca.attention_route(dtype)


@pytest.mark.parametrize("which", ["mlp", "ln_qkv"])
def test_mlp_route_refuses_other_dtypes(which):
    from vault_tpu_torch.ops import cuda_ln_qkv as cl

    with pytest.raises(TypeError):
        (cm.mlp_route if which == "mlp" else cl.ln_qkv_route)(torch.float16)


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
    ("fwd", torch.bfloat16, True, "vt_mlp_fwd_wgmma"),
    ("fwd", torch.float32, False, "vt_mlp_fwd"),
    ("fwd", torch.float32, True, "vt_mlp_fwd"),
    ("bwd", torch.bfloat16, False, "vt_mlp_bwd_wgmma"),
    ("bwd", torch.bfloat16, True, "vt_mlp_bwd_wgmma"),
    ("bwd", torch.float32, False, "vt_mlp_bwd"),
    ("bwd", torch.float32, True, "vt_mlp_bwd"),
    ("q8", torch.bfloat16, False, "vt_mlp_fwd_q8_wgmma"),
    ("q8", torch.bfloat16, True, "vt_mlp_fwd_q8_wgmma"),
    ("q8", torch.float32, False, "vt_mlp_fwd_q8"),
    ("q8", torch.float32, True, "vt_mlp_fwd_q8"),
    ("ln_qkv", torch.bfloat16, False, "vt_ln_qkv_wgmma"),
    ("ln_qkv", torch.float32, False, "vt_ln_qkv"),
    ("attention", torch.bfloat16, False, "vt_attention_fwd"),
    ("attention", torch.float32, False, "vt_attention_fwd"),
    ("attention_gqa", torch.bfloat16, False, "vt_attention_gqa_fwd"),
    ("attention_gqa", torch.float32, False, "vt_attention_gqa_fwd"),
    ("w8a8", torch.bfloat16, False, "vt_mlp_w8a8"),
    ("w8a8", torch.bfloat16, True, "vt_mlp_w8a8"),
    ("w8a8", torch.float32, False, "vt_mlp_w8a8"),
    ("w8a8", torch.float32, True, "vt_mlp_w8a8"),
])
def test_wrappers_launch_the_entries_of_their_route(monkeypatch, wrapper, dtype, postln,
                                                    entry):
    """The wrappers launch the C entries of the design ``mlp_route`` (or
    ``ln_qkv_route``, ``w8a8_route``) names, with the workspace of that
    design (LN->QKV: the wrapper's own scratch; w8a8: the second product's
    s32 slices, as many as ``vt_mlp_w8a8_slices`` says, and the codes'
    K-major storage handed as it lies).  Each attention wrapper has one C entry,
    which runs the design ``attention_route`` names for the dtype it is
    handed (bf16 1, fp32 0); the wrapper returns the (B, L, H, D) output as
    a (B, H, L, D) view and counts the launch."""
    from vault_tpu_torch.ops import cuda_attention as ca
    from vault_tpu_torch.ops import cuda_ln_qkv as cl

    lib = _EntryRecorder()
    monkeypatch.setattr(cm._build, "load", lambda name, signatures: lib)
    monkeypatch.setattr(cm, "_check", lambda *a: None)
    monkeypatch.setattr(cm, "check_operands", lambda *a: None)
    monkeypatch.setattr(cl, "check_operands", lambda *a: None)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(cuda_stream=None))
    if wrapper.startswith("attention"):
        gqa = wrapper == "attention_gqa"
        monkeypatch.setattr(ca, "_check_gqa" if gqa else "_check", lambda *a: None)
        counter = ca.fused_attention_gqa if gqa else ca.fused_attention
        monkeypatch.setattr(counter, "launches", 0)
        args = []

        def entry_fn(*a):
            args.append(a)
            lib.called.append(entry)
            return 0
        monkeypatch.setattr(lib, entry, entry_fn, raising=False)
        q = torch.zeros((2, 4, 5, 64), dtype=dtype)
        kv = torch.zeros((2, 2 if gqa else 4, 5, 64), dtype=dtype)
        bias = torch.zeros((2, 1, 5, 5) if gqa else (2, 1, 1, 5))
        out = (ca._gqa_kernel if gqa else ca._kernel)(q, kv, kv, bias)
        assert lib.called == [entry] and counter.launches == 1
        assert out.shape == q.shape and out.permute(0, 2, 1, 3).is_contiguous()
        assert args[0][-2] == {"wgmma": 1, "fma": 0}[ca.attention_route(dtype)]
        return
    a = {k: v.to(dtype) for k, v in _mlp_args().items()}
    if wrapper == "fwd":
        cm._launch(postln, a["gamma"], a["beta"], a["w1"], a["b1"], a["w2"], a["b2"],
                   a["x"], None, 1e-12, "gelu")
    elif wrapper == "bwd":
        cm._launch_bwd(postln, a["gamma"], a["beta"], a["w1"], a["b1"], a["w2"], a["b2"],
                       a["x"], a["g"], None, 1e-12)
    elif wrapper == "q8":
        i = a["w1"].shape[1]
        cm._launch_q8(postln, a["gamma"], a["beta"], a["w1"].to(torch.int8),
                      torch.ones(i), a["b1"], a["w2"].to(torch.int8), torch.ones(768),
                      a["b2"], a["x"], 1e-12, "gelu")
    elif wrapper == "w8a8":
        i = a["w1"].shape[1]
        w1q, w2q = (k_major(a[w].to(torch.int8)) for w in ("w1", "w2"))
        calls = []
        monkeypatch.setattr(lib, entry, lambda *args: calls.append(args) or
                            lib.called.append(entry) or 0, raising=False)
        cm._launch_w8a8(postln, a["gamma"], a["beta"], w1q, torch.ones(i), a["b1"], w2q,
                        torch.ones(768), a["b2"], a["x"], 1e-12, "gelu")
        assert lib.called == ["vt_mlp_w8a8_slices", entry]
        (call,) = calls
        assert call[3] == w1q.data_ptr() and call[6] == w2q.data_ptr()
        assert call[16:19] == (a["x"].shape[0], 768, i)
        assert call[-3:-1] == (int(postln), cm._DTYPES[dtype])
        return
    else:
        wqkv = torch.zeros((768, 2304), dtype=dtype)
        cl.fused_ln_qkv_fwd(a["gamma"], a["beta"], wqkv, torch.zeros(2304, dtype=dtype),
                            a["x"])
        assert lib.called == [entry]
        return
    design = "_wgmma" if entry.endswith("_wgmma") else ""
    workspace = {"fwd": f"vt_mlp{design}_workspace",
                 "q8": "vt_mlp_q8_wgmma_workspace" if design else "vt_mlp_workspace",
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


# ---------------------------------------------------------------------------
# The width contract: each wrapper, given CPU tensors, raises its width error
# before anything else when the width is outside its kernels' contract, and
# otherwise gets as far as the device check ("the kernel takes CUDA
# tensors"), so the contract shows without a card.
# ---------------------------------------------------------------------------

# (H, I) the wgmma core takes (bf16 blocks) and some it refuses: H a
# multiple of 64 from 64 to 8,192, I a multiple of 64.
CORE_WIDTHS = [(64, 64), (512, 2048), (768, 3072), (1024, 4096), (8192, 64)]
CORE_REFUSED = [(32, 64), (96, 128), (8256, 64), (768, 96), (768, 0)]
# the fp32 tiles' (fp32 blocks, int8 weights or not): H a multiple of 128
# from 128 to 8,192, I a multiple of 128
TILES_WIDTHS = [(128, 384), (512, 2048), (768, 128), (768, 3072), (1024, 4096),
                (8192, 128)]
TILES_REFUSED = [(96, 128), (8320, 128), (768, 192), (768, 0), (64, 128)]
# the w8a8 blocks' on the int8 core: H a multiple of 128 from 128 to 8,192,
# I a multiple of 128 up to 32,768
W8A8_WIDTHS = [(128, 128), (512, 2048), (768, 3072), (1024, 4096), (8192, 128),
               (128, 32768)]
W8A8_REFUSED = [(64, 128), (192, 128), (8320, 128), (768, 192), (768, 0), (128, 32896)]


def _block_args(dtype, h, i, rows=2):
    z = lambda *shape: torch.zeros(shape, dtype=dtype)
    return dict(gamma=z(h), beta=z(h), w1=z(h, i), b1=z(i), w2=z(i, h), b2=z(h),
                x=z(rows, h), g=z(rows, h))


def _call_fp(kind, postln, a):
    if kind == "fwd":
        fn = cm.fused_mlp_postln_fwd if postln else cm.fused_mlp_block_fwd
        return fn, lambda: fn(*(a[k] for k in ("gamma", "beta", "w1", "b1", "w2", "b2", "x")))
    fn = cm.fused_mlp_postln_block_bwd if postln else cm.fused_mlp_block_bwd
    return fn, lambda: fn(*(a[k] for k in ("gamma", "beta", "w1", "b1", "w2", "b2", "x", "g")))


@pytest.mark.parametrize("kind", ["fwd", "bwd"])
@pytest.mark.parametrize("postln", [False, True])
@pytest.mark.parametrize("dtype,h,i,accepted", [
    *[(torch.bfloat16, h, i, True) for h, i in CORE_WIDTHS],
    *[(torch.bfloat16, h, i, False) for h, i in CORE_REFUSED],
    *[(torch.float32, h, i, True) for h, i in TILES_WIDTHS],
    *[(torch.float32, h, i, False) for h, i in TILES_REFUSED],
])
def test_mlp_wrappers_hold_their_width_contract(kind, postln, dtype, h, i, accepted):
    fn, call = _call_fp(kind, postln, _block_args(dtype, h, i))
    before = fn.launches
    with pytest.raises(ValueError, match="CUDA" if accepted else "hidden size"):
        call()
    assert fn.launches == before


def _int8_contract(family, postln, dtype):
    """The widths an int8-weight block takes: the bf16 q8 blocks the wgmma
    core's, the fp32 ones the fp32 tiles', the w8a8 ones the int8 core's."""
    if family == "w8a8":
        return W8A8_WIDTHS, W8A8_REFUSED
    core = dtype == torch.bfloat16
    return (CORE_WIDTHS, CORE_REFUSED) if core else (TILES_WIDTHS, TILES_REFUSED)


def _int8_block_args(family, a, h, i, layout=None):
    """The int8 wrappers' arguments from ``_block_args``: the codes of w1
    and w2, K-major for w8a8 (``layout`` names one held row-major
    instead)."""
    def codes(name):
        q = a[name].to(torch.int8)
        return k_major(q) if family == "w8a8" and name != layout else q

    return (a["gamma"], a["beta"], codes("w1"), torch.ones(i), a["b1"], codes("w2"),
            torch.ones(h), a["b2"], a["x"])


@pytest.mark.parametrize("family,postln,dtype,h,i,accepted", [
    (family, postln, dtype, h, i, accepted)
    for family in ("q8", "w8a8") for postln in (False, True)
    for dtype in (torch.bfloat16, torch.float32)
    for widths, accepted in zip(_int8_contract(family, postln, dtype), (True, False))
    for h, i in widths])
def test_int8_mlp_wrappers_hold_their_width_contract(family, postln, dtype, h, i, accepted):
    fn = getattr(cm, f"fused_mlp_{'postln' if postln else 'block'}_fwd_{family}")
    args = _int8_block_args(family, _block_args(dtype, h, i), h, i)
    before = fn.launches
    with pytest.raises(ValueError, match="CUDA" if accepted else "hidden size"):
        fn(*args)
    assert fn.launches == before


@pytest.mark.parametrize("layout", ["w1", "w2"])
@pytest.mark.parametrize("postln", [False, True])
def test_w8a8_wrappers_refuse_codes_not_held_k_major(postln, layout):
    """Row-major codes (the JAX package's layout) are refused, not
    transposed per call: the port holds the MLP's w8a8 codes K-major from
    the start (ops/quantize.py k_major)."""
    fn = cm.fused_mlp_postln_fwd_w8a8 if postln else cm.fused_mlp_block_fwd_w8a8
    args = _int8_block_args("w8a8", _block_args(torch.bfloat16, 768, 256), 768, 256, layout)
    before = fn.launches
    with pytest.raises(ValueError, match=f"{layout}q must be held K-major.*k_major"):
        fn(*args)
    assert fn.launches == before


# LN->QKV: bf16 on the wgmma core takes H a multiple of 64 from 64 to 8,192
# (output width 3H); the w8a8 kernel on the int8 core and fp32 on gemm_tiles
# H a multiple of 128 from 128 to 8,192.
LNQKV_CORE_H = [64, 512, 768, 1024, 8192]
LNQKV_CORE_REFUSED_H = [32, 96, 8256]
LNQKV_TILES_H = [128, 512, 768, 1024, 8192]
LNQKV_TILES_REFUSED_H = [64, 96, 8320]


@pytest.mark.parametrize("kernel,dtype,h,accepted", [
    *[("fp", torch.bfloat16, h, True) for h in LNQKV_CORE_H],
    *[("fp", torch.bfloat16, h, False) for h in LNQKV_CORE_REFUSED_H],
    *[(k, dt, h, True) for k, dt in (("fp", torch.float32), ("w8a8", torch.bfloat16),
                                     ("w8a8", torch.float32)) for h in LNQKV_TILES_H],
    *[(k, dt, h, False) for k, dt in (("fp", torch.float32), ("w8a8", torch.bfloat16),
                                      ("w8a8", torch.float32)) for h in LNQKV_TILES_REFUSED_H],
])
def test_ln_qkv_wrappers_hold_their_width_contract(kernel, dtype, h, accepted):
    from vault_tpu_torch.ops import cuda_ln_qkv as cl

    z = lambda *shape, dt=dtype: torch.zeros(shape, dtype=dt)
    if kernel == "fp":
        fn, args = cl.fused_ln_qkv_fwd, (z(h), z(h), z(h, 3 * h), z(3 * h), z(2, h))
    else:
        fn = cl.fused_ln_qkv_fwd_w8a8
        args = (z(h), z(h), k_major(z(h, 3 * h, dt=torch.int8)), z(3 * h, dt=torch.float32),
                z(3 * h), z(2, h))
    before = fn.launches
    with pytest.raises(ValueError, match="CUDA" if accepted else "hidden size"):
        fn(*args)
    assert fn.launches == before


def test_ln_qkv_w8a8_wrapper_refuses_codes_not_held_k_major():
    """Row-major codes (the JAX package's layout) are refused, not
    transposed per call: the dispatch hands the kernel its concatenated
    operand K-major (``_w8a8_operands``)."""
    from vault_tpu_torch.ops import cuda_ln_qkv as cl

    z = lambda *shape, dt=torch.bfloat16: torch.zeros(shape, dtype=dt)
    before = cl.fused_ln_qkv_fwd_w8a8.launches
    with pytest.raises(ValueError, match="wqkv_q must be held K-major.*k_major"):
        cl.fused_ln_qkv_fwd_w8a8(z(768), z(768), z(768, 2304, dt=torch.int8),
                                 z(2304, dt=torch.float32), z(2304), z(2, 768))
    assert cl.fused_ln_qkv_fwd_w8a8.launches == before


@pytest.mark.parametrize("kernel,dtype,h,entry", [
    ("w8a8", torch.bfloat16, 512, "vt_ln_qkv_w8a8"),
    ("w8a8", torch.bfloat16, 1024, "vt_ln_qkv_w8a8"),
    ("w8a8", torch.float32, 512, "vt_ln_qkv_w8a8"),
    ("w8a8", torch.float32, 1024, "vt_ln_qkv_w8a8"),
    ("fp", torch.float32, 512, "vt_ln_qkv"),
    ("fp", torch.float32, 1024, "vt_ln_qkv"),
])
def test_ln_qkv_wrappers_launch_their_entry_at_other_widths(monkeypatch, kernel, dtype, h,
                                                            entry):
    """At widths past 768, where these entries refused to run before, the
    LN->QKV wrappers launch their route's entry with the call's rows, H and
    3H and the dtype's code; the w8a8 one hands the kernel its codes'
    K-major storage as it lies, and counts the launch."""
    from vault_tpu_torch.ops import cuda_ln_qkv as cl

    calls = []
    lib = _EntryRecorder()
    monkeypatch.setattr(lib, entry, lambda *args: calls.append(args) or 0, raising=False)
    monkeypatch.setattr(cl._build, "load", lambda name, signatures: lib)
    monkeypatch.setattr(cl, "check_operands", lambda *a: None)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(cuda_stream=None))
    z = lambda *shape, dt=dtype: torch.zeros(shape, dtype=dt)
    x = z(3, h)
    if kernel == "w8a8":
        fn = cl.fused_ln_qkv_fwd_w8a8
        wq = k_major(z(h, 3 * h, dt=torch.int8))
        monkeypatch.setattr(fn, "launches", 0)
        out = fn(z(h), z(h), wq, z(3 * h, dt=torch.float32), z(3 * h), x)
        (call,) = calls
        assert call[3] == wq.data_ptr() and call[9:12] == (3, h, 3 * h)
        assert call[-2] == cl._DTYPES[dtype]
    else:
        fn = cl.fused_ln_qkv_fwd
        monkeypatch.setattr(fn, "launches", 0)
        out = fn(z(h), z(h), z(h, 3 * h), z(3 * h), x)
        (call,) = calls
        assert call[7:10] == (3, h, 3 * h) and call[-2] == cl._DTYPES[dtype]
    assert out.shape == (3, 3 * h) and out.dtype == dtype and fn.launches == 1


def test_ln_qkv_core_refuses_an_output_width_off_its_multiple():
    from vault_tpu_torch.ops import cuda_ln_qkv as cl

    z = lambda *shape: torch.zeros(shape, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="output width"):
        cl.fused_ln_qkv_fwd(z(64), z(64), z(64, 96), z(96), z(2, 64))


# ---------------------------------------------------------------------------
# The w8 pre-LN block's dequantization pass (dequant_bf16): its plain
# version here, the kernel on the card
# ---------------------------------------------------------------------------

def _q8_case(rng, rows=20, k=128, n=48):
    a = _rnd(rng, rows, k).bfloat16()
    bq = torch.from_numpy(rng.integers(-128, 128, (k, n)).astype(np.int8))
    s = torch.from_numpy((rng.uniform(0.5, 2.0, n) / 127).astype(np.float32))
    return a, bq, s


def test_dequant_plain_rounds_the_fp32_product_to_bf16():
    """bf16(float(q) * s): one fp32 rounding of the exact product, then one
    to bf16, as the w8 linear dequantizes."""
    rng = np.random.default_rng(7)
    _, bq, s = _q8_case(rng)
    out = cg.dequant_plain(bq, s)
    f32 = (bq.numpy().astype(np.float32) * s.numpy()[None]).astype(np.float32)
    assert out.dtype == torch.bfloat16
    np.testing.assert_array_equal(out.float().numpy(),
                                  torch.from_numpy(f32).bfloat16().float().numpy())
    assert torch.equal(out, (bq.float() * s).bfloat16())


@pytest.mark.parametrize("bad", ["n", "rank", "codes", "scales", "scale_shape"])
def test_dequant_wrapper_refuses_what_the_pass_does_not_take(bad):
    rng = np.random.default_rng(9)
    _, bq, s = _q8_case(rng)
    before = cg.dequant_bf16.launches
    with pytest.raises((ValueError, TypeError)):
        if bad == "n":
            cg.dequant_bf16(bq[:, :40].contiguous(), s[:40].contiguous())
        elif bad == "rank":
            cg.dequant_bf16(bq.reshape(-1), s)
        elif bad == "codes":
            cg.dequant_bf16(bq.bfloat16(), s)
        elif bad == "scales":
            cg.dequant_bf16(bq, s.bfloat16())
        else:
            cg.dequant_bf16(bq, s[:32].contiguous())
    assert cg.dequant_bf16.launches == before


@pytest.mark.parametrize("defect", [_misaligned, _strided])
@pytest.mark.parametrize("operand", ["q", "s"])
def test_dequant_wrapper_refuses_misaligned_or_strided_operands(defect, operand):
    rng = np.random.default_rng(10)
    _, bq, s = _q8_case(rng)
    ops = {"q": bq, "s": s}
    ops[operand] = defect(ops[operand])
    before = cg.dequant_bf16.launches
    with pytest.raises(ValueError, match=f"{operand} must be contiguous"):
        cg.dequant_bf16(ops["q"], ops["s"])
    assert cg.dequant_bf16.launches == before


@pytest.mark.parametrize("act", ["gelu", "gelu_new", "gelu_pytorch_tanh", "relu"])
@pytest.mark.parametrize("postln", [False, True])
def test_w8a8_wrappers_take_every_activation(postln, act):
    """The w8a8 kernels take the activations of the fp and q8 blocks: a CPU
    call gets past the activation to the device check."""
    fn = cm.fused_mlp_postln_fwd_w8a8 if postln else cm.fused_mlp_block_fwd_w8a8
    args = _int8_block_args("w8a8", _block_args(torch.bfloat16, 768, 256), 768, 256)
    with pytest.raises(ValueError, match="CUDA"):
        fn(*args, act=act)
    with pytest.raises(ValueError, match="activation"):
        fn(*args, act="swish")


@pytest.mark.parametrize("gqa", [False, True])
@pytest.mark.parametrize("d,accepted", [(32, True), (64, True), (96, True), (128, True),
                                        (16, False), (48, False), (80, False),
                                        (256, False)])
def test_attention_wrappers_hold_their_head_dim_contract(gqa, d, accepted):
    """Both attention kernels take head dims 32, 64, 96 and 128: a CPU call
    reaches the device check ("no kernel" for a CPU tensor) or raises the
    head-dim error first."""
    from vault_tpu_torch.ops import cuda_attention as ca

    q = torch.zeros((1, 2, 5, d))
    if gqa:
        fn, bias = ca._gqa_kernel, torch.zeros((1, 1, 5, 5))
        counter = ca.fused_attention_gqa
    else:
        fn, bias = ca._kernel, torch.zeros((1, 1, 1, 5))
        counter = ca.fused_attention
    before = counter.launches
    with pytest.raises(ValueError, match="no kernel" if accepted else "with D in"):
        fn(q, q, q, bias)
    assert counter.launches == before
    assert d in ca.HEAD_DIMS if accepted else d not in ca.HEAD_DIMS


# ---------------------------------------------------------------------------
# Split-K: the plain version here, the core on the card
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("k,splits", [(64, 1), (3072, 7), (3072, 2), (768, 8), (192, 3)])
def test_split_bounds_cover_k_in_order(k, splits):
    bounds = cg.split_bounds(k, splits)
    assert len(bounds) == splits and bounds[0][0] == 0 and bounds[-1][1] == k
    assert all(a[1] == b[0] for a, b in zip(bounds, bounds[1:]))
    assert all(k1 > k0 and k0 % 64 == 0 for k0, k1 in bounds)


@pytest.mark.parametrize("k_contiguous", [False, True])
@pytest.mark.parametrize("splits", [1, 3, 4])
def test_gemm_split_k_plain_sums_to_the_product(k_contiguous, splits):
    rng = np.random.default_rng(5)
    a = _rnd(rng, 20, 256)
    b = _rnd(rng, 48, 256, std=0.05) if k_contiguous else _rnd(rng, 256, 48, std=0.05)
    slices = cg.gemm_split_k_plain(a, b, splits, k_contiguous)
    assert slices.shape == (splits, 20, 48)
    np.testing.assert_allclose(slices.sum(0).numpy(), cg.gemm_plain(a, b, k_contiguous).numpy(),
                               atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("splits", [0, 5])
def test_gemm_split_k_wrapper_refuses_splits_past_k(splits):
    rng = np.random.default_rng(6)
    a, b = _rnd(rng, 16, 256).bfloat16(), _rnd(rng, 256, 64).bfloat16()
    before = cg.gemm_bf16_split_k.launches
    with pytest.raises(ValueError, match="splits"):
        cg.gemm_bf16_split_k(a, b, splits)
    assert cg.gemm_bf16_split_k.launches == before


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


# The core alone against matmul_fp32: fp32 sums of the same exact bf16
# products in other orders, within 1e-4 of max(1, max|plain|).
GEMM_CORE_LIMIT = 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("k_contiguous", [False, True])
@pytest.mark.parametrize("tile_width", [64, 128, 192])
@pytest.mark.parametrize("rows,n,k,splits", [(320, 768, 3072, 7), (1280, 768, 3072, 2),
                                             (77, 768, 3072, 8), (37, 512, 2048, 3),
                                             (320, 3072, 768, 1)])
def test_gemm_split_k_on_the_core(dev, k_contiguous, tile_width, rows, n, k, splits):
    """Each split's slice against the plain product over its K range, and
    the slices' sum against the core's S = 1 product, at the post-LN
    blocks' shapes (a W2 and dh1 W1^T: K = I) and a ragged one."""
    g = torch.Generator(device=dev).manual_seed(rows + splits)
    rnd = lambda *s, std=1.0: (torch.randn(s, generator=g, device=dev) * std).to(torch.bfloat16)
    a = rnd(rows, k)
    b = rnd(n, k, std=0.02) if k_contiguous else rnd(k, n, std=0.02)
    before = cg.gemm_bf16_split_k.launches
    out = cg.gemm_bf16_split_k(a, b, splits, k_contiguous, tile_width)
    again = cg.gemm_bf16_split_k(a, b, splits, k_contiguous, tile_width)
    ref = cg.gemm_split_k_plain(a, b, splits, k_contiguous)
    whole = cg.gemm_bf16(a, b, k_contiguous, tile_width)
    torch.cuda.synchronize()
    assert cg.gemm_bf16_split_k.launches == before + 2
    assert out.shape == (splits, rows, n) and torch.equal(out, again)
    scale = max(1.0, ref.abs().max().item())
    assert (out - ref).abs().max().item() / scale <= GEMM_CORE_LIMIT
    scale = max(1.0, whole.abs().max().item())
    assert (out.sum(0) - whole).abs().max().item() / scale <= GEMM_CORE_LIMIT


# ---------------------------------------------------------------------------
# The int8 instance of the core (gemm_s8) and the w8a8 SwiGLU block on it:
# plain versions, routes, width and layout contracts here, the kernels on
# the card
# ---------------------------------------------------------------------------

def _codes(rng, *shape):
    return torch.from_numpy(rng.integers(-127, 128, shape).astype(np.int8))


def test_gemm_s8_plain_is_the_exact_int32_product():
    rng = np.random.default_rng(11)
    a, b = _codes(rng, 37, 256), _codes(rng, 48, 256)
    out = cg.gemm_s8_plain(a, b)
    assert out.dtype == torch.int32 and out.shape == (37, 48)
    ref = a.numpy().astype(np.int64) @ b.numpy().astype(np.int64).T
    np.testing.assert_array_equal(out.numpy(), ref)
    assert torch.equal(out, torch._int_mm(a, b.t()))


@pytest.mark.parametrize("bad", ["k", "n", "tile", "dtype", "strided"])
def test_gemm_s8_wrapper_refuses_what_the_core_does_not_take(bad):
    rng = np.random.default_rng(12)
    a, b = _codes(rng, 16, 256), _codes(rng, 64, 256)
    before = cg.gemm_s8.launches
    with pytest.raises((ValueError, TypeError)):
        if bad == "k":
            cg.gemm_s8(a[:, :192].contiguous(), b[:, :192].contiguous())
        elif bad == "n":
            cg.gemm_s8(a, b[:63].contiguous())
        elif bad == "tile":
            cg.gemm_s8(a, b, tile_width=256)
        elif bad == "dtype":
            cg.gemm_s8(a.float(), b)
        else:
            cg.gemm_s8(a, _strided(b))
    assert cg.gemm_s8.launches == before


@pytest.mark.parametrize("splits", [1, 3, 4, 6])
def test_gemm_s8_split_k_plain_sums_to_the_product(splits):
    """The s32 slices of the int8 split-K (the w8a8 post-LN block's second
    product) sum exactly to the whole product, in any order."""
    rng = np.random.default_rng(13)
    a, b = _codes(rng, 37, 768), _codes(rng, 48, 768)
    slices = cg.gemm_s8_split_k_plain(a, b, splits)
    assert slices.dtype == torch.int32 and slices.shape == (splits, 37, 48)
    whole = cg.gemm_s8_plain(a, b)
    assert torch.equal(slices.sum(0, dtype=torch.int32), whole)
    assert torch.equal(slices.flip(0).sum(0, dtype=torch.int32), whole)
    bounds = cg.split_bounds(768, splits, cg.K_MULTIPLE_S8)
    assert all(k0 % 128 == 0 and k1 > k0 for k0, k1 in bounds) and bounds[-1][1] == 768


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_swiglu_route(dtype):
    """The w8a8 SwiGLU block runs on the int8 core for both dtypes: its
    products are exact in int32, only its casts depend on the dtype."""
    from vault_tpu_torch.ops import cuda_swiglu as csw

    assert csw.swiglu_route(dtype) == "wgmma"


def test_swiglu_route_refuses_other_dtypes():
    from vault_tpu_torch.ops import cuda_swiglu as csw

    with pytest.raises(TypeError, match="not supported"):
        csw.swiglu_route(torch.float16)


def _swiglu_args(h, i, dtype=torch.bfloat16, rows=2, layout=None):
    """Zero operands of the SwiGLU wrapper at (H, I), the codes K-major
    (``layout`` names one held row-major instead)."""
    from vault_tpu_torch.ops.quantize import k_major

    def codes(name, shape):
        q = torch.zeros(shape, dtype=torch.int8)
        return q if name == layout else k_major(q)

    return (torch.ones(h), codes("wgq", (h, i)), torch.ones(i), codes("wuq", (h, i)),
            torch.ones(i), codes("wdq", (i, h)), torch.ones(h),
            torch.zeros((rows, h), dtype=dtype))


# (H, I) the SwiGLU kernel takes: H a multiple of 128 up to 8,192, I whose
# tile pick_tile(I, 1024) is a multiple of 128 (Llama-3-8B, Llama-3.2-1B, a
# tile below 1,024) and some it refuses
SWIGLU_WIDTHS = [(4096, 14336), (2048, 8192), (512, 1536), (128, 128), (8192, 1024),
                 (256, 768)]
SWIGLU_REFUSED = [(64, 1024), (4160, 1024), (8320, 1024), (512, 1000), (512, 1152),
                  (512, 0)]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("h,i,accepted", [*[(h, i, True) for h, i in SWIGLU_WIDTHS],
                                          *[(h, i, False) for h, i in SWIGLU_REFUSED]])
def test_swiglu_wrapper_holds_its_width_contract(dtype, h, i, accepted):
    from vault_tpu_torch.ops import cuda_swiglu as csw

    fn = csw.fused_swiglu_block_fwd_w8a8
    before = fn.launches
    with pytest.raises(ValueError, match="CUDA" if accepted else "hidden size"):
        fn(*_swiglu_args(h, i, dtype))
    assert fn.launches == before


@pytest.mark.parametrize("layout", ["wgq", "wuq", "wdq"])
def test_swiglu_wrapper_refuses_codes_not_held_k_major(layout):
    """Row-major codes (the JAX package's layout) are refused, not
    transposed per call: the port holds them K-major from the start."""
    from vault_tpu_torch.ops import cuda_swiglu as csw

    fn = csw.fused_swiglu_block_fwd_w8a8
    before = fn.launches
    with pytest.raises(ValueError, match=f"{layout} must be held K-major"):
        fn(*_swiglu_args(512, 1536, layout=layout))
    assert fn.launches == before


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("h,i", [(4096, 14336), (512, 1536)])
def test_swiglu_wrapper_launches_its_entry(monkeypatch, dtype, h, i):
    """One C entry, the codes' storage handed as it lies (no copy), the
    I-tile pick_tile(I, 1024) and the scratch of the four launches: the
    rows' codes and scales, the activation in x's dtype, its codes and one
    scale per (row, tile)."""
    from vault_tpu_torch.ops import cuda_swiglu as csw

    calls = []
    lib = types.SimpleNamespace(vt_swiglu_w8a8=lambda *a: calls.append(a) or 0)
    monkeypatch.setattr(csw._build, "load", lambda name, signatures: lib)
    monkeypatch.setattr(csw, "check_operands", lambda *a: None)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(cuda_stream=None))
    sizes = []
    real_empty = torch.empty
    monkeypatch.setattr(csw.torch, "empty", lambda shape, **kw: sizes.append(
        (tuple(shape) if not isinstance(shape, int) else (shape,), kw["dtype"]))
        or real_empty(shape, **kw))
    args = _swiglu_args(h, i, dtype, rows=3)
    monkeypatch.setattr(csw.fused_swiglu_block_fwd_w8a8, "launches", 0)
    out = csw.fused_swiglu_block_fwd_w8a8(*args)
    ti = csw.pick_tile(i, csw.I_TILE)
    (call,) = calls
    assert call[2] == args[1].data_ptr() and call[6] == args[5].data_ptr()
    assert call[14:18] == (3, h, i, ti)
    assert sizes == [((3, h), torch.int8), ((3,), torch.float32), ((3, i), dtype),
                     ((3, i), torch.int8), ((3, i // ti), torch.float32)]
    assert out.shape == (3, h) and csw.fused_swiglu_block_fwd_w8a8.launches == 1


@pytest.mark.cuda
@pytest.mark.parametrize("tile_width", [64, 128, 192])
@pytest.mark.parametrize("rows_first", [False, True])
@pytest.mark.parametrize("rows,n,k", [(640, 4096, 1024), (77, 768, 384), (320, 1536, 512)])
def test_gemm_s8_on_the_core(dev, tile_width, rows_first, rows, n, k):
    """The int8 instance against the exact int32 product: equal, repeats
    equal, at the SwiGLU down product's shape (one I-tile) and ragged ones."""
    g = torch.Generator(device=dev).manual_seed(rows + n)
    a = torch.randint(-127, 128, (rows, k), generator=g, device=dev, dtype=torch.int8)
    b = torch.randint(-127, 128, (n, k), generator=g, device=dev, dtype=torch.int8)
    before = cg.gemm_s8.launches
    out = cg.gemm_s8(a, b, tile_width, rows_first)
    again = cg.gemm_s8(a, b, tile_width, rows_first)
    torch.cuda.synchronize()
    assert cg.gemm_s8.launches == before + 2
    assert torch.equal(out, cg.gemm_s8_plain(a, b)) and torch.equal(out, again)
