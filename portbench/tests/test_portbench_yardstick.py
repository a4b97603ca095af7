"""The yardstick: the frozen product count, the roofline work of each
operator against hand-worked values, and the reading of a device trace
(kernels by operator, busy time, idle gaps by span, empty and short
traces)."""

import importlib.util
import json
import math
from pathlib import Path
from types import SimpleNamespace

import pytest

from portbench import devtrace, families, flops, roofline

HERE = Path(__file__).resolve().parents[1]
CANVAS = (384, 608)


def config(name):
    return json.loads((HERE / "configs" / f"{name}.json").read_text())


def reader(name):
    spec = importlib.util.spec_from_file_location(name.replace(".", "_"),
                                                  HERE / "metrics" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_forward_products_at_entry_geometry():
    """bert-base-uncased + ViLT-B/32, batch 16, 40 tokens, 384 x 608: BERT
    12 x 9.14 GF, ViLT (L 256) 12 x 61.2 GF, the projection 17.2 GF."""
    cfg = config("vault-bert-base-vilt-b32-w8a8")
    assert families.load(cfg, "flops").vilt_length(cfg, 40, CANVAS) == 256
    kinds = flops.forward_products(cfg, 16, 40, CANVAS)
    bert = 2 * 640 * 768 * (4 * 768 + 2 * 3072) + 4 * 16 * 40 * 40 * 768
    assert bert == pytest.approx(9.14e9, rel=1e-3)
    assert kinds["patch"] == pytest.approx(17.2e9, rel=1e-3)
    assert sum(kinds.values()) == pytest.approx(861.3e9, rel=1e-4)


def test_a_step_is_three_forwards_whatever_the_recompute():
    cfg = config("vault-bertweet-vilt-b32")
    step = flops.train_step_flops(cfg, 32, 40, CANVAS)
    assert step == 3 * flops.forward_flops(cfg, 32, 40, CANVAS)


def op(name, ts, dur, tid=1, dims=None, types=None, seq=None, cat="cpu_op"):
    args = {}
    if dims is not None:
        args.update({"Input Dims": dims, "Input type": types})
    if seq is not None:
        args["Sequence number"] = seq
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "tid": tid,
            "pid": 1, "args": args}


def launch(ts, corr, tid=1):
    return {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": ts,
            "dur": 2, "tid": tid, "pid": 1, "args": {"correlation": corr}}


def kernel(name, ts, dur, corr):
    return {"ph": "X", "cat": "kernel", "name": name, "ts": ts, "dur": dur, "tid": 7,
            "pid": 0, "args": {"correlation": corr}}


ATT_DIMS = [[64, 12, 256, 64]] * 3 + [[64, 1, 1, 256]]
ATT_TYPES = ["c10::BFloat16"] * 3 + ["float"]


def test_attention_least_time_by_hand():
    trace = devtrace.Trace([op("vault_tpu_torch::attention", 0, 10, dims=ATT_DIMS,
                               types=ATT_TYPES)])
    ops = 4.0 * 64 * 12 * 256 * 256 * 64  # q·kᵀ and p·v
    nbytes = 4 * (64 * 12 * 256 * 64 * 2) + 64 * 256 * 4  # q, k, v, out; bias
    assert ops == pytest.approx(12.885e9, rel=1e-4)
    want = max(ops / 989.4e12, nbytes / 3.35e12)
    assert reader("attn_roofline.score").least(trace, 0) == pytest.approx(want, rel=1e-12)
    assert want == pytest.approx(nbytes / 3.35e12)  # bound by bytes at D 64


@pytest.mark.parametrize("name,w_type,x_index,peak", [
    ("vault_tpu_torch::mlp_block", "c10::BFloat16", 6, 989.4e12),
    ("vault_tpu_torch::mlp_postln_w8a8", "signed char", 8, 1979e12)])
def test_mlp_least_time_by_hand(name, w_type, x_index, peak):
    rows, h, i = 64 * 256, 768, 3072
    if x_index == 6:  # gamma, beta, w1, b1, w2, b2, x, mask
        dims = [[h], [h], [h, i], [i], [i, h], [h], [64, 256, h], []]
        types = ["c10::BFloat16", "c10::BFloat16", w_type, "c10::BFloat16", w_type,
                 "c10::BFloat16", "c10::BFloat16", ""]
        nbytes = 2 * (4 * h + i) + 2 * 2 * h * i + 2 * 2 * rows * h
    else:  # gamma, beta, w1q, s1, b1, w2q, s2, b2, x
        dims = [[h], [h], [h, i], [1, i], [i], [i, h], [1, h], [h], [64, 256, h]]
        types = ["c10::BFloat16", "c10::BFloat16", w_type, "float", "c10::BFloat16",
                 w_type, "float", "c10::BFloat16", "c10::BFloat16"]
        nbytes = 2 * (3 * h + i) + 4 * (i + h) + 2 * h * i + 2 * 2 * rows * h
    trace = devtrace.Trace([op(name, 0, 10, dims=dims, types=types)])
    want = max(4.0 * rows * h * i / peak, nbytes / 3.35e12)
    assert reader("mlp_roofline.score").least(trace, 0) == pytest.approx(want, rel=1e-12)


def test_mlp_backward_takes_its_forward_shapes():
    rows, h, i = 1280, 768, 3072
    dims = [[h], [h], [h, i], [i], [i, h], [h], [32, 40, h], [32, 40, h]]
    types = ["c10::BFloat16"] * 8
    events = [op("_FusedMLP", 0, 5, dims=dims, types=types, seq=7),
              op("autograd::engine::evaluate_function: _FusedMLPBackward", 100, 50, seq=7),
              op("_FusedMLPBackward", 101, 40, seq=7)]
    trace = devtrace.Trace(events)
    m = reader("mlp_bwd_roofline.train")
    (index,) = trace.instances(m.match)
    assert trace.ops[index]["name"].startswith("autograd::engine")
    nbytes = 2 * 2 * (4 * h + 2 * h * i + i) + 4 * 2 * rows * h
    want = max(8.0 * rows * h * i / 989.4e12, nbytes / 3.35e12)
    assert m.least(trace, index) == pytest.approx(want, rel=1e-12)


def window_trace(extra=()):
    """A 100 µs window: an attention call launching one kernel (10-30 µs),
    a copy (40-50 µs) launched from the fetch span, and nothing else."""
    return [op(devtrace.WINDOW, 0, 100, cat="user_annotation"),
            op("portbench.forward", 1, 35, cat="user_annotation"),
            op("vault_tpu_torch::attention", 2, 20, dims=ATT_DIMS, types=ATT_TYPES),
            launch(5, corr=1),
            kernel("void attention_wgmma<64, false>(Params)", 10, 20, corr=1),
            op("portbench.fetch", 38, 30, cat="user_annotation"),
            launch(39, corr=2),
            kernel("void at::native::copy_kernel(float*)", 40, 10, corr=2),
            *extra]


def test_kernels_busy_time_and_idle_gaps():
    trace = devtrace.Trace(window_trace())
    assert trace.problem() is None
    assert trace.kernel_us(lambda n: n == "vault_tpu_torch::attention") == 20
    assert trace.busy_s() == pytest.approx(30e-6)
    assert trace.window_s() == pytest.approx(100e-6)
    assert trace.device_ops()[0] == ["attention_wgmma<64, false>", pytest.approx(20e-6)]
    gaps = dict(trace.idle_gaps())
    # each gap goes to the span the host was in where it began
    assert gaps["outside any span"] == pytest.approx(10e-6)  # 0-10
    assert gaps["portbench.forward"] == pytest.approx(10e-6)  # 30-40
    assert gaps["portbench.fetch"] == pytest.approx(50e-6)  # 50-100
    idle = reader("idle_pct.score").read(SimpleNamespace(traffic={"mode": "score"},
                                                          trace=trace))
    assert idle == pytest.approx(70.0)


def test_empty_and_short_traces_are_named():
    no_kernels = [e for e in window_trace() if e["cat"] != "kernel"]
    assert "no device events" in devtrace.Trace(no_kernels).problem()
    short = window_trace([launch(60, corr=3)])
    assert "1 of 3 launch calls have no kernel" in devtrace.Trace(short).problem()
    no_window = [e for e in window_trace() if e["name"] != devtrace.WINDOW]
    assert "no portbench.window" in devtrace.Trace(no_window).problem()


def test_roofline_share_and_its_silence():
    shapes = devtrace.Trace(window_trace())
    ctx = SimpleNamespace(traffic={"mode": "score"}, shape_trace=shapes, shape_iters=1,
                          trace=shapes, traced_iters=1)
    m = reader("attn_roofline.score")
    want = 100.0 * m.least(shapes, 2) / 20e-6
    assert m.read(ctx) == pytest.approx(want)
    # a traced window whose calls do not match the shape trace's: no reading
    ctx.traced_iters = 2
    assert m.read(ctx) is None
    ctx.traced_iters, ctx.trace = 1, None
    assert m.read(ctx) is None
    # a type the yardstick has no size for: no reading rather than a wrong one
    half = devtrace.Trace([{**e, "args": {**e["args"], "Input type": ["c10::Half"] * 4}}
                           if e["name"] == "vault_tpu_torch::attention" else e
                           for e in window_trace()])
    ctx.shape_trace, ctx.trace = half, shapes
    assert m.read(ctx) is None


def test_kernel_names_are_shortened():
    assert devtrace.short_name(
        "void sm90::gemm_kernel<__nv_bfloat16, 128, true>(Params, int)") == \
        "sm90::gemm_kernel<__nv_bfloat16, 128, true>"
    assert devtrace.short_name("void (anonymous namespace)::k(int)") == "k"


def test_peaks_are_the_data_sheets():
    assert (roofline.PEAK_BF16, roofline.PEAK_INT8, roofline.PEAK_BYTES) == \
        (989.4e12, 1979e12, 3.35e12)
    assert roofline.least_s(989.4e12, 0, roofline.PEAK_BF16) == pytest.approx(1.0)
    assert math.isclose(roofline.least_s(0, 3.35e12, roofline.PEAK_BF16), 1.0)
