"""attn_bwd_roofline.train on fake traces: the least time of one backward
call worked by hand, its share over the kernels launched under the
operator, and its silence where the operator never runs (a parent without
the backward kernel, a scoring cell)."""

import importlib.util
from pathlib import Path
from types import SimpleNamespace

import pytest

from portbench import devtrace

HERE = Path(__file__).resolve().parents[1]
NAME = "attn_bwd_roofline.train"
# ViLT-B/32 in a training step at batch 256: q, k, v, the key bias, dO
DIMS = [[256, 12, 256, 64]] * 3 + [[256, 1, 1, 256], [256, 12, 256, 64]]
TYPES = ["c10::BFloat16"] * 3 + ["float", "c10::BFloat16"]


def reader():
    spec = importlib.util.spec_from_file_location(NAME.replace(".", "_"),
                                                  HERE / "metrics" / f"{NAME}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def op(name, ts, dur, tid=2, dims=None, types=None, cat="cpu_op"):
    args = {} if dims is None else {"Input Dims": dims, "Input type": types}
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "tid": tid, "pid": 1,
            "args": args}


def launch(ts, corr, tid=2):
    return {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": ts, "dur": 2,
            "tid": tid, "pid": 1, "args": {"correlation": corr}}


def kernel(name, ts, dur, corr):
    return {"ph": "X", "cat": "kernel", "name": name, "ts": ts, "dur": dur, "tid": 7,
            "pid": 0, "args": {"correlation": corr}}


def step_trace(calls=1):
    """A window with ``calls`` backward calls on the autograd engine's
    thread, each launching its query pass (300 µs) and key pass (400 µs),
    and an unrelated copy."""
    events = [op(devtrace.WINDOW, 0, 10_000, tid=1, cat="user_annotation")]
    for c in range(calls):
        t0 = 100 + 2_000 * c
        events += [op("autograd::engine::evaluate_function: _AttentionBackward", t0, 900),
                   op("vault_tpu_torch::attention_bwd", t0 + 5, 800, dims=DIMS, types=TYPES),
                   launch(t0 + 10, corr=2 * c + 1), launch(t0 + 20, corr=2 * c + 2),
                   kernel("void attention_bwd_dq<64, false>(Params)", t0 + 30, 300, 2 * c + 1),
                   kernel("void attention_bwd_dkv<64, false>(Params)", t0 + 330, 400,
                          2 * c + 2)]
    events += [op("aten::copy_", 9_000, 50, tid=1), launch(9_010, corr=99, tid=1),
               kernel("void at::native::copy_kernel(float*)", 9_020, 30, 99)]
    return devtrace.Trace(events)


def test_least_time_by_hand():
    trace = step_trace()
    m = reader()
    (index,) = trace.instances(m.match)
    ops = 8.0 * 256 * 12 * 256 * 256 * 64  # dV, dP, dq, dk
    q = 256 * 12 * 256 * 64 * 2
    nbytes = 4 * q + 256 * 256 * 4 + 3 * q  # q, k, v, dO and the bias; dq, dk, dv
    assert ops == pytest.approx(103.08e9, rel=1e-4)
    assert nbytes == pytest.approx(705.0e6, rel=1e-3)
    want = max(ops / 989.4e12, nbytes / 3.35e12)  # the bytes: 0.2105 ms
    assert m.least(trace, index) == pytest.approx(want, rel=1e-12)
    assert want == pytest.approx(0.2105e-3, rel=1e-3)


@pytest.mark.parametrize("calls", [1, 3])
def test_share_over_both_passes(calls):
    trace = step_trace(calls)
    m = reader()
    ctx = SimpleNamespace(traffic={"mode": "train"}, shape_trace=step_trace(1),
                          shape_iters=1, trace=trace, traced_iters=calls)
    least = m.least(trace, trace.instances(m.match)[0])
    assert trace.kernel_us(m.match) == 700 * calls
    assert m.read(ctx) == pytest.approx(100.0 * least / 700e-6)


def test_silent_without_the_operator_and_while_scoring():
    m = reader()
    parent = devtrace.Trace([e for e in step_trace().ops + step_trace().kernels
                             if "attention_bwd" not in e["name"]])
    ctx = SimpleNamespace(traffic={"mode": "train"}, shape_trace=parent, shape_iters=1,
                          trace=parent, traced_iters=1)
    assert m.read(ctx) is None
    ctx = SimpleNamespace(traffic={"mode": "score"}, shape_trace=step_trace(), shape_iters=1,
                          trace=step_trace(), traced_iters=1)
    assert m.read(ctx) is None
