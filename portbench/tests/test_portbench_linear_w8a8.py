"""linear_w8a8_roofline.score on fake traces: the least time of one call
worked by hand, with and without the bias, its share over the row pass and
the product launched under the operator, and its silence where the operator
never runs (a parent without the kernel, a training cell)."""

import importlib.util
from pathlib import Path
from types import SimpleNamespace

import pytest

from portbench import devtrace

HERE = Path(__file__).resolve().parents[1]
NAME = "linear_w8a8_roofline.score"
OPERATOR = "vault_tpu_torch::linear_w8a8"
# BERT's attention output projection at batch 256, 40 tokens: x, the codes,
# the scales and the bias
ROWS, K, N = 256 * 40, 768, 768


def dims_types(bias):
    """The operator's inputs as the profiler records them; an absent
    optional bias has no dims and no type."""
    dims = [[256, 40, K], [K, N], [1, N], [N] if bias else []]
    types = ["c10::BFloat16", "signed char", "float", "c10::BFloat16" if bias else ""]
    return dims, types


def reader():
    spec = importlib.util.spec_from_file_location(NAME.replace(".", "_"),
                                                  HERE / "metrics" / f"{NAME}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def op(name, ts, dur, tid=1, dims=None, types=None, cat="cpu_op"):
    args = {} if dims is None else {"Input Dims": dims, "Input type": types}
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "tid": tid, "pid": 1,
            "args": args}


def launch(ts, corr, tid=1):
    return {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": ts, "dur": 2,
            "tid": tid, "pid": 1, "args": {"correlation": corr}}


def kernel(name, ts, dur, corr):
    return {"ph": "X", "cat": "kernel", "name": name, "ts": ts, "dur": dur, "tid": 7,
            "pid": 0, "args": {"correlation": corr}}


def score_trace(calls=1, bias=True):
    """A window with ``calls`` linear calls, each launching its row pass
    (20 µs) and its product (30 µs), and an unrelated copy."""
    dims, types = dims_types(bias)
    events = [op(devtrace.WINDOW, 0, 10_000, cat="user_annotation")]
    for c in range(calls):
        t0 = 100 + 200 * c
        events += [op(OPERATOR, t0, 60, dims=dims, types=types),
                   launch(t0 + 5, corr=2 * c + 1), launch(t0 + 10, corr=2 * c + 2),
                   kernel("void row_prologue<false>(Params)", t0 + 20, 20, 2 * c + 1),
                   kernel("void sm90::gemm_kernel<signed char, 128, false, 0, false, "
                          "EpiDequant8>(Params)", t0 + 40, 30, 2 * c + 2)]
    events += [op("aten::copy_", 9_000, 50), launch(9_010, corr=999),
               kernel("void at::native::copy_kernel(float*)", 9_020, 30, 999)]
    return devtrace.Trace(events)


@pytest.mark.parametrize("bias", [True, False])
def test_least_time_by_hand(bias):
    trace = score_trace(bias=bias)
    m = reader()
    (index,) = trace.instances(m.match)
    nbytes = 2 * ROWS * K + K * N + 4 * N + (2 * N if bias else 0) + 2 * ROWS * N
    want = max(2.0 * ROWS * K * N / 1979e12, nbytes / 3.35e12)
    assert m.least(trace, index) == pytest.approx(want, rel=1e-12)
    assert want == pytest.approx(nbytes / 3.35e12)  # bound by bytes at K 768


@pytest.mark.parametrize("calls", [1, 4])
def test_share_over_both_launches(calls):
    trace = score_trace(calls)
    m = reader()
    ctx = SimpleNamespace(traffic={"mode": "score"}, shape_trace=score_trace(1),
                          shape_iters=1, trace=trace, traced_iters=calls)
    least = m.least(trace, trace.instances(m.match)[0])
    assert trace.kernel_us(m.match) == 50 * calls
    assert m.read(ctx) == pytest.approx(100.0 * least / 50e-6)


def test_silent_without_the_operator_and_while_training():
    m = reader()
    whole = score_trace()
    parent = devtrace.Trace([e for e in whole.ops + whole.kernels if e["name"] != OPERATOR])
    ctx = SimpleNamespace(traffic={"mode": "score"}, shape_trace=parent, shape_iters=1,
                          trace=parent, traced_iters=1)
    assert m.read(ctx) is None
    ctx = SimpleNamespace(traffic={"mode": "train"}, shape_trace=whole, shape_iters=1,
                          trace=whole, traced_iters=1)
    assert m.read(ctx) is None
