"""The readers of the program's spans (``portbench/spans.py`` and the
metrics that use it) on synthetic Chrome traces: nested ``vault.*`` spans,
an idle gap that begins exactly at a span's end, kernels under nested
spans, a second thread, and a trace of a program without the spans, where
every reader finds nothing."""

import importlib.util
from pathlib import Path
from types import SimpleNamespace

import pytest

from portbench import devtrace, spans

HERE = Path(__file__).resolve().parents[1]
SCORE = ("embed_host_ms.score", "layer_host_us.score", "layer_launches.score",
         "layer_idle_ms.score")
TRAIN = ("forward_host_ms.train", "backward_host_ms.train", "optimizer_host_ms.train",
         "optimizer_launches.train")


def reader(name):
    spec = importlib.util.spec_from_file_location(name.replace(".", "_"),
                                                  HERE / "metrics" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def span(name, ts, end, tid=1):
    return {"ph": "X", "cat": "user_annotation", "name": name, "ts": ts, "dur": end - ts,
            "tid": tid, "pid": 1, "args": {}}


def launched(ts, corr, start, end, tid=1):
    """A launch call at ``ts`` on thread ``tid`` and its kernel on the device
    from ``start`` to ``end``."""
    return [{"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": ts,
             "dur": 1, "tid": tid, "pid": 1, "args": {"correlation": corr}},
            {"ph": "X", "cat": "kernel", "name": f"void k{corr}(int)", "ts": start,
             "dur": end - start, "tid": 7, "pid": 0, "args": {"correlation": corr}}]


def score_events():
    """One batch in a 200 µs window: the text tower (its embeddings and two
    layers), ViLT's embedding, its encoder (one layer) and the head, with a
    kernel launched from a second thread while the first layer runs."""
    return [span(devtrace.WINDOW, 0, 200), span("portbench.forward", 1, 150),
            span("vault.text_tower", 2, 60),
            span("vault.text_embed", 3, 10), *launched(4, 1, 5, 15),
            span("vault.layer", 12, 30), *launched(13, 2, 16, 25), *launched(20, 3, 26, 30),
            span("vault.layer", 32, 58), *launched(33, 4, 40, 50),
            span("vault.vilt_embed", 61, 64), *launched(62, 5, 65, 70),
            span("vault.vilt_encoder", 66, 140),
            span("vault.layer", 67, 100), *launched(68, 6, 80, 95),
            span("vault.head", 141, 148), *launched(142, 7, 150, 155),
            *launched(20, 8, 100, 105, tid=2),
            span("portbench.fetch", 151, 170), *launched(152, 9, 160, 165)]


def train_events():
    """Two steps in a 400 µs window; the backward's kernels come from
    autograd's thread (2), the second step's layer recompute in a span
    there."""
    out = [span(devtrace.WINDOW, 0, 400)]
    for s, t0, opt_launches in ((3, 0, 3), (4, 200, 2)):
        out += [span(f"train_step:{s}", t0 + 1, t0 + 190),
                span("vault.step.forward", t0 + 2, t0 + 60),
                span("vault.step.cast_params", t0 + 3, t0 + 10),
                span("vault.step.backward", t0 + 61, t0 + 150),
                *launched(t0 + 80, 10 * s, t0 + 85, t0 + 95, tid=2),
                span("vault.step.optimizer", t0 + 151, t0 + 189)]
        for i in range(opt_launches):
            out += launched(t0 + 152 + 10 * i, 10 * s + 1 + i, t0 + 155 + 10 * i,
                            t0 + 158 + 10 * i)
    out.append(span("vault.layer", 270, 300, tid=2))
    return out


def ctx(events, mode, iters):
    trace = devtrace.Trace(events)
    assert trace.problem() is None
    return SimpleNamespace(traffic={"mode": mode}, trace=trace, traced_iters=iters)


def test_spans_in_the_window_and_their_durations():
    trace = devtrace.Trace(score_events())
    names = [trace.ops[i]["name"] for i in spans.in_window(trace)]
    assert names == ["vault.text_tower", "vault.text_embed", "vault.layer", "vault.layer",
                     "vault.vilt_embed", "vault.vilt_encoder", "vault.layer", "vault.head"]
    assert spans.durations_us(trace, "vault.layer") == [18, 26, 33]
    assert spans.in_window(None) == []


def test_kernels_under_nested_spans_and_not_from_another_thread():
    trace = devtrace.Trace(score_events())
    # kernels 2, 3 (first layer), 4 (second) and 6 (ViLT's); kernel 8 was
    # launched from thread 2 while the first layer ran on thread 1
    assert spans.kernels_under(trace, "vault.layer") == 4
    assert spans.kernels_under(trace, "vault.text_tower") == 4
    assert spans.kernels_under(trace, "vault.vilt_encoder") == 1
    assert spans.kernels_under(trace, "vault.step.optimizer") == 0


def test_idle_gaps_go_to_the_innermost_span():
    idle = spans.idle_by_span(devtrace.Trace(score_events()))
    # 15-16 and 25-26 in the first layer, 30-40 from its last kernel's end,
    # which is the layer's own end, 50-65 in the second, 70-80 and 95-100
    # in ViLT's; 105-150 in ViLT's encoder after its layer; 0-5 and 155-200
    # begin outside every program span
    assert set(idle) == {"vault.layer", "vault.vilt_encoder"}
    assert idle["vault.layer"] == pytest.approx(42e-6)
    assert idle["vault.vilt_encoder"] == pytest.approx(45e-6)


def test_a_gap_that_begins_exactly_at_a_span_end_is_that_spans():
    events = [span(devtrace.WINDOW, 0, 100), span("vault.text_tower", 1, 90),
              span("vault.layer", 5, 30), *launched(6, 1, 10, 30),
              span("vault.layer", 40, 60), *launched(41, 2, 50, 60)]
    idle = spans.idle_by_span(devtrace.Trace(events))
    # 30-50 begins at the first layer's end, 60-100 at the second's; 0-10
    # before the tower
    assert idle == {"vault.layer": pytest.approx(60e-6)}
    events[2]["dur"] = 23  # the first layer now ends at 28: its gap is the tower's
    idle = spans.idle_by_span(devtrace.Trace(events))
    assert idle["vault.text_tower"] == pytest.approx(20e-6)


def test_a_gap_goes_to_the_span_that_began_last_over_threads():
    idle = spans.idle_by_span(devtrace.Trace(train_events()))
    # step 4: 295-355 begins inside the backward (thread 1) and inside the
    # recomputed layer (thread 2, begun later)
    assert idle["vault.layer"] == pytest.approx(60e-6)
    assert idle["vault.step.backward"] == pytest.approx(60e-6)  # step 3: 95-155
    assert "vault.step.cast_params" not in idle


def test_score_readers_by_hand():
    c = ctx(score_events(), "score", 1)
    got = {name: reader(name).read(c) for name in SCORE}
    assert got["embed_host_ms.score"] == pytest.approx((7 + 3) / 1e3)
    assert got["layer_host_us.score"] == pytest.approx((18 + 26 + 33) / 3)
    assert got["layer_launches.score"] == pytest.approx(4 / 3)
    assert got["layer_idle_ms.score"] == pytest.approx(42e-3)
    c.traced_iters = 2
    assert reader("layer_idle_ms.score").read(c) == pytest.approx(21e-3)
    assert reader("embed_host_ms.score").read(c) == pytest.approx(5e-3)
    assert all(reader(name).read(c) is None for name in TRAIN)


def test_train_readers_by_hand():
    c = ctx(train_events(), "train", 2)
    got = {name: reader(name).read(c) for name in TRAIN}
    assert got["forward_host_ms.train"] == pytest.approx(58e-3)
    assert got["backward_host_ms.train"] == pytest.approx(89e-3)
    assert got["optimizer_host_ms.train"] == pytest.approx(38e-3)
    assert got["optimizer_launches.train"] == pytest.approx((3 + 2) / 2)
    assert all(reader(name).read(c) is None for name in SCORE)


@pytest.mark.parametrize("mode", ["score", "train"])
def test_without_the_program_spans_every_reader_is_silent(mode):
    events = [e for e in (score_events() if mode == "score" else train_events())
              if not e["name"].startswith("vault.")]
    c = ctx(events, mode, 1)
    assert spans.idle_by_span(c.trace) == {}
    assert [reader(name).read(c) for name in SCORE + TRAIN] == [None] * 8
    c.trace, c.traced_iters = None, 0  # an untraced run
    assert [reader(name).read(c) for name in SCORE + TRAIN] == [None] * 8
