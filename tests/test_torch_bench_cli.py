"""The port's bench CLIs on the CPU (``python -m vault_tpu_torch.cli.
{bench,train_bench,perf_sweep,ablate_train}`` with ``--device cpu``), at the
tiny debug geometry and a 64 × 64 canvas, across the knob combinations
that ``tests/test_bench_scripts_smoke.py`` runs for the JAX package's
scripts: each prints its JSON line(s) with their keys, its guard passes,
and a misspelled knob raises before anything is built.  The timings
themselves mean nothing here; they come from the card.
"""

import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from vault_tpu_torch.cli import ablate_train, bench, perf_sweep, train_bench

ROOT = Path(__file__).resolve().parent.parent
TINY = ["--device", "cpu", "--debug_tiny"]
SHORT = ["--k_lo", "1", "--k_hi", "3", "--repeats", "1"]


def _lines(capsys):
    out = capsys.readouterr().out
    return [json.loads(ln) for ln in out.splitlines() if ln.startswith("{")]


@pytest.mark.parametrize("train", [False, True], ids=["forward", "with_train_leg"])
def test_bench_prints_one_record(capsys, train):
    env = {"VAULT_BENCH_TRAIN": "1", "VAULT_BENCH_TRAIN_BATCH": "2"} if train else {}
    rec = bench.main(TINY + SHORT + ["--canvas", "64,64", "--batch", "2", "--seq", "8"],
                     environ=env)
    lines = _lines(capsys)
    assert lines == [json.loads(json.dumps(rec))]
    assert rec["metric"] == "vault_forward_pairs_per_sec_per_card"
    assert rec["value"] > 0 and rec["vs_baseline"] > 0 and rec["baseline_pairs_per_sec"] > 0
    assert rec["baseline"] == "port plain path, fp32, host CPU, batch 4"
    assert rec["p50_host_process_encode_ms"] > 0
    assert rec["host_process_encode_device"] == "cpu"
    assert rec["guard_sound"] and rec["products_in_loop"] == 2 * rec["products_per_forward"]
    assert rec["products_per_forward"] == 8 * 4 + 3  # + the patch projection, pooler, head
    assert not rec["launches_checked"] and "suspect" not in rec
    assert rec["busy_ms"] is None and rec["fwd_busy_mfu_pct"] is None  # no CUPTI here
    assert 0 < rec["fwd_mfu_pct"] < 95 and rec["peak_tflops"] == 989.4
    assert rec["device"]["power_limit"] is None
    if train:
        assert rec["train_source"] == "live" and rec["train_batch"] == 2
        t = rec["train"]
        assert (t["remat"], t["opt_dtype"], t["nodrop"]) == (True, "bfloat16", False)
        assert t["guard_sound"] and rec["train_pairs_per_sec"] == t["value"] > 0
    else:
        assert "train_pairs_per_sec" not in rec


def test_bench_peak_override_and_suspect_flag(capsys):
    """VAULT_BF16_PEAK_TFLOPS replaces the H100's peak; a reading above 95%
    of it is flagged in the record and on stderr."""
    rec = bench.main(TINY + SHORT + ["--canvas", "64,64", "--batch", "2", "--seq", "8"],
                     environ={"VAULT_BF16_PEAK_TFLOPS": "1e-9"})
    assert rec["peak_tflops"] == 1e-9 and rec["fwd_mfu_pct"] > 95
    assert "fwd_mfu_pct above 95.0% of the peak" in rec["suspect"]
    assert "implausible" in capsys.readouterr().err


TRAIN_LEGS = [
    {},
    {"TRAIN_BENCH_MERGE_TO": "3"},
    {"TRAIN_BENCH_MERGE_TO": "3", "TRAIN_BENCH_MERGE_LAYER": "4"},
    {"TRAIN_BENCH_REMAT": "dots", "TRAIN_BENCH_OPT_DTYPE": "int8"},
    {"TRAIN_BENCH_REMAT": "1", "TRAIN_BENCH_NODROP": "1", "TRAIN_BENCH_GRAD_BF16": "1",
     "TRAIN_BENCH_OPT_DTYPE": "bfloat16"},
]


@pytest.mark.parametrize("extra", TRAIN_LEGS,
                         ids=["control", "merge", "merge_at_4", "dots_int8", "remat_nodrop_bf16"])
def test_train_bench_legs(capsys, extra):
    env = {"TRAIN_BENCH_BATCH": "2", "TRAIN_BENCH_CANVAS": "64,64", **extra}
    rec = train_bench.main(TINY + ["--k_lo", "1", "--k_hi", "2", "--repeats", "1"],
                           environ=env)
    assert _lines(capsys) == [json.loads(json.dumps(rec))]
    assert rec["metric"] == "vault_train_step_pairs_per_sec_per_card" and rec["value"] > 0
    assert rec["batch"] == 2 and rec["canvas"] == [64, 64]
    assert rec["merge_to"] == (3 if "TRAIN_BENCH_MERGE_TO" in extra else None)
    assert rec["merge_at_layer"] == int(extra.get("TRAIN_BENCH_MERGE_LAYER", 0))
    assert rec["opt_dtype"] == extra.get("TRAIN_BENCH_OPT_DTYPE", "float32")
    assert rec["remat"] == {"0": False, "1": True, "dots": "dots"}[
        extra.get("TRAIN_BENCH_REMAT", "0")]
    assert rec["guard_sound"] and rec["products_in_loop"] == rec["products_per_step"] > 0
    assert rec["ms_per_train_step"] > 0 and rec["train_mfu_pct"] > 0
    assert {"busy_ms", "idle_share", "train_busy_mfu_pct", "device"} <= rec.keys()


SWEEP_LEGS = [
    {"PERF_SWEEP_IMPLS": "1"},
    {"PERF_SWEEP_IMPLS": "fuselnqkv+fusemlp", "PERF_SWEEP_QUANT": "w8a8",
     "PERF_SWEEP_MERGE_TO": "3"},
    {"PERF_SWEEP_IMPLS": "1", "PERF_SWEEP_MERGE_TO": "3", "PERF_SWEEP_MERGE_LAYER": "4"},
    {"PERF_SWEEP_IMPLS": "0,1", "PERF_SWEEP_QUANT": "w8", "PERF_SWEEP_BATCHES": "2,3"},
]


@pytest.mark.parametrize("extra", SWEEP_LEGS,
                         ids=["bf16_control", "w8a8_merge", "merge_at_4", "w8_both_impls"])
def test_perf_sweep_legs(capsys, extra):
    env = {"PERF_SWEEP_CANVAS": "64,64", "PERF_SWEEP_BATCHES": "2", **extra}
    rows = perf_sweep.main(TINY + SHORT, environ=env)
    assert _lines(capsys) == json.loads(json.dumps(rows))
    impls = env["PERF_SWEEP_IMPLS"].split(",")
    batches = [int(b) for b in env["PERF_SWEEP_BATCHES"].split(",")]
    assert [(r["impl"], r["batch"]) for r in rows] == [(i, b) for i in impls for b in batches]
    for r in rows:
        assert r["pairs_per_sec"] > 0 and r["ms_per_step"] > 0 and "busy_ms" in r
        assert r["quant"] == env.get("PERF_SWEEP_QUANT", "0")
        assert r["merge_to"] == (3 if "PERF_SWEEP_MERGE_TO" in env else None)
        want = {"0": False, "1": "fuselnqkv+fusemlp" if r["quant"] == "w8a8" else "auto"}
        assert r["use_pallas"] == want.get(r["impl"], r["impl"])


def test_perf_sweep_goes_on_after_running_out_of_memory(capsys, monkeypatch):
    """A leg that runs out of the card's memory prints its error record and
    the sweep goes on; any other error ends the run."""
    real = perf_sweep.measure_leg

    def leg(model, cfg, bs, impl, *a, **kw):
        if bs == 3:
            raise torch.cuda.OutOfMemoryError("CUDA out of memory")
        return real(model, cfg, bs, impl, *a, **kw)

    monkeypatch.setattr(perf_sweep, "measure_leg", leg)
    rows = perf_sweep.main(TINY + SHORT, environ={"PERF_SWEEP_CANVAS": "64,64",
                                                  "PERF_SWEEP_BATCHES": "3,2",
                                                  "PERF_SWEEP_IMPLS": "0"})
    assert "out of memory" in rows[0]["error"] and rows[1]["pairs_per_sec"] > 0
    assert len(_lines(capsys)) == 2

    def broken(*a, **kw):
        raise RuntimeError("a kernel failed")

    monkeypatch.setattr(perf_sweep, "measure_leg", broken)
    with pytest.raises(RuntimeError, match="a kernel failed"):
        perf_sweep.main(TINY + SHORT, environ={"PERF_SWEEP_CANVAS": "64,64",
                                               "PERF_SWEEP_BATCHES": "2"})


@pytest.mark.parametrize("variants", ["fwd,fwdbwd,opt,full", "opt"])
def test_ablate_train_split(capsys, variants):
    env = {"TRAIN_BENCH_BATCH": "2", "TRAIN_BENCH_CANVAS": "64,64",
           "ABLATE_VARIANTS": variants}
    rec = ablate_train.main(TINY + ["--k_lo", "1", "--k_hi", "2", "--repeats", "1"],
                            environ=env)
    assert _lines(capsys) == [json.loads(json.dumps(rec))]
    names = variants.split(",")
    assert list(rec["variants"]) == names and rec["remat"] is True
    for v in rec["variants"].values():
        assert v["ms"] > 0 and v["busy_ms"] is None
    if len(names) == 4:
        assert rec["full_minus_fwdbwd_ms"] == (rec["variants"]["full"]["ms"]
                                               - rec["variants"]["fwdbwd"]["ms"])
        assert rec["opt_ms"] == rec["variants"]["opt"]["ms"]
        assert rec["fwdbwd_minus_fwd_ms"] is not None
    else:
        assert "full_minus_fwdbwd_ms" not in rec


TYPOS = [
    (bench, {"VAULT_BENCH_TRAINN": "1"}, "unknown knob"),
    (bench, {"VAULT_BENCH_TRAIN": "yes"}, "VAULT_BENCH_TRAIN='yes'"),
    (bench, {"VAULT_BF16_PEAK_TFLOPS": "-3"}, "must be positive"),
    (train_bench, {"TRAIN_BENCH_REMATT": "1"}, "unknown knob"),
    (train_bench, {"TRAIN_BENCH_REMAT": "2"}, "use 0, 1 or dots"),
    (train_bench, {"TRAIN_BENCH_OPT_DTYPE": "float16"}, "OPT_DTYPE"),
    (train_bench, {"TRAIN_BENCH_RBG": "1"}, "unknown knob"),
    (train_bench, {"TRAIN_BENCH_CANVAS": "64x64"}, "CANVAS"),
    (perf_sweep, {"PERF_SWEEP_QUANT": "int4"}, "use 0, w8 or w8a8"),
    (perf_sweep, {"PERF_SWEEP_IMPLS": "fusemlpp"}, "unknown use_pallas token"),
    (perf_sweep, {"PERF_SWEEP_BATCH": "16"}, "unknown knob"),
    (ablate_train, {"ABLATE_VARIANTS": "fwd,bwd"}, "ABLATE_VARIANTS"),
    (ablate_train, {"TRAIN_BENCH_BATCH": "0"}, "must be positive"),
]


@pytest.mark.parametrize("cli,env,match", TYPOS,
                         ids=[f"{c.__name__.rsplit('.', 1)[-1]}-{next(iter(e))}" for c, e, _ in TYPOS])
def test_a_knob_typo_raises(monkeypatch, cli, env, match):
    """Nothing is built or measured under a knob the CLI does not know or a
    value it refuses."""
    from vault_tpu_torch.models import vault as tvault

    def never(*a, **kw):
        raise AssertionError("a model was built")

    monkeypatch.setattr(tvault.VaultForClassification, "__init__", never)
    with pytest.raises(ValueError, match=match):
        cli.main(TINY + SHORT, environ=env)


@pytest.mark.parametrize("cli", [bench, train_bench, perf_sweep, ablate_train],
                         ids=lambda c: c.__name__.rsplit(".", 1)[-1])
def test_without_a_card_the_clis_raise(monkeypatch, cli):
    """No card and no --device cpu: the CLIs raise, they do not fall back to
    the host."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["--debug_tiny"], environ={})


def test_perf_sweep_runs_as_a_module():
    """``python -m vault_tpu_torch.cli.perf_sweep`` (the entry point a user
    types), environment knobs included: one JSON line on stdout."""
    env = {"PATH": "/usr/bin:/bin", "PERF_SWEEP_CANVAS": "64,64",
           "PERF_SWEEP_BATCHES": "2", "PERF_SWEEP_IMPLS": "0", "PYTHONPATH": str(ROOT)}
    res = subprocess.run([sys.executable, "-m", "vault_tpu_torch.cli.perf_sweep", *TINY,
                          *SHORT], cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    lines = [ln for ln in res.stdout.splitlines() if ln.strip()]
    assert len(lines) == 1 and json.loads(lines[0])["pairs_per_sec"] > 0


def test_the_guard_catches_a_step_that_reuses_its_gradients():
    """The training chain's guard: a chain that takes the gradients once and
    then only updates (the backward hoisted out of its steps) leaves the
    forward's and backward's products outside; the trainer's own chain
    leaves none."""
    from vault_tpu_torch.utils.benchloop import product_placement

    knobs = train_bench.default_knobs(BATCH=2, CANVAS=(64, 64))
    sb = train_bench.StepBench(knobs, "cpu", debug_tiny=True, seq=8)
    tr = sb.trainer

    def hoisted(m, _b, k):
        _, grads = tr.loss_and_grads(sb.batch, sb.labels, sb.weight, tr.step_generator(0))
        for _ in range(k):
            tr.opt_state = tr.tx.step_(tr.trainable, grads, tr.opt_state)

    good = product_placement(lambda m, _b, k: m.chain(k), lambda m, _b: m.step(),
                             sb, sb.batch, 1, 3)
    bad = product_placement(hoisted, lambda m, _b: m.step(), sb, sb.batch, 1, 3)
    assert good.sound and good.inside == 2 * good.per_call
    assert not bad.sound and bad.inside == 0 and bad.outside == 2 * bad.per_call > 0
