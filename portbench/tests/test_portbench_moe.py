"""The ``vault_moe`` family (Moonlight-16B-A3B feeding ViLT-B/32): its cell
runs from a copied checkout at the family's tiny size on the CPU, added
as files alone; its reference agrees with the repository's test reference
of the tower (``tests/deepseek_reference.py``); each leaf has its own
stream; its products at the published shapes are the hand-counted ones;
its three readers read a synthetic trace and fall silent on a program
without the operator or the spans."""

import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from portbench import devtrace, families, flops
from portbench.generate import make_batch
from portbench.spec import Spec

from conftest import REPO, TINY_TRAFFIC, copy_benchmark, shrink

TINY_TRAFFIC_CHECKED = json.loads((Path(__file__).resolve().parents[1] / "traffic"
                                   / "score_b256.json").read_text())["check_batches"]

CPU = torch.device("cpu")
SEED = 2**33 + 12345
CELL = "moonlight-bf16.score_b256"
CONFIG = "vault-moonlight-16b-a3b-vilt-b32"
HERE = Path(__file__).resolve().parents[1]

RUNNER = '''
import json, sys
import torch
from portbench import families, generate, run
from portbench.spec import Spec

made, draw = [], generate.make_weights

def counted(cfg, *args, **kwargs):
    made.append(families.load(cfg, "weights").__file__)
    return draw(cfg, *args, **kwargs)

generate.make_weights = counted
out = run.run_cell(Spec(), sys.argv[2], int(sys.argv[1]), 0.3, False, torch.device("cpu"))
from portbench.families.vault_moe import routes
print(json.dumps({"result": out, "made": made, "harness": run.__file__,
                  "routes_taken": sorted(k[1] for k in routes._taken),
                  "program_held": routes._router is not None}))
'''


def test_the_cell_runs_from_a_copied_checkout(tmp_path):
    root = copy_benchmark(tmp_path)
    shrink(root)
    path = [str(tmp_path), str(REPO), *os.environ.get("PYTHONPATH", "").split(os.pathsep)]
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(p for p in path if p),
           "PYTHONDONTWRITEBYTECODE": "1", "CUDA_VISIBLE_DEVICES": ""}
    done = subprocess.run([sys.executable, "-c", RUNNER, str(SEED), CELL], cwd=tmp_path, env=env,
                          capture_output=True, text=True, timeout=600)
    assert done.returncode == 0, done.stderr[-4000:]
    line = json.loads(done.stdout.strip().splitlines()[-1])
    assert Path(line["harness"]).resolve() == (root / "run.py").resolve()
    result = line["result"]
    assert result["correct"], result["checks"]
    assert result["attempted"] > 0 and result["failed"] == 0
    assert set(result["metrics"]) == {"setup_s", "score_pairs_per_s", "score_p95_ms"}
    assert line["made"] == [str((root / "families" / "vault_moe" / "weights.py").resolve())]
    # the reference took the program's routes of the batches it checked,
    # and let the program go
    assert len(line["routes_taken"]) == min(TINY_TRAFFIC_CHECKED, result["attempted"])
    assert not line["program_held"]


def _keys(tie):
    """Scores + bias of 4 rows over 5 experts, 2 a row: row 0's second and
    third lie half the tie apart, row 1's twice the tie, rows 2 and 3 well
    apart."""
    return torch.tensor([[0.9, 0.6, 0.6 - tie / 2, 0.1, 0.0],
                         [0.9, 0.6, 0.6 - 2 * tie, 0.1, 0.0],
                         [0.1, 0.2, 0.3, 0.8, 0.9],
                         [0.5, 0.1, 0.2, 0.3, 0.9]], dtype=torch.float64)


def test_the_reference_follows_the_program_at_a_tie_and_nowhere_else(tiny_spec):
    ref = families.load(tiny_spec.config(CONFIG), "reference")
    assert 0 < ref.TIE < 0.25
    key = _keys(ref.TIE)
    own = ref.choose(key, 2)
    assert own.sort(-1).values.tolist() == [[0, 1], [0, 1], [3, 4], [0, 4]]
    # the program's third expert in place of the second: followed within the
    # tie (row 0), refused beyond it (row 1); another order of the same two
    # experts is the same choice (row 2); a repeated expert is refused (row 3)
    given = torch.tensor([[0, 2], [0, 2], [4, 3], [4, 4]])
    seen = []
    got = ref.choose(key, 2, given, seen)
    assert got.tolist() == [[0, 2], own[1].tolist(), [4, 3], own[3].tolist()]
    assert seen == [{"followed": 0.25, "refused": 0.5, "shortfall": pytest.approx(ref.TIE / 2)}]
    # an expert out of range is refused, and nothing is read past the scores
    assert ref.choose(key, 2, torch.tensor([[0, 5]] * 4)).tolist() == own.tolist()


def _test_reference():
    spec = importlib.util.spec_from_file_location("deepseek_reference",
                                                  REPO / "tests" / "deepseek_reference.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_the_reference_agrees_with_the_test_reference(tiny_spec):
    cfg = tiny_spec.config(CONFIG)
    traffic = tiny_spec.traffic("score_b256")
    w = families.load(cfg, "weights")
    ref = families.load(cfg, "reference")
    batch, _ = make_batch(traffic, cfg, SEED, 0, CPU)
    ids, mask = batch["input_ids"], batch["attention_mask"]
    leaves = {k.removeprefix("deepseek."): v.float()
              for k, v in w.draw(cfg, SEED, torch.float32, CPU) if k.startswith("deepseek.")}
    tower = {**cfg["text_tower"], "kv_norm_eps": cfg["assumed"]["kv_norm_eps"]}
    routes = []
    with torch.no_grad():
        got = ref.tower(cfg, SEED, ids, mask, CPU, routes=routes)
        want = _test_reference().tower(leaves, tower, ids, mask)
    assert got.shape == (TINY_TRAFFIC["batch"], TINY_TRAFFIC["text_positions"], 32)
    torch.testing.assert_close(got, want, atol=2e-5, rtol=1e-5)
    assert len(routes) == 2 and routes[0].shape == (ids.numel(), 2)


def test_each_leaf_has_a_stream_of_its_own(tiny_spec):
    cfg = tiny_spec.config(CONFIG)
    w = families.load(cfg, "weights")
    shapes = w.param_shapes(cfg)
    every = w.make_weights(cfg, SEED, torch.bfloat16, CPU)
    assert list(every) == list(shapes) and all(every[k].shape == s for k, s in shapes.items())
    name = "deepseek.layers.2.experts.down"
    (_, alone), = w.draw(cfg, SEED, torch.bfloat16, CPU, {name})
    assert torch.equal(alone, every[name]) and alone.dtype == torch.bfloat16
    assert every["deepseek.layers.1.router_bias"].abs().max() > 0
    assert (every["deepseek.final_ln"] - 1).abs().max() > 0


def test_the_configuration_is_the_catalogs():
    cfg = json.loads((HERE / "configs" / f"{CONFIG}.json").read_text())
    tower = dict(cfg["text_tower"])
    assert (tower.pop("pad_token_id"), tower.pop("initializer_range")) == (163839, 0.02)
    assert {k: cfg[k] for k in tower} == tower
    assert cfg["family"] == "vault_moe" and cfg["reduced"] == [] and cfg["quantize"] is None
    assert (tower["num_hidden_layers"], tower["n_routed_experts"], tower["num_experts_per_tok"],
            tower["vocab_size"]) == (27, 64, 6, 163840)


def test_products_at_the_published_shapes():
    spec = Spec()
    c = spec.cell(CELL)
    cfg, t = spec.config(c["config"]), spec.traffic(c["traffic"])
    kinds = flops.forward_products(cfg, t["batch"], t["text_positions"], tuple(t["canvas"]))
    tokens, h, i = 256 * 40, 2048, 1408
    assert kinds["experts"] == 2.0 * tokens * 26 * 3 * h * i * (6 + 2)
    assert kinds["experts"] * 6 / 8 == pytest.approx(27.6e12, rel=2e-3)
    assert kinds["experts"] == pytest.approx(36.9e12, rel=2e-3)
    assert kinds["router"] == 2.0 * tokens * 26 * h * 64
    assert kinds["attention"] > 2.0 * 256 * 40 * 40 * 16 * 320 * 27
    assert sum(kinds.values()) == pytest.approx(58.1e12, rel=2e-3)
    assert kinds["experts"] / sum(kinds.values()) == pytest.approx(0.635, abs=0.005)


def reader(name):
    spec = importlib.util.spec_from_file_location(name.replace(".", "_"),
                                                  HERE / "metrics" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _ev(name, ts, dur, cat="cpu_op", dims=None, types=None, tid=1):
    args = {} if dims is None else {"Input Dims": dims, "Input type": types}
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "tid": tid, "pid": 1,
            "args": args}


def _launch(ts, corr):
    return {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": ts, "dur": 1,
            "tid": 1, "pid": 1, "args": {"correlation": corr}}


def _kernel(ts, dur, corr):
    return {"ph": "X", "cat": "kernel", "name": "grouped_kernel", "ts": ts, "dur": dur,
            "tid": 7, "pid": 0, "args": {"correlation": corr}}


R, H, I, E = 61440, 2048, 1408, 64
DIMS = [[R, H], [E, I, H], [E, I, H], [E, H, I], [E + 1], [R]]
TYPES = ["c10::BFloat16"] * 4 + ["int", "float"]


def _trace(with_program=True):
    """One MoE layer's span holding the operator's two kernels (1 ms and
    0.5 ms) and a third kernel, inside the window."""
    events = [_ev(devtrace.WINDOW, 0, 10_000, cat="user_annotation")]
    if with_program:
        events += [_ev("vault.moe", 100, 3000, cat="user_annotation"),
                   _ev("vault_tpu_torch::moe_experts", 200, 100, dims=DIMS, types=TYPES),
                   _launch(210, 1), _launch(250, 2), _launch(2000, 3),
                   _kernel(300, 1000, 1), _kernel(1300, 500, 2), _kernel(2100, 50, 3)]
    else:
        events += [_launch(210, 1), _kernel(300, 1000, 1)]
    return devtrace.Trace(events)


def _ctx(trace):
    from types import SimpleNamespace

    return SimpleNamespace(traffic={"mode": "score"}, trace=trace, shape_trace=trace,
                           traced_iters=1, shape_iters=1)


def test_the_moe_readers_by_hand():
    ctx = _ctx(_trace())
    least = 6.0 * R * H * I / 989.4e12
    nbytes = R * H * 2 * 2 + 3 * E * I * H * 2 + R * I * 2 * 2 + (E + 1) * 4 + R * 4
    assert nbytes == pytest.approx(1.96e9, rel=2e-3) and least > nbytes / 3.35e12
    assert reader("moe_roofline.score").read(ctx) == pytest.approx(100 * least / 1.5e-3)
    assert reader("moe_launches.score").read(ctx) == 3
    assert reader("moe_host_us.score").read(ctx) == 3000


@pytest.mark.parametrize("name", ["moe_roofline.score", "moe_launches.score",
                                  "moe_host_us.score"])
def test_the_moe_readers_fall_silent_without_the_program(name):
    assert reader(name).read(_ctx(_trace(with_program=False))) is None
