"""Model families found by name (``portbench/families/``).  The
``vault_bert`` family makes what the harness made before families were
folders: its weights, batches and reference readings at the tiny spec are
pinned by SHA-256 digests taken from that harness, and its product counts
at each cell's published shapes by their values.  A family added as files
alone runs a cell from a copied checkout, and a family or a traffic mode
that is not there is refused before any weights are made."""

import hashlib
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from portbench import check, families, flops
from portbench.generate import make_batch, make_weights
from portbench.spec import Spec

from conftest import REPO, copy_benchmark, shrink

CPU = torch.device("cpu")
SEEDS = (7, 2**33 + 12345)

# taken from the harness before its families moved into folders, at one CPU
# thread (the training reference's backward sums in an order that follows
# the thread count); the reference reads batches 0-2 of a scoring cell
PINNED = {
    "bertweet-bf16.score_b256": {
        7: {
            "weights": "78fed399a46a0e55fe24c6ffe278cf65849427178f4a8daa82b3f8158001deb3",
            "batches": "19e6c026aa36097d85e0b2aa1160165cbd293b75b20c6d6d9f8c2f94efba2e89",
            "reference": "1630309a8754e0780a1ca4f77b9477c42d2e0d9ace43653d4e5de50de2125687",
        },
        2**33 + 12345: {
            "weights": "dd09beb1ce4cd9804d3f1fd7a9319b6e67d6608a8eed13166134180b61994768",
            "batches": "913f37a4541da628133546e92178eb1fa7dfbc0cdb128a71751432516f61a4f6",
            "reference": "2ad1ab49e8f190d15d147ef1e356d10863d3198d96fb9cac3e30632b38abdb0e",
        },
    },
    "bert-w8a8.score_b256": {
        7: {
            "weights": "aca73e1581c05b68ffe9860890cf9c71cfac804b7bc7ea642ad3d7ed07f75680",
            "batches": "13380aa13daa513ac5a4edc7aaa88964c8566042606f2294c857e79f8c4791b8",
            "reference": "43da6c04f5432e0b993569538d4d5a38152a835bf3e696219464f5a06adbb227",
        },
        2**33 + 12345: {
            "weights": "5c0039013d8cf7e719a602b4eba9ec2dffe3f641aeafbe30f6c5d5f5a6e74a63",
            "batches": "80c4e766eb7b40b42aedf75869920ee8541e63744ff1717f6f6cf8601af1e846",
            "reference": "b432bba372f31c95c6f8c34a639efa4e744a6f77c06d986e598eb4fdc3b69785",
        },
    },
    "bertweet-bf16.train_b256": {
        7: {
            "weights": "7d7ab62e04190f1d8a4d207ac7397bec72f99eb1e0bd4e6be82f658061f4dad6",
            "batches": "19e6c026aa36097d85e0b2aa1160165cbd293b75b20c6d6d9f8c2f94efba2e89",
            "reference": "80e7793a4eb228c0cc7b4325cb1b500650a7ca7ca66ea53ee3b94201c10e8de0",
        },
        2**33 + 12345: {
            "weights": "81d00937269056173d20d161f873f5ac84cddb51f490ff3d6f8fef01f972cb5f",
            "batches": "913f37a4541da628133546e92178eb1fa7dfbc0cdb128a71751432516f61a4f6",
            "reference": "12113597f6559c6373b2fd5854ea528ce83444caa6c8a8985220d90d03697bef",
        },
    },
}

# (forward_products, train_step_flops) at each cell's published shapes (batch
# 256), taken from the harness before its families moved into folders
SCORE_B256 = ({"dense": 12872016986112.0, "attention": 633574785024.0, "patch": 275414777856.0},
              41343019646976.0)
PRODUCTS = {
    "bertweet-bf16.score_b256": SCORE_B256,
    "bert-w8a8.score_b256": SCORE_B256,
    "bertweet-bf16.train_b256": SCORE_B256,
}


def _bytes(t: torch.Tensor) -> bytes:
    t = t.detach().to("cpu").contiguous()
    head = repr((str(t.dtype), tuple(t.shape))).encode()
    return head + t.reshape(-1).view(torch.uint8).numpy().tobytes()


def _floats(values) -> bytes:
    return torch.tensor(list(values), dtype=torch.float64).numpy().tobytes()


def _sha(chunks) -> str:
    h = hashlib.sha256()
    for c in chunks:
        h.update(c)
    return h.hexdigest()


def digests(spec, cell: str, seed: int) -> dict:
    """SHA-256 of the run's weights (every leaf in order, in the type the
    cell makes them), of its first 3 batches, and of the reference's
    logits of batches 0-2 or its training losses and first gradients'
    norms."""
    c = spec.cell(cell)
    cfg, traffic = spec.config(c["config"]), spec.traffic(c["traffic"])
    train = traffic["mode"] == "train"
    dtype = torch.float32 if train else getattr(torch, cfg["dtype"])
    weights = make_weights(cfg, seed, dtype, CPU)
    out = {"weights": _sha(k.encode() + _bytes(v) for k, v in weights.items())}
    chunks = []
    for i in range(3):
        inputs, labels = make_batch(traffic, cfg, seed, i, CPU)
        chunks += [k.encode() + _bytes(v) for k, v in inputs.items()] + [_bytes(labels)]
    out["batches"] = _sha(chunks)
    prec = check.reference_prec(cfg)
    if train:
        ref = check.train_reference(cfg, traffic, seed, CPU, prec)
        out["reference"] = _sha([_floats(ref["losses"])]
                                + [k.encode() + _floats([v]) for k, v in ref["grad_norms"].items()])
    else:
        ref = check.score_reference(cfg, traffic, seed, [0, 1, 2], CPU, prec)
        out["reference"] = _sha(ref[i].tobytes() for i in (0, 1, 2))
    return out


@pytest.fixture
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("cell", list(PINNED))
def test_weights_batches_and_reference_are_pinned(tiny_spec, one_thread, cell, seed):
    assert digests(tiny_spec, cell, seed) == PINNED[cell][seed]


@pytest.mark.parametrize("cell", list(PRODUCTS))
def test_products_at_published_shapes_are_pinned(cell):
    spec = Spec()
    c = spec.cell(cell)
    cfg, t = spec.config(c["config"]), spec.traffic(c["traffic"])
    assert families.family(cfg) == "vault_bert"
    args = (cfg, t["batch"], t["text_positions"], tuple(t["canvas"]))
    assert (flops.forward_products(*args), flops.train_step_flops(*args)) == PRODUCTS[cell]


# a toy family: vault_bert's files under another name, each leaf drawn from
# a stream of its own, scoring only
TOY_DRAW = '''

def make_weights(cfg, seed, dtype, device):
    """Each leaf from a stream of its own."""
    out = {}
    for index, (name, shape) in enumerate(param_shapes(cfg).items()):
        g = generator(device, seed, "weights", index)
        leaf = torch.randn(shape, generator=g, device=device).mul_(weight_std(cfg, name))
        if name.endswith(".scale"):
            leaf.add_(1.0)
        out[name] = leaf.to(dtype)
    return out
'''

# each cell through ``run.run_cell`` on the CPU, in a process that imports
# the copy's harness; ``made`` lists the weights files that made weights
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
spec = Spec()
for cell in sys.argv[2:]:
    made.clear()
    try:
        out = {"result": run.run_cell(spec, cell, int(sys.argv[1]), 0.3, False,
                                      torch.device("cpu"))}
    except (FileNotFoundError, ValueError) as e:
        out = {"error": f"{type(e).__name__}: {e}"}
    print(json.dumps({"cell": cell, "harness": run.__file__, "made": list(made), **out}))
'''


def _add_config(tmp_path, bench, source: str, name: str, family: str) -> None:
    root = tmp_path / "portbench"
    cfg = json.loads((root / "configs" / f"{source}.json").read_text())
    cfg.update(name=name, family=family)
    (root / "configs" / f"{name}.json").write_text(json.dumps(cfg))
    bench["configs"].append({"name": name, "source": cfg["source"], "reduced": [],
                             "file": f"portbench/configs/{name}.json", "why": "a test"})


def _add_cell(bench, name: str, config: str, traffic: str) -> None:
    """The cell, and its name in the end-to-end metrics that cells of its
    traffic report."""
    traffic_of = {w["name"]: w["traffic"] for w in bench["workloads"]}
    for m in bench["end_to_end"]:
        if any(traffic_of[w] == traffic for w in m.get("workloads", ())):
            m["workloads"].append(name)
    bench["workloads"].append({"name": name, "config": config, "traffic": traffic,
                               "chips": 1, "why": "a test"})


def test_a_family_added_as_files_alone_runs_and_refusals_name_their_cause(tmp_path):
    root = copy_benchmark(tmp_path)
    toy = root / "families" / "toy"
    shutil.copytree(root / "families" / "vault_bert", toy)
    with open(toy / "weights.py", "a") as f:
        f.write(TOY_DRAW)
    system = (toy / "system.py").read_text()
    assert system.count('MODES = ("score", "train")') == 1
    (toy / "system.py").write_text(system.replace('MODES = ("score", "train")',
                                                  'MODES = ("score",)'))
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    _add_config(tmp_path, bench, "vault-bertweet-vilt-b32", "toy-vault", "toy")
    _add_cell(bench, "toy.score_b256", "toy-vault", "score_b256")
    _add_cell(bench, "toy.train_b256", "toy-vault", "train_b256")
    shrink(root)  # the toy configuration too, by the toy's own ``tiny``
    _add_config(tmp_path, bench, "vault-bertweet-vilt-b32", "ghost-vault", "ghost")
    _add_cell(bench, "ghost.score_b256", "ghost-vault", "score_b256")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    cfg = Spec(root).config("toy-vault")
    drawn = families.load(cfg, "weights", root / "families").make_weights(cfg, 7, torch.float32,
                                                                           CPU)
    flat = families.load({}, "weights").make_weights(cfg, 7, torch.float32, CPU)
    assert [(k, v.shape) for k, v in drawn.items()] == [(k, v.shape) for k, v in flat.items()]
    # stream 0 is the flat draw's own, so only the first leaf agrees
    assert [k for k in flat if torch.equal(drawn[k], flat[k])] == [next(iter(flat))]

    before = {p: p.read_bytes() for p in tmp_path.rglob("*") if p.is_file()}
    path = [str(tmp_path), str(REPO), *os.environ.get("PYTHONPATH", "").split(os.pathsep)]
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(p for p in path if p),
           "PYTHONDONTWRITEBYTECODE": "1", "CUDA_VISIBLE_DEVICES": ""}
    done = subprocess.run([sys.executable, "-c", RUNNER, str(SEEDS[1]), "toy.score_b256",
                           "toy.train_b256", "ghost.score_b256"], cwd=tmp_path, env=env,
                          capture_output=True, text=True, timeout=600)
    assert done.returncode == 0, done.stderr[-4000:]
    lines = {r["cell"]: r for r in map(json.loads, done.stdout.strip().splitlines())}
    assert all(Path(r["harness"]).resolve() == (root / "run.py").resolve()
               for r in lines.values())

    scored = lines["toy.score_b256"]
    assert scored["result"]["correct"], scored["result"]["checks"]
    assert set(scored["result"]["metrics"]) == {"setup_s", "score_pairs_per_s", "score_p95_ms"}
    assert set(scored["made"]) == {str((toy / "weights.py").resolve())}
    assert lines["toy.train_b256"]["made"] == []
    assert lines["toy.train_b256"]["error"].startswith("ValueError: family 'toy' runs score")
    ghost = lines["ghost.score_b256"]
    assert ghost["made"] == [] and ghost["error"].startswith("FileNotFoundError")
    assert str((root / "families" / "ghost" / "system.py").resolve()) in ghost["error"]
    assert {p: p.read_bytes() for p in tmp_path.rglob("*") if p.is_file()} == before
    # the harness's code is the repository's, byte for byte: the family is files alone
    code = {p.relative_to(root) for p in root.rglob("*.py")}
    assert [c for c in code if (REPO / "portbench" / c).exists()
            and (root / c).read_bytes() != (REPO / "portbench" / c).read_bytes()] == []


@pytest.mark.parametrize("name", ["../vault_bert", "vault_bert/", "", 3])
def test_a_family_is_a_folder_name(name):
    with pytest.raises(ValueError, match="not a folder name"):
        families.load({"name": "x", "family": name}, "weights")
