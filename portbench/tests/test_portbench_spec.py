"""``BENCHMARK.json`` against the benchmark's contract, and the loader
finding a configuration, a traffic mix and a metric by name: a new one is
added by adding files and entries, with no edit to a file that exists."""

import json
import re

import pytest

from portbench.spec import Spec

from conftest import REPO, copy_benchmark

HERE = REPO / "portbench"
BENCH = json.loads((REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
WIDTH = re.compile(r"(hidden|intermediate|latent|state|projection)|_dim$|_rank$|head")


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)
    assert len(json.dumps(BENCH)) <= 64 * 1024


def test_names_units_and_lines():
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    for entries in (BENCH["configs"], BENCH["workloads"], metrics):
        names = [e["name"] for e in entries]
        assert len(set(names)) == len(names)
        assert all(NAME.match(n) for n in names)
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for e in BENCH["configs"] + BENCH["workloads"]:
        assert 1 <= len(e["why"]) <= 200 and "\n" not in e["why"] and "\t" not in e["why"]


def test_configs_are_files_of_their_own_with_nothing_reduced():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"] == f"portbench/configs/{c['name']}.json"
        cfg = json.loads((REPO / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        assert c["reduced"] == cfg["reduced"] == []
        assert not [k for k in c["reduced"] if WIDTH.search(k)]
        assert any(w["config"] == c["name"] for w in BENCH["workloads"])


def test_cells_report_what_the_contract_asks():
    spec = Spec()
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert e2e["setup_s"]["bound"] == 0.25
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] == 1
        assert (HERE / "traffic" / f"{w['traffic']}.json").exists()
        reported = {m["name"] for m in spec.end_to_end(w["name"])}
        assert "setup_s" in reported and len(reported) >= 2
        layers = spec.per_layer(w["name"])
        assert layers and all(m["moves"] in reported for m in layers)
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        if m["name"].endswith("_roofline") or "_roofline." in m["name"]:
            assert m["unit"] == "%"
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(set(pairs)) == len(pairs)


def test_every_metric_has_a_reader():
    spec = Spec()
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert callable(spec.reader(m["name"]).read)


def test_the_seconds_fit_the_check_with_every_cell():
    cells = 24
    runs = 2 + 14 * cells
    assert runs * (BENCH["run_seconds"] + 60) + cells * 2 * 90 + 1200 <= 43200


def test_files_are_named_from_names():
    for path in HERE.rglob("*"):
        if "__pycache__" in path.parts or path.is_dir():
            continue
        rel = path.relative_to(REPO).as_posix()
        assert re.match(r"^[A-Za-z0-9_./-]+$", rel), rel


def test_a_new_config_traffic_and_metric_are_found_by_name(tmp_path):
    root = copy_benchmark(tmp_path)
    before = {p: p.read_bytes() for p in root.rglob("*") if p.is_file()}
    cfg = json.loads((root / "configs" / "vault-bertweet-vilt-b32.json").read_text())
    cfg["name"] = "vault-bertweet-vilt-b32-merged"
    (root / "configs" / "vault-bertweet-vilt-b32-merged.json").write_text(json.dumps(cfg))
    traffic = json.loads((root / "traffic" / "score_b256.json").read_text())
    traffic["batch"] = 8
    (root / "traffic" / "score_b8.json").write_text(json.dumps(traffic))
    (root / "metrics" / "batches.score.py").write_text(
        "def read(ctx):\n    return float(ctx.window['iters'])\n")
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": cfg["name"], "source": cfg["source"], "reduced": [],
                             "file": f"portbench/configs/{cfg['name']}.json", "why": "a test"})
    bench["workloads"].append({"name": "merged.score_b8", "config": cfg["name"],
                               "traffic": "score_b8", "chips": 1, "why": "a test"})
    bench["per_layer"].append({"name": "batches.score", "unit": "batches", "better": "higher",
                               "source": "host_clock", "layer": "model glue",
                               "moves": "score_pairs_per_s", "workloads": ["merged.score_b8"]})
    for m in bench["end_to_end"]:
        if "workloads" in m and m["name"].startswith("score_"):
            m["workloads"].append("merged.score_b8")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    spec = Spec(root)
    cell = spec.cell("merged.score_b8")
    assert spec.config(cell["config"])["name"] == "vault-bertweet-vilt-b32-merged"
    assert spec.traffic(cell["traffic"])["batch"] == 8
    assert [m["name"] for m in spec.per_layer("merged.score_b8")] == ["batches.score"]
    assert spec.reader("batches.score").read(type("Ctx", (), {"window": {"iters": 3}})) == 3.0
    assert {m["name"] for m in spec.end_to_end("merged.score_b8")} == {
        "setup_s", "score_pairs_per_s", "score_p95_ms"}
    assert all(p.read_bytes() == b for p, b in before.items())
    with pytest.raises(KeyError):
        spec.cell("no-such-cell")

