"""Shared set-up of the benchmark's own tests: the repository on the path,
and a copy of the benchmark at a tiny size for runs on the CPU.

Run from the repository's root: ``python -m pytest portbench/tests``.
"""

import json
import shutil
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

TINY_TRAFFIC = dict(batch=4, text_len=[3, 8], text_positions=8, canvas=[64, 64])


def copy_benchmark(dest: Path) -> Path:
    """A copy of ``BENCHMARK.json`` and ``portbench/`` (without its tests)
    under ``dest``; returns the copy's ``portbench`` folder."""
    root = dest / "portbench"
    shutil.copytree(REPO / "portbench", root,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(REPO / "BENCHMARK.json", dest / "BENCHMARK.json")
    return root


def shrink(root: Path) -> None:
    """Every configuration and traffic mix of a copy cut to a tiny size:
    each configuration as its family's ``tiny`` cuts it, 4 pairs of up to 8
    tokens and 64 x 64 images; the limits stay the cells' own."""
    from portbench import families

    for path in (root / "configs").glob("*.json"):
        cfg = json.loads(path.read_text())
        path.write_text(json.dumps(families.load(cfg, "weights", root / "families").tiny(cfg)))
    for path in (root / "traffic").glob("*.json"):
        traffic = json.loads(path.read_text())
        traffic.update(TINY_TRAFFIC)
        path.write_text(json.dumps(traffic))


@pytest.fixture
def tiny_spec(tmp_path):
    from portbench.spec import Spec

    root = copy_benchmark(tmp_path)
    shrink(root)
    return Spec(root)
