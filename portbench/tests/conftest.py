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

# weights drawn at 0.02 * sqrt(768 / 32), the published range scaled to the
# narrow width, so that each layer's outputs keep their full-width size and
# the logits move from pair to pair as the full model's do (by about 0.1)
TINY_STD = 0.1
TINY_TOWER = dict(vocab_size=99, hidden_size=32, num_hidden_layers=2, num_attention_heads=4,
                  intermediate_size=64, max_position_embeddings=64, initializer_range=TINY_STD)
TINY_VILT = dict(vocab_size=99, hidden_size=32, num_hidden_layers=2, num_attention_heads=4,
                 intermediate_size=64, image_size=64, patch_size=16,
                 initializer_range=TINY_STD)
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
    the same layers and mechanisms, widths of 32, 2 + 2 layers, 4 pairs of
    up to 8 tokens and 64 x 64 images; the limits stay the cells' own."""
    for path in (root / "configs").glob("*.json"):
        cfg = json.loads(path.read_text())
        cfg["text_tower"].update(TINY_TOWER)
        cfg["vilt"].update(TINY_VILT)
        cfg["assumed"]["num_patch_tokens"] = 12
        path.write_text(json.dumps(cfg))
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
