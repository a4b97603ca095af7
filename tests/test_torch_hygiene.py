"""The port stands alone: it imports neither JAX nor the JAX package, and its
entry points never drop to the CPU on their own.

The JAX package is ``vault_tpu`` and the port ``vault_tpu_torch``: the port's
name begins with the JAX package's, so every check here matches the module
``vault_tpu`` exactly, never the prefix.
"""

import pkgutil
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import vault_tpu_torch

ROOT = Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "vault_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
FORBIDDEN = re.compile(
    r"^\s*(import\s+(jax|vault_tpu)(\s|\.|,|$)"
    r"|from\s+(jax|vault_tpu)(\.|\s+import\b))", re.M)


def _port_modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        vault_tpu_torch.__path__, prefix="vault_tpu_torch."))


def test_import_pattern_matches_the_module_not_the_prefix():
    for bad in ("import jax", "import jax.numpy as jnp", "from jax import lax",
                "import vault_tpu", "from vault_tpu.ops import nn",
                "from vault_tpu import serving", "    import vault_tpu.config"):
        assert FORBIDDEN.search(bad), bad
    for ok in ("import vault_tpu_torch", "from vault_tpu_torch.ops import nn",
               "from vault_tpu_torch import serving", "import jaxlib_free",
               "# the JAX package vault_tpu stays the reference"):
        assert not FORBIDDEN.search(ok), ok


def test_no_source_imports_jax_or_the_jax_package():
    offenders = [f"{p.relative_to(ROOT)}: {m.group(0).strip()}"
                 for p in PORT_FILES for m in FORBIDDEN.finditer(p.read_text())]
    assert not offenders, offenders


def test_every_module_imports_with_jax_and_vault_tpu_blocked():
    modules = _port_modules() + ["chip_smoke"]
    assert len(modules) >= 19
    assert {f"vault_tpu_torch.training.{m}" for m in (
        "checkpoint", "experiment", "losses", "metrics", "optimizer", "trainer")
            } | {"vault_tpu_torch.data.loader", "vault_tpu_torch.models.llama",
                 "vault_tpu_torch.ops.cuda_swiglu"} <= set(modules)
    # the parallel layer, every module of it
    parallel = {f"vault_tpu_torch.parallel.{m}" for m in (
        "dryrun", "mesh", "multihost", "pipeline", "shard_map_step", "sharding",
        "tensor_parallel", "zero")}
    assert parallel == {m for m in modules if m.startswith("vault_tpu_torch.parallel.")}
    code = ("import importlib, sys\n"
            "sys.modules['jax'] = None\n"
            "sys.modules['vault_tpu'] = None\n"
            f"for name in {modules!r}:\n"
            "    importlib.import_module(name)\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
            "             or m == 'vault_tpu' or m.startswith('vault_tpu.'))\n"
            "assert all(sys.modules[m] is None for m in bad), bad\n"
            "from vault_tpu_torch.ops import _build\n"
            "assert _build._libs == {}, 'importing built a kernel'\n"
            "print('imported', len(" f"{modules!r}" "))\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert f"imported {len(modules)}" in res.stdout


def test_default_device_without_gpu_raises(monkeypatch):
    from vault_tpu_torch.config import VaultConfig, tiny_text_config, tiny_vilt_config
    from vault_tpu_torch.models.vault import VaultForClassification, resolve_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = VaultConfig(vilt=tiny_vilt_config(), text_tower=tiny_text_config())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        VaultForClassification(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device(None)
    assert VaultForClassification(cfg, device="cpu").device.type == "cpu"


def test_build_covers_every_kernel_source():
    from vault_tpu_torch.ops import _build

    assert _build.SOURCES == tuple(sorted(
        p.stem for p in (ROOT / "vault_tpu_torch" / "csrc").glob("*.cu")))
