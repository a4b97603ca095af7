"""Model families, found by name.  A configuration names the family that
builds, draws, checks and counts it: ``"family"`` in its file, and
:data:`DEFAULT` where the key is absent.  A family ``<f>`` is the folder
``portbench/families/<f>/``, whose files are loaded by their paths, as a
metric's reader is:

- ``weights.py``: ``param_shapes(cfg)``; ``make_weights(cfg, seed, dtype,
  device)``, every parameter made on the device from the seed; ``tiny(cfg)``,
  the configuration cut to the size of the benchmark's CPU tests.
- ``system.py``, the only modules of the benchmark that import the program:
  ``build_scorer(cfg, weights)``; ``build_trainer(cfg, traffic, weights,
  seed)`` where the family trains; ``MODES``, the traffic modes it runs.
- ``reference.py``, plain PyTorch that imports nothing of the program:
  ``score_reference(cfg, traffic, seed, indices, device, prec)``, {index:
  logits}; ``train_reference(cfg, traffic, seed, device, prec, ste, rows)``
  where the family trains.  The family makes its reference's weights
  itself, so it may make them layer by layer.
- ``flops.py``: ``forward_products(cfg, batch, seq, canvas)``, FLOPs by
  kind (``"dense"`` is counted at the int8 peak under w8a8), and
  ``train_step_flops(cfg, batch, seq, canvas)``.

A family is added by adding its folder; the harness names none but the
default.
"""

from __future__ import annotations

import importlib.util
import re
from pathlib import Path
from types import ModuleType

HERE = Path(__file__).resolve().parent
DEFAULT = "vault_bert"
FOLDER = re.compile(r"^[A-Za-z0-9_]+$")


def family(cfg: dict) -> str:
    """The name of ``cfg``'s family."""
    name = cfg.get("family", DEFAULT)
    if not isinstance(name, str) or not FOLDER.match(name):
        raise ValueError(f"configuration {cfg.get('name')!r}: family {name!r} is not a folder name")
    return name


def load(cfg: dict, part: str, root: Path = HERE) -> ModuleType:
    """The file ``<part>.py`` of ``cfg``'s family under ``root``, loaded."""
    name = family(cfg)
    path = Path(root) / name / f"{part}.py"
    if not path.is_file():
        raise FileNotFoundError(f"configuration {cfg.get('name')!r} names family {name!r}, "
                                f"but there is no {path}")
    module_spec = importlib.util.spec_from_file_location(f"portbench.families.{name}.{part}",
                                                         path)
    module = importlib.util.module_from_spec(module_spec)
    module_spec.loader.exec_module(module)
    return module


def system(cfg: dict, mode: str) -> ModuleType:
    """The family's ``system.py``, refusing traffic of a mode it does not run."""
    module = load(cfg, "system")
    if mode not in module.MODES:
        raise ValueError(f"family {family(cfg)!r} runs {', '.join(module.MODES)} traffic, "
                         f"not {mode!r}")
    return module
