"""Parameter bridge from the JAX package.

:func:`params_from_jax` turns that package's parameter pytree, given as
nested dicts of numpy arrays (``jax.tree.map(np.asarray, params)`` on the
JAX side; this port never sees JAX), into this port's state dict.  Both
packages store Linear weights (in, out) and the patch conv OIHW, so every
leaf is a copy; the only reshaping is that the JAX package stacks encoder
layers on axis 0 and the port keeps them as ``layers.<i>`` modules.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from vault_tpu_torch.config import VaultConfig


def _tensor(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # ml_dtypes' bf16: same bits as torch's
        return torch.from_numpy(np.ascontiguousarray(a).view(np.int16).copy()
                                ).view(torch.bfloat16)
    return torch.from_numpy(np.array(a, copy=True))


def params_from_jax(tree: Mapping, cfg: VaultConfig) -> Dict[str, torch.Tensor]:
    """State dict of :class:`~vault_tpu_torch.models.vault.
    VaultForClassification` (or of any subtree's module) from the JAX
    package's pytree.  Key ``a.layers.<i>.b.c`` holds leaf
    ``tree[a]["layers"][b][c][i]``."""
    n_layers = {"bert": (cfg.text_tower.num_hidden_layers
                         if cfg.text_tower is not None else None),
                "vilt": cfg.vilt.num_hidden_layers}
    out: Dict[str, torch.Tensor] = {}

    def walk(node, prefix, tower):
        if isinstance(node, Mapping):
            for k, v in node.items():
                if k == "layers":
                    walk_layers(v, f"{prefix}layers", tower)
                else:
                    walk(v, f"{prefix}{k}.", tower if prefix else k)
        else:
            out[prefix[:-1]] = _tensor(node)

    def walk_layers(node, prefix, tower):
        leaves = {}

        def collect(n, path):
            if isinstance(n, Mapping):
                for k, v in n.items():
                    collect(v, f"{path}.{k}" if path else k)
            else:
                leaves[path] = np.asarray(n)

        collect(node, "")
        depth = {a.shape[0] for a in leaves.values()}
        if len(depth) != 1 or (n_layers.get(tower) is not None
                                and depth != {n_layers[tower]}):
            raise ValueError(f"{prefix}: stacked layer axis {sorted(depth)} "
                             f"does not match the config ({n_layers.get(tower)})")
        for path, a in leaves.items():
            for i in range(a.shape[0]):
                out[f"{prefix}.{i}.{path}"] = _tensor(a[i])

    walk(tree, "", None)
    return out
