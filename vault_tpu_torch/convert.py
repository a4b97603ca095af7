"""Parameter and optimizer-state bridge to and from the JAX package's
layout.

:func:`params_from_jax` turns that package's parameter pytree, given as
nested dicts of numpy arrays (``jax.tree.map(np.asarray, params)`` on the
JAX side; this port never sees JAX) or of tensors, into this port's state
dict.  :func:`params_to_jax` is the reverse.  Both packages store Linear
weights (in, out) and the patch conv OIHW, so every leaf is a copy; the only
reshaping is that the JAX package stacks encoder layers on axis 0 and the
port keeps them as ``layers.<i>`` modules.  The w8a8 codes of the Llama
MLP (``gate``, ``up``, ``down``) come K-major, the same (in, out) values as
a transposed view of (out, in) storage (``ops/quantize.py`` ``k_major``),
the layout the port's SwiGLU kernel reads; going back, every leaf leaves in
the JAX package's row-major layout.  The optimizer's moments are
parameter-shaped trees, so :func:`opt_state_from_jax` and
:func:`opt_state_to_jax` map them the same way, with the step count beside
them as in the JAX package's ``HfAdamWState(count, mu, nu)``.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

from vault_tpu_torch.config import VaultConfig
from vault_tpu_torch.ops.quantize import k_major, k_major_site
from vault_tpu_torch.training.optimizer import AdamWState


def _tensor(a) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a.detach().clone()
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # ml_dtypes' bf16: same bits as torch's
        return torch.from_numpy(np.ascontiguousarray(a).view(np.int16).copy()
                                ).view(torch.bfloat16)
    return torch.from_numpy(np.array(a, copy=True))


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """A tensor as a host numpy array; bf16 becomes ml_dtypes' bfloat16
    (the JAX package's host type), so ``ml_dtypes`` is imported for bf16
    leaves only.  The array is a copy: a host tensor's later in-place
    updates do not reach it."""
    t = t.detach().to("cpu", copy=True)
    if t.dtype == torch.bfloat16:
        import ml_dtypes

        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def params_from_jax(tree: Mapping, cfg: Optional[VaultConfig] = None,
                    llama_cfg=None) -> Dict[str, torch.Tensor]:
    """State dict of :class:`~vault_tpu_torch.models.vault.
    VaultForClassification` or :class:`~vault_tpu_torch.models.vault.
    VaultWithLlamaTower`, of a TomBERT or TomViLT tree (or of any subtree's
    module) from the JAX package's pytree.  Key ``a.layers.<i>.b.c`` holds
    leaf ``tree[a]["layers"][b][c][i]``; a list (the ResNet's stages, lists
    of block dicts) numbers its items, so ``resnet.layer2.3.conv1`` holds
    ``tree["resnet"]["layer2"][3]["conv1"]``; a layer's bare arrays (the
    Llama tower's ``input_ln`` and ``post_ln``) unstack the same way, and
    quantized leaves keep their int8 and fp32 types.  With ``cfg`` (and
    ``llama_cfg``, a ``LlamaConfig``, for the ``llama`` subtree) the stacked
    layer axes are checked against the configs' depths."""
    n_layers = {"bert": (cfg.text_tower.num_hidden_layers
                         if cfg is not None and cfg.text_tower is not None
                         else None),
                "vilt": cfg.vilt.num_hidden_layers if cfg is not None else None,
                "llama": (llama_cfg.num_hidden_layers if llama_cfg is not None
                          else None)}
    out: Dict[str, torch.Tensor] = {}

    def walk(node, prefix, tower):
        if isinstance(node, Mapping):
            for k, v in node.items():
                if k == "layers":
                    walk_layers(v, f"{prefix}layers", tower)
                else:
                    walk(v, f"{prefix}{k}.", tower if prefix else k)
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(v, f"{prefix}{i}.", tower)
        else:
            out[prefix[:-1]] = _tensor(node)

    def walk_layers(node, prefix, tower):
        leaves = {}

        def collect(n, path):
            if isinstance(n, Mapping):
                for k, v in n.items():
                    collect(v, f"{path}.{k}" if path else k)
            else:
                leaves[path] = n if isinstance(n, torch.Tensor) else np.asarray(n)

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
    for key, t in out.items():
        parts = key.split(".")
        if len(parts) > 1 and parts[-1] == "w_q8" and k_major_site(parts[-2], "w8a8"):
            out[key] = k_major(t)
    return out


def _insert(tree: dict, parts, leaf):
    for p in parts[:-1]:
        tree = tree.setdefault(p, {})
    tree[parts[-1]] = leaf


def params_to_jax(state_dict: Mapping[str, torch.Tensor],
                  as_numpy: bool = True) -> Dict[str, Any]:
    """The JAX package's nested parameter tree from a state dict: keys split
    on ".", ``layers.<i>`` leaves stacked on axis 0 (on the host), any other
    numbered children (the ResNet's blocks) gathered into lists.  Leaves
    are numpy arrays (:func:`to_numpy`), or CPU tensors when not
    ``as_numpy``; either way they are copies, never the state dict's own
    tensors."""
    tree: Dict[str, Any] = {}
    stacks: Dict[tuple, Dict[int, torch.Tensor]] = {}
    for key, t in state_dict.items():
        parts = key.split(".")
        if "layers" in parts[:-1] and parts[parts.index("layers") + 1].isdigit():
            j = parts.index("layers")
            where = (tuple(parts[:j + 1]), tuple(parts[j + 2:]))
            stacks.setdefault(where, {})[int(parts[j + 1])] = t
        else:
            # a copy even on the host: the trainer's checkpoint is written on
            # another thread while the next step updates the masters in place
            _insert(tree, parts, t.detach().to("cpu", copy=True))
    for (prefix, rest), layers in stacks.items():
        if sorted(layers) != list(range(len(layers))):
            raise ValueError(f"{'.'.join(prefix)}: layers {sorted(layers)} are "
                             "not numbered 0..n-1")
        _insert(tree, list(prefix + rest),
                torch.stack([layers[i].detach() for i in range(len(layers))]).cpu())
    tree = _listify(tree)
    if as_numpy:
        tree = _map(to_numpy, tree)
    return tree


def _map(fn, tree):
    if isinstance(tree, Mapping):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map(fn, v) for v in tree]
    return fn(tree)


def _listify(node):
    """Nested dicts with their numbered children (keys "0".."n-1") made
    lists."""
    if not isinstance(node, dict):
        return node
    node = {k: _listify(v) for k, v in node.items()}
    if node and all(k.isdigit() for k in node):
        if sorted(map(int, node)) != list(range(len(node))):
            raise ValueError(f"children {sorted(node)} are not numbered 0..n-1")
        return [node[str(i)] for i in range(len(node))]
    return node


def opt_state_from_jax(state, cfg: Optional[VaultConfig] = None) -> AdamWState:
    """The port's optimizer state from the JAX package's ``HfAdamWState``
    (or any ``(count, mu, nu)`` triple of host trees)."""
    count, mu, nu = state
    return AdamWState(int(np.asarray(count)), params_from_jax(mu, cfg),
                      params_from_jax(nu, cfg))


def opt_state_to_jax(state: AdamWState, as_numpy: bool = True) -> tuple:
    """``(count, mu, nu)`` in the JAX package's layout: count an int32
    scalar, the moments nested and stacked as :func:`params_to_jax`."""
    count = np.asarray(state.count, np.int32)
    return (count if as_numpy else torch.tensor(state.count, dtype=torch.int32),
            params_to_jax(state.mu, as_numpy), params_to_jax(state.nu, as_numpy))


def param_tree(state_dict: Mapping[str, torch.Tensor]) -> Dict[str, Any]:
    """The nested form the model functions read, from a state dict: keys
    split on "." into dicts, numbered children (``layers.<i>``) into lists.
    The leaves are the state dict's own tensors, so autograd reaches them
    (the trainer's bf16 compute copy is passed this way)."""
    root: Dict[str, Any] = {}
    for key, t in state_dict.items():
        _insert(root, key.split("."), t)
    return _listify(root)
