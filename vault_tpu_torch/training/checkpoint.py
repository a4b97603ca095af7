"""Checkpoints in the JAX package's npz layout (port of ``save_checkpoint``
and ``restore_checkpoint`` of ``vault_tpu/training/checkpoint.py``), so a
checkpoint written by either package restores in the other.

Layout: one flat npz; keys are the tree paths joined with "/" (dicts by key,
tuples and lists by index, so the optimizer's ``(count, mu, nu)`` is
``opt_state/0|1|2``); encoder layers are stacked on axis 0
(``convert.params_to_jax``); a bf16 leaf is stored as its uint16 bits under
``<key>::bfloat16``, since npz has no bf16.  Leaves are tensors (any
device) or numpy arrays; restored leaves are CPU tensors where the target
holds tensors, numpy arrays elsewhere.  Int8 moments are ``Q8Moment(q,
scale)`` namedtuples, so their codes are ``<leaf>/0`` (int8) and their
scales ``<leaf>/1`` (fp32), as in the JAX package's files.

Several processes (the counterpart of the JAX package's
``save_/restore_checkpoint_multihost``, which write orbax directories):
:func:`save_checkpoint_multihost` and :func:`restore_checkpoint_multihost`
go through ``torch.distributed.checkpoint``.  Every rank enters the call
with a flat dict of its tensors, named so that tensors that differ between
ranks (ZeRO moment slices, tensor-parallel shards) have names of their own;
each rank writes its own, and a tensor that several ranks hold under one
name is written once.  Restore copies into the live tensors, in place.
These directories do not cross to the JAX package (nor to orbax).
"""

from __future__ import annotations

import logging
import os
from typing import Any, Dict

import numpy as np
import torch

def _flatten(tree, prefix="") -> Dict[str, Any]:
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}/"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}{i}/"))
    else:
        out[prefix.rstrip("/")] = tree
    return out


def save_checkpoint(path: str, tree: Any):
    """Write ``tree`` to ``path`` (".npz" appended when missing),
    atomically: a crash mid-write leaves the last good file in place."""
    out = {}
    for k, v in _flatten(tree).items():
        if isinstance(v, torch.Tensor):
            v = v.detach().cpu()
            if v.dtype == torch.bfloat16:
                out[f"{k}::bfloat16"] = v.view(torch.int16).numpy().view(np.uint16)
                continue
            v = v.numpy()
        out[k] = np.asarray(v)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    final = path if path.endswith(".npz") else path + ".npz"
    tmp = final + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **out)
    os.replace(tmp, final)


def _kind(dtype) -> str:
    return "f" if dtype.is_floating_point else "i"


def restore_checkpoint(path: str, target: Any) -> Any:
    """Restore into the structure of ``target`` (shapes checked).  A float
    leaf saved in another float type is cast to the target's type, with one
    warning naming the casts; a float/integer mismatch raises."""
    if not path.endswith(".npz") and os.path.exists(path + ".npz"):
        path = path + ".npz"
    data = np.load(path)
    tagged = {k.rsplit("::", 1)[0]: k for k in data.files if "::" in k}
    migrations: list = []

    def load(key):
        if key not in data.files and key in tagged:
            name = tagged[key].rsplit("::", 1)[1]
            if name != "bfloat16":
                raise ValueError(f"{key}: unsupported stored type {name}")
            return torch.from_numpy(data[tagged[key]].view(np.int16).copy()
                                    ).view(torch.bfloat16)
        if key not in data.files:
            # int8 moments are (q, scale) pairs under <leaf>/0 and /1: one
            # kind of moments restored into the other is refused by kind
            parent = key.rsplit("/", 1)[0]
            if f"{key}/0" in data.files or (key.endswith(("/0", "/1"))
                                            and parent in data.files):
                raise ValueError(
                    f"dtype mismatch at {parent if parent in data.files else key}: "
                    "int8 moments (q, scale) against float moments; a checkpoint "
                    "restores only into the moment kind it was written with")
            raise KeyError(f"{key} is not in {os.path.basename(path)}")
        arr = data[key]
        if arr.dtype.kind == "V":
            raise ValueError(f"{key}: untagged raw bytes (a file written "
                             "before dtype tagging) cannot be read")
        return torch.from_numpy(arr.copy())

    def rebuild(tree, prefix=""):
        if isinstance(tree, dict):
            return {k: rebuild(v, f"{prefix}{k}/") for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            vals = [rebuild(v, f"{prefix}{i}/") for i, v in enumerate(tree)]
            if hasattr(tree, "_fields"):  # namedtuple
                return type(tree)(*vals)
            return type(tree)(vals)
        key = prefix.rstrip("/")
        t = load(key)
        want = tree if isinstance(tree, torch.Tensor) else torch.as_tensor(
            np.asarray(tree))
        if tuple(t.shape) != tuple(want.shape):
            raise ValueError(f"shape mismatch at {key}: ckpt {tuple(t.shape)} "
                             f"vs target {tuple(want.shape)}")
        if t.dtype != want.dtype:
            if _kind(t.dtype) != _kind(want.dtype):
                raise ValueError(f"dtype mismatch at {key}: ckpt {t.dtype} vs "
                                 f"target {want.dtype}")
            migrations.append((key, str(t.dtype), str(want.dtype)))
            t = t.to(want.dtype)
        return t if isinstance(tree, torch.Tensor) else t.numpy()

    out = rebuild(target)
    if migrations:
        pairs = sorted({(a, b) for _, a, b in migrations})
        logging.getLogger(__name__).warning(
            "restore_checkpoint(%s): cast %d leaves across types %s (e.g. %s); "
            "restored numerics differ from the saved state",
            os.path.basename(path), len(migrations),
            ", ".join(f"{a}->{b}" for a, b in pairs), migrations[0][0])
    return out


def save_checkpoint_multihost(path: str, state: Dict[str, torch.Tensor]):
    """Every rank of the initialized world writes ``state`` (a flat dict of
    tensors) into the directory ``path``, through
    ``torch.distributed.checkpoint``.  The files go to ``path + ".tmp"``
    first, and rank 0 moves them into place once every rank has written,
    so an interrupted save leaves the last good directory."""
    import shutil

    import torch.distributed as dist
    import torch.distributed.checkpoint as dcp

    tmp = path + ".tmp"
    if dist.get_rank() == 0 and os.path.isdir(tmp):
        shutil.rmtree(tmp)
    dist.barrier()
    dcp.save({k: v.detach() for k, v in state.items()}, checkpoint_id=tmp)
    dist.barrier()
    if dist.get_rank() == 0:
        if os.path.isdir(path):
            shutil.rmtree(path)
        os.replace(tmp, path)
    dist.barrier()


@torch.no_grad()
def restore_checkpoint_multihost(path: str, state: Dict[str, torch.Tensor]):
    """Load the directory ``path`` into ``state``'s tensors in place
    (every rank enters the call with the names it wrote)."""
    import torch.distributed.checkpoint as dcp

    dcp.load({k: v.detach() for k, v in state.items()}, checkpoint_id=path)
