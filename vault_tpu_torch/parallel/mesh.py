"""Process groups and the ("data", "model") mesh (port of
``vault_tpu/parallel/mesh.py``).

The JAX package runs one controller over a ``jax.sharding.Mesh`` and lets
XLA insert the collectives; a mesh that spans hosts joins them with
``jax.distributed``.  The port keeps PyTorch's idiom: one process per rank
over ``torch.distributed``, which is what that mesh becomes once it spans
processes.  The caller names the backend: ``nccl`` by default when a card
is visible, ``gloo`` otherwise; ranks that share one card ask for ``gloo``
(NCCL refuses two ranks on one device).  Nothing switches backend or falls
back to fewer ranks on its own: a mesh without an initialized group, or
larger than the group, raises.

Axes, as in the JAX package: "data" splits the batch (data parallelism,
ZeRO-1), "model" splits the Megatron shards (tensor parallelism).  Rank
``r`` sits at (``r // num_model``, ``r % num_model``), the row-major layout
of ``np.reshape(devices, (num_data, num_model))``.

The collectives here stage CUDA tensors through the host when the group
runs ``gloo``, whose CUDA support stops at broadcast and all-reduce.
"""

from __future__ import annotations

import datetime
from dataclasses import dataclass
from typing import Any, List, Optional

import numpy as np
import torch
import torch.distributed as dist

DEFAULT_TIMEOUT_S = 900.0


def default_backend(device=None) -> str:
    """``nccl`` when a card is visible and ``device`` (when given) is a
    card, else ``gloo``."""
    if device is not None and torch.device(device).type != "cuda":
        return "gloo"
    return "nccl" if torch.cuda.is_available() else "gloo"


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     backend: Optional[str] = None,
                     timeout_s: float = DEFAULT_TIMEOUT_S):
    """Join ``num_processes`` processes at ``coordinator_address``
    (``host:port`` of rank 0) as rank ``process_id``, over ``backend``
    (:func:`default_backend` when None).  A second call on an initialized
    group passes when it asks for the same world (the benign
    re-initialization); a group of another size raises, so a failed join is
    never taken for a one-process run."""
    if dist.is_initialized():
        if num_processes is not None and dist.get_world_size() != num_processes:
            raise RuntimeError(
                f"torch.distributed is already initialized with "
                f"{dist.get_world_size()} process(es), expected {num_processes}")
        return
    if coordinator_address is None or num_processes is None or process_id is None:
        raise ValueError("init_distributed needs coordinator_address, "
                         "num_processes and process_id")
    address = coordinator_address
    if not address.startswith(("tcp://", "file://", "env://")):
        address = "tcp://" + address
    dist.init_process_group(
        backend=backend or default_backend(), init_method=address,
        world_size=int(num_processes), rank=int(process_id),
        timeout=datetime.timedelta(seconds=timeout_s))
    if dist.get_world_size() != num_processes:
        raise RuntimeError(
            f"torch.distributed joined {dist.get_world_size()} process(es), "
            f"expected {num_processes}: check --coordinator_address and that "
            "every process launched with a distinct --process_id")


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def coord_barrier(name: str, timeout_ms: int = 900_000, group=None):
    """Align every process of ``group`` (the world when None), failing
    after ``timeout_ms`` instead of hanging when gloo runs it (NCCL's
    barrier is bounded by the group's own timeout).  Nothing happens in a
    one-process run.  ``name`` labels the barrier in the error."""
    if not dist.is_initialized() or dist.get_world_size(group) == 1:
        return
    try:
        if dist.get_backend(group) == "gloo":
            dist.monitored_barrier(
                group=group, timeout=datetime.timedelta(milliseconds=timeout_ms))
        else:
            dist.barrier(group=group)
    except RuntimeError as e:
        raise RuntimeError(f"barrier {name!r} failed: {e}") from e


@dataclass
class Mesh:
    """This rank's place in a ``num_data x num_model`` layout and the two
    process groups it belongs to (one per axis)."""

    num_data: int
    num_model: int
    data_index: int
    model_index: int
    data_group: Any
    model_group: Any


def make_mesh(num_data: Optional[int] = None, num_model: int = 1) -> Mesh:
    """The ("data", "model") mesh over the initialized world; ``num_data``
    defaults to ``world // num_model``.  Every rank must call it (the groups
    are created collectively).  Raises without an initialized group, and
    when the mesh does not cover the world exactly."""
    if not dist.is_initialized():
        raise RuntimeError(
            "make_mesh needs an initialized torch.distributed group "
            "(parallel.mesh.init_distributed, or the CLIs' "
            "--coordinator_address/--num_processes/--process_id)")
    world = dist.get_world_size()
    num_model = int(num_model)
    if num_data is None:
        num_data = max(1, world // num_model)
    num_data = int(num_data)
    if num_data * num_model != world:
        raise ValueError(
            f"a {num_data} x {num_model} mesh needs {num_data * num_model} "
            f"ranks; the group has {world}")
    rank = dist.get_rank()
    d, m = divmod(rank, num_model)
    data_group = model_group = None
    # every rank creates every group, in one order
    for mi in range(num_model):
        g = dist.new_group([di * num_model + mi for di in range(num_data)])
        if mi == m:
            data_group = g
    for di in range(num_data):
        g = dist.new_group([di * num_model + mi for mi in range(num_model)])
        if di == d:
            model_group = g
    return Mesh(num_data, num_model, d, m, data_group, model_group)


# ---------------------------------------------------------------------------
# Collectives
# ---------------------------------------------------------------------------

def _staged(t: torch.Tensor, group) -> bool:
    return t.is_cuda and dist.get_backend(group) == "gloo"


def _to_host(t: torch.Tensor) -> torch.Tensor:
    """A copy of ``t`` in pinned host memory (PyTorch caches the pinned
    blocks, so a step's staging reuses them)."""
    h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    h.copy_(t)
    return h


def all_reduce_(t: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """In-place all-reduce of ``t`` over ``group``; returns ``t``."""
    if _staged(t, group):
        h = _to_host(t)
        dist.all_reduce(h, op=op, group=group)
        t.copy_(h)
    else:
        dist.all_reduce(t, op=op, group=group)
    return t


def all_gather(t: torch.Tensor, group) -> List[torch.Tensor]:
    """Every rank's ``t`` (equal shapes), in rank order, on ``t``'s
    device."""
    n = dist.get_world_size(group)
    src = t.contiguous()
    if _staged(src, group):
        src_h = _to_host(src)
        parts = [torch.empty_like(src_h, pin_memory=True) for _ in range(n)]
        dist.all_gather(parts, src_h, group=group)
        return [p.to(t.device) for p in parts]
    parts = [torch.empty_like(src) for _ in range(n)]
    dist.all_gather(parts, src, group=group)
    return parts


def all_reduce_bucket(tensors: List[torch.Tensor], group) -> List[torch.Tensor]:
    """Sum each tensor over ``group`` through one fp32 bucket (one
    collective): returns new fp32 tensors of the same shapes."""
    flat = torch.cat([t.float().reshape(-1) for t in tensors])
    all_reduce_(flat, group)
    out, off = [], 0
    for t in tensors:
        out.append(flat[off:off + t.numel()].view(t.shape))
        off += t.numel()
    return out


# ---------------------------------------------------------------------------
# Host batches
# ---------------------------------------------------------------------------

def shard_batch(mesh: Mesh, batch, micro: int = 1):
    """This rank's rows of a host batch (a dict of arrays, or one array)
    that every process holds whole: the seeded shuffle makes the batches
    identical on every process, so only the local rows are taken and no data
    moves between ranks.  The rows are cut per micro-batch: with ``micro``
    k, the leading axis is read as (k, num_data, m) and rank d keeps
    ``[:, d]``, so micro-batch i of every rank comes from global micro-batch
    i, as a sharded global array reshaped to (k, n / k) is in JAX."""
    def cut(x):
        x = np.asarray(x)
        n = x.shape[0]
        if n % (micro * mesh.num_data):
            raise ValueError(f"{n} rows do not split into {micro} micro-batches "
                             f"over {mesh.num_data} data ranks")
        m = n // (micro * mesh.num_data)
        return x.reshape(micro, mesh.num_data, m, *x.shape[1:])[
            :, mesh.data_index].reshape(micro * m, *x.shape[1:])

    if isinstance(batch, dict):
        return {k: cut(v) for k, v in batch.items()}
    return cut(batch)


def replicate(mesh: Mesh, tree, device=None):
    """Every rank's copy of a host tree that all processes hold whole (the
    same seed builds the same weights everywhere): tensors on ``device``.
    ``mesh`` names the layout the copies serve, as in the JAX package."""
    del mesh

    def put(x):
        if isinstance(x, dict):
            return {k: put(v) for k, v in x.items()}
        return torch.as_tensor(np.asarray(x) if not isinstance(x, torch.Tensor)
                               else x).to(device)

    return put(tree)


def pad_to_multiple(batch, multiple: int):
    """Pad every leading axis to a multiple of ``multiple`` with zeros, so
    an uneven final batch still splits over the data ranks.  Returns
    (padded_batch, real_count)."""
    sizes = {np.shape(x)[0] for x in batch.values()}
    if len(sizes) != 1:
        raise ValueError(f"inconsistent batch dims {sizes}")
    n = sizes.pop()
    rem = (-n) % multiple
    if rem == 0:
        return batch, n
    return {k: np.pad(np.asarray(x), [(0, rem)] + [(0, 0)] * (np.ndim(x) - 1))
            for k, x in batch.items()}, n
