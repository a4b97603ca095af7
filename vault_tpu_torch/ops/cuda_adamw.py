"""HF AdamW's update over many parameter leaves in one launch of the
hand-written kernel ``csrc/adamw.cu`` (multi-tensor), beside the per-leaf
loop of ``training/optimizer.py`` ``HfAdamW.step_``, which is its plain
version and the CPU's path.  On the card the two agree bit for bit (the
kernel does the loop's fp32 operations in its order, each rounded once).

  * :func:`split`: the route, by device alone.  Every leaf whose parameter
    lies on the card takes the kernel; the CPU's leaves take the loop.
  * :func:`gather`: the kernel's leaves by group, (card, parameter,
    gradient, moment dtype), in the parameters' order, each leaf as its row
    of the device table.  The kernel takes fp32 and bf16 in any
    combination (both moments of one type) and arrays laid out as rows of
    one length, each with its own row stride (:func:`rows_of`): contiguous
    tensors, and ZeRO's slices of a leaf on any axis.  A gradient in
    another layout (the ViLT patch projection's, channels last from the
    convolution's backward) is copied contiguous first: the update is
    elementwise, so the result is the loop's.  Any other leaf on the card
    raises ``ValueError``: another dtype (fp16, fp64), a parameter or moment
    in another layout, or arrays that do not match (shape, card).
  * :class:`FusedAdamW`: one optimizer's device tables, per group, built
    once and rebuilt only when its rows change (a resume, ``init``, new
    tensors): each leaf's parameter and moment addresses, size and layout,
    and the block table that cuts the group's elements into chunks of
    :data:`CHUNK` elements of one leaf each.  The gradients are new tensors
    every step: their addresses travel by value in the launch's parameters.
    A step costs the host one pass over the leaves and one launch a group
    of up to :data:`MAX_LEAVES` leaves, with no device allocation and no
    synchronisation.
  * :func:`fused_adamw`: one launch; ``fused_adamw.launches`` counts them.
"""

from __future__ import annotations

import ctypes
import struct
from typing import Dict, Iterable, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from vault_tpu_torch.ops import _build

# csrc/adamw.cu's kChunk and kMaxLeaves: elements a block updates, and the
# gradient addresses one launch carries in its parameters (480 x 8 bytes
# under the 4 KB of kernel parameters that CUDA 12 always takes)
CHUNK = 8192
MAX_LEAVES = 480
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# (parameter, gradient, moment) dtypes the kernel takes
_COMBOS = {(p, g, m) for p in _DTYPES for g in _DTYPES for m in _DTYPES}
_SIGNATURES = {"vt_adamw": (
    [ctypes.c_int] * 3 + [ctypes.c_void_p] * 2 + [ctypes.c_int, ctypes.c_char_p]
    + [ctypes.c_int] * 2 + [ctypes.c_float] * 7 + [ctypes.c_int, ctypes.c_void_p],
    ctypes.c_int)}

# a leaf: (parameter, gradient, first moment, second moment)
Leaf = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]
# a group: (card index, parameter, gradient, moment dtype)
GroupKey = Tuple[int, torch.dtype, torch.dtype, torch.dtype]


class Hyper(NamedTuple):
    """A step's scalars as the loop's fp32 operations read them: b1,
    1 - b1, b2, 1 - b2 (the differences taken in double), -step_size, eps,
    the decay lr * weight_decay, and whether the decay term runs (the
    loop's ``weight_decay > 0``)."""
    b1: float
    omb1: float
    b2: float
    omb2: float
    neg_step: float
    eps: float
    decay: float
    decay_on: bool


class Group(NamedTuple):
    """One group's leaves as the kernel reads them: ``rows``, each leaf's
    row of the device table (parameter, first and second moment addresses,
    size, row length, and the parameter's, gradient's and moments' row
    strides, in elements); ``grads``, the gradients in order;
    ``moments``, each leaf's (first, second) moment."""
    rows: List[tuple]
    grads: List[torch.Tensor]
    moments: List[Tuple[torch.Tensor, torch.Tensor]]


class Launch(NamedTuple):
    """One launch's device tables: ``leaves`` int64 (n, 9), the group's
    rows; ``blocks`` int32 (n_blocks, 2), each block's leaf (a row of
    ``leaves``) and chunk.  ``lo``: the launch's first leaf in its group."""
    leaves: torch.Tensor
    blocks: torch.Tensor
    lo: int


def rows_of(t: torch.Tensor) -> Optional[Tuple[int, int]]:
    """(cols, stride): ``t``'s elements, in order, are rows of ``cols``
    contiguous elements ``stride`` apart (``stride == cols``: contiguous);
    None for any other layout (permuted, overlapping)."""
    dims = [(n, s) for n, s in zip(t.shape, t.stride()) if n != 1]
    cols = 1
    while dims and dims[-1][1] == cols:
        cols *= dims.pop()[0]
    if not dims:
        return cols, cols
    stride = expect = dims[-1][1]
    for n, s in reversed(dims):
        if s != expect:
            return None
        expect *= n
    return (cols, stride) if stride > cols else None


def _strided_row(p, g, m, v, n):
    """(gradient, row) of a leaf with an array that is not contiguous: one
    row length for the arrays, a row stride each; the gradient copied
    contiguous when its layout fits neither."""
    lays = [rows_of(t) for t in (p, m, v)]
    if None in lays or len({c for c, s in lays if s != c}) > 1:
        raise ValueError(
            f"HfAdamW: the kernel takes parameters and moments laid out as rows of one "
            f"length; got strides {p.stride()}, {m.stride()}, {v.stride()} for shape "
            f"{tuple(p.shape)}")
    cols = next((c for c, s in lays if s != c), None)
    lay = rows_of(g)
    if lay is None or (lay[1] != lay[0] and cols is not None and lay[0] != cols):
        g, lay = g.contiguous(), (n, n)
    if cols is None:
        cols = lay[0] if lay[1] != lay[0] else n
    sp, sg, sm, sv = (s if s != c else cols for c, s in (*lays[:1], lay, *lays[1:]))
    return g, (p.data_ptr(), m.data_ptr(), v.data_ptr(), n, cols, sp, sg, sm, sv)


def _refuse(p, g, m, v):
    arrays = ", ".join(f"{name} {t.dtype} {tuple(t.shape)} on {t.device}" for name, t in
                       (("parameter", p), ("gradient", g), ("moments", m), ("and", v)))
    raise ValueError(
        f"HfAdamW: the kernel takes a parameter, its gradient of the same shape on the "
        f"same card and two moments of its size, fp32 or bf16 each, the moments of one "
        f"type; got {arrays}")


def gather(leaves: Iterable[Leaf]) -> Dict[GroupKey, Group]:
    """The kernel's leaves by :data:`GroupKey`, in order (see the module
    docstring); ``ValueError`` for a leaf the kernel does not take.  The
    moments' card and shape are checked where the tables are built
    (:meth:`FusedAdamW.tables`): a moment at a held address is on the card
    it was on, and its size is checked here."""
    groups: Dict[GroupKey, Group] = {}
    for p, g, m, v in leaves:
        key = (p.get_device(), p.dtype, g.dtype, m.dtype)
        group = groups.get(key)
        if group is None:
            if key[1:] not in _COMBOS:
                _refuse(p, g, m, v)
            group = groups[key] = Group([], [], [])
        n = p.numel()
        if not (v.dtype is key[3] and g.get_device() == key[0] and p.shape == g.shape
                and m.numel() == n == v.numel()):
            _refuse(p, g, m, v)
        if p.is_contiguous() and g.is_contiguous() and m.is_contiguous() and v.is_contiguous():
            row = (p.data_ptr(), m.data_ptr(), v.data_ptr(), n, n, n, n, n, n)
        else:
            g, row = _strided_row(p, g, m, v, n)
        group.rows.append(row)
        group.grads.append(g)
        group.moments.append((m, v))
    return groups


def split(params, grads, mu, nu) -> Tuple[Dict[GroupKey, Group], List[str]]:
    """(groups, loop): the card's leaves for the kernel (:func:`gather`)
    and the keys of the CPU's, for the loop."""
    card: List[Leaf] = []
    loop: List[str] = []
    for k, p in params.items():
        if p.is_cuda:
            card.append((p, grads[k], mu[k], nu[k]))
        else:
            loop.append(k)
    return gather(card), loop


def block_table(sizes: Sequence[int]) -> np.ndarray:
    """(leaf, chunk) int32 pairs: every leaf's elements in chunks of
    :data:`CHUNK`, leaf by leaf; an empty leaf has none."""
    sizes = np.asarray(sizes, dtype=np.int64)
    per = -(-sizes // CHUNK)
    leaf = np.repeat(np.arange(len(sizes), dtype=np.int64), per)
    first = np.repeat(np.cumsum(per) - per, per)
    return np.stack([leaf, np.arange(len(leaf)) - first], axis=1).astype(np.int32)


class FusedAdamW:
    """One optimizer's device tables, per group (see the module
    docstring)."""

    def __init__(self):
        self._tables: Dict[GroupKey, Tuple[List[tuple], List[Launch]]] = {}

    def tables(self, key: GroupKey, group: Group) -> List[Launch]:
        """The group's launches, rebuilt when its rows changed."""
        held = self._tables.get(key)
        if held is not None and held[0] == group.rows:
            return held[1]
        dev = group.grads[0].device
        for g, (m, v) in zip(group.grads, group.moments):
            if not (m.device == v.device == dev and m.shape == v.shape == g.shape):
                raise ValueError(f"HfAdamW: moments {tuple(m.shape)} on {m.device} and "
                                 f"{tuple(v.shape)} on {v.device} for a gradient "
                                 f"{tuple(g.shape)} on {dev}")
        launches = []
        for lo in range(0, len(group.rows), MAX_LEAVES):
            part = group.rows[lo:lo + MAX_LEAVES]
            table = torch.tensor(part, dtype=torch.int64)
            blocks = torch.from_numpy(block_table([row[3] for row in part]))
            launches.append(Launch(table.to(dev), blocks.to(dev), lo))
        self._tables[key] = (group.rows, launches)
        return launches

    def step_(self, groups: Dict[GroupKey, Group], hyper: Hyper) -> None:
        """Every group's leaves updated in place, one launch a group of up
        to :data:`MAX_LEAVES` leaves."""
        for key, group in groups.items():
            for launch in self.tables(key, group):
                fused_adamw(key, launch, group.grads[launch.lo:launch.lo + MAX_LEAVES], hyper)


def fused_adamw(key: GroupKey, launch: Launch, grads: Sequence[torch.Tensor],
                hyper: Hyper) -> None:
    """One launch of ``csrc/adamw.cu`` over ``launch``'s leaves with these
    gradients (one per leaf, in order), on the card's current stream."""
    dev, pd, gd, md = key
    lib = _build.load("adamw", _SIGNATURES)
    ptrs = struct.pack(f"{len(grads)}Q", *[g.data_ptr() for g in grads])
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = lib.vt_adamw(_DTYPES[pd], _DTYPES[gd], _DTYPES[md], launch.leaves.data_ptr(),
                            launch.blocks.data_ptr(), launch.blocks.shape[0], ptrs,
                            len(grads), CHUNK, *hyper[:7], int(hyper.decay_on), stream)
    _build.check(lib, code, "adamw")
    fused_adamw.launches += 1


fused_adamw.launches = 0
