"""The program's expert choices, passed from the family's system to its
reference.

A run builds the program (``system.py``), times it, and then the reference
(``reference.py``) computes the checked batches.  Through 26 routed layers
the bf16 program and the fp32 reference choose other experts wherever a
row's sixth and seventh scores lie within rounding of each other, and the
moved rows move the rest, so the two would part whatever the precision.
The reference therefore follows the program's choice of a row where its
own scores put that choice within a tie of its own, and only there.

The harness loads each file of a family by its path, a module of its own
each time, so what passes between the two lives here, in a module imported
by name.  ``system.py`` leaves the program's router (:func:`leave`): a
function of a batch that runs the program on it and returns each MoE
layer's chosen experts.  The reference takes the routes of the batches it
checks (:func:`routes_of`), each batch's once, and then lets the program go
(:func:`release`); the routes stay for the rest of the process, so a
second reference of the same batches (the control) follows the same ones.
"""

from __future__ import annotations

from typing import Callable, Dict, Hashable, List, Optional

import torch

_router: Optional[Callable] = None
_taken: Dict[Hashable, List[torch.Tensor]] = {}


def leave(router: Optional[Callable]) -> None:
    """Hold the program's ``router(batch)`` (None: no program); the routes
    taken from an earlier one go."""
    global _router
    _router = router
    _taken.clear()


def routes_of(key: Hashable, batch: dict) -> Optional[List[torch.Tensor]]:
    """The program's chosen experts of ``batch`` (``key`` names it), one
    (rows, k) tensor an MoE layer; None where no program was left."""
    if key not in _taken and _router is not None:
        _taken[key] = _router(batch)
    return _taken.get(key)


def release() -> None:
    """Let the program go; the routes taken stay."""
    global _router
    _router = None
