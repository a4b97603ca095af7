"""The products a forward and a training step compute, counted by the
configuration's family (``portbench/families/<family>/flops.py``): FLOPs
by kind, ``dense`` being the linears that a w8a8 configuration runs on
int8.  Remat's recomputation is not model work and is never counted."""

from __future__ import annotations

from typing import Dict, Tuple

from portbench import families


def forward_products(cfg: dict, batch: int, seq: int, canvas: Tuple[int, int]) -> Dict[str, float]:
    """FLOPs of one forward by kind."""
    return families.load(cfg, "flops").forward_products(cfg, batch, seq, canvas)


def forward_flops(cfg: dict, batch: int, seq: int, canvas: Tuple[int, int]) -> float:
    return sum(forward_products(cfg, batch, seq, canvas).values())


def train_step_flops(cfg: dict, batch: int, seq: int, canvas: Tuple[int, int]) -> float:
    return families.load(cfg, "flops").train_step_flops(cfg, batch, seq, canvas)
