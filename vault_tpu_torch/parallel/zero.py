"""ZeRO-1: the AdamW moments split over the data-parallel ranks (port of
``vault_tpu/parallel/zero.py``).

Plain data parallelism keeps every moment on every rank and runs the whole
elementwise update on each.  Here each rank keeps the slice of every moment
leaf that :func:`_leaf_spec` gives it, updates the same slice of the
parameters from the already all-reduced gradients, and all-gathers the
parameters afterwards (one collective per dtype for the whole model).  The update is elementwise, so parameters and
moments equal plain data parallelism's bit for bit.

  * fp32 and bf16 moments: a leaf splits along its largest axis that the
    rank count divides (ties: the first); a leaf that nothing divides
    stays whole on every rank, as in the JAX package;
  * int8 moments (``training/optimizer.py`` ``Q8Moment``): a slice holds
    whole blocks of the JAX leaf (``convert.stacked_leaf``'s stacked
    layers, one code sequence), codes and scales together, so every block's
    absmax is the unsplit one's; the block rows split into contiguous
    ranges, the last shorter when the count does not divide them.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from vault_tpu_torch.training.optimizer import (
    INT8_BLOCK,
    AdamWState,
    HfAdamW,
    Q8Moment,
    _q8_decode,
    _q8_encode,
    _sqrt,
    q8_groups,
)


def _leaf_spec(shape, dp: int) -> Tuple[Optional[str], ...]:
    """Spec sharding the largest axis divisible by ``dp`` (ties -> first);
    replicated when nothing divides (scalars, tiny vectors)."""
    best = None
    for i, d in enumerate(shape):
        if d % dp == 0 and d >= dp and (best is None or d > shape[best]):
            best = i
    if best is None:
        return ()
    spec: List[Optional[str]] = [None] * len(shape)
    spec[best] = "data"
    return tuple(spec)


def _axis(shape, dp: int) -> Optional[int]:
    spec = _leaf_spec(shape, dp)
    return spec.index("data") if "data" in spec else None


def block_range(nb: int, index: int, count: int) -> Tuple[int, int]:
    """Rank ``index``'s contiguous block rows of ``nb``."""
    per = -(-nb // count)
    lo = min(nb, index * per)
    return lo, min(nb, lo + per)


class ZeroAdamW:
    """:class:`~vault_tpu_torch.training.optimizer.HfAdamW` with its
    moments split over ``group`` (the mesh's "data" group), the same
    ``init`` / ``step_`` interface.  ``state.mu`` / ``state.nu`` hold this
    rank's slices."""

    def __init__(self, tx: HfAdamW, group):
        self.tx = tx
        self.group = group
        self.dp = dist.get_world_size(group)
        self.index = dist.get_rank(group)

    def __getattr__(self, name):
        return getattr(self.tx, name)

    def _slice(self, t: torch.Tensor) -> torch.Tensor:
        axis = _axis(t.shape, self.dp)
        if axis is None:
            return t
        n = t.shape[axis] // self.dp
        return t.narrow(axis, self.index * n, n)

    def init(self, params: Mapping[str, torch.Tensor]) -> AdamWState:
        if self.tx.int8:
            def fresh(keys):
                n = sum(params[k].numel() for k in keys)
                nb = -(-n // INT8_BLOCK)
                lo, hi = block_range(nb, self.index, self.dp)
                dev = params[keys[0]].device
                return Q8Moment(torch.zeros((hi - lo, INT8_BLOCK), dtype=torch.int8,
                                            device=dev),
                                torch.full((hi - lo, 1), 1e-12, device=dev))

            groups = q8_groups(params)
            return AdamWState(0, {g: fresh(ks) for g, ks in groups.items()},
                              {g: fresh(ks) for g, ks in groups.items()})
        dtype = self.tx.state_dtype

        def zeros(p):
            return torch.zeros_like(self._slice(p), dtype=dtype or p.dtype,
                                    memory_format=torch.contiguous_format)

        return AdamWState(0, {k: zeros(p) for k, p in params.items()},
                          {k: zeros(p) for k, p in params.items()})

    def _gather_slices(self, parts: List[torch.Tensor]) -> List[List[torch.Tensor]]:
        """Every rank's copy of each of this rank's ``parts`` (equal shapes
        on every rank), through one all-gather per dtype: [part][rank]."""
        from vault_tpu_torch.parallel.mesh import all_gather

        out: List[List[torch.Tensor]] = [[] for _ in parts]
        by_dtype: Dict[torch.dtype, List[int]] = {}
        for i, t in enumerate(parts):
            by_dtype.setdefault(t.dtype, []).append(i)
        for idx in by_dtype.values():
            flat = torch.cat([parts[i].reshape(-1) for i in idx])
            for whole in all_gather(flat, self.group):
                off = 0
                for i in idx:
                    n = parts[i].numel()
                    out[i].append(whole[off:off + n].view(parts[i].shape))
                    off += n
        return out

    @torch.no_grad()
    def step_(self, params: Mapping[str, torch.Tensor],
              grads: Mapping[str, torch.Tensor],
              state: AdamWState) -> AdamWState:
        if self.tx.int8:
            return self._step_q8(params, grads, state)
        views = {k: self._slice(p) for k, p in params.items()}
        slices = {k: self._slice(g) for k, g in grads.items()}
        # the plain update on this rank's slices (views into the parameters)
        state = self.tx.step_(views, slices, state)
        split = [(k, a) for k, p in params.items()
                 if (a := _axis(p.shape, self.dp)) is not None]
        gathered = self._gather_slices([views[k] for k, _ in split])
        for (k, axis), pieces in zip(split, gathered):
            params[k].copy_(torch.cat(pieces, dim=axis))
        return state

    def _step_q8(self, params, grads, state: AdamWState) -> AdamWState:
        tx = self.tx
        count = state.count + 1
        lr, step_size = tx.step_sizes(count)
        decay = float(np.float32(lr) * np.float32(tx.weight_decay))
        b1, b2 = tx.b1, tx.b2
        groups, parts = [], []
        for leaf, keys in q8_groups(params).items():
            ps = [params[k] for k in keys]
            flat_p = torch.cat([p.reshape(-1) for p in ps])
            g32 = torch.cat([grads[k].float().reshape(-1) for k in keys])
            n = g32.numel()
            nb = -(-n // INT8_BLOCK)
            lo, hi = block_range(nb, self.index, self.dp)
            a, b = min(n, lo * INT8_BLOCK), min(n, hi * INT8_BLOCK)
            mu, nu = state.mu[leaf], state.nu[leaf]
            g = g32[a:b]
            m32 = b1 * _q8_decode(mu, b - a) + (1 - b1) * g
            s = _q8_decode(nu, b - a)
            v32 = b2 * s * s + (1 - b2) * g * g
            root = _sqrt(v32)
            for dst, src in ((mu, _q8_encode(m32)), (nu, _q8_encode(root))):
                dst.q.copy_(src.q)
                dst.scale.copy_(src.scale)
            upd = (-step_size * m32) / (root + tx.eps)
            if tx.weight_decay > 0.0:
                upd = upd - decay * flat_p[a:b].float()
            # equal-length pieces for the gather: padded to the longest range
            per = -(-nb // self.dp) * INT8_BLOCK
            padded = torch.zeros(per, dtype=flat_p.dtype, device=flat_p.device)
            padded[:b - a] = flat_p[a:b] + upd.to(flat_p.dtype)
            groups.append((ps, n, nb, per))
            parts.append(padded)
        for (ps, n, nb, per), pieces in zip(groups, self._gather_slices(parts)):
            spans = [block_range(nb, r, self.dp) for r in range(self.dp)]
            flat = torch.cat([piece[:min(n, hi * INT8_BLOCK) - min(n, lo * INT8_BLOCK)]
                              for piece, (lo, hi) in zip(pieces, spans)])
            off = 0
            for p in ps:
                p.copy_(flat[off:off + p.numel()].view(p.shape))
                off += p.numel()
        return AdamWState(count, state.mu, state.nu)


def moment_bytes(state: AdamWState) -> int:
    """Bytes this rank holds in ``state``'s moments."""
    total = 0
    for moments in (state.mu, state.nu):
        for v in moments.values():
            if isinstance(v, Q8Moment):
                total += v.q.numel() * v.q.element_size()
                total += v.scale.numel() * v.scale.element_size()
            else:
                total += v.numel() * v.element_size()
    return total
