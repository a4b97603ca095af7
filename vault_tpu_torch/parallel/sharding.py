"""Tensor-parallel sharding rules over the port's state-dict keys (port of
``vault_tpu/parallel/sharding.py``).

The JAX package's rules, leaf for leaf:
  * q/k/v, ``mlp_in``, ``gate`` and ``up`` weights: the OUTPUT dim is split
    over "model" (column parallel: heads and intermediate columns);
  * ``attn_out``, ``mlp_out``, ``o`` and ``down`` weights: the INPUT dim
    (row parallel: partial products summed, parallel/tensor_parallel.py);
  * a column layer's bias and per-out-channel ``w_scale`` follow its
    output dim; a row layer's stay whole;
  * int8 codes (``w_q``, ``w_q8``) shard like the weights they replace;
  * embeddings, LayerNorms, poolers and heads stay whole.

A spec is a tuple with one entry per dim, "model" or None, as a
``PartitionSpec`` is.  The port keeps one tensor per layer where the JAX
package stacks the layers on axis 0 (``convert.stacked_leaf``), so a spec
here has the JAX leaf's entries without that axis; the K-major int8 codes
(``ops/quantize.py``) have the JAX shape, so the same dim.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

import torch

COLUMN_W = {"q", "k", "v", "mlp_in",
            # Llama tower (models/llama.py): SwiGLU in-projections
            "gate", "up"}
ROW_W = {"attn_out", "mlp_out",
         # Llama tower: attention output + SwiGLU down-projection
         "o", "down"}

Spec = Tuple[Optional[str], ...]


def _spec_for(key: str, leaf) -> Spec:
    names = key.split(".")
    sub = None
    for n in names:
        if n in COLUMN_W or n in ROW_W:
            sub = n
    param = names[-1]
    ndim = getattr(leaf, "ndim", 0)
    if sub in COLUMN_W:
        if param in ("w", "w_q", "w_q8", "b", "w_scale"):
            return (None,) * (ndim - 1) + ("model",)        # (..., in, OUT)
    if sub in ROW_W:
        if param in ("w", "w_q", "w_q8"):
            return (None,) * (ndim - 2) + ("model", None)   # (..., IN, out)
    return (None,) * ndim


def vault_param_specs(params: Mapping[str, torch.Tensor]) -> Dict[str, Spec]:
    """{key: spec} of a state dict under the TP rules."""
    return {k: _spec_for(k, v) for k, v in params.items()}


def shard_dim(spec: Spec) -> Optional[int]:
    return spec.index("model") if "model" in spec else None


def shard_leaf(t: torch.Tensor, dim: Optional[int], index: int, count: int
               ) -> torch.Tensor:
    """Block ``index`` of ``count`` of ``t`` along ``dim`` (``t`` itself
    when ``dim`` is None), in the layout ``t`` has: a K-major matrix (a
    transposed view of contiguous storage) stays K-major."""
    if dim is None or count == 1:
        return t
    size = t.shape[dim]
    if size % count:
        raise ValueError(f"dim {dim} of {tuple(t.shape)} does not split into "
                         f"{count} shards")
    part = t.narrow(dim, index * (size // count), size // count)
    if t.dim() == 2 and not t.is_contiguous() and t.t().is_contiguous():
        return part.t().contiguous().t()
    return part.contiguous()


def shard_params(params: Mapping[str, torch.Tensor], index: int, count: int
                 ) -> Dict[str, torch.Tensor]:
    """Shard ``index`` of ``count`` of every leaf under the TP rules (the
    JAX package's ``shard_params`` hands each device its block; here one
    rank or one device takes one)."""
    specs = vault_param_specs(params)
    return {k: shard_leaf(v, shard_dim(specs[k]), index, count)
            for k, v in params.items()}
