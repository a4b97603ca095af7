"""The routed experts of a mixture-of-experts layer (DeepSeek-V3's
``DeepseekV3MoE``, as Moonlight-16B-A3B runs it), routed on the device
without a host synchronisation and without dropping a token.

The JAX package has no routed experts; this layer is the port's own.  One
layer's routed half, for rows h (T, H):

  * :func:`route`: the sigmoid router in fp32 (``scores = sigmoid(h W_r)``),
    the top k of ``scores + bias`` chosen (the bias moves the choice, never
    the weights), each row's k weights ``scores[chosen]`` normalised to sum
    to one (``norm_topk_prob``) and scaled (``routed_scaling_factor``).  One
    group (``n_group = topk_group = 1``): the group step chooses all.
  * :func:`dispatch`: the R = T k (row, choice) pairs put in expert order,
    stable (rows ascending within an expert), with the offsets of each
    expert's run, from running counts taken by comparison and cumulative
    sums on the device: no sort, no ``bincount`` (which reads its maximum on
    the host).
  * :func:`grouped_experts`: every expert's SwiGLU on its own run of rows,
    the route weight applied in fp32 before the one cast:
    ``bf16(w * (bf16(silu(x Wg^T) * (x Wu^T)) Wd^T))``, through the operator
    ``vault_tpu_torch::moe_experts`` (``ops/cuda_moe.py``: the grouped
    Hopper kernel on the card, :func:`moe_experts_plain` for CPU tensors).
  * the combine: each row's k weighted outputs gathered back into row order
    and summed in fp32 in choice order, one cast; no ``index_add_``, so two
    runs of one batch give the same bits.

Expert weights are held as HF holds them, (out, in): gate and up (E, I, H),
down (E, H, I).  Departures from the published code (``modeling_deepseek.py``
``moe_infer``), each a rounding: the gate and up products are not rounded to
bf16 before ``silu(g) * u``, and the route weight multiplies each expert's
fp32 output before its cast, where HF weights the bf16 output in fp32.  The
choices come from ``torch.topk`` in descending order, so the combine sums
each row's experts from the highest score down.
"""

from __future__ import annotations

from typing import Tuple

import torch

from vault_tpu_torch.ops.nn import matmul_fp32, silu
from vault_tpu_torch.utils.profiling import span


def route(h: torch.Tensor, w_router: torch.Tensor, bias: torch.Tensor, top_k: int,
          scaling: float, norm_topk_prob: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """The chosen experts (T, k) int64 and their weights (T, k) fp32 of rows
    h (T, H); ``w_router`` (H, E), ``bias`` (E,)."""
    scores = torch.sigmoid(h.float() @ w_router.float())
    chosen = torch.topk(scores + bias.float(), top_k, dim=-1).indices
    weights = scores.gather(1, chosen)
    if norm_topk_prob and top_k > 1:
        weights = weights / (weights.sum(-1, keepdim=True) + 1e-20)
    return chosen, weights * scaling


def dispatch(chosen: torch.Tensor, n_experts: int):
    """Expert order of the pairs of ``chosen`` (T, k), pair p = row p // k,
    choice p % k: ``offsets`` (E + 1,) int32, expert e's run
    [offsets[e], offsets[e + 1]); ``order`` (R,), the pair at each position;
    ``position`` (R,), the position of each pair (the inverse of
    ``order``).  All on the device, nothing read on the host."""
    flat = chosen.reshape(-1)
    # (E, R): each expert's running count is a scan along the inner dim;
    # taken along the pairs (an outer-dim scan of (R, E)) it cost 23 ms a
    # layer at R 61,440 on the H100
    hits = (torch.arange(n_experts, device=flat.device)[:, None] == flat[None]).to(torch.int32)
    running = hits.cumsum(1)
    counts = running[:, -1]
    rank = running.gather(0, flat[None]).squeeze(0) - 1
    offsets = torch.cat([counts.new_zeros(1), counts.cumsum(0)])
    position = offsets[flat] + rank
    order = torch.empty_like(position).scatter_(
        0, position, torch.arange(flat.numel(), device=flat.device))
    return offsets.to(torch.int32), order, position


def moe_experts_plain(x, w_gate, w_up, w_down, offsets, route_w):
    """The grouped experts in plain PyTorch, a loop over the experts (the
    offsets read on the host): rows x (R, H) in expert order, gate and up
    (E, I, H), down (E, H, I), ``offsets`` (E + 1,), route weights (R,)
    fp32 -> (R, H) in x's type, as the module docstring writes it."""
    out = torch.empty_like(x)
    bounds = offsets.tolist()
    for e in range(w_gate.shape[0]):
        a, b = bounds[e], bounds[e + 1]
        if a == b:
            continue
        xe = x[a:b]
        g = matmul_fp32(xe, w_gate[e].t())
        u = matmul_fp32(xe, w_up[e].t())
        act = (silu(g) * u).to(x.dtype)
        out[a:b] = (matmul_fp32(act, w_down[e].t()) * route_w[a:b, None]).to(x.dtype)
    return out


def grouped_experts(x, w_gate, w_up, w_down, offsets, route_w):
    """Every expert on its run of ``x``, through the operator."""
    from vault_tpu_torch.ops.cuda_moe import MOE_EXPERTS
    from vault_tpu_torch.ops._dispatch import kernel_or_plain

    return kernel_or_plain(MOE_EXPERTS, moe_experts_plain, x, w_gate, w_up, w_down,
                           offsets, route_w)


def routed_experts(h: torch.Tensor, p, top_k: int, scaling: float, norm_topk_prob: bool,
                   routes=None) -> torch.Tensor:
    """The routed half of an MoE layer on h (..., H): ``p`` holds ``router``
    ({"w": (H, E)}), ``router_bias`` (E,) and ``experts`` (gate, up, down).
    ``routes``, a list, gets the chosen experts (T, k).  Spans
    ``vault.moe.route``, ``vault.moe.experts``, ``vault.moe.combine``."""
    shape, hidden = h.shape, h.shape[-1]
    h2 = h.reshape(-1, hidden)
    ex = p["experts"]
    with span("vault.moe.route"):
        chosen, weights = route(h2, p["router"]["w"], p["router_bias"], top_k, scaling,
                                norm_topk_prob)
        if routes is not None:
            routes.append(chosen)
        offsets, order, position = dispatch(chosen, ex["gate"].shape[0])
        x = h2.index_select(0, order // top_k)
        route_w = weights.reshape(-1).index_select(0, order)
    with span("vault.moe.experts"):
        out = grouped_experts(x, ex["gate"], ex["up"], ex["down"], offsets, route_w)
    with span("vault.moe.combine"):
        y = out.index_select(0, position).view(-1, top_k, hidden).float().sum(1)
    return y.to(h.dtype).view(shape)
