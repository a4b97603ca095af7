"""ToMe-style token merging (port of ``vault_tpu/ops/token_merge.py``).

Bipartite soft matching (Bolya et al., "Token Merging: Your ViT But
Faster", arXiv 2210.09461): tokens split into alternating sets A and B;
each A token finds its most cosine-similar B token; the r best-matched A
tokens are merged into their targets by size-weighted averaging.  Merged
tokens carry a ``size`` (how many originals they represent), and attention
becomes proportional, ``softmax(qk / sqrt(d) + log(size_k))``, through the
additive key bias the attention kernels already read.

As in the JAX package, ``r`` and the output length are static (one shape a
configuration), and the validity rules hold exactly: invalid (padded)
tokens are consumed first with zero merge weight, a valid A token is never
merged into an invalid B token, and a valid A token with no valid B target
(a batch row with fewer than two valid tokens) transfers its content, size
and validity into an invalid B slot, which flips valid.

In PyTorch idiom: ``torch.argsort(..., stable=True)`` for ``jnp.argsort``
(stable too), ``torch.gather`` for ``take_along_axis``, and the merged rows
are added into their targets with ``scatter_add`` in place of the JAX
package's one-hot product.  Both add the same fp32 terms; ``scatter_add``
adds them in another order than the product's sum over the r rows, so a
target that receives several merges may differ from the JAX package's
by fp32 rounding (the tests hold the step to 1e-6 in fp32 and to one bf16
ulp in bf16).  The cosine similarity is taken in fp32 with TF32 off
(a TF32 similarity would reorder near-ties), with the 1e-6 norm floor.
Merging is differentiable (the size-weighted average); its decisions are
piecewise constant, so gradients are exact almost everywhere.  It runs as
PyTorch operations: host-shaped gather and scatter work, with no kernel of
its own (the JAX package has no Pallas kernel for it either).
"""

from __future__ import annotations

from typing import Tuple

import torch

_NEG = -1e30


def _similarity(na: torch.Tensor, nb: torch.Tensor) -> torch.Tensor:
    """(B, la, H) x (B, lb, H) -> (B, la, lb) fp32, TF32 off on the card."""
    if na.device.type == "cuda":
        prev = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = False
        try:
            return torch.bmm(na, nb.transpose(1, 2))
        finally:
            torch.backends.cuda.matmul.allow_tf32 = prev
    return torch.bmm(na, nb.transpose(1, 2))


def merge_decisions(x: torch.Tensor, mask: torch.Tensor, r: int):
    """The decisions of one bipartite step: (order, dst) with ``order`` (B,
    la) the A rows in merge-first order (the first r merge, the rest stay)
    and ``dst`` (B, r) the B slot each merged row lands in.  ``r`` already
    clipped to 1..la."""
    xa, xb = x[:, 0::2], x[:, 1::2]
    ma = mask[:, 0::2].float()
    mb = mask[:, 1::2].float()

    fa, fb = xa.float(), xb.float()
    na = fa / torch.clamp(torch.linalg.vector_norm(fa, dim=-1, keepdim=True), min=1e-6)
    nb = fb / torch.clamp(torch.linalg.vector_norm(fb, dim=-1, keepdim=True), min=1e-6)
    sim_raw = _similarity(na, nb)
    # a valid A must never merge into an invalid B
    neg = torch.full_like(sim_raw, _NEG)
    sim = torch.where(mb[:, None, :] > 0, sim_raw, neg)
    val, best = sim.max(dim=-1)                           # first index on ties
    # a valid A row with no valid B target anywhere goes to its most
    # similar invalid B slot instead (content, size and validity move there)
    pair_ok = val > _NEG / 2
    best_inv = torch.where(mb[:, None, :] > 0, neg, sim_raw).argmax(dim=-1)
    # invalid A rows are consumed first; no-target rows rank last
    rank_val = torch.where(ma > 0, val, torch.full_like(val, float("inf")))
    order = torch.argsort(-rank_val, dim=1, stable=True)  # merge-first order
    dst = torch.gather(torch.where(pair_ok, best, best_inv), 1, order[:, :r])
    return order, dst


def bipartite_merge_step(x: torch.Tensor, sizes: torch.Tensor,
                         mask: torch.Tensor, r: int
                         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One bipartite soft-matching step: (B, L, H) -> (B, L - r, H).

    ``sizes`` (B, L) float: how many original tokens each row represents;
    ``mask`` (B, L) {0, 1} validity; ``r`` static, clipped to |A| =
    ceil(L / 2).  Returns (x', sizes', mask'), the output in the order
    [unmerged A tokens, updated B tokens]."""
    b, l, h = x.shape
    la = (l + 1) // 2
    r = int(min(r, la))
    if r <= 0:
        return x, sizes, mask
    order, dst = merge_decisions(x, mask, r)
    merge_rows, keep_rows = order[:, :r], order[:, r:]
    xa, xb = x[:, 0::2], x[:, 1::2]
    sa, sb = sizes[:, 0::2], sizes[:, 1::2]
    ma = mask[:, 0::2].float()
    mb = mask[:, 1::2].float()
    fa, fb = xa.float(), xb.float()
    lb = xb.shape[1]

    w = torch.gather(sa * ma, 1, merge_rows)                          # (B, r)
    src = torch.gather(fa, 1, merge_rows[..., None].expand(b, r, h))  # (B, r, H)
    contrib = torch.zeros((b, lb, h), dtype=torch.float32, device=x.device)
    contrib = contrib.scatter_add(1, dst[..., None].expand(b, r, h), src * w[..., None])
    w_in = torch.zeros((b, lb), dtype=torch.float32, device=x.device).scatter_add(1, dst, w)

    sbm = sb * mb                                       # invalid B: weight 0
    num = fb * sbm[..., None] + contrib
    den = sbm + w_in
    xb_new = (num / torch.clamp(den, min=1e-6)[..., None]).to(x.dtype)
    # a B row carries content if it was valid or received a transfer (w_in
    # > 0 there: normal merges target valid B only, invalid A weigh 0)
    receives = (mb > 0) | (w_in > 0)
    xb_new = torch.where(receives[..., None], xb_new, xb)
    sb_new = torch.where(receives, den, sb)
    mb_new = receives.to(mask.dtype)

    xa_keep = torch.gather(xa, 1, keep_rows[..., None].expand(b, la - r, h))
    sa_keep = torch.gather(sa, 1, keep_rows)
    ma_keep = torch.gather(mask[:, 0::2], 1, keep_rows)
    return (torch.cat([xa_keep, xb_new], dim=1),
            torch.cat([sa_keep, sb_new], dim=1),
            torch.cat([ma_keep, mb_new], dim=1))


def merge_schedule(length: int, target: int):
    """The r of each step that takes ``length`` tokens to ``max(target,
    1)``: one step removes at most ceil(L / 2), so 215 -> 87 is r = 108,
    then r = 20."""
    target, steps = max(int(target), 1), []
    while length > target:
        r = min(length - target, (length + 1) // 2)
        steps.append(r)
        length -= r
    return steps


def merge_tokens_to(x: torch.Tensor, mask: torch.Tensor, target: int
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Cascade bipartite merge steps until the length reaches ``target``.
    Returns (x', sizes', mask') with x'.shape[1] == max(target, 1)."""
    b, l, _ = x.shape
    sizes = torch.ones((b, l), dtype=torch.float32, device=x.device)
    for r in merge_schedule(l, target):
        x, sizes, mask = bipartite_merge_step(x, sizes, mask, r)
    return x, sizes, mask
