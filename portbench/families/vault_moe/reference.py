"""The plain reference of the ``vault_moe`` family: a DeepSeek-V3 text tower
(Moonlight-16B-A3B) whose last hidden states, projected by ``lm_proj``,
feed ViLT-B/32 as its text embeddings, ViLT's tanh pooler and the linear
head.  Written from the published ``modeling_deepseek.py`` and HF
``ViltModel`` in plain PyTorch, fp32 with TF32 off, and independent of the
program: it imports nothing of it.

The run's bf16 weights are made again from their streams one layer at a
time (``weights.py`` :func:`draw`), in fp32 (2.3 GB an MoE layer at the
published widths), and every checked batch goes through a layer before the
next layer is made.  The tower's departures from the published code are
the port's documented ones, none of them a rounding the reference copies:
``kv_a_layernorm``'s eps is ``assumed.kv_norm_eps`` (its class default),
the rotary pairs are rotated in place (the same dot products), and ViLT's
are the BERT family's (``portbench/reference/vault_ref.py``).

The routes: through 26 routed layers, rounding moves the top 6 of a row
wherever its sixth and seventh scores lie within rounding of each other,
and a moved row moves others, so the program and any reference that
chooses for itself part whatever the precision (at random weights the
fp32 reference against itself with TF32 products reads a logit gap of
0.14–0.48).  So where the program has left its routes (``routes.py``), the
reference follows the program's six experts of a row wherever its own fp32
scores (+ bias) put them within :data:`TIE` of its own top 6: the lowest
of the six at least the highest of the rest less :data:`TIE`.  Elsewhere,
and for a row whose six are not six distinct experts, it takes its own.
The weights are always its own scores of the experts it takes.

``prec`` "fp8" (the control one precision below bf16) runs every product
of the tower, ``lm_proj`` and ViLT's encoder on e4m3 codes (one scale a
row of the activations, one a column of the weights), their products
summed in fp32; the router stays fp32, as in the program.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from portbench import families
from portbench.check import full_fp32
from portbench.families.vault_moe import routes as program_routes
from portbench.generate import make_batch
from portbench.reference.vault_ref import _attention, _codes, _key_bias, _linear, _ln, patch_tokens


# How far below the highest of the rest the program's lowest chosen score
# may lie (sigmoid score + bias).  Through the tower the bf16 program's
# states drift from the fp32 reference's even where both route alike, and
# the largest shortfall of its choices grows from 0.007 at the first MoE
# layer to 0.039 at the last (3 seeds, 8 batches each, on the H100); the
# fp8 control's reaches 0.11 to 0.43.  Three times the program's largest.
TIE = 2.0 ** -3


def _mm(x: torch.Tensor, w: torch.Tensor, prec: Optional[str]) -> torch.Tensor:
    """x @ w for w (in, out); on codes of ``prec``."""
    if prec is None:
        return x @ w
    xq, xs = _codes(x, -1, prec)
    wq, ws = _codes(w, -2, prec)
    return (xq @ wq) * (xs * ws)


def _rms(x, w, eps):
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * w


def _rope(x, positions, theta):
    """Each adjacent pair (2i, 2i + 1) of x's last dim rotated by position ·
    θ^(−2i/d)."""
    d = x.shape[-1]
    inv = 1.0 / theta ** (torch.arange(0, d, 2, device=x.device, dtype=torch.float64) / d)
    angle = positions.double()[:, None, :, None] * inv
    c, s = torch.cos(angle).float(), torch.sin(angle).float()
    a, b = x[..., 0::2], x[..., 1::2]
    return torch.stack([a * c - b * s, b * c + a * s], dim=-1).flatten(-2)


def _swiglu(p, name, x, prec):
    a = F.silu(_mm(x, p[f"{name}.gate.w"], prec)) * _mm(x, p[f"{name}.up.w"], prec)
    return _mm(a, p[f"{name}.down.w"], prec)


def _mla(p, name, t, x, bias, positions, prec):
    b, l, _ = x.shape
    n, dn, dr, dv = (t["num_attention_heads"], t["qk_nope_head_dim"], t["qk_rope_head_dim"],
                     t["v_head_dim"])
    q = _mm(x, p[f"{name}.q.w"], prec).view(b, l, n, dn + dr).transpose(1, 2)
    c, k_pe = _mm(x, p[f"{name}.kv_a.w"], prec).split([t["kv_lora_rank"], dr], dim=-1)
    kv = _mm(_rms(c, p[f"{name}.kv_ln"], t["kv_norm_eps"]), p[f"{name}.kv_b.w"], prec)
    k_nope, v = kv.view(b, l, n, dn + dv).transpose(1, 2).split([dn, dv], dim=-1)
    theta = t["rope_theta"]
    query = torch.cat([q[..., :dn], _rope(q[..., dn:], positions, theta)], dim=-1)
    k_pe = _rope(k_pe[:, None], positions, theta).expand(b, n, l, dr)
    key = torch.cat([k_nope, k_pe], dim=-1)
    probs = torch.softmax(query @ key.transpose(-1, -2) / (dn + dr) ** 0.5 + bias, dim=-1)
    return _mm((probs @ v).transpose(1, 2).reshape(b, l, n * dv), p[f"{name}.o.w"], prec)


def choose(key: torch.Tensor, k: int, given: Optional[torch.Tensor] = None,
           seen: Optional[list] = None) -> torch.Tensor:
    """The k experts of each row of ``key`` (T, E), scores + bias: its own
    top k, or the row of ``given`` (T, k), the program's, where that is
    within :data:`TIE` of a top k (see the module docstring).  ``seen``, a
    list, gets the layer's shares of rows taken from the program where its
    own differ and refused, and the largest shortfall taken."""
    own = torch.topk(key, k, dim=-1).indices
    if given is None:
        return own
    given = given.to(own.device, torch.int64)
    fits = ((given >= 0) & (given < key.shape[1])).all(-1)
    given = torch.where(fits[:, None], given, own)
    ordered = given.sort(-1).values
    fits &= (ordered[:, 1:] != ordered[:, :-1]).all(-1)
    short = key.scatter(1, given, -math.inf).amax(-1) - key.gather(1, given).amin(-1)
    take = fits & (short <= TIE)
    if seen is not None:
        other = (ordered != own.sort(-1).values).any(-1)
        seen.append({"followed": float((take & other).float().mean()),
                     "refused": float((~take).float().mean()),
                     "shortfall": float(short[take].max()) if take.any() else 0.0})
    return torch.where(take[:, None], given, own)


def _moe(p, name, t, h, prec, routes=None, given=None, seen=None):
    """The sigmoid router (fp32), the top k of scores + bias (or the
    program's ``given`` choice at a tie, :func:`choose`), the chosen scores
    normalised and scaled; each expert on its rows; the shared experts.
    ``routes``: a list that gets the chosen experts (T, k)."""
    shape = h.shape
    h2 = h.reshape(-1, shape[-1])
    k = t["num_experts_per_tok"]
    scores = torch.sigmoid(h2 @ p[f"{name}.router.w"])
    chosen = choose(scores + p[f"{name}.router_bias"], k, given, seen)
    weights = scores.gather(1, chosen)
    if t["norm_topk_prob"] and k > 1:
        weights = weights / (weights.sum(-1, keepdim=True) + 1e-20)
    weights = weights * t["routed_scaling_factor"]
    if routes is not None:
        routes.append(chosen)
    out = torch.zeros_like(h2)
    gate, up, down = (p[f"{name}.experts.{s}"] for s in ("gate", "up", "down"))
    for e in range(gate.shape[0]):
        rows, slot = (chosen == e).nonzero(as_tuple=True)
        if rows.numel():
            x = h2[rows]
            a = F.silu(_mm(x, gate[e].t(), prec)) * _mm(x, up[e].t(), prec)
            out.index_add_(0, rows, weights[rows, slot, None] * _mm(a, down[e].t(), prec))
    return out.view(shape) + _swiglu(p, f"{name}.shared", h, prec)


def tower(cfg, seed, ids, mask, device, prec=None, routes=None, given=None, seen=None):
    """The tower's last hidden states of ``ids`` (B, L), its weights made
    layer by layer from the run's seed; ``routes`` gets each MoE layer's
    chosen experts; ``given``, the program's, one (B L, k) an MoE layer, are
    followed at a tie; ``seen`` gets :func:`choose`'s shares a layer."""
    w = families.load(cfg, "weights")
    t = {**cfg["text_tower"], "kv_norm_eps": cfg["assumed"]["kv_norm_eps"]}
    dtype = getattr(torch, cfg["dtype"])

    def made(names):
        return {k: v.float() for k, v in w.draw(cfg, seed, dtype, device, set(names))}

    x = made(["deepseek.embed"])["deepseek.embed"][ids]
    b, l = ids.shape
    positions = torch.arange(l, device=device).expand(b, l)
    keep = torch.tril(torch.ones((l, l), device=device))[None, None] * mask.float()[:, None, None]
    bias = (1.0 - keep) * torch.finfo(torch.float32).min
    eps = t["rms_norm_eps"]
    given = iter(given or ())
    for n in range(t["num_hidden_layers"]):
        p, name = made(w.tower_layer_shapes(t, n)), f"deepseek.layers.{n}"
        x = x + _mla(p, name, t, _rms(x, p[f"{name}.input_ln"], eps), bias, positions, prec)
        h = _rms(x, p[f"{name}.post_ln"], eps)
        x = x + (_swiglu(p, f"{name}.mlp", h, prec) if n < t["first_k_dense_replace"]
                 else _moe(p, name, t, h, prec, routes, next(given, None), seen))
        del p
    return _rms(x, made(["deepseek.final_ln"])["deepseek.final_ln"], eps)


def vilt_logits(p, cfg, hidden, batch, prec=None):
    """``lm_proj``, then ViLT (its text positions off, as behind any text
    tower) and the head, of one batch's tower states."""
    v = cfg["vilt"]
    eps = v["layer_norm_eps"]
    mask = batch["attention_mask"]
    text = _mm(hidden, p["lm_proj.w"], prec) + p["lm_proj.b"]
    text = text + p["vilt.text_embeddings.token_type"][batch["token_type_ids"]]
    text = _ln(p, "vilt.text_embeddings.ln", text, eps)
    img, img_mask = patch_tokens(p, cfg, batch["pixel_values"].float(), batch["pixel_mask"])
    x = torch.cat([text + p["vilt.modality_type"][0], img + p["vilt.modality_type"][1]], 1)
    bias = _key_bias(torch.cat([mask.float(), img_mask], dim=1))
    for n in range(v["num_hidden_layers"]):
        name = f"vilt.layers.{n}"
        x = x + _attention(p, name, _ln(p, f"{name}.ln_before", x, eps), bias,
                           v["num_attention_heads"], prec, False, None, 0.0)
        y = _linear(p, f"{name}.mlp_in", _ln(p, f"{name}.ln_after", x, eps), prec)
        x = x + _linear(p, f"{name}.mlp_out", F.gelu(y), prec)
    x = _ln(p, "vilt.final_ln", x, eps)
    pooled = torch.tanh(_linear(p, "vilt.pooler", x[:, 0]))
    return _linear(p, "head.out", pooled)


def program_choices(seed: int, indices, batches) -> Optional[list]:
    """The program's routes of the batches, each MoE layer's over all their
    rows, where the program left them (``routes.py``); then the program
    goes."""
    taken = [program_routes.routes_of((seed, i), b) for i, b in zip(indices, batches)]
    program_routes.release()
    if any(r is None for r in taken):
        return None
    return [torch.cat(layer) for layer in zip(*taken)]


def score_reference(cfg: dict, traffic: dict, seed: int, indices, device,
                    prec=None, routes=None, seen=None) -> Dict[int, np.ndarray]:
    """The reference's logits of the run's batches ``indices``, following
    the program's routes at a tie where it left them."""
    indices = list(indices)
    with torch.no_grad():
        batches = [make_batch(traffic, cfg, seed, i, device)[0] for i in indices]
        given = program_choices(seed, indices, batches)
    with torch.no_grad(), full_fp32():
        hidden = tower(cfg, seed, torch.cat([b["input_ids"] for b in batches]),
                       torch.cat([b["attention_mask"] for b in batches]), device, prec, routes,
                       given, seen)
        w = families.load(cfg, "weights")
        names = [k for k in w.param_shapes(cfg) if not k.startswith("deepseek.")]
        p = {k: v.float() for k, v in w.draw(cfg, seed, getattr(torch, cfg["dtype"]), device,
                                             set(names))}
        out, start = {}, 0
        for i, batch in zip(indices, batches):
            rows = batch["input_ids"].shape[0]
            logits = vilt_logits(p, cfg, hidden[start:start + rows], batch, prec)
            out[i] = logits.cpu().numpy()
            start += rows
    return out
