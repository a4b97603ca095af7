"""A plain fp32 reference of the DeepSeek-V3 text tower (Moonlight-16B-A3B's
architecture), written from the published ``modeling_deepseek.py``
(``DeepseekV3Attention``, ``MoEGate``, ``DeepseekV3MoE.moe_infer``,
``apply_rotary_pos_emb``) in plain ``torch``.  It imports neither the port
nor JAX, and shares no code with ``vault_tpu_torch/models/deepseek.py``:
its RoPE de-interleaves each head's rotary half and rotates it by halves, as
the published code does; its experts run token by token in expert order as
``moe_infer`` runs them.

``p`` is a flat dict of fp32 tensors named as the port's tower state dict
names them (``embed``, ``layers.<n>.q.w``, ..., ``final_ln``; projections
(in, out), experts (E, out, in)); ``cfg`` a dict of the published config's
keys plus ``kv_norm_eps``.
"""

import torch


def rms(x, w, eps):
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * w


def _rotate_half(x):
    half = x.shape[-1] // 2
    return torch.cat([-x[..., half:], x[..., :half]], dim=-1)


def rope(x, positions, theta):
    """``apply_rotary_pos_emb`` of the published code on x (B, h, L, d):
    the interleaved pairs gathered into halves (evens, then odds), then
    ``x cos + rotate_half(x) sin`` with cos and sin over cat(freqs, freqs)."""
    b, h, l, d = x.shape
    inv_freq = 1.0 / (theta ** (torch.arange(0, d, 2, dtype=torch.float64) / d))
    freqs = positions.double()[..., None] * inv_freq            # (B, L, d/2)
    emb = torch.cat([freqs, freqs], dim=-1)[:, None]             # (B, 1, L, d)
    x = x.view(b, h, l, d // 2, 2).transpose(4, 3).reshape(b, h, l, d)
    return (x * emb.cos().float()) + (_rotate_half(x) * emb.sin().float())


def router(p, name, cfg, h):
    """``MoEGate`` (noaux_tc, one group): (chosen (T, k), weights (T, k))."""
    scores = torch.sigmoid(h @ p[f"{name}.router.w"])
    choice = scores + p[f"{name}.router_bias"]
    chosen = torch.topk(choice, cfg["num_experts_per_tok"], dim=-1).indices
    weights = scores.gather(1, chosen)
    if cfg["norm_topk_prob"] and cfg["num_experts_per_tok"] > 1:
        weights = weights / (weights.sum(-1, keepdim=True) + 1e-20)
    return chosen, weights * cfg["routed_scaling_factor"]


def expert(p, name, e, x):
    g = x @ p[f"{name}.experts.gate"][e].t()
    u = x @ p[f"{name}.experts.up"][e].t()
    return (torch.nn.functional.silu(g) * u) @ p[f"{name}.experts.down"][e].t()


def swiglu(p, name, x):
    g, u = x @ p[f"{name}.gate.w"], x @ p[f"{name}.up.w"]
    return (torch.nn.functional.silu(g) * u) @ p[f"{name}.down.w"]


def moe(p, name, cfg, h):
    """``DeepseekV3MoE.forward``: ``moe_infer`` (the (token, choice) pairs
    sorted by expert, each expert on its tokens, the outputs put back and
    summed with their weights) plus the shared experts."""
    shape = h.shape
    h2 = h.reshape(-1, shape[-1])
    chosen, weights = router(p, name, cfg, h2)
    flat = chosen.reshape(-1)
    idxs = flat.argsort(stable=True)
    counts = torch.bincount(flat, minlength=cfg["n_routed_experts"]).tolist()
    tokens = h2[idxs // cfg["num_experts_per_tok"]]
    outs, start = [], 0
    for e, n in enumerate(counts):
        if n:
            outs.append(expert(p, name, e, tokens[start:start + n]))
        start += n
    outs = torch.cat(outs)
    back = torch.empty_like(outs)
    back[idxs] = outs
    routed = (back.view(*chosen.shape, -1) * weights[..., None]).sum(1)
    return routed.view(shape) + swiglu(p, f"{name}.shared", h)


def attention(p, name, cfg, x, bias, positions):
    """``DeepseekV3Attention`` without query compression."""
    b, l, _ = x.shape
    n = cfg["num_attention_heads"]
    dn, dr, dv = cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"], cfg["v_head_dim"]
    q = (x @ p[f"{name}.q.w"]).view(b, l, n, dn + dr).transpose(1, 2)
    q_nope, q_pe = q.split([dn, dr], dim=-1)
    ckv = x @ p[f"{name}.kv_a.w"]
    c, k_pe = ckv.split([cfg["kv_lora_rank"], dr], dim=-1)
    k_pe = k_pe.view(b, l, 1, dr).transpose(1, 2)
    kv = (rms(c, p[f"{name}.kv_ln"], cfg["kv_norm_eps"]) @ p[f"{name}.kv_b.w"])
    kv = kv.view(b, l, n, dn + dv).transpose(1, 2)
    k_nope, v = kv.split([dn, dv], dim=-1)
    q_pe, k_pe = rope(q_pe, positions, cfg["rope_theta"]), rope(k_pe, positions, cfg["rope_theta"])
    query = torch.cat([q_nope, q_pe], dim=-1)
    key = torch.cat([k_nope, k_pe.expand(b, n, l, dr)], dim=-1)
    scores = query @ key.transpose(2, 3) * (dn + dr) ** -0.5 + bias
    out = torch.softmax(scores, dim=-1) @ v
    return out.transpose(1, 2).reshape(b, l, n * dv) @ p[f"{name}.o.w"]


def tower(p, cfg, ids, mask):
    """The tower's last hidden states (B, L, H) under a causal + padding mask."""
    b, l = ids.shape
    eps = cfg["rms_norm_eps"]
    x = p["embed"][ids]
    positions = torch.arange(l).expand(b, l)
    keep = torch.tril(torch.ones(l, l))[None, None] * mask.float()[:, None, None, :]
    bias = (1.0 - keep) * torch.finfo(torch.float32).min
    for i in range(cfg["num_hidden_layers"]):
        name = f"layers.{i}"
        x = x + attention(p, name, cfg, rms(x, p[f"{name}.input_ln"], eps), bias, positions)
        h = rms(x, p[f"{name}.post_ln"], eps)
        x = x + (swiglu(p, f"{name}.mlp", h) if i < cfg["first_k_dense_replace"]
                 else moe(p, name, cfg, h))
    return rms(x, p["final_ln"], eps)

