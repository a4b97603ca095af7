"""The DeepSeek-V3 tower (``vault_tpu_torch/models/deepseek.py``), its routed
experts (``ops/moe.py``) and ``VaultWithDeepseekTower`` against the plain
fp32 reference ``tests/deepseek_reference.py`` at a tiny size on the CPU,
with seeded weights (non-unit norms, a router bias that moves choices).
fp32 throughout: the limits are fp32 round-off over a few layers (the two
sides sum in other orders), 1e-5 of values of order one."""

import dataclasses

import numpy as np
import pytest
import torch

import deepseek_reference as ref
from vault_tpu_torch.config import tiny_vilt_config
from vault_tpu_torch.models import deepseek as ds
from vault_tpu_torch.models import vault as tvault
from vault_tpu_torch.models import vilt as tvilt
from vault_tpu_torch.ops import moe

ATOL, RTOL = 2e-5, 1e-5


def _tower(cfg, seed=0, bias_std=0.05):
    """Seeded tower parameters, the norm weights 1 + N(0, 0.1) and the
    router biases N(0, bias_std)."""
    gen = torch.Generator().manual_seed(seed)
    p = ds.init_deepseek(gen, cfg)
    with torch.no_grad():
        for name, v in p.named_parameters():
            if name.endswith("_ln"):
                v.add_(0.1 * torch.randn(v.shape, generator=gen))
            elif name.endswith("router_bias"):
                v.copy_(bias_std * torch.randn(v.shape, generator=gen))
    return p


def _flat(p):
    return {k: v.detach().float() for k, v in p.state_dict().items()}


def _ids(cfg, lengths=(7, 4, 1), seed=1):
    g = torch.Generator().manual_seed(seed)
    l = max(lengths)
    ids = torch.randint(1, cfg.vocab_size, (len(lengths), l), generator=g)
    mask = (torch.arange(l)[None] < torch.tensor(lengths)[:, None]).long()
    return ids * mask, mask


def _plain_experts(monkeypatch):
    """The routed experts on the plain composition, called directly, in
    place of the operator."""
    monkeypatch.setattr(moe, "grouped_experts", moe.moe_experts_plain)


@pytest.mark.parametrize("impl", ["pallas", "xla"])
def test_tower_matches_the_reference(impl, monkeypatch):
    """"pallas": the routed experts through the operator; "xla": the plain
    composition called directly."""
    if impl == "xla":
        _plain_experts(monkeypatch)
    cfg = ds.tiny_deepseek_config()
    p = _tower(cfg)
    ids, mask = _ids(cfg)
    with torch.no_grad():
        out = ds.deepseek_apply(p, cfg, ids, mask)
        want = ref.tower(_flat(p), dataclasses.asdict(cfg), ids, mask)
    assert out.shape == (3, 7, cfg.hidden_size)
    torch.testing.assert_close(out, want, atol=ATOL, rtol=RTOL)


def test_the_operator_route_and_the_plain_route_agree_bit_for_bit(monkeypatch):
    cfg = ds.tiny_deepseek_config()
    p = _tower(cfg)
    ids, mask = _ids(cfg)
    with torch.no_grad():
        a = ds.deepseek_apply(p, cfg, ids, mask)
        _plain_experts(monkeypatch)
        b = ds.deepseek_apply(p, cfg, ids, mask)
    assert torch.equal(a, b)


def test_a_forward_reports_the_experts_it_chose():
    """``routes`` gets each MoE layer's chosen experts, the reference's at
    every row (the reference's router is fp32 too), and nothing else moves."""
    cfg = ds.tiny_deepseek_config()
    p = _tower(cfg)
    ids, mask = _ids(cfg)
    chosen = []
    f, c, eps = _flat(p), dataclasses.asdict(cfg), cfg.rms_norm_eps
    keep = torch.tril(torch.ones(7, 7))[None, None] * mask.float()[:, None, None, :]
    bias, pos = (1.0 - keep) * torch.finfo(torch.float32).min, torch.arange(7).expand(3, 7)
    with torch.no_grad():
        out = ds.deepseek_apply(p, cfg, ids, mask, routes=chosen)
        assert torch.equal(out, ds.deepseek_apply(p, cfg, ids, mask))
        x = f["embed"][ids]
        x = x + ref.attention(f, "layers.0", c, ref.rms(x, f["layers.0.input_ln"], eps), bias, pos)
        x = x + ref.swiglu(f, "layers.0.mlp", ref.rms(x, f["layers.0.post_ln"], eps))
        x = x + ref.attention(f, "layers.1", c, ref.rms(x, f["layers.1.input_ln"], eps), bias, pos)
        want, _ = ref.router(f, "layers.1", c, ref.rms(x, f["layers.1.post_ln"], eps).view(21, -1))
    assert len(chosen) == 2 and chosen[0].shape == (ids.numel(), 2)
    assert torch.equal(chosen[0].sort(-1).values, want.sort(-1).values)


def _router_inputs(seed=2, t=64, h=32, e=8):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn((t, h), generator=g), torch.randn((h, e), generator=g) * 0.3,
            torch.randn((e,), generator=g) * 0.05)


def test_the_router_chooses_as_the_reference_and_the_bias_moves_choices_not_weights():
    h, w, bias = _router_inputs()
    cfg = {"num_experts_per_tok": 2, "norm_topk_prob": True, "routed_scaling_factor": 2.446}
    chosen, weights = moe.route(h, w, bias, 2, 2.446, True)
    want_c, want_w = ref.router({"x.router.w": w, "x.router_bias": bias}, "x", cfg, h)
    assert torch.equal(chosen, want_c)
    torch.testing.assert_close(weights, want_w, atol=1e-6, rtol=1e-6)
    # the bias changes some choices ...
    plain_c, _ = moe.route(h, w, torch.zeros_like(bias), 2, 2.446, True)
    assert (chosen != plain_c).any(dim=1).any()
    # ... but each chosen expert's weight is its unbiased score, normalised
    scores = torch.sigmoid(h @ w).gather(1, chosen)
    torch.testing.assert_close(weights, 2.446 * scores / scores.sum(-1, keepdim=True))
    # norm_topk_prob: the weights sum to the scaling factor; without it they
    # are the scaled scores
    torch.testing.assert_close(weights.sum(-1), torch.full((64,), 2.446))
    _, raw = moe.route(h, w, bias, 2, 2.446, False)
    torch.testing.assert_close(raw, 2.446 * scores)


def test_rope_rotates_adjacent_pairs():
    g = torch.Generator().manual_seed(3)
    x = torch.randn((2, 3, 5, 8), generator=g)
    pos = torch.tensor([[0, 1, 2, 3, 4], [7, 9, 11, 13, 40]])
    out = ds.rope_pairs(x, pos, 50000.0)
    want = torch.empty_like(x)
    for i in range(4):
        angle = pos.double()[:, None, :] * 50000.0 ** (-2.0 * i / 8)
        c, s = torch.cos(angle).float(), torch.sin(angle).float()
        a, b = x[..., 2 * i], x[..., 2 * i + 1]
        want[..., 2 * i], want[..., 2 * i + 1] = a * c - b * s, b * c + a * s
    torch.testing.assert_close(out, want, atol=1e-6, rtol=1e-6)
    # the published code's de-interleaved result is the same pairs, evens first
    evens_first = torch.cat([out[..., 0::2], out[..., 1::2]], dim=-1)
    torch.testing.assert_close(ref.rope(x, pos, 50000.0), evens_first, atol=1e-6, rtol=1e-6)


def test_mla_at_the_published_head_sizes():
    """Query/key heads of 128 + 64 = 192 against value heads of 128."""
    cfg = ds.tiny_deepseek_config(hidden_size=64, num_attention_heads=2, kv_lora_rank=32,
                                  qk_nope_head_dim=128, qk_rope_head_dim=64, v_head_dim=128,
                                  initializer_range=0.05)
    p = _tower(cfg)
    lp = p["layers"][1]
    g = torch.Generator().manual_seed(4)
    x = torch.randn((2, 6, 64), generator=g)
    ids, mask = _ids(cfg, lengths=(6, 3))
    keep = torch.tril(torch.ones(6, 6))[None, None] * mask.float()[:, None, None, :]
    bias = (1.0 - keep) * torch.finfo(torch.float32).min
    pos = torch.arange(6).expand(2, 6)
    assert lp["q"]["w"].shape == (64, 2 * 192) and lp["o"]["w"].shape == (2 * 128, 64)
    with torch.no_grad():
        out = ds.mla(lp, cfg, x, bias, pos)
        f = _flat(p)
        want = x + ref.attention(f, "layers.1", dataclasses.asdict(cfg),
                                 ref.rms(x, f["layers.1.input_ln"], cfg.rms_norm_eps), bias, pos)
    torch.testing.assert_close(out, want, atol=ATOL, rtol=RTOL)


def _experts(e=6, h=16, i=24, seed=5):
    g = torch.Generator().manual_seed(seed)
    return tuple(torch.randn(s, generator=g) * 0.2 for s in ((e, i, h), (e, i, h), (e, h, i)))


def _per_token(h, chosen, weights, wg, wu, wd):
    """Each row's k experts one at a time."""
    out = torch.zeros_like(h)
    for t in range(h.shape[0]):
        for j in range(chosen.shape[1]):
            e = int(chosen[t, j])
            a = torch.nn.functional.silu(h[t] @ wg[e].t()) * (h[t] @ wu[e].t())
            out[t] += weights[t, j] * (a @ wd[e].t())
    return out


def test_dispatch_is_a_stable_sort_by_expert():
    chosen = torch.tensor([[3, 0], [3, 5], [0, 3], [5, 1]])
    offsets, order, position = moe.dispatch(chosen, 6)
    assert offsets.tolist() == [0, 2, 3, 3, 6, 6, 8] and offsets.dtype == torch.int32
    assert torch.equal(order, chosen.reshape(-1).argsort(stable=True))
    assert torch.equal(order[position], torch.arange(8))


@pytest.mark.parametrize("routing", ["drawn", "an expert with no rows and one with every row"])
def test_routed_experts_match_a_per_token_loop(routing):
    g = torch.Generator().manual_seed(6)
    t, hdim, e, k = 40, 16, 6, 2
    wg, wu, wd = _experts(e, hdim)
    h = torch.randn((t, hdim), generator=g)
    w_router = torch.randn((hdim, e), generator=g) * 0.3
    bias = torch.randn((e,), generator=g) * 0.05
    if routing != "drawn":
        bias[2], bias[4] = 100.0, -100.0
    p = {"router": {"w": w_router}, "router_bias": bias,
         "experts": {"gate": wg, "up": wu, "down": wd}}
    chosen, weights = moe.route(h, w_router, bias, k, 2.446, True)
    offsets, _, _ = moe.dispatch(chosen, e)
    counts = (offsets[1:] - offsets[:-1]).tolist()
    if routing != "drawn":
        assert counts[2] == t and counts[4] == 0
    out = moe.routed_experts(h, p, k, 2.446, True)
    torch.testing.assert_close(out, _per_token(h, chosen, weights, wg, wu, wd),
                               atol=ATOL, rtol=RTOL)


def test_the_plain_grouped_product_takes_empty_and_full_runs():
    wg, wu, wd = _experts()
    g = torch.Generator().manual_seed(7)
    x = torch.randn((9, 16), generator=g)
    w = torch.rand((9,), generator=g)
    for bounds in ([0, 0, 4, 4, 9, 9, 9], [0, 0, 0, 9, 9, 9, 9]):
        offsets = torch.tensor(bounds, dtype=torch.int32)
        out = moe.moe_experts_plain(x, wg, wu, wd, offsets, w)
        expert = np.searchsorted(bounds, np.arange(9), side="right") - 1
        for r, e in enumerate(expert):
            a = torch.nn.functional.silu(x[r] @ wg[e].t()) * (x[r] @ wu[e].t())
            torch.testing.assert_close(out[r], w[r] * (a @ wd[e].t()), atol=ATOL, rtol=RTOL)


def test_unheld_branches_are_refused():
    for kw in ({"q_lora_rank": 16}, {"n_group": 2}, {"scoring_func": "softmax"}):
        with pytest.raises(ValueError, match="DeepseekConfig"):
            ds.tiny_deepseek_config(**kw).check()


def _batch(seed=8, b=3, seq=7, hw=(64, 96)):
    rng = np.random.default_rng(seed)
    am = np.ones((b, seq), np.int64)
    am[1, 4:] = 0
    pm = np.ones((b, *hw), np.int64)
    pm[2, :, 64:] = 0
    return {"input_ids": rng.integers(1, 99, (b, seq)) * am, "attention_mask": am,
            "token_type_ids": np.zeros((b, seq), np.int64),
            "pixel_values": rng.normal(size=(b, 3, *hw)).astype(np.float32),
            "pixel_mask": pm}


def test_vault_with_deepseek_tower_classifies_end_to_end():
    """The module's logits equal the reference tower's hidden states taken
    through lm_proj, ViLT (text positions off) and the head; meta builds
    nothing; the state dict names the tower's leaves."""
    vcfg, tcfg = tiny_vilt_config(), ds.tiny_deepseek_config()
    model = tvault.VaultWithDeepseekTower(vcfg, tcfg, n_classes=3, device="cpu", seed=3)
    with torch.no_grad():
        model.deepseek.load_state_dict(_tower(tcfg).state_dict())
    batch = _batch()
    chosen = []
    with torch.inference_mode():
        logits = model(batch)
        assert torch.equal(model(batch, routes=chosen), logits) and len(chosen) == 2
        t = {k: torch.as_tensor(v) for k, v in batch.items()}
        hidden = ref.tower(_flat(model.deepseek), dataclasses.asdict(tcfg), t["input_ids"],
                           t["attention_mask"])
        hidden = hidden @ model.lm_proj["w"] + model.lm_proj["b"]
        out = tvilt.vilt_apply(model.vilt, dataclasses.replace(
            vcfg, add_text_position_embeddings=False), attention_mask=t["attention_mask"],
            token_type_ids=t["token_type_ids"], pixel_values=t["pixel_values"],
            pixel_mask=t["pixel_mask"], inputs_embeds=hidden, use_pallas=False)
        want = out.pooler_output @ model.head["out"]["w"] + model.head["out"]["b"]
    assert logits.shape == (3, 3)
    torch.testing.assert_close(logits, want, atol=ATOL, rtol=RTOL)
    keys = model.state_dict()
    assert {"deepseek.layers.0.mlp.gate.w", "deepseek.layers.1.experts.gate",
            "deepseek.layers.2.router_bias", "lm_proj.w", "head.out.w"} <= set(keys)
    with torch.device("meta"):
        meta = tvault.VaultWithDeepseekTower(vcfg, tcfg, device="meta")
    assert meta.device.type == "meta" and set(meta.state_dict()) == set(keys)
