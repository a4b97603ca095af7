"""The weights of the ``vault_moe`` family, a DeepSeek-V3 text tower
(Moonlight-16B-A3B) feeding ViLT-B/32 through a width projection: every
parameter of ``VaultWithDeepseekTower``, named as the program names them
(:func:`param_shapes`), each drawn from a stream of its own
(``generate.generator(device, seed, "weights", index)``, index its place in
:func:`param_shapes`) in the run's type on the device.  So no fp32 copy of
the 31 GB of bf16 weights is ever made, and the reference remakes any
layer's leaves alone (:func:`draw`)."""

from __future__ import annotations

from typing import Dict, Iterator, Tuple

import torch

from portbench.generate import generator
from portbench.reference.vault_ref import param_shapes as vault_shapes

# the tiny tower: 1 dense + 2 MoE layers, 8 experts with 2 a token and 1
# shared, widths of 32, heads of 8 + 4 (query/key) and 8 (value); weights
# at 0.02 * sqrt(2048 / 32), so that each layer's outputs keep their
# published size
TINY_STD = 0.16
TINY_TOWER = dict(vocab_size=99, hidden_size=32, num_hidden_layers=3, num_attention_heads=4,
                  intermediate_size=64, moe_intermediate_size=32, n_routed_experts=8,
                  n_shared_experts=1, num_experts_per_tok=2, kv_lora_rank=16,
                  qk_nope_head_dim=8, qk_rope_head_dim=4, v_head_dim=8,
                  pad_token_id=98, initializer_range=TINY_STD)
TINY_VILT = dict(vocab_size=99, hidden_size=32, num_hidden_layers=2, num_attention_heads=4,
                 intermediate_size=64, image_size=64, patch_size=16, initializer_range=0.1)


def tower_layer_shapes(t: dict, n: int) -> Dict[str, Tuple[int, ...]]:
    """Layer ``n`` of the tower ``t`` (the published config's keys)."""
    h, heads = t["hidden_size"], t["num_attention_heads"]
    dn, dr, dv = t["qk_nope_head_dim"], t["qk_rope_head_dim"], t["v_head_dim"]
    r, p = t["kv_lora_rank"], f"deepseek.layers.{n}"
    out = {f"{p}.input_ln": (h,), f"{p}.q.w": (h, heads * (dn + dr)),
           f"{p}.kv_a.w": (h, r + dr), f"{p}.kv_ln": (r,), f"{p}.kv_b.w": (r, heads * (dn + dv)),
           f"{p}.o.w": (heads * dv, h), f"{p}.post_ln": (h,)}
    if n < t["first_k_dense_replace"]:
        i = t["intermediate_size"]
        out.update({f"{p}.mlp.gate.w": (h, i), f"{p}.mlp.up.w": (h, i),
                    f"{p}.mlp.down.w": (i, h)})
        return out
    e, i = t["n_routed_experts"], t["moe_intermediate_size"]
    s = t["n_shared_experts"] * i
    out.update({f"{p}.router.w": (h, e), f"{p}.router_bias": (e,),
                f"{p}.experts.gate": (e, i, h), f"{p}.experts.up": (e, i, h),
                f"{p}.experts.down": (e, h, i),
                f"{p}.shared.gate.w": (h, s), f"{p}.shared.up.w": (h, s),
                f"{p}.shared.down.w": (s, h)})
    return out


def param_shapes(cfg: dict) -> Dict[str, Tuple[int, ...]]:
    """Every parameter, name -> shape, in a fixed order: the tower (its
    embedding, each layer, its final norm), ``lm_proj``, ViLT and the head
    (named and shaped as ``portbench/reference/vault_ref.py`` names them;
    projections (in, out), the experts (E, out, in))."""
    t = cfg["text_tower"]
    out = {"deepseek.embed": (t["vocab_size"], t["hidden_size"])}
    for n in range(t["num_hidden_layers"]):
        out.update(tower_layer_shapes(t, n))
    out["deepseek.final_ln"] = (t["hidden_size"],)
    out["lm_proj.w"] = (t["hidden_size"], cfg["vilt"]["hidden_size"])
    out["lm_proj.b"] = (cfg["vilt"]["hidden_size"],)
    # ViLT's and the head's leaves: those of the BERT family's classifier,
    # whose text tower is left out here (a stand-in of no layers)
    stand_in = dict(hidden_size=1, intermediate_size=1, vocab_size=1, type_vocab_size=1,
                    max_position_embeddings=1, num_hidden_layers=0)
    vilt = vault_shapes({**cfg, "text_tower": stand_in})
    out.update((k, s) for k, s in vilt.items() if not k.startswith("bert."))
    return out


def leaf_std(cfg: dict, name: str) -> float:
    """The draw's scale: the tower's and ``lm_proj``'s leaves (the router
    biases too, which then move some top-6 choices) the tower's initializer
    range, ViLT's and the head's ViLT's."""
    tower = name.startswith(("deepseek.", "lm_proj."))
    return cfg["text_tower" if tower else "vilt"]["initializer_range"]


def draw(cfg: dict, seed: int, dtype, device, names=None) -> Iterator[Tuple[str, torch.Tensor]]:
    """(name, leaf) of every parameter, or of those in ``names``: standard
    normal values drawn in ``dtype`` from the leaf's own stream, times its
    scale (:func:`leaf_std`); a norm weight (a name ending in ``_ln`` or
    ``.scale``) is 1 plus that.  The same leaf whatever else is drawn."""
    for index, (name, shape) in enumerate(param_shapes(cfg).items()):
        if names is not None and name not in names:
            continue
        leaf = torch.randn(shape, generator=generator(device, seed, "weights", index),
                           device=device, dtype=dtype).mul_(leaf_std(cfg, name))
        if name.endswith(("_ln", ".scale")):
            leaf.add_(1.0)
        yield name, leaf


def make_weights(cfg: dict, seed: int, dtype, device) -> Dict[str, torch.Tensor]:
    """Every parameter of the configuration, leaf by leaf, in ``dtype``."""
    return dict(draw(cfg, seed, dtype, device))


def tiny(cfg: dict) -> dict:
    """``cfg`` cut to the CPU tests' size: every mechanism, widths of 32
    (:data:`TINY_TOWER`), ViLT at 2 layers, 12 patch tokens on 64 x 64
    images, in fp32.  At 8 experts of width 32 a bf16 rounding moves a
    token's top-2 choice in about one batch of eight, by 0.07 to 0.16 of a
    logit, which the limit set at the published widths does not admit; in
    fp32 the program meets the reference to 1e-6, so the CPU tests hold the
    harness and the family's code, and the card the bf16 cell."""
    return {**cfg, "dtype": "float32", "text_tower": {**cfg["text_tower"], **TINY_TOWER},
            "vilt": {**cfg["vilt"], **TINY_VILT},
            "assumed": {**cfg["assumed"], "num_patch_tokens": 12}}
