"""Plain PyTorch reference of the VAuLT classifier (arXiv 2208.09021): a
BERT or BERTweet (RoBERTa) tower whose last hidden states feed ViLT-B/32 as
its text embeddings, ViLT's tanh pooler, and a dropout + linear head.

Written from the published architecture (HF ``BertModel`` /
``RobertaModel`` and ``ViltModel``), in fp32 with TF32 off, and
independent of the program: it imports nothing of it.  Two departures
from HF, both the VAuLT port's documented semantics and stated in
``PERF.md``: ViLT's text position embeddings are off behind a text tower
(the paper's setting), and the patch tokens are the valid patches in
raster order, first ``num_patch_tokens`` of them, where HF samples them.

``params`` is a flat dict of fp32 tensors named as :func:`param_shapes`
names them.  ``prec`` ("int8", "int4" or "fp8") runs every encoder linear
(Q, K, V, the attention output and the two MLP products of both towers)
on codes of that precision: the activations with one absmax scale per
row, the weights one per output column; integer codes are symmetric and
rounded half to even, fp8 codes are e4m3 with the absmax at 448; the
products of the codes are exact (float64), then ``acc * (x_scale *
w_scale) + b``.  "int8" is the w8a8 deployment; "int4" and "fp8" are the
controls one precision below int8 and bf16.  ``ste`` trains through those
products (:class:`_QuantProduct`), for a training control: its backward
runs on codes too, the gradients' in e5m2 under "fp8", as fp8 training
does.

``dropout`` is a :class:`Draws` or None (deterministic).  The draws are
the program's: U[0, 1) of each dropped tensor's shape from one generator,
in the order the forward meets them (the tower's embeddings, then per
layer the attention probabilities, the attention output and the MLP
output; ViLT's rates are 0 and draw nothing; then the head).
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

QUANT_SITES = ("q", "k", "v", "attn_out", "mlp_in", "mlp_out")


def param_shapes(cfg) -> Dict[str, Tuple[int, ...]]:
    """Every parameter of the classifier, name -> shape, in a fixed order.
    Linear weights are (in, out); the patch projection is a conv's OIHW."""
    t, v = cfg["text_tower"], cfg["vilt"]
    out: Dict[str, Tuple[int, ...]] = {}

    def linear(name, i, o, bias=True):
        out[f"{name}.w"] = (i, o)
        if bias:
            out[f"{name}.b"] = (o,)

    def ln(name, h):
        out[f"{name}.scale"] = (h,)
        out[f"{name}.bias"] = (h,)

    h, i = t["hidden_size"], t["intermediate_size"]
    out["bert.embeddings.word"] = (t["vocab_size"], h)
    out["bert.embeddings.position"] = (t["max_position_embeddings"], h)
    out["bert.embeddings.token_type"] = (t["type_vocab_size"], h)
    ln("bert.embeddings.ln", h)
    for n in range(t["num_hidden_layers"]):
        p = f"bert.layers.{n}"
        for s in ("q", "k", "v", "attn_out"):
            linear(f"{p}.{s}", h, h)
        ln(f"{p}.attn_ln", h)
        linear(f"{p}.mlp_in", h, i)
        linear(f"{p}.mlp_out", i, h)
        ln(f"{p}.mlp_ln", h)

    h, i = v["hidden_size"], v["intermediate_size"]
    grid = v["image_size"] // v["patch_size"]
    out["vilt.cls_token"] = (h,)
    out["vilt.pos_embeddings"] = (grid * grid + 1, h)
    out["vilt.modality_type"] = (v["modality_type_vocab_size"], h)
    out["vilt.text_embeddings.word"] = (v["vocab_size"], h)
    out["vilt.text_embeddings.position"] = (v["max_position_embeddings"], h)
    out["vilt.text_embeddings.token_type"] = (v["type_vocab_size"], h)
    ln("vilt.text_embeddings.ln", h)
    out["vilt.patch_proj.w"] = (h, v["num_channels"], v["patch_size"], v["patch_size"])
    out["vilt.patch_proj.b"] = (h,)
    for n in range(v["num_hidden_layers"]):
        p = f"vilt.layers.{n}"
        ln(f"{p}.ln_before", h)
        for s in ("q", "k", "v"):
            linear(f"{p}.{s}", h, h, v["qkv_bias"])
        linear(f"{p}.attn_out", h, h)
        ln(f"{p}.ln_after", h)
        linear(f"{p}.mlp_in", h, i)
        linear(f"{p}.mlp_out", i, h)
    ln("vilt.final_ln", h)
    linear("vilt.pooler", h, h)
    linear("head.out", h, cfg["head"]["n_classes"])
    return out


class Draws:
    """The dropout draws of one forward, from ``generator`` in call order."""

    def __init__(self, generator: torch.Generator):
        self.generator = generator

    def __call__(self, x: torch.Tensor, rate: float) -> torch.Tensor:
        if rate == 0.0:
            return x
        keep = 1.0 - rate
        u = torch.rand(x.shape, generator=self.generator, device=x.device)
        return torch.where(u < keep, x / keep, torch.zeros_like(x))


_TOP = {"int8": 127.0, "int4": 7.0, "fp8": 448.0, "fp8e5": 57344.0}
_FP8 = {"fp8": torch.float8_e4m3fn, "fp8e5": torch.float8_e5m2}
# the gradients' format in a training control: fp8 trains its backward in e5m2
_GRAD = {"int8": "int8", "int4": "int4", "fp8": "fp8e5"}


def _codes(x: torch.Tensor, dim: int, prec: str):
    """Codes of ``x`` in ``prec`` with one scale along ``dim``, as fp32."""
    x = x.detach()
    top = _TOP[prec]
    absmax = torch.clamp_min(x.abs().amax(dim=dim, keepdim=True), 1e-8)
    scale = absmax / torch.full_like(absmax, top)
    if prec in _FP8:
        return (x / scale).to(_FP8[prec]).float(), scale
    return torch.clamp(torch.round(x / scale), -top, top), scale


def _dequantized(x: torch.Tensor, dim: int, prec: str) -> torch.Tensor:
    q, scale = _codes(x, dim, prec)
    return q * scale


class _QuantProduct(torch.autograd.Function):
    """``x @ w`` trained in ``prec``: the forward on the codes of x and w,
    the backward's two products on them and on the codes of the incoming
    gradient (one scale per row), straight through the rounding."""

    @staticmethod
    def forward(ctx, x, w, prec):
        xd, wd = _dequantized(x, -1, prec), _dequantized(w, -2, prec)
        ctx.save_for_backward(xd, wd)
        ctx.prec = prec
        return xd @ wd

    @staticmethod
    def backward(ctx, g):
        xd, wd = ctx.saved_tensors
        gd = _dequantized(g, -1, _GRAD[ctx.prec])
        dw = xd.reshape(-1, xd.shape[-1]).t() @ gd.reshape(-1, gd.shape[-1])
        return gd @ wd.t(), dw, None


def _linear(p, name, x, prec=None, ste=False):
    w, b = p[f"{name}.w"], p.get(f"{name}.b")
    site = name.rsplit(".", 1)[-1]
    if prec is None or site not in QUANT_SITES:
        y = x @ w
    elif ste:
        y = _QuantProduct.apply(x, w, prec)
    else:
        xq, xs = _codes(x, -1, prec)
        wq, ws = _codes(w, -2, prec)
        y = (xq.double() @ wq.double()).float() * (xs * ws)
    return y if b is None else y + b


def _ln(p, name, x, eps):
    return F.layer_norm(x, (x.shape[-1],), p[f"{name}.scale"], p[f"{name}.bias"], eps)


def _attention(p, name, x, bias, heads, prec, ste, drop, rate):
    b, l, h = x.shape
    d = h // heads

    def split(t):
        return t.reshape(b, l, heads, d).transpose(1, 2)

    q = split(_linear(p, f"{name}.q", x, prec, ste))
    k = split(_linear(p, f"{name}.k", x, prec, ste))
    v = split(_linear(p, f"{name}.v", x, prec, ste))
    scores = q @ k.transpose(-1, -2) / math.sqrt(d) + bias
    probs = torch.softmax(scores, dim=-1)
    if drop is not None:
        probs = drop(probs, rate)
    ctx = (probs @ v).transpose(1, 2).reshape(b, l, h)
    return _linear(p, f"{name}.attn_out", ctx, prec, ste)


def _key_bias(mask: torch.Tensor) -> torch.Tensor:
    return ((1.0 - mask.float()) * torch.finfo(torch.float32).min)[:, None, None, :]


def text_tower(p, cfg, ids, mask, types, prec=None, ste=False, drop=None):
    """The BERT / RoBERTa tower's last hidden states (post-LN layers)."""
    t = cfg["text_tower"]
    eps, rate = t["layer_norm_eps"], t["hidden_dropout_prob"]
    pad = t["pad_token_id"]
    if t["model_type"] == "roberta":
        m = mask.long()
        pos = torch.cumsum(m, dim=1) * m + pad
    else:
        pos = torch.arange(ids.shape[1], device=ids.device).expand_as(ids)
    if t["type_vocab_size"] < 2:
        # a tower with one segment type reads row 0 for every token
        types = torch.zeros_like(ids)
    x = (p["bert.embeddings.word"][ids] + p["bert.embeddings.position"][pos]
         + p["bert.embeddings.token_type"][types])
    x = _ln(p, "bert.embeddings.ln", x, eps)
    if drop is not None:
        x = drop(x, rate)
    bias = _key_bias(mask)
    for n in range(t["num_hidden_layers"]):
        name = f"bert.layers.{n}"
        a = _attention(p, name, x, bias, t["num_attention_heads"], prec, ste, drop,
                       t["attention_probs_dropout_prob"])
        if drop is not None:
            a = drop(a, rate)
        x = _ln(p, f"{name}.attn_ln", x + a, eps)
        y = _linear(p, f"{name}.mlp_out",
                    F.gelu(_linear(p, f"{name}.mlp_in", x, prec, ste)), prec, ste)
        if drop is not None:
            y = drop(y, rate)
        x = _ln(p, f"{name}.mlp_ln", x + y, eps)
    return x


def patch_tokens(p, cfg, pixels, pixel_mask):
    """ViLT's visual embeddings: the 32 x 32 patch projection, the 12 x 12
    position grid resized per image (bilinear, corners aligned) to its
    valid patches, the valid patches first in raster order up to the
    token budget, and the CLS token.  Returns (tokens, mask)."""
    v = cfg["vilt"]
    ps, g = v["patch_size"], v["image_size"] // v["patch_size"]
    x = F.conv2d(pixels, p["vilt.patch_proj.w"], p["vilt.patch_proj.b"], stride=ps)
    b, h, gh, gw = x.shape
    pm = F.interpolate(pixel_mask[:, None].float(), size=(gh, gw), mode="nearest")[:, 0]
    rows = pm[:, :, 0].sum(1).long()
    cols = pm[:, 0, :].sum(1).long()
    grid = p["vilt.pos_embeddings"][1:].reshape(g, g, h).permute(2, 0, 1)[None]
    pos = x.new_zeros((b, h, gh, gw))
    for r, c in {(int(r), int(c)) for r, c in zip(rows.tolist(), cols.tolist())}:
        sel = (rows == r) & (cols == c)
        resized = F.interpolate(grid, size=(r, c), mode="bilinear", align_corners=True)
        pos[sel, :, :r, :c] = resized[0]
    x = x.flatten(2).transpose(1, 2)
    pos = pos.flatten(2).transpose(1, 2)
    flat = pm.reshape(b, gh * gw)
    n = min(cfg["assumed"]["num_patch_tokens"], gh * gw)
    order = torch.argsort(1.0 - flat, dim=1, stable=True)[:, :n]
    idx = order[..., None].expand(b, n, h)
    x = torch.gather(x, 1, idx) + torch.gather(pos, 1, idx)
    sel_mask = torch.gather(flat, 1, order)
    cls = (p["vilt.cls_token"] + p["vilt.pos_embeddings"][0]).expand(b, 1, h)
    return (torch.cat([cls, x], dim=1),
            torch.cat([sel_mask.new_ones((b, 1)), sel_mask], dim=1))


def classifier_logits(p, cfg, batch, prec: Optional[str] = None, ste: bool = False,
                      drop: Optional[Draws] = None) -> torch.Tensor:
    """Logits of the VAuLT classifier for ``batch`` (input_ids,
    attention_mask, token_type_ids, pixel_values, pixel_mask)."""
    v = cfg["vilt"]
    eps = v["layer_norm_eps"]
    mask = batch["attention_mask"]
    hidden = text_tower(p, cfg, batch["input_ids"], mask, batch["token_type_ids"],
                        prec, ste, drop)
    text = hidden + p["vilt.text_embeddings.token_type"][batch["token_type_ids"]]
    text = _ln(p, "vilt.text_embeddings.ln", text, eps)
    if drop is not None:
        text = drop(text, v["hidden_dropout_prob"])
    img, img_mask = patch_tokens(p, cfg, batch["pixel_values"].float(), batch["pixel_mask"])
    if drop is not None:
        img = drop(img, v["hidden_dropout_prob"])
    x = torch.cat([text + p["vilt.modality_type"][0], img + p["vilt.modality_type"][1]], 1)
    bias = _key_bias(torch.cat([mask.float(), img_mask], dim=1))
    rate = v["hidden_dropout_prob"]
    for n in range(v["num_hidden_layers"]):
        name = f"vilt.layers.{n}"
        a = _attention(p, name, _ln(p, f"{name}.ln_before", x, eps), bias,
                       v["num_attention_heads"], prec, ste, drop,
                       v["attention_probs_dropout_prob"])
        if drop is not None:
            a = drop(a, rate)
        x = x + a
        y = _linear(p, f"{name}.mlp_out", F.gelu(
            _linear(p, f"{name}.mlp_in", _ln(p, f"{name}.ln_after", x, eps), prec, ste)),
            prec, ste)
        if drop is not None:
            y = drop(y, rate)
        x = x + y
    x = _ln(p, "vilt.final_ln", x, eps)
    pooled = torch.tanh(_linear(p, "vilt.pooler", x[:, 0]))
    if drop is not None:
        pooled = drop(pooled, cfg["head"]["dropout"])
    return _linear(p, "head.out", pooled)
