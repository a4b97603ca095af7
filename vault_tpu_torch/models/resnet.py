"""ResNet region-feature extractor (port of ``vault_tpu/models/resnet.py``).

The reference wraps torchvision ResNets minus avgpool/fc and flattens the
7x7 output grid into 49 region tokens of dim 512 (r18/34) or 2048
(r50/101/152) (vault/modules.py:210-308).  The torchvision v1 architecture
(7x7/2 stem, 3x3/2 max pool, four stages of Basic or Bottleneck blocks) is
written out here, with a converter from torchvision's state-dict keys.
The convolutions are ``F.conv2d``: the JAX package computes them with
``lax.conv_general_dilated``, outside any Pallas kernel.

BatchNorm runs in inference mode (running statistics), folded as the JAX
package folds it; the reference freezes the ResNet and caches its
embeddings after epoch 0 (vault/models/tombert/trainer.py:63-77).  Region
embeddings given in place of images (``x.ndim != 4``) pass through.

Parameters: ``stem.conv``, ``stem.bn.{scale,bias,mean,var}``, then one
list per stage, ``layer<s>.<b>.{conv1,bn1,...,down_conv,down_bn}``: the
JAX package's tree, whose stages are Python lists of block dicts.
"""

from __future__ import annotations

import math
from typing import Dict, Mapping

import torch
import torch.nn.functional as F
from torch import nn

from vault_tpu_torch.models.convert import StateDict, _f32
from vault_tpu_torch.ops.nn import ParamDict

RESNET_LAYERS = {
    18: ("basic", [2, 2, 2, 2]),
    34: ("basic", [3, 4, 6, 3]),
    50: ("bottleneck", [3, 4, 6, 3]),
    101: ("bottleneck", [3, 4, 23, 3]),
    152: ("bottleneck", [3, 8, 36, 3]),
}
RESNET_OUT_DIM = {18: 512, 34: 512, 50: 2048, 101: 2048, 152: 2048}


def _conv(x, w, stride=1, padding=0):
    return F.conv2d(x, w, stride=stride, padding=padding)


def _bn(p, x, eps=1e-5):
    inv = torch.rsqrt(p["var"] + eps)
    scale = (p["scale"] * inv)[None, :, None, None]
    shift = (p["bias"] - p["mean"] * p["scale"] * inv)[None, :, None, None]
    return x * scale + shift


def _init_conv(gen, out_c, in_c, k):
    fan = in_c * k * k
    return torch.randn((out_c, in_c, k, k), generator=gen) * math.sqrt(2.0 / fan)


def _init_bn(c) -> ParamDict:
    return ParamDict(scale=torch.ones(c), bias=torch.zeros(c),
                     mean=torch.zeros(c), var=torch.ones(c))


def init_resnet(gen: torch.Generator, depth: int = 152) -> ParamDict:
    """Seeded random ResNet parameters on the host, fp32 (He-normal
    convolutions, identity BatchNorms)."""
    kind, blocks = RESNET_LAYERS[depth]
    params: Dict = {"stem": ParamDict(conv=_init_conv(gen, 64, 3, 7),
                                      bn=_init_bn(64))}
    in_c = 64
    expansion = 1 if kind == "basic" else 4
    for s, (w, n) in enumerate(zip([64, 128, 256, 512], blocks)):
        stage = []
        for b in range(n):
            stride = 2 if (s > 0 and b == 0) else 1
            out_c = w * expansion
            if kind == "basic":
                blk = dict(conv1=_init_conv(gen, w, in_c, 3), bn1=_init_bn(w),
                           conv2=_init_conv(gen, w, w, 3), bn2=_init_bn(w))
            else:
                blk = dict(conv1=_init_conv(gen, w, in_c, 1), bn1=_init_bn(w),
                           conv2=_init_conv(gen, w, w, 3), bn2=_init_bn(w),
                           conv3=_init_conv(gen, out_c, w, 1), bn3=_init_bn(out_c))
            if stride != 1 or in_c != out_c:
                blk.update(down_conv=_init_conv(gen, out_c, in_c, 1),
                           down_bn=_init_bn(out_c))
            stage.append(ParamDict(**blk))
            in_c = out_c
        params[f"layer{s + 1}"] = nn.ModuleList(stage)
    return ParamDict(**params)


def _basic_block(p, x, stride):
    out = torch.relu(_bn(p["bn1"], _conv(x, p["conv1"], stride, 1)))
    out = _bn(p["bn2"], _conv(out, p["conv2"], 1, 1))
    sc = x
    if "down_conv" in p:
        sc = _bn(p["down_bn"], _conv(x, p["down_conv"], stride, 0))
    return torch.relu(out + sc)


def _bottleneck_block(p, x, stride):
    out = torch.relu(_bn(p["bn1"], _conv(x, p["conv1"], 1, 0)))
    out = torch.relu(_bn(p["bn2"], _conv(out, p["conv2"], stride, 1)))
    out = _bn(p["bn3"], _conv(out, p["conv3"], 1, 0))
    sc = x
    if "down_conv" in p:
        sc = _bn(p["down_bn"], _conv(x, p["down_conv"], stride, 0))
    return torch.relu(out + sc)


def resnet_features(params, depth: int, x: torch.Tensor) -> torch.Tensor:
    """Images (B, 3, H, W) -> region tokens (B, (H/32)*(W/32), C), in the
    parameters' dtype.  A 224x224 input gives the reference's 49 regions."""
    kind, _ = RESNET_LAYERS[depth]
    block_fn = _basic_block if kind == "basic" else _bottleneck_block

    x = x.to(params["stem"]["conv"].dtype)
    x = _conv(x, params["stem"]["conv"], 2, 3)
    x = torch.relu(_bn(params["stem"]["bn"], x))
    # torch MaxPool2d(kernel=3, stride=2, padding=1): the padding is -inf
    x = F.max_pool2d(x, 3, 2, padding=1)
    for s in range(4):
        for b, blk in enumerate(params[f"layer{s + 1}"]):
            x = block_fn(blk, x, 2 if (s > 0 and b == 0) else 1)
    b_, c, h, w = x.shape
    return x.reshape(b_, c, h * w).transpose(1, 2)


def resnet_embed(params, depth: int, x: torch.Tensor,
                 train: bool = False) -> torch.Tensor:
    """ResNetEmbeddings.forward: precomputed embeddings (``x.ndim != 4``)
    pass through; a frozen ResNet's features are cut from the graph
    (vault/modules.py:282-301)."""
    if x.ndim != 4:
        return x
    if train:
        return resnet_features(params, depth, x)
    with torch.no_grad():
        return resnet_features(params, depth, x)


# ---------------------------------------------------------------------------
# torchvision state_dict converter
# ---------------------------------------------------------------------------

def resnet_params_from_torch(state_dict: Mapping, depth: int) -> StateDict:
    """The ResNet's state dict (this module's keys, fp32) from a
    torchvision ``resnet<depth>`` state dict (``fc.*`` is not read)."""
    kind, blocks = RESNET_LAYERS[depth]
    sd = state_dict
    out: StateDict = {}

    def bn(key, name):
        for leaf, src in (("scale", "weight"), ("bias", "bias"),
                          ("mean", "running_mean"), ("var", "running_var")):
            out[f"{key}.{leaf}"] = _f32(sd[f"{name}.{src}"])

    out["stem.conv"] = _f32(sd["conv1.weight"])
    bn("stem.bn", "bn1")
    n_convs = 2 if kind == "basic" else 3
    for s, n in enumerate(blocks):
        for b in range(n):
            pre = f"layer{s + 1}.{b}"
            for ci in range(1, n_convs + 1):
                out[f"{pre}.conv{ci}"] = _f32(sd[f"{pre}.conv{ci}.weight"])
                bn(f"{pre}.bn{ci}", f"{pre}.bn{ci}")
            if f"{pre}.downsample.0.weight" in sd:
                out[f"{pre}.down_conv"] = _f32(sd[f"{pre}.downsample.0.weight"])
                bn(f"{pre}.down_bn", f"{pre}.downsample.1")
    return out
