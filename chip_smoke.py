"""Chip smoke test of the PyTorch port on one NVIDIA H100.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``vault_tpu_torch/csrc``, holds each
(forward and backward) against its plain PyTorch version at the main path's
shapes, times it beside its bound and a PyTorch library call (the routed
experts' grouped kernel at Moonlight-16B-A3B's widths, with its launches
from a forward of that tower), drives the
VAuLT-base classifier (bert-base-uncased tower + ViLT-B/32, seeded random
weights) through ``VaultForClassification`` and a ``BatchingEngine`` (bf16;
then bf16 on the fused LN->QKV selector; then quantized w8a8, int8 weights
and activations, forward and engine; then quantized w8, int8 weights only,
forward and engine), serves the Llama-3-8B-geometry tower feeding ViLT-B/32
through ``VaultWithLlamaTower`` (all 32 layers, w8a8 tower, the GQA
attention and SwiGLU kernels), then the tower at the published Llama-2-7B,
TinyLlama-1.1B, SmolLM-135M and OpenLLaMA-3B geometries (all layers, w8a8;
TinyLlama's w8 too; the kernels alone at each geometry's widths), then
trains VAuLT-base: one step on the
kernel path against one on the plain path
(fp32 masters, bf16 compute, remat, dropout 0.1, batch 32 at the ``entry()``
layout) and a short ``Trainer.train()`` with a dev evaluation and a
checkpoint; then serves and trains it with token merging (ToMe, the patch
tokens merged to 87: bf16 and the w8a8 levered configuration at layer 0,
batch 8 and 64, its engine, the fp32 model merged at layer 4, one merged
training step); then serves it from checkpoint files (HF-layout
directories written and loaded, ``python -m vault_tpu_torch.cli.
quantize_ckpt`` on the card and on the host with equal results, five
``cli.serve`` servers answering HTTP bit-equal to a direct forward, the
served forward exported with ``torch.export``, saved, loaded and run); then
trains the paper's tasks and the remaining heads at full width (the
experiment CLI ``cli.clsf_vault`` in process on MVSA and Twitter201X; the
MLM, VQA, retrieval and NLVR2 heads through their trainers, each on
synthetic files written under ``build/``); then trains and evaluates the
paper's baselines, TomBERT and TomViLT with a frozen ResNet-101, through
``python -m vault_tpu_torch.cli.tmsc_tombert`` in process (the attention
kernel at their lengths, the ResNet on the card against the host, each
model's forward and step against its plain path); then the training
core's last options and the native host cores (a step under remat False,
True and "dots" on both paths, the int8 AdamW moments on the card against
the host, a ``Trainer.train()`` with int8 moments, "dots", ``profile_dir``,
a resume and a NaN check, ``cli.clsf_vault`` with images held and decoded
at batch time, the C++ resize and WordPiece cores against PIL and
Python); then the parallel layer (ranks as worker processes sharing the
card over gloo, and a one-rank NCCL group: data parallelism held to one
process, ZeRO-1 and the resumed ``torch.distributed.checkpoint`` run held
bit for bit, tensor parallelism, the 2-stage pipeline on two streams,
data- and tensor-parallel serving over ``[cuda:0, cuda:0]``); then the
bench CLIs in process (``cli.bench`` with its training leg,
``cli.ablate_train``, ``cli.perf_sweep`` at batch 16 on the plain path and
the kernels: their guards, MFUs and busy times, the chained forward's busy
time against the vault group's).  The serve
and tasks groups run both towers at 6 of their 12 layers (full width).
It checks the launch counts, the gradients and the outputs.
Each phase prints one JSON line; any failure exits non-zero.  Device
times come from CUPTI traces, each held against the CUDA-event time of the
same calls (``device_ms``).  The last line
is ``{"ok": true, "device": {...}}``.  Needs a CUDA card: without one it
exits non-zero and prints no result.  Imports nothing of JAX or of the JAX
package.

``--phases a,b`` runs only the named groups of phases (``kernels``,
``attn_bwd``, ``moe``, ``vault``, ``w8``, ``llama``, ``train``, ``merge``, ``serve``, ``tasks``,
``baselines``, ``options``, ``parallel``, ``bench``) while
working on one of them; such
a run ends with ``{"partial": [...]}``, not with the ``ok`` line.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import contextlib
import dataclasses
import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

# The card's clocks and rates, shared with the bench CLIs (cli/bench.py):
# CUDA-event wall time, CUPTI busy time held against it (TRACE_LOG counts
# the checks), bounds, host profiles.  Outside the repository (or without
# PyTorch) the import fails and main() says so.
try:
    from vault_tpu_torch.utils.profiling import (
        LAUNCH_GAP_MS,
        PEAK_BF16_FLOPS,
        PEAK_INT8_OPS,
        TRACE_LOG,
        TRACE_LONG_SHARE,
        TRACE_SHORT_SHARE,
        bound_ms,
        device_ms,
        host_profile,
        time_ms,
    )
except ImportError as e:
    _IMPORT_ERROR = e
else:
    _IMPORT_ERROR = None
OUT_DIR = Path("chiprun_out") / "chip_smoke"

# Limits of |kernel - plain| on the same inputs.  bf16: both round the
# activations and the output to bf16 at different points (the kernel keeps
# the GELU input in fp32, the plain composition rounds the first product to
# bf16 first), so they differ by a few bf16 ulps of the output (2^-7
# relative); fp32: only the summation order differs.
LIMITS = {"bfloat16": 6.25e-2, "float32": 1e-4}
# bf16 attention is held, besides LIMITS, per query row: max |kernel -
# plain| over the row's max |plain| (``attention_row_err``).  Its outputs
# are means of V rows, about sqrt(e / L) for N(0, 1) scores, so at long L
# LIMITS is as large as a typical output and would pass a P V product in a
# lower precision.  The kernel and the plain version round the
# probabilities at other points (after or before the division by the row
# sum), a bf16 ulp of each, and the output once more: a few ulps of the
# row's largest output, 2^-8 each.  Every bf16 row also reads the same
# attention with its unnormalised probabilities cast to fp8 (e4m3) before
# P V (``attention_p_cast``, the control) and fails if that would pass.
ATTENTION_ROW_LIMIT = 2.0 ** -5
# The int8 kernels round at the cast points of their plain versions, which
# take the LN statistics in double as the kernels do and compute every
# fp32 step in the same order: K2-K4 (the w8a8 LN->QKV and MLP kernels)
# must equal them bit for bit.  K1, the fp LN->QKV kernel, is held to its
# plain version, the XLA composition: in bf16 they differ in the LN
# statistics' rounding and the product's summation order, by at most 2^-7
# of the output's scale (max(1, max|plain|)), one or two bf16 ulps there.
LNQKV_BF16_LIMIT = 2.0 ** -7
# |kernel path - plain path| of the full-width bf16 forward: 24 layers of
# the per-kernel differences above, through the final LN and the tanh pooler.
FORWARD_LIMITS = {"pooler": 6e-2, "logits": 2e-2}
# The w8a8 model's kernel path is held bit-equal to the same path with the
# int8 kernels' plain versions in their place (``int8_plain_versions``).
# Its distance from the XLA composition (``use_pallas=False``) is reported,
# not gated: a w8a8 forward is discontinuous, each linear rounding its input
# to int8 codes, and the XLA composition rounds at other points (GELU on the
# bf16 product, the post-LN sum in bf16, LN statistics in another order), as
# the JAX package's does against its Pallas kernels, so codes flip now and
# then and the flips grow through 24 layers.  The "fuselnqkv" path, which
# differs from the XLA composition only in ViLT's LN statistics, shows that
# sensitivity in every run (``sensitivity_fuselnqkv_only``).
# Backward kernels vs their plain versions, per output: bf16 2^-5 of the
# output's scale (max(1, max|plain|)), about four bf16 ulps there: the
# outputs are bf16 sums of products of bf16-rounded activations, which the
# kernel and the plain version accumulate in other orders; fp32 1e-4 of the
# scale (summation order).  dgamma and dbeta are fp32 sums over the rows
# before their cast: relative 1e-3 in bf16.
BWD_LIMITS = {"bfloat16": 2.0 ** -5, "float32": 1e-4}
BWD_LN_LIMIT = 1e-3
# The wgmma GEMM core alone against the plain fp32 product (``cuda_gemm``):
# both sum the same exact bf16 products in fp32, in other orders, so they
# differ by fp32 rounding, far below one bf16 ulp (2^-8) of the output:
# 1e-4 of max(1, max|plain|).
GEMM_CORE_LIMIT = 1e-4
# Device kernels that show which design ran a block (``cuda_mlp.mlp_route``,
# ``cuda_ln_qkv.ln_qkv_route``, ``cuda_attention.attention_route``,
# ``cuda_swiglu.swiglu_route``): on the wgmma core the GEMM core's products
# and the block's row passes, on the fp32 tiles gemm_tiles and the same row
# passes (with int8 weights behind dequant_f32); bf16 attention the
# one-pass wgmma kernel; the SwiGLU block, the w8a8 MLP blocks and the w8a8
# LN->QKV the int8 core's products between their row passes (the row codes,
# the requantization of the activation; post-LN also the slices' row pass).
ROUTE_KERNELS = {
    ("encoder_attention", "wgmma"): ("attention_wgmma",),
    ("attention_gqa", "wgmma"): ("attention_wgmma",),
    ("attention_bwd", "wgmma"): ("attention_bwd_dq", "attention_bwd_dkv"),
    ("mlp_block", "wgmma"): ("gemm_kernel", "ln_rows_bf16"),
    ("mlp_block_q8", "wgmma"): ("dequant_kernel", "gemm_kernel", "ln_rows_bf16"),
    ("mlp_postln_q8", "wgmma"): ("dequant_kernel", "gemm_kernel", "mlp_epilogue"),
    ("swiglu_w8a8", "wgmma"): ("rms_quant_rows", "gemm_kernel", "requant_tiles"),
    ("mlp_block_w8a8", "wgmma"): ("row_prologue", "gemm_kernel", "h_requant_rows"),
    ("mlp_postln_w8a8", "wgmma"): ("row_prologue", "gemm_kernel", "h_requant_rows",
                                   "w8a8_out"),
    ("ln_qkv", "wgmma"): ("gemm_kernel", "ln_rows_bf16"),
    ("ln_qkv_w8a8", "wgmma"): ("row_prologue", "gemm_kernel"),
    ("linear_w8a8", "wgmma"): ("row_prologue", "gemm_kernel"),
    ("mlp_postln", "wgmma"): ("gemm_kernel", "mlp_epilogue"),
    ("mlp_block_bwd", "wgmma"): ("gemm_kernel", "ln_rows_bf16", "mlp_bwd_preln_rows"),
    ("mlp_postln_bwd", "wgmma"): ("gemm_kernel", "mlp_bwd_postln_rows", "mlp_bwd_postln_dx"),
    ("mlp_block", "tiles"): ("row_prologue", "gemm_tiles", "mlp_epilogue"),
    ("mlp_postln", "tiles"): ("gemm_tiles", "mlp_epilogue"),
    ("mlp_block_q8", "tiles"): ("dequant_f32", "row_prologue", "gemm_tiles", "mlp_epilogue"),
    ("mlp_postln_q8", "tiles"): ("dequant_f32", "gemm_tiles", "mlp_epilogue"),
    ("mlp_block_bwd", "tiles"): ("transpose", "row_prologue", "gemm_tiles",
                                 "mlp_bwd_preln_rows", "mlp_bwd_reduce_cols"),
    ("mlp_postln_bwd", "tiles"): ("transpose", "gemm_tiles", "mlp_bwd_postln_rows",
                                  "mlp_bwd_postln_dx", "mlp_bwd_reduce_cols"),
}
# The second geometries the bf16 blocks (and both LN->QKV kernels, both q8
# blocks and both w8a8 blocks) are checked at (the wgmma core's width
# contract): BERT-large (H 1,024, I 4,096) and H 512 / I 2,048.
OTHER_WIDTHS = ((1024, 4096), (512, 2048))
# The SwiGLU block's other widths (its contract: H a multiple of 16 up to
# 8,192, an I-tile pick_tile(I, 1,024) a multiple of 16): Llama-3.2-1B (H
# 2,048, I 8,192) and H 512 / I 1,536 (two tiles of 768) on the exact
# instance; SmolLM-135M (H 576, I 1,536), H 400 / I 960 and H 128 / I 1,376
# (two tiles of 688) on the widened one.
SWIGLU_WIDTHS = ((2048, 8192), (512, 1536), (576, 1536), (400, 960), (128, 1376))
# One training step, kernel path vs plain path (same parameters, batch and
# generator seed): per parameter leaf ||g_kernel - g_plain|| / ||g_plain||,
# and |loss difference|.  The paths round bf16 activations at different
# points through 24 layers and their recomputes.
STEP_LIMITS = {"grad_rel": 5e-2, "loss": 1e-2}
TRAIN_BATCH = 32
KERNEL_NAMES = ("encoder_attention", "attention_bwd", "mlp_block", "mlp_postln", "mlp_block_bwd",
                "mlp_postln_bwd", "ln_qkv", "ln_qkv_w8a8", "mlp_block_w8a8",
                "mlp_postln_w8a8", "mlp_block_q8", "mlp_postln_q8", "attention_gqa",
                "swiglu_w8a8", "linear_w8a8")


def launches(**counts):
    """A launch table: the named kernels' counts, every other kernel 0."""
    return {**{k: 0 for k in KERNEL_NAMES}, **counts}


# Kernel launches of one full-depth forward without gradients (a forward,
# an evaluation batch, a served batch): attention in each of the 24 layers,
# one MLP block in each.
EVAL_LAUNCHES = launches(encoder_attention=24, mlp_block=12, mlp_postln=12)
# The bf16 forward on "fuselnqkv+fusemlp+batched": the fused LN->QKV kernel
# in each ViLT layer besides the above.
LNQKV_LAUNCHES = dict(EVAL_LAUNCHES, ln_qkv=12)
# The w8a8 model's forward (its selector, "fuselnqkv+fusemlp+batched"): the
# int8 LN->QKV and MLP kernels in place of the bf16 MLP kernels, and the
# w8a8 linear kernel for BERT's Q, K, V and attention output projections
# (4 x 12) and ViLT's attention output projection (12).
W8A8_LAUNCHES = launches(encoder_attention=24, ln_qkv_w8a8=12, mlp_block_w8a8=12,
                         mlp_postln_w8a8=12, linear_w8a8=60)
# The w8 model's forward (its selector "auto": "fuseqkv+fusemlp+batched" on
# the card): the q8 MLP kernels in place of the bf16 ones; Q/K/V and the
# attention output projections dequantize and take the plain product.
W8_LAUNCHES = launches(encoder_attention=24, mlp_block_q8=12, mlp_postln_q8=12)
# The Llama-3-8B-geometry tower feeding ViLT-B/32: a GQA attention, a
# SwiGLU kernel and four w8a8 linears (q, k, v, o: H 4,096 -> 4,096 and
# 1,024) in each of the 32 tower layers, then ViLT's 12 layers on "auto"
# (encoder attention and the pre-LN bf16 MLP block).
LLAMA_LAYERS = 32
LLAMA_LAUNCHES = launches(attention_gqa=LLAMA_LAYERS, swiglu_w8a8=LLAMA_LAYERS,
                          linear_w8a8=4 * LLAMA_LAYERS, encoder_attention=12, mlp_block=12)
# The same tower on its plain path (attn_impl and mlp_impl "xla"): no GQA or
# SwiGLU kernel; the MLP's gate and up products (4,096 -> 14,336) take the
# w8a8 linear kernel too, its down product (K 14,336, past the kernel's
# 8,192) the composition.
LLAMA_PLAIN_LAUNCHES = dict(LLAMA_LAUNCHES, attention_gqa=0, swiglu_w8a8=0,
                            linear_w8a8=6 * LLAMA_LAYERS)
# One training step with remat: the forward launches each MLP block once per
# layer and remat's recompute in the backward once more; each backward kernel
# runs once per layer.  Attention takes its kernels where no dropout is
# drawn: ViLT's 12 layers (attention dropout 0) launch the forward kernel
# in the forward and in the recompute and the backward kernel once; BERT's
# (dropout 0.1) run the plain composition.
STEP_LAUNCHES = launches(encoder_attention=24, attention_bwd=12, mlp_block=24,
                         mlp_postln=24, mlp_block_bwd=12, mlp_postln_bwd=12)
# The serve and tasks groups run both towers at this depth (full width, 6
# of their 12 layers) so that the whole run, the parallel group included,
# stays near half the time limit; the full-depth forward, serving and
# training paths are the vault, w8, train, merge and parallel groups'.
CUT_LAYERS = 6


def at_depth(table, layers=CUT_LAYERS):
    """A launch table of the 12 + 12-layer model (every count a per-layer
    count times the layers) at ``layers`` + ``layers``."""
    return {k: v * layers // 12 for k, v in table.items()}


def cut_depth(cfg, layers=CUT_LAYERS):
    """``cfg`` (a VAuLT config) with both towers at ``layers`` layers."""
    return dataclasses.replace(
        cfg, vilt=dataclasses.replace(cfg.vilt, num_hidden_layers=layers),
        text_tower=dataclasses.replace(cfg.text_tower, num_hidden_layers=layers))


def emit(**kw):
    print(json.dumps(kw), flush=True)


def fail(msg: str):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def timed(fn, prefix, row, iters=20):
    """Device ms (``<prefix>ms``) and event wall ms (``<prefix>wall_ms``)."""
    row[prefix + "ms"], kernels = device_ms(fn, iters)
    row[prefix + "wall_ms"] = time_ms(fn, iters)
    row[prefix + "device_kernels"] = kernels


# ---------------------------------------------------------------------------
# Kernel checks
# ---------------------------------------------------------------------------

def attention_case(gen, b, h, l, dtype, dev, fused, d=64, masked_row=False):
    """q, k, v (B, H, L, D) and a key-padding bias.  ``fused``: the heads
    are views into one (B, L, 3 H D) projection, as the main path's fused
    QKV product hands them to the kernel.  ``masked_row``: the last batch
    row masks every key (its rows get the uniform distribution)."""
    import torch

    from vault_tpu_torch.ops.attention import split_heads
    from vault_tpu_torch.ops.masks import extend_attention_mask

    if fused:
        qkv = torch.randn((b, l, 3 * h * d), generator=gen, device=dev).to(dtype)
        q, k, v = (split_heads(t, h) for t in torch.chunk(qkv, 3, dim=-1))
    else:
        q, k, v = (torch.randn((b, h, l, d), generator=gen, device=dev).to(dtype)
                   for _ in range(3))
    lens = torch.randint(max(1, l // 2), l + 1, (b,), generator=gen, device=dev)
    mask = (torch.arange(l, device=dev)[None] < lens[:, None]).to(torch.int32)
    if masked_row:
        mask[-1] = 0
    return q, k, v, extend_attention_mask(mask)


def attention_row_err(out, ref):
    """Max over query rows of max |out - ref| / max |ref| in that row."""
    ref = ref.float()
    err = (out.float() - ref).abs().amax(-1)
    return (err / ref.abs().amax(-1).clamp_min(1e-30)).max().item()


def attention_p_cast(q, k, v, bias, p_dtype):
    """The attention (encoder or GQA: H // G query heads a K/V head, a
    (B, 1, 1 or L, L) bias) with its unnormalised probabilities exp(s - max)
    cast to ``p_dtype`` before P V and the row sum kept in fp32, divided
    once at the end: in bf16 the one-pass kernel's rounding over several key
    tiles, in float8_e4m3fn the control for ``ATTENTION_ROW_LIMIT``, a P V
    product in a lower precision."""
    import torch

    b, h, l, d = q.shape
    g = k.shape[1]
    s = (torch.matmul(q.float().reshape(b, g, h // g, l, d),
                      k.float()[:, :, None].transpose(-1, -2)) / math.sqrt(d)
         + bias.float()[:, :, None])
    e = torch.exp(s - s.amax(-1, keepdim=True))
    out = torch.matmul(e.to(p_dtype).float(), v.float()[:, :, None])
    return (out / e.sum(-1, keepdim=True)).reshape(b, h, l, d).to(v.dtype)


def check_attention_rows(name, shape, q, k, v, bias, out, ref, row):
    """The bf16 row gate (``ATTENTION_ROW_LIMIT``) and its fp8 control."""
    import torch

    row_err = attention_row_err(out, ref)
    control = attention_row_err(attention_p_cast(q, k, v, bias, torch.float8_e4m3fn), ref)
    if not row_err <= ATTENTION_ROW_LIMIT:
        fail(f"{name} {shape}: max over rows of max |kernel - plain| / max |plain| {row_err} "
             f"> {ATTENTION_ROW_LIMIT}")
    if not control > ATTENTION_ROW_LIMIT:
        fail(f"{name} {shape}: P V in fp8 reads {control}, within the row limit "
             f"{ATTENTION_ROW_LIMIT}: the limit would not catch it")
    row.update(row_err=row_err, row_limit=ATTENTION_ROW_LIMIT, fp8_pv_control_row_err=control)


def check_attention(gen, dev):
    import torch
    import torch.nn.functional as F

    from vault_tpu_torch.ops import cuda_attention as ca

    rows = []
    # the main path's two shapes (timed), fp32, the other head dims the
    # kernel takes (BERT-small 32, 96, 128) at the joint length, and the
    # longer lengths where the bf16 kernel's softmax runs online (timed, not
    # main path): ViLT-B/32 at its largest canvas, 384 x 640 (40 + 1 + 240),
    # and BERT's position limit, each with a batch row whose keys are all
    # masked; the main path's shapes at head dim 100 too (timed: the padded
    # instance, OpenLLaMA-3B's head dim)
    long_rows = ((8, 12, 281, torch.bfloat16, 64), (8, 12, 512, torch.bfloat16, 64))
    for b, h, l, dtype, d in ((8, 12, 40, torch.bfloat16, 64),
                              (8, 12, 256, torch.bfloat16, 64),
                              (2, 3, 77, torch.float32, 64),
                              *((8, 12, 256, torch.bfloat16, d) for d in (32, 96, 128)),
                              (2, 3, 77, torch.float32, 128),
                              (8, 12, 40, torch.bfloat16, 100),
                              (8, 12, 256, torch.bfloat16, 100),
                              (2, 3, 77, torch.float32, 100),
                              *long_rows):
        long = (b, h, l, dtype, d) in long_rows
        q, k, v, bias = attention_case(gen, b, h, l, dtype, dev,
                                       fused=dtype == torch.bfloat16, d=d, masked_row=long)
        out, again = ca.fused_attention(q, k, v, bias), ca.fused_attention(q, k, v, bias)
        ref = ca.attention_plain(q, k, v, bias)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        limit = LIMITS[str(dtype).split(".")[-1]]
        if not math.isfinite(err) or err > limit:
            fail(f"attention {(b, h, l, d)} {dtype}: max |kernel - plain| {err} > {limit}")
        if not torch.equal(out, again):
            fail(f"attention {(b, h, l, d)} {dtype}: two launches differ")
        row = dict(kernel="encoder_attention", shape=[b, h, l, d],
                   dtype=str(dtype).split(".")[-1], max_abs_err=err, limit=limit,
                   bit_equal_repeat=True, route=ca.attention_route(dtype))
        if dtype == torch.bfloat16:
            check_attention_rows("attention", (b, h, l, d), q, k, v, bias, out, ref, row)
        if d != 64 or long:
            row["path"] = "long" if long else "other"
        if dtype == torch.bfloat16 and d in (64, 100):
            allowed = bias > -1.0  # True where a key is attended
            timed(lambda: ca.fused_attention(q, k, v, bias), "", row)
            timed(lambda: ca.attention_plain(q, k, v, bias), "plain_", row)
            timed(lambda: F.scaled_dot_product_attention(
                q, k, v, attn_mask=allowed), "library_", row)
            flops = 4.0 * b * h * l * l * d
            nbytes = 4.0 * q.numel() * q.element_size() + bias.numel() * 4
            row["bound_ms"], row["bound_by"] = bound_ms(flops, nbytes, dtype)
            check_route("encoder_attention", row)
        emit(phase="kernel_check", **row)
        rows.append(row)
    return rows


# The backward kernel (``fused_attention_bwd``) against the autograd of the
# plain composition on the same bf16 inputs and output gradient, per
# gradient: ||kernel - plain|| / ||plain||.  Both round dP and P to bf16 at
# the same points; the kernel also feeds dS / sqrt(d) to the tensor cores in
# bf16 (one ulp, 2^-8 relative, of each term) and sums in other orders.
ATTENTION_BWD_LIMIT = 2.0 ** -7
# ViLT-B/32's attention in a training step at batch 256: 12 heads, L 256
# (40 text + 1 + 215 patches), head dim 64.
VILT_TRAIN_SHAPE = (256, 12, 256, 64)


def attention_grads_plain(q, k, v, bias, dout):
    """(dq, dk, dv): the autograd of ``attention_plain``, the parent's
    backward of a training step's attention (forward recomputed)."""
    import torch

    from vault_tpu_torch.ops import cuda_attention as ca

    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    return torch.autograd.grad(ca.attention_plain(*leaves, bias), leaves, dout)


def check_attention_bwd(gen, dev):
    """The attention backward kernel against the autograd of the plain
    composition: ViLT's training shape (timed: the kernel, the plain
    version, the autograd the parent runs, and SDPA's backward as the
    library's yardstick, never called by the port), then B 4, H 12 at L 40,
    65, 256 and 320 and head dims 32, 64, 100 and 128, with key padding and
    a fully masked batch row; two calls bit-equal, one counted call each."""
    import torch
    import torch.nn.functional as F

    from vault_tpu_torch.ops import cuda_attention as ca

    rows = []
    cases = [VILT_TRAIN_SHAPE] + [(4, 12, l, d) for l in (40, 65, 256, 320)
                                  for d in (32, 64, 100, 128)]
    for b, h, l, d in cases:
        q, k, v, bias = attention_case(gen, b, h, l, torch.bfloat16, dev, fused=True, d=d,
                                       masked_row=(b, h, l, d) != VILT_TRAIN_SHAPE)
        dout = torch.randn((b, l, h, d), generator=gen, device=dev).to(
            torch.bfloat16).permute(0, 2, 1, 3)
        n = ca.fused_attention_bwd.launches
        out, again = (ca.fused_attention_bwd(q, k, v, bias, dout) for _ in range(2))
        ref = attention_grads_plain(q, k, v, bias, dout)
        torch.cuda.synchronize()
        if ca.fused_attention_bwd.launches != n + 2:
            fail(f"attention_bwd {(b, h, l, d)}: {ca.fused_attention_bwd.launches - n} "
                 "counted launches for 2 calls")
        errs = {}
        for name, a, r in zip(("dq", "dk", "dv"), out, ref):
            errs[name] = ((a.float() - r.float()).norm() / r.float().norm()).item()
        bad = {n_: e for n_, e in errs.items()
               if not math.isfinite(e) or e > ATTENTION_BWD_LIMIT}
        if bad:
            fail(f"attention_bwd {(b, h, l, d)}: ||kernel - plain|| / ||plain|| {bad} over "
                 f"{ATTENTION_BWD_LIMIT}")
        if not all(torch.equal(a, r) for a, r in zip(out, again)):
            fail(f"attention_bwd {(b, h, l, d)}: two calls differ")
        row = dict(kernel="attention_bwd", shape=[b, h, l, d], dtype="bfloat16",
                   rel_err_by_output=errs, limit=ATTENTION_BWD_LIMIT, bit_equal_repeat=True,
                   route="wgmma")
        if (b, h, l, d) == VILT_TRAIN_SHAPE:
            timed(lambda: ca.fused_attention_bwd(q, k, v, bias, dout), "", row)
            check_route("attention_bwd", row)
            timed(lambda: ca.attention_bwd_plain(q, k, v, bias, dout), "plain_", row)
            timed(lambda: attention_grads_plain(q, k, v, bias, dout), "parent_path_", row)
            leaves = [t.detach().requires_grad_() for t in (q, k, v)]
            sdpa = F.scaled_dot_product_attention(*leaves, attn_mask=bias)
            timed(lambda: torch.autograd.grad(sdpa, leaves, dout, retain_graph=True),
                  "library_", row)
            nbytes = 7.0 * q.numel() * q.element_size() + bias.numel() * 4
            row["bound_ms"], row["bound_by"] = bound_ms(8.0 * b * h * l * l * d, nbytes,
                                                        torch.bfloat16)
            row["bound_share"] = row["bound_ms"] / row["ms"]
            del sdpa, leaves
        else:
            row["path"] = "other"
        emit(phase="attention_bwd", **row)
        rows.append(row)
        del q, k, v, bias, dout, out, again, ref
    torch.cuda.empty_cache()
    return rows


def mlp_operands(gen, rows, dtype, dev, with_mask, h=768, i=3072):
    import torch

    def rnd(*shape, std=1.0, mean=0.0):
        return (torch.randn(shape, generator=gen, device=dev) * std + mean).to(dtype)

    x = rnd(rows, h)
    ops = dict(gamma=rnd(h, std=0.1, mean=1.0), beta=rnd(h, std=0.1),
               w1=rnd(h, i, std=0.02), b1=rnd(i, std=0.02),
               w2=rnd(i, h, std=0.02), b2=rnd(h, std=0.02))
    m = None
    if with_mask:
        keep = torch.rand((rows, h), generator=gen, device=dev) < 0.9
        m = torch.where(keep, torch.tensor(1 / 0.9, device=dev),
                        torch.tensor(0.0, device=dev)).to(dtype)
    return x, ops, m


def check_mlp(gen, dev, postln: bool):
    """The forward block kernel against its plain version at the serving
    and training rows (timed there, beside its bound and the library call),
    at ragged rows, fp32, and at the second widths (``OTHER_WIDTHS``); two
    launches bit-equal (split-K included)."""
    import torch
    import torch.nn.functional as F

    from vault_tpu_torch.ops import cuda_mlp as cm

    name = "mlp_postln" if postln else "mlp_block"
    kernel = cm.fused_mlp_postln_fwd if postln else cm.fused_mlp_block_fwd
    plain = cm._mlp_postln_plain if postln else cm._mlp_block_plain
    main_rows = 8 * 40 if postln else 8 * 256
    # the training step's rows (batch 32; BERT's blocks carry the mask)
    train_rows = TRAIN_BATCH * (40 if postln else 256)
    rows_out = []
    bf, h0, i0 = torch.bfloat16, 768, 3072
    cases = [(main_rows, bf, False, h0, i0), (main_rows, bf, True, h0, i0),
             (train_rows, bf, postln, h0, i0), (77, torch.float32, True, h0, i0)]
    # the wgmma route: ragged tiles and both mask settings, the other widths
    cases += [(train_rows, bf, not postln, h0, i0)] + [
        (rows, bf, mask, h0, i0) for rows in (37, 77) for mask in (False, True)] + [
        (rows, bf, True, h, i) for h, i in OTHER_WIDTHS for rows in (77, main_rows)]
    for rows, dtype, with_mask, h, i in cases:
        x, o, m = mlp_operands(gen, rows, dtype, dev, with_mask, h=h, i=i)
        ln_p = {"scale": o["gamma"], "bias": o["beta"]}
        p_in = {"w": o["w1"], "b": o["b1"]}
        p_out = {"w": o["w2"], "b": o["b2"]}
        run = lambda: kernel(o["gamma"], o["beta"], o["w1"], o["b1"], o["w2"],
                             o["b2"], x, m, eps=1e-12)
        ref_fn = lambda: plain(ln_p, p_in, p_out, x, 1e-12, "gelu", m)
        out, again, ref = run(), run(), ref_fn()
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        limit = LIMITS[str(dtype).split(".")[-1]]
        if not math.isfinite(err) or err > limit:
            fail(f"{name} rows={rows} {dtype} mask={with_mask} H={h} I={i}: "
                 f"max |kernel - plain| {err} > {limit}")
        if not torch.equal(out, again):
            fail(f"{name} rows={rows} {dtype} mask={with_mask} H={h} I={i}: two launches differ")
        route = cm.mlp_route(dtype)
        row = dict(kernel=name, rows=rows, hidden=h, intermediate=i,
                   dtype=str(dtype).split(".")[-1], mask=with_mask, max_abs_err=err,
                   limit=limit, bit_equal_repeat=True, route=route,
                   path="other" if (h, i) != (h0, i0) else (
                       "train" if rows == train_rows else (
                           "forward" if rows == main_rows else "other")))
        if dtype == bf and (h, i) == (h0, i0) and rows in (main_rows, train_rows) and (
                rows == train_rows and with_mask == postln or not with_mask):
            w1t, w2t = o["w1"].t().contiguous(), o["w2"].t().contiguous()
            g, bt, b1, b2 = o["gamma"], o["beta"], o["b1"], o["b2"]
            masked = (lambda t: t) if m is None else (lambda t: t * m)
            if postln:
                lib = lambda: F.layer_norm(
                    x + masked(F.linear(F.gelu(F.linear(x, w1t, b1)), w2t, b2)),
                    (h,), g, bt, 1e-12)
            else:
                lib = lambda: x + masked(F.linear(F.gelu(F.linear(
                    F.layer_norm(x, (h,), g, bt, 1e-12), w1t, b1)), w2t, b2))
            timed(run, "", row)
            timed(ref_fn, "plain_", row)
            timed(lib, "library_", row)
            if route == "wgmma":
                # what the first product's GELU (erff on every element)
                # costs: the same launch with ReLU in its epilogue
                row["relu_epilogue_ms"], _ = device_ms(lambda: kernel(
                    o["gamma"], o["beta"], o["w1"], o["b1"], o["w2"], o["b2"], x, m,
                    eps=1e-12, act="relu"))
            flops = 4.0 * rows * h * i
            nbytes = ((2 + (1 if with_mask else 0)) * rows * h + 2 * h * i
                      + 3 * h + i) * x.element_size()
            row["bound_ms"], row["bound_by"] = bound_ms(flops, nbytes, dtype)
            row["bound_share"] = row["bound_ms"] / row["ms"]
            check_route(name, row)
        emit(phase="kernel_check", **row)
        rows_out.append(row)
    return rows_out


# Kernels of the other designs that a timed run on the wgmma route must not
# show: the MLP walk, gemm_tiles, the FMA attention, and the deleted wmma
# kernels (a stale library would still carry them): attention_kernel, the
# bf16 attention, and gate_up_tiles / down_tiles, the SwiGLU products.
NOT_WGMMA = ("mlp_main", "mlp_bwd_walk", "gemm_tiles", "attention_fma", "attention_kernel",
             "gate_up_tiles", "down_tiles")
# ... and a timed run on the fp32 tiles: the core's products, the walk.
NOT_TILES = ("gemm_kernel", "mlp_main", "mlp_bwd_walk")


def check_route(name, row):
    """The timed run went through the kernels of the block's route."""
    want = ROUTE_KERNELS[(name, row["route"])]
    ran = row["device_kernels"]
    at = f"rows={row['rows']}" if "rows" in row else f"shape={row['shape']}"
    if not all(any(k in n for n in ran) for k in want):
        fail(f"{name} {at}: route {row['route']} should run {want}, ran {sorted(ran)}")
    if row["route"] == "wgmma" and any(k in n for n in ran for k in NOT_WGMMA):
        fail(f"{name} {at}: the wgmma route ran another design's kernel: {sorted(ran)}")
    if row["route"] == "tiles" and any(k in n for n in ran for k in NOT_TILES):
        fail(f"{name} {at}: the fp32 tiles ran another design's kernel: {sorted(ran)}")


def check_gemm_core(gen, dev):
    """The wgmma core alone (``cuda_gemm``) against the plain fp32 product,
    each operand layout at the serving rows (2,048 x 768 x 3,072: W1
    N-contiguous in y W1 at both tile widths, W1 K-contiguous in dh1 W1^T at
    both, the dual y W1 and gc W2^T) and at ragged 77 rows; each timed at
    the training rows (8,192) beside its bound and ``matmul_fp32``."""
    import torch

    from vault_tpu_torch.ops import cuda_gemm as cg

    h, i = 768, 3072
    rnd = lambda *shape, std=1.0: (torch.randn(shape, generator=gen, device=dev)
                                   * std).to(torch.bfloat16)
    w1, w2 = rnd(h, i, std=0.02), rnd(i, h, std=0.02)
    cases = {  # name: (kernel call, plain call, M, N, K) on rows r
        "n_contiguous_192": lambda y, d: (lambda: cg.gemm_bf16(y, w1),
                                          lambda: cg.gemm_plain(y, w1), i, h),
        "n_contiguous_128": lambda y, d: (lambda: cg.gemm_bf16(y, w1, tile_width=128),
                                          lambda: cg.gemm_plain(y, w1), i, h),
        "k_contiguous_192": lambda y, d: (lambda: cg.gemm_bf16(d, w1, True),
                                          lambda: cg.gemm_plain(d, w1, True), h, i),
        "k_contiguous_128": lambda y, d: (lambda: cg.gemm_bf16(d, w1, True, 128),
                                          lambda: cg.gemm_plain(d, w1, True), h, i),
        "dual": lambda y, d: (lambda: cg.gemm_dual_bf16(y, w1, gc, w2),
                              lambda: cg.gemm_dual_plain(y, w1, gc, w2), i, h),
    }
    rows_out = []
    for rows in (2048, 77, 8 * 1024):
        y, d, gc = rnd(rows, h), rnd(rows, i), rnd(rows, h)
        for name, make in cases.items():
            run, plain, n, k = make(y, d)
            out, ref = run(), plain()
            torch.cuda.synchronize()
            outs = out if isinstance(out, tuple) else (out,)
            refs = ref if isinstance(ref, tuple) else (ref,)
            err = max((a - b).abs().max().item() / max(1.0, b.abs().max().item())
                      for a, b in zip(outs, refs))
            if not math.isfinite(err) or err > GEMM_CORE_LIMIT:
                fail(f"gemm core {name} rows={rows}: |kernel - plain| / scale {err} > "
                     f"{GEMM_CORE_LIMIT}")
            row = dict(kernel="gemm_core", layout=name, m=rows, n=n, k=k, rel_err=err,
                       limit=GEMM_CORE_LIMIT)
            if rows == 8 * 1024:
                products = len(outs)
                row["ms"], row["device_kernels"] = device_ms(run)
                row["library_ms"], _ = device_ms(plain)
                row["bound_ms"], row["bound_by"] = bound_ms(
                    2.0 * products * rows * n * k,
                    2.0 * products * (rows * k + k * n) + 4.0 * products * rows * n,
                    torch.bfloat16)
                row["share_of_peak"] = row["bound_ms"] / row["ms"]
            emit(phase="kernel_check", **row)
            rows_out.append(row)
    return rows_out


def check_postln_tiles(gen, dev):
    """The tile shapes tried for the post-LN block's two products, on the
    core alone (``cuda_gemm``) at the BERT rows of a batch-8 forward (320)
    and of a training step (1,280): x W1 (N-contiguous, K = 768) 64, 128 and
    192 wide, and a W2 (K = 3,072) 128 and 192 wide, unsplit and split 2, 4,
    7 and 8 ways.  Each against matmul_fp32 (``GEMM_CORE_LIMIT``; split: the
    slices' sum) and timed beside its bound; the split count the block
    itself takes is read off its workspace (``vt_mlp_wgmma_workspace``)."""
    import torch

    from vault_tpu_torch.ops import _build
    from vault_tpu_torch.ops import cuda_gemm as cg
    from vault_tpu_torch.ops import cuda_mlp as cm

    h, i = 768, 3072
    rnd = lambda *shape, std=1.0: (torch.randn(shape, generator=gen, device=dev)
                                   * std).to(torch.bfloat16)
    w1, w2 = rnd(h, i, std=0.02), rnd(i, h, std=0.02)
    lib = _build.load("mlp", cm._SIGNATURES)
    rows_out = []
    for rows in (320, 1280):
        x, a = rnd(rows, h), rnd(rows, i)
        ws = lib.vt_mlp_wgmma_workspace(rows, h, i, 1)
        picked = (ws - (rows * i + 1) // 2) // (rows * h)
        cases = [("x_w1", x, w1, bn, 1) for bn in (64, 128, 192)] + [
            ("a_w2", a, w2, bn, sp) for bn in (128, 192) for sp in (1, 2, 4, 7, 8)]
        for product, lhs, rhs, bn, splits in cases:
            run = (lambda: cg.gemm_bf16(lhs, rhs, tile_width=bn)) if splits == 1 else (
                lambda: cg.gemm_bf16_split_k(lhs, rhs, splits, tile_width=bn))
            out, ref = run(), cg.gemm_plain(lhs, rhs)
            torch.cuda.synchronize()
            whole = out if splits == 1 else out.sum(0)
            err = (whole - ref).abs().max().item() / max(1.0, ref.abs().max().item())
            if not math.isfinite(err) or err > GEMM_CORE_LIMIT:
                fail(f"post-LN tiles {product} rows={rows} bn={bn} splits={splits}: "
                     f"|kernel - plain| / scale {err} > {GEMM_CORE_LIMIT}")
            m_, k_ = lhs.shape
            n_ = rhs.shape[1]
            row = dict(kernel="postln_tiles", product=product, rows=rows, n=n_, k=k_,
                       tile_width=bn, splits=splits, block_splits=picked, rel_err=err,
                       limit=GEMM_CORE_LIMIT)
            row["ms"], row["device_kernels"] = device_ms(run)
            row["bound_ms"], row["bound_by"] = bound_ms(
                2.0 * m_ * n_ * k_, 2.0 * (m_ * k_ + k_ * n_) + 4.0 * splits * m_ * n_,
                torch.bfloat16)
            row["bound_share"] = row["bound_ms"] / row["ms"]
            emit(phase="kernel_check", **row)
            rows_out.append(row)
    return rows_out


BWD_NAMES = ("dgamma", "dbeta", "dw1", "db1", "dw2", "db2", "dx")


def check_mlp_bwd(gen, dev, postln: bool):
    """The backward kernel against its plain version at the training main
    path's rows (batch 32: 1280 BERT rows, 8192 ViLT rows): all seven
    outputs of the wrapper, the kernel's fp32 dgamma/dbeta, and two launches
    bit-equal.  ``ms`` times the kernel alone (what replaces the Pallas
    call); ``wrapper_ms`` adds the weight-gradient products; ``plain_ms``
    and ``library_ms`` compute all seven outputs (the library: autograd
    through F.layer_norm/F.linear/F.gelu, backward only)."""
    import torch
    import torch.nn.functional as F

    from vault_tpu_torch.ops import cuda_mlp as cm

    name = "mlp_postln_bwd" if postln else "mlp_block_bwd"
    wrapper = cm.fused_mlp_postln_block_bwd if postln else cm.fused_mlp_block_bwd
    plain = cm.mlp_postln_bwd_plain if postln else cm.mlp_block_bwd_plain
    main_rows = TRAIN_BATCH * (40 if postln else 256)
    rows_out = []
    bf, h0, i0 = torch.bfloat16, 768, 3072
    # the main path: BERT's blocks carry the dropout mask, ViLT's none; then
    # fp32, the wgmma route's ragged tiles and the other widths
    cases = [(main_rows, bf, postln, h0, i0), (main_rows, bf, not postln, h0, i0),
             (77, torch.float32, True, h0, i0), (77, bf, True, h0, i0),
             (37, bf, False, h0, i0), (2048 + 5, bf, False, h0, i0)] + [
        (rows, bf, True, h, i) for h, i in OTHER_WIDTHS for rows in (77, 1280)]
    for rows, dtype, with_mask, h, i in cases:
        x, o, m = mlp_operands(gen, rows, dtype, dev, with_mask, h=h, i=i)
        g = torch.randn((rows, h), generator=gen, device=dev).to(dtype)
        args = (o["gamma"], o["beta"], o["w1"], o["b1"], o["w2"], o["b2"], x, g, m)
        dt = str(dtype).split(".")[-1]
        out, ref, again = wrapper(*args), plain(*args), wrapper(*args)
        # dgamma/dbeta before their cast: the kernel's fp32 sums, and the
        # plain version's with fp32 gamma/beta (same arithmetic otherwise)
        raw = cm._launch_bwd(postln, *args, 1e-12)[4:]
        raw_ref = plain(o["gamma"].float(), o["beta"].float(), *args[2:])[:2]
        torch.cuda.synchronize()
        errs = {}
        for n, a, b in zip(BWD_NAMES, out, ref):
            scale = max(1.0, b.float().abs().max().item())
            errs[n] = (a.float() - b.float()).abs().max().item() / scale
        for n, a, b in zip(("dgamma_f32", "dbeta_f32"), raw, raw_ref):
            scale = max(1.0, b.abs().max().item())
            errs[n] = (a - b).abs().max().item() / scale
        limit = BWD_LIMITS[dt]
        bad = {n: e for n, e in errs.items() if not math.isfinite(e) or e > (
            BWD_LN_LIMIT if n.endswith("_f32") and dtype == torch.bfloat16 else limit)}
        if bad:
            fail(f"{name} rows={rows} {dtype} mask={with_mask} H={h} I={i}: |kernel - "
                 f"plain| / scale {bad} over the limit {limit} (LN sums {BWD_LN_LIMIT})")
        same = all(torch.equal(a, b) for a, b in zip(out, again))
        if not same:
            fail(f"{name} rows={rows} {dtype} H={h} I={i}: two launches differ")
        row = dict(kernel=name, rows=rows, hidden=h, intermediate=i, dtype=dt, mask=with_mask,
                   route=cm.mlp_route(dtype),
                   rel_err_by_output=errs, limit=limit, ln_sum_limit=BWD_LN_LIMIT,
                   max_abs_err=max((a.float() - b.float()).abs().max().item()
                                   for a, b in zip(out, ref)),
                   bit_equal_repeat=same)
        if (h, i) != (h0, i0):
            row["path"] = "other"
        if dtype == bf and with_mask == postln and rows == main_rows and (h, i) == (h0, i0):
            timed(lambda: cm._launch_bwd(postln, *args, 1e-12), "", row)
            check_route(name, row)
            row["wrapper_ms"], _ = device_ms(lambda: wrapper(*args))
            timed(lambda: plain(*args), "plain_", row)
            leaves = [t.detach().clone().requires_grad_() for t in (
                x, o["gamma"], o["beta"], o["w1"].t().contiguous(), o["b1"],
                o["w2"].t().contiguous(), o["b2"])]
            xl, gl, bl, w1t, b1, w2t, b2 = leaves
            if postln:
                mlp = F.linear(F.gelu(F.linear(xl, w1t, b1)), w2t, b2)
                fwd = F.layer_norm(xl + (mlp if m is None else mlp * m), (768,),
                                   gl, bl, 1e-12)
            else:
                mlp = F.linear(F.gelu(F.linear(F.layer_norm(xl, (768,), gl, bl, 1e-12),
                                              w1t, b1)), w2t, b2)
                fwd = xl + (mlp if m is None else mlp * m)
            timed(lambda: torch.autograd.grad(fwd, leaves, g, retain_graph=True),
                  "library_", row)
            h, i = 768, 3072
            # pre-LN: h1, da, dy (3 products); post-LN: h1 and o for the LN
            # backward, then da and dx (4).  The JAX CostEstimate counts 3
            # for both; the post-LN kernel must rebuild o before its LN
            # backward, so 4 is the work it has to do.
            products = 4 if postln else 3
            esz = x.element_size()
            nbytes = ((4 + (1 if with_mask else 0)) * rows * h + 2 * rows * i
                      + 2 * h * i + 3 * h + i) * esz + 2 * h * 4
            row["bound_ms"], row["bound_by"] = bound_ms(
                2.0 * products * rows * h * i, nbytes, dtype)
            row["products_in_bound"] = products
            row["bound_share"] = row["bound_ms"] / row["ms"]
            # the wrapper adds dW1 and dW2 (two products) and reads dh1, a
            row["wrapper_bound_ms"], _ = bound_ms(
                2.0 * (products + 2) * rows * h * i, nbytes + 4 * h * i * esz, dtype)
        emit(phase="kernel_check", **row)
        rows_out.append(row)
    return rows_out


# The fp32 blocks on the fp32 tiles (``cuda_mlp.mlp_route`` "tiles"): every
# width of their contract checked here (BERT-base / ViLT-B/32, BERT-large,
# H 512 / I 2,048, H 128 / I 384) at ragged rows, and each block timed at H
# 768 at its main path's rows (the bf16 block's: 2,048 ViLT and 320 BERT
# rows forward, 8,192 and 1,280 in a training step).
TILES_WIDTHS = ((768, 3072), (1024, 4096), (512, 2048), (128, 384))
TILES_ROWS = {"mlp_block": 8 * 256, "mlp_postln": 8 * 40, "mlp_block_q8": 8 * 256,
              "mlp_postln_q8": 8 * 40, "mlp_block_bwd": TRAIN_BATCH * 256,
              "mlp_postln_bwd": TRAIN_BATCH * 40}


def check_mlp_tiles(dev):
    """Every fp32 block (forward, q8 forward, backward; pre-LN and post-LN)
    against its plain version at ``TILES_WIDTHS``, 77 and 37 rows (and the
    forward blocks with the mask): forward within ``LIMITS["float32"]``,
    backward per output within ``BWD_LIMITS["float32"]`` of max(1,
    max|plain|); two launches bit-equal.  At H 768 each is also checked and
    timed at ``TILES_ROWS`` beside its bound (fp32 without the tensor cores),
    its plain version and the library composition (F.layer_norm, F.linear,
    F.gelu in fp32; backward: autograd of it), and its route's kernels
    checked (``check_route``).  Its inputs come from a generator of its own.
    Returns the timed rows by kernel name."""
    import torch
    import torch.nn.functional as F

    from vault_tpu_torch.ops import cuda_mlp as cm

    f32 = torch.float32
    gen = torch.Generator(device=dev).manual_seed(12)
    timed_rows = {}
    for name, rows_main in TILES_ROWS.items():
        postln = "postln" in name
        q8, bwd = name.endswith("_q8"), name.endswith("_bwd")
        cases = [(rows, h, i, mask) for h, i in TILES_WIDTHS for rows in (77, 37)
                 for mask in ((False,) if q8 else (False, True))]
        cases.insert(0, (rows_main, 768, 3072, postln and not q8))
        for rows, h, i, with_mask in cases:
            what = f"{name} fp32 rows={rows} H={h} I={i} mask={with_mask}"
            if q8:
                qo, m = int8_operands(gen, rows, f32, dev, h=h, i=i), None
                args = [qo[k] for k in INT8_KERNELS[name][2]]
                wrapper = getattr(cm, INT8_KERNELS[name][0])
                plain = getattr(cm, INT8_KERNELS[name][1])
                run, ref_fn = (lambda: wrapper(*args)), (lambda: plain(*args))
            else:
                x, o, m = mlp_operands(gen, rows, f32, dev, with_mask, h=h, i=i)
            if bwd:
                g = torch.randn((rows, h), generator=gen, device=dev)
                args = (o["gamma"], o["beta"], o["w1"], o["b1"], o["w2"], o["b2"], x, g, m)
                wrapper = cm.fused_mlp_postln_block_bwd if postln else cm.fused_mlp_block_bwd
                plain = cm.mlp_postln_bwd_plain if postln else cm.mlp_block_bwd_plain
                run, ref_fn = (lambda: wrapper(*args)), (lambda: plain(*args))
            elif not q8:
                kernel = cm.fused_mlp_postln_fwd if postln else cm.fused_mlp_block_fwd
                plain = cm._mlp_postln_plain if postln else cm._mlp_block_plain
                run = lambda: kernel(o["gamma"], o["beta"], o["w1"], o["b1"], o["w2"],
                                     o["b2"], x, m, eps=1e-12)
                ref_fn = lambda: plain({"scale": o["gamma"], "bias": o["beta"]},
                                       {"w": o["w1"], "b": o["b1"]},
                                       {"w": o["w2"], "b": o["b2"]}, x, 1e-12, "gelu", m)
            out, again, ref = run(), run(), ref_fn()
            torch.cuda.synchronize()
            outs, refs, agains = ((out, ref, again) if bwd else ((out,), (ref,), (again,)))
            errs = {}
            for n, a, b in zip(BWD_NAMES if bwd else ("out",), outs, refs):
                scale = max(1.0, b.abs().max().item()) if bwd else 1.0
                errs[n] = (a - b).abs().max().item() / scale
            limit = BWD_LIMITS["float32"] if bwd else LIMITS["float32"]
            bad = {n: e for n, e in errs.items() if not math.isfinite(e) or e > limit}
            if bad:
                fail(f"{what}: |kernel - plain| {bad} over the limit {limit}")
            if not all(torch.equal(a, b) for a, b in zip(outs, agains)):
                fail(f"{what}: two launches differ")
            row = dict(kernel=name, rows=rows, hidden=h, intermediate=i, dtype="float32",
                       mask=with_mask, route=cm.mlp_route(f32), max_abs_err=max(
                           (a - b).abs().max().item() for a, b in zip(outs, refs)),
                       rel_err_by_output=errs if bwd else None, limit=limit,
                       bit_equal_repeat=True, path="fp32")
            if rows == rows_main:
                row_run = (lambda: cm._launch_bwd(postln, *args, 1e-12)) if bwd else run
                timed(row_run, "", row, iters=5 if bwd else 20)
                check_route(name, row)
                timed(ref_fn, "plain_", row, iters=5 if bwd else 20)
                if q8:
                    w1 = qo["w1q"].float() * qo["s1"].reshape(1, -1)
                    w2 = qo["w2q"].float() * qo["s2"].reshape(1, -1)
                    b1, b2, gam, bet = qo["b1"], qo["b2"], qo["gamma"], qo["beta"]
                    xl = qo["x"]
                else:
                    w1, w2, b1, b2, xl = o["w1"], o["w2"], o["b1"], o["b2"], x
                    gam, bet = o["gamma"], o["beta"]
                leaves = [t.detach().clone().requires_grad_(bwd) for t in (
                    xl, gam, bet, w1.t().contiguous(), b1, w2.t().contiguous(), b2)]
                xv, gv, bv, w1t, b1v, w2t, b2v = leaves
                ln = lambda t: F.layer_norm(t, (h,), gv, bv, 1e-12)
                masked = (lambda t: t) if m is None else (lambda t: t * m)

                def lib_fwd():
                    if postln:
                        return ln(xv + masked(F.linear(F.gelu(F.linear(xv, w1t, b1v)), w2t,
                                                       b2v)))
                    return xv + masked(F.linear(F.gelu(F.linear(ln(xv), w1t, b1v)), w2t, b2v))

                if bwd:
                    fwd = lib_fwd()
                    timed(lambda: torch.autograd.grad(fwd, leaves, g, retain_graph=True),
                          "library_", row, iters=5)
                else:
                    timed(lib_fwd, "library_", row)
                products = (4 if postln else 3) if bwd else 2
                nbytes = 4 * ((2 + (1 if with_mask else 0) + (3 if bwd else 0)) * rows * h
                              + (2 * rows * i if bwd else 0) + 2 * h * i + 3 * h + i)
                if q8:
                    nbytes -= 3 * 2 * h * i - 4 * (h + i)  # int8 codes and their scales
                row["bound_ms"], row["bound_by"] = bound_ms(
                    2.0 * products * rows * h * i, nbytes, f32)
                row["bound_share"] = row["bound_ms"] / row["ms"]
                timed_rows[name] = row
            emit(phase="kernel_check", **row)
    return timed_rows


def int8_operands(gen, rows, dtype, dev, h=768, i=3072, w8a8=False):
    """x and the LN/bias vectors in ``dtype``; the QKV and MLP weights drawn
    in ``dtype`` and quantized as the model's are (int8 codes, fp32
    per-out-channel scales); ``w8a8``: the codes K-major, as a w8a8 model
    holds the MLP's and the LN->QKV kernel's concatenated operand
    (``k_major``; the w8 codes row-major)."""
    import torch

    from vault_tpu_torch.ops.quantize import k_major, quantize_weight

    def rnd(*shape, std=1.0, mean=0.0):
        return (torch.randn(shape, generator=gen, device=dev) * std + mean).to(dtype)

    o = dict(x=rnd(rows, h), gamma=rnd(h, std=0.1, mean=1.0), beta=rnd(h, std=0.1),
             wqkv=rnd(h, 3 * h, std=0.02), bqkv=rnd(3 * h, std=0.02),
             b1=rnd(i, std=0.02), b2=rnd(h, std=0.02))
    for name, w in (("wqkv", o["wqkv"]), ("w1", rnd(h, i, std=0.02)),
                    ("w2", rnd(i, h, std=0.02))):
        q, sc = quantize_weight(w)
        o[name + "q"], o["s" + name[1:]] = q, sc.reshape(-1)
        if w8a8:
            o[name + "q"] = k_major(q)
    return o


def _int8_linear_lib(a, wq, sc, b):
    """The library yardstick's w8a8 linear: per-row absmax quantization in
    PyTorch ops, torch._int_mm (on the codes as they lie), dequantization
    and bias."""
    import torch

    af = a.float()
    rs = af.abs().amax(-1, keepdim=True).clamp_min(1e-8) / 127.0
    q = torch.round(af / rs).clamp_(-127, 127).to(torch.int8)
    return torch._int_mm(q, wq).float() * (rs * sc) + b


INT8_KERNELS = {
    # name: (wrapper, plain, operands, main-path rows, library label)
    "ln_qkv": ("fused_ln_qkv_fwd", "ln_qkv_plain",
               ("gamma", "beta", "wqkv", "bqkv", "x"), 8 * 256,
               "F.layer_norm + F.linear"),
    "ln_qkv_w8a8": ("fused_ln_qkv_fwd_w8a8", "ln_qkv_w8a8_plain",
                    ("gamma", "beta", "wqkvq", "sqkv", "bqkv", "x"), 8 * 256,
                    "F.layer_norm + row quantization + torch._int_mm (composition, "
                    "K-major codes)"),
    "mlp_block_w8a8": ("fused_mlp_block_fwd_w8a8", "mlp_block_w8a8_plain",
                       ("gamma", "beta", "w1q", "s1", "b1", "w2q", "s2", "b2", "x"),
                       8 * 256, "F.layer_norm + 2 x (row quantization + "
                       "torch._int_mm) + F.gelu (composition)"),
    "mlp_postln_w8a8": ("fused_mlp_postln_fwd_w8a8", "mlp_postln_w8a8_plain",
                        ("gamma", "beta", "w1q", "s1", "b1", "w2q", "s2", "b2", "x"),
                        8 * 40, "2 x (row quantization + torch._int_mm) + F.gelu + "
                        "F.layer_norm (composition)"),
    "mlp_block_q8": ("fused_mlp_block_fwd_q8", "mlp_block_q8_plain",
                     ("gamma", "beta", "w1q", "s1", "b1", "w2q", "s2", "b2", "x"),
                     8 * 256, "F.layer_norm + 2 x (dequantization + F.linear) + "
                     "F.gelu (composition)"),
    "mlp_postln_q8": ("fused_mlp_postln_fwd_q8", "mlp_postln_q8_plain",
                      ("gamma", "beta", "w1q", "s1", "b1", "w2q", "s2", "b2", "x"),
                      8 * 40, "2 x (dequantization + F.linear) + F.gelu + "
                      "F.layer_norm (composition)"),
}


# The w8a8 linear kernel's shapes (rows, K, N): the main path's at batch
# 256 (BERT's q, k, v and attention output projections at 10,240 rows, ViLT's
# attention output projection at 65,536), a Llama-3-8B K/V projection, and
# ragged rows; the first three timed.
LINEAR_W8A8_SHAPES = ((10240, 768, 768), (65536, 768, 768), (640, 4096, 1024),
                      (1, 768, 768), (17, 768, 768), (40, 768, 768), (257, 768, 768))


def check_linear_w8a8(gen, dev):
    """The w8a8 linear kernel (``cuda_linear.linear_w8a8``) bit-equal to
    its plain version (``nn.linear_w8a8_plain``: the row quantization in
    PyTorch ops, torch._int_mm, the dequantization's casts) at
    ``LINEAR_W8A8_SHAPES``, with and without a bias, an all-zero row and a
    row of half-way ties at +-127 in each; two launches bit-equal; the
    timed shapes beside their bound, the plain version on the K-major codes
    and on row-major ones (the layout the model held before the kernel),
    the route's device kernels checked."""
    import torch

    from vault_tpu_torch.ops import cuda_linear as clin
    from vault_tpu_torch.ops.nn import linear_w8a8_plain
    from vault_tpu_torch.ops.quantize import k_major, quantize_weight

    rows_out = []
    for i, (rows, k, n) in enumerate(LINEAR_W8A8_SHAPES):
        q, s = quantize_weight(torch.randn((k, n), generator=gen, device=dev) * 0.05)
        w = k_major(q)
        x = torch.randn((rows, k), generator=gen, device=dev) * 3
        x[0] = 0.0
        if rows > 1:
            x[1] = torch.arange(k, device=dev) % 9 - 4.5
            x[1, 0], x[1, 1] = 127.0, -127.0
        x = x.to(torch.bfloat16)
        b = (torch.randn(n, generator=gen, device=dev) * 0.1).to(torch.bfloat16)
        for bias in (b, None):
            out, again = clin.linear_w8a8(x, w, s, bias), clin.linear_w8a8(x, w, s, bias)
            ref = linear_w8a8_plain(x, w, s, bias)
            torch.cuda.synchronize()
            what = f"linear_w8a8 rows={rows} K={k} N={n} bias={bias is not None}"
            if not torch.equal(out, ref):
                fail(f"{what}: max |kernel - plain| "
                     f"{(out.float() - ref.float()).abs().max().item()}, expected bit-equal")
            if not torch.equal(out, again):
                fail(f"{what}: two launches differ")
        row = dict(kernel="linear_w8a8", shape=[rows, k, n], route="wgmma", max_abs_err=0.0,
                   bit_equal_repeat=True, bias=True, path="forward" if i < 3 else "other")
        if i < 3:
            row_major = q.contiguous()
            timed(lambda: clin.linear_w8a8(x, w, s, b), "", row)
            timed(lambda: linear_w8a8_plain(x, w, s, b), "plain_", row)
            timed(lambda: linear_w8a8_plain(x, row_major, s, b), "library_", row)
            row["library"] = ("the plain version on row-major codes (the model's path "
                              "before the kernel: torch._int_mm and its cast chain)")
            nbytes = 2 * rows * k + k * n + 4 * n + 2 * n + 2 * rows * n
            row["bound_ms"], row["bound_by"] = bound_ms(2.0 * rows * k * n, nbytes,
                                                        torch.bfloat16, PEAK_INT8_OPS)
            row["bound_share"] = row["bound_ms"] / row["ms"]
            check_route("linear_w8a8", row)
        emit(phase="kernel_check", **row)
        rows_out.append(row)
    return rows_out


def _q8_linear_lib(a, wq, sc, b):
    """The library yardstick's w8 linear: the weights dequantized to a's
    type (counted in the time), then F.linear's product."""
    import torch.nn.functional as F

    return F.linear(a, (wq.float() * sc[:, None]).to(a.dtype), b)


def check_int8_family(gen, dev, name):
    """One LN->QKV, w8a8 MLP or q8 MLP kernel against its plain version at
    the serving path's rows (batch 8: 2,048 ViLT rows, 320 BERT rows) and at
    77 fp32 rows (w8a8: bit-equal; fp LN->QKV: see ``LNQKV_BF16_LIMIT``; q8,
    which rounds no activation to int8: ``LIMITS``); every kernel also at
    77 and 37 rows and at ``OTHER_WIDTHS``, q8 and w8a8 MLP blocks with
    every activation, w8a8 and the fp LN->QKV in bf16 and fp32 alike (the
    w8a8 codes K-major, as the model holds them), the bf16 q8 blocks in
    bf16; two launches bit-equal; times beside the bound and the library
    composition (w8a8 LN->QKV: on K-major and on row-major codes), the
    route's device kernels checked (``check_route``); each q8 block's
    dequantization pass held exact (``check_dequant_pass``)."""
    import torch
    import torch.nn.functional as F

    from vault_tpu_torch.ops import cuda_ln_qkv as cl
    from vault_tpu_torch.ops import cuda_mlp as cm

    wrapper_name, plain_name, names, main_rows, library = INT8_KERNELS[name]
    mod = cl if name.startswith("ln_qkv") else cm
    wrapper, plain = getattr(mod, wrapper_name), getattr(mod, plain_name)
    route_of = {"ln_qkv": lambda dt: cl.ln_qkv_route(dt),
                "ln_qkv_w8a8": lambda dt: cl.ln_qkv_route(dt, w8a8=True),
                "mlp_block_q8": lambda dt: cm.mlp_route(dt, True, False),
                "mlp_postln_q8": lambda dt: cm.mlp_route(dt, True, True),
                "mlp_block_w8a8": cm.w8a8_route, "mlp_postln_w8a8": cm.w8a8_route}.get(name)
    bf, h0, i0 = torch.bfloat16, 768, 3072
    rows_out = []
    cases = [(main_rows, bf, h0, i0, {}), (77, torch.float32, h0, i0, {})]
    if name.startswith("mlp_"):  # the other activations the MLP blocks take
        cases += [(rows, dtype, h0, i0, {"act": act}) for act in ("gelu_new", "relu")
                  for rows, dtype in ((main_rows, bf), (77, torch.float32))]
    # every kernel: the rows and the widths of its contract
    acts = ([{}] if name.startswith("ln_qkv")
            else [{}] + [{"act": a} for a in cm._ACTS if a != "gelu"])
    dtypes = (bf, torch.float32) if name.endswith("_w8a8") or name == "ln_qkv" else (bf,)
    cases += [c for c in ((rows, dt, h, i, kw) for h, i in ((h0, i0), *OTHER_WIDTHS)
                          for rows in (main_rows, 77, 37) for kw in acts for dt in dtypes)
              if c not in cases]
    for rows, dtype, h, i, kw in cases:
        o = int8_operands(gen, rows, dtype, dev, h=h, i=i, w8a8=name.endswith("_w8a8"))
        args = [o[k] for k in names]
        out, again, ref = wrapper(*args, **kw), wrapper(*args, **kw), plain(*args, **kw)
        torch.cuda.synchronize()
        dt = str(dtype).split(".")[-1]
        err = (out.float() - ref.float()).abs().max().item()
        if name.endswith("_w8a8"):
            limit = 0.0
        elif name == "ln_qkv" and dtype == bf:
            limit = LNQKV_BF16_LIMIT * max(1.0, ref.float().abs().max().item())
        else:
            limit = LIMITS[dt]
        what = f"{name} rows={rows} {dtype} H={h} I={i} {kw}"
        if not math.isfinite(err) or err > limit:
            fail(f"{what}: max |kernel - plain| {err} > {limit}")
        if not torch.equal(out, again):
            fail(f"{what}: two launches differ")
        forward = dtype == bf and not kw and (rows, h, i) == (main_rows, h0, i0)
        row = dict(kernel=name, rows=rows, hidden=h, intermediate=i, dtype=dt,
                   max_abs_err=err, limit=limit, bit_equal_repeat=True,
                   path="forward" if forward else "other", act=kw.get("act", "gelu"))
        if route_of is not None:
            row["route"] = route_of(dtype)
        if forward:
            x, g, bt, eps = o["x"], o["gamma"], o["beta"], 1e-12
            ln = lambda t: F.layer_norm(t, (h,), g, bt, eps)
            if name == "ln_qkv":
                wt = o["wqkv"].t().contiguous()
                lib = lambda: F.linear(ln(x), wt, o["bqkv"])
            elif name == "ln_qkv_w8a8":
                lib = lambda: _int8_linear_lib(ln(x), o["wqkvq"], o["sqkv"],
                                               o["bqkv"]).to(dtype)
                row_major = o["wqkvq"].contiguous()  # the JAX package's layout
                timed(lambda: _int8_linear_lib(ln(x), row_major, o["sqkv"],
                                               o["bqkv"]).to(dtype),
                      "library_row_major_", row)
            else:
                if name.endswith("_q8"):
                    w1t, w2t = o["w1q"].t().contiguous(), o["w2q"].t().contiguous()
                    lin1 = lambda a: _q8_linear_lib(a, w1t, o["s1"], o["b1"])
                    lin2 = lambda a: _q8_linear_lib(a, w2t, o["s2"], o["b2"])
                else:
                    lin1 = lambda a: _int8_linear_lib(a, o["w1q"], o["s1"], o["b1"])
                    lin2 = lambda a: _int8_linear_lib(a, o["w2q"], o["s2"], o["b2"])

                def lib(postln=name.startswith("mlp_postln")):
                    a = F.gelu(lin1(x if postln else ln(x))).to(dtype)
                    mlp = lin2(a)
                    return ln(x + mlp.to(dtype)) if postln else mlp.to(dtype) + x
            timed(lambda: wrapper(*args), "", row)
            timed(lambda: plain(*args), "plain_", row)
            timed(lib, "library_", row)
            row["library"] = library
            n = 3 * h
            if name.startswith("ln_qkv"):
                ops = 2.0 * rows * h * n
                wbytes = h * n * (2 if name == "ln_qkv" else 1) + (0 if name == "ln_qkv"
                                                                   else 4 * n)
                nbytes = 2 * rows * (h + n) + wbytes + 2 * (2 * h + n)
                peak = PEAK_BF16_FLOPS if name == "ln_qkv" else PEAK_INT8_OPS
            else:
                ops = 4.0 * rows * h * i
                nbytes = 2 * 2 * rows * h + 2 * h * i + 4 * (h + i) + 2 * (3 * h + i)
                # q8 dequantizes the weights and runs the products in bf16
                peak = PEAK_BF16_FLOPS if name.endswith("_q8") else PEAK_INT8_OPS
            row["bound_ms"], row["bound_by"] = bound_ms(ops, nbytes, dtype, peak)
            row["bound_share"] = row["bound_ms"] / row["ms"]
            if route_of is not None:
                check_route(name, row)
            if name.endswith("_q8"):
                check_dequant_pass(name, o, x, out)
        emit(phase="kernel_check", **row)
        rows_out.append(row)
    return rows_out


def check_dequant_pass(name, o, x, out):
    """A q8 block's route at the serving rows is its dequantization pass
    (``dequant_kernel``), then the bf16 block of the same kind (pre-LN or
    post-LN): the pass alone must equal ``dequant_plain`` bit for bit, and
    the block's output must equal the bf16 block's on the pass's weights."""
    import torch

    from vault_tpu_torch.ops import cuda_gemm as cg
    from vault_tpu_torch.ops import cuda_mlp as cm

    block = cm.fused_mlp_postln_fwd if name == "mlp_postln_q8" else cm.fused_mlp_block_fwd
    w1, w2 = cg.dequant_bf16(o["w1q"], o["s1"]), cg.dequant_bf16(o["w2q"], o["s2"])
    via_pass = block(o["gamma"], o["beta"], w1, o["b1"], w2, o["b2"], x)
    torch.cuda.synchronize()
    if not (torch.equal(w1, cg.dequant_plain(o["w1q"], o["s1"]))
            and torch.equal(w2, cg.dequant_plain(o["w2q"], o["s2"]))):
        fail(f"{name}: the dequantization pass differs from dequant_plain")
    if not torch.equal(via_pass, out):
        fail(f"{name}: the route and the bf16 block on the pass's weights differ")


def check_lnqkv_tiles(gen, dev):
    """The LN->QKV products' tile widths on the core alone (``cuda_gemm``)
    at the serving rows (2,048 x 2,304 x 768: 576 tiles 64 wide in five
    waves, 288 tiles 128 wide in three, 192 tiles 192 wide in two): the bf16
    product's two (128, 192) against matmul_fp32 (``GEMM_CORE_LIMIT``), the
    int8 instance's three (64, 128, 192; K-major codes, s32 out) equal to
    ``gemm_s8_plain``; each timed beside its bound.  The width a kernel takes
    shows in its device kernels' names."""
    import torch

    from vault_tpu_torch.ops import cuda_gemm as cg

    rows, h, n = 2048, 768, 2304
    rows_out = []
    g8 = torch.Generator(device=dev).manual_seed(8)  # leaves gen's draws as they were
    yq = torch.randint(-127, 128, (rows, h), generator=g8, device=dev, dtype=torch.int8)
    wt = torch.randint(-127, 128, (n, h), generator=g8, device=dev, dtype=torch.int8)
    ref = cg.gemm_s8_plain(yq, wt)
    for bn in cg.TILE_WIDTHS:
        run = lambda: cg.gemm_s8(yq, wt, bn)
        out = run()
        torch.cuda.synchronize()
        if not torch.equal(out, ref):
            fail(f"LN->QKV int8 tiles bn={bn}: {int((out != ref).sum())} elements differ "
                 "from the int32 product")
        row = dict(kernel="lnqkv_tiles_s8", rows=rows, n=n, k=h, tile_width=bn, exact=True)
        row["ms"], row["device_kernels"] = device_ms(run)
        row["bound_ms"], row["bound_by"] = bound_ms(
            2.0 * rows * n * h, rows * h + n * h + 4.0 * rows * n, torch.int8, PEAK_INT8_OPS)
        row["bound_share"] = row["bound_ms"] / row["ms"]
        emit(phase="kernel_check", **row)
        rows_out.append(row)
    del yq, wt, ref
    rnd = lambda *shape, std=1.0: (torch.randn(shape, generator=gen, device=dev)
                                   * std).to(torch.bfloat16)
    y, w = rnd(rows, h), rnd(h, n, std=0.02)
    ref = cg.gemm_plain(y, w)
    for bn in (128, 192):
        run = lambda: cg.gemm_bf16(y, w, tile_width=bn)
        out = run()
        torch.cuda.synchronize()
        err = (out - ref).abs().max().item() / max(1.0, ref.abs().max().item())
        if not math.isfinite(err) or err > GEMM_CORE_LIMIT:
            fail(f"LN->QKV tiles bn={bn}: |kernel - plain| / scale {err} > {GEMM_CORE_LIMIT}")
        row = dict(kernel="lnqkv_tiles", rows=rows, n=n, k=h, tile_width=bn, rel_err=err,
                   limit=GEMM_CORE_LIMIT)
        row["ms"], row["device_kernels"] = device_ms(run)
        row["bound_ms"], row["bound_by"] = bound_ms(
            2.0 * rows * n * h, 2.0 * (rows * h + h * n) + 4.0 * rows * n, torch.bfloat16)
        row["bound_share"] = row["bound_ms"] / row["ms"]
        emit(phase="kernel_check", **row)
        rows_out.append(row)
    return rows_out


def gqa_case(gen, b, h, g, l, d, dtype, dev):
    """q (B, H, L, D) and k, v (B, G, L, D) as head views of (B, L, heads D)
    projections, the layout the tower hands the kernel, and a (B, 1, L, L)
    causal and padding bias with the tower's finite fill: row 0 unpadded,
    row 1 padded on the right, row 2 on the left (its first query rows see
    no key at all), the rest at random lengths."""
    import torch

    from vault_tpu_torch.ops.attention import split_heads

    q = split_heads(torch.randn((b, l, h * d), generator=gen, device=dev).to(dtype), h)
    k, v = (split_heads(torch.randn((b, l, g * d), generator=gen, device=dev).to(dtype), g)
            for _ in range(2))
    lens = torch.randint(max(1, l // 2), l + 1, (b,), generator=gen, device=dev)
    pos = torch.arange(l, device=dev)[None]
    pad = (pos < lens[:, None]).float()
    pad[0] = 1.0
    if b > 2:
        pad[2] = (pos >= l - lens[2]).float()[0]
    keep = torch.tril(torch.ones((l, l), device=dev))[None, None] * pad[:, None, None, :]
    return q, k, v, ((1.0 - keep) * torch.finfo(torch.float32).min).contiguous()


def check_attention_gqa(gen, dev):
    """The GQA kernel against its plain version: the tower's shape (16, 32
    heads on 8, 40, 128) with a padded batch, once with one query head per
    K/V head (rep = 1), ragged fp32, the other head dims of an exact
    instance (32, 64, 96) and of a padded one (100, 80, 48, 16; 100 in fp32
    too), and at L = 300,
    where the bf16 kernel's softmax runs online."""
    import torch

    from vault_tpu_torch.ops import cuda_attention as ca

    rows = []
    for b, h, g, l, dtype, d in ((16, 32, 8, 40, torch.bfloat16, 128),
                                 (4, 8, 8, 40, torch.bfloat16, 128),
                                 (3, 8, 2, 77, torch.float32, 128),
                                 *((4, 8, 2, 77, torch.bfloat16, d)
                                   for d in (32, 64, 96, 100, 80, 48, 16)),
                                 (3, 8, 2, 77, torch.float32, 100),
                                 (4, 32, 8, 300, torch.bfloat16, 128)):
        q, k, v, bias = gqa_case(gen, b, h, g, l, d, dtype, dev)
        out, again = ca.fused_attention_gqa(q, k, v, bias), ca.fused_attention_gqa(q, k, v, bias)
        ref = ca.attention_gqa_plain(q, k, v, bias)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        dt = str(dtype).split(".")[-1]
        if not math.isfinite(err) or err > LIMITS[dt]:
            fail(f"attention_gqa {(b, h, g, l, d)} {dtype}: max |kernel - plain| {err} > "
                 f"{LIMITS[dt]}")
        if not torch.equal(out, again):
            fail(f"attention_gqa {(b, h, g, l, d)} {dtype}: two launches differ")
        row = dict(kernel="attention_gqa", shape=[b, h, l, d], kv_heads=g, dtype=dt,
                   max_abs_err=err, limit=LIMITS[dt], bit_equal_repeat=True,
                   route=ca.attention_route(dtype),
                   path="forward" if (b, h, g) == (16, 32, 8) else "other")
        if dtype == torch.bfloat16:
            check_attention_rows("attention_gqa", (b, h, g, l, d), q, k, v, bias, out, ref, row)
        if row["path"] == "forward":
            time_gqa(row, q, k, v, bias)
            check_route("attention_gqa", row)
        emit(phase="kernel_check", **row)
        rows.append(row)
    return rows


def swiglu_operands(gen, dev, h=4096, i=14336):
    """The tower's MLP weights: drawn in fp32 (std 0.02) and quantized one
    at a time, the codes held K-major, as the model's are; the norm weight
    fp32."""
    import torch

    from vault_tpu_torch.ops.quantize import k_major, quantize_weight

    o = {"ln_w": 1.0 + 0.1 * torch.randn(h, generator=gen, device=dev)}
    for name, shape in (("g", (h, i)), ("u", (h, i)), ("d", (i, h))):
        w = torch.randn(shape, generator=gen, device=dev) * 0.02
        q, sc = quantize_weight(w)
        o["w" + name + "q"], o["s" + name] = k_major(q), sc.reshape(-1)
        del w, q
    return o


def time_swiglu(row, o, x, args, eps):
    """The SwiGLU kernel's device ms at ``args`` beside its plain version's,
    a library composition's (``torch._int_mm`` on the K-major codes, per-row
    requantization) and its bound, into ``row``."""
    import torch
    import torch.nn.functional as F

    from vault_tpu_torch.ops import cuda_swiglu as cs

    (rows, h), i, dt = x.shape, o["wgq"].shape[1], x.dtype

    def lib():
        y = F.rms_norm(x, (h,), o["ln_w"].to(dt), eps)
        zero = torch.zeros((), device=x.device)
        a = (F.silu(_int8_linear_lib(y, o["wgq"], o["sg"], zero))
             * _int8_linear_lib(y, o["wuq"], o["su"], zero)).to(dt)
        return x + _int8_linear_lib(a, o["wdq"], o["sd"], zero).to(dt)
    # 20 calls a trace: at 5, three traces in a row at OpenLLaMA-3B's widths
    # held 3 of the 4 launches a call (0.83 of the event time)
    timed(lambda: cs.fused_swiglu_block_fwd_w8a8(*args), "", row)
    timed(lambda: cs.swiglu_block_w8a8_plain(*args), "plain_", row, iters=2)
    timed(lib, "library_", row)
    row["library"] = ("F.rms_norm + 3 x (row quantization + torch._int_mm) + "
                      "F.silu (composition, per-row requantization)")
    nbytes = 3 * h * i + 2 * 2 * rows * h + 4 * (2 * i + h) + 4 * h
    row["bound_ms"], row["bound_by"] = bound_ms(6.0 * rows * h * i, nbytes, dt, PEAK_INT8_OPS)


def time_gqa(row, q, k, v, bias):
    """The GQA kernel's device ms beside its plain version's, SDPA's and
    its bound, into ``row``."""
    import torch.nn.functional as F

    from vault_tpu_torch.ops import cuda_attention as ca

    b, h, l, d = q.shape
    timed(lambda: ca.fused_attention_gqa(q, k, v, bias), "", row)
    timed(lambda: ca.attention_gqa_plain(q, k, v, bias), "plain_", row)
    timed(lambda: F.scaled_dot_product_attention(
        q, k, v, attn_mask=bias.to(q.dtype), enable_gqa=True), "library_", row)
    row["library"] = "F.scaled_dot_product_attention(enable_gqa=True)"
    nbytes = (2.0 * q.numel() + 2.0 * k.numel()) * q.element_size() + bias.numel() * 4
    row["bound_ms"], row["bound_by"] = bound_ms(4.0 * b * h * l * l * d, nbytes, q.dtype)


def check_swiglu(gen, dev):
    """The w8a8 SwiGLU kernel against ``swiglu_block_w8a8_plain`` at the
    tower's rows (batch 16: 640) and half of them, bf16 and fp32, and at
    ``SWIGLU_WIDTHS`` (640 and 77 rows): bit-equal, repeats bit-equal.  Its
    distance from the per-row XLA composition (``swiglu_block_plain``,
    another requantization grouping) is reported; the bf16 main-width rows
    are timed and held to the int8 core's kernels (``check_route``)."""
    import torch

    from vault_tpu_torch.ops import cuda_swiglu as cs

    names = ("ln_w", "wgq", "sg", "wuq", "su", "wdq", "sd")
    rows_out = []
    cases = [((4096, 14336), rows, dtype) for rows, dtype in (
        (640, torch.bfloat16), (320, torch.bfloat16), (640, torch.float32),
        (320, torch.float32))]
    cases += [(hi, rows, dtype) for hi in SWIGLU_WIDTHS
              for rows, dtype in ((640, torch.bfloat16), (77, torch.bfloat16),
                                  (77, torch.float32))]
    o = None
    for (h, i), rows, dtype in cases:
        if o is None or tuple(o["wgq"].shape) != (h, i):
            o = None
            torch.cuda.empty_cache()
            o = swiglu_operands(gen, dev, h, i)
        x = torch.randn((rows, h), generator=gen, device=dev).to(dtype)
        args = [o[k] for k in names] + [x]
        out, again = cs.fused_swiglu_block_fwd_w8a8(*args), cs.fused_swiglu_block_fwd_w8a8(*args)
        ref = cs.swiglu_block_w8a8_plain(*args)
        per_row = cs._w8a8_ref(*args)
        torch.cuda.synchronize()
        dt = str(dtype).split(".")[-1]
        diff = (out.float() - ref.float()).abs()
        err = diff.max().item()
        what = f"swiglu_w8a8 rows={rows} {dtype} H={h} I={i}"
        if not math.isfinite(err) or err != 0.0:
            fail(f"{what}: max |kernel - plain| {err} at {int((diff > 0).sum())} of "
                 f"{diff.numel()} elements, expected bit-equal")
        if not torch.equal(out, again):
            fail(f"{what}: two launches differ")
        main = (h, i) == (4096, 14336)
        row = dict(kernel="swiglu_w8a8", rows=rows, hidden=h, intermediate=i, dtype=dt,
                   max_abs_err=err, limit=0.0, bit_equal_repeat=True,
                   i_tile=cs.pick_tile(i, cs.I_TILE), route=cs.swiglu_route(dtype),
                   vs_per_row_composition=(out.float() - per_row.float()).abs().max().item(),
                   path="forward" if main and (rows, dtype) == (640, torch.bfloat16)
                   else "other")
        if main and dtype == torch.bfloat16:
            time_swiglu(row, o, x, args, 1e-5)
            row["bound_share"] = row["bound_ms"] / row["ms"]
            check_route("swiglu_w8a8", row)
        emit(phase="kernel_check", **row)
        rows_out.append(row)
    del o
    torch.cuda.empty_cache()
    return rows_out


def check_gemm_core_s8(gen, dev):
    """The int8 instance of the core alone (``cuda_gemm.gemm_s8``) against
    the exact int32 product, at the SwiGLU block's gate/up shape (640 x
    14,336 x 4,096), its down product over one I-tile (640 x 4,096 x 1,024)
    and a ragged one, each tile width, rows first or N first: equal; the
    gate/up shape timed beside its bound and ``torch._int_mm``."""
    import torch

    from vault_tpu_torch.ops import cuda_gemm as cg

    rows_out = []
    for m, n, k in ((640, 14336, 4096), (640, 4096, 1024), (77, 768, 384)):
        a = torch.randint(-127, 128, (m, k), generator=gen, device=dev, dtype=torch.int8)
        b = torch.randint(-127, 128, (n, k), generator=gen, device=dev, dtype=torch.int8)
        ref = cg.gemm_s8_plain(a, b)
        for bn in cg.TILE_WIDTHS:
            for rows_first in (True, False):
                run = lambda: cg.gemm_s8(a, b, bn, rows_first)
                out = run()
                torch.cuda.synchronize()
                if not torch.equal(out, ref):
                    fail(f"gemm core s8 {(m, n, k)} bn={bn} rows_first={rows_first}: "
                         f"{int((out != ref).sum())} elements differ from the int32 product")
                row = dict(kernel="gemm_core_s8", m=m, n=n, k=k, tile_width=bn,
                           rows_first=rows_first, exact=True)
                if (m, n, k) == (640, 14336, 4096):
                    row["ms"], row["device_kernels"] = device_ms(run)
                    row["bound_ms"], row["bound_by"] = bound_ms(
                        2.0 * m * n * k, m * k + n * k + 4.0 * m * n, torch.int8, PEAK_INT8_OPS)
                    row["share_of_peak"] = row["bound_ms"] / row["ms"]
                    if bn == 128 and rows_first:
                        bt = b.t()
                        row["library_ms"], _ = device_ms(lambda: torch._int_mm(a, bt))
                emit(phase="kernel_check", **row)
                rows_out.append(row)
        del a, b, ref
    return rows_out


# ---------------------------------------------------------------------------
# Full-width forward and serving
# ---------------------------------------------------------------------------

def entry_batch(cfg, batch_size, dev, seed=0, vocab=None):
    """The JAX package's ``entry()`` input layout: 40 text tokens, a
    384x608 canvas, bf16 pixels.  ``vocab``: the text tower's vocabulary
    size when ``cfg`` is not a VAuLT config."""
    import torch

    rng = np.random.default_rng(seed)
    seq = 40
    vocab = cfg.text_tower.vocab_size if vocab is None else vocab
    return {
        "input_ids": torch.as_tensor(rng.integers(
            0, vocab, (batch_size, seq)), device=dev),
        "attention_mask": torch.ones((batch_size, seq), dtype=torch.int64, device=dev),
        "token_type_ids": torch.zeros((batch_size, seq), dtype=torch.int64, device=dev),
        "pixel_values": torch.as_tensor(rng.normal(size=(batch_size, 3, 384, 608)),
                                        dtype=torch.float32, device=dev).to(torch.bfloat16),
        "pixel_mask": torch.ones((batch_size, 384, 608), dtype=torch.int64, device=dev),
    }


def counters():
    """Every kernel wrapper with a launch counter, by the kernel's name."""
    from vault_tpu_torch.utils.benchloop import launch_counters

    return launch_counters()


def reset_counts():
    for fn in counters().values():
        fn.launches = 0


def read_counts():
    return {name: fn.launches for name, fn in counters().items()}


def attention_ms(kernels):
    """Device ms of a forward's attention kernels (encoder and GQA), from
    ``device_ms``'s kernels by name."""
    return sum(ms for name, ms in kernels.items() if "attention" in name)


def forward_timings(model, cfg, dev, batch_sizes=(8, 16), impl=None):
    """Wall ms of ``model(batch)`` per batch size on the model's own
    selector (or on ``impl``) and on the plain path, taken alternately
    (plain, kernel, kernel, plain: both see the same host and card), with
    the kernel path's device busy ms (CUPTI), idle share, heaviest kernels
    and attention kernels' ms."""
    import torch

    timings = {}
    with torch.inference_mode():
        for bs in batch_sizes:
            b = entry_batch(cfg, bs, dev, seed=1)
            kernel_path = (lambda: model(b)) if impl is None else (
                lambda: model(b, use_pallas=impl))
            plain_path = lambda: model(b, use_pallas=False)
            samples = {"kernel": [], "plain": []}
            for path in ("plain", "kernel", "kernel", "plain"):
                fn = kernel_path if path == "kernel" else plain_path
                samples[path] += [time_ms(fn, iters=5, warmup=2) for _ in range(3)]
            ms = float(np.median(samples["kernel"]))
            dev_ms, kernels = device_ms(kernel_path, iters=3, warmup=1)
            top = dict(sorted(kernels.items(), key=lambda kv: -kv[1])[:8])
            timings[bs] = dict(ms=ms, ms_samples=samples["kernel"],
                               pairs_per_s=bs / ms * 1e3,
                               plain_ms=float(np.median(samples["plain"])),
                               plain_ms_samples=samples["plain"],
                               device_busy_ms=dev_ms, idle_share=1.0 - dev_ms / ms,
                               top_kernels_ms=top, attention_ms=attention_ms(kernels))
    return timings


# The bf16 forward's busy ms per batch size (forward_timings), from the
# vault group; the bench group holds its chained forward to it.
FORWARD_BUSY_MS = {}


def forward_phase(dev):
    import torch

    from vault_tpu_torch.models.vault import VaultForClassification
    from vault_tpu_torch.presets import vault_base

    cfg = vault_base("bert-base-uncased")
    t0 = time.perf_counter()
    model = VaultForClassification(cfg, n_classes=3, device=dev,
                                   dtype=torch.bfloat16, seed=0)
    n_params = sum(p.numel() for p in model.parameters())
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    batch = entry_batch(cfg, 8, dev)
    with torch.inference_mode():
        reset_counts()
        logits = model(batch)
        torch.cuda.synchronize()
        counts = read_counts()
    want = dict(EVAL_LAUNCHES)
    if counts != want:
        fail(f"launches per forward {counts}, expected {want}")
    if logits.shape != (8, 3) or not torch.isfinite(logits.float()).all():
        fail(f"logits {tuple(logits.shape)} not finite")

    err_pool, err_logits, (_, k_logits) = kernel_vs_plain(model, cfg, batch, "auto")
    if (k_logits - logits.float()).abs().max().item() != 0.0:
        fail("forward: model(batch) and vault_apply disagree")
    timings = forward_timings(model, cfg, dev)
    FORWARD_BUSY_MS.update((bs, t["device_busy_ms"]) for bs, t in timings.items())
    with torch.inference_mode():
        b = entry_batch(cfg, 16, dev, seed=1)
        timings["host_ops_ms"] = host_profile(lambda: model(b))
    emit(phase="forward", params=n_params, build_s=build_s,
         launches_per_forward=counts, pooler_max_abs_err=err_pool,
         logits_max_abs_err=err_logits, limits=FORWARD_LIMITS,
         peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
         timings={str(k): v for k, v in timings.items()})
    return model, cfg, counts


def synthetic_vocab(size=30522):
    """A WordPiece vocabulary of bert-base-uncased's size: its specials at
    their ids, single characters, the test sentences' words, and filler."""
    vocab = ["[PAD]"] + [f"[unused{i}]" for i in range(99)]
    vocab += ["[UNK]", "[CLS]", "[SEP]", "[MASK]"]
    vocab += list("abcdefghijklmnopqrstuvwxyz0123456789!?.,'")
    vocab += ["##" + c for c in "abcdefghijklmnopqrstuvwxyz"]
    vocab += ("a the cat dog on couch sits next to window red blue small big "
              "photo of happy sad man woman street car").split()
    vocab = list(dict.fromkeys(vocab))
    vocab += [f"tok{i}" for i in range(size - len(vocab))]
    return {t: i for i, t in enumerate(vocab)}


def serving_phase(model, launches=EVAL_LAUNCHES, phase="serving"):
    """16 concurrent requests through a ``BatchingEngine`` on ``model``:
    ``launches`` per served batch, rows equal to a direct forward."""
    import torch

    from vault_tpu_torch.data.processor import VaultProcessor
    from vault_tpu_torch.serving import BatchingEngine, pad_rows
    from vault_tpu_torch.text.wordpiece import WordPieceTokenizer

    vocab = synthetic_vocab()
    tok = WordPieceTokenizer(vocab)
    # the server resizes on its model's device; the host processor is the
    # reference for the pixels and the yardstick for the time
    proc = VaultProcessor(tok, max_length=40, canvas="auto", device=model.device)
    host_proc = VaultProcessor(tok, max_length=40, canvas="auto")
    rng = np.random.default_rng(2)
    n_req = 16
    # landscape photos of assorted sizes: every batch lands on the
    # (384, 608) canvas, so each row can be held against a direct forward
    sizes = [(int(h), int(h * ar)) for h, ar in
             zip(rng.integers(300, 700, n_req), rng.uniform(1.2, 1.55, n_req))]
    images = [rng.integers(0, 256, (h, w, 3), dtype=np.uint8) for h, w in sizes]
    texts = [f"a {a} {b} sits on the couch next to photo{i}" for i, (a, b) in
             enumerate(zip(rng.choice(["red", "small", "happy"], n_req),
                           rng.choice(["cat", "dog", "man"], n_req)))]
    # one untimed pass first: the first resize and forward at a new shape
    # pay one-time set-up that a running server has behind it
    with torch.inference_mode():
        enc = proc(images[:8], texts[:8])
        model(enc)
    host_enc = host_proc(images[:8], texts[:8])
    pixel_err = float(np.abs(torch.as_tensor(enc["pixel_values"]).cpu().numpy()
                             - host_enc["pixel_values"]).max())
    if pixel_err > 2.0 / 255 + 1e-6:
        fail(f"pixel_values on the card vs the host differ by {pixel_err}")
    proc_ms = {}
    for name, p in (("card", proc), ("host", host_proc)):
        samples = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            p(images[:8], texts[:8])
            torch.cuda.synchronize()
            samples.append((time.perf_counter() - t0) * 1e3)
        proc_ms[name] = float(np.median(samples))
    engine = BatchingEngine(proc, model, max_batch=8, max_wait_ms=50.0)
    reset_counts()
    try:
        with concurrent.futures.ThreadPoolExecutor(n_req) as pool:
            futs = [pool.submit(engine.predict, im, t, 120.0)
                    for im, t in zip(images, texts)]
            results = [f.result() for f in futs]
        stats = engine.stats()
    finally:
        engine.close()
    counts = read_counts()
    if engine._worker.is_alive():
        fail("serving worker did not stop")
    if counts != {k: v * stats["batches_run"] for k, v in launches.items()}:
        fail(f"serving launches {counts} for {stats['batches_run']} batches")
    direct = []
    with torch.inference_mode():
        for lo in range(0, n_req, 8):
            enc = proc(images[lo:lo + 8], texts[lo:lo + 8])
            n = len(images[lo:lo + 8])
            enc = {k: pad_rows(v, 8) for k, v in enc.items()}
            if enc["pixel_values"].shape[-2:] != (384, 608):
                fail(f"canvas {enc['pixel_values'].shape[-2:]}, expected (384, 608)")
            direct.append(model(enc).float().cpu().numpy()[:n])
    direct = np.concatenate(direct)
    err = float(np.abs(np.stack(results) - direct).max())
    if not np.isfinite(err) or err > 1e-2:
        fail(f"engine rows vs direct forward: max abs diff {err}")
    if stats["requests_served"] != n_req:
        fail(f"engine served {stats['requests_served']} of {n_req}")
    emit(phase=phase, requests=n_req, max_abs_diff_vs_direct=err,
         results_shape=list(np.stack(results).shape), launches=counts,
         processor_ms_batch8=proc_ms, pixel_max_abs_diff_card_vs_host=pixel_err,
         stats=stats)


def pooler_logits(model, cfg, batch, impl):
    """(pooler, logits) in fp32 of one deterministic forward on ``impl``."""
    import torch

    from vault_tpu_torch.models.vault import classifier_head_apply, vault_apply

    with torch.inference_mode():
        out = vault_apply(model, cfg, deterministic=True, use_pallas=impl, **batch)
        return (out.pooler_output.float(),
                classifier_head_apply(model["head"], out.pooler_output,
                                      deterministic=True).float())


def kernel_vs_plain(model, cfg, batch, impl, limits=FORWARD_LIMITS):
    """Max |kernel path ``impl`` - plain path| of the pooler and the logits
    (failing past ``limits`` unless it is None), and the kernel path's
    (pooler, logits) in fp32, on the same model and batch."""
    outs = {key: pooler_logits(model, cfg, batch, key) for key in (impl, False)}
    err_pool = (outs[impl][0] - outs[False][0]).abs().max().item()
    err_logits = (outs[impl][1] - outs[False][1]).abs().max().item()
    if limits is not None and not (err_logits <= limits["logits"]
                                   and err_pool <= limits["pooler"]):
        fail(f"{impl} kernel path vs plain path: pooler {err_pool}, logits "
             f"{err_logits} (limits {limits})")
    return err_pool, err_logits, outs[impl]


def lnqkv_phase(model, cfg, dev):
    """The bf16 model on "fuselnqkv+fusemlp+batched": one forward with the
    fused LN->QKV kernel in every ViLT layer, held against the plain path;
    times at batch 8 and 16 as ``forward_timings``."""
    import torch

    impl = "fuselnqkv+fusemlp+batched"
    batch = entry_batch(cfg, 8, dev)
    with torch.inference_mode():
        reset_counts()
        logits = model(batch, use_pallas=impl)
        torch.cuda.synchronize()
        counts = read_counts()
    if counts != LNQKV_LAUNCHES:
        fail(f"{impl}: launches per forward {counts}, expected {LNQKV_LAUNCHES}")
    err_pool, err_logits, (_, k_logits) = kernel_vs_plain(model, cfg, batch, impl)
    if (k_logits - logits.float()).abs().max().item() != 0.0:
        fail(f"{impl}: model(batch) and vault_apply disagree")
    timings = forward_timings(model, cfg, dev, impl=impl)
    emit(phase="forward_fuselnqkv", use_pallas=impl, launches_per_forward=counts,
         pooler_max_abs_err=err_pool, logits_max_abs_err=err_logits,
         limits=FORWARD_LIMITS, timings={str(k): v for k, v in timings.items()})
    return counts


@contextlib.contextmanager
def plain_versions(swaps):
    """Kernel wrappers replaced by their plain versions, ``swaps`` a list of
    (module, wrapper name, plain function): the dispatchers look the
    wrappers up at each call, so a forward on the same selector then runs
    those blocks in plain PyTorch, with the kernels' cast points, and every
    other step as before, the other kernels included."""
    wrappers = [getattr(mod, name) for mod, name, _ in swaps]
    for mod, name, plain in swaps:
        setattr(mod, name, plain)
    try:
        yield
    finally:
        for (mod, name, _), fn in zip(swaps, wrappers):
            setattr(mod, name, fn)


def int8_plain_versions():
    """The four w8a8 kernels of the VAuLT-base path as their plain versions."""
    from vault_tpu_torch.ops import cuda_linear as clin
    from vault_tpu_torch.ops import cuda_ln_qkv as cl
    from vault_tpu_torch.ops import cuda_mlp as cm
    from vault_tpu_torch.ops.nn import linear_w8a8_plain

    return plain_versions([(cl, "fused_ln_qkv_fwd_w8a8", cl.ln_qkv_w8a8_plain),
                           (cm, "fused_mlp_block_fwd_w8a8", cm.mlp_block_w8a8_plain),
                           (cm, "fused_mlp_postln_fwd_w8a8", cm.mlp_postln_w8a8_plain),
                           (clin, "linear_w8a8", linear_w8a8_plain)])


def swiglu_plain_version():
    """The SwiGLU kernel of the Llama tower as its plain version."""
    from vault_tpu_torch.ops import cuda_swiglu as cs

    return plain_versions([(cs, "fused_swiglu_block_fwd_w8a8", cs.swiglu_block_w8a8_plain)])


def w8a8_forward_phase(dev, cfg, bf16_model):
    """The same seeded VAuLT-base, cast to bf16 and then quantized w8a8
    (``VaultForClassification.quantize``, its MLP codes held K-major), on
    its serving selector: launches
    per forward, the kernel path bit-equal to the same path through the
    int8 kernels' plain versions, its distance from the XLA composition and
    from the bf16 model (reported), weight bytes, and times at batch 8 and
    16 taken alternately with the plain path."""
    import torch

    from vault_tpu_torch.models.vault import VaultForClassification
    from vault_tpu_torch.ops.quantize import is_k_major, quantized_bytes

    t0 = time.perf_counter()
    model = VaultForClassification(cfg, n_classes=3, device=dev, dtype=torch.bfloat16,
                                   seed=0).quantize("w8a8")
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    # the int8 MLP kernels take the codes K-major only: the model holds them so
    if not all(is_k_major(lp[n]["w_q8"]) for tower in ("vilt", "bert")
               for lp in model[tower]["layers"] for n in ("mlp_in", "mlp_out")):
        fail("w8a8: the MLP codes are not held K-major")
    impl = model.use_pallas
    batch = entry_batch(cfg, 8, dev)
    with torch.inference_mode():
        reset_counts()
        logits = model(batch)
        torch.cuda.synchronize()
        counts = read_counts()
    if counts != W8A8_LAUNCHES:
        fail(f"w8a8 launches per forward {counts}, expected {W8A8_LAUNCHES}")
    if logits.shape != (8, 3) or not torch.isfinite(logits.float()).all():
        fail(f"w8a8 logits {tuple(logits.shape)} not finite")
    k_pool, k_logits = pooler_logits(model, cfg, batch, impl)
    if (k_logits - logits.float()).abs().max().item() != 0.0:
        fail("w8a8: model(batch) and vault_apply disagree")
    reset_counts()
    with int8_plain_versions():
        p_pool, p_logits = pooler_logits(model, cfg, batch, impl)
    torch.cuda.synchronize()
    plain_counts = read_counts()
    want_plain = dict(W8A8_LAUNCHES, ln_qkv_w8a8=0, mlp_block_w8a8=0, mlp_postln_w8a8=0,
                      linear_w8a8=0)
    if plain_counts != want_plain:
        fail(f"w8a8 through the plain versions: launches {plain_counts}, "
             f"expected {want_plain}")
    vs_plain = {"pooler": (k_pool - p_pool).abs().max().item(),
                "logits": (k_logits - p_logits).abs().max().item()}
    if not (torch.equal(k_pool, p_pool) and torch.equal(k_logits, p_logits)):
        fail(f"w8a8 kernel path vs the int8 kernels' plain versions: max |diff| "
             f"{vs_plain}, expected bit-equal")
    err_pool, err_logits, _ = kernel_vs_plain(model, cfg, batch, impl, None)
    sens_pool, sens_logits, _ = kernel_vs_plain(model, cfg, batch, "fuselnqkv", None)
    _, _, (b_pool, b_logits) = kernel_vs_plain(bf16_model, cfg, batch, "auto")
    divergence = {"pooler_max_abs": (k_pool - b_pool).abs().max().item(),
                  "logits_max_abs": (k_logits - b_logits).abs().max().item(),
                  "argmax_agree": int((k_logits.argmax(-1) == b_logits.argmax(-1)).sum())}
    weight_bytes = {"bf16": quantized_bytes(bf16_model), "w8a8": quantized_bytes(model)}
    torch.cuda.reset_peak_memory_stats()
    timings = forward_timings(model, cfg, dev)
    emit(phase="forward_w8a8", use_pallas=impl, build_s=build_s,
         launches_per_forward=counts, vs_int8_plain_versions=vs_plain,
         vs_int8_plain_versions_limit="bit-equal",
         launches_through_plain_versions=plain_counts,
         vs_xla_path={"pooler": err_pool, "logits": err_logits},
         vs_xla_path_within_forward_limits=(err_pool <= FORWARD_LIMITS["pooler"] and
                                            err_logits <= FORWARD_LIMITS["logits"]),
         forward_limits=FORWARD_LIMITS,
         sensitivity_fuselnqkv_only={"pooler": sens_pool, "logits": sens_logits},
         divergence_from_bf16=divergence, weight_bytes=weight_bytes,
         peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
         timings={str(k): v for k, v in timings.items()})
    return model, counts


def w8_forward_phase(dev, cfg, bf16_model):
    """The same seeded VAuLT-base, cast to bf16 and then quantized w8 (int8
    weights only), on ``serving_impl("w8")`` = "auto": launches per forward,
    the kernel path within ``FORWARD_LIMITS`` of the plain path (w8 rounds
    no activation to int8, so the bf16 limits apply), its distance from the
    bf16 model, weight bytes, and times at batch 8 and 16."""
    import torch

    from vault_tpu_torch.models.vault import VaultForClassification
    from vault_tpu_torch.ops.quantize import quantized_bytes

    t0 = time.perf_counter()
    model = VaultForClassification(cfg, n_classes=3, device=dev, dtype=torch.bfloat16,
                                   seed=0).quantize("w8")
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    impl = model.use_pallas
    counts = {}
    with torch.inference_mode():
        for bs in (8, 16):
            batch = entry_batch(cfg, bs, dev)
            reset_counts()
            logits = model(batch)
            torch.cuda.synchronize()
            counts[bs] = read_counts()
            if counts[bs] != W8_LAUNCHES:
                fail(f"w8 launches per forward at batch {bs} {counts[bs]}, expected "
                     f"{W8_LAUNCHES}")
            if logits.shape != (bs, 3) or not torch.isfinite(logits.float()).all():
                fail(f"w8 logits {tuple(logits.shape)} not finite")
    errs = {}
    for bs in (8, 16):
        batch = entry_batch(cfg, bs, dev)
        err_pool, err_logits, (k_pool, k_logits) = kernel_vs_plain(model, cfg, batch, impl)
        errs[bs] = {"pooler": err_pool, "logits": err_logits}
    if (k_logits - logits.float()).abs().max().item() != 0.0:
        fail("w8: model(batch) and vault_apply disagree")
    _, _, (b_pool, b_logits) = kernel_vs_plain(bf16_model, cfg, batch, "auto")
    divergence = {"pooler_max_abs": (k_pool - b_pool).abs().max().item(),
                  "logits_max_abs": (k_logits - b_logits).abs().max().item(),
                  "argmax_agree": int((k_logits.argmax(-1) == b_logits.argmax(-1)).sum())}
    weight_bytes = {"bf16": quantized_bytes(bf16_model), "w8": quantized_bytes(model)}
    torch.cuda.reset_peak_memory_stats()
    timings = forward_timings(model, cfg, dev)
    emit(phase="forward_w8", use_pallas=impl, build_s=build_s,
         launches_per_forward=counts[8], vs_plain_path={str(k): v for k, v in errs.items()},
         limits=FORWARD_LIMITS, divergence_from_bf16_batch16=divergence,
         weight_bytes=weight_bytes, peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
         timings={str(k): v for k, v in timings.items()})
    return model, counts[8]


def llama_phase(dev):
    """The Llama-3-8B-geometry tower (published widths, all 32 layers,
    seeded random weights quantized w8a8 on the card layer by layer) feeding
    an unquantized bf16 ViLT-B/32 through ``VaultWithLlamaTower``: launches
    per forward, the kernel path bit-equal to the same selectors with the
    SwiGLU wrapper swapped for its plain version, its distance from the
    tower's plain path (``attn_impl="xla", mlp_impl="xla"``, reported),
    resident weight bytes, peak memory and times at batch 16."""
    import torch

    from vault_tpu_torch.config import ViltConfig
    from vault_tpu_torch.models.llama import LlamaConfig
    from vault_tpu_torch.models.vault import VaultWithLlamaTower, vault_with_llama_tower
    from vault_tpu_torch.ops.quantize import quantized_bytes

    bs = 16
    vilt_cfg = ViltConfig()
    llama_cfg = LlamaConfig(num_hidden_layers=LLAMA_LAYERS, attn_impl="pallas",
                            mlp_impl="pallas")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = VaultWithLlamaTower(vilt_cfg, llama_cfg, device=dev, dtype=torch.bfloat16,
                                seed=0, quantize="w8a8")
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    build_peak_gb = torch.cuda.max_memory_allocated() / 1e9
    tower = model["llama"]
    leaf = tower["layers"][0]
    dtypes = {"embed": tower["embed"].dtype, "input_ln": leaf["input_ln"].dtype,
              "gate.w_q8": leaf["gate"]["w_q8"].dtype, "gate.w_scale": leaf["gate"]["w_scale"].dtype,
              "vilt": model["vilt"]["layers"][0]["mlp_in"]["w"].dtype}
    want = {"embed": torch.bfloat16, "input_ln": torch.float32, "gate.w_q8": torch.int8,
            "gate.w_scale": torch.float32, "vilt": torch.bfloat16}
    if dtypes != want:
        fail(f"llama tower dtypes {dtypes}, expected {want}")
    from vault_tpu_torch.ops.quantize import is_k_major

    if not all(is_k_major(lp[n]["w_q8"]) for lp in tower["layers"] for n in ("gate", "up", "down")):
        fail("llama tower: the MLP's int8 codes are not held K-major (the SwiGLU kernel's layout)")
    weight_bytes = {"tower_int8_codes": sum(
        p.numel() for p in tower.parameters() if p.dtype == torch.int8),
        "tower_embed": tower["embed"].numel() * tower["embed"].element_size(),
        "all": quantized_bytes(model)}
    batch = entry_batch(None, bs, dev, vocab=llama_cfg.vocab_size)
    torch.cuda.reset_peak_memory_stats()
    with torch.inference_mode():
        reset_counts()
        out = model(batch)
        torch.cuda.synchronize()
        counts = read_counts()
        if counts != LLAMA_LAUNCHES:
            fail(f"llama launches per forward {counts}, expected {LLAMA_LAUNCHES}")
        pooled, hidden = out.pooler_output, out.last_hidden_state
        if pooled.shape != (bs, vilt_cfg.hidden_size) or not (
                torch.isfinite(pooled.float()).all() and torch.isfinite(hidden.float()).all()):
            fail(f"llama pooler {tuple(pooled.shape)} not finite")
        reset_counts()
        with swiglu_plain_version():
            p_out = model(batch)
        torch.cuda.synchronize()
        plain_counts = read_counts()
        if plain_counts != dict(LLAMA_LAUNCHES, swiglu_w8a8=0):
            fail(f"llama through the SwiGLU plain version: launches {plain_counts}")
        vs_plain = {"pooler": (pooled.float() - p_out.pooler_output.float()).abs().max().item(),
                    "hidden": (hidden.float() - p_out.last_hidden_state.float()
                               ).abs().max().item()}
        if not (torch.equal(pooled, p_out.pooler_output)
                and torch.equal(hidden, p_out.last_hidden_state)):
            fail(f"llama kernel path vs the SwiGLU kernel's plain version: max |diff| "
                 f"{vs_plain}, expected bit-equal")
        xla_cfg = dataclasses.replace(llama_cfg, attn_impl="xla", mlp_impl="xla")
        reset_counts()
        x_out = vault_with_llama_tower(model, vilt_cfg, xla_cfg, deterministic=True,
                                       use_pallas=model.use_pallas, **batch)
        torch.cuda.synchronize()
        xla_counts = read_counts()
        if xla_counts != LLAMA_PLAIN_LAUNCHES:
            fail(f"llama tower on its plain path: launches {xla_counts}, expected "
                 f"{LLAMA_PLAIN_LAUNCHES}")
        vs_xla = {"pooler": (pooled.float() - x_out.pooler_output.float()).abs().max().item(),
                  "hidden": (hidden.float() - x_out.last_hidden_state.float()
                             ).abs().max().item(),
                  "pooler_rms": x_out.pooler_output.float().square().mean().sqrt().item()}
        del p_out, x_out
        run = lambda: model(batch)
        plain_run = lambda: vault_with_llama_tower(
            model, vilt_cfg, xla_cfg, deterministic=True, use_pallas=False, **batch)
        samples = {"kernel": [], "plain": []}
        for path in ("plain", "kernel", "kernel", "plain"):
            fn = run if path == "kernel" else plain_run
            samples[path] += [time_ms(fn, iters=2, warmup=1) for _ in range(2)]
        ms = float(np.median(samples["kernel"]))
        busy, kernels = device_ms(run, iters=2, warmup=0)
        top = dict(sorted(kernels.items(), key=lambda kv: -kv[1])[:8])
    emit(phase="llama_w8a8", tower="llama-3-8B geometry, w8a8", layers=LLAMA_LAYERS,
         batch=bs, build_s=build_s, build_peak_mem_gb=build_peak_gb,
         launches_per_forward=counts, vs_swiglu_plain_version=vs_plain,
         vs_swiglu_plain_version_limit="bit-equal",
         vs_tower_plain_path=vs_xla, weight_bytes=weight_bytes,
         peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9, ms=ms,
         ms_samples=samples["kernel"], plain_ms=float(np.median(samples["plain"])),
         plain_ms_samples=samples["plain"], pairs_per_s=bs / ms * 1e3,
         device_busy_ms=busy, idle_share=1.0 - busy / ms, top_kernels_ms=top,
         attention_ms=attention_ms(kernels))
    del model
    torch.cuda.empty_cache()
    return counts


# The published Llama-architecture geometries whose widths the Llama-3-8B
# one does not cover, from each model's config.json on the Hugging Face hub
# (hidden size, layers, heads and KV heads, intermediate size, vocabulary,
# RMSNorm eps, RoPE base, positions): the SwiGLU kernel's widened instance
# (H 576 and 3,200; I-tiles of 688, 704, 960) and the GQA kernel's padded
# instance (OpenLLaMA-3B's head dim 100).  All layers, seeded random weights.
LLAMA_GEOMETRIES = {
    "meta-llama/Llama-2-7b-hf": dict(
        hidden_size=4096, num_hidden_layers=32, num_attention_heads=32,
        num_key_value_heads=32, intermediate_size=11008, vocab_size=32000,
        rms_norm_eps=1e-5, rope_theta=10000.0, max_position_embeddings=4096),
    "TinyLlama/TinyLlama-1.1B-Chat-v1.0": dict(
        hidden_size=2048, num_hidden_layers=22, num_attention_heads=32,
        num_key_value_heads=4, intermediate_size=5632, vocab_size=32000,
        rms_norm_eps=1e-5, rope_theta=10000.0, max_position_embeddings=2048),
    "HuggingFaceTB/SmolLM-135M": dict(
        hidden_size=576, num_hidden_layers=30, num_attention_heads=9,
        num_key_value_heads=3, intermediate_size=1536, vocab_size=49152,
        rms_norm_eps=1e-5, rope_theta=10000.0, max_position_embeddings=2048),
    "openlm-research/open_llama_3b": dict(
        hidden_size=3200, num_hidden_layers=26, num_attention_heads=32,
        num_key_value_heads=32, intermediate_size=8640, vocab_size=32000,
        rms_norm_eps=1e-6, rope_theta=10000.0, max_position_embeddings=2048),
}
# the geometry whose tower also runs quantized w8 (int8 weights only)
LLAMA_W8_GEOMETRY = "TinyLlama/TinyLlama-1.1B-Chat-v1.0"


def llama_launches(cfg, w8a8=True):
    """A Llama-tower forward feeding ViLT-B/32: a GQA attention and (w8a8)
    a SwiGLU kernel in each tower layer, and four w8a8 linears (q, k, v, o)
    where the geometry's widths are the linear kernel's (H and the K/V width
    multiples of 128: SmolLM-135M's 576 is not), then ViLT's 12 layers on
    "auto"."""
    from vault_tpu_torch.ops import cuda_linear as clin

    layers = cfg.num_hidden_layers
    kv = cfg.num_key_value_heads * cfg.head_dim
    linears = w8a8 and not (cfg.hidden_size % clin.K_MULTIPLE or kv % clin.N_MULTIPLE)
    return launches(attention_gqa=layers, swiglu_w8a8=layers if w8a8 else 0,
                    linear_w8a8=4 * layers if linears else 0, encoder_attention=12,
                    mlp_block=12)


def check_geometry_kernels(gen, dev, name, cfg, rows, counts):
    """The tower's two kernels alone at the geometry's widths and ``rows``
    (batch 16 at 40 tokens), bf16: the SwiGLU block bit-equal to its plain
    version, the GQA attention within ``LIMITS`` and the row gate of its
    plain version, repeats bit-equal; each timed beside its bound, its
    plain version and a library call (``torch._int_mm`` on the K-major
    codes; SDPA)."""
    import torch

    from vault_tpu_torch.ops import cuda_attention as ca
    from vault_tpu_torch.ops import cuda_swiglu as cs

    bf = torch.bfloat16
    h, i, d = cfg.hidden_size, cfg.intermediate_size, cfg.head_dim
    o = swiglu_operands(gen, dev, h, i)
    x = torch.randn((rows, h), generator=gen, device=dev).to(bf)
    args = [o[k] for k in ("ln_w", "wgq", "sg", "wuq", "su", "wdq", "sd")] + [x]
    out, again = cs.fused_swiglu_block_fwd_w8a8(*args), cs.fused_swiglu_block_fwd_w8a8(*args)
    ref = cs.swiglu_block_w8a8_plain(*args)
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs().max().item()
    if not math.isfinite(err) or err != 0.0:
        fail(f"swiglu_w8a8 {name} rows={rows}: max |kernel - plain| {err}, expected bit-equal")
    if not torch.equal(out, again):
        fail(f"swiglu_w8a8 {name}: two launches differ")
    ti = cs.pick_tile(i, cs.I_TILE)
    sw = dict(kernel="swiglu_w8a8", geometry=name, rows=rows, hidden=h, intermediate=i,
              i_tile=ti, dtype="bfloat16", max_abs_err=err, limit=0.0,
              bit_equal_repeat=True, route=cs.swiglu_route(bf),
              launches=counts["swiglu_w8a8"],
              instance="exact" if h % 128 == 0 and ti % 128 == 0 else "widened")

    time_swiglu(sw, o, x, args, cfg.rms_norm_eps)
    check_route("swiglu_w8a8", sw)
    emit(phase="kernel_check", **sw)
    del o, x, args, out, again, ref

    b, heads, kv, l = rows // 40, cfg.num_attention_heads, cfg.num_key_value_heads, 40
    q, k, v, bias = gqa_case(gen, b, heads, kv, l, d, bf, dev)
    out, again = ca.fused_attention_gqa(q, k, v, bias), ca.fused_attention_gqa(q, k, v, bias)
    ref = ca.attention_gqa_plain(q, k, v, bias)
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs().max().item()
    if not math.isfinite(err) or err > LIMITS["bfloat16"]:
        fail(f"attention_gqa {name} {(b, heads, kv, l, d)}: max |kernel - plain| {err} > "
             f"{LIMITS['bfloat16']}")
    if not torch.equal(out, again):
        fail(f"attention_gqa {name}: two launches differ")
    at = dict(kernel="attention_gqa", geometry=name, shape=[b, heads, l, d], kv_heads=kv,
              dtype="bfloat16", max_abs_err=err, limit=LIMITS["bfloat16"],
              bit_equal_repeat=True, route=ca.attention_route(bf),
              launches=counts["attention_gqa"],
              instance="exact" if d in ca.EXACT_HEAD_DIMS else "padded")
    check_attention_rows("attention_gqa", (b, heads, kv, l, d), q, k, v, bias, out, ref, at)
    time_gqa(at, q, k, v, bias)
    check_route("attention_gqa", at)
    emit(phase="kernel_check", **at)
    return [sw, at]


# Moonlight-16B-A3B's routed experts (csrc/moe_experts.cu): H 2,048, I
# 1,408, 64 experts, 6 a token, a batch of 256 x 40 tokens, so R = 61,440
# routed rows.  The kernel and its plain version (a cuBLAS fp32 product an
# expert) round at the same points and sum in other orders, so an
# intermediate element may round to its neighbour: 2^-7 of the largest
# output.  A call is two kernels (gate/up, then down); the tower launches
# one call in each MoE layer.
MOE_SHAPE = dict(rows=61440, hidden=2048, intermediate=1408, experts=64, top_k=6)
MOE_LIMIT = 2.0 ** -7
MOE_KERNELS_PER_CALL = 2
MOE_TOWER_LAYERS = 3  # 1 dense + 2 MoE layers at the published widths


def moe_routing(gen, dev, kind, tokens, experts, k):
    """(tokens, k) distinct experts a row: drawn uniformly (as a router at
    random weights chooses), skewed (a few experts take most rows), or with
    experts 40-63 empty and expert 7 in every row."""
    import torch

    scores = torch.rand((tokens, experts), generator=gen, device=dev)
    if kind == "skewed":
        scores = scores + 2.0 / (1.0 + torch.arange(experts, device=dev))
    elif kind == "empty":
        scores[:, 40:] = -1.0
        scores[:, 7] = 2.0
    return torch.topk(scores, k, dim=-1).indices


def moe_phase(dev, gen):
    """The grouped kernel ``vault_tpu_torch::moe_experts`` against
    ``moe_experts_plain`` on the same card tensors at ``MOE_SHAPE`` (uniform,
    skewed and empty-expert routings; repeats bit-equal), timed beside its
    bound and its plain version; then its launches from a forward of the
    Moonlight tower at the published widths (``MOE_TOWER_LAYERS`` layers),
    the counters set to 0 just before, under ``set_sync_debug_mode("error")``:
    one call and two ``grouped_kernel`` launches an MoE layer.  Returns the
    kernel's row of the table."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from vault_tpu_torch.models import deepseek as ds
    from vault_tpu_torch.ops import cuda_moe, moe

    r, h, i, e, k = (MOE_SHAPE[n] for n in ("rows", "hidden", "intermediate", "experts",
                                              "top_k"))
    tokens = r // k
    bf = torch.bfloat16
    wg, wu = (torch.randn((e, i, h), generator=gen, device=dev).mul_(0.02).to(bf)
              for _ in range(2))
    wd = torch.randn((e, h, i), generator=gen, device=dev).mul_(0.02).to(bf)
    row = None
    for kind in ("uniform", "skewed", "empty"):
        offsets, order, _ = moe.dispatch(moe_routing(gen, dev, kind, tokens, e, k), e)
        x = torch.randn((tokens, h), generator=gen, device=dev).to(bf).index_select(0, order // k)
        route_w = torch.rand((r,), generator=gen, device=dev)
        args = (x, wg, wu, wd, offsets, route_w)
        out, again = cuda_moe.MOE_EXPERTS(*args), cuda_moe.MOE_EXPERTS(*args)
        want = moe.moe_experts_plain(*args)
        torch.cuda.synchronize()
        err = (out.float() - want.float()).abs().max().item()
        limit = MOE_LIMIT * want.float().abs().max().item()
        what = f"moe_experts {kind} R={r} H={h} I={i} E={e}"
        if not math.isfinite(err) or err > limit:
            fail(f"{what}: max |kernel - plain| {err} over the limit {limit}")
        if not torch.equal(out, again):
            fail(f"{what}: two launches differ")
        counts = (offsets[1:] - offsets[:-1]).tolist()
        check = dict(kernel="moe_experts", routing=kind, **MOE_SHAPE, max_abs_err=err,
                     limit=limit, bit_equal_repeat=True, rows_per_expert=[min(counts),
                                                                         max(counts)])
        if kind == "uniform":
            timed(lambda: cuda_moe.MOE_EXPERTS(*args), "", check)
            check["plain_ms"], _ = device_ms(lambda: moe.moe_experts_plain(*args), iters=3)
            flops = 6.0 * r * h * i
            nbytes = 2 * r * h * 2 + 3 * e * i * h * 2 + 2 * r * i * 2 + r * 4 + (e + 1) * 4
            check["bound_ms"], check["bound_by"] = bound_ms(flops, nbytes, bf)
            check["bound_share"] = check["bound_ms"] / check["ms"]
            ran = check["device_kernels"]
            if [n for n in ran if "grouped_kernel" not in n]:
                fail(f"{what}: the operator ran other kernels: {sorted(ran)}")
            row = check
        emit(phase="kernel_check", **check)
    del wg, wu, wd, x, out, again, want, args
    torch.cuda.empty_cache()

    cfg = ds.DeepseekConfig(num_hidden_layers=MOE_TOWER_LAYERS)
    tower_gen = torch.Generator(device=dev).manual_seed(25)
    p = ds.init_deepseek(tower_gen, cfg, bf)
    ids = torch.randint(1, cfg.vocab_size, (256, 40), generator=tower_gen, device=dev)
    lengths = torch.randint(8, 41, (256,), generator=tower_gen, device=dev)
    mask = (torch.arange(40, device=dev)[None] < lengths[:, None]).long()
    moe_layers = sum(cfg.is_moe(n) for n in range(cfg.num_hidden_layers))
    with torch.inference_mode():
        ds.deepseek_apply(p, cfg, ids, mask)
        torch.cuda.synchronize()
        cuda_moe.fused_moe_experts.launches = 0
        torch.cuda.set_sync_debug_mode("error")
        try:
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                ds.deepseek_apply(p, cfg, ids, mask)
                torch.cuda.synchronize()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    calls = cuda_moe.fused_moe_experts.launches
    grouped = sum(1 for ev in prof.events() if ev.device_type == torch.autograd.DeviceType.CUDA
                  and "grouped_kernel" in ev.name)
    if calls != moe_layers or grouped != MOE_KERNELS_PER_CALL * moe_layers:
        fail(f"moe_experts: a {cfg.num_hidden_layers}-layer Moonlight forward made {calls} "
             f"calls and {grouped} grouped_kernel launches; expected {moe_layers} and "
             f"{MOE_KERNELS_PER_CALL * moe_layers}")
    emit(phase="moe_tower_launches", layers=cfg.num_hidden_layers, moe_layers=moe_layers,
         calls=calls, grouped_kernel_launches=grouped, synchronised=False)
    del p
    torch.cuda.empty_cache()
    row.update(launches=calls, launches_path=f"moonlight tower, {moe_layers} MoE layers",
               kernel_launches=grouped)
    return row


def llama_geometries_phase(dev):
    """The Llama tower at each of ``LLAMA_GEOMETRIES`` (published widths,
    all layers, w8a8, seeded random weights) feeding a bf16 ViLT-B/32
    through ``VaultWithLlamaTower``, batch 16: launches per forward exact,
    the kernel path bit-equal to the same forward with the SwiGLU wrapper
    swapped for its plain version, the distance from the tower's plain path
    reported; each of the tower's kernels alone at the geometry's widths
    (``check_geometry_kernels``).  ``LLAMA_W8_GEOMETRY`` also runs w8 (int8
    weights, the GQA kernel, the plain SwiGLU composition): finite, its
    distance from the same tower in bf16 reported.  Returns the launch
    tables and the kernel rows."""
    import torch

    from vault_tpu_torch.config import ViltConfig
    from vault_tpu_torch.models.llama import LlamaConfig
    from vault_tpu_torch.models.vault import VaultWithLlamaTower, vault_with_llama_tower

    bs, vilt_cfg = 16, ViltConfig()
    gen = torch.Generator(device=dev).manual_seed(19)
    counts_by, rows = {}, []

    def forward(model, batch, want, what):
        reset_counts()
        out = model(batch)
        torch.cuda.synchronize()
        counts = read_counts()
        if counts != want:
            fail(f"{what}: launches per forward {counts}, expected {want}")
        if out.pooler_output.shape != (bs, vilt_cfg.hidden_size) or not (
                torch.isfinite(out.pooler_output.float()).all()
                and torch.isfinite(out.last_hidden_state.float()).all()):
            fail(f"{what}: pooler {tuple(out.pooler_output.shape)} not finite")
        return out, counts

    def distance(a, b):
        return {"pooler": (a.pooler_output.float() - b.pooler_output.float()).abs().max().item(),
                "hidden": (a.last_hidden_state.float() - b.last_hidden_state.float()
                           ).abs().max().item()}

    for name, fields in LLAMA_GEOMETRIES.items():
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        cfg = LlamaConfig(attn_impl="pallas", mlp_impl="pallas", **fields)
        layers = cfg.num_hidden_layers
        t0 = time.perf_counter()
        model = VaultWithLlamaTower(vilt_cfg, cfg, device=dev, dtype=torch.bfloat16, seed=0,
                                    quantize="w8a8")
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        codes = sum(p.numel() for p in model["llama"].parameters() if p.dtype == torch.int8)
        batch = entry_batch(None, bs, dev, vocab=cfg.vocab_size)
        want = llama_launches(cfg)
        with torch.inference_mode():
            out, counts = forward(model, batch, want, f"llama {name}")
            reset_counts()
            with swiglu_plain_version():
                p_out = model(batch)
            torch.cuda.synchronize()
            if read_counts() != dict(want, swiglu_w8a8=0):
                fail(f"llama {name} through the SwiGLU plain version: launches {read_counts()}")
            vs_plain = distance(out, p_out)
            if not (torch.equal(out.pooler_output, p_out.pooler_output)
                    and torch.equal(out.last_hidden_state, p_out.last_hidden_state)):
                fail(f"llama {name} kernel path vs the SwiGLU kernel's plain version: "
                     f"max |diff| {vs_plain}, expected bit-equal")
            del p_out
            xla_cfg = dataclasses.replace(cfg, attn_impl="xla", mlp_impl="xla")
            x_out = vault_with_llama_tower(model, vilt_cfg, xla_cfg, deterministic=True,
                                           use_pallas=model.use_pallas, **batch)
            vs_xla = dict(distance(out, x_out), pooler_rms=x_out.pooler_output.float(
            ).square().mean().sqrt().item())
            del x_out
            run = lambda: model(batch)
            ms = time_ms(run, iters=2, warmup=1)
            busy, kernels = device_ms(run, iters=2, warmup=0)
        counts_by[name] = counts
        row = dict(phase="llama_geometry", geometry=name, layers=layers, batch=bs,
                   head_dim=cfg.head_dim, build_s=build_s,
                   tower_int8_code_bytes=codes, launches_per_forward=counts,
                   vs_swiglu_plain_version=vs_plain, vs_swiglu_plain_version_limit="bit-equal",
                   vs_tower_plain_path=vs_xla, ms=ms, device_busy_ms=busy,
                   idle_share=1.0 - busy / ms, attention_ms=attention_ms(kernels),
                   peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
        del model, out
        torch.cuda.empty_cache()
        kernel_rows = check_geometry_kernels(gen, dev, name, cfg, bs * 40, counts)
        row.update(i_tile=kernel_rows[0]["i_tile"],
                   instances={r["kernel"]: r["instance"] for r in kernel_rows})
        rows += kernel_rows
        if name == LLAMA_W8_GEOMETRY:
            torch.cuda.empty_cache()
            with torch.inference_mode():
                ref = VaultWithLlamaTower(vilt_cfg, cfg, device=dev, dtype=torch.bfloat16,
                                          seed=0)
                b_out = ref(batch)
                del ref
                torch.cuda.empty_cache()
                w8 = VaultWithLlamaTower(vilt_cfg, cfg, device=dev, dtype=torch.bfloat16,
                                         seed=0, quantize="w8")
                w8_out, w8_counts = forward(w8, batch, llama_launches(cfg, w8a8=False),
                                            f"llama {name} w8")
                row["w8"] = dict(launches_per_forward=w8_counts,
                                 distance_from_bf16=distance(w8_out, b_out))
                del w8, w8_out, b_out
            torch.cuda.empty_cache()
        emit(**row)
    return counts_by, rows


# ---------------------------------------------------------------------------
# Token merging (ToMe)
# ---------------------------------------------------------------------------

# ToMe on VAuLT-base: the 215 patch tokens merged to 87 (two bipartite steps,
# r = 108 then 20), so the joint length is 40 + 1 + 87 = 128 and ViLT runs
# 1,024 rows at batch 8, 8,192 at batch 64 and 4,096 in a batch-32 training
# step; the key bias carries log(size).  The reference's best serving
# configuration is w8a8 with merge_to 87 at layer 0 on "fuselnqkv+fusemlp".
MERGE_TO = 87
MERGED_L = 40 + 1 + MERGE_TO
# Merging after layer 4: the kernel path and the plain path merge
# contextualized tokens that differ by their rounding, so in bf16 they may
# take other merge decisions; the layer-4 merge is gated in fp32, where the
# fp32 kernels stay within 1e-4 of their plain versions (LIMITS), and the 24
# layers, the final LN, the pooler and the head keep the path difference at
# that order: 1e-4 of the pooler and the logits.
MERGE_F32_LIMITS = {"pooler": 1e-4, "logits": 1e-4}
MERGE_MID_LAYER = 4


@contextlib.contextmanager
def recorded_rows():
    """The rows each MLP block launch of ``cuda_mlp`` runs on, by launcher
    and form: ``{"fwd": [...], "bwd": [...], "w8a8": [...]}`` of (postln,
    rows), recorded around the launchers the wrappers call."""
    from vault_tpu_torch.ops import cuda_mlp as cm

    seen = {"fwd": [], "bwd": [], "w8a8": []}
    names = {"fwd": ("_launch", 7), "bwd": ("_launch_bwd", 7), "w8a8": ("_launch_w8a8", 9)}
    originals = {k: getattr(cm, n) for k, (n, _) in names.items()}

    def wrap(key, fn, at):
        def launcher(postln, *args, **kw):
            x = args[at - 1]
            seen[key].append((bool(postln), x.numel() // x.shape[-1]))
            return fn(postln, *args, **kw)
        return launcher

    for key, (name, at) in names.items():
        setattr(cm, name, wrap(key, originals[key], at))
    try:
        yield seen
    finally:
        for key, (name, _) in names.items():
            setattr(cm, name, originals[key])


def vilt_rows(seen, key):
    """The distinct row counts of the pre-LN (ViLT) blocks in ``seen[key]``."""
    return sorted({rows for postln, rows in seen[key] if not postln})


def merged_forward_phase(dev, cfg):
    """bf16 VAuLT-base merged to 87 patch tokens at layer 0, batch 8: the
    launches per forward on "auto" and on "fuselnqkv+fusemlp+batched" as
    unmerged, ViLT's rows 1,024 and L 128, the kernel path within
    ``FORWARD_LIMITS`` of the plain path on both selectors (both merge the
    same patch embeddings), and busy ms beside the unmerged forward of the
    same model in the same call."""
    import torch

    from vault_tpu_torch.models.vault import VaultForClassification, vault_apply

    model = VaultForClassification(cfg, n_classes=3, device=dev, dtype=torch.bfloat16,
                                   seed=0, merge_to=MERGE_TO)
    batch = entry_batch(cfg, 8, dev)
    counts, errs = {}, {}
    for impl, want in (("auto", EVAL_LAUNCHES),
                       ("fuselnqkv+fusemlp+batched", LNQKV_LAUNCHES)):
        with torch.inference_mode(), recorded_rows() as seen:
            reset_counts()
            logits = model(batch, use_pallas=impl)
            torch.cuda.synchronize()
            counts[impl] = read_counts()
        if counts[impl] != want:
            fail(f"merged {impl}: launches per forward {counts[impl]}, expected {want}")
        if vilt_rows(seen, "fwd") != [8 * MERGED_L]:
            fail(f"merged {impl}: ViLT MLP blocks ran at rows {vilt_rows(seen, 'fwd')}, "
                 f"expected {8 * MERGED_L}")
        if logits.shape != (8, 3) or not torch.isfinite(logits.float()).all():
            fail(f"merged {impl}: logits {tuple(logits.shape)} not finite")
        err_pool, err_logits, (_, k_logits) = merged_kernel_vs_plain(
            model, cfg, batch, impl, FORWARD_LIMITS)
        if (k_logits - logits.float()).abs().max().item() != 0.0:
            fail(f"merged {impl}: model(batch) and vault_apply disagree")
        errs[impl] = {"pooler": err_pool, "logits": err_logits}
    with torch.inference_mode():
        out = vault_apply(model, cfg, merge_patches_to=MERGE_TO, **batch)
    if tuple(out.last_hidden_state.shape[:2]) != (8, MERGED_L) or \
            int(out.attention_mask.shape[1]) != MERGED_L:
        fail(f"merged: joint length {tuple(out.last_hidden_state.shape)}, expected {MERGED_L}")
    timings = {}
    for label, merge_to in (("unmerged", None), ("merged", MERGE_TO), ("merged_again", MERGE_TO),
                            ("unmerged_again", None)):
        model.merge_to = merge_to
        timings[label] = forward_timings(model, cfg, dev, batch_sizes=(8,))[8]
    model.merge_to = MERGE_TO
    # the merge itself (two bipartite steps on batch 8's patch tokens):
    # device ms, and event wall ms per call with the host's launches in it
    from vault_tpu_torch.ops.token_merge import merge_tokens_to

    patches = torch.randn((8, cfg.vilt.num_patch_tokens, cfg.vilt.hidden_size), device=dev,
                          dtype=torch.bfloat16)
    valid = torch.ones(patches.shape[:2], dtype=torch.int64, device=dev)
    with torch.inference_mode():
        merge_cost = {"ms": device_ms(lambda: merge_tokens_to(patches, valid, MERGE_TO))[0],
                      "wall_ms": time_ms(lambda: merge_tokens_to(patches, valid, MERGE_TO))}
    emit(phase="forward_merged", merge_to=MERGE_TO, merge_at_layer=0, joint_length=MERGED_L,
         vilt_rows=8 * MERGED_L, launches_per_forward=counts, vs_plain_path=errs,
         limits=FORWARD_LIMITS, merge_tokens_to_batch8=merge_cost, timings_batch8=timings)
    return model, counts["auto"]


def merged_kernel_vs_plain(model, cfg, batch, impl, limits):
    """``kernel_vs_plain`` on the model's own merge settings."""
    import torch

    from vault_tpu_torch.models.vault import classifier_head_apply, vault_apply

    outs = {}
    for key in (impl, False):
        with torch.inference_mode():
            out = vault_apply(model, cfg, deterministic=True, use_pallas=key,
                              merge_patches_to=model.merge_to,
                              merge_at_layer=model.merge_at_layer, **batch)
            outs[key] = (out.pooler_output.float(), classifier_head_apply(
                model["head"], out.pooler_output, deterministic=True).float())
    err_pool = (outs[impl][0] - outs[False][0]).abs().max().item()
    err_logits = (outs[impl][1] - outs[False][1]).abs().max().item()
    if limits is not None and not (err_logits <= limits["logits"]
                                   and err_pool <= limits["pooler"]):
        fail(f"merged {impl} (merge_to {model.merge_to} at layer {model.merge_at_layer}) "
             f"kernel path vs plain path: pooler {err_pool}, logits {err_logits} "
             f"(limits {limits})")
    return err_pool, err_logits, outs[impl]


def merged_w8a8_phase(dev, cfg):
    """The reference's levered serving configuration: w8a8, merge_to 87 at
    layer 0, "fuselnqkv+fusemlp(+batched)", at batch 8 and 64 (8,192 ViLT
    rows): launches, bit-equal to ``int8_plain_versions``, busy ms and
    pairs/s beside the same model unmerged, in the same call."""
    import torch

    from vault_tpu_torch.models.vault import VaultForClassification

    model = VaultForClassification(cfg, n_classes=3, device=dev, dtype=torch.bfloat16,
                                   seed=0, merge_to=MERGE_TO).quantize("w8a8")
    impl = model.use_pallas
    res = {}
    for bs in (8, 64):
        batch = entry_batch(cfg, bs, dev)
        with torch.inference_mode(), recorded_rows() as seen:
            reset_counts()
            logits = model(batch)
            torch.cuda.synchronize()
            counts = read_counts()
        if counts != W8A8_LAUNCHES:
            fail(f"merged w8a8 batch {bs}: launches {counts}, expected {W8A8_LAUNCHES}")
        if vilt_rows(seen, "w8a8") != [bs * MERGED_L]:
            fail(f"merged w8a8 batch {bs}: ViLT blocks at rows {vilt_rows(seen, 'w8a8')}")
        if logits.shape != (bs, 3) or not torch.isfinite(logits.float()).all():
            fail(f"merged w8a8 batch {bs}: logits {tuple(logits.shape)} not finite")
        k_pool, k_logits = merged_kernel_vs_plain(model, cfg, batch, impl, None)[2]
        if (k_logits - logits.float()).abs().max().item() != 0.0:
            fail(f"merged w8a8 batch {bs}: model(batch) and vault_apply disagree")
        with int8_plain_versions():
            p_pool, p_logits = merged_kernel_vs_plain(model, cfg, batch, impl, None)[2]
        vs_plain = {"pooler": (k_pool - p_pool).abs().max().item(),
                    "logits": (k_logits - p_logits).abs().max().item()}
        if not (torch.equal(k_pool, p_pool) and torch.equal(k_logits, p_logits)):
            fail(f"merged w8a8 batch {bs}: kernel path vs the int8 plain versions "
                 f"{vs_plain}, expected bit-equal")
        timings = {}
        for label, merge_to in (("unmerged", None), ("merged", MERGE_TO),
                                ("merged_again", MERGE_TO), ("unmerged_again", None)):
            model.merge_to = merge_to
            timings[label] = forward_timings(model, cfg, dev, batch_sizes=(bs,))[bs]
        model.merge_to = MERGE_TO
        res[bs] = dict(launches=counts, vilt_rows=bs * MERGED_L,
                       vs_int8_plain_versions=vs_plain, timings=timings)
    emit(phase="forward_merged_w8a8", use_pallas=impl, merge_to=MERGE_TO, merge_at_layer=0,
         vs_int8_plain_versions_limit="bit-equal",
         batches={str(k): v for k, v in res.items()})
    return model, res[8]["launches"]


def merged_mid_phase(dev, cfg, bf16_model):
    """merge_to 87 after layer 4: the fp32 model (the fp32 attention kernel
    and the fp32 tiles' MLP blocks at full width: 2,048 ViLT rows before the
    merge, 1,024 after) within ``MERGE_F32_LIMITS`` of its plain path; the
    bf16 model's distance from its plain path reported, not gated."""
    import torch

    from vault_tpu_torch.models.vault import VaultForClassification

    batch = entry_batch(cfg, 8, dev)
    model = VaultForClassification(cfg, n_classes=3, device=dev, dtype=torch.float32,
                                   seed=0, merge_to=MERGE_TO, merge_at_layer=MERGE_MID_LAYER)
    batch32 = dict(batch, pixel_values=batch["pixel_values"].float())
    with torch.inference_mode(), recorded_rows() as seen:
        reset_counts()
        model(batch32)
        torch.cuda.synchronize()
        counts = read_counts()
    if counts != EVAL_LAUNCHES:
        fail(f"fp32 merged at layer {MERGE_MID_LAYER}: launches {counts}")
    rows = vilt_rows(seen, "fwd")
    if rows != sorted({8 * MERGED_L, 8 * 256}):
        fail(f"fp32 merged at layer {MERGE_MID_LAYER}: ViLT rows {rows}")
    f32_pool, f32_logits, _ = merged_kernel_vs_plain(model, cfg, batch32, "auto",
                                                     MERGE_F32_LIMITS)
    del model
    bf16_model.merge_to, bf16_model.merge_at_layer = MERGE_TO, MERGE_MID_LAYER
    bf_pool, bf_logits, _ = merged_kernel_vs_plain(bf16_model, cfg, batch, "auto", None)
    bf16_model.merge_at_layer = 0
    emit(phase="forward_merged_mid", merge_to=MERGE_TO, merge_at_layer=MERGE_MID_LAYER,
         launches_per_forward=counts, vilt_rows=rows,
         fp32_vs_plain_path={"pooler": f32_pool, "logits": f32_logits},
         fp32_limits=MERGE_F32_LIMITS,
         bf16_vs_plain_path_reported={"pooler": bf_pool, "logits": bf_logits})


# ---------------------------------------------------------------------------
# Training
# ---------------------------------------------------------------------------

UNUSED_LEAVES = {"vilt.text_embeddings.word", "vilt.text_embeddings.position"}


def zero_in_exact_arithmetic(name: str) -> bool:
    """The key projections' biases: b_k adds q . b_k to every score of a
    query's row, and the softmax does not change under that, so their
    gradient is 0 in exact arithmetic and both paths return rounding noise
    there.  They are held to be finite; their norms are printed."""
    return name.endswith(".k.b")


def grad_rel(kernel_grads, plain_grads, unread):
    """Per leaf ||g_kernel - g_plain|| / ||g_plain|| of one step's
    gradients on the two paths.  Returns (rel, noise, bad): ``noise`` the
    two norms of each leaf whose gradient is 0 in exact arithmetic
    (``zero_in_exact_arithmetic``, held finite only); ``bad`` the leaves
    with an unexpected gradient: one the loss never reads (``unread``)
    with a nonzero gradient, any other with a zero or non-finite one."""
    import torch

    rel, noise, bad = {}, {}, []
    for k, gp in plain_grads.items():
        gk = kernel_grads[k]
        nk, np_ = (torch.linalg.vector_norm(t.double()).item() for t in (gk, gp))
        finite = math.isfinite(nk) and math.isfinite(np_)
        if unread(k):
            if nk != 0.0 or np_ != 0.0:
                bad.append((k, nk, np_))
        elif zero_in_exact_arithmetic(k):
            noise[k] = [nk, np_]
            if not finite:
                bad.append((k, nk, np_))
        elif not finite or nk == 0.0 or np_ == 0.0:
            bad.append((k, nk, np_))
        else:
            rel[k] = torch.linalg.vector_norm(gk.double() - gp.double()).item() / np_
    return rel, noise, bad


def entry_features(cfg, n, seed):
    """``n`` examples in the ``entry()`` layout as host numpy arrays (a
    dataset's form): 40 text tokens with ragged padding, a 384x608 canvas,
    3-way labels."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(20, 41, n)
    mask = (np.arange(40)[None] < lens[:, None]).astype(np.int32)
    feats = {"input_ids": (rng.integers(1, cfg.text_tower.vocab_size, (n, 40))
                           * mask).astype(np.int32),
             "attention_mask": mask,
             "token_type_ids": np.zeros((n, 40), np.int32),
             "pixel_values": rng.normal(size=(n, 3, 384, 608)).astype(np.float32),
             "pixel_mask": np.ones((n, 384, 608), np.int32)}
    return feats, rng.integers(0, 3, n)


def train_args(**kw):
    from vault_tpu_torch.training.trainer import TrainArgs

    # the JAX package's defaults (batch 32, remat, bf16 moments,
    # use_pallas "auto") with the bf16 compute copy of fp32 masters
    return TrainArgs(**{**dict(compute_dtype="bfloat16", train_batch_size=TRAIN_BATCH,
                               eval_batch_size=TRAIN_BATCH, disable_tqdm=True), **kw})


def train_step_phase(dev, merge_to=None):
    """One step on the kernel path against one on the plain path (same
    masters, batch and generator seed), the launch counts of a step, and
    the step's time.  With ``merge_to`` the step trains through ToMe (at
    layer 0: both paths merge the same patch embeddings, dropout included,
    the generators drawing alike), its ViLT backward kernels must run at
    ``TRAIN_BATCH * (40 + 1 + merge_to)`` rows, and it is timed beside the
    unmerged step (kernel path) instead of the plain path."""
    import torch

    from vault_tpu_torch.data.loader import InMemoryDataset
    from vault_tpu_torch.models.vault import VaultForClassification
    from vault_tpu_torch.ops import cuda_adamw
    from vault_tpu_torch.presets import vault_base
    from vault_tpu_torch.training.trainer import Trainer, classifier_apply_fn

    cfg = vault_base("bert-base-uncased")
    feats, labels = entry_features(cfg, TRAIN_BATCH, seed=3)
    paths = {impl: classifier_apply_fn(cfg, train_args(use_pallas=impl, merge_to=merge_to))
             for impl in ("auto", False)}
    tr = Trainer(paths["auto"],
                 VaultForClassification(cfg, device=dev, dtype=torch.float32, seed=0),
                 train_args(), InMemoryDataset(feats, labels), device=dev)
    batch, lab, w = tr._to_device(*tr._pad(feats, labels))

    res = {}
    for impl in ("auto", False):
        tr.apply_fn = paths[impl]
        gen = tr.step_generator(0)
        reset_counts()
        with recorded_rows() as seen:
            loss, grads = tr.loss_and_grads(batch, lab, w, gen)
            torch.cuda.synchronize()
        res[impl] = dict(loss=loss.item(), grads=grads, gen=gen.get_state(),
                         counts=read_counts(), rows=vilt_rows(seen, "bwd"))
    vilt_len = 40 + 1 + (cfg.vilt.num_patch_tokens if merge_to is None else merge_to)
    if res["auto"]["rows"] != [TRAIN_BATCH * vilt_len]:
        fail(f"training step (merge_to {merge_to}): the ViLT backward kernels ran at rows "
             f"{res['auto']['rows']}, expected {TRAIN_BATCH * vilt_len}")
    kern, plain = res["auto"], res[False]
    want_plain = {k: 0 for k in STEP_LAUNCHES}
    if kern["counts"] != STEP_LAUNCHES or plain["counts"] != want_plain:
        fail(f"launches of a training forward+backward: kernel path "
             f"{kern['counts']} (expected {STEP_LAUNCHES}), plain path "
             f"{plain['counts']}")
    # the same draws in the same order on both paths: the generators end in
    # the same state, so the dropout masks were the same
    if not torch.equal(kern["gen"], plain["gen"]):
        fail("the kernel path and the plain path drew different dropout streams")
    loss_diff = abs(kern["loss"] - plain["loss"])
    rel, noise, bad = grad_rel(kern["grads"], plain["grads"], UNUSED_LEAVES.__contains__)
    if bad:
        fail(f"leaves with an unexpected gradient (an unread leaf's nonzero, another's "
             f"zero or not finite): {bad[:8]}")
    worst = sorted(rel.items(), key=lambda kv: -kv[1])[:5]
    loss_kernel = kern["loss"]
    if loss_diff > STEP_LIMITS["loss"] or worst[0][1] > STEP_LIMITS["grad_rel"]:
        fail(f"step kernel path vs plain path: loss diff {loss_diff}, worst "
             f"leaves {worst} (limits {STEP_LIMITS})")
    del res, kern, plain

    # the main path: whole optimizer steps through the kernels
    tr.apply_fn = paths["auto"]
    tr._build_optimizer(1)
    step = lambda i: tr.train_step(batch, lab, w, i)
    for i in range(2):
        step(i)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    adamw_before = cuda_adamw.fused_adamw.launches
    step(2)
    torch.cuda.synchronize()
    counts = read_counts()
    if counts != STEP_LAUNCHES:
        fail(f"launches per training step {counts}, expected {STEP_LAUNCHES}")
    # the optimizer: every leaf (fp32 masters, fp32 gradients, bf16
    # moments: one dtype group) in one launch of csrc/adamw.cu
    optimizer = dict(adamw_launches=cuda_adamw.fused_adamw.launches - adamw_before,
                     fused_leaves=tr.tx.fused_leaves, loop_leaves=tr.tx.loop_leaves)
    if optimizer != dict(adamw_launches=1, fused_leaves=len(tr.trainable), loop_leaves=0):
        fail(f"the training step's optimizer: {optimizer}, expected one launch over "
             f"all {len(tr.trainable)} leaves")
    # the yardstick beside the kernel path: the plain path, or (merged)
    # the unmerged kernel path
    other = "plain" if merge_to is None else "unmerged"
    ref_fn = paths[False] if merge_to is None else classifier_apply_fn(cfg, train_args())
    samples = {"kernel": [], other: []}
    # other, kernel, kernel, other: both paths see the same host and card
    for path in (other, "kernel", "kernel", other):
        tr.apply_fn = paths["auto"] if path == "kernel" else ref_fn
        samples[path] += [time_ms(lambda: step(3), iters=1, warmup=0)
                          for _ in range(2)]
    extra = {}
    if merge_to is not None:
        tr.apply_fn = ref_fn
        extra["unmerged_device_busy_ms"], _ = device_ms(lambda: step(4), iters=2, warmup=1)
    tr.apply_fn = paths["auto"]
    ms = float(np.median(samples["kernel"]))
    busy, kernels = device_ms(lambda: step(4), iters=2, warmup=0)
    top = dict(sorted(kernels.items(), key=lambda kv: -kv[1])[:10])
    emit(phase="train_step" if merge_to is None else "train_step_merged", merge_to=merge_to,
         vilt_bwd_rows=TRAIN_BATCH * vilt_len, batch=TRAIN_BATCH,
         loss_kernel_path=loss_kernel,
         loss_abs_diff=loss_diff, grad_rel_worst=worst,
         grad_rel_median=float(np.median(list(rel.values()))),
         leaves_checked=len(rel), unused_leaves=sorted(UNUSED_LEAVES),
         key_bias_grad_norms_kernel_plain=dict(sorted(noise.items())[:4]),
         key_bias_grad_norm_max=max(max(v) for v in noise.values()),
         limits=STEP_LIMITS, launches_per_step=counts, optimizer=optimizer, ms=ms,
         ms_samples=samples["kernel"], **{f"{other}_ms": float(np.median(samples[other])),
                                          f"{other}_ms_samples": samples[other]},
         pairs_per_s=TRAIN_BATCH / ms * 1e3,
         device_busy_ms=busy, idle_share=1.0 - busy / ms,
         peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
         top_kernels_ms=top, **extra)
    del tr
    torch.cuda.empty_cache()
    return cfg, counts


def trainer_phase(dev, cfg):
    """``Trainer.train()`` for six steps with one dev evaluation and a
    checkpoint at its window; the checkpoint restores bit-equal."""
    import shutil

    import torch

    from vault_tpu_torch.data.loader import InMemoryDataset
    from vault_tpu_torch.models.vault import VaultForClassification
    from vault_tpu_torch.training.checkpoint import restore_checkpoint
    from vault_tpu_torch.training.experiment import ExperimentHandler
    from vault_tpu_torch.training.trainer import Trainer, classifier_apply_fn

    feats, labels = entry_features(cfg, 2 * TRAIN_BATCH, seed=4)
    dev_ds = InMemoryDataset(*entry_features(cfg, TRAIN_BATCH, seed=5))
    # the checkpoint (1.8 GB) goes to the build directory, not the output
    ckpt_dir = Path("build") / "chip_smoke_ckpt"
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    handler = ExperimentHandler(str(OUT_DIR / "experiment_logs"), "chip_smoke")
    handler.set_params({"model": "vault_base(bert-base-uncased)", "steps": 6})
    handler.set_name_params(["model"])
    args = train_args(num_train_epochs=3, eval_steps=6, checkpoint_dir=str(ckpt_dir))
    tr = Trainer(classifier_apply_fn(cfg, args),
                 VaultForClassification(cfg, device=dev, dtype=torch.float32, seed=1),
                 args, InMemoryDataset(feats, labels), dev_dataset=dev_ds,
                 exp_handler=handler, device=dev)
    before = {k: tr.params[k].detach().clone() for k in
              ("bert.layers.0.mlp_in.w", "head.out.w",
               f"vilt.layers.{cfg.vilt.num_hidden_layers - 1}.mlp_out.w")}
    reset_counts()
    t0 = time.perf_counter()
    tr.train()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    want = {k: 6 * STEP_LAUNCHES[k] + EVAL_LAUNCHES[k] for k in STEP_LAUNCHES}
    if counts != want:
        fail(f"Trainer.train() launches {counts}, expected {want} (6 steps, 1 "
             "evaluation batch)")
    series = handler._series
    values = series["train_loss"] + series["eval_loss"]
    if len(series["train_loss"]) != 1 or not all(math.isfinite(v) for v in values):
        fail(f"window losses {series}")
    changed = {k: (tr.params[k] - v).abs().max().item() for k, v in before.items()}
    if not all(c > 0.0 for c in changed.values()):
        fail(f"parameters did not change: {changed}")
    reset_counts()
    tr.evaluate(dev_ds)
    eval_counts = read_counts()
    if eval_counts != EVAL_LAUNCHES:
        fail(f"launches of one evaluation batch {eval_counts}, expected {EVAL_LAUNCHES}")
    restored = restore_checkpoint(str(ckpt_dir / "last.ckpt"), tr.checkpoint_state(0))
    live = tr.checkpoint_state(6)
    flat = lambda t: [t["step"], t["opt_state"][0],
                      *_leaves(t["params"]), *_leaves(t["opt_state"][1:])]
    same = [bool(np.array_equal(np.asarray(a), np.asarray(b))) if not isinstance(
        a, torch.Tensor) else torch.equal(a, b) for a, b in zip(flat(restored), flat(live))]
    if not all(same) or len(same) != len(flat(live)):
        fail(f"the checkpoint restores {sum(same)} of {len(same)} leaves bit-equal")
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    emit(phase="trainer", steps=6, wall_s=wall, train_loss=series["train_loss"],
         eval=dict(loss=series["eval_loss"], accuracy=series["eval_accuracy"]),
         launches=counts, launches_per_eval_batch=eval_counts,
         max_param_change=changed, checkpoint_leaves_bit_equal=len(same),
         logs=handler.directory())


# ---------------------------------------------------------------------------
# Serving from checkpoint files (the serve and quantize CLIs, torch.export)
# ---------------------------------------------------------------------------

# Requests per CLI-built server, concurrent, max_batch 8: two served batches.
SERVE_REQUESTS = 16
# The BERTweet-base tower in the HF layout (vinai/bertweet-base's
# config.json widths): RoBERTa positions, one token type, 130 positions.
BERTWEET_CONFIG = dict(model_type="roberta", vocab_size=64001, hidden_size=768,
                       num_hidden_layers=12, num_attention_heads=12,
                       intermediate_size=3072, hidden_act="gelu",
                       max_position_embeddings=130, type_vocab_size=1,
                       layer_norm_eps=1e-5, pad_token_id=1, bos_token_id=0,
                       eos_token_id=2)
SERVE_WORDS = ("a the cat dog on couch sits next to window red blue small big "
               "photo of happy sad man woman street car").split()


def seeded_state_dict(module, seed):
    """The module's state dict with seeded numpy values in place of its own
    (LayerNorm scales about 1, everything else about 0.02), fp32."""
    rng = np.random.default_rng(seed)
    out = {}
    for k, t in module.state_dict().items():
        a = rng.standard_normal(tuple(t.shape), dtype=np.float32) * np.float32(0.02)
        out[k] = a + np.float32(1.0) if k.endswith(".scale") else a
    return out


def fastbpe_files(directory: Path, size: int):
    """A fairseq ``vocab.txt`` (``size`` entries with the four specials and
    ``<mask>`` that ``FastBPE`` adds) and ``bpe.codes`` merging each of
    ``SERVE_WORDS`` whole; single characters, with and without the ``@@``
    continuation mark, cover any other word."""
    chars = list("abcdefghijklmnopqrstuvwxyz0123456789!?.,'")
    tokens = list(dict.fromkeys(SERVE_WORDS + chars + [c + "@@" for c in chars]))
    tokens += [f"tok{i}" for i in range(size - 5 - len(tokens))]
    (directory / "vocab.txt").write_text("".join(f"{t} {len(tokens) - i}\n"
                                                 for i, t in enumerate(tokens)))
    merges = []
    for w in SERVE_WORDS:
        pieces = list(w[:-1]) + [w[-1] + "</w>"]
        while len(pieces) > 1:
            merges.append(f"{pieces[0]} {pieces[1]} 1")
            pieces = [pieces[0] + pieces[1]] + pieces[2:]
    (directory / "bpe.codes").write_text("\n".join(dict.fromkeys(merges)) + "\n")


def write_hf_dirs(root: Path, names=None, layers=12):
    """Three checkpoint directories in the HF layout from seeded numpy, with
    this package's safetensors writer: bert-base-uncased (fp32, ``bert.``,
    a 30,522-entry WordPiece vocab), ViLT-B/32 (fp32, ``vilt.``) and
    BERTweet-base (bf16, ``roberta.``, a fairseq vocab and fastBPE codes),
    each at its published width and ``layers`` layers (12, the published
    depth; the serve and tasks groups take ``CUT_LAYERS``);
    ``names`` picks some of them (each keeps its seed).  Returns, per
    directory, its path, the port-layout arrays its weights hold
    (bf16-rounded for BERTweet) and its size on disk."""
    import torch

    from vault_tpu_torch.config import TextTowerConfig
    from vault_tpu_torch.models import bert as bert_mod
    from vault_tpu_torch.models import vilt as vilt_mod
    from vault_tpu_torch.models.convert import bert_params_to_torch, vilt_params_to_torch
    from vault_tpu_torch.models.pretrained import save_safetensors
    from vault_tpu_torch.presets import bert_base_uncased, vilt_b32

    gen = torch.Generator().manual_seed(0)
    tweet_config = dict(BERTWEET_CONFIG, num_hidden_layers=layers)
    bertweet = TextTowerConfig(**{k: v for k, v in tweet_config.items()
                                  if k not in ("model_type", "bos_token_id", "eos_token_id")},
                               position_embedding_style="roberta")
    bert = dataclasses.replace(bert_base_uncased(), num_hidden_layers=layers)
    vilt = dataclasses.replace(vilt_b32(), num_hidden_layers=layers)
    specs = {"bert-base-uncased": ("bert", bert, "bert.", torch.float32,
                                   dict(model_type="bert", **dataclasses.asdict(bert))),
             "vilt-b32-mlm": ("vilt", vilt, "vilt.", torch.float32,
                              dict(model_type="vilt", **dataclasses.asdict(vilt))),
             "bertweet-base": ("bert", bertweet, "roberta.", torch.bfloat16, tweet_config)}
    out = {}
    for seed, (name, (kind, cfg, prefix, dtype, config)) in enumerate(specs.items()):
        if names is not None and name not in names:
            continue
        d = root / name
        d.mkdir()
        tower = (vilt_mod.init_vilt(gen, cfg) if kind == "vilt"
                 else bert_mod.init_bert(gen, cfg))
        port = seeded_state_dict(tower, seed)
        to_hf = vilt_params_to_torch if kind == "vilt" else bert_params_to_torch
        hf = {k: v.to(dtype) for k, v in to_hf(port, cfg, prefix).items()}
        save_safetensors(hf, str(d / "model.safetensors"), {"format": "pt"})
        (d / "config.json").write_text(json.dumps(config))
        if name == "bert-base-uncased":
            vocab = synthetic_vocab()
            (d / "vocab.txt").write_text("".join(t + "\n" for t in vocab))
        elif name == "bertweet-base":
            fastbpe_files(d, tweet_config["vocab_size"])
            port = {k: torch.from_numpy(v).bfloat16().float().numpy() for k, v in port.items()}
        out[name] = (d, port, sum(f.stat().st_size for f in d.iterdir()))
    return out


def check_loaded(model, tower: str, port: dict):
    """Every parameter of ``model``'s ``tower`` equals its source array."""
    import torch

    sd = model.state_dict()
    for k, a in port.items():
        t = sd[f"{tower}.{k}"]
        if t.dtype != torch.float32 or not torch.equal(t.cpu(), torch.from_numpy(a)):
            fail(f"serve: {tower}.{k} on the card differs from its checkpoint array")


SERVE_CASES = (
    # (name, CLI arguments past the shared ones, launches per served batch,
    #  export the served forward)
    ("bf16", ["--ckpt", "{ft}"], at_depth(EVAL_LAUNCHES), True),
    ("w8a8", ["--ckpt", "{w8a8}"], at_depth(W8A8_LAUNCHES), True),
    ("w8", ["--ckpt", "{w8}"], at_depth(W8_LAUNCHES), False),
    ("w8a8_merge87", ["--ckpt", "{w8a8}", "--merge_to", str(MERGE_TO)],
     at_depth(W8A8_LAUNCHES), False),
    ("bertweet_bf16", ["--bert", "{bertweet}"], at_depth(EVAL_LAUNCHES), False),
)


def http_json(url, payload=None, timeout=120.0):
    import urllib.request

    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(url, data=data, headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        body = r.read()
        return body if r.headers["Content-Type"].startswith("text/plain") else json.loads(body)


def serve_requests(seed=3):
    """``SERVE_REQUESTS`` (PNG bytes base64, text, image) of assorted
    landscape photo sizes and short texts."""
    import base64
    import io

    from PIL import Image

    rng = np.random.default_rng(seed)
    out = []
    for i in range(SERVE_REQUESTS):
        h = int(rng.integers(300, 700))
        im = rng.integers(0, 256, (h, int(h * rng.uniform(1.2, 1.55)), 3), dtype=np.uint8)
        buf = io.BytesIO()
        Image.fromarray(im).save(buf, format="PNG")
        text = (f"a {rng.choice(['red', 'small', 'happy'])} "
                f"{rng.choice(['cat', 'dog', 'man'])} sits on the couch next to photo{i}")
        out.append((base64.b64encode(buf.getvalue()).decode(), text, im))
    return out


def served_phase(name, model, processor, server, launches):
    """``SERVE_REQUESTS`` concurrent POST /predict to a started CLI-built
    server after the CLI's warm-up request: launches per served batch, each
    response against a direct forward of the same model on its processed
    batch (the rows of ``serving_phase``), /healthz and /metrics."""
    import torch

    from vault_tpu_torch.cli.serve import warm_up
    from vault_tpu_torch.serving import pad_rows

    base = f"http://127.0.0.1:{server.port}"
    reqs = serve_requests()
    warm_up(server)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(reqs)) as pool:
        futs = [pool.submit(http_json, f"{base}/predict", {"text": t, "image_b64": b})
                for b, t, _ in reqs]
        results = [f.result()["output"] for f in futs]
    wall_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    counts = read_counts()
    health = http_json(f"{base}/healthz")
    metrics = http_json(f"{base}/metrics").decode()
    # the warm-up is one request and one batch of the server's counts
    if not health["ok"] or health["requests_served"] != len(reqs) + 1:
        fail(f"serve {name}: /healthz {health}")
    if f"vault_requests_served {len(reqs) + 1}" not in metrics:
        fail(f"serve {name}: /metrics does not count {len(reqs) + 1} requests:\n{metrics}")
    batches = health["batches_run"] - 1
    if counts != {k: v * batches for k, v in launches.items()}:
        fail(f"serve {name}: launches {counts} for {batches} batches")
    direct = []
    with torch.inference_mode():
        for lo in range(0, len(reqs), 8):
            part = reqs[lo:lo + 8]
            enc = processor([im for _, _, im in part], [t for _, t, _ in part])
            enc = {k: pad_rows(v, 8) for k, v in enc.items()}
            direct.append(model(enc).float().cpu().numpy()[:len(part)])
    direct = np.concatenate(direct)
    got = np.asarray(results, np.float32)
    # the server and the direct forward run the same kernels on the same
    # batches, so a response equals its row bit for bit; the rows differ
    # from each other, so a response sent back to another request shows
    if (got.shape != direct.shape or not np.isfinite(direct).all()
            or not np.array_equal(got, direct)):
        err = float(np.abs(got - direct).max()) if got.shape == direct.shape else None
        fail(f"serve {name}: responses {got.shape} differ from the direct forward "
             f"{direct.shape}: max abs diff {err}")
    apart = np.abs(direct[:, None] - direct[None]).max(-1)
    row_gap = float(apart[~np.eye(len(direct), dtype=bool)].min())
    if row_gap == 0.0:
        fail(f"serve {name}: two requests got the same logits; the check cannot "
             "tell their responses apart")
    return dict(requests=len(reqs), batches=batches, launches=counts,
                bit_equal_vs_direct=True, min_row_gap=row_gap, wall_s=wall_s,
                stats=health)


def export_phase(name, model, cfg, dev, root: Path, launches):
    """The served forward exported at batch 8 (``vault_tpu_torch.export``),
    saved, loaded and run: logits bit-equal to the eager kernel path, the
    same launches, one ``vault_tpu_torch`` node per launch; the artifact's
    size, the wall ms of eager against loaded in turns, and where the host
    time of one forward goes in each (``host_profile``)."""
    import torch

    from vault_tpu_torch.export import export_forward, exported_ops, load_forward

    batch = entry_batch(cfg, 8, dev)
    path = root / f"{name}.pt2"
    with torch.inference_mode():
        reset_counts()
        eager = model(batch)
        torch.cuda.synchronize()
        eager_counts = read_counts()
    t0 = time.perf_counter()
    program = export_forward(model, (batch,), str(path))
    export_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    loaded = load_forward(str(path))
    load_s = time.perf_counter() - t0
    with torch.inference_mode():
        reset_counts()
        out = loaded(batch)
        torch.cuda.synchronize()
        counts = read_counts()
    if eager_counts != launches or counts != launches:
        fail(f"export {name}: launches eager {eager_counts}, loaded {counts}, "
             f"expected {launches}")
    if out.shape != eager.shape or not torch.equal(out, eager):
        fail(f"export {name}: loaded logits differ from the eager kernel path by "
             f"{(out.float() - eager.float()).abs().max().item()}")
    nodes = {}
    for op in exported_ops(program):
        nodes[op] = nodes.get(op, 0) + 1
    # one node per launch (the counters' names, "encoder_attention" the
    # operator "attention"); besides them only the fp32-output products
    want = {f"vault_tpu_torch.{'attention' if k == 'encoder_attention' else k}.default": n
            for k, n in launches.items() if n}
    if {k: v for k, v in nodes.items() if "matmul_fp32" not in k} != want:
        fail(f"export {name}: graph nodes {nodes} for launches {launches}")
    samples = {"eager": [], "loaded": []}
    with torch.inference_mode():
        for turn in ("eager", "loaded", "loaded", "eager"):
            fn = (lambda: model(batch)) if turn == "eager" else (lambda: loaded(batch))
            samples[turn] += [time_ms(fn, iters=5, warmup=1) for _ in range(2)]
        profiles = {"eager": host_profile(lambda: model(batch), top=6),
                    "loaded": host_profile(lambda: loaded(batch), top=6)}
    return dict(artifact_bytes=path.stat().st_size, export_s=export_s, load_s=load_s,
                launches=counts, graph_ops=nodes, bit_equal=True,
                eager_ms=float(np.median(samples["eager"])),
                loaded_ms=float(np.median(samples["loaded"])), ms_samples=samples,
                host_profile=profiles)


def same_npz(a: Path, b: Path) -> bool:
    """Two npz files hold the same keys and equal arrays."""
    with np.load(a) as za, np.load(b) as zb:
        return (sorted(za.files) == sorted(zb.files)
                and all(np.array_equal(za[k], zb[k]) for k in za.files))


def serve_phase(dev):
    """VAuLT-base served from checkpoint files: HF-layout directories
    written and loaded bit-equal, a fine-tuned npz quantized by
    ``cli.quantize_ckpt`` (w8a8, w8) on the card and equal to the same run
    on the CPU, five servers built by ``cli.serve`` answering HTTP, a
    refused composition, and the bf16 and w8a8 forwards exported, saved,
    loaded and run.  Returns each server's launches per served batch."""
    import tempfile

    import torch

    from vault_tpu_torch.cli import quantize_ckpt, serve
    from vault_tpu_torch.convert import params_to_jax
    from vault_tpu_torch.models.pretrained import load_torch_state_dict, load_vault_backbone
    from vault_tpu_torch.models.vault import VaultForClassification, init_classifier_head
    from vault_tpu_torch.presets import vault_base
    from vault_tpu_torch.training.checkpoint import save_checkpoint

    Path("build").mkdir(exist_ok=True)
    path_counts = {}
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory(dir="build", prefix="serve_") as tmp:
        root = Path(tmp)
        t0 = time.perf_counter()
        dirs = write_hf_dirs(root, layers=CUT_LAYERS)
        write_s = time.perf_counter() - t0
        vilt_dir, bert_dir, tweet_dir = (str(dirs[n][0]) for n in (
            "vilt-b32-mlm", "bert-base-uncased", "bertweet-base"))
        read_s = {}
        for name, (d, _, _) in dirs.items():
            t0 = time.perf_counter()
            load_torch_state_dict(str(d))
            read_s[name] = time.perf_counter() - t0
        loads = {}
        for tower_name, bert, cfg in (
                ("bertweet-base", tweet_dir, cut_depth(vault_base("bertweet-base"))),
                ("bert-base-uncased", bert_dir, cut_depth(vault_base()))):
            t0 = time.perf_counter()
            backbone = load_vault_backbone(cfg, torch.Generator().manual_seed(0),
                                           vilt_dir, bert)
            load_s = time.perf_counter() - t0
            model = VaultForClassification(cfg, device=dev)
            model.load_state_dict({**model.state_dict(), **backbone})
            check_loaded(model, "vilt", dirs["vilt-b32-mlm"][1])
            check_loaded(model, "bert", dirs[tower_name][1])
            loads[tower_name] = load_s
        # the fine-tuned checkpoint: the bert-base backbone just loaded, a
        # seeded head
        head = init_classifier_head(torch.Generator().manual_seed(1), cfg.vilt.hidden_size, 3)
        model.load_state_dict({**model.state_dict(),
                               **{f"head.{k}": v for k, v in head.state_dict().items()}})
        ft = root / "finetuned.npz"
        save_checkpoint(str(ft), {"params": params_to_jax(model.state_dict(),
                                                          as_numpy=False)})
        del model, backbone
        # quantized on the card (the CLI's default), and on the host to
        # hold the card's codes, scales and bf16 leaves against
        quantized, quantize_s, quantize_cpu_s = {}, {}, {}
        for mode in ("w8a8", "w8"):
            quantized[mode] = root / f"finetuned_{mode}.npz"
            argv = ["--vilt", vilt_dir, "--bert", bert_dir, "--ckpt", str(ft), "--mode", mode]
            t0 = time.perf_counter()
            quantize_ckpt.main(argv + ["--out", str(quantized[mode])])
            quantize_s[mode] = time.perf_counter() - t0
            on_cpu = root / f"finetuned_{mode}_cpu.npz"
            t0 = time.perf_counter()
            quantize_ckpt.main(argv + ["--out", str(on_cpu), "--device", "cpu"])
            quantize_cpu_s[mode] = time.perf_counter() - t0
            if not same_npz(quantized[mode], on_cpu):
                fail(f"serve: the {mode} checkpoint quantized on the card differs from "
                     "the one quantized on the CPU")
            on_cpu.unlink()
        emit(phase="serve", step="files", write_s=write_s, read_s=read_s,
             load_vault_backbone_s=loads, loaded_bit_equal=True,
             dir_bytes={n: v[2] for n, v in dirs.items()},
             npz_bytes={"finetuned": ft.stat().st_size,
                        **{m: p.stat().st_size for m, p in quantized.items()}},
             quantize_ckpt_s=quantize_s, quantize_ckpt_cpu_s=quantize_cpu_s,
             quantized_card_equals_cpu=True)

        fill = {"ft": str(ft), "w8a8": str(quantized["w8a8"]),
                "w8": str(quantized["w8"]), "bertweet": tweet_dir}
        shared = ["--vilt", vilt_dir, "--bert", bert_dir, "--port", "0",
                  "--max_batch", "8", "--max_wait_ms", "50"]
        for name, extra, launches, export in SERVE_CASES:
            args = serve.parse_args(shared + [a.format(**fill) for a in extra])
            t0 = time.perf_counter()
            model, processor, server = serve.build(args)
            torch.cuda.synchronize()
            build_s = time.perf_counter() - t0
            server.start()
            try:
                result = served_phase(name, model, processor, server, launches)
            finally:
                server.close()
            if server.engine._worker.is_alive():
                fail(f"serve {name}: the engine's worker did not stop")
            if export:
                result["export"] = export_phase(name, model, model.cfg, dev, root, launches)
            emit(phase="serve", step=name, build_s=build_s, quant_mode=model.quant_mode,
                 use_pallas=model.use_pallas, merge_to=model.merge_to, **result)
            path_counts[f"serve_{name}"] = launches
            del model, processor, server
            torch.cuda.empty_cache()

        refused = ["--n_classes", "3129", "--quantize", "w8a8", "--merge_to", str(MERGE_TO)]
        try:
            serve.build(serve.parse_args(shared + refused))
            code = 0
        except SystemExit as e:
            code = e.code
        if code != 2:
            fail(f"serve: a refused composition exited with {code}, expected 2")
        emit(phase="serve", step="refusal", argv=refused, exit_code=code)
    emit(phase="serve", step="total", seconds=time.perf_counter() - t_phase)
    return path_counts


# ---------------------------------------------------------------------------
# The paper's tasks and the remaining heads (the experiment CLI; MLM, VQA,
# retrieval, NLVR2)
# ---------------------------------------------------------------------------

# VQAv2's answer vocabulary as dandelin/vilt-b32-finetuned-vqa publishes it
VQA_ANSWERS = 3129
# Examples per task: 64 train (two steps of 32), 32 evaluated; retrieval
# pairs 16 texts with 16 images (32 training pairs, 256 evaluated).
TASK_TRAIN = 64
TASK_EVAL = 32
RETRIEVAL_IDS = 16
TASK_WORDS = SERVE_WORDS


def task_sentence(rng, n=12):
    return " ".join(rng.choice(TASK_WORDS, n))


def write_task_images(directory: Path, names, seed):
    """Seeded noise JPEGs of tweet-photo sizes (608 x 400 landscape, 400 x
    608 portrait), which the (384, 608) canvas holds after the resize."""
    from PIL import Image

    rng = np.random.default_rng(seed)
    directory.mkdir(parents=True, exist_ok=True)
    for i, name in enumerate(names):
        hw = (400, 608) if i % 4 else (608, 400)
        Image.fromarray(rng.integers(0, 256, (*hw, 3), dtype=np.uint8)).save(
            directory / name, quality=90)


def write_mvsa(root: Path):
    """MVSA-Single's layout: ``labelResultAll.txt`` (text and image labels),
    ``data/<id>.txt`` and ``data/<id>.jpg``."""
    rng = np.random.default_rng(21)
    d = root / "MVSA_Single"
    kinds = ["positive", "neutral", "negative"]
    ids = [str(i) for i in range(1, TASK_TRAIN + 1)]
    write_task_images(d / "data", [f"{i}.jpg" for i in ids], seed=22)
    with open(d / "labelResultAll.txt", "w") as f:
        f.write("ID\ttext,image\n")
        for i in ids:
            f.write(f"{i}\t{kinds[rng.integers(3)]},{kinds[rng.integers(3)]}\n")
    for i in ids:
        (d / "data" / f"{i}.txt").write_text(task_sentence(rng) + " #mynewcar @user")
    return d


def write_twitter(root: Path):
    """Twitter-2015's layout: ``<split>.tsv`` (id, label, image, tweet with
    $T$, target) and ``<dir>_images/``."""
    rng = np.random.default_rng(23)
    d, imgs = root / "twitter2015", root / "twitter2015_images"
    d.mkdir()
    write_task_images(imgs, [f"{i}.jpg" for i in range(16)] + ["17_06_4705.jpg"], seed=24)
    for split, n in (("train", TASK_TRAIN), ("dev", 16), ("test", 16)):
        with open(d / f"{split}.tsv", "w") as f:
            f.write("index\t#1 Label\t#2 ImageID\t#3 String\t#3 String\n")
            for i in range(n):
                f.write(f"{i}\t{rng.integers(3) - 1}\t{i % 16}.jpg\t"
                        f"{task_sentence(rng)} $T$ {task_sentence(rng, 4)}\t"
                        f"{task_sentence(rng, 2)}\n")
    return d


def task_launches(steps, eval_batches, images=1):
    """Kernel launches of ``steps`` training steps and ``eval_batches``
    evaluation batches, each forward run ``images`` times (the pair head)."""
    step, fwd = at_depth(STEP_LAUNCHES), at_depth(EVAL_LAUNCHES)
    return {k: images * (steps * step[k] + eval_batches * fwd[k]) for k in KERNEL_NAMES}


def task_path(name, tr, plain_fn, feats8, step_batch, run_counts, want, run_s,
              metrics, images=1, mlm_cfg=None, **extra):
    """What each task path reports: its run's launches against ``want``, one
    deterministic batch-8 forward on the kernel path held against the plain
    path (its launches too), every loss finite, then a training step's wall
    and busy ms and the card's idle share.

    The head's logits are held to ``FORWARD_LIMITS["logits"]``.  The MLM
    head (``mlm_cfg``, its model config) reads the text span of the last
    hidden state through a fixed 30,522-word product, so its logits reach
    about 2.7 where a bf16 ulp is 2^-6: they are held to that limit times
    max(1, max|plain logit|), and the backbone the kernels run is held as
    the ``forward`` phase holds it, its pooler within
    ``FORWARD_LIMITS["pooler"]``; the text span's distance is reported."""
    import torch

    from vault_tpu_torch.models.vault import batch_to_device, vault_apply

    if run_counts != want:
        fail(f"tasks {name}: launches {run_counts}, expected {want}")
    losses = {k: v for k, v in metrics.items() if "loss" in k}
    if not losses or not all(math.isfinite(v) for v in losses.values()):
        fail(f"tasks {name}: losses {losses}")
    tree = tr.compute_params({k: v.detach() for k, v in tr.params.items()})
    batch = batch_to_device({k: v for k, v in feats8.items() if k != "label_weights"},
                            tr.device)
    with torch.inference_mode():
        reset_counts()
        out = tr.apply_fn(tree, batch, True, None)
        torch.cuda.synchronize()
        fwd_counts = read_counts()
        ref = plain_fn(tree, batch, True, None).float()
        backbone = {}
        if mlm_cfg is not None:
            if out.dtype != torch.float32 or tuple(out.shape) != (
                    8, batch["input_ids"].shape[1], mlm_cfg.vilt.vocab_size):
                fail(f"tasks {name}: logits {out.dtype} {tuple(out.shape)}")
            k_out, p_out = (vault_apply(tree, mlm_cfg, use_pallas=sel, **batch)
                            for sel in (tr.args.use_pallas, False))
            span = batch["input_ids"].shape[1]
            k_text = k_out.last_hidden_state[:, :span].float()
            p_text = p_out.last_hidden_state[:, :span].float()
            backbone = {
                "pooler_max_abs_err": (k_out.pooler_output.float()
                                       - p_out.pooler_output.float()).abs().max().item(),
                "text_hidden_max_abs_err": (k_text - p_text).abs().max().item(),
                "text_hidden_max_abs": p_text.abs().max().item()}
            del k_out, p_out, k_text, p_text
        out = out.float()
    want_fwd = {k: images * v for k, v in at_depth(EVAL_LAUNCHES).items()}
    if fwd_counts != want_fwd:
        fail(f"tasks {name}: launches of a batch-8 forward {fwd_counts}, expected {want_fwd}")
    if not bool(torch.isfinite(out).all()):
        fail(f"tasks {name}: the batch-8 forward is not finite")
    err = (out - ref).abs().max().item()
    scale = max(1.0, ref.abs().max().item()) if mlm_cfg is not None else 1.0
    limit = FORWARD_LIMITS["logits"] * scale
    if err > limit:
        fail(f"tasks {name}: kernel path vs plain path, logits {err} (limit {limit})")
    if backbone and backbone["pooler_max_abs_err"] > FORWARD_LIMITS["pooler"]:
        fail(f"tasks {name}: kernel path vs plain path, pooler "
             f"{backbone['pooler_max_abs_err']} (limit {FORWARD_LIMITS['pooler']})")
    del tree, out, ref
    b, lab, w = tr._to_device(*tr._pad(*step_batch))
    step = lambda: tr.train_step(b, lab, w, 1000)
    step()
    torch.cuda.synchronize()
    samples = [time_ms(step, iters=1, warmup=0) for _ in range(3)]
    busy, kernels = device_ms(step, iters=2, warmup=0)
    ms = float(np.median(samples))
    emit(phase="tasks", path=name, run_s=run_s, launches=run_counts,
         launches_per_forward=fwd_counts, logits_max_abs_err=err, logits_scale=scale,
         limit=limit, **backbone, step_ms=ms, step_ms_samples=samples,
         device_busy_ms=busy, idle_share=1.0 - busy / ms,
         top_kernels_ms=dict(sorted(kernels.items(), key=lambda kv: -kv[1])[:6]),
         peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9, metrics=metrics, **extra)
    torch.cuda.reset_peak_memory_stats()


def cli_paths(root: Path, dirs):
    """``cli.clsf_vault.main`` in process on MVSA (dual heads) and
    Twitter201X: one epoch over 64 examples, a dev and a test evaluation,
    the backbone from the HF-layout directories."""
    import torch

    from vault_tpu_torch.cli import clsf_vault
    from vault_tpu_torch.training.trainer import classifier_apply_fn

    shared = ["--vilt_model_name_or_path", str(dirs["vilt-b32-mlm"][0]),
              "--bert_model_name_or_path", str(dirs["bert-base-uncased"][0]),
              "--canvas", "384x608", "--num_train_epochs", "1", "--disable_tqdm",
              "--experiment_root", str(root / "logs")]
    cases = {
        "cli_mvsa": (["MVSA", "--root_dir", str(write_mvsa(root)),
                      "--train_split", "train", "dev", "test", "--val_split", "dev",
                      "--test_split", "test"], "VaultTMSCMVSA"),
        "cli_twitter201x": (["Twitter201X", "--dir", str(write_twitter(root)),
                             "--train_split", "train", "--dev_split", "dev",
                             "--test_split", "test"], "VaultTMSCTwitter201X"),
    }
    counts = {}
    for name, (argv, exp) in cases.items():
        reset_counts()
        t0 = time.perf_counter()
        (tr,) = clsf_vault.main(argv + shared)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        run_counts = read_counts()
        eval_batches = sum(ds.num_batches(tr.args.eval_batch_size)
                           for ds in (tr.dev_dataset, tr.test_dataset))
        want = task_launches(tr.train_dataset.num_batches(TRAIN_BATCH), eval_batches)
        logs = Path(tr.exp_handler.directory())
        if not (logs / "aggregated_metrics.yml").exists() or logs.parent.name != exp:
            fail(f"tasks {name}: no aggregated_metrics.yml under {logs}")
        h = tr.exp_handler
        metrics = {**{k: v[-1] for k, v in h._series.items()}, **h._finals}
        feats, labels = next(tr.train_dataset.batches(TRAIN_BATCH))
        eight = {k: v[:8] for k, v in feats.items()}
        run_cfg = clsf_vault.model_config(clsf_vault.parse_args(argv + shared))
        plain = classifier_apply_fn(run_cfg, dataclasses.replace(tr.args, use_pallas=False))
        task_path(name, tr, plain, eight, (feats, labels), run_counts, want, run_s, metrics,
                  argv=argv[:1], logs=str(logs), aggregated_metrics=True,
                  train_examples=tr.train_dataset.num_examples, eval_batches=eval_batches)
        counts[name] = run_counts
        del tr
        torch.cuda.empty_cache()
    return counts


def head_paths(dev, root: Path, dirs):
    """MLM, VQA, retrieval and NLVR2 through their trainers at full width:
    seeded random weights, ``TrainArgs`` defaults (batch 32, remat, bf16
    compute, dropout 0.1 in BERT)."""
    import json as json_mod

    import torch

    from vault_tpu_torch.data.loader import InMemoryDataset
    from vault_tpu_torch.data.nlvr2 import Nlvr2Dataset
    from vault_tpu_torch.data.processor import VaultProcessor
    from vault_tpu_torch.data.retrieval import RetrievalDataset
    from vault_tpu_torch.data.vqa_dataset import VqaDataset
    from vault_tpu_torch.models import vault as vm
    from vault_tpu_torch.models.pretrained import build_tokenizer
    from vault_tpu_torch.presets import vault_base
    from vault_tpu_torch.training import trainer as trm
    from vault_tpu_torch.training.mlm import mask_tokens, mlm_accuracy, mlm_loss
    from vault_tpu_torch.training.task_trainers import (
        ImagesAndTextTrainer,
        RetrievalTrainer,
        VqaTrainer,
    )

    class MlmTrainer(trm.Trainer):
        """The Trainer with the MLM loss and masked accuracy (the JAX
        package has no MLM trainer either: ``training/mlm.py`` gives them).
        The evaluation keeps each row's logits for ``mlm_accuracy``."""

        def calculate_loss(self, logits, labels, weight, train):
            return mlm_loss(logits, labels, weight)

        def get_eval_preds(self, logits):
            return list(logits)

        def evaluation_metrics(self, y_true, y_pred):
            acc = mlm_accuracy(torch.from_numpy(np.stack(y_pred)),
                               torch.from_numpy(np.stack(y_true)))
            return {"mlm_accuracy": acc.item()}

    cfg = cut_depth(vault_base("bert-base-uncased"))
    tok = build_tokenizer(str(dirs["bert-base-uncased"][0]))
    proc = VaultProcessor(tok, canvas=(384, 608))
    vcfg = cfg.resolved_vilt()

    def params(seed, head_key, head):
        gen = torch.Generator().manual_seed(seed)
        sd = vm.init_vault(gen, cfg).state_dict()
        if head_key == "pair":
            sd.update({f"vilt.{k}": v for k, v in vm.resize_modality_type_embeddings(
                {"modality_type": sd["vilt.modality_type"]}, 2).items()})
        sd.update({f"{head_key}.{k}": v for k, v in head(gen).state_dict().items()})
        return sd

    def run(trainer_cls, factory, sd, train_ds, test_ds, eval_batches, epochs=1, images=1,
            max_steps=-1):
        """Train on ``train_ds``, then evaluate ``test_ds`` once."""
        args = train_args(num_train_epochs=epochs, max_steps=max_steps)
        tr = trainer_cls(factory(cfg, args), sd, args, train_ds, test_dataset=test_ds,
                         device=dev)
        reset_counts()
        t0 = time.perf_counter()
        tr.train()
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        counts = read_counts()
        steps = epochs * train_ds.num_batches(TRAIN_BATCH)
        steps = min(steps, max_steps) if max_steps > 0 else steps
        h = tr.exp_handler
        metrics = {**{k: v[-1] for k, v in h._series.items()}, **h._finals}
        feats, labels = next(train_ds.batches(TRAIN_BATCH))
        eight = {k: v[:8] for k, v in feats.items()}
        plain = factory(cfg, train_args(use_pallas=False))
        return tr, plain, eight, (feats, labels), counts, \
            task_launches(steps, eval_batches, images), run_s, metrics

    out = {}
    # MLM: ViLT-B/32's 30,522-word vocabulary, the decoder tied to ViLT's
    # word table; three steps, then mlm_accuracy on an evaluation batch
    feats, _ = entry_features(cfg, TASK_TRAIN + TRAIN_BATCH, seed=31)
    special = (feats["attention_mask"] == 0)
    special[:, 0] = True
    ids, labels = mask_tokens(torch.Generator().manual_seed(32),
                              torch.from_numpy(feats["input_ids"]).long(),
                              torch.from_numpy(special.astype(np.int32)),
                              tok.mask_token_id, cfg.vilt.vocab_size)
    feats["input_ids"] = ids.numpy()
    labels = labels.numpy()
    n = TASK_TRAIN
    train_ds, eval_ds = (InMemoryDataset({k: v[sl] for k, v in feats.items()}, labels[sl])
                         for sl in (slice(0, n), slice(n, None)))
    sd = params(41, "mlm", lambda g: vm.init_mlm_head(g, vcfg))
    res = run(MlmTrainer, trm.mlm_apply_fn, sd, train_ds, eval_ds, 1, epochs=2, max_steps=3)
    task_path("mlm", *res, mlm_cfg=cfg, vocab=cfg.vilt.vocab_size,
              masked_share=float((labels != -100).mean()))
    out["mlm"] = res[4]
    del res
    torch.cuda.empty_cache()

    # VQA: VQAv2-format questions and annotations over a 3,129-answer vocabulary
    rng = np.random.default_rng(33)
    vqa = root / "vqa"
    write_task_images(vqa / "images", [f"{i}.jpg" for i in range(16)], seed=34)
    label2id = {f"answer {i}": i for i in range(VQA_ANSWERS)}
    for split, n_q in (("train", TASK_TRAIN), ("val", TASK_EVAL)):
        qs = [{"question_id": i, "image_id": i % 16, "question": task_sentence(rng, 8)}
              for i in range(n_q)]
        anns = [{"question_id": i, "image_id": i % 16,
                 "answers": [{"answer": f"answer {rng.integers(VQA_ANSWERS)}"}
                             for _ in range(10)]} for i in range(n_q) if i % 8]
        (vqa / f"{split}_q.json").write_text(json_mod.dumps({"questions": qs}))
        (vqa / f"{split}_a.json").write_text(json_mod.dumps({"annotations": anns}))
    ds = {split: VqaDataset(str(vqa / f"{split}_q.json"), str(vqa / f"{split}_a.json"),
                            str(vqa / "images"), proc, label2id=label2id)
          for split in ("train", "val")}
    sd = params(42, "vqa", lambda g: vm.init_vqa_head(g, vcfg, VQA_ANSWERS))
    res = run(VqaTrainer, trm.vqa_apply_fn, sd, ds["train"], ds["val"],
              ds["val"].num_batches(TRAIN_BATCH))
    task_path("vqa", *res, answers=VQA_ANSWERS,
              unlabeled_rows=int((ds["train"].label_weights == 0).sum()))
    out["vqa"] = res[4]
    del res
    torch.cuda.empty_cache()

    # retrieval: 16 texts and their images, one sampled negative each
    write_task_images(root / "retrieval", [f"{i}.jpg" for i in range(RETRIEVAL_IDS)], seed=35)
    rds = RetrievalDataset([f"r{i}" for i in range(RETRIEVAL_IDS)],
                           [task_sentence(rng) for _ in range(RETRIEVAL_IDS)],
                           [str(root / "retrieval" / f"{i}.jpg")
                            for i in range(RETRIEVAL_IDS)], proc, seed=36)
    sd = params(43, "rank", lambda g: vm.init_rank_head(g, vcfg))
    # two epochs of one step; the evaluation scores all 16 x 16 pairs
    res = run(RetrievalTrainer, trm.retrieval_apply_fn, sd, rds, rds,
              -(-RETRIEVAL_IDS ** 2 // TRAIN_BATCH), epochs=2)
    if not all(f"test_{kind}-R@{k}" in res[7] for kind in ("image", "text")
               for k in (1, 5, 10)):
        fail(f"tasks retrieval: no R@k in {sorted(res[7])}")
    task_path("retrieval", *res, pairs_evaluated=RETRIEVAL_IDS ** 2)
    out["retrieval"] = res[4]
    del res
    torch.cuda.empty_cache()

    # NLVR2: the pair head over two images per example (two backbone passes)
    nl = root / "nlvr2"
    write_task_images(nl / "images", [f"dev-{i}-0-img{s}.png" for i in range(TASK_TRAIN)
                                      for s in (0, 1)][:32], seed=37)
    for split, n_r in (("train", TASK_TRAIN), ("dev", TASK_EVAL)):
        recs = [{"identifier": f"dev-{i % 16}-0-{i}", "sentence": task_sentence(rng),
                 "label": "True" if rng.integers(2) else "False"} for i in range(n_r)]
        (nl / f"{split}.jsonl").write_text("\n".join(json_mod.dumps(r) for r in recs))
    ds = {split: Nlvr2Dataset(str(nl / f"{split}.jsonl"), str(nl / "images"), proc)
          for split in ("train", "dev")}
    sd = params(44, "pair", lambda g: vm.init_pair_head(g, vcfg))
    res = run(ImagesAndTextTrainer, trm.images_and_text_apply_fn, sd, ds["train"],
              ds["dev"], ds["dev"].num_batches(TRAIN_BATCH), images=2)
    task_path("nlvr2", *res, images=2)
    out["nlvr2"] = res[4]
    del res
    torch.cuda.empty_cache()
    return out


def tasks_phase(dev):
    """The tasks group: the experiment CLI and the four remaining heads,
    each path's launches, its forward against the plain path and its step
    times (``task_path``).  Returns each path's launches."""
    import tempfile

    Path("build").mkdir(exist_ok=True)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir="build", prefix="tasks_") as tmp:
        root = Path(tmp)
        dirs = write_hf_dirs(root, names=("bert-base-uncased", "vilt-b32-mlm"),
                             layers=CUT_LAYERS)
        counts = cli_paths(root, dirs)
        counts.update(head_paths(dev, root, dirs))
    emit(phase="tasks", step="total", seconds=time.perf_counter() - t0)
    return {f"tasks_{k}": v for k, v in counts.items()}


# ---------------------------------------------------------------------------
# The baselines group: TomBERT and TomViLT (the paper's baselines) at the
# reference's default configuration, bert-base-uncased text stacks, one
# cross layer, a frozen ResNet-101 at a 224 crop (49 regions of 2,048),
# 64 tweet+target and 16 target tokens, TomViLT on ViLT-B/32 with the tweet
# tower; through ``python -m vault_tpu_torch.cli.tmsc_tombert`` in process.
# ---------------------------------------------------------------------------

RESNET_DEPTH = 101
# Encoder attention lengths on the baselines' path: the target (16), ViLT
# in TomViLT (40 text + 16 attended tokens), the tweet+target pair (64) and
# TomBERT's multimodal stack (the pooled visual token + 64).
BASELINE_ATTENTION_L = (16, 56, 64, 65)
# Kernel launches of the baselines' paths.  TomBERT: the
# tweet, target and multimodal stacks have 12 layers each, the cross layer
# one post-LN MLP block (its attention stays on the plain composition, as
# the JAX package keeps it on XLA).  TomViLT: the target stack and VAuLT's
# BERT 12 layers each, the cross layer, ViLT's 12 pre-LN layers.  Neither
# trains with remat; in a step attention takes its kernels where no dropout
# is drawn: ViLT's layers only.
TOMBERT_EVAL_LAUNCHES = launches(encoder_attention=36, mlp_postln=37)
TOMBERT_STEP_LAUNCHES = launches(mlp_postln=37, mlp_postln_bwd=37)
TOMVILT_EVAL_LAUNCHES = launches(encoder_attention=36, mlp_postln=25, mlp_block=12)
TOMVILT_STEP_LAUNCHES = launches(encoder_attention=12, attention_bwd=12, mlp_postln=25,
                                 mlp_block=12, mlp_postln_bwd=25, mlp_block_bwd=12)
TOMVILT_NO_TWEET_EVAL_LAUNCHES = launches(encoder_attention=24, mlp_postln=13, mlp_block=12)
# ResNet-101 region features on the card against the same fp32 tree on the
# host (TF32 off): max |card - host| over the features' largest magnitude.
RESNET_LIMIT = 1e-4


def check_baseline_attention(gen, dev):
    """The encoder-attention kernel at the baselines' lengths (batch 8, 12
    heads, head dim 64, bf16, a ragged key mask), against its plain
    version: the bf16 limit, the per-row gate with its fp8 control, timed
    beside the plain version and ``scaled_dot_product_attention``."""
    import torch
    import torch.nn.functional as F

    from vault_tpu_torch.ops import cuda_attention as ca

    rows = []
    for l in BASELINE_ATTENTION_L:
        q, k, v, bias = attention_case(gen, 8, 12, l, torch.bfloat16, dev, fused=True)
        out, again = ca.fused_attention(q, k, v, bias), ca.fused_attention(q, k, v, bias)
        ref = ca.attention_plain(q, k, v, bias)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        if not math.isfinite(err) or err > LIMITS["bfloat16"]:
            fail(f"baselines attention L {l}: max |kernel - plain| {err} > {LIMITS['bfloat16']}")
        if not torch.equal(out, again):
            fail(f"baselines attention L {l}: two launches differ")
        row = dict(kernel="encoder_attention", path="baselines", shape=[8, 12, l, 64],
                   dtype="bfloat16", max_abs_err=err, limit=LIMITS["bfloat16"],
                   bit_equal_repeat=True, route=ca.attention_route(torch.bfloat16))
        check_attention_rows("baselines attention", (8, 12, l, 64), q, k, v, bias, out, ref,
                             row)
        allowed = bias > -1.0
        timed(lambda: ca.fused_attention(q, k, v, bias), "", row)
        timed(lambda: ca.attention_plain(q, k, v, bias), "plain_", row)
        timed(lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=allowed),
              "library_", row)
        row["bound_ms"], row["bound_by"] = bound_ms(4.0 * 8 * 12 * l * l * 64,
                                                    4.0 * q.numel() * 2 + bias.numel() * 4,
                                                    torch.bfloat16)
        check_route("encoder_attention", row)
        emit(phase="baselines", step="attention", **row)
        rows.append(row)
    return rows


def write_torchvision_resnet(path: Path, depth=RESNET_DEPTH, seed=31):
    """A torchvision-layout ResNet state dict from seeded numpy, saved with
    ``torch.save``: He-normal convolutions, BatchNorm weights about 1 (each
    block's last one about 0.2, damping the residual growth that running
    statistics of 0 and 1 do not normalize), biases and running means
    about 0, running variances about 1.  Returns the state dict."""
    import torch

    from vault_tpu_torch.models.resnet import RESNET_LAYERS

    rng = np.random.default_rng(seed)
    kind, blocks = RESNET_LAYERS[depth]
    sd = {}

    def conv(name, o, i, k):
        w = rng.standard_normal((o, i, k, k), dtype=np.float32) * np.float32(
            math.sqrt(2.0 / (i * k * k)))
        sd[f"{name}.weight"] = torch.from_numpy(w)

    def bn(name, c, gamma=1.0):
        noise = lambda s: rng.standard_normal(c, dtype=np.float32) * np.float32(s)
        sd[f"{name}.weight"] = torch.from_numpy(np.float32(gamma) * (1 + noise(0.05)))
        sd[f"{name}.bias"] = torch.from_numpy(noise(0.02))
        sd[f"{name}.running_mean"] = torch.from_numpy(noise(0.02))
        sd[f"{name}.running_var"] = torch.from_numpy(
            rng.uniform(0.9, 1.1, c).astype(np.float32))
        sd[f"{name}.num_batches_tracked"] = torch.tensor(0)

    conv("conv1", 64, 3, 7)
    bn("bn1", 64)
    in_c, expansion = 64, 1 if kind == "basic" else 4
    for s, (w, n) in enumerate(zip([64, 128, 256, 512], blocks)):
        for b in range(n):
            pre, out_c = f"layer{s + 1}.{b}", w * expansion
            if kind == "basic":
                conv(f"{pre}.conv1", w, in_c, 3), bn(f"{pre}.bn1", w)
                conv(f"{pre}.conv2", w, w, 3), bn(f"{pre}.bn2", w, 0.2)
            else:
                conv(f"{pre}.conv1", w, in_c, 1), bn(f"{pre}.bn1", w)
                conv(f"{pre}.conv2", w, w, 3), bn(f"{pre}.bn2", w)
                conv(f"{pre}.conv3", out_c, w, 1), bn(f"{pre}.bn3", out_c, 0.2)
            if b == 0:
                conv(f"{pre}.downsample.0", out_c, in_c, 1)
                bn(f"{pre}.downsample.1", out_c)
            in_c = out_c
    sd["fc.weight"] = torch.zeros(1000, in_c)
    sd["fc.bias"] = torch.zeros(1000)
    torch.save(sd, path)
    return sd


def check_resnet_features(dev, pth: Path, images):
    """ResNet-101 region features of 8 preprocessed images on the card
    against the same tree on the host (fp32, TF32 off), within
    ``RESNET_LIMIT`` of the features' scale; the 32-image cache batch
    timed on the card."""
    import torch

    from vault_tpu_torch.convert import param_tree
    from vault_tpu_torch.models.pretrained import load_resnet_tower
    from vault_tpu_torch.models.resnet import resnet_features

    sd = load_resnet_tower(str(pth), RESNET_DEPTH)
    host = param_tree(sd)
    card = param_tree({k: v.to(dev) for k, v in sd.items()})
    x = torch.from_numpy(np.ascontiguousarray(images[:8]))
    with torch.inference_mode():
        t0 = time.perf_counter()
        ref = resnet_features(host, RESNET_DEPTH, x)
        host_s = time.perf_counter() - t0
        out = resnet_features(card, RESNET_DEPTH, x.to(dev)).cpu()
        if tuple(out.shape) != (8, 49, 2048):
            fail(f"baselines ResNet-101 features {tuple(out.shape)}, expected (8, 49, 2048)")
        scale = ref.abs().max().item()
        err = (out - ref).abs().max().item() / scale
        if not math.isfinite(err) or err > RESNET_LIMIT:
            fail(f"baselines ResNet-101 card vs host: {err} of the scale > {RESNET_LIMIT}")
        x32 = torch.from_numpy(np.ascontiguousarray(images[:32])).to(dev)
        fn = lambda: resnet_features(card, RESNET_DEPTH, x32)
        busy, kernels = device_ms(fn, iters=3, warmup=1)
        wall = time_ms(fn, iters=3, warmup=0)
    emit(phase="baselines", step="resnet101", rows=8, max_rel_err=err, limit=RESNET_LIMIT,
         scale=scale, host_s=host_s, batch32_device_ms=busy, batch32_wall_ms=wall,
         top_kernels_ms=dict(sorted(kernels.items(), key=lambda kv: -kv[1])[:4]))


def baseline_step_vs_plain(name, tr, plain_fn, batch, lab, w):
    """One batch-32 step's loss and gradients on the kernel path against the
    plain path (the same masters, batch and generator seed: the dropout
    streams match), under ``STEP_LIMITS``; returns the kernel path's
    launches.  Leaves the loss does not reach get no gradient on either
    path (a frozen ResNet, ViLT's image path)."""
    import torch

    kernel_fn = tr.apply_fn
    res = {}
    for path, fn in (("kernel", kernel_fn), ("plain", plain_fn)):
        tr.apply_fn = fn
        gen = tr.step_generator(0)
        reset_counts()
        loss, grads = tr.loss_and_grads(batch, lab, w, gen)
        torch.cuda.synchronize()
        res[path] = dict(loss=loss.item(), grads=grads, counts=read_counts(),
                         gen=gen.get_state())
    tr.apply_fn = kernel_fn
    kern, plain = res["kernel"], res["plain"]
    if any(plain["counts"].values()):
        fail(f"baselines {name}: the plain path launched kernels {plain['counts']}")
    if not torch.equal(kern["gen"], plain["gen"]):
        fail(f"baselines {name}: the paths drew different dropout streams")
    rel, _, bad = grad_rel(kern["grads"], plain["grads"], tr.apply_fn.unreached)
    if bad:
        fail(f"baselines {name}: leaves with an unexpected gradient: {bad[:8]}")
    worst = sorted(rel.items(), key=lambda kv: -kv[1])[:5]
    loss_diff = abs(kern["loss"] - plain["loss"])
    if loss_diff > STEP_LIMITS["loss"] or worst[0][1] > STEP_LIMITS["grad_rel"]:
        fail(f"baselines {name} step kernel path vs plain path: loss diff {loss_diff}, "
             f"worst leaves {worst} (limits {STEP_LIMITS})")
    return kern["counts"], dict(loss_kernel_path=kern["loss"], loss_abs_diff=loss_diff,
                                grad_rel_worst=worst, leaves_checked=len(rel),
                                grad_rel_median=float(np.median(list(rel.values()))))


def baseline_cli_path(name, argv, want_eval, want_step, plain_fn_of):
    """``cli.tmsc_tombert.main`` in process (one epoch over 64 examples, a
    dev and a test evaluation): its launches, one frozen-cache computation
    per split, a batch-8 evaluation forward and a batch-32 step each held
    against the plain path, the step's wall and busy ms, idle share and
    peak memory."""
    import torch

    from vault_tpu_torch.cli import tmsc_tombert
    from vault_tpu_torch.data.tombert_dataset import TomBertTmscDataset
    from vault_tpu_torch.models.vault import batch_to_device

    caches = {}
    replace = TomBertTmscDataset.replace_images_with_embeddings

    def counted(ds, embeddings):
        caches[ds.name] = caches.get(ds.name, 0) + 1
        return replace(ds, embeddings)

    TomBertTmscDataset.replace_images_with_embeddings = counted
    try:
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t0 = time.perf_counter()
        (tr,) = tmsc_tombert.main(argv)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        run_counts = read_counts()
    finally:
        TomBertTmscDataset.replace_images_with_embeddings = replace
    splits = (tr.train_dataset, tr.dev_dataset, tr.test_dataset)
    if sorted(caches.values()) != [1, 1, 1] or any(
            ds.embeddings is None or ds._emb_src is not tr.resnet_params for ds in splits):
        fail(f"baselines {name}: frozen-cache computations per split {caches}")
    if any(ds.embeddings.shape[1:] != (49, 2048) for ds in splits):
        fail(f"baselines {name}: cached regions {splits[0].embeddings.shape}")
    steps = tr.train_dataset.num_batches(TRAIN_BATCH)
    eval_batches = sum(ds.num_batches(tr.args.eval_batch_size) for ds in splits[1:])
    want = {k: steps * want_step[k] + eval_batches * want_eval[k] for k in KERNEL_NAMES}
    if run_counts != want:
        fail(f"baselines {name}: launches {run_counts}, expected {want}")
    h = tr.exp_handler
    metrics = {**{k: v[-1] for k, v in h._series.items()}, **h._finals}
    losses = {k: v for k, v in metrics.items() if "loss" in k}
    if not losses or not all(math.isfinite(v) for v in losses.values()):
        fail(f"baselines {name}: losses {losses}")
    if not (Path(h.directory()) / "aggregated_metrics.yml").exists():
        fail(f"baselines {name}: no aggregated_metrics.yml under {h.directory()}")
    peak_run = torch.cuda.max_memory_allocated() / 1e9

    plain_fn = plain_fn_of(tr)
    tree = tr.compute_params({k: v.detach() for k, v in tr.params.items()})
    feats, _ = next(tr.dev_dataset.batches(8))
    batch8 = batch_to_device(feats, tr.device)
    with torch.inference_mode():
        reset_counts()
        out = tr.apply_fn(tree, batch8, True, None)
        torch.cuda.synchronize()
        fwd_counts = read_counts()
        ref = plain_fn(tree, batch8, True, None)
        fwd_ms = time_ms(lambda: tr.apply_fn(tree, batch8, True, None), iters=5)
        plain_fwd_ms = time_ms(lambda: plain_fn(tree, batch8, True, None), iters=5)
    if fwd_counts != want_eval:
        fail(f"baselines {name}: launches of a batch-8 forward {fwd_counts}, expected "
             f"{want_eval}")
    out, ref = out.float(), ref.float()
    if not bool(torch.isfinite(out).all()) or tuple(out.shape) != (8, 3):
        fail(f"baselines {name}: the batch-8 forward {tuple(out.shape)} is not finite")
    err = (out - ref).abs().max().item()
    if err > FORWARD_LIMITS["logits"]:
        fail(f"baselines {name}: kernel path vs plain path, logits {err} "
             f"(limit {FORWARD_LIMITS['logits']})")
    del tree

    feats, labels = next(tr.train_dataset.batches(TRAIN_BATCH))
    b, lab, w = tr._to_device(*tr._pad(feats, labels))
    step_counts, step_cmp = baseline_step_vs_plain(name, tr, plain_fn, b, lab, w)
    if step_counts != want_step:
        fail(f"baselines {name}: launches of a training step {step_counts}, expected "
             f"{want_step}")
    torch.cuda.reset_peak_memory_stats()
    step = lambda: tr.train_step(b, lab, w, 1000)
    step()
    torch.cuda.synchronize()
    samples = [time_ms(step, iters=1, warmup=0) for _ in range(3)]
    busy, kernels = device_ms(step, iters=2, warmup=0)
    ms = float(np.median(samples))
    emit(phase="baselines", path=name, run_s=run_s, launches=run_counts,
         cache_computations=caches, launches_per_forward=fwd_counts,
         launches_per_step=step_counts, logits_max_abs_err=err,
         limit=FORWARD_LIMITS["logits"], forward8_ms=fwd_ms, plain_forward8_ms=plain_fwd_ms,
         **step_cmp, step_limits=STEP_LIMITS, step_ms=ms, step_ms_samples=samples,
         device_busy_ms=busy, idle_share=1.0 - busy / ms,
         top_kernels_ms=dict(sorted(kernels.items(), key=lambda kv: -kv[1])[:6]),
         peak_mem_gb_run=peak_run, peak_mem_gb_step=torch.cuda.max_memory_allocated() / 1e9,
         params_m=sum(v.numel() for v in tr.params.values()) / 1e6,
         metrics=metrics, logs=h.directory())
    return tr, run_counts


def tomvilt_no_tweet_forward(tr, vault_cfg, text_cfg):
    """TomViLT without the tweet tower (``use_tweet_bert`` off: ViLT reads
    the token ids with its own word table), on the trained TomViLT's
    parameters: a batch-8 forward's launches and its logits against the
    plain path."""
    import dataclasses as dc

    import torch

    from vault_tpu_torch.models.vault import batch_to_device
    from vault_tpu_torch.training.task_trainers import tomvilt_apply_fn

    cfg = dc.replace(vault_cfg, text_tower=None)
    fns = {impl: tomvilt_apply_fn(cfg, text_cfg, RESNET_DEPTH, use_pallas=impl)
           for impl in ("auto", False)}
    tree = tr.compute_params({k: v.detach() for k, v in tr.params.items()
                              if not k.startswith("vault.bert.")})
    feats, _ = next(tr.dev_dataset.batches(8))
    batch8 = batch_to_device(feats, tr.device)
    with torch.inference_mode():
        reset_counts()
        out = fns["auto"](tree, batch8, True, None).float()
        torch.cuda.synchronize()
        counts = read_counts()
        ref = fns[False](tree, batch8, True, None).float()
    if counts != TOMVILT_NO_TWEET_EVAL_LAUNCHES:
        fail(f"baselines tomvilt without the tweet tower: launches {counts}, expected "
             f"{TOMVILT_NO_TWEET_EVAL_LAUNCHES}")
    err = (out - ref).abs().max().item()
    if not bool(torch.isfinite(out).all()) or err > FORWARD_LIMITS["logits"]:
        fail(f"baselines tomvilt without the tweet tower: logits {err} "
             f"(limit {FORWARD_LIMITS['logits']})")
    emit(phase="baselines", path="tomvilt_no_tweet_forward", launches_per_forward=counts,
         logits_max_abs_err=err, limit=FORWARD_LIMITS["logits"])
    return counts


def baselines_phase(dev):
    """The baselines group: the attention kernel at the baselines' lengths,
    the ResNet-101 features on the card against the host, then TomBERT and
    TomViLT through the CLI on full-width files under a temporary
    ``build/baselines_*``.  Returns each path's launches."""
    import tempfile

    import torch

    from vault_tpu_torch.cli import tmsc_tombert
    from vault_tpu_torch.training.task_trainers import tombert_apply_fn, tomvilt_apply_fn

    Path("build").mkdir(exist_ok=True)
    t0 = time.perf_counter()
    check_baseline_attention(torch.Generator(device=dev).manual_seed(15), dev)
    counts = {}
    with tempfile.TemporaryDirectory(dir="build", prefix="baselines_") as tmp:
        root = Path(tmp)
        dirs = write_hf_dirs(root, names=("bert-base-uncased", "vilt-b32-mlm"))
        pth = root / "resnet101.pth"
        write_torchvision_resnet(pth)
        twitter = write_twitter(root)
        shared = ["--dir", str(twitter), "--train_split", "train", "--dev_split", "dev",
                  "--test_split", "test", "--model_name_or_path",
                  str(dirs["bert-base-uncased"][0]), "--resnet_weights", str(pth),
                  "--num_train_epochs", "1", "--disable_tqdm",
                  "--experiment_root", str(root / "logs")]
        argv = ["TomBERT"] + shared
        args = tmsc_tombert.parse_args(argv)
        text_cfg = tmsc_tombert.text_config(args)
        tr, counts["baselines_tombert_cli"] = baseline_cli_path(
            "tombert_cli", argv, TOMBERT_EVAL_LAUNCHES, TOMBERT_STEP_LAUNCHES,
            lambda tr: tombert_apply_fn(text_cfg, args.pooling, RESNET_DEPTH,
                                        use_pallas=False))
        check_resnet_features(dev, pth, tr.train_dataset.images)
        del tr
        torch.cuda.empty_cache()

        argv = ["TomViLT", "--use_tweet_bert", "--vilt_model_name_or_path",
                str(dirs["vilt-b32-mlm"][0])] + shared
        args = tmsc_tombert.parse_args(argv)
        vault_cfg = tmsc_tombert.vault_config(args, text_cfg)

        tr, counts["baselines_tomvilt_cli"] = baseline_cli_path(
            "tomvilt_cli", argv, TOMVILT_EVAL_LAUNCHES, TOMVILT_STEP_LAUNCHES,
            lambda tr: tomvilt_apply_fn(vault_cfg, text_cfg, RESNET_DEPTH,
                                        head_dropout=args.vilt_dropout_prob,
                                        use_pallas=False))
        counts["baselines_tomvilt_no_tweet"] = tomvilt_no_tweet_forward(tr, vault_cfg,
                                                                        text_cfg)
        del tr
        torch.cuda.empty_cache()
    emit(phase="baselines", step="total", seconds=time.perf_counter() - t0)
    return counts


# ---------------------------------------------------------------------------
# The options group: the training core's last options (remat="dots", the
# int8 AdamW moments, profile_dir and the NaN checks, the lazy datasets)
# and the native host cores, at VAuLT-base's full width.
# ---------------------------------------------------------------------------

# Kernel launches of one training step per remat mode on the kernel path:
# without remat each MLP block runs once per layer; under True and "dots"
# the backward reruns it (the kernels are operators, which "dots"
# recomputes, as the JAX policy saves no pallas_call).
REMAT_STEP_LAUNCHES = {False: launches(encoder_attention=12, attention_bwd=12, mlp_block=12,
                                       mlp_postln=12, mlp_block_bwd=12, mlp_postln_bwd=12),
                       True: STEP_LAUNCHES, "dots": STEP_LAUNCHES}
# The 2-D products (aten mm / addmm, one cuBLAS launch each) of one layer's
# forward that remat=True recomputes and "dots" keeps (ops/nn.py
# _SAVED_PRODUCTS), per tower: on the kernel path the fused QKV product and
# the attention output projection (the MLP is one kernel); on the plain
# path Q, K, V, the output projection and the MLP's two halves.  The
# recompute stops once it holds what the backward reads, but each bf16
# product here is a Function (ops/nn.py _MatmulFP32) that packs its saved
# inputs after its product runs, so it reaches even ViLT's second MLP
# product, whose output no backward reads (an fp32 aten mm packs them
# first: on the CPU the recompute stops short of that one).
LAYER_PRODUCTS = {"auto": {"bert": 2, "vilt": 2}, False: {"bert": 6, "vilt": 6}}
# "dots" against True on one path, same generator: the same operations on
# the same values (bit-equal expected).
DOTS_VS_TRUE = 1e-6
# The int8 moments on the card against the host: each step's fp32 moment
# math is elementwise and correctly rounded on both, so the codes should
# agree; a code may move by one where the two sides round a value at a
# code boundary apart.
INT8_FLIP = {"max_step": 1, "share": 1e-4, "rel": 1e-6}
OPTIONS_STEPS = 4  # Trainer.train(): two eval windows of two steps
OPTIONS_WINDOW = 2


@contextlib.contextmanager
def recorded_masks():
    """The dropout masks ``ops.nn.dropout_mask`` draws (the MLP kernels'),
    in order, first runs and recomputes alike."""
    from vault_tpu_torch.ops import cuda_mlp
    from vault_tpu_torch.ops import nn as nn_ops

    real, seen = nn_ops.dropout_mask, []

    def record(*a, **kw):
        m = real(*a, **kw)
        seen.append(m)
        return m

    nn_ops.dropout_mask = cuda_mlp.dropout_mask = record
    try:
        yield seen
    finally:
        nn_ops.dropout_mask = cuda_mlp.dropout_mask = real


def remat_dots_phase(dev):
    """One training step (batch 32, dropout 0.1, bf16 compute) under
    remat False, True and "dots", each on the kernel path and the plain
    path: exact kernel launches, the cuBLAS products of "dots" those of
    True less the layers' recomputed ones, each mode's gradients against
    the plain path's, "dots" against True (gradients and dropout masks),
    peak memory; wall and busy ms of each.  Returns the "dots" step's
    launches on the kernel path."""
    import torch

    from vault_tpu_torch.data.loader import InMemoryDataset
    from vault_tpu_torch.models.vault import VaultForClassification
    from vault_tpu_torch.presets import vault_base
    from vault_tpu_torch.training.trainer import Trainer, classifier_apply_fn
    from vault_tpu_torch.utils.benchloop import ProductCount

    cfg = vault_base("bert-base-uncased")
    towers = {"bert": cfg.text_tower, "vilt": cfg.vilt}
    # the MLP kernels' masks: one per layer of a tower with dropout
    masked = sum(t.num_hidden_layers for t in towers.values() if t.hidden_dropout_prob > 0)
    feats, labels = entry_features(cfg, TRAIN_BATCH, seed=3)
    tr = Trainer(classifier_apply_fn(cfg, train_args()),
                 VaultForClassification(cfg, device=dev, dtype=torch.float32, seed=0),
                 train_args(), InMemoryDataset(feats, labels), device=dev)
    batch, lab, w = tr._to_device(*tr._pad(feats, labels))
    res = {}
    for impl in ("auto", False):
        for remat in (False, True, "dots"):
            tr.apply_fn = classifier_apply_fn(cfg, train_args(use_pallas=impl, remat=remat))
            gen = tr.step_generator(0)
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            reset_counts()
            with recorded_masks() as masks, ProductCount() as products:
                loss, grads = tr.loss_and_grads(batch, lab, w, gen)
                torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated() - base
            counts = read_counts()
            run = lambda: tr.loss_and_grads(batch, lab, w, tr.step_generator(0))
            wall = [time_ms(run, iters=1, warmup=0) for _ in range(2)]
            busy, _ = device_ms(run, iters=1, warmup=1)
            cublas = products.counts["aten::mm"] + products.counts["aten::addmm"]
            res[impl, remat] = dict(loss=loss.item(), grads=grads, gen=gen.get_state(),
                                    counts=counts, products=cublas,
                                    masks=masks, peak_gb=peak / 1e9,
                                    wall_ms=float(np.median(wall)), busy_ms=busy)
    report = {}
    for (impl, remat), r in res.items():
        want = REMAT_STEP_LAUNCHES[remat] if impl == "auto" else launches()
        if r["counts"] != want:
            fail(f"options remat={remat!r} on {impl}: launches {r['counts']}, expected {want}")
        report[f"{impl}/{remat}"] = {k: r[k] for k in ("loss", "products", "peak_gb",
                                                       "wall_ms", "busy_ms")}
    for impl in ("auto", False):
        recomputed = sum(LAYER_PRODUCTS[impl][name] * t.num_hidden_layers
                         for name, t in towers.items())
        if res[impl, "dots"]["products"] != res[impl, True]["products"] - recomputed:
            fail(f"options on {impl}: {res[impl, 'dots']['products']} products under "
                 f"'dots', expected {res[impl, True]['products']} under True less "
                 f"{recomputed} recomputed")
        ends = {str(r): res[impl, r]["gen"] for r in (False, True, "dots")}
        if not all(torch.equal(e, ends["False"]) for e in ends.values()):
            fail(f"options on {impl}: the step generators end apart under the remat modes")
    for remat in (False, True, "dots"):
        kern, plain = res["auto", remat], res[False, remat]
        rel, _, bad = grad_rel(kern["grads"], plain["grads"], UNUSED_LEAVES.__contains__)
        worst = max(rel.items(), key=lambda kv: kv[1])
        loss_diff = abs(kern["loss"] - plain["loss"])
        if bad or worst[1] > STEP_LIMITS["grad_rel"] or loss_diff > STEP_LIMITS["loss"]:
            fail(f"options remat={remat!r}: kernel vs plain path, loss diff {loss_diff}, "
                 f"worst leaf {worst}, unexpected {bad[:4]} (limits {STEP_LIMITS})")
        report[f"auto/{remat}"].update(grad_rel_worst=worst, loss_abs_diff=loss_diff)
    dots_vs_true = {}
    for impl in ("auto", False):
        a, b = res[impl, "dots"]["grads"], res[impl, True]["grads"]
        rel = max(torch.linalg.vector_norm((a[k] - b[k]).double()).item()
                  / max(torch.linalg.vector_norm(b[k].double()).item(), 1e-30) for k in b)
        equal = sum(torch.equal(a[k], b[k]) for k in b)
        dots_vs_true[str(impl)] = dict(max_rel=rel, bit_equal_leaves=equal, leaves=len(b))
        if rel > DOTS_VS_TRUE:
            fail(f"options on {impl}: 'dots' gradients {rel} from True's (limit {DOTS_VS_TRUE})")
    m_dots, m_true = res["auto", "dots"]["masks"], res["auto", True]["masks"]
    # each MLP mask drawn twice, in the layer's run and in its recompute
    # (which the backward reaches last layer first), and the same masks
    # under True and "dots"
    if (len(m_dots) != 2 * masked or len(m_true) != len(m_dots)
            or not all(torch.equal(a, b) for a, b in zip(m_dots, m_true))
            or not all(torch.equal(m_dots[i], m_dots[-1 - i]) for i in range(masked))):
        fail(f"options: the dropout masks under 'dots' ({len(m_dots)}) differ from those "
             f"under True ({len(m_true)}) or between a layer's run and its recompute")
    # "dots" keeps less than no remat where a layer's other activations
    # outweigh the recompute of one layer: on the plain path, whose
    # attention keeps its fp32 (B, H, L, L) tensors.  On the kernel path the
    # attention keeps only q, k and v, the products' outputs "dots" keeps
    # too (ViLT's, the most of them), so there the two are reported.
    peaks = {str(r): res["auto", r]["peak_gb"] for r in (False, True, "dots")}
    plain_peaks = {str(r): res[False, r]["peak_gb"] for r in (False, True, "dots")}
    if not plain_peaks["dots"] <= plain_peaks["False"]:
        fail(f"options: peak memory on the plain path under 'dots' {plain_peaks['dots']} GB "
             f"above False's {plain_peaks['False']}")
    emit(phase="options", step="remat_dots", batch=TRAIN_BATCH, modes=report,
         layer_products={str(k): v for k, v in LAYER_PRODUCTS.items()}, dots_vs_true=dots_vs_true, limit=DOTS_VS_TRUE,
         masks_checked=len(m_dots), peak_gb_above_start=peaks,
         plain_peak_gb_above_start=plain_peaks,
         launches={str(r): res["auto", r]["counts"] for r in (False, True, "dots")})
    counts = res["auto", "dots"]["counts"]
    del res, tr
    torch.cuda.empty_cache()
    return counts


def adamw_fused_vs_loop(params, grads, tx, state):
    """The bf16-moment update of ``params`` (fp32 masters, fp32 gradients)
    through ``csrc/adamw.cu`` against the per-leaf loop, its plain version,
    from copies of the same state: one step bit-equal (parameters and both
    moments), then each route timed (CUPTI busy ms, CUDA-event wall ms and
    the host's ms to queue a step) beside the kernel's bound, 20 bytes an
    element over 3.35 TB/s."""
    import torch

    from vault_tpu_torch.ops import cuda_adamw

    copies = lambda: ({k: v.clone() for k, v in params.items()},
                      type(state)(state.count, {k: v.clone() for k, v in state.mu.items()},
                                  {k: v.clone() for k, v in state.nu.items()}))
    (p_f, s_f), (p_l, s_l) = copies(), copies()
    n0 = cuda_adamw.fused_adamw.launches
    s_f = tx.step_(p_f, grads, s_f)
    fused_launches, fused_leaves = cuda_adamw.fused_adamw.launches - n0, tx.fused_leaves
    s_l = tx.step_(p_l, grads, s_l, plain=True)
    torch.cuda.synchronize()
    bits = lambda t: t.view(torch.int16 if t.element_size() == 2 else torch.int32)
    differ = [k for k in params if not all(torch.equal(bits(a), bits(b)) for a, b in (
        (p_f[k], p_l[k]), (s_f.mu[k], s_l.mu[k]), (s_f.nu[k], s_l.nu[k])))]
    if differ or fused_launches != 1 or fused_leaves != len(params):
        fail(f"adamw: the fused step over {len(params)} leaves ({fused_launches} launches, "
             f"{fused_leaves} leaves fused) differs from the loop in {differ[:8]}")
    del p_l, s_l
    n = sum(v.numel() for v in params.values())
    out = dict(leaves=len(params), parameters=n, bit_equal=True,
               bound_ms=bound_ms(0, 20 * n, torch.float32)[0])
    for route in ("fused", "loop"):
        step = lambda: tx.step_(p_f, grads, s_f, plain=route == "loop")
        busy, kernels = device_ms(step, iters=2, warmup=1)
        host = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            step()
            host.append((time.perf_counter() - t0) * 1e3)
        out[route] = dict(busy_ms=busy, wall_ms=time_ms(step, iters=3, warmup=1),
                          host_ms=float(np.median(host)), host_ms_samples=host,
                          kernels=len(kernels),
                          top_kernels_ms=dict(sorted(kernels.items(),
                                                     key=lambda kv: -kv[1])[:3]))
    del p_f, s_f
    torch.cuda.empty_cache()
    return out


def int8_moments_phase(dev):
    """Three ``HfAdamW(state_dtype="int8")`` steps from fixed seeded
    gradients, on the card and on the host, over ViLT-B/32's parameters
    and the head (stacked layer leaves and single ones; the host's steps
    over all of VAuLT-base would take 20 s): codes equal but for
    ``INT8_FLIP``, scales and parameters within its relative limit.  Then
    over all of VAuLT-base on the card: the moments' bytes beside bf16's,
    and the optimizer pass's busy and wall ms beside the bf16 pass's."""
    import torch

    from vault_tpu_torch.models.vault import VaultForClassification
    from vault_tpu_torch.presets import vault_base
    from vault_tpu_torch.training.optimizer import hf_adamw

    cfg = vault_base("bert-base-uncased")
    every = {k: v.to(dev) for k, v in VaultForClassification(
        cfg, device="cpu", dtype=torch.float32, seed=0).state_dict().items()
        if v.is_floating_point()}
    card = {k: v.clone() for k, v in every.items() if k.startswith(("vilt.", "head."))}
    host = {k: v.cpu() for k, v in card.items()}
    gen = torch.Generator(device=dev).manual_seed(7)
    grads = [{k: torch.randn(v.shape, generator=gen, device=dev) * 10.0 ** -(2 + i)
              for k, v in card.items()} for i in range(3)]
    tx = hf_adamw(1e-3, weight_decay=0.01, state_dtype="int8")
    s_host, s_card = tx.init(host), tx.init(card)
    t0 = time.perf_counter()
    for g in grads:
        s_host = tx.step_(host, {k: v.cpu() for k, v in g.items()}, s_host)
    host_s = time.perf_counter() - t0
    for g in grads:
        s_card = tx.step_(card, g, s_card)
    torch.cuda.synchronize()
    codes = flips = worst_step = 0
    worst_scale = worst_param = 0.0
    for leaf, m_host in [*s_host.mu.items(), *(("nu:" + k, v) for k, v in s_host.nu.items())]:
        m_card = (s_card.nu[leaf[3:]] if leaf.startswith("nu:") else s_card.mu[leaf])
        d = (m_card.q.cpu().int() - m_host.q.int()).abs()
        codes += d.numel()
        flips += int((d > 0).sum())
        worst_step = max(worst_step, int(d.max()))
        worst_scale = max(worst_scale, ((m_card.scale.cpu() - m_host.scale).abs()
                                        / m_host.scale).max().item())
    for k, p in host.items():
        worst_param = max(worst_param, (card[k].cpu() - p).abs().max().item()
                          / max(p.abs().max().item(), 1e-30))
    if (worst_step > INT8_FLIP["max_step"] or flips > INT8_FLIP["share"] * codes
            or worst_scale > INT8_FLIP["rel"] or worst_param > INT8_FLIP["rel"]):
        fail(f"options int8 moments, card vs host: {flips} of {codes} codes moved (by up to "
             f"{worst_step}), scales {worst_scale}, parameters {worst_param} (limits "
             f"{INT8_FLIP})")
    checked = sum(v.numel() for v in host.values())
    del host, card, grads, s_host, s_card
    n = sum(v.numel() for v in every.values())
    g0 = {k: torch.randn(v.shape, generator=gen, device=dev) * 1e-3 for k, v in every.items()}
    bf16 = hf_adamw(1e-3, weight_decay=0.01, state_dtype=torch.bfloat16)
    s_int8, s_bf16 = tx.init(every), bf16.init(every)
    int8_bytes = 2 * sum(m.q.numel() + 4 * m.scale.numel() for m in s_int8.mu.values())
    fused_vs_loop = adamw_fused_vs_loop(every, g0, bf16, s_bf16)
    passes = {}
    for name, opt, state in (("int8", tx, s_int8), ("bfloat16", bf16, s_bf16)):
        step = lambda: opt.step_(every, g0, state)
        busy, kernels = device_ms(step, iters=2, warmup=1)
        passes[name] = dict(busy_ms=busy, wall_ms=time_ms(step, iters=3, warmup=1),
                            kernels=len(kernels))
    emit(phase="options", step="int8_moments", parameters=n, leaves=len(every),
         jax_leaves=len(s_int8.mu), checked_parameters=checked, steps=3, codes=codes,
         codes_moved=flips,
         max_code_step=worst_step, scale_max_rel=worst_scale, param_max_rel=worst_param,
         limits=INT8_FLIP, host_steps_s=host_s, moment_bytes_int8=int8_bytes,
         moment_bytes_bf16=2 * 2 * n, optimizer_pass=passes, adamw=fused_vs_loop)
    del every, g0, s_int8, s_bf16
    torch.cuda.empty_cache()


def _trace_summary(profile_dir: Path):
    """(trace files, steps spanned, kernel and operator names) of the
    Chrome traces under ``profile_dir``."""
    files = sorted(profile_dir.glob("*.json"))
    steps, kernels, ops, size = set(), set(), set(), 0
    for f in files:
        size += f.stat().st_size
        for e in json.loads(f.read_text())["traceEvents"]:
            name = str(e.get("name", ""))
            if name.startswith("train_step:"):
                steps.add(int(name.split(":")[1]))
            elif e.get("cat") == "kernel":
                kernels.add(name)
            elif name.startswith("vault_tpu_torch::"):
                ops.add(name)
    return files, sorted(steps), kernels, sorted(ops), size


def trainer_options_phase(dev):
    """``Trainer.train()`` at full width with int8 moments, remat "dots",
    ``profile_dir``, a dev set and a checkpoint at each window: the trace
    spans exactly the second window's steps and holds the MLP kernels;
    a run cut by ``max_steps`` and resumed ends on the uninterrupted run's
    parameters and codes bit for bit; a NaN injected into a step's forward
    raises under ``enable_nan_checks(True)``.  Returns the full run's
    launches."""
    import shutil

    import torch

    from vault_tpu_torch.data.loader import InMemoryDataset
    from vault_tpu_torch.models.vault import VaultForClassification
    from vault_tpu_torch.presets import vault_base
    from vault_tpu_torch.training.experiment import ExperimentHandler
    from vault_tpu_torch.training.trainer import Trainer, classifier_apply_fn
    from vault_tpu_torch.utils import profiling

    cfg = vault_base("bert-base-uncased")
    feats, labels = entry_features(cfg, OPTIONS_STEPS * TRAIN_BATCH, seed=4)
    dev_ds = InMemoryDataset(*entry_features(cfg, TRAIN_BATCH, seed=5))
    # checkpoints (1.8 GB each) go to the build directory, the trace to the
    # output directory (then removed: its summary is printed)
    root = Path("build") / "chip_smoke_options"
    profile_dir = OUT_DIR / "options_profile"
    for d in (root, profile_dir):
        shutil.rmtree(d, ignore_errors=True)
    init = VaultForClassification(cfg, device="cpu", dtype=torch.float32, seed=1).state_dict()

    def run(name, **kw):
        args = train_args(num_train_epochs=1, eval_steps=OPTIONS_WINDOW,
                          opt_state_dtype="int8", remat="dots",
                          checkpoint_dir=str(root / name), **kw)
        tr = Trainer(classifier_apply_fn(cfg, args), init, args,
                     InMemoryDataset(feats, labels), dev_dataset=dev_ds,
                     exp_handler=ExperimentHandler(str(root / "logs"), name), device=dev)
        reset_counts()
        t0 = time.perf_counter()
        tr.train()
        torch.cuda.synchronize()
        return tr, read_counts(), time.perf_counter() - t0

    try:  # the trace (tens of MB) is read here and not brought back
        full, counts, wall = run("full", profile_dir=str(profile_dir))
        files, steps, kernels, ops, size = _trace_summary(profile_dir)
    finally:
        shutil.rmtree(profile_dir, ignore_errors=True)
    windows = OPTIONS_STEPS // OPTIONS_WINDOW
    want = {k: OPTIONS_STEPS * REMAT_STEP_LAUNCHES["dots"][k] + windows * EVAL_LAUNCHES[k]
            for k in KERNEL_NAMES}
    if counts != want:
        fail(f"options Trainer.train(): launches {counts}, expected {want}")
    second = list(range(OPTIONS_WINDOW, 2 * OPTIONS_WINDOW))
    want_kernels = ("ln_rows_bf16", "mlp_epilogue", "mlp_bwd_preln_rows", "mlp_bwd_postln_rows")
    missing = [k for k in want_kernels if not any(k in name for name in kernels)]
    want_ops = ["vault_tpu_torch::mlp_block", "vault_tpu_torch::mlp_postln"]
    if len(files) != 1 or steps != second or missing or not set(want_ops) <= set(ops):
        fail(f"options profile_dir: {len(files)} traces spanning steps {steps} (expected one, "
             f"{second}), MLP kernels missing {missing}, operators {ops}")

    _, cut_counts, _ = run("cut", max_steps=OPTIONS_WINDOW)
    resumed, _, resume_wall = run("cut", resume=True)
    diff = [k for k in full.params if not torch.equal(full.params[k], resumed.params[k])]
    for mine, theirs in ((full.opt_state.mu, resumed.opt_state.mu),
                         (full.opt_state.nu, resumed.opt_state.nu)):
        diff += [k for k in mine if not (torch.equal(mine[k].q, theirs[k].q)
                                         and torch.equal(mine[k].scale, theirs[k].scale))]
    if diff or not resumed.opt_state.count == full.opt_state.count == OPTIONS_STEPS:
        fail(f"options resume: {len(diff)} leaves differ from the uninterrupted run "
             f"(first {diff[:4]}), steps {resumed.opt_state.count} / {full.opt_state.count}")
    losses = full.exp_handler._series
    if not all(math.isfinite(v) for v in losses["train_loss"] + losses["eval_loss"]):
        fail(f"options Trainer.train(): losses {losses}")

    bad = {k: v[:TRAIN_BATCH].copy() for k, v in feats.items()}
    bad["pixel_values"][3, 1, 5, 7] = np.nan
    good = resumed._to_device(*resumed._pad({k: v[:TRAIN_BATCH] for k, v in feats.items()},
                                            labels[:TRAIN_BATCH]))
    poisoned = resumed._to_device(*resumed._pad(bad, labels[:TRAIN_BATCH]))
    raised = None
    t0 = time.perf_counter()
    try:
        profiling.enable_nan_checks(True)
        resumed.train_step(*good, 100)  # finite: no alarm
        checked_step_s = time.perf_counter() - t0
        try:
            resumed.train_step(*poisoned, 101)
        except RuntimeError as e:
            raised = str(e).splitlines()[0]
    finally:
        profiling.enable_nan_checks(False)
    if raised is None or "NaN produced by" not in raised:
        fail(f"options: a NaN pixel under enable_nan_checks(True) did not raise ({raised})")
    ckpt_bytes = sum(f.stat().st_size for f in (root / "full").glob("*.npz"))
    shutil.rmtree(root, ignore_errors=True)
    emit(phase="options", step="trainer", steps=OPTIONS_STEPS, window=OPTIONS_WINDOW,
         wall_s=wall, resumed_wall_s=resume_wall, launches=counts, cut_launches=cut_counts,
         train_loss=losses["train_loss"], eval_loss=losses["eval_loss"],
         trace=dict(files=len(files), steps=steps, bytes=size, kernels=len(kernels),
                    mlp_kernels=[k for k in sorted(kernels)
                                 if any(w in k for w in want_kernels)][:8], operators=ops),
         resume_bit_equal_leaves=len(full.params) + 2 * len(full.opt_state.mu),
         checkpoint_bytes=ckpt_bytes, nan_check=raised, checked_step_s=checked_step_s)
    del full, resumed
    torch.cuda.empty_cache()
    return counts


@contextlib.contextmanager
def lazy_twitter_images():
    """``data.datasets.Twitter201XDataset`` with ``lazy_images=True`` for
    the experiment CLI, which builds the datasets from that name."""
    from vault_tpu_torch.data import datasets

    eager = datasets.Twitter201XDataset

    class Lazy(eager):
        def __init__(self, *a, **kw):
            super().__init__(*a, lazy_images=True, **kw)

    datasets.Twitter201XDataset = Lazy
    try:
        yield
    finally:
        datasets.Twitter201XDataset = eager


def _median_ms(fn, repeats=5):
    samples = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        fn()
        samples.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(samples))


def lazy_and_native_phase(dev):
    """``cli.clsf_vault`` on the synthetic Twitter201X files of the tasks
    group, once with the images held and once decoded at batch time: equal
    metrics.  The native resize and WordPiece cores, built on this machine,
    against the PIL and Python paths on the same files, bit for bit; the
    host preprocessing ms of a batch of 32 on each."""
    import tempfile

    import torch
    from PIL import Image

    from vault_tpu_torch.cli import clsf_vault
    from vault_tpu_torch.data.datasets import load_image_file, read_twitter201x
    from vault_tpu_torch.data.image import IMAGE_MEAN, IMAGE_STD, target_size
    from vault_tpu_torch.data.native_image import resize_normalize_native
    from vault_tpu_torch.models.pretrained import build_tokenizer

    Path("build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir="build", prefix="options_") as tmp:
        root = Path(tmp)
        dirs = write_hf_dirs(root, names=("bert-base-uncased", "vilt-b32-mlm"))
        twitter = write_twitter(root)
        argv = ["Twitter201X", "--dir", str(twitter), "--train_split", "train",
                "--dev_split", "dev", "--test_split", "test",
                "--vilt_model_name_or_path", str(dirs["vilt-b32-mlm"][0]),
                "--bert_model_name_or_path", str(dirs["bert-base-uncased"][0]),
                "--canvas", "384x608", "--num_train_epochs", "1", "--disable_tqdm",
                "--max_num_workers", "4", "--experiment_root", str(root / "logs")]
        runs = {}
        for mode in ("eager", "lazy"):
            with lazy_twitter_images() if mode == "lazy" else contextlib.nullcontext():
                t0 = time.perf_counter()
                (tr,) = clsf_vault.main(argv)
                torch.cuda.synchronize()
            held = tr.train_dataset._images is not None
            if held != (mode == "eager"):
                fail(f"options lazy_and_native: the {mode} run's train set holds images: {held}")
            h = tr.exp_handler
            runs[mode] = dict(seconds=time.perf_counter() - t0,
                              metrics={**{k: v for k, v in h._series.items()},
                                       **{k: v for k, v in h._finals.items()
                                          if "per_sec" not in k}},
                              errors=tr.train_dataset._err_count)
            del tr
            torch.cuda.empty_cache()
        if runs["eager"]["metrics"] != runs["lazy"]["metrics"]:
            fail(f"options: the lazy run's metrics {runs['lazy']['metrics']} differ from the "
                 f"eager run's {runs['eager']['metrics']}")

        images = [load_image_file(str(p)) for p in sorted(
            (root / "twitter2015_images").glob("*.jpg"))]
        sizes = [target_size(*im.shape[:2]) for im in images]

        def pil_path(im, hw):
            out = np.asarray(Image.fromarray(im).resize((hw[1], hw[0]), Image.BICUBIC),
                             np.float32)
            return ((out / 255.0 - IMAGE_MEAN) / IMAGE_STD).transpose(2, 0, 1)

        resize_diff = [int((resize_normalize_native(im, hw, IMAGE_MEAN, IMAGE_STD)
                            != pil_path(im, hw)).sum()) for im, hw in zip(images, sizes)]
        tok = build_tokenizer(str(dirs["bert-base-uncased"][0]), 40)
        texts = [t for e in read_twitter201x(str(twitter), ["train", "dev", "test"])
                 for t in (e.targetless_tweet, e.target)]
        tok._ids_for_text(texts[0])  # loads the native core
        python_ids = lambda t: tok.convert_tokens_to_ids(tok.tokenize(t))
        text_diff = sum(tok._native.tokenize_to_ids(t) != python_ids(t) for t in texts)
        if any(resize_diff) or text_diff or not tok._native.available:
            fail(f"options native cores vs PIL / Python: {sum(resize_diff)} pixels, "
                 f"{text_diff} of {len(texts)} texts differ")
        batch_im = [(images[i % len(images)], sizes[i % len(sizes)]) for i in range(TRAIN_BATCH)]
        batch_tx = texts[:TRAIN_BATCH]
        host_ms = {
            "resize_native": _median_ms(lambda: [resize_normalize_native(
                im, hw, IMAGE_MEAN, IMAGE_STD) for im, hw in batch_im]),
            "resize_pil": _median_ms(lambda: [pil_path(im, hw) for im, hw in batch_im]),
            "wordpiece_native": _median_ms(lambda: [tok._native.tokenize_to_ids(t)
                                                    for t in batch_tx]),
            "wordpiece_python": _median_ms(lambda: [python_ids(t) for t in batch_tx])}
    emit(phase="options", step="lazy_and_native", runs=runs, images_checked=len(images),
         texts_checked=len(texts), host_ms_batch32=host_ms, cpus=os.cpu_count())


def options_phase(dev):
    """The options group.  Returns (the "dots" step's launches, the path
    launches of its trainer run)."""
    t0 = time.perf_counter()
    dots = remat_dots_phase(dev)
    int8_moments_phase(dev)
    trainer_counts = trainer_options_phase(dev)
    lazy_and_native_phase(dev)
    emit(phase="options", step="total", seconds=time.perf_counter() - t0)
    return dots, {"options_trainer": trainer_counts}


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


# ---------------------------------------------------------------------------
# The parallel layer (--phases parallel): data parallelism, ZeRO-1, tensor
# parallelism, the pipeline, multi-device serving and multi-process
# checkpoints at VAuLT-base's width.  The ranks are worker processes
# (``python3 -m chip_smoke <rank> <ranks> <port> <outdir> --scenario
# <role>``, parallel/multihost.py ``spawn_workers``) that share cuda:0 over
# gloo, or one NCCL rank; the serving and pipeline legs run in this process
# over a device list that names cuda:0 twice.  The ranks share one card, so
# no number here is a scaling number.
# ---------------------------------------------------------------------------

PARALLEL_STEPS = 3
PARALLEL_DIR = Path("build") / "chip_smoke_parallel"
TP_BATCH = 8
PIPE_BATCH, PIPE_MICRO = 32, 4
CKPT_STEPS, CKPT_EVERY, CKPT_STOP = 6, 4, 5
# The TP forward's kernels: the attention kernel on each rank's 6 heads in
# all 24 layers; the products run the plain composition (as the JAX
# package's tensor-parallel path runs XLA), so no MLP kernel.
TP_LAUNCHES = launches(encoder_attention=24)


def deterministic_mode():
    """Bit-equal repeats across processes: PyTorch's deterministic
    kernels where it has them (the index_put_ accumulations of the
    embedding and position-grid gathers' backward), and one cuBLAS
    workspace setting in every process of the group."""
    import torch

    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.use_deterministic_algorithms(True, warn_only=True)
    torch.utils.deterministic.fill_uninitialized_memory = False


def checksum(t) -> int:
    """A checksum of a tensor's bits (int64 sum of the 32-bit words, each
    weighted by its position mod a prime)."""
    import torch

    bits = t.detach().contiguous().view(-1)
    if bits.element_size() == 2:
        bits = bits.view(torch.int16).to(torch.int64)
    elif bits.element_size() == 1:
        bits = bits.view(torch.int8).to(torch.int64)
    else:
        bits = bits.view(torch.int32).to(torch.int64)
    w = torch.arange(bits.numel(), device=bits.device, dtype=torch.int64) % 1000003 + 1
    return int((bits * w).sum().item())


def parallel_batches(cfg, seed=6):
    feats, labels = entry_features(cfg, TRAIN_BATCH * PARALLEL_STEPS, seed=seed)
    return [({k: v[i * TRAIN_BATCH:(i + 1) * TRAIN_BATCH] for k, v in feats.items()},
             labels[i * TRAIN_BATCH:(i + 1) * TRAIN_BATCH]) for i in range(PARALLEL_STEPS)]


_BASE = {}


def base_params(cfg):
    """The seeded VAuLT-base weights on the host, drawn once a process
    (every trainer of the group starts from them)."""
    import torch

    from vault_tpu_torch.models.vault import VaultForClassification

    if "params" not in _BASE:
        model = VaultForClassification(cfg, device="cpu", dtype=torch.float32, seed=0)
        _BASE["params"] = {k: v.detach() for k, v in model.state_dict().items()}
    return _BASE["params"]


def parallel_trainer(cfg, dev, mesh=None, tensor_parallel=False, dataset=None, **kw):
    from vault_tpu_torch.data.loader import InMemoryDataset
    from vault_tpu_torch.training.trainer import Trainer, classifier_apply_fn

    args = train_args(**kw)
    tr = Trainer(classifier_apply_fn(cfg, args), base_params(cfg), args,
                 dataset or InMemoryDataset(*entry_features(cfg, 1, seed=0)),
                 device=dev, mesh=mesh, tensor_parallel=tensor_parallel)
    tr._build_optimizer(1)
    return tr


def manual_steps(tr, batches, on_step=None):
    """``Trainer._train_step`` written out: per step the rank's rows, the
    (all-reduced) gradients, the update.  Returns the launches of each
    step's forward and backward and each step's wall ms."""
    import torch

    counts, walls = [], []
    for i, (feats, labels) in enumerate(batches):
        b, lab, w = tr._pad(feats, labels)
        bt, lt, wt = tr._to_device(*tr._rows(b, lab, w))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        reset_counts()
        _, grads = tr.loss_and_grads(bt, lt, wt, tr.step_generator(i))
        counts.append(read_counts())
        if on_step is not None:
            on_step(i, grads)
        tr.opt_state = tr.tx.step_(tr.trainable, grads, tr.opt_state)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    return counts, walls


def timed_collectives():
    """Wraps the trainer's gradient bucket all-reduce and ZeRO's gathers
    with a wall-clock meter (synchronized, so the card's queue is drained
    before and after) and a profiler region of the same name; returns the
    meter {name: [ms, ...]}."""
    import torch

    from vault_tpu_torch.parallel import mesh as mesh_mod
    from vault_tpu_torch.parallel import zero as zero_mod

    meter = {"all_reduce_bucket": [], "zero_gather": []}

    def wrap(mod, name, key):
        fn = getattr(mod, name)

        def timed(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with torch.profiler.record_function(key):
                out = fn(*a, **kw)
            torch.cuda.synchronize()
            meter[key].append((time.perf_counter() - t0) * 1e3)
            return out

        setattr(mod, name, timed)

    wrap(mesh_mod, "all_reduce_bucket", "all_reduce_bucket")
    wrap(zero_mod.ZeroAdamW, "_gather_slices", "zero_gather")
    return meter


def traced_step(tr, batch, meter):
    """One more data-parallel step under a CUPTI trace: the rank's device
    busy ms in the step, the part of it in the gradient all-reduce's region
    (the meter drains the card before the region, so every device event
    that starts inside it is the all-reduce's: the bucket's cast and
    concatenation and its copies to and from pinned host memory), their
    ratio, and the step's and the region's wall ms.  The shares are None
    when CUPTI hands back a trace without device events."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    meter["all_reduce_bucket"].clear()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _, walls = manual_steps(tr, [batch])
    events = prof.events()
    regions = [e.time_range for e in events if e.name == "all_reduce_bucket"
               and e.device_type == torch.autograd.DeviceType.CPU]
    device = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA
              and e.name not in meter]  # not the regions' own device annotations
    busy = sum(e.time_range.elapsed_us() for e in device) / 1e3
    inside = sum(e.time_range.elapsed_us() for e in device
                 if any(r.start <= e.time_range.start <= r.end for r in regions)) / 1e3
    wall, coll = walls[0], sum(meter["all_reduce_bucket"])
    return dict(busy_ms=busy, all_reduce_busy_ms=inside,
                all_reduce_share_of_busy=inside / busy if busy > 0 else None,
                wall_ms=wall, all_reduce_wall_ms=coll,
                all_reduce_share_of_wall=coll / wall, device_events=len(device),
                regions=len(regions))


def worker_single(out: Path, dev, role: str):
    """``single``: one process, no group; ``nccl``: a one-rank NCCL group.
    The same 3 steps on the same global batches; the gradients of each
    step (``single``: saved in bf16 for the data-parallel ranks' gate) and
    checksums of the gradients and the final parameters."""
    import torch

    from vault_tpu_torch.parallel.mesh import init_distributed, make_mesh
    from vault_tpu_torch.presets import vault_base

    cfg = vault_base("bert-base-uncased")
    mesh = None
    if role == "single":
        # the first step's gradients in fp32 compute: the yardstick both
        # bf16 paths are read against (reported, not gated)
        tr32 = parallel_trainer(cfg, dev, compute_dtype="float32")
        b, lab, w = tr32._pad(*parallel_batches(cfg)[0])
        _, g32 = tr32.loss_and_grads(*tr32._to_device(b, lab, w), tr32.step_generator(0))
        torch.save({k: g.cpu() for k, g in g32.items()}, out / "single32_grads_0.pt")
        del tr32, g32
        torch.cuda.empty_cache()
    if role == "nccl":
        from vault_tpu_torch.parallel.multihost import free_port

        init_distributed(f"localhost:{free_port()}", 1, 0, backend="nccl")
        mesh = make_mesh(1)
    tr = parallel_trainer(cfg, dev, mesh=mesh)
    sums, param_sums = [], []

    def on_step(i, grads):
        sums.append({k: checksum(g) for k, g in grads.items()})
        if i > 0:  # the parameters after the previous step's update
            param_sums.append({k: checksum(v) for k, v in tr.params.items()})
        if role == "single":
            torch.save({k: g.to(torch.bfloat16).cpu() for k, g in grads.items()},
                       out / f"single_grads_{i}.pt")

    # the NCCL rank takes the first two steps: a gradient all-reduced and an
    # update applied, then the next step's gradients on the updated masters
    batches = parallel_batches(cfg)[:2 if role == "nccl" else PARALLEL_STEPS]
    counts, walls = manual_steps(tr, batches, on_step)
    param_sums.append({k: checksum(v) for k, v in tr.params.items()})
    if role == "single":
        torch.save({k: v.detach().cpu() for k, v in tr.params.items()},
                   out / "single_params.pt")
    (out / f"{role}.json").write_text(json.dumps(dict(
        grad_sums=sums, param_sums=param_sums, counts=counts, wall_ms=walls)))
    if role == "nccl":
        torch.distributed.destroy_process_group()


def worker_ranks(out: Path, dev, rank: int):
    """The 2 gloo ranks on cuda:0: data parallelism (held to the
    ``single`` run per step), ZeRO-1 (bit-equal to it), tensor
    parallelism (forward and one step against one device), and the
    interrupted and resumed ZeRO ``Trainer.train()`` through
    ``torch.distributed.checkpoint``."""
    import shutil

    import torch

    from vault_tpu_torch.convert import param_tree
    from vault_tpu_torch.data.loader import InMemoryDataset
    from vault_tpu_torch.models.vault import (
        VaultForClassification,
        classifier_head_apply,
        vault_apply,
        vault_for_classification,
    )
    from vault_tpu_torch.parallel.mesh import make_mesh
    from vault_tpu_torch.parallel.sharding import shard_params
    from vault_tpu_torch.parallel.tensor_parallel import ProcessTP, use_tp
    from vault_tpu_torch.parallel.zero import ZeroAdamW, moment_bytes
    from vault_tpu_torch.presets import vault_base
    from vault_tpu_torch.training import losses
    from vault_tpu_torch.training.trainer import Trainer, classifier_apply_fn

    cfg = vault_base("bert-base-uncased")
    res = {"backend": torch.distributed.get_backend()}
    batches = parallel_batches(cfg)
    meter = timed_collectives()

    # ---- data parallelism: 16 rows a rank, held to one process's 32 per step
    dp_mesh = make_mesh(2)
    tr = parallel_trainer(cfg, dev, mesh=dp_mesh)
    # the one-process reference and the NCCL rank ran beside this set-up;
    # the timed steps begin once both have finished
    t0 = time.perf_counter()
    deadline = t0 + 600.0
    while not all((out / f"{role}.json").exists() for role in ("single", "nccl")):
        if (out / "abort").exists() or time.perf_counter() > deadline:
            raise RuntimeError("the one-process reference or the NCCL rank did not finish")
        time.sleep(0.2)
    torch.distributed.barrier()
    res["waited_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    rel_steps = []

    def on_step(i, grads):
        if rank != 0:
            return
        ref = torch.load(out / f"single_grads_{i}.pt")
        rel, _, bad = grad_rel({k: g.float() for k, g in grads.items()},
                               {k: v.to(dev).float() for k, v in ref.items()},
                               UNUSED_LEAVES.__contains__)
        worst = max(rel.values())
        top = sorted(rel, key=rel.get)[-4:]
        entry = dict(worst=worst, worst_leaf=max(rel, key=rel.get),
                     median=float(np.median(list(rel.values()))),
                     bad=[b[0] for b in bad][:4])
        if i == 0:
            # the worst leaves of both bf16 paths against the fp32 step
            g32 = torch.load(out / "single32_grads_0.pt")
            norm = lambda t: torch.linalg.vector_norm(t.double()).item()
            entry["vs_fp32"] = {k: dict(
                dp=norm(grads[k].double().cpu() - g32[k].double()) / norm(g32[k]),
                single=norm(ref[k].double() - g32[k].double()) / norm(g32[k]))
                for k in top}
        rel_steps.append(entry)

    counts, walls = manual_steps(tr, batches, on_step)
    res.update(dp_counts=counts, dp_wall_ms=walls, dp_grad_rel=rel_steps,
               dp_all_reduce_ms=list(meter["all_reduce_bucket"]),
               dp_moment_bytes=moment_bytes(tr.opt_state))
    if rank == 0:
        single = torch.load(out / "single_params.pt")
        res["dp_param_max_abs_vs_single"] = max(
            float((tr.params[k].detach().cpu() - v).abs().max()) for k, v in single.items())
    dp_params = {k: v.detach().clone() for k, v in tr.params.items()}
    dp_mu = {k: v.clone() for k, v in tr.opt_state.mu.items()}
    dp_nu = {k: v.clone() for k, v in tr.opt_state.nu.items()}
    res["dp_trace"] = traced_step(tr, batches[-1], meter)
    del tr
    res["dp_s"] = time.perf_counter() - t0

    # ---- ZeRO-1, bf16 moments: bit-equal to data parallelism
    t0 = time.perf_counter()
    meter["all_reduce_bucket"].clear()
    tr = parallel_trainer(cfg, dev, mesh=dp_mesh, zero_opt=True)
    zcounts, zwalls = manual_steps(tr, batches)
    zero = tr.tx
    assert isinstance(zero, ZeroAdamW)
    unequal = [k for k, v in tr.params.items() if not torch.equal(v, dp_params[k])]
    unequal += [f"mu/{k}" for k, v in tr.opt_state.mu.items()
                if not torch.equal(v, zero._slice(dp_mu[k]))]
    unequal += [f"nu/{k}" for k, v in tr.opt_state.nu.items()
                if not torch.equal(v, zero._slice(dp_nu[k]))]
    # the optimizer's routes in the last step: every leaf on csrc/adamw.cu,
    # the slices on a leaf's last axis (not contiguous) by their row strides
    zero_routes = dict(fused=zero.fused_leaves, loop=zero.loop_leaves,
                       sliced=sum(not zero._slice(p).is_contiguous()
                                  for p in tr.trainable.values()),
                       leaves=len(tr.trainable))
    res.update(zero_counts=zcounts, zero_wall_ms=zwalls, zero_unequal=unequal[:8],
               zero_routes=zero_routes,
               zero_leaves=len(tr.params) + 2 * len(tr.opt_state.mu),
               zero_moment_bytes=moment_bytes(tr.opt_state),
               zero_gather_ms=sum(meter["zero_gather"]) / PARALLEL_STEPS,
               zero_all_reduce_ms=list(meter["all_reduce_bucket"]),
               moment_dtype=str(next(iter(tr.opt_state.mu.values())).dtype))
    del tr, dp_params, dp_mu, dp_nu
    torch.cuda.empty_cache()
    res["zero_s"] = time.perf_counter() - t0

    # ---- tensor parallelism: 6 heads and 1,536 columns a rank, bf16
    t0 = time.perf_counter()
    tp_mesh = make_mesh(1, 2)
    tp_group = ProcessTP(tp_mesh.model_group)
    full = base_params(cfg)
    shard = {k: v.to(dev) for k, v in shard_params(full, tp_mesh.model_index, 2).items()}
    batch = entry_batch(cfg, TP_BATCH, dev, seed=7)
    bf16 = lambda p: param_tree({k: v.to(torch.bfloat16) if v.is_floating_point() else v
                                 for k, v in p.items()})

    def forward(params, impl):
        out = vault_apply(params, cfg, deterministic=True, use_pallas=impl, **batch)
        return (out.pooler_output.float(),
                classifier_head_apply(params["head"], out.pooler_output,
                                      deterministic=True).float())

    with torch.inference_mode():
        reset_counts()
        with use_tp(tp_group):
            tp_pool, tp_logits = forward(bf16(shard), "auto")
        torch.cuda.synchronize()
        res["tp_counts"] = read_counts()
        ref_pool, ref_logits = forward(bf16({k: v.to(dev) for k, v in full.items()}), False)
    res.update(tp_pooler_err=(tp_pool - ref_pool).abs().max().item(),
               tp_logits_err=(tp_logits - ref_logits).abs().max().item())
    tp_fwd_ms = []
    with torch.inference_mode(), use_tp(tp_group):
        tree = bf16(shard)
        for _ in range(3):
            torch.cuda.synchronize()
            ts = time.perf_counter()
            forward(tree, "auto")
            torch.cuda.synchronize()
            tp_fwd_ms.append((time.perf_counter() - ts) * 1e3)
    res["tp_forward_ms"] = tp_fwd_ms

    # one TP step (the plain products, dropout on; the masks of all 12
    # heads, cut to the rank's 6) against one device's plain step
    args = train_args(use_pallas="auto")
    apply_fn = classifier_apply_fn(cfg, args)
    feats, labels = batches[0]
    feats = {k: v[:TP_BATCH] for k, v in feats.items()}
    labels = labels[:TP_BATCH]
    ttr = Trainer(apply_fn, full, args, InMemoryDataset(feats, labels), device=dev,
                  mesh=tp_mesh, tensor_parallel=True)
    b, lab, w = ttr._to_device(*ttr._rows(*ttr._pad(feats, labels)))
    tp_loss, tp_grads = ttr.loss_and_grads(b, lab, w, ttr.step_generator(0))
    from vault_tpu_torch.parallel.mesh import all_gather
    from vault_tpu_torch.parallel.sharding import shard_dim, vault_param_specs

    specs = vault_param_specs(tp_grads)
    tp_grads = {k: g if shard_dim(specs[k]) is None else
                torch.cat(all_gather(g, tp_mesh.model_group), dim=shard_dim(specs[k]))
                for k, g in tp_grads.items()}
    masters = {k: v.to(dev).requires_grad_(v.is_floating_point()) for k, v in full.items()}
    gen = ttr.step_generator(0)
    logits = vault_for_classification(bf16(masters), cfg, b, head_dropout=0.1,
                                      deterministic=False, generator=gen,
                                      use_pallas=False, remat=True)
    ref_loss = losses.softmax_cross_entropy(logits, lab, w)
    keys = [k for k in masters if masters[k].requires_grad]
    ref_grads = torch.autograd.grad(ref_loss, [masters[k] for k in keys], allow_unused=True)
    ref_grads = {k: torch.zeros_like(masters[k]) if g is None else g
                 for k, g in zip(keys, ref_grads)}
    rel, _, bad = grad_rel(tp_grads, ref_grads, UNUSED_LEAVES.__contains__)
    res.update(tp_step_loss_diff=abs(float(tp_loss) - float(ref_loss)),
               tp_step_grad_rel_worst=max(rel.values()),
               tp_step_worst_leaf=max(rel, key=rel.get),
               tp_step_grad_rel_median=float(np.median(list(rel.values()))),
               tp_step_bad=[x[0] for x in bad][:4])
    del ttr, masters, ref_grads, tp_grads, logits

    # the w8a8 model's TP forward: its distance is reported
    q = VaultForClassification(cfg, device=dev, dtype=torch.bfloat16, seed=0).quantize("w8a8")
    qfull = {k: v.detach() for k, v in q.state_dict().items()}
    qshard = shard_params(qfull, tp_mesh.model_index, 2)
    with torch.inference_mode():
        with use_tp(tp_group):
            qtp = vault_for_classification(param_tree(qshard), cfg, batch, head_dropout=0.0,
                                           use_pallas="auto").float()
        qref = q(batch).float()
    res["tp_w8a8_logits_dist"] = (qtp - qref).abs().max().item()
    del q, qfull, qshard, full, shard
    torch.cuda.empty_cache()
    res["tp_s"] = time.perf_counter() - t0

    # ---- Trainer.train() with ZeRO, interrupted after the step-4
    # checkpoint (torch.distributed.checkpoint) and resumed
    t0 = time.perf_counter()
    feats, labels = entry_features(cfg, TRAIN_BATCH * CKPT_STEPS, seed=8)
    ckpt = PARALLEL_DIR / "ckpt"

    def run(**kw):
        t = parallel_trainer(cfg, dev, dataset=InMemoryDataset(feats, labels),
                             num_train_epochs=1, eval_steps=CKPT_EVERY, zero_opt=True,
                             prefetch_batches=0, **kw)
        t.train()
        return {k: v.detach().clone() for k, v in t.params.items()}

    final = run()
    run(max_steps=CKPT_STOP, checkpoint_dir=str(ckpt))
    resumed = run(checkpoint_dir=str(ckpt), resume=True)
    res.update(ckpt_unequal=[k for k, v in final.items() if not torch.equal(v, resumed[k])][:8],
               ckpt_max_abs_diff=max(float((v - resumed[k]).abs().max())
                                     for k, v in final.items()),
               ckpt_leaves=len(final),
               ckpt_files=sorted(p.name for p in ckpt.iterdir()) if ckpt.exists() else [])
    torch.distributed.barrier()
    if rank == 0:
        shutil.rmtree(ckpt, ignore_errors=True)
    res["ckpt_s"] = time.perf_counter() - t0
    (out / f"rank{rank}.json").write_text(json.dumps(res))


def parallel_worker(argv):
    """A worker process of the parallel group (never prints the run's last
    line; its results go to ``<results>/<role>.json`` or ``rank<r>.json``,
    ``--results`` the directory the group's workers share)."""
    import torch

    rank, nproc, port = int(argv[0]), int(argv[1]), argv[2]
    role = argv[argv.index("--scenario") + 1]
    outdir = Path(argv[argv.index("--results") + 1])
    deterministic_mode()
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    if role in ("single", "nccl"):
        worker_single(outdir, dev, role)
    else:
        from vault_tpu_torch.parallel.mesh import init_distributed

        init_distributed(f"localhost:{port}", nproc, rank, backend="gloo", timeout_s=600)
        worker_ranks(outdir, dev, rank)
        torch.distributed.barrier()
        torch.distributed.destroy_process_group()
    print(f"RESULT {rank} ok", flush=True)


def pipeline_leg(dev, cfg, model_f32):
    """Both stages on cuda:0 on two streams, batch 32 in 4 micro-batches:
    the forward against the monolithic forward on the same selector, the
    launches (4 x a batch-8 forward), the gradients against one device's
    step, wall and kernel-sum ms beside the monolithic forward."""
    import torch

    from torch.profiler import ProfilerActivity, profile

    from vault_tpu_torch.convert import param_tree
    from vault_tpu_torch.models.vault import VaultForClassification, vault_apply
    from vault_tpu_torch.parallel.pipeline import (
        PipelineVault,
        make_pipeline_train_fn,
        place_pipeline_params,
    )
    from vault_tpu_torch.training import losses

    t0 = time.perf_counter()
    model = VaultForClassification(cfg, device=dev, dtype=torch.bfloat16, seed=0)
    pipe = PipelineVault(model, cfg, lm_device=dev, vilt_device=dev,
                         inner_batch_size=PIPE_BATCH // PIPE_MICRO)
    batch = entry_batch(cfg, PIPE_BATCH, dev, seed=9)
    keys = ("input_ids", "attention_mask", "token_type_ids", "pixel_values", "pixel_mask")
    with torch.inference_mode():
        reset_counts()
        out = pipe(**{k: batch[k] for k in keys})
        torch.cuda.synchronize()
        counts = read_counts()
        mono = vault_apply(model, cfg, deterministic=True, use_pallas="auto", **batch)
    want = {k: v * PIPE_MICRO for k, v in EVAL_LAUNCHES.items()}
    err = (out.pooler_output.float() - mono.pooler_output.float()).abs().max().item()
    if counts != want:
        fail(f"pipeline forward launches {counts}, expected {want}")
    if err > FORWARD_LIMITS["pooler"]:
        fail(f"pipeline pooler vs monolithic: {err} (limit {FORWARD_LIMITS['pooler']})")

    def kernel_sum(fn):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        return sum(e.time_range.elapsed_us() for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3

    with torch.inference_mode():
        run_pipe = lambda: pipe(**{k: batch[k] for k in keys})
        run_mono = lambda: vault_apply(model, cfg, deterministic=True, use_pallas="auto",
                                       **batch)
        samples = {"pipeline": [], "monolithic": []}
        for name in ("monolithic", "pipeline", "pipeline", "monolithic"):
            fn = run_pipe if name == "pipeline" else run_mono
            samples[name].append(time_ms(fn, iters=3, warmup=1))
        busy = {"pipeline": kernel_sum(run_pipe), "monolithic": kernel_sum(run_mono)}
    del model, pipe
    torch.cuda.empty_cache()

    # the trainable pipeline against one device's step, bf16 compute on fp32
    # masters; without dropout (the pipeline's 2 x 4 micro-batch generators
    # draw other masks than one batch-32 forward)
    placed = place_pipeline_params(model_f32, dev, dev)
    fn = make_pipeline_train_fn(cfg, losses.softmax_cross_entropy, lm_device=dev,
                                vilt_device=dev, num_micro=PIPE_MICRO, remat=True,
                                compute_dtype=torch.bfloat16)
    feats, labels = entry_features(cfg, PIPE_BATCH, seed=10)
    weight = np.ones(PIPE_BATCH, np.float32)
    reset_counts()
    loss, grads = fn(placed, feats, labels, weight)
    torch.cuda.synchronize()
    pcounts = read_counts()
    masters = {k: v.detach().clone().requires_grad_(v.is_floating_point())
               for k, v in placed.items()}
    from vault_tpu_torch.models.vault import batch_to_device, vault_for_classification

    b = batch_to_device(feats, dev)
    bf16 = {k: v.to(torch.bfloat16) if v.is_floating_point() else v for k, v in masters.items()}
    logits = vault_for_classification(param_tree(bf16), cfg, b, head_dropout=0.0,
                                      deterministic=True, use_pallas="auto", remat=True)
    ref_loss = losses.softmax_cross_entropy(logits, torch.as_tensor(labels, device=dev),
                                            torch.as_tensor(weight, device=dev))
    ref = torch.autograd.grad(ref_loss, [masters[k] for k in grads], allow_unused=True)
    ref = {k: torch.zeros_like(masters[k]) if g is None else g for k, g in zip(grads, ref)}
    rel, _, bad = grad_rel(grads, ref, UNUSED_LEAVES.__contains__)
    worst = max(rel.values())
    loss_diff = abs(float(loss) - float(ref_loss.detach()))
    if bad or worst > STEP_LIMITS["grad_rel"] or loss_diff > STEP_LIMITS["loss"]:
        fail(f"pipeline step vs one device: loss diff {loss_diff}, worst grad rel "
             f"{worst} ({max(rel, key=rel.get)}), bad {bad[:4]}")
    del placed, masters, grads, ref
    torch.cuda.empty_cache()
    emit(phase="parallel_pipeline", batch=PIPE_BATCH, micro_batches=PIPE_MICRO,
         streams=2, device=str(dev), launches_forward=counts, pooler_max_abs_err=err,
         limits=FORWARD_LIMITS, wall_ms=samples, kernel_sum_ms=busy,
         step_launches=pcounts, step_loss_diff=loss_diff, step_grad_rel_worst=worst,
         step_grad_rel_median=float(np.median(list(rel.values()))),
         seconds=time.perf_counter() - t0)
    return counts


def serving_leg(dev, cfg):
    """``dp_sharded_forward`` and ``tp_forward`` over [cuda:0, cuda:0],
    bf16 and w8a8: DP bit-equal to each shard's direct forward, TP within
    the forward limits of the direct forward (w8a8: reported), and 16
    concurrent ``BatchingEngine`` requests on the DP forward."""
    import torch

    from vault_tpu_torch.convert import param_tree
    from vault_tpu_torch.models.vault import VaultForClassification, vault_for_classification
    from vault_tpu_torch.serving import dp_sharded_forward, tp_forward

    t0 = time.perf_counter()
    devices = [dev, dev]
    res = {}
    for mode in ("bf16", "w8a8"):
        model = VaultForClassification(cfg, device=dev, dtype=torch.bfloat16, seed=0)
        if mode == "w8a8":
            model.quantize("w8a8")
        impl = model.use_pallas
        params = {k: v.detach() for k, v in model.state_dict().items()}

        def apply_fn(p, b, impl=impl):
            return vault_for_classification(param_tree(p), cfg, b, head_dropout=0.0,
                                            use_pallas=impl)

        batch = entry_batch(cfg, 16, dev, seed=11)
        dp = dp_sharded_forward(apply_fn, devices, params)
        tp = tp_forward(apply_fn, devices, params)
        with torch.inference_mode():
            reset_counts()
            out = dp(batch)
            torch.cuda.synchronize()
            dp_counts = read_counts()
            direct = torch.cat([model({k: v[i:i + 8] for k, v in batch.items()})
                                for i in (0, 8)])
            tp_out = tp({k: v[:8] for k, v in batch.items()})
            ref = (model({k: v[:8] for k, v in batch.items()}, use_pallas=False)
                   if mode == "bf16" else direct[:8])
        if not torch.equal(out, direct):
            fail(f"{mode} dp_sharded_forward vs the direct forward of each shard: "
                 f"max abs diff {(out.float() - direct.float()).abs().max().item()}")
        tp_err = (tp_out.float() - ref.float()).abs().max().item()
        if mode == "bf16" and tp_err > FORWARD_LIMITS["logits"]:
            fail(f"bf16 tp_forward logits vs the plain direct forward: {tp_err}")
        want = EVAL_LAUNCHES if mode == "bf16" else W8A8_LAUNCHES
        if dp_counts != {k: 2 * v for k, v in want.items()}:
            fail(f"{mode} dp_sharded_forward launches {dp_counts}, expected 2 x {want}")

        class Served:
            """The DP forward where ``serving_phase`` expects a model."""
            device = dev

            def __call__(self, b):
                return dp(b)

        serving_phase(Served(), {k: 2 * v for k, v in want.items()},
                      f"parallel_serving_{mode}")
        res[mode] = dict(dp_bit_equal=True, dp_launches=dp_counts, tp_logits_err=tp_err,
                         tp_gated=mode == "bf16")
        del model, params, dp, tp
        torch.cuda.empty_cache()
    emit(phase="parallel_serving", devices=[str(d) for d in devices], **res,
         limits=FORWARD_LIMITS, seconds=time.perf_counter() - t0)


def parallel_phase(dev):
    """The parallel group (see the section comment).  Returns the launch
    counts of its paths."""
    import shutil

    import torch

    from vault_tpu_torch.models.vault import VaultForClassification
    from vault_tpu_torch.parallel.multihost import spawn_workers
    from vault_tpu_torch.presets import vault_base

    t_group = time.perf_counter()
    deterministic_mode()
    cfg = vault_base("bert-base-uncased")
    shutil.rmtree(PARALLEL_DIR, ignore_errors=True)
    PARALLEL_DIR.mkdir(parents=True)
    out = PARALLEL_DIR.resolve()
    seconds = {}

    def job(role, n, timeout):
        try:
            spawn_workers(str(out / role), num_processes=n, scenario=role, timeout=timeout,
                          module="chip_smoke", extra=["--results", str(out)])
        except BaseException:
            (out / "abort").touch()  # the ranks stop waiting for the reference
            raise

    try:
        t0 = time.perf_counter()
        # the one-process reference and the one-rank NCCL group side by side,
        # and the two gloo ranks starting and setting up beside them
        with concurrent.futures.ThreadPoolExecutor(3) as pool:
            jobs = [pool.submit(job, "single", 1, 600), pool.submit(job, "nccl", 1, 600),
                    pool.submit(job, "ranks", 2, 900)]
            for j in jobs:
                j.result()
        seconds["workers"] = time.perf_counter() - t0
        single = json.loads((out / "single.json").read_text())
        nccl = json.loads((out / "nccl.json").read_text())
        n = len(nccl["grad_sums"])
        nccl_equal = (single["grad_sums"][:n] == nccl["grad_sums"]
                      and single["param_sums"][:n] == nccl["param_sums"])
        if not nccl_equal:
            fail("the one-rank NCCL group's steps are not bit-equal to one process's")
        if single["counts"] != [STEP_LAUNCHES] * PARALLEL_STEPS:
            fail(f"single-process step launches {single['counts']}")
        ranks = [json.loads((out / f"rank{r}.json").read_text()) for r in (0, 1)]
    finally:
        for p in out.glob("single*.pt"):
            p.unlink()
    r0 = ranks[0]
    for name in ("single", "nccl", "rank0", "rank1"):
        src = out / f"{name}.json"
        if src.exists():
            shutil.copy(src, OUT_DIR / f"parallel_{name}.json")
    problems = []
    for r in ranks:
        if r["dp_counts"] != [STEP_LAUNCHES] * PARALLEL_STEPS:
            problems.append(f"data-parallel launches per rank per step {r['dp_counts']}, "
                            f"expected {STEP_LAUNCHES}")
        if r["zero_unequal"]:
            problems.append(f"ZeRO-1 vs data parallelism, not bit-equal: {r['zero_unequal']}")
        routes = r["zero_routes"]
        if (routes["fused"], routes["loop"]) != (routes["leaves"], 0):
            problems.append(f"ZeRO-1's optimizer routes {routes}: every leaf on the kernel")
        if r["tp_counts"] != TP_LAUNCHES:
            problems.append(f"TP forward launches per rank {r['tp_counts']}, expected "
                            f"{TP_LAUNCHES}")
        if r["ckpt_unequal"]:
            problems.append(f"the resumed run's finals differ from the uninterrupted run's: "
                            f"{r['ckpt_unequal']} (max abs {r['ckpt_max_abs_diff']})")
    worst = max(s["worst"] for s in r0["dp_grad_rel"])
    if worst > STEP_LIMITS["grad_rel"] or any(s["bad"] for s in r0["dp_grad_rel"]):
        problems.append(f"data-parallel gradients vs one process: {r0['dp_grad_rel']}")
    if not (r0["tp_pooler_err"] <= FORWARD_LIMITS["pooler"]
            and r0["tp_logits_err"] <= FORWARD_LIMITS["logits"]):
        problems.append(f"TP forward vs one device's plain forward: pooler "
                        f"{r0['tp_pooler_err']}, logits {r0['tp_logits_err']}")
    if (r0["tp_step_grad_rel_worst"] > STEP_LIMITS["grad_rel"]
            or r0["tp_step_loss_diff"] > STEP_LIMITS["loss"] or r0["tp_step_bad"]):
        problems.append(f"TP step vs one device: loss diff {r0['tp_step_loss_diff']}, worst "
                        f"{r0['tp_step_grad_rel_worst']} ({r0['tp_step_worst_leaf']})")
    step_ms = [float(np.median(r["dp_wall_ms"])) for r in ranks]
    coll_ms = [float(np.median(r["dp_all_reduce_ms"])) for r in ranks]
    emit(phase="parallel_dp", backend=r0["backend"], ranks=2, device=str(dev),
         global_batch=TRAIN_BATCH, rows_per_rank=TRAIN_BATCH // 2, steps=PARALLEL_STEPS,
         launches_per_rank_per_step=r0["dp_counts"][0], grad_rel_per_step=r0["dp_grad_rel"],
         param_max_abs_vs_single=r0["dp_param_max_abs_vs_single"],
         step_wall_ms=[r["dp_wall_ms"] for r in ranks],
         all_reduce_wall_ms=[r["dp_all_reduce_ms"] for r in ranks],
         collective_share_of_step_wall=[c / s for c, s in zip(coll_ms, step_ms)],
         traced_step=[r["dp_trace"] for r in ranks],
         single_step_wall_ms=single["wall_ms"], limits=STEP_LIMITS,
         nccl_one_rank=dict(backend="nccl", bit_equal_to_single=nccl_equal,
                            step_wall_ms=nccl["wall_ms"]),
         waited_for_reference_s=r0["waited_s"], seconds=r0["dp_s"])
    emit(phase="parallel_zero", backend=r0["backend"], ranks=2,
         moment_dtype=r0["moment_dtype"], bit_equal_leaves=r0["zero_leaves"],
         optimizer_routes=[r["zero_routes"] for r in ranks],
         moment_bytes_per_rank=[r["zero_moment_bytes"] for r in ranks],
         dp_moment_bytes_per_rank=[r["dp_moment_bytes"] for r in ranks],
         step_wall_ms=[r["zero_wall_ms"] for r in ranks],
         param_gather_ms_per_step=[r["zero_gather_ms"] for r in ranks],
         seconds=r0["zero_s"])
    emit(phase="parallel_tp", backend=r0["backend"], ranks=2, heads_per_rank=6,
         batch=TP_BATCH, launches_per_rank=r0["tp_counts"],
         pooler_max_abs_err=r0["tp_pooler_err"], logits_max_abs_err=r0["tp_logits_err"],
         limits=FORWARD_LIMITS, forward_wall_ms=r0["tp_forward_ms"],
         step_loss_diff=r0["tp_step_loss_diff"],
         step_grad_rel_worst=r0["tp_step_grad_rel_worst"],
         step_worst_leaf=r0["tp_step_worst_leaf"],
         step_grad_rel_median=r0["tp_step_grad_rel_median"],
         w8a8_logits_dist_reported=r0["tp_w8a8_logits_dist"], seconds=r0["tp_s"])
    emit(phase="parallel_ckpt", backend=r0["backend"], ranks=2, zero_opt=True,
         steps=CKPT_STEPS, checkpoint_every=CKPT_EVERY, interrupted_after=CKPT_STOP,
         bit_equal_leaves=r0["ckpt_leaves"], max_abs_diff=r0["ckpt_max_abs_diff"],
         files=r0["ckpt_files"], seconds=r0["ckpt_s"])
    if problems:
        fail("; ".join(problems))

    model_f32 = VaultForClassification(cfg, device=dev, dtype=torch.float32, seed=0)
    pipe_counts = pipeline_leg(dev, cfg, model_f32)
    del model_f32
    torch.cuda.empty_cache()
    serving_leg(dev, cfg)
    torch.use_deterministic_algorithms(False)
    shutil.rmtree(PARALLEL_DIR, ignore_errors=True)
    emit(phase="parallel", seconds=time.perf_counter() - t_group,
         legs_seconds=seconds)
    return {"parallel_dp_step": r0["dp_counts"][0], "parallel_tp_forward": r0["tp_counts"],
            "parallel_pipeline_forward": pipe_counts}


# ---------------------------------------------------------------------------
# The bench CLIs
# ---------------------------------------------------------------------------

# The chained forward's busy ms per forward, less the chain's own adds
# (feedback_ms), against the vault group's busy ms of model(batch) at batch
# 16: the same kernels on the same shapes, so within this share.
BENCH_BUSY_SHARE = 0.05
# Busy time is a part of the wall time of the same calls: at most this
# factor of the slope (the two are taken in separate runs).
BUSY_OVER_SLOPE = 1.05
MFU_LIMIT_PCT = 95.0
# The CLIs' chains here are shorter than their defaults (bench K 2..22 x 3,
# ablate_train 2..8 x 2, perf_sweep 2..12 x 3), so that the whole run stays
# near its time budget; the bench's training leg keeps train_bench's.
BENCH_ARGV = ("--k_hi", "12", "--repeats", "2")
ABLATE_ARGV = ("--k_lo", "1", "--k_hi", "3", "--repeats", "1")
SWEEP_ARGV = ("--k_hi", "6", "--repeats", "2")


def run_cli(main, environ, argv=()):
    """A bench CLI's ``main`` in this process: (what it returns, the JSON
    lines it printed), each line parsed."""
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        ret = main(list(argv), environ=environ)
    lines = [ln for ln in buf.getvalue().splitlines() if ln.strip()]
    try:
        return ret, [json.loads(ln) for ln in lines]
    except ValueError:
        fail(f"{main.__module__} printed a line that is not JSON: {lines}")


def check_busy(name, busy, slope):
    if not busy <= BUSY_OVER_SLOPE * slope:
        fail(f"bench {name}: busy {busy} ms > {BUSY_OVER_SLOPE} x the slope {slope} ms")


def bench_phase(dev):
    """``cli.bench`` with its training leg (``VAULT_BENCH_TRAIN=1``), then
    ``cli.ablate_train`` at the train bench's defaults, then
    ``cli.perf_sweep`` at batch 16 over the plain path and the kernels, each
    in this process at full width and depth.  Gates: the guard sound for the
    forward and the training chains on both counts (products and the
    kernels' launches, a direct forward's and step's exactly), every MFU at
    most 95%, busy at most 1.05 x the slope, the chained forward's busy ms
    (less the chain's own adds) within 5% of the vault group's at batch 16,
    the plain leg's busy time above the kernels'.  Reported: the host
    synchronizations of a chained forward, by line."""
    import torch

    from vault_tpu_torch.cli import ablate_train, bench, perf_sweep
    from vault_tpu_torch.models.vault import VaultForClassification
    from vault_tpu_torch.presets import vault_base

    seconds = {}
    reset_counts()
    t0 = time.perf_counter()
    rec, lines = run_cli(bench.main, {"VAULT_BENCH_TRAIN": "1"}, BENCH_ARGV)
    if lines != [json.loads(json.dumps(rec))]:
        fail(f"cli.bench printed {len(lines)} lines, not its one record")
    seconds["bench"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    split, lines = run_cli(ablate_train.main, {}, ABLATE_ARGV)
    if lines != [json.loads(json.dumps(split))]:
        fail(f"cli.ablate_train printed {len(lines)} lines, not its one record")
    seconds["ablate_train"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    rows, lines = run_cli(perf_sweep.main, {"PERF_SWEEP_BATCHES": "16",
                                            "PERF_SWEEP_IMPLS": "0,1"}, SWEEP_ARGV)
    if lines != json.loads(json.dumps(rows)) or len(rows) != 2:
        fail(f"cli.perf_sweep printed {lines}, not one record for each of 2 legs")
    seconds["perf_sweep"] = time.perf_counter() - t0
    torch.cuda.synchronize()
    counts = read_counts()
    train = rec["train"]

    # the guard, on both counts, and exact launches per iteration
    for name, r, want in (("forward", rec, EVAL_LAUNCHES), ("train", train, STEP_LAUNCHES)):
        if not (r["guard_sound"] and r["launches_checked"]) or "suspect" in r:
            fail(f"bench {name} chain: the guard failed ({r.get('suspect')})")
        got = r["launches_per_forward" if name == "forward" else "launches_per_step"]
        if got != want:
            fail(f"bench {name} chain: launches per iteration {got}, expected {want}")
    missing = [k for k, v in counts.items()
               if v == 0 and (EVAL_LAUNCHES[k] or STEP_LAUNCHES[k])]
    if missing:
        fail(f"bench group: kernels of its path never launched: {missing}")
    for key, r in (("fwd_mfu_pct", rec), ("fwd_busy_mfu_pct", rec),
                   ("train_mfu_pct", train), ("train_busy_mfu_pct", train)):
        if not 0 < r[key] <= MFU_LIMIT_PCT:
            fail(f"bench {key} {r[key]} outside (0, {MFU_LIMIT_PCT}]")
    check_busy("forward", rec["busy_ms"], rec["ms_per_step"])
    check_busy("train", train["busy_ms"], train["ms_per_train_step"])
    for name, v in split["variants"].items():
        check_busy(f"ablate {name}", v["busy_ms"], v["ms"])
    for row in rows:
        check_busy(f"sweep impl {row['impl']}", row["busy_ms"], row["ms_per_step"])

    # the chained forward's kernels against a direct forward's
    ref = FORWARD_BUSY_MS.get(16)
    if ref is None:  # the vault group did not run: a direct forward here
        cfg = vault_base("bert-base-uncased")
        model = VaultForClassification(cfg, n_classes=3, device=dev,
                                       dtype=torch.bfloat16, seed=0)
        b16 = entry_batch(cfg, 16, dev, seed=1)
        with torch.inference_mode():
            ref = device_ms(lambda: model(b16), iters=3, warmup=1)[0]
        del model, b16
        torch.cuda.empty_cache()
    share = rec["busy_ms_net"] / ref - 1.0
    if not abs(share) <= BENCH_BUSY_SHARE:
        fail(f"bench: chained busy {rec['busy_ms_net']} ms a forward (less the chain's "
             f"adds, {rec['feedback_ms']} ms) is {share:+.3%} from the vault group's "
             f"{ref} ms at batch 16")
    plain, kernel = sorted(rows, key=lambda r: r["impl"])
    if not plain["busy_ms"] > kernel["busy_ms"]:
        fail(f"sweep: the plain leg's busy {plain['busy_ms']} ms is not above the "
             f"kernels' {kernel['busy_ms']} ms")
    if rec["host_syncs_per_forward"]:
        print(f"chip_smoke: {rec['host_syncs_per_forward']} host synchronizations per "
              f"chained forward: {rec['host_sync_sites']}", file=sys.stderr, flush=True)
    emit(phase="bench", forward=rec, ablate_train=split, sweep=rows,
         vault_busy_ms_batch16=ref, chained_vs_vault_busy=share,
         launches_in_group=counts, seconds=seconds)
    return {"bench_forward": rec["launches_per_forward"],
            "bench_train_step": train["launches_per_step"]}


PHASES = ("kernels", "attn_bwd", "moe", "vault", "w8", "llama", "train", "merge", "serve", "tasks",
          "baselines", "options", "parallel", "bench")


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma-separated groups of phases to run (default: all)")
    phases = [p for p in ap.parse_args().phases.split(",") if p]
    if set(phases) - set(PHASES):
        fail(f"unknown phases {sorted(set(phases) - set(PHASES))}; known: {PHASES}")
    try:
        import torch
    except ImportError:
        fail("PyTorch is not installed")
    if not torch.cuda.is_available():
        fail("no CUDA device: the chip smoke test runs only on the card")
    try:
        from vault_tpu_torch.ops import _build
    except ImportError as e:
        fail(f"the vault_tpu_torch package is not importable here ({e}); run "
             "from the root of the repository")
    if _IMPORT_ERROR is not None:
        fail(f"vault_tpu_torch.utils.profiling does not import: {_IMPORT_ERROR}")
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    OUT_DIR.mkdir(parents=True, exist_ok=True)

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    emit(phase="card", nvidia_smi=smi, torch=torch.__version__,
         cuda=torch.version.cuda, device=torch.cuda.get_device_name(0))

    t0 = time.perf_counter()
    built = _build.build_all()
    build_s = time.perf_counter() - t0
    ptxas = {}
    for name, (_, log) in built.items():
        (OUT_DIR / f"nvcc_{name}.log").write_text(log)
        ptxas[name] = [ln.split("ptxas info    : ")[-1] for ln in log.splitlines()
                       if "Used" in ln or "spill" in ln]
    emit(phase="build", seconds=build_s,
         per_source={k: v[0] for k, v in built.items()}, ptxas=ptxas)

    # seconds of each group of phases, printed at the end of the run
    group_s, last = {}, [time.perf_counter()]

    def lap(name):
        now = time.perf_counter()
        group_s[name] = now - last[0]
        last[0] = now

    gen = torch.Generator(device=dev).manual_seed(0)
    checks, path_counts = {}, {}
    if "kernels" in phases:
        check_gemm_core(gen, dev)
        check_gemm_core_s8(gen, dev)
        check_postln_tiles(gen, dev)
        check_lnqkv_tiles(gen, dev)
        checks["encoder_attention"] = check_attention(gen, dev)
        checks["mlp_block"] = check_mlp(gen, dev, postln=False)
        checks["mlp_postln"] = check_mlp(gen, dev, postln=True)
        checks["mlp_block_bwd"] = check_mlp_bwd(gen, dev, postln=False)
        checks["mlp_postln_bwd"] = check_mlp_bwd(gen, dev, postln=True)
        tiles_rows = check_mlp_tiles(dev)
        for name in INT8_KERNELS:
            checks[name] = check_int8_family(gen, dev, name)
        checks["attention_gqa"] = check_attention_gqa(gen, dev)
        checks["swiglu_w8a8"] = check_swiglu(gen, dev)
        checks["linear_w8a8"] = check_linear_w8a8(gen, dev)
        torch.cuda.empty_cache()

    lap("kernels")
    attn_bwd_rows = check_attention_bwd(gen, dev) if "attn_bwd" in phases else None
    lap("attn_bwd")
    moe_row = moe_phase(dev, gen) if "moe" in phases else None
    lap("moe")
    if "vault" in phases or "w8" in phases:
        model, cfg, path_counts["forward"] = forward_phase(dev)
    if "vault" in phases:
        serving_phase(model)
        path_counts["forward_fuselnqkv"] = lnqkv_phase(model, cfg, dev)
        qmodel, path_counts["forward_w8a8"] = w8a8_forward_phase(dev, cfg, model)
        serving_phase(qmodel, W8A8_LAUNCHES, "serving_w8a8")
        del qmodel
    if "w8" in phases:
        qmodel, path_counts["forward_w8"] = w8_forward_phase(dev, cfg, model)
        serving_phase(qmodel, W8_LAUNCHES, "serving_w8")
        del qmodel
    if "vault" in phases or "w8" in phases:
        del model
        torch.cuda.empty_cache()
    lap("vault_w8")
    geometry_rows = []
    if "llama" in phases:
        path_counts["llama_w8a8"] = llama_phase(dev)
        geometry_counts, geometry_rows = llama_geometries_phase(dev)
        path_counts.update({f"llama {k}": v for k, v in geometry_counts.items()})
    lap("llama")
    step_counts = launches()
    if "train" in phases:
        cfg, step_counts = train_step_phase(dev)
        path_counts["train_step"] = step_counts
        trainer_phase(dev, cfg)
    lap("train")
    if "merge" in phases:
        from vault_tpu_torch.presets import vault_base

        cfg = vault_base("bert-base-uncased")
        model, path_counts["forward_merged"] = merged_forward_phase(dev, cfg)
        qmodel, path_counts["forward_merged_w8a8"] = merged_w8a8_phase(dev, cfg)
        serving_phase(qmodel, W8A8_LAUNCHES, "serving_merged_w8a8")
        del qmodel
        merged_mid_phase(dev, cfg, model)
        del model
        torch.cuda.empty_cache()
        _, path_counts["train_step_merged"] = train_step_phase(dev, merge_to=MERGE_TO)
    lap("merge")
    if "serve" in phases:
        path_counts.update(serve_phase(dev))
    lap("serve")
    if "tasks" in phases:
        path_counts.update(tasks_phase(dev))
    lap("tasks")
    if "baselines" in phases:
        path_counts.update(baselines_phase(dev))
    lap("baselines")
    dots_counts = launches()
    if "options" in phases:
        dots_counts, counts = options_phase(dev)
        path_counts.update(counts)
    lap("options")
    if "parallel" in phases:
        path_counts.update(parallel_phase(dev))
    lap("parallel")
    if "bench" in phases:
        path_counts.update(bench_phase(dev))
    lap("bench")
    emit(phase="groups", seconds=group_s, build_s=build_s,
         total_s=sum(group_s.values()) + build_s)
    emit(phase="trace_checks", short_share=TRACE_SHORT_SHARE, long_share=TRACE_LONG_SHARE,
         launch_gap_ms=LAUNCH_GAP_MS, **TRACE_LOG)
    if set(phases) != set(PHASES):
        print(json.dumps({"partial": sorted(phases)}), flush=True)
        return

    sources = {"encoder_attention": ("vault_tpu_torch/csrc/attention.cu",
                                     "vault_tpu/ops/pallas_attention.py:92"),
               "mlp_block": ("vault_tpu_torch/csrc/mlp.cu",
                             "vault_tpu/ops/pallas_mlp.py:132"),
               "mlp_postln": ("vault_tpu_torch/csrc/mlp.cu",
                              "vault_tpu/ops/pallas_mlp.py:832"),
               "mlp_block_bwd": ("vault_tpu_torch/csrc/mlp_bwd.cu",
                                 "vault_tpu/ops/pallas_mlp.py:523"),
               "mlp_postln_bwd": ("vault_tpu_torch/csrc/mlp_bwd.cu",
                                  "vault_tpu/ops/pallas_mlp.py:1231"),
               "ln_qkv": ("vault_tpu_torch/csrc/ln_qkv.cu",
                          "vault_tpu/ops/pallas_mlp.py:282"),
               "ln_qkv_w8a8": ("vault_tpu_torch/csrc/ln_qkv.cu",
                               "vault_tpu/ops/pallas_mlp.py:360"),
               "mlp_block_w8a8": ("vault_tpu_torch/csrc/mlp_w8a8.cu",
                                  "vault_tpu/ops/pallas_mlp.py:720"),
               "mlp_postln_w8a8": ("vault_tpu_torch/csrc/mlp_w8a8.cu",
                                   "vault_tpu/ops/pallas_mlp.py:1054"),
               "mlp_block_q8": ("vault_tpu_torch/csrc/mlp.cu",
                                "vault_tpu/ops/pallas_mlp.py:607"),
               "mlp_postln_q8": ("vault_tpu_torch/csrc/mlp.cu",
                                 "vault_tpu/ops/pallas_mlp.py:966"),
               "attention_gqa": ("vault_tpu_torch/csrc/attention_gqa.cu",
                                 "vault_tpu/ops/pallas_attention.py:214"),
               "swiglu_w8a8": ("vault_tpu_torch/csrc/swiglu_w8a8.cu",
                               "vault_tpu/ops/pallas_swiglu.py:186"),
               "linear_w8a8": ("vault_tpu_torch/csrc/linear_w8a8.cu",
                               "vault_tpu/ops/nn.py:29")}
    # each kernel's launches in the run of the path that drives it
    # (path_counts, in the order the paths ran)
    kernels = []
    for name, rows in checks.items():
        timed = [r for r in rows if "ms" in r and r.get("path", "forward") == "forward"]
        at_train_rows = [r for r in rows if "ms" in r and r.get("path") == "train"]
        # attention: the main path launches it equally often at L = 40 and
        # L = 256, so its numbers are the mean over those two shapes
        mean = lambda key: sum(r[key] for r in timed) / len(timed)
        # launches: from the first path that runs the kernel (the bf16
        # forward, the fuselnqkv, w8a8 and w8 forwards, the Llama-tower
        # forward, a training step)
        path, n_launches = next(((p, c[name]) for p, c in path_counts.items()
                                 if c[name]), (None, 0))
        entry = dict(name=name, route="cuda", source=sources[name][0],
                     replaces=sources[name][1], launches=n_launches,
                     launches_path=path,
                     launches_per_train_step=step_counts[name],
                     launches_per_dots_step=dots_counts[name],
                     max_abs_err=max(r["max_abs_err"] for r in timed),
                     ms=mean("ms"), wall_ms=mean("wall_ms"), plain_ms=mean("plain_ms"),
                     bound_ms=mean("bound_ms"),
                     bound_by=max(timed, key=lambda r: r["bound_ms"])["bound_by"],
                     library_ms=mean("library_ms"))
        if name == "encoder_attention":
            entry["replaces_also"] = ["vault_tpu/ops/pallas_attention.py:148",
                                      "vault_tpu/ops/pallas_attention.py:245"]
        if name.endswith("_bwd"):
            entry["wrapper_ms"] = mean("wrapper_ms")
        if timed[0].get("route") == "wgmma":  # a block redesigned on the wgmma core
            entry.update(design="wgmma", device_kernels=timed[0]["device_kernels"])
        if "library" in timed[0]:
            entry["library"] = timed[0]["library"]
        if "library_row_major_ms" in timed[0]:
            entry["library_row_major_ms"] = mean("library_row_major_ms")
        fp32 = tiles_rows.get(name)
        if fp32 is not None:  # the fp32 block on the fp32 tiles, at H 768
            entry.update(fp32_rows=fp32["rows"], fp32_ms=fp32["ms"],
                         fp32_plain_ms=fp32["plain_ms"], fp32_library_ms=fp32["library_ms"],
                         fp32_bound_ms=fp32["bound_ms"], fp32_bound_by=fp32["bound_by"],
                         fp32_max_abs_err=fp32["max_abs_err"])
        for r in at_train_rows:  # the forward kernels at the training rows
            entry.update(train_rows=r["rows"], train_ms=r["ms"],
                         train_plain_ms=r["plain_ms"],
                         train_library_ms=r["library_ms"],
                         train_bound_ms=r["bound_ms"], train_bound_by=r["bound_by"])
            if r.get("route") == "wgmma":
                entry["train_device_kernels"] = r["device_kernels"]
        kernels.append(entry)
    # the Llama tower's two kernels at the published geometries of
    # LLAMA_GEOMETRIES: the widened SwiGLU and padded GQA instances beside the
    # exact ones, launches from that geometry's forward
    for r in geometry_rows:
        kernels.append(dict(
            name=f"{r['kernel']}@{r['geometry']}", route="cuda",
            source=sources[r["kernel"]][0], replaces=sources[r["kernel"]][1],
            launches=r["launches"], launches_path=f"llama {r['geometry']}",
            instance=r["instance"], max_abs_err=r["max_abs_err"], ms=r["ms"],
            wall_ms=r["wall_ms"], plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
            bound_by=r["bound_by"], library_ms=r["library_ms"], library=r["library"],
            design="wgmma", device_kernels=r["device_kernels"]))
    # the routed experts (no TPU kernel: the JAX package has none), launches
    # from the Moonlight tower's forward
    kernels.append(dict(
        name="moe_experts", route="cuda", source="vault_tpu_torch/csrc/moe_experts.cu",
        replaces=None, launches=moe_row["launches"], launches_path=moe_row["launches_path"],
        kernel_launches=moe_row["kernel_launches"], max_abs_err=moe_row["max_abs_err"],
        ms=moe_row["ms"], wall_ms=moe_row["wall_ms"], plain_ms=moe_row["plain_ms"],
        bound_ms=moe_row["bound_ms"], bound_by=moe_row["bound_by"],
        bound_share=moe_row["bound_share"], design="wgmma",
        device_kernels=moe_row["device_kernels"]))
    # the attention backward kernel (no TPU kernel: the JAX package
    # recomputes through XLA), at ViLT's training shape, launches from a
    # training step
    r = attn_bwd_rows[0]
    kernels.append(dict(
        name="attention_bwd", route="cuda", source="vault_tpu_torch/csrc/attention_bwd.cu",
        replaces=None, launches=step_counts["attention_bwd"], launches_path="train_step",
        shape=r["shape"], rel_err_by_output=r["rel_err_by_output"], ms=r["ms"],
        wall_ms=r["wall_ms"], plain_ms=r["plain_ms"], parent_path_ms=r["parent_path_ms"],
        bound_ms=r["bound_ms"], bound_by=r["bound_by"], bound_share=r["bound_share"],
        library_ms=r["library_ms"], design="wgmma", device_kernels=r["device_kernels"]))
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    if len(sys.argv) > 4 and sys.argv[1].isdigit():
        parallel_worker(sys.argv[1:])
    else:
        main()
