"""2-stage pipelined VAuLT (port of ``vault_tpu/parallel/pipeline.py``, the
rebuild of the reference's ``PipelineVaultMixin``,
vault/models/vault/model.py:221-366).

The language tower runs on one device and ViLT (with the heads) on
another; the batch is split into micro-batches, and the LM of micro-batch
i + 1 overlaps ViLT on micro-batch i.  Where the JAX package gets the
overlap from asynchronous dispatch, here each stage runs on its own CUDA
stream and the handoff is an event: the ViLT stream waits for the event
recorded after the LM produced the activation, as the reference's streams
did.  With one card both stages run on ``cuda:0``, on two streams (the JAX
package's default also puts both stages on its first device when there is
only one).  On the CPU the stages run in order.

For intra-model scaling use data or tensor parallelism instead
(parallel/mesh.py, parallel/tensor_parallel.py); this module exists for
parity with the reference's only model-parallel construct.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, List, Mapping, Optional

import numpy as np
import torch

from vault_tpu_torch.config import VaultConfig
from vault_tpu_torch.convert import param_tree
from vault_tpu_torch.models import vilt as vilt_mod
from vault_tpu_torch.models.vault import (
    batch_to_device,
    classifier_head_apply,
    lm_encode,
    resolve_device,
)


def default_devices(lm_device=None, vilt_device=None):
    """(lm_device, vilt_device): the named ones, else the first card for
    the LM and the second (the first again on a one-card machine) for
    ViLT."""
    lm = resolve_device(lm_device)
    if vilt_device is not None:
        return lm, resolve_device(vilt_device)
    if lm.type == "cuda" and torch.cuda.device_count() > 1:
        return lm, torch.device("cuda", 1)
    return lm, lm


class _Stage:
    """A device and, on a card, the stream the stage's work goes on."""

    def __init__(self, device: torch.device):
        self.device = device
        self.stream = (torch.cuda.Stream(device=device) if device.type == "cuda"
                       else None)

    def __enter__(self):
        self._ctx = (torch.cuda.stream(self.stream) if self.stream is not None
                     else contextlib.nullcontext())
        return self._ctx.__enter__()

    def __exit__(self, *exc):
        return self._ctx.__exit__(*exc)

    def handoff(self, t: torch.Tensor, to: "_Stage") -> torch.Tensor:
        """``t`` (made on this stage's stream) for use on stage ``to``:
        ``to``'s stream waits for an event recorded here; the copy, when
        the devices differ, runs on ``to``'s stream."""
        if self.stream is None and to.stream is None:
            return t.to(to.device)
        event = torch.cuda.Event()
        event.record(self.stream)
        with to:
            if to.stream is not None:
                to.stream.wait_event(event)
            out = t.to(to.device)
            if out is t and to.stream is not None:
                # the allocator must not reuse t's memory before to's stream is done
                t.record_stream(to.stream)
        return out

    def start(self):
        """This stage's stream waits for the caller's: the inputs, the
        weights' last update and the memory the caller freed are ready."""
        if self.stream is not None:
            self.stream.wait_stream(torch.cuda.current_stream(self.device))

    def join(self):
        """The caller's stream waits for this stage's work."""
        if self.stream is not None:
            torch.cuda.current_stream(self.device).wait_stream(self.stream)


def _split_tree(params: Mapping[str, torch.Tensor], prefix: str, device):
    n = len(prefix) + 1
    return param_tree({k[n:]: v.to(device) for k, v in params.items()
                       if k.startswith(prefix + ".")})


def _micro_slices(n: int, num_micro: int) -> List[slice]:
    """The ceil split of ``n`` rows into at most ``num_micro`` non-empty
    micro-batches (the last may be shorter)."""
    nm = min(num_micro, max(int(n), 1))
    size = -(-n // nm)
    # with size = ceil(n / nm) the last slices may be empty (n = 9,
    # num_micro = 4 -> [0:3], [3:6], [6:9], [9:9]); count only non-empty ones
    nm = -(-max(int(n), 1) // size)
    return [slice(i * size, min(n, (i + 1) * size)) for i in range(nm)]


def _generator(seed: int, stage: int, micro: int, device) -> torch.Generator:
    state = np.random.SeedSequence([int(seed), stage, micro]).generate_state(
        1, np.uint64)[0]
    return torch.Generator(device=device).manual_seed(int(state >> 1))


class PipelineVault:
    """The VAuLT backbone as a 2-stage pipeline.  ``params``: a state dict
    (or module) with ``bert.*`` and ``vilt.*`` keys; ``inner_batch_size``:
    the micro-batch rows (the whole batch when None).  Calling it returns
    the :class:`~vault_tpu_torch.models.vilt.ViltOutput` on the ViLT device
    (or ``output_device``)."""

    def __init__(self, params, cfg: VaultConfig, lm_device=None, vilt_device=None,
                 output_device=None, inner_batch_size: Optional[int] = None,
                 use_pallas="auto"):
        if cfg.text_tower is None:
            raise ValueError("the pipeline needs the LM tower")
        if isinstance(params, torch.nn.Module):
            params = params.state_dict()
        lm, vd = default_devices(lm_device, vilt_device)
        self.lm, self.vilt = _Stage(lm), _Stage(vd)
        self.lm_device, self.vilt_device = lm, vd
        self.output_device = output_device
        self.inner_batch_size = inner_batch_size
        self.cfg = cfg
        self.use_pallas = use_pallas
        self.bert_params = _split_tree(params, "bert", lm)
        self.vilt_params = _split_tree(params, "vilt", vd)

    @torch.no_grad()
    def __call__(self, input_ids, attention_mask=None, token_type_ids=None,
                 pixel_values=None, pixel_mask=None) -> vilt_mod.ViltOutput:
        if pixel_values is None:
            raise ValueError("PipelineVault requires pixel_values (the ViLT "
                             "stage has no external image_embeds path here)")
        n = input_ids.shape[0]
        if attention_mask is None:
            attention_mask = torch.ones(input_ids.shape, dtype=torch.int64)
        if token_type_ids is None:
            token_type_ids = torch.zeros(input_ids.shape, dtype=torch.int64)
        if pixel_mask is None:
            pixel_mask = torch.ones((n, *pixel_values.shape[2:]), dtype=torch.int64)
        batch = dict(input_ids=input_ids, attention_mask=attention_mask,
                     token_type_ids=token_type_ids, pixel_values=pixel_values,
                     pixel_mask=pixel_mask)
        mb = self.inner_batch_size or n
        micros = [{k: v[i:i + mb] for k, v in batch.items()} for i in range(0, n, mb)]
        vilt_cfg = self.cfg.resolved_vilt()
        self.lm.start()
        self.vilt.start()

        def lm_step(m):
            with self.lm:
                d = batch_to_device(m, self.lm_device)
                return lm_encode({"bert": self.bert_params}, self.cfg, d["input_ids"],
                                 d["attention_mask"], d["token_type_ids"],
                                 use_pallas=self.use_pallas)

        def vilt_step(m, hidden):
            hidden = self.lm.handoff(hidden, self.vilt)
            with self.vilt:
                d = batch_to_device(m, self.vilt_device)
                out = vilt_mod.vilt_apply(
                    self.vilt_params, vilt_cfg, attention_mask=d["attention_mask"],
                    token_type_ids=d["token_type_ids"], pixel_values=d["pixel_values"],
                    pixel_mask=d["pixel_mask"], inputs_embeds=hidden,
                    use_pallas=self.use_pallas)
                return out.last_hidden_state, out.pooler_output

        # the 1-deep software pipeline: LM(i + 1) is issued before ViLT(i)
        outs, hidden = [], [None] * len(micros)
        for i, m in enumerate(micros):
            hidden[i] = lm_step(m)
            if i > 0:
                outs.append(vilt_step(micros[i - 1], hidden[i - 1]))
        outs.append(vilt_step(micros[-1], hidden[-1]))
        self.lm.join()
        self.vilt.join()
        last = torch.cat([o[0] for o in outs])
        pooled = torch.cat([o[1] for o in outs])
        if self.output_device is not None:
            last, pooled = last.to(self.output_device), pooled.to(self.output_device)
        return vilt_mod.ViltOutput(last_hidden_state=last, pooler_output=pooled,
                                   attention_mask=None)


def make_pipeline_train_fn(cfg: VaultConfig, loss_fn: Callable, params=None,
                           lm_device=None, vilt_device=None, num_micro: int = 2,
                           head_dropout: float = 0.0, use_pallas="auto",
                           remat=False, compute_dtype=None) -> Callable:
    """The differentiable 2-stage pipeline (the reference's
    ``PipelineVaultMixin`` trained through autograd across its two devices,
    vault/models/vault/model.py:327-366).  Three stage programs:

      * the LM forward (LM device), without a graph;
      * stage 2 (ViLT device): ViLT and the head, forward and backward,
        giving the weighted loss *sum*, the gradients of ViLT and the head,
        and the cotangent of the incoming activation;
      * the LM backward (LM device) by recompute, with stage 2's
        cotangent: the forward is run again from a generator in the state
        the first run had, so it redraws the same dropout masks.

    Micro-batch i's LM forward is issued before stage 2 of i - 1 (the
    1-deep pipeline), each stage on its own stream; each stage's gradients
    accumulate on its own device.  ``loss_fn(logits, labels, weight)`` is a
    weighted mean (training/losses.py); the micro losses are re-weighted
    into sums, so unequal micro sizes are exact.

    Returns ``fn(params, batch, labels, weight, seed=None) -> (loss,
    grads)``: ``params`` placed by :func:`place_pipeline_params`, ``grads``
    keyed like it, each on its stage's device; ``seed`` None runs without
    dropout, else the 2 x (micro-batches) generators are seeded from it.
    ``compute_dtype`` (e.g. ``torch.bfloat16``): the stages run on casts of
    the float leaves, differentiable back to the masters, as the trainer's
    ``compute_dtype`` does.  (``params`` here is only the JAX signature's
    structure prototype.)"""
    del params
    lm_dev, vilt_dev = default_devices(lm_device, vilt_device)
    lm, vs = _Stage(lm_dev), _Stage(vilt_dev)
    vilt_cfg = cfg.resolved_vilt()

    def lm_forward(bert_p, mb, gen):
        return lm_encode({"bert": bert_p}, cfg, mb["input_ids"], mb["attention_mask"],
                         mb.get("token_type_ids"), deterministic=gen is None,
                         generator=gen, use_pallas=use_pallas, remat=remat)

    def cast(t):
        return t.to(compute_dtype) if compute_dtype and t.is_floating_point() else t

    def fn(params, batch, labels, weight, seed: Optional[int] = None):
        n = int(np.shape(labels)[0])
        slices = _micro_slices(n, num_micro)
        bert_keys = [k for k in params if k.startswith("bert.")]
        rest_keys = [k for k in params if not k.startswith("bert.")]

        def bert_p():  # the LM tree, cast where the graph records it
            return param_tree({k[5:]: cast(params[k]) for k in bert_keys})

        lm_train = [k for k in bert_keys if params[k].requires_grad]
        s2_train = [k for k in rest_keys if params[k].requires_grad]
        weight_t = torch.as_tensor(np.asarray(weight, np.float32))
        labels_t = torch.as_tensor(np.asarray(labels))

        lm.start()
        vs.start()

        def gen(stage, i, device):
            return None if seed is None else _generator(seed, stage, i, device)

        def lm_batch(i):
            return batch_to_device({k: v[slices[i]] for k, v in batch.items()
                                    if k in ("input_ids", "attention_mask",
                                             "token_type_ids")}, lm_dev)

        def run_stage2(i, hidden):
            hidden = lm.handoff(hidden, vs)
            with vs:
                mb = batch_to_device({k: v[slices[i]] for k, v in batch.items()},
                                     vilt_dev)
                lb = labels_t[slices[i]].to(vilt_dev)
                wb = weight_t[slices[i]].to(vilt_dev)
                g = gen(1, i, vilt_dev)
                h = hidden.detach().requires_grad_(True)
                with torch.enable_grad():
                    tree = param_tree({k: cast(params[k]) for k in rest_keys})
                    out = vilt_mod.vilt_apply(
                        tree["vilt"], vilt_cfg, attention_mask=mb["attention_mask"],
                        token_type_ids=mb.get("token_type_ids"),
                        pixel_values=mb["pixel_values"], pixel_mask=mb["pixel_mask"],
                        inputs_embeds=h, deterministic=g is None, generator=g,
                        use_pallas=use_pallas, remat=remat)
                    logits = classifier_head_apply(tree["head"], out.pooler_output,
                                                   head_dropout, g is None, g)
                    # weighted SUM form so micro-batch contributions add exactly
                    val = loss_fn(logits, lb, wb) * wb.sum()
                    grads = torch.autograd.grad(
                        val, [params[k] for k in s2_train] + [h], allow_unused=True)
                return val.detach(), grads[:-1], grads[-1]

        # ---- the 1-deep pipeline: LM(i + 1) is issued before stage 2 of i
        hiddens, stage2 = [None] * len(slices), [None] * len(slices)
        for i in range(len(slices)):
            with lm, torch.no_grad():
                hiddens[i] = lm_forward(bert_p(), lm_batch(i), gen(0, i, lm_dev))
            if i > 0:
                stage2[i - 1] = run_stage2(i - 1, hiddens[i - 1])
        stage2[-1] = run_stage2(len(slices) - 1, hiddens[-1])

        # ---- the backward shuttle: cotangents cross ViLT -> LM per micro-batch
        loss_sum, g_s2, g_lm = None, None, None
        for i, (val, grads, g_hidden) in enumerate(stage2):
            loss_sum = val if loss_sum is None else loss_sum + val
            grads = [torch.zeros_like(params[k]) if g is None else g
                     for k, g in zip(s2_train, grads)]
            g_s2 = grads if g_s2 is None else [a + b for a, b in zip(g_s2, grads)]
            ct = vs.handoff(g_hidden, lm)
            with lm, torch.enable_grad():
                hidden = lm_forward(bert_p(), lm_batch(i), gen(0, i, lm_dev))
                g = torch.autograd.grad(hidden, [params[k] for k in lm_train],
                                        grad_outputs=ct.to(hidden.dtype),
                                        allow_unused=True)
            g = [torch.zeros_like(params[k]) if t is None else t
                 for k, t in zip(lm_train, g)]
            g_lm = g if g_lm is None else [a + b for a, b in zip(g_lm, g)]
        lm.join()
        vs.join()
        wsum = torch.clamp(weight_t.sum(), min=1.0)
        grads = {k: v / wsum.to(v.device) for k, v in zip(lm_train, g_lm)}
        grads.update({k: v / wsum.to(v.device) for k, v in zip(s2_train, g_s2)})
        return loss_sum / wsum.to(loss_sum.device), grads

    return fn


def place_pipeline_params(params, lm_device=None, vilt_device=None
                          ) -> Dict[str, torch.Tensor]:
    """Stage placement: the LM tower (``bert.*``) on the LM device, ViLT and
    the heads on the ViLT device (the reference's from_pretrained placement,
    model.py:259-284).  Returns new leaf tensors (gradients enabled for the
    float ones)."""
    if isinstance(params, torch.nn.Module):
        params = params.state_dict()
    lm, vd = default_devices(lm_device, vilt_device)
    return {k: v.detach().to(lm if k.startswith("bert.") else vd, copy=True)
            .requires_grad_(v.is_floating_point()) for k, v in params.items()}
