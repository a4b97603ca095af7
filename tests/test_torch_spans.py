"""The program's spans (utils/profiling.py ``span``) on the CPU at a tiny
size: the ``vault.*`` ranges a classifier forward and a training step
record under ``torch.profiler``, their nesting, and that with no profiler
running nothing of the profiler is entered and the logits do not move."""

import contextlib

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from vault_tpu_torch.config import VaultConfig, tiny_text_config, tiny_vilt_config
from vault_tpu_torch.models import vault as tvault
from vault_tpu_torch.training.trainer import Trainer, TrainArgs, classifier_apply_fn
from vault_tpu_torch.utils import profiling

TEXT_LAYERS, VILT_LAYERS = 2, 3
MODEL_SPANS = ("vault.text_tower", "vault.text_embed", "vault.vilt_embed",
               "vault.vilt_encoder", "vault.head")


def _cfg():
    return VaultConfig(vilt=tiny_vilt_config(num_hidden_layers=VILT_LAYERS, image_size=32,
                                             num_patch_tokens=8),
                       text_tower=tiny_text_config(num_hidden_layers=TEXT_LAYERS))


def _batch(n=2, seed=0):
    gen = torch.Generator().manual_seed(seed)
    ids = torch.randint(5, 99, (n, 8), generator=gen)
    return {"input_ids": ids, "attention_mask": torch.ones(n, 8, dtype=torch.int64),
            "token_type_ids": torch.zeros(n, 8, dtype=torch.int64),
            "pixel_values": torch.randn(n, 3, 32, 32, generator=gen),
            "pixel_mask": torch.ones(n, 32, 32, dtype=torch.int64)}


def _spans(prof, prefixes=("vault.", "train_step:")):
    """(name, start µs, end µs) of each recorded span, in time order."""
    out = [(e.name, e.time_range.start, e.time_range.end) for e in prof.events()
           if e.name.startswith(prefixes)]
    return sorted(out, key=lambda s: (s[1], -s[2]))


def _inside(inner, outer):
    return outer[1] <= inner[1] and inner[2] <= outer[2]


def _one(spans, name):
    found = [s for s in spans if s[0] == name]
    assert len(found) == 1, (name, found)
    return found[0]


def test_span_is_a_shared_null_context_without_a_profiler():
    assert not torch.autograd.profiler._is_profiler_enabled
    assert profiling.span("vault.layer") is profiling.span("vault.head")
    assert isinstance(profiling.span("vault.layer"), contextlib.nullcontext)
    with profile(activities=[ProfilerActivity.CPU]):
        assert isinstance(profiling.span("vault.layer"), torch.profiler.record_function)
    assert isinstance(profiling.span("vault.layer"), contextlib.nullcontext)


def test_a_forward_records_each_model_span_nested():
    model = tvault.VaultForClassification(_cfg(), device="cpu")
    with torch.inference_mode(), profile(activities=[ProfilerActivity.CPU]) as prof:
        model(_batch())
    spans = _spans(prof)
    tower, embed, vembed, encoder, head = (_one(spans, n) for n in MODEL_SPANS)
    layers = [s for s in spans if s[0] == "vault.layer"]
    assert len(layers) == TEXT_LAYERS + VILT_LAYERS
    assert _inside(embed, tower)
    assert [_inside(s, tower) for s in layers] == [True] * TEXT_LAYERS + [False] * VILT_LAYERS
    assert all(_inside(s, encoder) for s in layers[TEXT_LAYERS:])
    assert tower[2] <= vembed[1] and vembed[2] <= encoder[1] and encoder[2] <= head[1]
    assert embed[2] <= layers[0][1]


def _trainer(cfg):
    args = TrainArgs(train_batch_size=2, remat=True, compute_dtype="bfloat16",
                     grad_dtype="bfloat16", num_train_epochs=1)
    model = tvault.VaultForClassification(cfg, device="cpu")
    trainer = Trainer(classifier_apply_fn(cfg, args, head_dropout=0.1), model, args,
                      train_dataset=None, device="cpu")
    trainer._build_optimizer(4)
    return trainer


def test_a_step_records_forward_backward_optimizer_in_order():
    trainer = _trainer(_cfg())
    labels, weight = torch.tensor([0, 2]), torch.ones(2)
    trainer.train_step(_batch(), labels, weight, 0)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        trainer.train_step(_batch(seed=1), labels, weight, 7)
    spans = _spans(prof)
    step = _one(spans, "train_step:7")
    fwd, cast, bwd, opt = (_one(spans, f"vault.step.{n}")
                           for n in ("forward", "cast_params", "backward", "optimizer"))
    assert all(_inside(s, step) for s in (fwd, bwd, opt))
    assert _inside(cast, fwd) and fwd[2] <= bwd[1] and bwd[2] <= opt[1]
    # the forward's model spans lie inside the step's forward
    for name in MODEL_SPANS:
        assert _inside(_one(spans, name), fwd), name
    layers = [s for s in spans if s[0] == "vault.layer"]
    assert len(layers) == TEXT_LAYERS + VILT_LAYERS
    assert all(_inside(s, fwd) for s in layers)


def test_without_a_profiler_no_record_function_is_built(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("record_function entered with no profiler running")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    cfg = _cfg()
    with torch.inference_mode():
        logits = tvault.VaultForClassification(cfg, device="cpu")(_batch())
    assert torch.isfinite(logits).all()
    trainer = _trainer(cfg)
    out = trainer.train_step(_batch(), torch.tensor([1, 0]), torch.ones(2), 0)
    assert torch.isfinite(out).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_the_profiler_leaves_the_logits_bit_equal(dtype):
    model = tvault.VaultForClassification(_cfg(), device="cpu", dtype=dtype)
    batch = _batch(n=3, seed=5)
    with torch.inference_mode():
        off = model(batch)
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            on = model(batch)
    assert any(e.name == "vault.layer" for e in prof.events())
    assert on.dtype == off.dtype and torch.equal(on, off)
