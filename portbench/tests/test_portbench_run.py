"""Whole runs of each cell at a tiny size on the CPU, past the harness's
look for a card: a sound run comes out correct, and a run whose timed path
is broken underneath comes out not correct, once for each fault the cell
can have (the exchange between chips does not exist on one chip).  The
reference at a tiny size runs, and twice gives the same numbers."""

import json

import pytest
import torch

from portbench import run
from portbench.check import reference_weights
from portbench.generate import make_batch
from portbench.reference.train_ref import optimizer_settings, train_steps
from portbench.reference.vault_ref import classifier_logits

CPU = torch.device("cpu")
SEED = 2**33 + 12345
SCORE_CELLS = ["bertweet-bf16.score_b256", "bert-w8a8.score_b256"]
TRAIN_CELL = "bertweet-bf16.train_b256"


def result(spec, cell):
    out = run.run_cell(spec, cell, SEED, 0.3, False, CPU)
    json.dumps(out)
    return out


@pytest.mark.parametrize("cell", SCORE_CELLS + [TRAIN_CELL])
def test_a_sound_run_is_correct(tiny_spec, cell):
    out = result(tiny_spec, cell)
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    assert list(out)[-1] == "checks"
    assert {m["name"] for m in tiny_spec.end_to_end(cell)} == set(out["metrics"])


def _alter_logit(monkeypatch):
    from vault_tpu_torch.models import vault

    head = vault.classifier_head_apply

    def altered(*args, **kwargs):
        logits = head(*args, **kwargs).clone()
        logits[0, 0] += 0.5
        return logits

    monkeypatch.setattr(vault, "classifier_head_apply", altered)


def _half_batch(monkeypatch):
    from vault_tpu_torch.models import vault

    forward = vault.vault_for_classification

    def half(params, cfg, batch, **kwargs):
        n = batch["input_ids"].shape[0] // 2
        logits = forward(params, cfg, {k: v[:n] for k, v in batch.items()}, **kwargs)
        return torch.cat([logits, logits])

    monkeypatch.setattr(vault, "vault_for_classification", half)


def _stale(monkeypatch):
    from vault_tpu_torch.models import vault

    forward, last = vault.vault_for_classification, []

    def stale(*args, **kwargs):
        logits = forward(*args, **kwargs)
        out = last[0] if last else logits
        last[:] = [logits]
        return out

    monkeypatch.setattr(vault, "vault_for_classification", stale)


@pytest.mark.parametrize("cell", SCORE_CELLS)
@pytest.mark.parametrize("fault", [_alter_logit, _half_batch, _stale],
                         ids=["answer altered", "half the batch", "stale answer"])
def test_a_broken_scoring_path_is_not_correct(tiny_spec, monkeypatch, cell, fault):
    fault(monkeypatch)
    assert not result(tiny_spec, cell)["correct"]


def _unchanged_state(monkeypatch):
    from vault_tpu_torch.training.optimizer import AdamWState, HfAdamW

    def step_(self, params, grads, state):
        return AdamWState(state.count + 1, state.mu, state.nu)

    monkeypatch.setattr(HfAdamW, "step_", step_)


def _half_batch_mean(monkeypatch):
    from vault_tpu_torch.training.trainer import Trainer

    train_step = Trainer.train_step

    def half(self, batch, labels, weight, step):
        weight = weight.clone()
        weight[weight.shape[0] // 2:] = 0.0
        return train_step(self, batch, labels, weight, step)

    monkeypatch.setattr(Trainer, "train_step", half)


def _altered_loss(monkeypatch):
    from vault_tpu_torch.training import losses

    loss = losses.softmax_cross_entropy
    monkeypatch.setattr(losses, "softmax_cross_entropy",
                        lambda *a, **k: loss(*a, **k) * 1.05)


@pytest.mark.parametrize("fault", [_unchanged_state, _half_batch_mean, _altered_loss],
                         ids=["state unchanged", "half the batch", "loss altered"])
def test_a_broken_training_step_is_not_correct(tiny_spec, monkeypatch, fault):
    fault(monkeypatch)
    assert not result(tiny_spec, TRAIN_CELL)["correct"]


@pytest.mark.parametrize("prec", [None, "int8", "fp8"])
def test_reference_runs_and_repeats(tiny_spec, prec):
    cell = tiny_spec.cell("bertweet-bf16.score_b256")
    cfg, traffic = tiny_spec.config(cell["config"]), tiny_spec.traffic(cell["traffic"])
    p = reference_weights(cfg, SEED, torch.bfloat16, CPU)
    inputs, _ = make_batch(traffic, cfg, SEED, 3, CPU)
    a = classifier_logits(p, cfg, inputs, prec=prec)
    b = classifier_logits(p, cfg, inputs, prec=prec)
    assert a.shape == (traffic["batch"], cfg["head"]["n_classes"])
    assert torch.isfinite(a).all() and torch.equal(a, b)


def test_reference_training_repeats(tiny_spec):
    cell = tiny_spec.cell(TRAIN_CELL)
    cfg, traffic = tiny_spec.config(cell["config"]), tiny_spec.traffic(cell["traffic"])
    p = reference_weights(cfg, SEED, torch.float32, CPU)
    made = [make_batch(traffic, cfg, SEED, i, CPU) for i in range(2)]
    args = (p, cfg, [b for b, _ in made], [y for _, y in made], SEED,
            optimizer_settings(traffic))
    a, b = train_steps(*args), train_steps(*args)
    assert a["losses"] == b["losses"] and a["delta_norms"] == b["delta_norms"]
    assert all(torch.equal(a["grads"][k], b["grads"][k]) for k in a["grads"])
    fp8 = train_steps(*args, prec="fp8", ste=True)
    assert fp8["losses"] != a["losses"]
