"""The port's bench loop (``vault_tpu_torch/utils/benchloop.py``), its FLOP
count (``utils/flops.py``) and the NaN checks of every top-level forward,
against the JAX package.

``feedback_batch`` is held bit for bit against the JAX package's on the
same numpy batch; the chained forward of a tiny VAuLT (the JAX package's
parameters bridged with ``params_from_jax``, fp32, the plain path) against
``jax.jit(make_chained_forward(...))`` within 1e-5.  The guard
(``product_placement``) must pass the full-feedback chain and report, on
the rounds-1-3 pattern (the text tower's output computed once before the
loop and reused, as ``tests/test_bench_loop.py`` builds its buggy loop),
the BERT tower's products as outside the loop.  ``enable_nan_checks(True)``
must make a NaN raise in a direct forward, a ``VaultPipeline`` call and a
served batch, as ``jax_debug_nans`` does for the JAX package's jitted
forward.
"""

import contextlib

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from vault_tpu.config import VaultConfig as JVaultConfig
from vault_tpu.config import tiny_text_config as j_tiny_text
from vault_tpu.config import tiny_vilt_config as j_tiny_vilt
from vault_tpu.models import vault as jvault
from vault_tpu.utils import benchloop as jbench
from vault_tpu.utils import profiling as jprofiling
from vault_tpu_torch.config import VaultConfig, tiny_text_config, tiny_vilt_config
from vault_tpu_torch.convert import params_from_jax
from vault_tpu_torch.models import vault as tvault
from vault_tpu_torch.utils import benchloop, flops, profiling

BITS = {"float32": np.uint32, "bfloat16": np.uint16}


def _bits(x):
    """The raw bits of a torch or JAX float array, as unsigned integers."""
    if isinstance(x, torch.Tensor):
        return x.view({torch.float32: torch.int32, torch.bfloat16: torch.int16}[x.dtype]
                      ).numpy().view(BITS[str(x.dtype).split(".")[-1]])
    x = np.asarray(x)
    return x.view(BITS[x.dtype.name])


def _np_batch(seed=0, b=3, seq=7, hw=(8, 8)):
    rng = np.random.default_rng(seed)
    return {"input_ids": rng.integers(0, 100, (b, seq)).astype(np.int32),
            "attention_mask": (rng.random((b, seq)) > 0.3).astype(np.int32),
            "pixel_values": rng.normal(size=(b, 3, *hw)).astype(np.float32),
            "pixel_mask": np.ones((b, *hw), np.int32)}


def _sides(batch, dtype):
    jb = {k: jnp.asarray(v) if v.dtype.kind != "f" else jnp.asarray(v, getattr(jnp, dtype))
          for k, v in batch.items()}
    tb = {k: torch.from_numpy(v.astype(np.int64)) if v.dtype.kind != "f"
          else torch.from_numpy(v).to(getattr(torch, dtype)) for k, v in batch.items()}
    return jb, tb


@pytest.mark.parametrize("fb", [0.25, 3.0517578125e-9, -1.4901161193847656e-07, 1.5])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_feedback_batch_bit_equal_to_jax(dtype, fb):
    """Floats shift by the feedback exactly as in the JAX package (bit for
    bit, in their own dtype); integers keep their values."""
    batch = _np_batch()
    jb, tb = _sides(batch, dtype)
    ref = jbench.feedback_batch(jb, jnp.asarray(fb, jnp.bfloat16))
    out = benchloop.feedback_batch(tb, torch.tensor(fb, dtype=torch.bfloat16))
    for key in batch:
        if batch[key].dtype.kind == "f":
            assert out[key].dtype == getattr(torch, dtype)
            np.testing.assert_array_equal(_bits(out[key]), _bits(ref[key]))
            if abs(fb) >= 0.25:  # a shift the dtype can hold: the term is live
                assert (_bits(out[key]) != _bits(tb[key])).any()
        else:
            assert out[key].dtype == torch.int64
            np.testing.assert_array_equal(out[key].numpy(), batch[key])
            np.testing.assert_array_equal(np.asarray(ref[key]), batch[key])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_nan_feedback_shifts_the_integers_by_one(dtype):
    """The integers' term is isnan(feedback): zero for a finite output, one
    for a NaN, on both sides, so it is computed, not folded away."""
    batch = _np_batch(seed=1)
    jb, tb = _sides(batch, dtype)
    ref = jbench.feedback_batch(jb, jnp.asarray(np.nan, jnp.bfloat16))
    out = benchloop.feedback_batch(tb, torch.tensor(float("nan"), dtype=torch.bfloat16))
    for key in ("input_ids", "attention_mask", "pixel_mask"):
        np.testing.assert_array_equal(out[key].numpy(), batch[key] + 1)
        np.testing.assert_array_equal(np.asarray(ref[key]), batch[key] + 1)
    assert torch.isnan(out["pixel_values"]).all()


@pytest.mark.parametrize("value", [0.7578125, -3.25, 123.0, 1e-3])
def test_next_feedback_bit_equal_to_jax(value):
    """(out[0, 0] * 1e-9) in bf16: the scale rounded to the output's dtype
    first, as the JAX package's weakly typed 1e-9 is."""
    out = np.full((2, 3), value, np.float32)
    ref = (jnp.asarray(out, jnp.bfloat16)[0, 0] * 1e-9).astype(jnp.bfloat16)
    got = benchloop.next_feedback(torch.from_numpy(out).to(torch.bfloat16))
    assert got.dtype == torch.bfloat16 and got.shape == ()
    np.testing.assert_array_equal(_bits(got.reshape(1)), _bits(np.asarray(ref).reshape(1)))


# ---------------------------------------------------------------------------
# The chained forward on a tiny VAuLT
# ---------------------------------------------------------------------------

def _tiny(dtype="float32"):
    jcfg = JVaultConfig(vilt=j_tiny_vilt(), text_tower=j_tiny_text())
    tcfg = VaultConfig(vilt=tiny_vilt_config(), text_tower=tiny_text_config())
    p = jvault.init_vault(jax.random.PRNGKey(0), jcfg)
    p["head"] = jvault.init_classifier_head(jax.random.PRNGKey(1), jcfg.vilt.hidden_size, 3)
    leaves, tree = jax.tree.flatten(p)
    rng = np.random.default_rng(7)
    leaves = [l + jnp.asarray(0.02 * rng.normal(size=l.shape), l.dtype) for l in leaves]
    jp = jax.tree.map(lambda x: x.astype(getattr(jnp, dtype)), jax.tree.unflatten(tree, leaves))
    model = tvault.VaultForClassification(tcfg, device="cpu", dtype=getattr(torch, dtype))
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, jp), tcfg))
    return jcfg, tcfg, jp, model


def _vault_batch(seed=0, b=3, seq=8, hw=(64, 64)):
    rng = np.random.default_rng(seed)
    am = np.ones((b, seq), np.int32)
    am[1, 5:] = 0
    return {"input_ids": rng.integers(1, 99, (b, seq)).astype(np.int32),
            "attention_mask": am,
            "token_type_ids": (rng.random((b, seq)) > 0.5).astype(np.int32),
            "pixel_values": rng.normal(size=(b, 3, *hw)).astype(np.float32),
            "pixel_mask": np.ones((b, *hw), np.int32)}


@pytest.mark.parametrize("k", [0, 1, 3])
def test_chained_forward_matches_jax(k):
    """k pooled forwards, each reading the last one's output through
    feedback_batch, against the JAX package's jitted chain (fp32 compute,
    the pooled output carried in bf16 on both sides, as the JAX loop
    carries it)."""
    jcfg, tcfg, jp, model = _tiny()
    jb, tb = _sides(_vault_batch(), "float32")
    shape = (3, jcfg.vilt.hidden_size)
    jchain = jax.jit(jbench.make_chained_forward(
        lambda p, b: jvault.vault_apply(p, jcfg, use_pallas=False, **b
                                        ).pooler_output.astype(jnp.bfloat16), shape))
    ref = jchain(jp, jb, jnp.int32(k))
    chain = benchloop.make_chained_forward(
        lambda m, b: tvault.vault_apply(m, tcfg, use_pallas=False, **b
                                        ).pooler_output.to(torch.bfloat16), shape)
    with torch.inference_mode():
        out = chain(model, tb, k)
    assert out.shape == shape and out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(), np.asarray(ref, np.float32),
                               rtol=0, atol=1e-5)
    if k:
        assert out.abs().sum() > 0


def _bert_cached_chain(tcfg, shape):
    """The rounds-1-3 pattern, written for the port: the text tower's
    output is computed once, before the loop, and every iteration reuses
    it; only the pixels carry the loop."""

    def chained(model, batch, k):
        hidden = tvault.lm_encode(model, tcfg, batch["input_ids"], batch["attention_mask"],
                                  batch["token_type_ids"], use_pallas=False)
        fb = torch.zeros((), dtype=torch.bfloat16)
        out = torch.zeros(shape, dtype=torch.bfloat16)
        for _ in range(k):
            b = dict(batch, pixel_values=batch["pixel_values"] + fb.float())
            out = tvault.vilt_mod.vilt_apply(
                model["vilt"], tcfg.resolved_vilt(), None, b["attention_mask"],
                b["token_type_ids"], b["pixel_values"], b["pixel_mask"], hidden,
                use_pallas=False).pooler_output.to(torch.bfloat16)
            fb = benchloop.next_feedback(out)
        return out

    return chained


def _one(tcfg):
    return lambda m, b: tvault.vault_apply(m, tcfg, use_pallas=False, **b
                                           ).pooler_output.to(torch.bfloat16)


@pytest.mark.parametrize("span", [(1, 2), (1, 3), (2, 5)])
def test_product_placement_sound_on_the_full_feedback_chain(span):
    _, tcfg, _, model = _tiny()
    _, tb = _sides(_vault_batch(seed=1), "float32")
    one = _one(tcfg)
    chain = benchloop.make_chained_forward(one, (3, 32))
    with torch.inference_mode():
        p = benchloop.product_placement(chain, one, model, tb, *span)
    # per layer: Q, K, V, output, two MLP products, q·kᵀ and p·v; the
    # patch projection and the pooler
    assert p.per_call == 8 * 4 + 2
    assert p.inside == (span[1] - span[0]) * p.per_call and p.outside == 0
    assert p.sound and p.launches_outside is None  # no launch counters on the CPU


@pytest.mark.parametrize("span", [(1, 2), (1, 3)])
def test_product_placement_reports_the_hoisted_text_tower(span):
    """The rounds-1-3 pattern: the BERT tower's products run once, before
    the loop, so every one of them is missing from each iteration: outside
    is the tower's count per extra iteration, and the guard fails."""
    _, tcfg, _, model = _tiny()
    _, tb = _sides(_vault_batch(seed=2), "float32")
    with torch.inference_mode():
        bert = sum(benchloop.count_products(lambda: tvault.lm_encode(
            model, tcfg, tb["input_ids"], tb["attention_mask"], tb["token_type_ids"],
            use_pallas=False)).values())
        p = benchloop.product_placement(_bert_cached_chain(tcfg, (3, 32)), _one(tcfg),
                                        model, tb, *span)
    assert bert == 8 * tcfg.text_tower.num_hidden_layers
    assert p.outside == (span[1] - span[0]) * bert
    assert p.inside == (span[1] - span[0]) * (p.per_call - bert)
    assert not p.sound


N, STEPS = 64, 6


def _toy():
    """An expensive text branch (a lookup, then a chain of products) and a
    cheap image branch, as tests/test_bench_loop.py's toy model."""
    w = torch.from_numpy(np.random.default_rng(1).normal(size=(N, N)).astype(np.float32) * 0.02)

    def apply_fn(params, batch):
        h = params["w"][batch["input_ids"] % N]
        for _ in range(STEPS):
            h = torch.tanh(h @ params["w"])
        return (h + batch["pixel_values"].mean()).to(torch.bfloat16)

    rng = np.random.default_rng(2)
    batch = {"input_ids": torch.from_numpy(rng.integers(0, N, (4,))),
             "pixel_values": torch.from_numpy(rng.normal(size=(4, 4)).astype(np.float32))}
    return {"w": w}, batch, apply_fn


def test_product_placement_on_a_toy_two_branch_model():
    params, batch, apply_fn = _toy()
    fixed = benchloop.make_chained_forward(apply_fn, (4, N))
    p = benchloop.product_placement(fixed, apply_fn, params, batch, 1, 4)
    assert (p.per_call, p.inside, p.outside, p.sound) == (STEPS, 3 * STEPS, 0, True)

    def buggy(params, batch, k):
        # the text branch computed once; only the pixels carry the loop
        h = params["w"][batch["input_ids"] % N]
        for _ in range(STEPS):
            h = torch.tanh(h @ params["w"])
        fb = torch.zeros((), dtype=torch.bfloat16)
        out = torch.zeros((4, N), dtype=torch.bfloat16)
        for _ in range(k):
            out = (h + (batch["pixel_values"] + fb.float()).mean()).to(torch.bfloat16)
            fb = benchloop.next_feedback(out)
        return out

    p = benchloop.product_placement(buggy, apply_fn, params, batch, 1, 4)
    assert (p.inside, p.outside, p.sound) == (0, 3 * STEPS, False)


def test_launch_counters_name_every_counted_wrapper():
    """The guard's launch table is the one chip_smoke.py reads: every kernel
    wrapper with a launch counter, by the kernel's name."""
    import chip_smoke

    counters = benchloop.launch_counters()
    assert set(counters) == set(chip_smoke.KERNEL_NAMES)
    assert all(isinstance(w.launches, int) for w in counters.values())
    assert benchloop.count_launches(lambda: None) == {k: 0 for k in counters}


def test_slope_ms_takes_the_per_iteration_time(monkeypatch):
    """(t(k_hi) - t(k_lo)) / (k_hi - k_lo) of a run whose k iterations each
    take 8 ms after 20 ms once per call, on a simulated host clock (the
    module's ``time``), so that no other work on the host moves the result;
    the once-per-call part cancels."""
    import types

    clock = [0.0]
    monkeypatch.setattr(benchloop, "time",
                        types.SimpleNamespace(perf_counter=lambda: clock[0]))
    calls = []

    def run(k):
        calls.append(k)
        clock[0] += 0.02 + 0.008 * k

    s = benchloop.slope_ms(run, 1, 4, repeats=2)
    assert calls == [1, 1, 1, 4, 4]
    assert 7.5 <= s["ms"] <= 14.0, s
    assert s["ms"] == pytest.approx(8.0)
    assert s["t_hi_ms"] > s["t_lo_ms"] >= 28.0
    assert (s["t_lo_ms"], s["t_hi_ms"]) == (pytest.approx(28.0), pytest.approx(52.0))
    with pytest.raises(ValueError, match="must exceed"):
        benchloop.slope_ms(run, 3, 3)


# ---------------------------------------------------------------------------
# The FLOP count
# ---------------------------------------------------------------------------

def test_flops_give_861_gf_at_the_bench_geometry():
    """docs/BENCHMARKS.md "MFU accounting": BERT 12 × 9.14 GF, ViLT at L =
    256 12 × 61.2 GF, the projection over 228 patches 17.2 GF; no model
    is built or run."""
    from vault_tpu_torch.presets import vault_base

    cfg = vault_base("bert-base-uncased")
    fwd = flops.vault_forward_flops(cfg, 16, 40, (384, 608))
    assert abs(fwd / 861e9 - 1.0) <= 0.005, fwd
    assert flops.vilt_length(cfg, 40, (384, 608)) == 256
    bert = flops.encoder_layer_flops(16, 40, 768, 3072)
    vilt = flops.encoder_layer_flops(16, 256, 768, 3072)
    assert abs(bert / 9.14e9 - 1) < 0.005 and abs(vilt / 61.2e9 - 1) < 0.005
    assert flops.train_step_flops(cfg, 16, 40, (384, 608), remat=True) == 4 * fwd
    assert flops.train_step_flops(cfg, 16, 40, (384, 608), remat=False) == 3 * fwd
    assert flops.train_step_flops(cfg, 16, 40, (384, 608), remat="dots") == 3 * fwd
    # ToMe 87 at layer 0: every ViLT layer at 40 + 1 + 87; at layer 4 the
    # first four at 256
    merged = flops.vault_forward_flops(cfg, 16, 40, (384, 608), merge_to=87)
    assert merged == fwd - 12 * (vilt - flops.encoder_layer_flops(16, 128, 768, 3072))
    at4 = flops.vault_forward_flops(cfg, 16, 40, (384, 608), merge_to=87, merge_at_layer=4)
    assert at4 == merged + 4 * (vilt - flops.encoder_layer_flops(16, 128, 768, 3072))


@pytest.mark.parametrize("hw", [(64, 64), (64, 96)])
def test_flops_equal_the_products_a_forward_dispatches(hw):
    """The count from the configuration equals 2·M·N·K summed over the
    products the plain forward of a tiny VAuLT dispatches, less the pooler
    and the head (which the count leaves out)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    _, tcfg, _, model = _tiny()
    batch = _vault_batch(seed=3, hw=hw)
    batch["attention_mask"][:] = 1
    _, tb = _sides(batch, "float32")

    class Flops(TorchDispatchMode):
        total = 0.0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            name = func.overloadpacket.__name__
            # under inference mode matmul reaches the mode undecomposed
            if name in ("mm", "addmm", "bmm", "matmul", "linear"):
                a = args[1] if name == "addmm" else args[0]
                self.total += 2.0 * out.numel() * a.shape[-1]
            return out

    with torch.inference_mode(), Flops() as mode:
        model(tb, use_pallas=False)
    b, h = 3, tcfg.vilt.hidden_size
    pooler_and_head = 2.0 * b * h * h + 2.0 * b * h * 3
    assert mode.total - pooler_and_head == flops.vault_forward_flops(tcfg, b, 8, hw)


# ---------------------------------------------------------------------------
# NaN checks reach every top-level forward (Queue C 9)
# ---------------------------------------------------------------------------

def _nan_batch(batch):
    bad = {k: v.copy() for k, v in batch.items()}
    bad["pixel_values"][0, 0, 5, 5] = np.nan  # row 0: the row a lone request serves
    return bad


class _Processor:
    """Stands in for a VaultProcessor: returns one fixed encoded batch."""

    def __init__(self, enc):
        self.enc = enc

    def __call__(self, images, texts):
        n = len(texts)
        return {k: v[:n] for k, v in self.enc.items()}


def _run(entry, model, tcfg, enc):
    if entry == "forward":
        with torch.no_grad():
            return model(enc)
    if entry == "pipeline":
        from vault_tpu_torch.pipeline_api import VaultPipeline

        pipe = VaultPipeline(model, tcfg, _Processor(enc), max_batch=3)
        return pipe([np.zeros((8, 8, 3), np.uint8)] * 3, ["a"] * 3)
    from vault_tpu_torch.serving import BatchingEngine

    engine = BatchingEngine(_Processor(enc), model, max_batch=3, max_wait_ms=1.0)
    try:
        return engine.predict(np.zeros((8, 8, 3), np.uint8), "a", timeout=60.0)
    finally:
        engine.close()


@pytest.mark.parametrize("entry", ["forward", "pipeline", "served"])
def test_nan_checks_reach_every_forward(entry):
    """After enable_nan_checks(True) a NaN pixel raises at the first
    operator that makes a NaN, in a direct forward, a VaultPipeline call
    and a batch the engine serves on its own thread; with the checks off
    the same calls run and return NaNs."""
    _, tcfg, _, model = _tiny()
    good = _vault_batch(seed=4)
    bad = _nan_batch(good)
    try:
        profiling.enable_nan_checks(True)
        assert np.isfinite(np.asarray(_run(entry, model, tcfg, good)[0]
                                      if entry == "pipeline" else
                                      _run(entry, model, tcfg, good))).all()
        with pytest.raises(RuntimeError, match="NaN produced by"):
            _run(entry, model, tcfg, bad)
    finally:
        profiling.enable_nan_checks(False)
    out = _run(entry, model, tcfg, bad)
    out = out[1] if entry == "pipeline" else out
    assert np.isnan(np.asarray(out)).any()


def test_nan_checks_reach_the_llama_tower_model():
    from vault_tpu_torch.models.llama import tiny_llama_config

    vcfg = tiny_vilt_config()
    model = tvault.VaultWithLlamaTower(vcfg, tiny_llama_config(), device="cpu")
    batch = _vault_batch(seed=5)
    batch["input_ids"] %= tiny_llama_config().vocab_size
    try:
        profiling.enable_nan_checks(True)
        with torch.no_grad():
            assert torch.isfinite(model(batch).pooler_output).all()
            with pytest.raises(RuntimeError, match="NaN produced by"):
                model(_nan_batch(batch))
    finally:
        profiling.enable_nan_checks(False)
    with torch.no_grad():
        assert torch.isnan(model(_nan_batch(batch)).pooler_output).any()


def test_jax_debug_nans_raises_on_the_same_input():
    """The reference: the JAX package's jitted classifier under its
    enable_nan_checks(True) raises FloatingPointError on the NaN pixel."""
    jcfg, _, jp, _ = _tiny()
    bad = _nan_batch(_vault_batch(seed=4))
    jb = {k: jnp.asarray(v) for k, v in bad.items()}
    fwd = jax.jit(lambda p, b: jvault.vault_for_classification(p, jcfg, b, use_pallas=False))
    try:
        jprofiling.enable_nan_checks(True)
        with pytest.raises(FloatingPointError):
            fwd(jp, jb).block_until_ready()
    finally:
        jprofiling.enable_nan_checks(False)
    assert np.isnan(np.asarray(fwd(jp, jb))).any()


def test_nan_checks_do_not_nest():
    """A forward inside an active NanCheckMode (a served model's forward on
    the engine's thread) enters no second mode: each operator is checked
    once."""
    from torch.utils._python_dispatch import _get_current_dispatch_mode_stack

    try:
        profiling.enable_nan_checks(True)
        with profiling.nan_checks():
            inner = profiling.nan_checks()
            with inner:
                modes = [m for m in _get_current_dispatch_mode_stack()
                         if isinstance(m, profiling.NanCheckMode)]
        assert len(modes) == 1
    finally:
        profiling.enable_nan_checks(False)
    assert isinstance(inner, contextlib.nullcontext)
    assert isinstance(profiling.nan_checks(), contextlib.nullcontext)  # off


def test_host_syncs_name_where_each_comes_from(monkeypatch):
    """Each synchronizing operation is counted by the PyTorch function that
    warned and the first caller outside PyTorch (the card's sync debug mode
    warns; here a stand-in warning)."""
    import warnings

    modes = []

    def set_mode(mode):  # switching the mode synchronizes: not counted
        modes.append(mode)
        warnings.warn("called a synchronizing CUDA operation")

    monkeypatch.setattr(torch.cuda, "get_sync_debug_mode", lambda: 0)
    monkeypatch.setattr(torch.cuda, "set_sync_debug_mode", set_mode)

    def forward():
        for _ in range(2):
            warnings.warn("called a synchronizing CUDA operation")
        warnings.warn("something else")

    sites = benchloop.host_syncs(forward)
    assert modes == ["warn", 0] and sum(sites.values()) == 2 and len(sites) == 1
    (site,) = sites
    assert site.startswith("forward (") and site.endswith(" forward")
    assert "test_torch_benchloop.py" in site
