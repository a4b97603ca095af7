"""The port's checkpoint loading (``models/pretrained.py``,
``models/convert.py``) against the JAX package's.

HF-layout directories are written by ``transformers``' ``save_pretrained``
of tiny seeded ``BertModel`` / ``RobertaModel`` / ``ViltModel``s, in
safetensors (fp32, fp16, bf16) and in ``pytorch_model.bin``.  Both packages
load them; the parameters must be equal bit for bit (the port's state dict
against ``convert.params_from_jax`` of the JAX tree).  The JAX package reads
safetensors through ``safetensors.numpy``, which has no bf16, so a bf16
directory is held against the JAX converters applied to the same values
upcast to fp32 (what its ``_np`` does with any float).  The port's own
safetensors reader is held against the ``safetensors`` package, its writer
round-trips through both.  Forward: the loaded model against ``vault_apply``
at ``tests/test_torch_models.py``'s fp32 tolerance.
"""

import dataclasses
import json
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.hf_utils import DeterministicMultinomial, hf_bert_config, hf_vilt_config
from vault_tpu.config import VaultConfig as JVaultConfig
from vault_tpu.config import tiny_text_config as j_tiny_text
from vault_tpu.config import tiny_vilt_config as j_tiny_vilt
from vault_tpu.models import convert as jconvert
from vault_tpu.models import llama as jllama
from vault_tpu.models import pretrained as jpre
from vault_tpu.models import vault as jvault
from vault_tpu_torch.config import VaultConfig, tiny_text_config, tiny_vilt_config
from vault_tpu_torch.convert import params_from_jax
from vault_tpu_torch.models import convert as tconvert
from vault_tpu_torch.models import llama as tllama
from vault_tpu_torch.models import pretrained as tpre
from vault_tpu_torch.models import vault as tvault
from vault_tpu_torch.models import vilt as tvilt

ROBERTA = dict(type_vocab_size=1, pad_token_id=1, position_embedding_style="roberta",
               max_position_embeddings=66)
FP32_ATOL = 5e-5  # tests/test_torch_models.py's fp32 tolerance
FORMATS = ["safetensors-float32", "safetensors-float16", "safetensors-bfloat16", "bin"]


def _cfgs(tower):
    kw = ROBERTA if tower == "roberta" else {}
    jcfg = JVaultConfig(vilt=j_tiny_vilt(), text_tower=j_tiny_text(**kw))
    tcfg = VaultConfig(vilt=tiny_vilt_config(), text_tower=tiny_text_config(**kw))
    return jcfg, tcfg


def _perturbed(model, seed):
    """HF inits LayerNorms to (1, 0) and biases to 0: move every leaf."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in model.parameters():
            p.add_(0.02 * torch.randn(p.shape, generator=g))
    return model.eval()


def _hf_text(cfg, tower, seed=0):
    from transformers import BertModel, RobertaConfig, RobertaModel

    if tower == "roberta":
        hf_cfg = RobertaConfig(**{k: v for k, v in hf_bert_config(cfg).to_dict().items()
                                  if k not in ("architectures", "model_type")})
        return _perturbed(RobertaModel(hf_cfg, add_pooling_layer=False), seed)
    return _perturbed(BertModel(hf_bert_config(cfg), add_pooling_layer=False), seed)


def _hf_vilt(cfg, seed=1, pooler=True):
    from transformers import ViltModel

    return _perturbed(ViltModel(hf_vilt_config(cfg), add_pooling_layer=pooler), seed)


def _save(model, path, fmt):
    if fmt.startswith("safetensors"):
        model.to(getattr(torch, fmt.split("-")[1])).save_pretrained(path)
    else:
        model.save_pretrained(path, safe_serialization=False)
    return str(path)


def _jax_backbone(jcfg, vilt_dir, bert_dir, fmt):
    """The JAX package's backbone, as the port's state dict."""
    if fmt != "safetensors-bfloat16":
        tree = jpre.load_vault_backbone(jcfg, jax.random.PRNGKey(0), vilt_dir, bert_dir)
    else:  # its numpy reader has no bf16: the converters on the upcast values
        def sd(d):
            return {k: v.float().numpy() for k, v in tpre.load_torch_state_dict(d).items()}
        tree = {"vilt": jconvert.vilt_params_from_torch(sd(vilt_dir), jcfg.resolved_vilt()),
                "bert": jconvert.bert_params_from_torch(sd(bert_dir), jcfg.text_tower)}
    return params_from_jax(jax.tree.map(np.asarray, tree))


def _assert_equal(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == torch.float32 and got[k].is_contiguous(), k
        assert torch.equal(got[k], want[k]), k


@pytest.mark.parametrize("tower", ["bert", "roberta"])
@pytest.mark.parametrize("fmt", FORMATS)
def test_load_vault_backbone_matches_jax(tmp_path, fmt, tower):
    jcfg, tcfg = _cfgs(tower)
    bert_dir = _save(_hf_text(tcfg.text_tower, tower), tmp_path / "text", fmt)
    vilt_dir = _save(_hf_vilt(tcfg.vilt), tmp_path / "vilt", fmt)
    got = tpre.load_vault_backbone(tcfg, torch.Generator().manual_seed(0), vilt_dir,
                                   bert_dir)
    _assert_equal(got, _jax_backbone(jcfg, vilt_dir, bert_dir, fmt))
    if fmt == "safetensors-bfloat16":  # the bf16 values, upcast exactly
        src = tpre.load_torch_state_dict(bert_dir)
        w = src["encoder.layer.0.attention.self.query.weight"]
        assert w.dtype == torch.bfloat16
        assert torch.equal(got["bert.layers.0.q.w"], w.float().t())


def test_loaded_model_matches_jax_forward(tmp_path):
    """The loaded backbone in a VaultForClassification against the JAX
    package's ``vault_for_classification`` on the same loaded tree."""
    jcfg, tcfg = _cfgs("bert")
    bert_dir = _save(_hf_text(tcfg.text_tower, "bert"), tmp_path / "text",
                     "safetensors-float32")
    vilt_dir = _save(_hf_vilt(tcfg.vilt), tmp_path / "vilt", "safetensors-float32")
    jp = jpre.load_vault_backbone(jcfg, jax.random.PRNGKey(0), vilt_dir, bert_dir)
    jp["head"] = jvault.init_classifier_head(jax.random.PRNGKey(1), jcfg.vilt.hidden_size, 3)
    model = tvault.VaultForClassification(tcfg, device="cpu")
    backbone = tpre.load_vault_backbone(tcfg, torch.Generator(), vilt_dir, bert_dir)
    head = params_from_jax({"head": jax.tree.map(np.asarray, jp["head"])})
    model.load_state_dict({**backbone, **head})
    rng = np.random.default_rng(0)
    batch = {"input_ids": rng.integers(1, 99, (2, 8)).astype(np.int32),
             "attention_mask": np.ones((2, 8), np.int32),
             "token_type_ids": np.zeros((2, 8), np.int32),
             "pixel_values": rng.normal(size=(2, 3, 64, 64)).astype(np.float32),
             "pixel_mask": np.ones((2, 64, 64), np.int32)}
    ref = jvault.vault_for_classification(jp, jcfg, {k: jnp.asarray(v) for k, v in batch.items()},
                                          head_dropout=0.0, deterministic=True)
    with torch.inference_mode():
        out = model({k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=FP32_ATOL)


def test_vilt_without_pooler(tmp_path):
    """A ViLT state dict without a pooler converts without one in both
    packages, and ``vilt_apply`` then returns no pooled output."""
    jcfg, tcfg = _cfgs("bert")
    sd = _hf_vilt(tcfg.vilt, pooler=False).state_dict()
    assert not any(k.startswith("pooler") for k in sd)
    jtree = jconvert.vilt_params_from_torch(sd, jcfg.vilt)
    got = tconvert.vilt_params_from_torch(sd, tcfg.vilt)
    assert "pooler" not in jtree and not any(k.startswith("pooler") for k in got)
    _assert_equal(got, params_from_jax(jax.tree.map(np.asarray, jtree)))
    vilt = tvilt.init_vilt(torch.Generator(), tcfg.vilt, add_pooling_layer=False)
    vilt.load_state_dict(got)
    rng = np.random.default_rng(1)
    out = tvilt.vilt_apply(vilt, tcfg.vilt,
                           input_ids=torch.from_numpy(rng.integers(1, 99, (1, 5))),
                           attention_mask=torch.ones((1, 5), dtype=torch.int64),
                           pixel_values=torch.randn(1, 3, 64, 64),
                           pixel_mask=torch.ones((1, 64, 64), dtype=torch.int64))
    assert out.pooler_output is None


@pytest.mark.parametrize("prefix", ["", "vilt.", "bert."])
def test_hf_round_trip_and_known_prefixes(prefix):
    """The reverse converters give HF's own keys (they load strictly into the
    HF models) and invert the forward ones; ``_strip_known_prefixes`` takes
    the first matching prefix only, as the JAX package's."""
    _, tcfg = _cfgs("bert")
    hf_vilt, hf_bert = _hf_vilt(tcfg.vilt), _hf_text(tcfg.text_tower, "bert")
    vilt = tconvert.vilt_params_from_torch(hf_vilt.state_dict(), tcfg.vilt)
    bert = tconvert.bert_params_from_torch(hf_bert.state_dict(), tcfg.text_tower)
    back_v = tconvert.vilt_params_to_torch(vilt, tcfg.vilt)
    back_b = tconvert.bert_params_to_torch(bert, tcfg.text_tower)
    hf_vilt.load_state_dict(back_v, strict=True)
    hf_bert.load_state_dict(back_b, strict=True)
    _assert_equal(tconvert.vilt_params_from_torch(back_v, tcfg.vilt), vilt)
    sd = {prefix + k: v for k, v in back_b.items()}
    sd["other.head.weight"] = torch.zeros(1)
    got, p = tpre._strip_known_prefixes(sd)
    want, jp = jpre._strip_known_prefixes(sd)
    assert p == jp and sorted(got) == sorted(want)
    if prefix:
        assert p == prefix and "other.head.weight" not in got
    _assert_equal(tconvert.bert_params_from_torch(got, tcfg.text_tower), bert)


def test_load_bert_tower_matches_jax(tmp_path):
    jcfg, tcfg = _cfgs("roberta")
    d = _save(_hf_text(tcfg.text_tower, "roberta"), tmp_path / "text", "bin")
    got = tpre.load_bert_tower(d, tcfg.text_tower)
    want = params_from_jax({"t": jax.tree.map(np.asarray, jpre.load_bert_tower(
        d, jcfg.text_tower))})
    _assert_equal(got, {k[2:]: v for k, v in want.items()})


def test_llama_params_from_torch_matches_jax():
    from transformers import LlamaConfig as HFLlamaConfig
    from transformers import LlamaForCausalLM

    jcfg, tcfg = jllama.tiny_llama_config(), tllama.tiny_llama_config()
    hf = _perturbed(LlamaForCausalLM(HFLlamaConfig(
        vocab_size=tcfg.vocab_size, hidden_size=tcfg.hidden_size,
        num_hidden_layers=tcfg.num_hidden_layers,
        num_attention_heads=tcfg.num_attention_heads,
        num_key_value_heads=tcfg.num_key_value_heads,
        intermediate_size=tcfg.intermediate_size)), 3)
    sd = hf.state_dict()
    assert any(k.startswith("model.") for k in sd)
    got = tconvert.llama_params_from_torch(sd, tcfg)
    want = params_from_jax({"llama": jax.tree.map(np.asarray, jllama.llama_params_from_torch(
        sd, jcfg))}, llama_cfg=tcfg)
    _assert_equal({f"llama.{k}": v for k, v in got.items()}, want)
    tower = tllama.init_llama(torch.Generator(), tcfg)
    tower.load_state_dict(got, strict=True)  # the tower's own keys


def test_configs_match_jax(tmp_path):
    _, tcfg = _cfgs("roberta")
    for name, hf in (("text", _hf_text(tcfg.text_tower, "roberta")),
                     ("bert", _hf_text(tiny_text_config(), "bert")),
                     ("vilt", _hf_vilt(tcfg.vilt))):
        d = _save(hf, tmp_path / name, "safetensors-float32")
        fn = "vilt_config_from_name" if name == "vilt" else "text_config_from_name"
        assert dataclasses.asdict(getattr(tpre, fn)(d)) == \
            dataclasses.asdict(getattr(jpre, fn)(d)), name
    for name in ("vinai/bertweet-base", "bert-base-uncased", str(tmp_path / "missing")):
        assert dataclasses.asdict(tpre.text_config_from_name(name)) == \
            dataclasses.asdict(jpre.text_config_from_name(name))
    assert dataclasses.asdict(tpre.vilt_config_from_name("x", image_size=64)) == \
        dataclasses.asdict(jpre.vilt_config_from_name("x", image_size=64))
    assert tpre.text_config_from_name(str(tmp_path / "text")).position_embedding_style == \
        "roberta"


def test_missing_paths_init_random_loudly(tmp_path, caplog):
    """A path that is not a directory: the seeded random init (ViLT, then
    the LM tower, as ``init_vault``) and the JAX package's warning text."""
    _, tcfg = _cfgs("bert")
    jcfg = _cfgs("bert")[0]
    vilt, bert = str(tmp_path / "no_vilt"), "bert-base-uncased"
    with caplog.at_level(logging.WARNING):
        got = tpre.load_vault_backbone(tcfg, torch.Generator().manual_seed(5), vilt, bert)
        jpre.load_vault_backbone(jcfg, jax.random.PRNGKey(0), vilt, bert)
    msgs = [r.getMessage() for r in caplog.records if "RANDOM weights" in r.getMessage()]
    assert len(msgs) == 4 and msgs[:2] == msgs[2:], msgs
    assert msgs[0].startswith("vilt tower: ") and msgs[1].startswith("LM tower: ")
    _assert_equal(got, tvault.init_vault(torch.Generator().manual_seed(5), tcfg).state_dict())
    caplog.clear()
    with caplog.at_level(logging.WARNING):
        tpre.load_vault_backbone(tcfg, torch.Generator())
    assert not caplog.records  # no path named: random without a warning


def test_missing_weights_raise(tmp_path):
    with pytest.raises(FileNotFoundError, match="no weights"):
        tpre.load_torch_state_dict(str(tmp_path))


_ST_TENSORS = {
    "f32": torch.randn(3, 5), "bf16": torch.randn(4, 2).bfloat16(),
    "f16": torch.randn(7).half(), "f64": torch.randn(2, 2, dtype=torch.float64),
    "i64": torch.arange(6).reshape(2, 3), "i32": torch.arange(5, dtype=torch.int32),
    "i16": torch.arange(3, dtype=torch.int16), "i8": torch.tensor([-128, 0, 127],
                                                                  dtype=torch.int8),
    "u8": torch.arange(9, dtype=torch.uint8).reshape(3, 3),
    "bool": torch.tensor([True, False, True]), "scalar": torch.tensor(2.5),
    "empty": torch.zeros(0, 4)}


def test_safetensors_reader_matches_the_package(tmp_path):
    from safetensors.numpy import load_file as np_load
    from safetensors.torch import load_file, save_file

    path = str(tmp_path / "model.safetensors")
    save_file(_ST_TENSORS, path, metadata={"format": "pt"})
    got = tpre.load_safetensors(path)
    want = load_file(path)
    assert sorted(got) == sorted(want)
    for k, t in want.items():
        assert got[k].dtype == t.dtype and got[k].shape == t.shape, k
        assert torch.equal(got[k], t), k
    # safetensors.numpy has no bf16: the other types through it too
    save_file({k: v for k, v in _ST_TENSORS.items() if k != "bf16"}, path)
    got = tpre.load_safetensors(path)
    for k, a in np_load(path).items():
        assert got[k].numpy().dtype == a.dtype, k
        np.testing.assert_array_equal(got[k].numpy(), a)


def test_safetensors_writer_round_trips(tmp_path):
    from safetensors import safe_open
    from safetensors.torch import load_file

    path = str(tmp_path / "w.safetensors")
    src = dict(_ST_TENSORS, view=torch.randn(4, 6).t())  # a non-contiguous view
    tpre.save_safetensors(src, path, metadata={"format": "pt", "note": "x"})
    for loaded in (load_file(path), tpre.load_safetensors(path)):
        assert sorted(loaded) == sorted(src)
        for k, t in src.items():
            assert loaded[k].dtype == t.dtype and torch.equal(loaded[k], t), k
    with safe_open(path, framework="pt") as f:
        assert f.metadata() == {"format": "pt", "note": "x"}
    with open(path, "rb") as f:
        n = int.from_bytes(f.read(8), "little")
        assert (8 + n) % 8 == 0 and "__metadata__" in json.loads(f.read(n))


def test_safetensors_reader_rejects_a_short_file(tmp_path):
    path = str(tmp_path / "short.safetensors")
    tpre.save_safetensors({"a": torch.randn(64)}, path)
    with open(path, "r+b") as f:
        f.truncate(f.seek(0, 2) - 8)
    with pytest.raises(ValueError, match="past the end"):
        tpre.load_safetensors(path)


def test_hf_vilt_forward_through_the_loader(tmp_path):
    """End to end through the port only: HF's ViltModel against the port's
    vilt_apply on the directory the loader reads (HF's patch sampling made
    deterministic, as tests/test_vilt_parity.py does)."""
    _, tcfg = _cfgs("bert")
    hf = _hf_vilt(tcfg.vilt)
    d = _save(hf, tmp_path / "vilt", "safetensors-float32")
    cfg = tpre.vilt_config_from_name(d, num_patch_tokens=tcfg.vilt.num_patch_tokens)
    vilt = tvilt.init_vilt(torch.Generator(), cfg)
    vilt.load_state_dict(tconvert.vilt_params_from_torch(tpre.load_torch_state_dict(d), cfg))
    rng = np.random.default_rng(2)
    ids = torch.from_numpy(rng.integers(1, 99, (2, 6)))
    am = torch.ones((2, 6), dtype=torch.int64)
    px = torch.from_numpy(rng.normal(size=(2, 3, 64, 64)).astype(np.float32))
    pm = torch.ones((2, 64, 64), dtype=torch.int64)
    with torch.inference_mode(), DeterministicMultinomial():
        ref = hf(input_ids=ids, attention_mask=am, pixel_values=px, pixel_mask=pm)
        out = tvilt.vilt_apply(vilt, cfg, input_ids=ids, attention_mask=am,
                               pixel_values=px, pixel_mask=pm)
    np.testing.assert_allclose(out.pooler_output.numpy(), ref.pooler_output.numpy(),
                               atol=FP32_ATOL)
