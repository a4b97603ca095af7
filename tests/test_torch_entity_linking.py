"""The port's entity linking (``text/entity_linking.py``) against the JAX
package's ``vault_tpu/text/entity_linking.py``: the cache file name and
I/O (a file each package writes reads in the other), the offline linker
(alias lookup, threshold, disambiguation chains), ``build_entity_cache``,
``resolve_entities_for_cli`` (its errors, the tokens it registers), and the
two embedding integrations, whose max-pooled rows must equal the JAX
package's exactly (a max selects one of the table's own values).
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vault_tpu.config import VaultConfig as JVaultConfig
from vault_tpu.config import tiny_text_config as j_tiny_text
from vault_tpu.config import tiny_vilt_config as j_tiny_vilt
from vault_tpu.text import entity_linking as jel
from vault_tpu.text.wordpiece import WordPieceTokenizer as JWordPiece
from vault_tpu_torch.config import VaultConfig, tiny_text_config, tiny_vilt_config
from vault_tpu_torch.text import entity_linking as tel
from vault_tpu_torch.text.wordpiece import WordPieceTokenizer

VOCAB = ("[PAD] [UNK] [CLS] [SEP] [MASK] the a cat dog red blue city of river "
         "paris france capital band rock").split()
STORE = {
    "aliases": {"paris": [["Paris", 9.0], ["Paris_Hilton", 3.0]],
                "the band": [["The_Band", 0.5]],
                "mercury": [["Mercury", 5.0]]},
    "descriptions": {"Paris": "paris the capital of france",
                     "The_Band": "a rock band",
                     "Mercury_(planet)": "a red planet"},
    "disambiguations": {"Mercury": ["Mercury_(planet)", "Freddie_Mercury"]},
}


def _toks():
    v = {t: i for i, t in enumerate(VOCAB)}
    return JWordPiece(dict(v)), WordPieceTokenizer(dict(v))


@pytest.fixture
def store(tmp_path):
    path = tmp_path / "store.json"
    path.write_text(json.dumps(STORE))
    return str(path)


def test_cache_io_is_shared_with_jax(tmp_path):
    name = tel.entities_cache_filename(str(tmp_path), "/data/twitter2015/", ["train", "dev"],
                                       "wiki_2019", 0.5)
    assert name == jel.entities_cache_filename(str(tmp_path), "/data/twitter2015/",
                                               ["train", "dev"], "wiki_2019", 0.5)
    cache = {"paris": ("Paris", "the capital"), "x": (None, None)}
    tel.save_entity_cache(str(tmp_path / "a" / "c.json"), cache)
    assert jel.load_entity_cache(str(tmp_path / "a" / "c.json")) == cache
    jel.save_entity_cache(str(tmp_path / "j.json"), cache)
    assert tel.load_entity_cache(str(tmp_path / "j.json")) == cache
    (tmp_path / "bad.json").write_text("[1, 2")
    assert tel.load_entity_cache(str(tmp_path / "bad.json")) is None
    assert tel.load_entity_cache(str(tmp_path / "none.json")) is None


@pytest.mark.parametrize("threshold", [0.0, 4.0])
def test_offline_linker_and_build_match_jax(tmp_path, store, threshold):
    """The best alias wins; below the threshold the entity stays and its
    description is withheld; a disambiguation page follows its first
    option; an unknown target links to nothing.  The built caches are
    equal and only unseen targets are linked again."""
    targets = ["Paris", "the  band", "Mercury", "nowhere", "Paris"]
    ours = tel.OfflineEntityLinker(store, threshold).link(targets)
    ref = jel.OfflineEntityLinker(store, threshold).link(targets)
    assert ours == ref
    assert ours["Mercury"] == ("Mercury", "a red planet")
    assert ours["the  band"] == ("The_Band", None if threshold else "a rock band")
    a = tel.build_entity_cache(str(tmp_path / "t.json"), targets,
                               tel.OfflineEntityLinker(store, threshold))
    b = jel.build_entity_cache(str(tmp_path / "j.json"), targets,
                               jel.OfflineEntityLinker(store, threshold))
    assert a == b and json.loads((tmp_path / "t.json").read_text()) == json.loads(
        (tmp_path / "j.json").read_text())

    class Counting:
        seen = []

        def link(self, ts):
            self.seen.extend(ts)
            return {t: (None, None) for t in ts}

    linker = Counting()
    tel.build_entity_cache(str(tmp_path / "t.json"), targets + ["new one"], linker)
    assert linker.seen == ["new one"]
    rel = tel.EntityLinker(str(tmp_path))
    assert rel.available == jel.EntityLinker(str(tmp_path)).available
    if not rel.available:
        with pytest.raises(RuntimeError, match="REL is not installed"):
            rel.link(["Paris"])


def test_resolve_entities_for_cli_matches_jax(tmp_path, store):
    """The cache built from the store on first use, then read; an entity
    token per described entity, registered once; the errors of the JAX
    package (a store without a cache file, a missing cache and no
    linker)."""
    jt, tt = _toks()
    targets = lambda: ["Paris", "the band", "Mercury", "Paris"]
    ours = tel.resolve_entities_for_cli(str(tmp_path / "t.json"), store, 0.0, tt, targets)
    ref = jel.resolve_entities_for_cli(str(tmp_path / "j.json"), store, 0.0, jt, targets)
    assert ours == ref
    assert ours[0] == {"Paris": "[Paris]", "the band": "[The_Band]",
                       "Mercury": "[Mercury]"}
    assert len(tt) == len(jt) == len(VOCAB) + 3
    again = tel.resolve_entities_for_cli(str(tmp_path / "t.json"), None, 0.0,
                                         _toks()[1], lambda: pytest.fail("read"))
    assert again == ours
    assert tel.resolve_entities_for_cli(None, None, 0.0, tt, targets) == ({}, [])
    with pytest.raises(ValueError, match="--wiki_store was given without --entity_cache"):
        tel.resolve_entities_for_cli(None, store, 0.0, tt, targets)
    with pytest.raises(ValueError, match="--wiki_store was given without --entity_cache"):
        jel.resolve_entities_for_cli(None, store, 0.0, jt, targets)
    if not tel.EntityLinker(".").available:
        with pytest.raises(RuntimeError, match="no linker"):
            tel.resolve_entities_for_cli(str(tmp_path / "missing.json"), None, 0.0, tt,
                                         targets)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_integrate_entities_into_embeddings_equals_jax(dtype):
    """Each new row the per-dimension max over its description's token
    rows and the [CLS] and [SEP] rows; a description of unknown words
    pools over [UNK], [CLS] and [SEP]."""
    jt, tt = _toks()
    table = np.random.default_rng(0).normal(size=(len(VOCAB), 8)).astype(np.float32)
    descs = ["paris the capital of france", "a rock band", "zzz qqq"]
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    ref = np.asarray(jnp.asarray(jel.integrate_entities_into_embeddings(
        jnp.asarray(table, jdt), descs, jt), jnp.float32))
    src = torch.from_numpy(table).to(tdt)
    ours = tel.integrate_entities_into_embeddings(src, descs, tt)
    assert ours.dtype == tdt and tuple(ours.shape) == (len(VOCAB) + 3, 8)
    np.testing.assert_array_equal(ours.float().numpy(), ref)
    assert torch.equal(ours[:len(VOCAB)], src)
    assert tel.integrate_entities_into_embeddings(src, [], tt) is src


@pytest.mark.parametrize("tower", [True, False])
def test_integrate_entities_into_vault_equals_jax(tower):
    """The active tower's table (BERT's with a text tower, ViLT's without)
    grows, the config's vocab_size with it; a prefix reaches a TomViLT
    tree's ``vault.`` keys; the given dict is not changed."""
    jt, tt = _toks()
    rng = np.random.default_rng(1)
    bert = rng.normal(size=(30, 8)).astype(np.float32)
    vilt = rng.normal(size=(40, 8)).astype(np.float32)
    jcfg = JVaultConfig(vilt=j_tiny_vilt(vocab_size=40),
                        text_tower=j_tiny_text(vocab_size=30) if tower else None)
    tcfg = VaultConfig(vilt=tiny_vilt_config(vocab_size=40),
                       text_tower=tiny_text_config(vocab_size=30) if tower else None)
    jparams = {"vilt": {"text_embeddings": {"word": jnp.asarray(vilt)}},
               "bert": {"embeddings": {"word": jnp.asarray(bert)}}}
    sd = {"vault.vilt.text_embeddings.word": torch.from_numpy(vilt),
          "vault.bert.embeddings.word": torch.from_numpy(bert)}
    descs = ["red city", "blue river of the city"]
    jout, jcfg2 = jel.integrate_entities_into_vault(jparams, jcfg, descs, jt)
    out, tcfg2 = tel.integrate_entities_into_vault(sd, tcfg, descs, tt, prefix="vault.")
    key = "vault.bert.embeddings.word" if tower else "vault.vilt.text_embeddings.word"
    want = (jout["bert"]["embeddings"]["word"] if tower
            else jout["vilt"]["text_embeddings"]["word"])
    np.testing.assert_array_equal(out[key].numpy(), np.asarray(want))
    assert tuple(sd[key].shape)[0] == (30 if tower else 40)
    if tower:
        assert tcfg2.text_tower.vocab_size == jcfg2.text_tower.vocab_size == 32
    else:
        assert tcfg2.vilt.vocab_size == jcfg2.vilt.vocab_size == 42
    assert tel.integrate_entities_into_vault(sd, tcfg, [], tt) == (sd, tcfg)
