"""The port's tokenizers (``text/bpe.py``, ``text/fastbpe.py``,
``text/roberta_format.py``), ``build_tokenizer`` and the processor's HF and
augmentation branches, against the JAX package's.

Vocab and merges files are written here, as ``tests/test_bpe.py`` and
``tests/test_fastbpe.py`` write theirs; token ids must be equal.  The
processor's ``augment_rng`` must take the same crops (equal pixel masks and
rng state afterwards) with pixels within one uint8 level (2/255 after
normalization; the port resizes with PyTorch's antialiased bicubic, the JAX
package reproduces PIL).
"""

import json
import sys

import numpy as np
import pytest

from vault_tpu.data import image as jimage
from vault_tpu.data.processor import VaultProcessor as JProcessor
from vault_tpu.models import pretrained as jpre
from vault_tpu.text.bpe import ByteLevelBPE as JByteLevelBPE
from vault_tpu.text.bpe import bytes_to_unicode
from vault_tpu.text.fastbpe import FastBPE as JFastBPE
from vault_tpu_torch.data import image as timage
from vault_tpu_torch.data.processor import VaultProcessor
from vault_tpu_torch.models import pretrained as tpre
from vault_tpu_torch.text.bpe import ByteLevelBPE
from vault_tpu_torch.text.fastbpe import FastBPE, normalize_tweet

PIXEL_ATOL = 2.0 / 255 + 1e-6

BPE_TEXTS = ["the cat and the dog", "the dinner", "cats dogma the", "unicode: café ❤",
             " leading and  double  spaces", "the_cat and__the dog_", ""]
FASTBPE_TEXTS = ["the cat", "dog running", "a the cat dog", "unknownword the", "cats",
                 "the cat\ndog  running", ""]
TWEETS = ["@john check https://t.co/xyz it's great",
          "I can't believe it… meet at 5 p. m. ok",
          "cannot wait, you're going to love this"]


def _write_bpe(d):
    byte_vocab = list(bytes_to_unicode().values())
    merges = [("Ġ", "t"), ("h", "e"), ("Ġt", "he"), ("i", "n"), ("e", "r"),
              ("a", "n"), ("Ġ", "a"), ("o", "g"), ("Ġ", "d"), ("Ġd", "og"),
              ("c", "a"), ("ca", "t"), ("Ġ", "cat")]
    tokens = ["<s>", "<pad>", "</s>", "<unk>", "<mask>"] + byte_vocab + \
        ["".join(m) for m in merges]
    vocab = {t: i for i, t in enumerate(dict.fromkeys(tokens))}
    (d / "vocab.json").write_text(json.dumps(vocab))
    (d / "merges.txt").write_text("#version: 0.2\n" + "\n".join(f"{a} {b}" for a, b in merges)
                                  + "\n")
    return str(d / "vocab.json"), str(d / "merges.txt")


def _write_fastbpe(d):
    tokens = ["the</w>", "cat</w>", "do", "g</w>", "run", "ning</w>", "a</w>", "c",
              "at</w>", "t", "h", "e</w>", "o", "d", "n", "i", "g", "r", "u", "a", "s</w>", "e"]
    (d / "vocab.txt").write_text("\n".join(f"{t} {100 - i}" for i, t in enumerate(tokens))
                                 + "\n")
    merges = ["t h", "th e</w>", "c at</w>", "d o", "g </w>", "r u", "ru n", "n ing</w>",
              "n i", "ni n", "nin g</w>", "a </w>"]
    (d / "bpe.codes").write_text("#version: 0.2\n" + "\n".join(f"{m} 1" for m in merges)
                                 + "\n")
    return str(d / "vocab.txt"), str(d / "bpe.codes")


@pytest.fixture(scope="module")
def bpe_files(tmp_path_factory):
    return _write_bpe(tmp_path_factory.mktemp("bpe"))


@pytest.fixture(scope="module")
def fastbpe_files(tmp_path_factory):
    return _write_fastbpe(tmp_path_factory.mktemp("fastbpe"))


def _same_encodings(ours, theirs, texts, pairs=None, max_length=12):
    for i, t in enumerate(texts):
        p = None if pairs is None else pairs[i]
        assert ours.tokenize(t) == theirs.tokenize(t), t
        assert ours.encode(t, p, max_length=max_length) == \
            theirs.encode(t, p, max_length=max_length), (t, p)
    got = ours.batch_encode(texts, pairs, max_length=max_length)
    want = theirs.batch_encode(texts, pairs, max_length=max_length)
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])


@pytest.mark.parametrize("max_length", [5, 12, None])
def test_byte_level_bpe_matches_jax(bpe_files, max_length):
    pairs = [None, "the dog", "a cat", None, "x", "the_cat", "dog"]
    _same_encodings(ByteLevelBPE(*bpe_files), JByteLevelBPE(*bpe_files), BPE_TEXTS,
                    pairs, max_length)
    ours = ByteLevelBPE(*bpe_files)
    assert ours.vocab == JByteLevelBPE(*bpe_files).vocab and len(ours) == len(ours.vocab)


@pytest.mark.parametrize("max_length", [5, 12, None])
def test_fastbpe_matches_jax(fastbpe_files, max_length):
    pairs = ["dog", None, "the the the the the", None, "cat cat", "a", None]
    ours, theirs = FastBPE(*fastbpe_files), JFastBPE(*fastbpe_files)
    assert ours.vocab == theirs.vocab and ours.bpe_ranks == theirs.bpe_ranks
    _same_encodings(ours, theirs, FASTBPE_TEXTS, pairs, max_length)
    assert ours.pad_token_id == 1 and ours.vocab["<mask>"] == len(ours) - 1


@pytest.mark.parametrize("text", TWEETS)
def test_tweet_normalization_matches_jax(fastbpe_files, text):
    pytest.importorskip("nltk")
    from vault_tpu.text.fastbpe import normalize_tweet as j_normalize

    assert normalize_tweet(text) == j_normalize(text)
    ours = FastBPE(*fastbpe_files, normalization=True)
    theirs = JFastBPE(*fastbpe_files, normalization=True)
    assert ours.tokenize(text) == theirs.tokenize(text)


def test_normalization_needs_nltk_only_when_asked(fastbpe_files, monkeypatch):
    """nltk is imported inside ``normalize_tweet``: without it the default
    (``normalization=False``) tokenizes and normalization raises."""
    for name in [m for m in sys.modules if m == "nltk" or m.startswith("nltk.")]:
        monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, "nltk", None)
    assert FastBPE(*fastbpe_files).tokenize("the dog") == \
        JFastBPE(*fastbpe_files).tokenize("the dog") == ["the", "do@@", "g"]
    with pytest.raises(ImportError):
        normalize_tweet(TWEETS[0])


def _texts():
    return ["The Cat sits", "a DOG running", "the the cat"]


@pytest.mark.parametrize("layout", ["fastbpe", "bpe", "wordpiece-config", "wordpiece-tokcfg",
                                    "bert-base-cased", "bert-base-uncased", "not-a-dir"])
def test_build_tokenizer_branches_match_jax(tmp_path, layout):
    d = tmp_path / layout
    d.mkdir()
    if layout == "fastbpe":
        _write_fastbpe(d)
    elif layout == "bpe":
        _write_bpe(d)
    elif layout != "not-a-dir":
        words = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]", "the", "cat", "dog", "a",
                 "The", "Cat", "DOG", "sits", "running", "##s"]
        (d / "vocab.txt").write_text("\n".join(words) + "\n")
        if layout == "wordpiece-config":
            (d / "config.json").write_text(json.dumps({"do_lower_case": False}))
        elif layout == "wordpiece-tokcfg":
            (d / "tokenizer_config.json").write_text(json.dumps({"do_lower_case": False}))
            (d / "config.json").write_text(json.dumps({"do_lower_case": True}))
    path = str(d) if layout != "not-a-dir" else "bert-base-uncased"
    ours, theirs = tpre.build_tokenizer(path), jpre.build_tokenizer(path)
    assert type(ours).__name__ == type(theirs).__name__
    assert ours.vocab == theirs.vocab
    got = ours.batch_encode(_texts(), max_length=10)
    want = theirs.batch_encode(_texts(), max_length=10)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    if layout.startswith("wordpiece") or layout.startswith("bert-base"):
        lower = layout in ("bert-base-uncased",)
        assert ours.basic.lowercase == theirs.basic.lowercase == lower


def _hf_fast_tokenizer_dir(d):
    """A directory AutoTokenizer reads and no native branch does:
    ``tokenizer.json`` (a word-level fast tokenizer) and its config."""
    tokenizers = pytest.importorskip("tokenizers")
    transformers = pytest.importorskip("transformers")
    vocab = {w: i for i, w in enumerate(["[PAD]", "[UNK]", "[CLS]", "[SEP]", "the", "cat",
                                         "dog", "sits", "running", "a"])}
    tok = tokenizers.Tokenizer(tokenizers.models.WordLevel(vocab, unk_token="[UNK]"))
    tok.pre_tokenizer = tokenizers.pre_tokenizers.Whitespace()
    tok.post_processor = tokenizers.processors.TemplateProcessing(
        single="[CLS] $A [SEP]", pair="[CLS] $A [SEP] $B:1 [SEP]:1",
        special_tokens=[("[CLS]", 2), ("[SEP]", 3)])
    fast = transformers.PreTrainedTokenizerFast(tokenizer_object=tok, pad_token="[PAD]",
                                                unk_token="[UNK]")
    fast.save_pretrained(str(d))
    return str(d)


def test_build_tokenizer_auto_and_processor_hf_branch(tmp_path):
    path = _hf_fast_tokenizer_dir(tmp_path / "fast")
    ours, theirs = tpre.build_tokenizer(path), jpre.build_tokenizer(path)
    assert not hasattr(ours, "batch_encode") and ours.model_max_length == 40
    texts = ["the cat sits", "a dog running the cat", "cat"]
    for pairs in (None, ["a dog", "the", "cat dog"], ["a dog", None, "cat"]):
        got = VaultProcessor(ours).encode_text(texts, pairs, max_length=9)
        want = JProcessor(theirs).encode_text(texts, pairs, max_length=9)
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == want[k].dtype == np.int32
            np.testing.assert_array_equal(got[k], want[k])


def test_build_tokenizer_refuses_an_unreadable_directory(tmp_path, monkeypatch):
    """An existing directory without tokenizer files raises the JAX
    package's RuntimeError, with transformers failing or missing."""
    (tmp_path / "config.json").write_text("{}")
    for build in (tpre.build_tokenizer, jpre.build_tokenizer):
        with pytest.raises(RuntimeError, match="is a checkpoint directory but no tokenizer"):
            build(str(tmp_path))
    monkeypatch.setitem(sys.modules, "transformers", None)
    with pytest.raises(RuntimeError, match="AutoTokenizer failed"):
        tpre.build_tokenizer(str(tmp_path))


def _images(seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (90, 160, 3), dtype=np.uint8),
            rng.integers(0, 256, (200, 70, 3), dtype=np.uint8),
            rng.integers(0, 256, (40, 700, 3), dtype=np.uint8),   # safe-crop first
            rng.integers(0, 256, (64, 64), dtype=np.uint8),
            rng.integers(0, 256, (33, 47, 4), dtype=np.uint8)]


def test_relative_random_crop_and_crop_stage_match_jax():
    for seed in range(3):
        ours, theirs = np.random.default_rng(seed), np.random.default_rng(seed)
        for im in _images(seed):
            for ratio in (0.9, 0.5):
                np.testing.assert_array_equal(timage.relative_random_crop(ours, im, ratio),
                                              jimage.relative_random_crop(theirs, im, ratio))
            for safe in (True, False):
                np.testing.assert_array_equal(
                    timage.crop_stage(im, safe, ours), jimage.crop_stage(im, safe, theirs))
            np.testing.assert_array_equal(timage.crop_stage(im), jimage.crop_stage(im))
        assert ours.bit_generator.state == theirs.bit_generator.state


@pytest.mark.parametrize("canvas", [(384, 608), "auto", None])
@pytest.mark.parametrize("num_workers", [0, 3])
def test_processor_augment_rng_matches_jax(canvas, num_workers):
    words = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]", "a", "cat"]
    from vault_tpu.text.wordpiece import WordPieceTokenizer as JWordPiece
    from vault_tpu_torch.text.wordpiece import WordPieceTokenizer

    vocab = {w: i for i, w in enumerate(words)}
    ours = VaultProcessor(WordPieceTokenizer(vocab), max_length=6, canvas=canvas,
                          num_workers=num_workers)
    theirs = JProcessor(JWordPiece(vocab), max_length=6, canvas=canvas)
    images, texts = _images(4), ["a cat"] * 5
    r_ours, r_theirs = np.random.default_rng(11), np.random.default_rng(11)
    got = ours(images, texts, augment_rng=r_ours)
    want = theirs(images, texts, augment_rng=r_theirs)
    assert r_ours.bit_generator.state == r_theirs.bit_generator.state
    np.testing.assert_array_equal(got["pixel_mask"], want["pixel_mask"])
    np.testing.assert_array_equal(got["input_ids"], want["input_ids"])
    assert got["pixel_values"].shape == want["pixel_values"].shape
    np.testing.assert_allclose(got["pixel_values"], want["pixel_values"], atol=PIXEL_ATOL)
