"""The port's native host cores (``csrc/host/``, built with the host C++
compiler at first use by ``ops/_build_host.py``) against the JAX package's
wrappers of its own copies (``native/``) and against the PIL and Python
paths, bit for bit: the geometries of tests/test_native_image.py and the
corpus of tests/test_native_tokenizer.py.  Then the routing
(``data/image.py`` ``resize_normalize``, ``text/wordpiece.py``), and a
build by several processes at once."""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

from vault_tpu.data import native_image as jnative_image
from vault_tpu.text import native as jnative_text
from vault_tpu.text.wordpiece import WordPieceTokenizer as JWordPiece
from vault_tpu_torch.data import native_image
from vault_tpu_torch.data.image import IMAGE_MEAN, IMAGE_STD, resize_normalize
from vault_tpu_torch.ops import _build, _build_host
from vault_tpu_torch.text import native as native_text
from vault_tpu_torch.text.wordpiece import WordPieceTokenizer

ROOT = Path(__file__).resolve().parent.parent

GEOMETRIES = [
    (480, 640, 384, 512),   # downscale, landscape
    (640, 480, 512, 384),   # downscale, portrait
    (100, 100, 384, 384),   # upscale
    (1000, 700, 384, 268),  # strong downscale
    (384, 608, 384, 608),   # identity
    (384, 608, 384, 416),   # width-only
    (500, 416, 384, 416),   # height-only
    (50, 373, 32, 352),     # thin strip
    (7, 9, 384, 608),       # tiny source
]

VOCAB = {t: i for i, t in enumerate(dict.fromkeys(
    "[PAD] [UNK] [CLS] [SEP] [MASK] the quick brown fox jump ##s ##ed over "
    "lazy dog un ##want ! . , ' run ##ning".split()))}
CORPUS = ["The quick brown fox jumps over the lazy dog!", "unwanted running",
          "UNWANTED ruNNing...", "completely-unknownword", "",
          "the\tquick\r\nfox , 'jumped' over;the dog?!", "x" * 120 + " fox"]


@pytest.fixture(scope="module")
def jax_libs():
    """The JAX package's libraries, built as its own tests build them."""
    assert jnative_image.build_native_lib() and jnative_text.build_native_lib()


def _pil_normalized(src, oh, ow):
    ref = np.asarray(Image.fromarray(src).resize((ow, oh), Image.BICUBIC))
    return ((ref.astype(np.float32) / 255.0 - IMAGE_MEAN) / IMAGE_STD).transpose(2, 0, 1)


@pytest.mark.parametrize("h,w,oh,ow", GEOMETRIES)
def test_resize_is_pil_and_the_jax_core_bit_for_bit(jax_libs, h, w, oh, ow):
    rng = np.random.default_rng(h * 1000 + w)
    src = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    ref = np.asarray(Image.fromarray(src).resize((ow, oh), Image.BICUBIC))
    out = native_image.resize_rgb8_native(src, (oh, ow))
    np.testing.assert_array_equal(out, ref)
    np.testing.assert_array_equal(out, jnative_image.resize_rgb8_native(src, (oh, ow)))
    norm = native_image.resize_normalize_native(src, (oh, ow), IMAGE_MEAN, IMAGE_STD)
    assert norm.dtype == np.float32 and norm.shape == (3, oh, ow)
    np.testing.assert_array_equal(norm, _pil_normalized(src, oh, ow))
    np.testing.assert_array_equal(norm, jnative_image.resize_normalize_native(
        src, (oh, ow), IMAGE_MEAN, IMAGE_STD))


def test_resize_normalize_routes_by_input():
    """A uint8 image on the host takes the native core (PIL's values
    exactly, also for a non-contiguous view and a gray image); a float
    image keeps the interpolate path; the core refuses what it does not
    take."""
    rng = np.random.default_rng(1)
    big = rng.integers(0, 256, (300, 500, 3), dtype=np.uint8)
    view = big[10:290, 20:480]
    out = resize_normalize(view, (384, 608))
    assert isinstance(out, torch.Tensor) and out.dtype == torch.float32
    np.testing.assert_array_equal(out.numpy(),
                                  _pil_normalized(np.ascontiguousarray(view), 384, 608))
    gray = big[..., 0]
    np.testing.assert_array_equal(resize_normalize(gray, (64, 96)).numpy(),
                                  _pil_normalized(np.stack([gray] * 3, -1), 64, 96))
    f = rng.normal(size=(64, 64, 3)).astype(np.float32)
    assert resize_normalize(f, (32, 32)).shape == (3, 32, 32)
    with pytest.raises(ValueError, match="uint8"):
        native_image.resize_normalize_native(f, (32, 32), 0.5, 0.5)


@pytest.mark.parametrize("text", CORPUS)
def test_wordpiece_core_is_the_python_tokenizer_and_the_jax_core(jax_libs, text):
    tok = WordPieceTokenizer(VOCAB)
    nat = native_text.NativeWordPiece(VOCAB, VOCAB["[UNK]"], lowercase=True)
    assert nat.available
    ids = nat.tokenize_to_ids(text)
    assert ids == tok.convert_tokens_to_ids(tok.tokenize(text))
    assert ids == jnative_text.NativeWordPiece(VOCAB, VOCAB["[UNK]"]).tokenize_to_ids(text)


def test_wordpiece_routes_by_input(monkeypatch):
    """ASCII text without a protected token reaches the core; text with a
    protected token or a non-ASCII character the Python path; either way
    the ids are the JAX tokenizer's.  A vocabulary with gaps in its ids
    keeps to the Python path, as in the JAX package."""
    tok, jtok = WordPieceTokenizer(VOCAB), JWordPiece(VOCAB)
    tok.add_tokens(["$T$"])
    jtok.add_tokens(["$T$"])
    calls = []
    real = native_text.NativeWordPiece.tokenize_to_ids
    monkeypatch.setattr(native_text.NativeWordPiece, "tokenize_to_ids",
                        lambda self, t: calls.append(t) or real(self, t))
    for text in ("the quick fox", "the $T$ fox [SEP] dog", "café fox 😀"):
        assert tok.encode(text, max_length=12) == jtok.encode(text, max_length=12)
    assert calls == ["the quick fox", "café fox 😀"]  # the latter returns None
    assert native_text.NativeWordPiece(VOCAB, VOCAB["[UNK]"]).tokenize_to_ids("café") is None
    sparse = {t: 2 * i for i, t in enumerate(VOCAB)}
    assert not native_text.NativeWordPiece(sparse, sparse["[UNK]"]).available
    stok = WordPieceTokenizer(sparse)
    assert stok.encode("the fox", max_length=6) == JWordPiece(sparse).encode(
        "the fox", max_length=6)


_BUILD = """
import sys
sys.path.insert(0, {root!r})
from vault_tpu_torch.ops import _build, _build_host
_build.BUILD_DIR = _build_host.BUILD_DIR = __import__("pathlib").Path({out!r})
from vault_tpu_torch.text.native import NativeWordPiece
print(NativeWordPiece({{"[UNK]": 0, "a": 1}}, 0).tokenize_to_ids("a b a"))
"""


def test_concurrent_builds_leave_one_loadable_library(tmp_path):
    """Four processes building into one empty directory at once: each loads
    a whole library, one file remains, no temporary file is left."""
    code = _BUILD.format(root=str(ROOT), out=str(tmp_path))
    procs = [subprocess.Popen([sys.executable, "-c", code], stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for _ in range(4)]
    outs = [p.communicate(timeout=120) for p in procs]
    assert all(p.returncode == 0 for p in procs), [e for _, e in outs]
    assert [o.strip() for o, _ in outs] == ["[1, 0, 1]"] * 4
    assert [p.name for p in tmp_path.glob("lib*")] == [
        _build_host.lib_path("wordpiece").name]
    assert not list(tmp_path.glob("*.tmp"))


def test_build_names_the_compiler_and_hashes_source_and_flags(monkeypatch, tmp_path):
    """The library's name changes with the flags; a compiler that fails
    raises naming it; nothing falls back."""
    name = _build_host.lib_path("wordpiece").name
    monkeypatch.setitem(_build_host.FLAGS, "wordpiece",
                        _build_host.FLAGS["wordpiece"] + ("-DVT_TEST",))
    assert _build_host.lib_path("wordpiece").name != name
    assert _build_host.lib_path("wordpiece").parent == _build.BUILD_DIR
    monkeypatch.setattr(_build_host, "BUILD_DIR", tmp_path)
    monkeypatch.setitem(_build_host.FLAGS, "wordpiece", ("-Wall", "--no-such-flag"))
    with pytest.raises(RuntimeError, match="g\\+\\+|c\\+\\+"):
        _build_host.build("wordpiece")
    monkeypatch.setenv("CXX", "no-such-compiler")
    with pytest.raises(RuntimeError, match="no-such-compiler"):
        _build_host.build("wordpiece")
