"""ctypes wrapper of the native WordPiece core (``csrc/host/wordpiece.cpp``,
built at first use by ``ops/_build_host.py``; the port's counterpart of the
JAX package's ``vault_tpu/text/native.py``).

The core tokenizes ASCII text as the Python tokenizer does.  Which text
reaches it is decided by input in :meth:`~vault_tpu_torch.text.wordpiece.
WordPieceTokenizer._ids_for_text`: ASCII text without a protected token.
A library that does not build or load raises."""

from __future__ import annotations

import ctypes
from typing import Dict, List, Optional

from vault_tpu_torch.ops import _build_host

_SIGNATURES = {
    "wp_create": ([ctypes.POINTER(ctypes.c_char_p), ctypes.c_int32, ctypes.c_int32,
                   ctypes.c_int32, ctypes.c_int32], ctypes.c_void_p),
    "wp_free": ([ctypes.c_void_p], None),
    "wp_tokenize": ([ctypes.c_void_p, ctypes.c_char_p, ctypes.POINTER(ctypes.c_int32),
                     ctypes.c_int32], ctypes.c_int32),
}


def library() -> ctypes.CDLL:
    return _build_host.load("wordpiece", _SIGNATURES)


class NativeWordPiece:
    """A vocabulary loaded into the C++ core.  ``available`` is False for a
    vocabulary whose ids are not 0..n-1 (the core numbers tokens by
    position); the tokenizer then keeps to its Python path, as the JAX
    package's does."""

    def __init__(self, vocab: Dict[str, int], unk_id: int,
                 lowercase: bool = True, max_chars_per_word: int = 100):
        self._handle = None
        items = sorted(vocab.items(), key=lambda kv: kv[1])
        if [v for _, v in items] != list(range(len(items))):
            return
        self._lib = library()
        arr = (ctypes.c_char_p * len(items))()
        self._keepalive = [k.encode("utf-8") for k, _ in items]
        for i, b in enumerate(self._keepalive):
            arr[i] = b
        self._handle = self._lib.wp_create(arr, len(items), unk_id,
                                           1 if lowercase else 0, max_chars_per_word)

    @property
    def available(self) -> bool:
        return self._handle is not None

    def tokenize_to_ids(self, text: str) -> Optional[List[int]]:
        """The ids of ASCII ``text``; None for other text (or when not
        ``available``)."""
        if self._handle is None or not text.isascii():
            return None
        # a token is at least one character: len(text) ids always fit
        buf = (ctypes.c_int32 * max(1, len(text)))()
        n = self._lib.wp_tokenize(self._handle, text.encode("ascii"), buf, len(buf))
        return list(buf[:n])

    def __del__(self):
        if getattr(self, "_handle", None) is not None:
            self._lib.wp_free(self._handle)
