"""WordPiece tokenizer, HF ``BertTokenizer``-compatible (a copy of the JAX
package's ``vault_tpu/text/wordpiece.py``).  Body text that is ASCII and
holds no protected token goes to the native C++ core
(``text/native.py``, built at first use), as in the JAX package; other text
goes through the Python tokenizer here.  Both give the same ids.

The reference swaps ViLT's tokenizer for the BERT tower's
(vault/models/vault/processor.py:6-18) and relies on HF tokenization
semantics: basic tokenization (clean / lowercase / strip accents / punctuation
split / CJK spacing) followed by greedy longest-match WordPiece with ``##``
continuation.  This is a standalone reimplementation loading standard
``vocab.txt`` files, so the framework has no hard dependency on HF at runtime.
"""

from __future__ import annotations

import unicodedata
from typing import Dict, List, Optional, Sequence, Union


def load_vocab(vocab_file: str) -> Dict[str, int]:
    vocab: Dict[str, int] = {}
    with open(vocab_file, encoding="utf-8") as f:
        for i, line in enumerate(f):
            tok = line.rstrip("\n")
            if tok:
                vocab[tok] = i
    return vocab


def _is_whitespace(ch: str) -> bool:
    if ch in (" ", "\t", "\n", "\r"):
        return True
    return unicodedata.category(ch) == "Zs"


def _is_control(ch: str) -> bool:
    if ch in ("\t", "\n", "\r"):
        return False
    return unicodedata.category(ch).startswith("C")


def _is_punctuation(ch: str) -> bool:
    cp = ord(ch)
    if (33 <= cp <= 47) or (58 <= cp <= 64) or (91 <= cp <= 96) or (123 <= cp <= 126):
        return True
    return unicodedata.category(ch).startswith("P")


def _is_cjk(cp: int) -> bool:
    return (
        0x4E00 <= cp <= 0x9FFF or 0x3400 <= cp <= 0x4DBF
        or 0x20000 <= cp <= 0x2A6DF or 0x2A700 <= cp <= 0x2B73F
        or 0x2B740 <= cp <= 0x2B81F or 0x2B820 <= cp <= 0x2CEAF
        or 0xF900 <= cp <= 0xFAFF or 0x2F800 <= cp <= 0x2FA1F
    )


class BasicTokenizer:
    def __init__(self, lowercase: bool = True, strip_accents: Optional[bool] = None):
        self.lowercase = lowercase
        self.strip_accents = strip_accents

    def _clean(self, text: str) -> str:
        out = []
        for ch in text:
            cp = ord(ch)
            if cp == 0 or cp == 0xFFFD or _is_control(ch):
                continue
            out.append(" " if _is_whitespace(ch) else ch)
        return "".join(out)

    def _space_cjk(self, text: str) -> str:
        out = []
        for ch in text:
            if _is_cjk(ord(ch)):
                out.append(f" {ch} ")
            else:
                out.append(ch)
        return "".join(out)

    def _strip_accents(self, text: str) -> str:
        return "".join(ch for ch in unicodedata.normalize("NFD", text)
                       if unicodedata.category(ch) != "Mn")

    def _split_punct(self, token: str) -> List[str]:
        pieces: List[str] = []
        current: List[str] = []
        for ch in token:
            if _is_punctuation(ch):
                if current:
                    pieces.append("".join(current))
                    current = []
                pieces.append(ch)
            else:
                current.append(ch)
        if current:
            pieces.append("".join(current))
        return pieces

    def tokenize(self, text: str, never_split: Sequence[str] = ()) -> List[str]:
        text = self._clean(text)
        text = self._space_cjk(text)
        tokens: List[str] = []
        for tok in text.split():
            if tok in never_split:
                tokens.append(tok)
                continue
            if self.lowercase:
                tok = tok.lower()
                if self.strip_accents is not False:
                    tok = self._strip_accents(tok)
            elif self.strip_accents:
                tok = self._strip_accents(tok)
            tokens.extend(self._split_punct(tok))
        return tokens


class WordPieceTokenizer:
    """HF BertTokenizer equivalent: basic tokenize + WordPiece + specials."""

    def __init__(self, vocab: Union[str, Dict[str, int]], lowercase: bool = True,
                 unk_token: str = "[UNK]", cls_token: str = "[CLS]",
                 sep_token: str = "[SEP]", pad_token: str = "[PAD]",
                 mask_token: str = "[MASK]", max_chars_per_word: int = 100):
        if isinstance(vocab, str):
            vocab = load_vocab(vocab)
        self.vocab = dict(vocab)
        self.ids_to_tokens = {i: t for t, i in self.vocab.items()}
        self.basic = BasicTokenizer(lowercase)
        self.unk_token, self.cls_token = unk_token, cls_token
        self.sep_token, self.pad_token = sep_token, pad_token
        self.mask_token = mask_token
        self.max_chars_per_word = max_chars_per_word
        self.added_tokens: Dict[str, int] = {}
        self._native = None  # the C++ core, loaded at the first encode

    # -- vocab management (reference: --add_placeholder_token adds "$T$" and
    #    resizes embeddings, experiments/clsf_vault.py:99-100, 205-209) -----
    def add_tokens(self, tokens: Sequence[str]) -> int:
        added = 0
        for t in tokens:
            if t not in self.vocab and t not in self.added_tokens:
                idx = len(self.vocab) + len(self.added_tokens)
                self.added_tokens[t] = idx
                self.ids_to_tokens[idx] = t
                added += 1
        return added

    def __len__(self) -> int:
        return len(self.vocab) + len(self.added_tokens)

    @property
    def pad_token_id(self) -> int:
        return self.vocab[self.pad_token]

    @property
    def mask_token_id(self) -> int:
        return self.vocab[self.mask_token]

    def _wordpiece(self, token: str) -> List[str]:
        if len(token) > self.max_chars_per_word:
            return [self.unk_token]
        out: List[str] = []
        start = 0
        while start < len(token):
            end = len(token)
            piece = None
            while start < end:
                sub = token[start:end]
                if start > 0:
                    sub = "##" + sub
                if sub in self.vocab:
                    piece = sub
                    break
                end -= 1
            if piece is None:
                return [self.unk_token]
            out.append(piece)
            start = end
        return out

    @property
    def _protected(self) -> List[str]:
        """Tokens that survive basic tokenization intact: user-added tokens
        (e.g. "$T$") and the special tokens — the reference embeds sep_token
        literally in TMSC text (vault/models/vault/dataset.py:256-261)."""
        return list(self.added_tokens) + [self.unk_token, self.cls_token,
                                          self.sep_token, self.pad_token,
                                          self.mask_token]

    def tokenize(self, text: str) -> List[str]:
        never = self._protected
        tokens: List[str] = []
        for chunk in self._split_on_added(text):
            if chunk in never:
                tokens.append(chunk)
            else:
                for tok in self.basic.tokenize(chunk, never_split=never):
                    tokens.extend(self._wordpiece(tok))
        return tokens

    def _split_on_added(self, text: str) -> List[str]:
        chunks = [text]
        for tok in self._protected:
            protected = set(self._protected)
            next_chunks: List[str] = []
            for ch in chunks:
                if ch in protected:
                    next_chunks.append(ch)
                    continue
                parts = ch.split(tok)
                for i, p in enumerate(parts):
                    if p:
                        next_chunks.append(p)
                    if i < len(parts) - 1:
                        next_chunks.append(tok)
            chunks = next_chunks
        return chunks

    def _ids_for_text(self, text: str) -> List[int]:
        """Body text to ids: the native core for ASCII text without a
        protected token (and a vocabulary numbered 0..n-1), the Python
        tokenizer for the rest, as the JAX package routes it."""
        if self._native is None:
            from vault_tpu_torch.text.native import NativeWordPiece

            self._native = NativeWordPiece(self.vocab, self.vocab[self.unk_token],
                                           self.basic.lowercase,
                                           self.max_chars_per_word)
        if self._native.available and not any(t in text for t in self._protected):
            ids = self._native.tokenize_to_ids(text)
            if ids is not None:
                return ids
        return self.convert_tokens_to_ids(self.tokenize(text))

    def convert_tokens_to_ids(self, tokens: Sequence[str]) -> List[int]:
        out = []
        for t in tokens:
            if t in self.added_tokens:
                out.append(self.added_tokens[t])
            else:
                out.append(self.vocab.get(t, self.vocab[self.unk_token]))
        return out

    def convert_ids_to_tokens(self, ids: Sequence[int]) -> List[str]:
        return [self.ids_to_tokens.get(i, self.unk_token) for i in ids]

    def encode(
        self,
        text: str,
        text_pair: Optional[str] = None,
        max_length: Optional[int] = None,
        padding: str = "max_length",
        truncation: bool = True,
    ) -> Dict[str, List[int]]:
        """Returns input_ids / attention_mask / token_type_ids, matching HF
        ``padding="max_length", truncation=True`` (longest_first for pairs) as
        the reference's datasets call it (vault/vl_utils/dataset.py:190-200)."""
        a = self._ids_for_text(text)
        b = self._ids_for_text(text_pair) if text_pair is not None else None
        n_special = 3 if b is not None else 2
        if truncation and max_length is not None:
            budget = max_length - n_special
            if b is None:
                a = a[:budget]
            else:
                # longest-first: trim the longer sequence one token at a
                # time.  TIES trim the PAIR, exactly as HF truncate_sequences
                # does (`if len(ids) > len(pair_ids): ids else pair_ids`) —
                # the reference leans on this ("truncates preferably from
                # the target if the two are equal",
                # vault/models/tombert/dataset.py:186)
                while len(a) + len(b) > budget:
                    if len(a) > len(b):
                        a = a[:-1]
                    else:
                        b = b[:-1]
        cls_id = self.vocab[self.cls_token]
        sep_id = self.vocab[self.sep_token]
        ids = [cls_id] + a + [sep_id]
        type_ids = [0] * len(ids)
        if b is not None:
            ids += b + [sep_id]
            type_ids += [1] * (len(b) + 1)
        mask = [1] * len(ids)
        if padding == "max_length" and max_length is not None:
            pad_n = max_length - len(ids)
            ids += [self.pad_token_id] * pad_n
            mask += [0] * pad_n
            type_ids += [0] * pad_n
        return {"input_ids": ids, "attention_mask": mask, "token_type_ids": type_ids}

    def batch_encode(self, texts: Sequence[str],
                     text_pairs: Optional[Sequence[Optional[str]]] = None,
                     max_length: Optional[int] = None,
                     padding: str = "max_length", truncation: bool = True):
        import numpy as np

        if text_pairs is None:
            text_pairs = [None] * len(texts)
        encs = [self.encode(t, p, max_length, padding, truncation)
                for t, p in zip(texts, text_pairs)]
        if padding != "max_length" or max_length is None:
            max_len = max(len(e["input_ids"]) for e in encs)
            for e in encs:
                pad_n = max_len - len(e["input_ids"])
                e["input_ids"] += [self.pad_token_id] * pad_n
                e["attention_mask"] += [0] * pad_n
                e["token_type_ids"] += [0] * pad_n
        return {k: np.asarray([e[k] for e in encs], np.int32)
                for k in ("input_ids", "attention_mask", "token_type_ids")}
