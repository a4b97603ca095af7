"""Native byte-level BPE tokenizer (GPT-2 / RoBERTa family; a copy of the JAX
package's ``vault_tpu/text/bpe.py``).

Covers the RoBERTa-architecture towers (SURVEY.md §2.7: BERTweet is
RoBERTa-architecture with its own tokenizer; generic roberta-base towers use
byte-level BPE).  Loads standard ``vocab.json`` + ``merges.txt``; parity with
the JAX package's tokenizer is asserted in tests/test_torch_tokenizers.py.
BERTweet's fastBPE format is ``text/fastbpe.py``.
"""

from __future__ import annotations

import json
import re
from functools import lru_cache
from typing import Dict, List, Sequence, Tuple

from vault_tpu_torch.text.roberta_format import RobertaEncodeMixin


@lru_cache()
def bytes_to_unicode() -> Dict[int, str]:
    """GPT-2's reversible byte<->unicode mapping: printable bytes map to
    themselves; the rest shift into U+0100+."""
    bs = (list(range(ord("!"), ord("~") + 1))
          + list(range(ord("\xa1"), ord("\xac") + 1))
          + list(range(ord("\xae"), ord("\xff") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


# GPT-2 pre-tokenization pattern (contractions, words, numbers, other,
# spaces).  The "other" class is GPT-2's [^\s\p{L}\p{N}]+ — python re has
# no \p{..}, so it's expressed as "not (space|word) OR underscore": '_' is
# \w but is NOT a letter/number, so GPT-2 treats it as "other"; omitting
# the |_ silently DROPPED underscores from the token stream.
_PAT = re.compile(
    r"'s|'t|'re|'ve|'m|'ll|'d| ?[^\W\d_]+| ?\d+| ?(?:[^\s\w]|_)+"
    r"|\s+(?!\S)|\s+",
    re.UNICODE)


class ByteLevelBPE(RobertaEncodeMixin):
    def __init__(self, vocab, merges, unk_token: str = "<unk>",
                 bos_token: str = "<s>", eos_token: str = "</s>",
                 pad_token: str = "<pad>", mask_token: str = "<mask>"):
        """vocab: path to vocab.json or dict; merges: path to merges.txt or
        list of (a, b) pairs."""
        if isinstance(vocab, str):
            with open(vocab, encoding="utf-8") as f:
                vocab = json.load(f)
        self.vocab: Dict[str, int] = dict(vocab)
        self.ids_to_tokens = {i: t for t, i in self.vocab.items()}
        if isinstance(merges, str):
            with open(merges, encoding="utf-8") as f:
                lines = [l.rstrip("\n") for l in f]
            if lines and lines[0].startswith("#version"):
                lines = lines[1:]
            merges = [tuple(l.split()) for l in lines if l]
        self.bpe_ranks: Dict[Tuple[str, str], int] = {
            tuple(m): i for i, m in enumerate(merges)}
        self.byte_encoder = bytes_to_unicode()
        self.byte_decoder = {v: k for k, v in self.byte_encoder.items()}
        self.unk_token, self.bos_token = unk_token, bos_token
        self.eos_token, self.pad_token = eos_token, pad_token
        self.mask_token = mask_token
        self._cache: Dict[str, List[str]] = {}

    @property
    def pad_token_id(self) -> int:
        return self.vocab[self.pad_token]

    def __len__(self) -> int:
        return len(self.vocab)

    def _bpe(self, token: str) -> List[str]:
        if token in self._cache:
            return self._cache[token]
        word: List[str] = list(token)
        while len(word) > 1:
            pairs = {(word[i], word[i + 1]) for i in range(len(word) - 1)}
            best = min(pairs, key=lambda p: self.bpe_ranks.get(p, 1 << 30))
            if best not in self.bpe_ranks:
                break
            a, b = best
            merged: List[str] = []
            i = 0
            while i < len(word):
                if i < len(word) - 1 and word[i] == a and word[i + 1] == b:
                    merged.append(a + b)
                    i += 2
                else:
                    merged.append(word[i])
                    i += 1
            word = merged
        self._cache[token] = word
        return word

    def tokenize(self, text: str) -> List[str]:
        out: List[str] = []
        for chunk in _PAT.findall(text):
            mapped = "".join(self.byte_encoder[b] for b in chunk.encode("utf-8"))
            out.extend(self._bpe(mapped))
        return out

    def convert_tokens_to_ids(self, tokens: Sequence[str]) -> List[int]:
        unk = self.vocab.get(self.unk_token, 0)
        return [self.vocab.get(t, unk) for t in tokens]

