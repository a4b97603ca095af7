"""Corpus-statistics word segmentation for hashtag unpacking (a copy of
``vault_tpu/text/segmenter.py``; its tables are copies too, in this
package's ``text/data/``).

The reference unpacks hashtags with ekphrasis' statistical segmenter
(vault/utils.py:196-207: ``segmenter="twitter_2018"``, ``unpack_hashtags=True``)
and its tag handler rejoins the segments as ``# a-b-c`` (vault/utils.py:155-181).
This module reimplements the segmentation algorithm — maximum-likelihood
splitting under a unigram/bigram language model with a length-exponential
unknown-word penalty (the Norvig word-segmentation formulation ekphrasis
uses) — against the checked-in offline tables (``text/data/unigrams_en.txt``
and ``bigrams_en.txt``, built by ``scripts/build_segmenter_stats.py``) (the twitter_2018 corpus itself is not
redistributable/downloadable here).

Properties that matter for hashtag segmentation:
  * a known whole word beats any split of it into known words (frequency
    products fall fast), so "sunset" stays one token;
  * an unknown whole word beats splits that contain unknown fragments
    (the 1/10^len penalty is convex), so "bertweet" isn't shredded;
  * splits win only when every part is known and common — "mynewcar" ->
    ["my", "new", "car"].
"""

from __future__ import annotations

import functools
import math
import os
from typing import Dict, List, Optional, Tuple

_DATA_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
_MAX_WORD = 24  # ekphrasis' split bound


def _load_table(path: str) -> Dict[str, int]:
    table: Dict[str, int] = {}
    with open(path) as f:
        for line in f:
            key, _, cnt = line.rstrip("\n").rpartition("\t")
            if key:
                table[key] = int(cnt)
    return table


class Segmenter:
    """Max-likelihood segmentation of an all-lowercase alphabetic string."""

    def __init__(self, unigrams: Optional[Dict[str, int]] = None,
                 bigrams: Optional[Dict[str, int]] = None):
        if unigrams is None:
            unigrams = _load_table(os.path.join(_DATA_DIR, "unigrams_en.txt"))
        if bigrams is None:
            bigrams = _load_table(os.path.join(_DATA_DIR, "bigrams_en.txt"))
        self.unigrams = unigrams
        self.bigrams = bigrams
        self.total = float(sum(unigrams.values())) or 1.0
        self._seg = functools.lru_cache(maxsize=65536)(self._segment_rec)

    # ------------------------------------------------------------- scoring
    def _log_punigram(self, word: str) -> float:
        cnt = self.unigrams.get(word)
        if cnt is not None:
            return math.log10(cnt / self.total)
        # unknown-word penalty: P = 10 / (N * 10^len)
        return math.log10(10.0 / self.total) - len(word)

    def _log_pcond(self, word: str, prev: str) -> float:
        """log10 P(word | prev) via bigram counts when available."""
        big = self.bigrams.get(f"{prev} {word}")
        prev_cnt = self.unigrams.get(prev)
        if big is not None and prev_cnt:
            return math.log10(big / prev_cnt)
        return self._log_punigram(word)

    # -------------------------------------------------------------- search
    def _segment_rec(self, text: str, prev: str) -> Tuple[float, Tuple[str, ...]]:
        if not text:
            return 0.0, ()
        best = (-math.inf, ())
        for i in range(1, min(len(text), _MAX_WORD) + 1):
            head, rest = text[:i], text[i:]
            score = self._log_pcond(head, prev)
            rest_score, rest_words = self._seg(rest, head)
            cand = (score + rest_score, (head,) + rest_words)
            if cand[0] > best[0]:
                best = cand
        return best

    def segment(self, text: str) -> List[str]:
        """Split an all-lowercase alphabetic chunk into most-likely words."""
        if not text:
            return []
        return list(self._seg(text, "<s>")[1])


_default: Optional[Segmenter] = None


def default_segmenter() -> Segmenter:
    global _default
    if _default is None:
        _default = Segmenter()
    return _default
