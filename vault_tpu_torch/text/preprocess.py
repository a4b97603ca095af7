"""Twitter text preprocessing + demojization (a copy of
``vault_tpu/text/preprocess.py``, reading this package's segmenter).

Behavior-equivalent rebuild of the reference's ekphrasis pipeline + tag
handler (vault/utils.py:118-212) and per-LM demojizer selection
(vault/utils.py:18-50).  ekphrasis/emoji aren't available in this
environment, so both are implemented natively with the same output
conventions:

  * url/email/phone/user mentions -> bare tag words ("url", "user", ...)
    (ekphrasis ``normalize`` + the reference's tag_handler mapping
    ``<tag>`` -> ``tag``);
  * hashtags -> ``# seg-ment-ed`` (reference rejoins ekphrasis hashtag
    segments with "-" after a "# " marker, vault/utils.py:155-181);
    segmentation splits on explicit case/digit/underscore boundaries and
    then statistically segments lowercase chunks with the corpus-statistics
    model in text/segmenter.py (ekphrasis ``segmenter="twitter_2018"``,
    ``unpack_hashtags=True`` behavior, vault/utils.py:196-207);
  * annotation tags (allcaps/elongated/repeated/emphasis/censored) carry no
    surface form — the reference *drops* them in its tag handler — but the
    ekphrasis *surface normalizations* that precede the tags are applied:
    elongations reduced to two chars (Helloooo -> helloo), repeated
    punctuation collapsed to its distinct marks (!!!? -> !?), emphasis
    asterisks stripped (*word* -> word), censored words kept whole (f**k);
  * common English contractions unpacked (ekphrasis unpack_contractions);
  * emojis -> "(name words)" via unicodedata names, matching
    ``emoji.demojize(..., delimiters=("(", ")")).replace("_", " ")``.
"""

from __future__ import annotations

import re
import unicodedata
from typing import Callable, List, Optional

_URL = re.compile(r"(?:https?://|www\.)\S+", re.IGNORECASE)
_EMAIL = re.compile(r"\b[\w.+-]+@[\w-]+\.[\w.-]+\b")
_PHONE = re.compile(r"(?<!\w)(?:\+?\d{1,3}[ .-]?)?(?:\(?\d{3}\)?[ .-]?)\d{3}[ .-]?\d{4}(?!\w)")
_USER = re.compile(r"@\w+")
_HASHTAG = re.compile(r"#(\w+)")

_CONTRACTIONS = [
    (re.compile(r"\b(can)'t\b", re.I), r"\1 not"),
    (re.compile(r"\b(won)'t\b", re.I), "will not"),
    (re.compile(r"\b(\w+)n't\b", re.I), r"\1 not"),
    (re.compile(r"\b(\w+)'re\b", re.I), r"\1 are"),
    (re.compile(r"\b(\w+)'ll\b", re.I), r"\1 will"),
    (re.compile(r"\b(\w+)'ve\b", re.I), r"\1 have"),
    (re.compile(r"\b(\w+)'m\b", re.I), r"\1 am"),
    (re.compile(r"\b(\w+)'d\b", re.I), r"\1 would"),
]

# censored words (f**k) and emoticons kept whole (ekphrasis SocialTokenizer
# keeps :) :-( ;P etc. as single tokens); otherwise words and punctuation
_TOKEN = re.compile(
    r"\w+(?:\*+\w+)+"              # censored: f**k
    r"|[:;=8xX][-o^']?[)(\]\[dDpP/\\|@*3]"   # western emoticons
    r"|<3"                          # heart
    r"|[!?.]+"                      # punctuation runs stay one token (?!)
    r"|\w+|[^\w\s]")
# LETTERS only, like ekphrasis' elongated regex
# (\b[A-Za-z]*([a-zA-Z])\1\1[A-Za-z]*\b) — \w would collapse digit runs
# and rewrite every year/price ("2000" -> "200")
_ELONG = re.compile(r"([A-Za-z])\1{2,}")
_REPEAT_PUNCT = re.compile(r"([!?.])(?:[!?.])+")
_EMPHASIS = re.compile(r"\*(\w+)\*")


def _segment_hashtag(body: str) -> List[str]:
    """ekphrasis-equivalent hashtag unpacking: explicit case/digit/underscore
    boundaries first, then corpus-statistics segmentation of each lowercase
    alphabetic chunk (#mynewcar -> my/new/car; #MyNewCar likewise;
    #iphone7 -> iphone/7)."""
    from vault_tpu_torch.text.segmenter import default_segmenter

    parts = re.findall(r"[A-Z]+(?=[A-Z][a-z])|[A-Z]?[a-z]+|[A-Z]+|\d+",
                       body.replace("_", " "))
    seg = default_segmenter()
    out: List[str] = []
    for p in parts:
        p = p.lower()
        out.extend(seg.segment(p) if p.isalpha() else [p])
    return out or [body.lower()]


def _normalize_token_surface(text: str) -> str:
    """The surface effects of ekphrasis' annotate set (the tags themselves
    are dropped by the reference's tag handler, vault/utils.py:149-158)."""
    text = _EMPHASIS.sub(r"\1", text)           # *word* -> word
    text = _ELONG.sub(r"\1\1", text)            # helloooo -> helloo
    # !!!??? -> its distinct marks, sorted descending (ekphrasis
    # handle_repeated_puncts keeps one of each distinct mark)
    text = _REPEAT_PUNCT.sub(
        lambda m: "".join(sorted(set(m.group(0)), reverse=True)), text)
    return text


def twitter_preprocessor(normalized_tags: Optional[List[str]] = None,
                         extra_tags: Optional[List[str]] = None) -> Callable[[str], str]:
    normalized_tags = normalized_tags or ["url", "email", "phone", "user"]
    # falsy extra_tags ([] or None) falls back to the full default set,
    # exactly like the reference's `extra_tags or [hashtag, elongated, ...]`
    # (vault/utils.py:134-141) — an explicit empty list must NOT disable
    # hashtag unpacking
    hashtags = ("hashtag" in extra_tags) if extra_tags else True

    def process(text: str) -> str:
        if "url" in normalized_tags:
            text = _URL.sub(" url ", text)
        if "email" in normalized_tags:
            text = _EMAIL.sub(" email ", text)
        if "phone" in normalized_tags:
            text = _PHONE.sub(" phone ", text)
        if "user" in normalized_tags:
            text = _USER.sub(" user ", text)
        for pat, rep in _CONTRACTIONS:
            text = pat.sub(rep, text)

        def plain(chunk: str):
            return (t.lower() for t in
                    _TOKEN.findall(_normalize_token_surface(chunk)))

        out: List[str] = []
        pos = 0
        for m in _HASHTAG.finditer(text):
            out.extend(plain(text[pos:m.start()]))
            if hashtags:
                out.append("# " + "-".join(_segment_hashtag(m.group(1))))
            else:
                out.append(m.group(1).lower())
            pos = m.end()
        out.extend(plain(text[pos:]))
        return " ".join(out).strip()

    process.log = f"native twitter preprocessor: {normalized_tags}, hashtags={hashtags}"
    return process


# emoji-style codepoints BELOW the U+2190 arrows/symbols cutoff that
# emoji.demojize still converts (common in tweets): copyright, registered,
# double exclamation, exclamation question, information source, trade mark
_LOW_EMOJI = frozenset(map(ord, "©®‼⁉ℹ™"))


def _demojize_en(text: str, delimiters=("(", ")")) -> str:
    """Best-effort stand-in for emoji.demojize (unavailable offline): name
    emoji-plane codepoints and high SYMBOL characters.  Scoped by unicode
    category so it never touches letters — a >=U+2190 codepoint test alone
    would rewrite CJK/Hangul/kana text into name parentheticals.  Variation
    selectors / ZWJ are dropped (demojize folds them into the emoji name)."""
    out = []
    for ch in text:
        cp = ord(ch)
        if cp in (0xFE0E, 0xFE0F, 0x200D):  # invisible emoji modifiers
            continue
        is_emoji_like = cp in _LOW_EMOJI or cp >= 0x1F000 or (
            cp >= 0x2190 and unicodedata.category(ch) in ("So", "Sk"))
        if is_emoji_like:
            try:
                name = unicodedata.name(ch).lower()
            except ValueError:
                out.append(ch)
                continue
            out.append(f"{delimiters[0]}{name}{delimiters[1]}")
        else:
            out.append(ch)
    return "".join(out)


def demojizer_selector(model_name: str, delimiters=("(", ")")) -> Callable[[str], str]:
    """Per-LM emoji policy (vault/utils.py:18-50): BERTweet keeps raw emoji
    (its tokenizer handles them); bert-base-uncased gets English
    descriptions."""
    identity = lambda x: x
    demojize = lambda x: _demojize_en(x, delimiters)
    table = {
        "vinai/bertweet-base": identity,
        "bertweet-base": identity,
        "bert-base-uncased": demojize,
        "bert-base-multilingual-uncased": demojize,
    }
    return table.get(model_name, identity)
