"""Native fastBPE tokenizer — the BERTweet (`vinai/bertweet-base`) format (a
copy of the JAX package's ``vault_tpu/text/fastbpe.py``).

Completes the tokenizer family (WordPiece, byte-level BPE, fastBPE) so every
LM tower the reference uses runs without the HF runtime.  Contract matches
HF ``BertweetTokenizer`` (normalization=False, its default):

  * vocab file: "<token> <count>" lines appended after the fairseq specials
    ``<s>=0, <pad>=1, </s>=2, <unk>=3`` with ``<mask>`` appended last;
  * merges file: "a b [count]" lines (count dropped), first line may be a
    version header;
  * BPE over whitespace tokens with a ``</w>`` end-of-word marker; continuing
    pieces carry an ``@@`` suffix;
  * encoding format ``<s> A </s> [</s> B </s>]`` (RoBERTa-style, all
    token_type 0).

Parity with the JAX package's tokenizer is asserted in
tests/test_torch_tokenizers.py.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

from vault_tpu_torch.text.roberta_format import RobertaEncodeMixin


SPECIAL_PUNCTS = {"’": "'", "…": "..."}


def normalize_tweet(tweet: str, demojizer=None) -> str:
    """BERTweet's tweet normalization (BertweetTokenizer.normalizeTweet):
    nltk TweetTokenizer split, @handles -> @USER, urls -> HTTPURL, punct
    unification, optional demojize, contraction re-spacing.  Requires nltk."""
    from nltk.tokenize import TweetTokenizer

    for punct, repl in SPECIAL_PUNCTS.items():
        tweet = tweet.replace(punct, repl)

    def norm_token(token: str) -> str:
        low = token.lower()
        if token.startswith("@"):
            return "@USER"
        if low.startswith("http") or low.startswith("www"):
            return "HTTPURL"
        if len(token) == 1:
            if token in SPECIAL_PUNCTS:
                return SPECIAL_PUNCTS[token]
            return demojizer(token) if demojizer is not None else token
        return token

    tokens = TweetTokenizer().tokenize(tweet)
    out = " ".join(norm_token(t) for t in tokens)
    out = (out.replace("cannot ", "can not ").replace("n't ", " n't ")
           .replace("n 't ", " n't ").replace("ca n't", "can't")
           .replace("ai n't", "ain't"))
    out = (out.replace("'m ", " 'm ").replace("'re ", " 're ")
           .replace("'s ", " 's ").replace("'ll ", " 'll ")
           .replace("'d ", " 'd ").replace("'ve ", " 've "))
    # (HF quirk preserved: p.m. gets a double space, a.m. a single one)
    out = (out.replace(" p . m .", "  p.m.").replace(" p . m ", " p.m ")
           .replace(" a . m .", " a.m.").replace(" a . m ", " a.m "))
    return " ".join(out.split())


def _read_merges(merges_file: str) -> List[Tuple[str, str]]:
    with open(merges_file, encoding="utf-8") as f:
        lines = f.read().split("\n")[:-1]
    if lines and lines[0].startswith("#version"):
        lines = lines[1:]
    return [tuple(l.split()[:2]) for l in lines if l]


def _read_vocab(vocab_file: str, bos="<s>", pad="<pad>", eos="</s>",
                unk="<unk>", mask="<mask>") -> Dict[str, int]:
    encoder = {bos: 0, pad: 1, eos: 2, unk: 3}
    with open(vocab_file, encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            idx = line.rfind(" ")
            word = line[:idx] if idx != -1 else line
            if word not in encoder:
                encoder[word] = len(encoder)
    encoder.setdefault(mask, len(encoder))
    return encoder


class FastBPE(RobertaEncodeMixin):
    def __init__(self, vocab_file: str, merges_file: str,
                 normalization: bool = False,
                 bos_token: str = "<s>", eos_token: str = "</s>",
                 pad_token: str = "<pad>", unk_token: str = "<unk>",
                 mask_token: str = "<mask>", demojizer=None):
        self.vocab = _read_vocab(vocab_file, bos_token, pad_token, eos_token,
                                 unk_token, mask_token)
        self.ids_to_tokens = {i: t for t, i in self.vocab.items()}
        merges = _read_merges(merges_file)
        self.bpe_ranks = {m: i for i, m in enumerate(merges)}
        self.bos_token, self.eos_token = bos_token, eos_token
        self.pad_token, self.unk_token = pad_token, unk_token
        self.mask_token = mask_token
        self.normalization = normalization
        self.demojizer = demojizer
        self._cache: Dict[str, str] = {}

    @property
    def pad_token_id(self) -> int:
        return self.vocab[self.pad_token]

    def __len__(self) -> int:
        return len(self.vocab)

    def _bpe(self, token: str) -> str:
        if token in self._cache:
            return self._cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        if len(word) == 1:
            return token
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
            word = tuple(merged)
        out = "@@ ".join(word)
        out = out[:-4]  # strip the trailing "</w>"
        self._cache[token] = out
        return out

    def tokenize(self, text: str) -> List[str]:
        import re

        if self.normalization:
            text = normalize_tweet(text, self.demojizer)
        tokens: List[str] = []
        for tok in re.findall(r"\S+\n?", text):
            tokens.extend(self._bpe(tok).split(" "))
        return tokens

    def convert_tokens_to_ids(self, tokens: Sequence[str]) -> List[int]:
        unk = self.vocab[self.unk_token]
        return [self.vocab.get(t, unk) for t in tokens]

