"""VQA answer normalization (a copy of ``vault_tpu/data/vqa.py``) — the
standard VQAv2 evaluation normalization
(same contract the reference vendors from the public ViLT repo at
vault/vl_utils/dataset_utils.py:39-229): punctuation stripping with
digit-comma handling, number words -> digits, article removal, contraction
restoration.  The tables are the canonical public VQA-eval constants.
"""

from __future__ import annotations

import re
from typing import Dict, List

# canonical VQA-eval contraction restorations, "collapsed spelling" ->
# apostrophized form (encoded compactly; split on ':')
_CONTRACTION_PAIRS = """
aint:ain't arent:aren't cant:can't couldve:could've couldnt:couldn't
couldn'tve:couldn't've couldnt've:couldn't've didnt:didn't doesnt:doesn't
dont:don't hadnt:hadn't hadnt've:hadn't've hadn'tve:hadn't've hasnt:hasn't
havent:haven't hed:he'd hed've:he'd've he'dve:he'd've hes:he's howd:how'd
howll:how'll hows:how's Id've:I'd've I'dve:I'd've Im:I'm Ive:I've isnt:isn't
itd:it'd itd've:it'd've it'dve:it'd've itll:it'll let's:let's maam:ma'am
mightnt:mightn't mightnt've:mightn't've mightn'tve:mightn't've
mightve:might've mustnt:mustn't mustve:must've neednt:needn't notve:not've
oclock:o'clock oughtnt:oughtn't ow's'at:'ow's'at 'ows'at:'ow's'at
'ow'sat:'ow's'at shant:shan't shed've:she'd've she'dve:she'd've she's:she's
shouldve:should've shouldnt:shouldn't shouldnt've:shouldn't've
shouldn'tve:shouldn't've somebody'd:somebodyd somebodyd've:somebody'd've
somebody'dve:somebody'd've somebodyll:somebody'll somebodys:somebody's
someoned:someone'd someoned've:someone'd've someone'dve:someone'd've
someonell:someone'll someones:someone's somethingd:something'd
somethingd've:something'd've something'dve:something'd've
somethingll:something'll thats:that's thered:there'd thered've:there'd've
there'dve:there'd've therere:there're theres:there's theyd:they'd
theyd've:they'd've they'dve:they'd've theyll:they'll theyre:they're
theyve:they've twas:'twas wasnt:wasn't wed've:we'd've we'dve:we'd've
weve:we've werent:weren't whatll:what'll whatre:what're whats:what's
whatve:what've whens:when's whered:where'd wheres:where's whereve:where've
whod:who'd whod've:who'd've who'dve:who'd've wholl:who'll whos:who's
whove:who've whyll:why'll whyre:why're whys:why's wont:won't
wouldve:would've wouldnt:wouldn't wouldnt've:wouldn't've
wouldn'tve:wouldn't've yall:y'all yall'll:y'all'll y'allll:y'all'll
yall'd've:y'all'd've y'alld've:y'all'd've y'all'dve:y'all'd've youd:you'd
youd've:you'd've you'dve:you'd've youll:you'll youre:you're youve:you've
"""

CONTRACTIONS: Dict[str, str] = dict(
    pair.split(":", 1) for pair in _CONTRACTION_PAIRS.split())

NUMBER_WORDS: Dict[str, str] = {
    w: str(i) for i, w in enumerate(
        ["zero", "one", "two", "three", "four", "five", "six", "seven",
         "eight", "nine", "ten"])
}
NUMBER_WORDS["none"] = "0"

ARTICLES = ("a", "an", "the")
PUNCT: List[str] = list(";/[]\"{}()=+\\_-><@`,?!")

_PERIOD = re.compile(r"(?!<=\d)(\.)(?!\d)")
_DIGIT_COMMA = re.compile(r"(\d)(,)(\d)")


def normalize_word(token: str) -> str:
    """VQA answer normalization (public VQA-eval semantics)."""
    out = token
    for p in PUNCT:
        # drop punctuation adjacent to whitespace or inside digit groups,
        # otherwise replace with a space
        if (p + " " in token) or (" " + p in token) or _DIGIT_COMMA.search(token):
            out = out.replace(p, "")
        else:
            out = out.replace(p, " ")
    out = _PERIOD.sub("", out)

    words = []
    for word in out.lower().split():
        word = NUMBER_WORDS.get(word, word)
        if word not in ARTICLES:
            words.append(word)
    words = [CONTRACTIONS.get(w, w) for w in words]
    return " ".join(words).replace(",", "")


def answer_scores(answers: List[str], label2id: Dict[str, int],
                  num_labels: int):
    """VQAv2 soft scores: each answer contributes min(1, #occurrences/3)
    after normalization; returns a (num_labels,) float vector."""
    import numpy as np

    from collections import Counter

    counts = Counter(normalize_word(a) for a in answers)
    scores = np.zeros((num_labels,), np.float32)
    for ans, c in counts.items():
        if ans in label2id:
            scores[label2id[ans]] = min(1.0, c / 3.0)
    return scores
