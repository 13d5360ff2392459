"""Text annotation — the UIMA add-on's capabilities, dependency-free.

Reference: ``deeplearning4j-nlp-uima/`` (UIMA analysis engines wrapping
sentence segmentation, tokenization, POS tagging, and SentiWordNet
sentiment).  UIMA itself is JVM infrastructure, not capability; the
equivalents here are lightweight rule/lexicon annotators with the same
surface: annotate text -> sentences -> tokens with POS + sentiment scores.

The port's copy of ``deeplearning4j_tpu/nlp/annotation.py``: no framework,
so its outputs equal the reference's exactly.
"""

from __future__ import annotations

import dataclasses
import re
import string
from typing import Dict, List, Optional, Tuple

def _norm(token: str) -> str:
    """Lowercase + strip surrounding punctuation (the default tokenizer
    keeps sentence-final punctuation attached)."""
    return token.lower().strip(string.punctuation)

# --------------------------------------------------------------- sentences

# NB deliberately excludes "no": sentence-final "no." (the word) is far more
# common than the numeric abbreviation "No. 5"
_ABBREV = frozenset([
    "mr", "mrs", "ms", "dr", "prof", "sr", "jr", "st", "vs", "etc", "eg",
    "ie", "inc", "ltd", "co", "corp", "vol", "fig", "al",
])

_SENT_BOUNDARY = re.compile(r"([.!?]+)(\s+|$)")


def split_sentences(text: str) -> List[str]:
    """Rule-based sentence segmentation (≙ UIMA SentenceAnnotator):
    terminal punctuation ends a sentence unless it follows a known
    abbreviation or a single initial."""
    sentences: List[str] = []
    start = 0
    for m in _SENT_BOUNDARY.finditer(text):
        prev = text[start:m.start()].rstrip()
        last_word = (prev.split()[-1].lower().replace(".", "")
                     if prev.split() else "")
        if m.group(1).startswith(".") and (
                last_word in _ABBREV or (len(last_word) == 1
                                         and last_word.isalpha())):
            continue  # abbreviation / initial: not a boundary
        chunk = text[start:m.end()].strip()
        if chunk:
            sentences.append(chunk)
        start = m.end()
    tail = text[start:].strip()
    if tail:
        sentences.append(tail)
    return sentences


# --------------------------------------------------------------------- POS

# Closed-class lexicon + suffix rules: the capability analog of the UIMA/
# OpenNLP tagger for the pipelines the reference builds (token filtering,
# lemmatization hooks) — not a treebank-trained model.
_LEXICON: Dict[str, str] = {}
for _w in ("the a an this that these those my your his her its our their".split()):
    _LEXICON[_w] = "DET"
for _w in ("i you he she it we they me him us them who".split()):
    _LEXICON[_w] = "PRON"
for _w in ("in on at by for with from to of about over under into".split()):
    _LEXICON[_w] = "ADP"
for _w in ("and or but nor so yet".split()):
    _LEXICON[_w] = "CONJ"
for _w in ("is am are was were be been being have has had do does did "
           "will would can could shall should may might must".split()):
    _LEXICON[_w] = "VERB"
# common irregular past/base forms the suffix rules can't catch — only
# forms that are UNAMBIGUOUSLY verbal (homographs like left/saw/found/
# read/made/felt would mis-tag noun/adjective uses and fragment NPs)
for _w in ("ran run sat went goes take got came come said say told tell "
           "gave give knew know thought think kept held heard met brought "
           "began wrote".split()):
    _LEXICON[_w] = "VERB"
for _w in ("not never also very too quite really".split()):
    _LEXICON[_w] = "ADV"

_SUFFIX_RULES: List[Tuple[str, str]] = [
    ("ing", "VERB"), ("ed", "VERB"), ("ly", "ADV"),
    ("ous", "ADJ"), ("ful", "ADJ"), ("ive", "ADJ"), ("able", "ADJ"),
    ("ible", "ADJ"), ("al", "ADJ"), ("ness", "NOUN"), ("ment", "NOUN"),
    ("tion", "NOUN"), ("sion", "NOUN"), ("ity", "NOUN"), ("er", "NOUN"),
    ("ist", "NOUN"), ("ism", "NOUN"), ("s", "NOUN"),
]


def pos_tag(tokens: List[str]) -> List[Tuple[str, str]]:
    """(token, tag) pairs over the universal-ish tagset
    DET/PRON/ADP/CONJ/VERB/ADV/ADJ/NOUN/NUM/PUNCT."""
    out = []
    for tok in tokens:
        low = _norm(tok)
        if not any(c.isalnum() for c in tok):
            tag = "PUNCT"
        elif low.replace(".", "").replace(",", "").isdigit():
            tag = "NUM"
        elif low in _LEXICON:
            tag = _LEXICON[low]
        else:
            tag = "NOUN"
            for suffix, t in _SUFFIX_RULES:
                if len(low) > len(suffix) + 2 and low.endswith(suffix):
                    tag = t
                    break
        out.append((tok, tag))
    return out


# --------------------------------------------------------------- sentiment

# Compact polarity lexicon (SentiWordNet-style scores in [-1, 1]).
_SENTIMENT: Dict[str, float] = {
    "good": 0.7, "great": 0.8, "excellent": 0.9, "best": 0.9, "love": 0.8,
    "loved": 0.8, "wonderful": 0.8, "amazing": 0.8, "happy": 0.7,
    "fantastic": 0.8, "nice": 0.5, "perfect": 0.9, "better": 0.4,
    "awesome": 0.8, "enjoy": 0.6, "enjoyed": 0.6, "like": 0.4,
    "bad": -0.7, "terrible": -0.9, "awful": -0.9, "worst": -0.9,
    "hate": -0.8, "hated": -0.8, "horrible": -0.8, "sad": -0.6,
    "poor": -0.5, "disappointing": -0.7, "disappointed": -0.7,
    "worse": -0.5, "boring": -0.6, "annoying": -0.6, "broken": -0.5,
    "fail": -0.6, "failed": -0.6, "wrong": -0.4, "problem": -0.3,
}
_NEGATORS = frozenset(["not", "no", "never", "n't", "dont", "don't",
                       "didnt", "didn't", "isnt", "isn't", "wasnt",
                       "wasn't", "cant", "can't"])


def sentiment_score(tokens: List[str]) -> float:
    """Mean polarity over matched tokens, sign-flipped within 2 tokens of a
    negator (≙ the UIMA SentiWordNet annotator's aggregate use)."""
    scores = []
    for i, tok in enumerate(tokens):
        s = _SENTIMENT.get(_norm(tok))
        if s is None:
            continue
        window = [_norm(t) for t in tokens[max(0, i - 2):i]]
        if any(w in _NEGATORS for w in window):
            s = -s
        scores.append(s)
    return float(sum(scores) / len(scores)) if scores else 0.0


# --------------------------------------------------------------- annotator

@dataclasses.dataclass
class AnnotatedToken:
    text: str
    pos: str


@dataclasses.dataclass
class AnnotatedSentence:
    text: str
    tokens: List[AnnotatedToken]
    sentiment: float


class TextAnnotator:
    """Pipeline facade: text -> annotated sentences.  ≙ the UIMA analysis
    engine chain (sentence -> tokenize -> POS -> sentiment)."""

    def __init__(self, tokenizer_factory=None):
        if tokenizer_factory is None:
            from deeplearning4j_tpu_torch.nlp.tokenization import (
                DefaultTokenizerFactory,
            )
            tokenizer_factory = DefaultTokenizerFactory()
        self.tokenizer_factory = tokenizer_factory

    def annotate(self, text: str) -> List[AnnotatedSentence]:
        out = []
        for sent in split_sentences(text):
            tokens = self.tokenizer_factory.create(sent).tokens()
            tagged = pos_tag(tokens)
            out.append(AnnotatedSentence(
                text=sent,
                tokens=[AnnotatedToken(t, p) for t, p in tagged],
                sentiment=sentiment_score(tokens),
            ))
        return out
