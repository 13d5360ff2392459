"""Tokenizers + token preprocessing.

Reference: ``deeplearning4j-nlp/.../text/tokenization/`` — DefaultTokenizer
(whitespace/punct split via java.util.StringTokenizer semantics),
NGramTokenizer, ``CommonPreprocessor`` (lowercase + strip punctuation),
``EndingPreProcessor``, stopwords list (``text/stopwords``).

The port's copy of ``deeplearning4j_tpu/nlp/tokenization.py``: no framework,
so its outputs equal the reference's exactly.
"""

from __future__ import annotations

import re
from typing import Callable, List, Optional

# Compact english stopword list (reference ships one as a resource file;
# text/stopwords — same role, trimmed to the common core).
# single authoritative stoplist (see nlp/stopwords.py, ≙ StopWords.java)
from deeplearning4j_tpu_torch.nlp.stopwords import ENGLISH as STOP_WORDS


class TokenPreProcess:
    """≙ ``tokenization/tokenizer/TokenPreProcess.java``."""

    def pre_process(self, token: str) -> str:
        raise NotImplementedError


class CommonPreprocessor(TokenPreProcess):
    """Lowercase + strip punctuation/digits at token edges.
    ≙ ``preprocessor/CommonPreprocessor.java``."""

    _PUNCT = re.compile(r"[\d\.:,\"'\(\)\[\]|/?!;]+")

    def pre_process(self, token: str) -> str:
        return self._PUNCT.sub("", token.lower())


class EndingPreProcessor(TokenPreProcess):
    """Crude stemmer: strips common english endings.
    ≙ ``preprocessor/EndingPreProcessor.java``."""

    def pre_process(self, token: str) -> str:
        if token.endswith("s") and not token.endswith("ss"):
            token = token[:-1]
        for suffix in ("ed", "ing", "ly"):
            if token.endswith(suffix):
                token = token[: -len(suffix)]
                break
        return token


class Tokenizer:
    """≙ ``tokenization/tokenizer/Tokenizer.java`` — iterator surface kept
    pythonic: ``tokens()`` returns the full list."""

    def __init__(self, tokens: List[str], pre: Optional[TokenPreProcess] = None):
        self._tokens = tokens
        self._pre = pre

    def set_token_pre_processor(self, pre: TokenPreProcess) -> None:
        self._pre = pre

    def count_tokens(self) -> int:
        return len(self.tokens())

    def tokens(self) -> List[str]:
        out = []
        for t in self._tokens:
            if self._pre is not None:
                t = self._pre.pre_process(t)
            if t:
                out.append(t)
        return out


class TokenizerFactory:
    """≙ ``tokenizerfactory/TokenizerFactory.java``."""

    def create(self, text: str) -> Tokenizer:
        raise NotImplementedError

    def set_token_pre_processor(self, pre: TokenPreProcess) -> None:
        self._pre = pre


class DefaultTokenizerFactory(TokenizerFactory):
    """Whitespace tokenizer. ≙ ``DefaultTokenizerFactory.java``."""

    def __init__(self):
        self._pre: Optional[TokenPreProcess] = None

    def create(self, text: str) -> Tokenizer:
        return Tokenizer(text.split(), self._pre)


class NGramTokenizerFactory(TokenizerFactory):
    """Word n-grams over the base tokenization.
    ≙ ``NGramTokenizerFactory.java``."""

    def __init__(self, min_n: int, max_n: int,
                 base: Optional[TokenizerFactory] = None):
        self.min_n = min_n
        self.max_n = max_n
        self.base = base or DefaultTokenizerFactory()
        self._pre: Optional[TokenPreProcess] = None

    def create(self, text: str) -> Tokenizer:
        base_tokens = self.base.create(text).tokens()
        out = []
        for n in range(self.min_n, self.max_n + 1):
            for i in range(len(base_tokens) - n + 1):
                out.append(" ".join(base_tokens[i:i + n]))
        return Tokenizer(out, self._pre)
