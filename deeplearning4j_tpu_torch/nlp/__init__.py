"""NLP embeddings stack (≙ deeplearning4j-nlp-parent) — counterpart of
``deeplearning4j_tpu/nlp``, with the same exports.

Batched gather / product / ``index_add_`` steps over embedding matrices
on the device (``nlp/learning.py``; on the card a captured CUDA graph a
batch shape), one generic SequenceVectors engine, and the Word2Vec /
ParagraphVectors / GloVe facades on top.  Entry points place their
matrices on ``cuda`` unless the caller passes ``device="cpu"``.
"""

from deeplearning4j_tpu_torch.nlp.bow import BagOfWordsVectorizer, TfidfVectorizer
from deeplearning4j_tpu_torch.nlp.documents import (
    AggregatingSentenceIterator,
    BasicLineIterator,
    CollectionSentenceIterator,
    FileSentenceIterator,
    LabelAwareIterator,
    LabelledDocument,
    LabelsSource,
    SentenceIterator,
    SimpleLabelAwareIterator,
)
from deeplearning4j_tpu_torch.nlp.glove import CoOccurrences, Glove
from deeplearning4j_tpu_torch.nlp.lookup import InMemoryLookupTable
from deeplearning4j_tpu_torch.nlp.paragraphvectors import ParagraphVectors
from deeplearning4j_tpu_torch.nlp.sequencevectors import (
    SequenceVectors,
    VectorsConfiguration,
)
from deeplearning4j_tpu_torch.nlp.tokenization import (
    STOP_WORDS,
    CommonPreprocessor,
    DefaultTokenizerFactory,
    EndingPreProcessor,
    NGramTokenizerFactory,
    TokenizerFactory,
)
from deeplearning4j_tpu_torch.nlp.vocab import (
    Sequence,
    SequenceElement,
    VocabCache,
    VocabConstructor,
    VocabWord,
    build_huffman,
    codes_matrix,
)
from deeplearning4j_tpu_torch.nlp.word2vec import StaticWord2Vec, Word2Vec
from deeplearning4j_tpu_torch.nlp.wordvectors import WordVectors
from deeplearning4j_tpu_torch.nlp import serializer as WordVectorSerializer
from deeplearning4j_tpu_torch.nlp.stopwords import (
    StopWordsRemover, get_stop_words, is_stop_word, remove_stop_words,
)
from deeplearning4j_tpu_torch.nlp.annotation import (
    TextAnnotator, pos_tag, sentiment_score, split_sentences,
)
from deeplearning4j_tpu_torch.nlp.treeparser import (
    BinarizeTreeTransformer, CollapseUnaries, HeadWordFinder, Tree,
    TreeParser, TreeVectorizer,
)
from deeplearning4j_tpu_torch.nlp.windows import Window, windows

__all__ = [
    "BagOfWordsVectorizer", "TfidfVectorizer", "AggregatingSentenceIterator",
    "BasicLineIterator", "CollectionSentenceIterator", "FileSentenceIterator",
    "LabelAwareIterator", "LabelledDocument", "LabelsSource",
    "SentenceIterator", "SimpleLabelAwareIterator", "CoOccurrences", "Glove",
    "InMemoryLookupTable", "ParagraphVectors", "SequenceVectors",
    "VectorsConfiguration", "STOP_WORDS", "CommonPreprocessor",
    "DefaultTokenizerFactory", "EndingPreProcessor", "NGramTokenizerFactory",
    "TokenizerFactory", "Sequence", "SequenceElement", "VocabCache",
    "VocabConstructor", "VocabWord", "build_huffman", "codes_matrix",
    "StaticWord2Vec", "Word2Vec", "WordVectors", "WordVectorSerializer",
    "StopWordsRemover", "get_stop_words", "is_stop_word",
    "remove_stop_words", "TextAnnotator", "pos_tag", "sentiment_score",
    "split_sentences", "BinarizeTreeTransformer", "CollapseUnaries",
    "HeadWordFinder", "Tree", "TreeParser", "TreeVectorizer",
    "Window", "windows",
]
