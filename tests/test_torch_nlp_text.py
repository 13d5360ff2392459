"""The NLP stack's framework-free text modules in the port
(``deeplearning4j_tpu_torch/nlp``: stopwords, tokenization, documents,
vocab, windows, bow, annotation, treeparser) give exactly the JAX
package's outputs on the same inputs: tokens, the vocabulary and its
Huffman codes and points, the dense code tables, bag-of-words and
tf-idf, annotations and parse trees."""

import numpy as np
import pytest

from deeplearning4j_tpu import nlp as jnlp
from deeplearning4j_tpu.nlp import treeparser as jtree
from deeplearning4j_tpu_torch import nlp as tnlp
from deeplearning4j_tpu_torch.nlp import treeparser as ttree

from tests.test_nlp import synthetic_corpus

TEXT = ("Dr. Smith went home. He was very tired! Was it late? The quick "
        "brown dog quickly chased a red ball in the park, and 42 birds "
        "sang happily. I don't think so; e.g. the docs say otherwise.")


def _vocab(pkg, sentences, min_freq=1):
    tf = pkg.DefaultTokenizerFactory()
    tf.set_token_pre_processor(pkg.CommonPreprocessor())

    def seqs():
        for s in sentences:
            seq = pkg.Sequence()
            for t in tf.create(s).tokens():
                seq.add_element(pkg.VocabWord(label=t))
            seq.set_sequence_label(pkg.VocabWord(label=f"L{len(s) % 3}",
                                                 special=True))
            yield seq

    return pkg.VocabConstructor(min_element_frequency=min_freq).build_vocab(
        seqs())


def _words(cache):
    return [(w.label, w.element_frequency, w.index, w.special, w.codes,
             w.points) for w in cache.vocab_words()]


@pytest.mark.parametrize("pre", [None, "common", "ending"])
def test_tokens_match(pre):
    def toks(pkg, factory):
        if pre == "common":
            factory.set_token_pre_processor(pkg.CommonPreprocessor())
        elif pre == "ending":
            factory.set_token_pre_processor(pkg.EndingPreProcessor())
        return factory.create(TEXT).tokens()

    assert toks(tnlp, tnlp.DefaultTokenizerFactory()) == \
        toks(jnlp, jnlp.DefaultTokenizerFactory())
    assert toks(tnlp, tnlp.NGramTokenizerFactory(1, 3)) == \
        toks(jnlp, jnlp.NGramTokenizerFactory(1, 3))


def test_stop_words_and_windows_match():
    tokens = TEXT.lower().split()
    assert tnlp.get_stop_words() == jnlp.get_stop_words()
    assert tnlp.remove_stop_words(tokens) == jnlp.remove_stop_words(tokens)
    assert [tnlp.is_stop_word(t) for t in tokens] == \
        [jnlp.is_stop_word(t) for t in tokens]
    for size in (1, 4, 5):
        assert [(w.words, w.focus_index) for w in tnlp.windows(tokens, size)] \
            == [(w.words, w.focus_index) for w in jnlp.windows(tokens, size)]


def test_sentence_iterators_match(tmp_path):
    (tmp_path / "a.txt").write_text("line one\nline two\n\nline three\n")
    (tmp_path / "b.txt").write_text("other\n")
    for make in (lambda p: p.BasicLineIterator(str(tmp_path / "a.txt")),
                 lambda p: p.FileSentenceIterator(str(tmp_path)),
                 lambda p: p.AggregatingSentenceIterator(
                     p.CollectionSentenceIterator(["x y"]),
                     p.BasicLineIterator(str(tmp_path / "b.txt")))):
        assert list(make(tnlp)) == list(make(jnlp))
    src_t, src_j = tnlp.LabelsSource(), jnlp.LabelsSource()
    assert [src_t.next_label() for _ in range(3)] == \
        [src_j.next_label() for _ in range(3)]


@pytest.mark.parametrize("min_freq", [1, 3])
def test_vocab_and_huffman_tables_match(min_freq):
    sentences = synthetic_corpus(120) + [TEXT]
    tv, jv = _vocab(tnlp, sentences, min_freq), _vocab(jnlp, sentences,
                                                       min_freq)
    assert tv.total_word_count == jv.total_word_count
    tnlp.build_huffman(tv)
    jnlp.build_huffman(jv)
    assert _words(tv) == _words(jv)
    for a, b in zip(tnlp.codes_matrix(tv), jnlp.codes_matrix(jv)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_bag_of_words_and_tfidf_match():
    docs = synthetic_corpus(30) + [TEXT, "a b a", "b c"]
    for cls in ("BagOfWordsVectorizer", "TfidfVectorizer"):
        t = getattr(tnlp, cls)()
        j = getattr(jnlp, cls)()
        a, b = t.fit_transform(docs), j.fit_transform(docs)
        assert t.vocab_words() == j.vocab_words()
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(t.transform(TEXT), j.transform(TEXT))


def test_annotation_matches():
    assert tnlp.split_sentences(TEXT) == jnlp.split_sentences(TEXT)
    tokens = TEXT.split()
    assert tnlp.pos_tag(tokens) == jnlp.pos_tag(tokens)
    assert tnlp.sentiment_score(tokens) == jnlp.sentiment_score(tokens)
    ours = tnlp.TextAnnotator().annotate(TEXT)
    theirs = jnlp.TextAnnotator().annotate(TEXT)
    assert repr(ours) == repr(theirs)


def test_parse_trees_match():
    def run(mod):
        parser = mod.TreeParser()
        trees = parser.get_trees(TEXT)
        out = [repr(t) for t in trees]
        out += [repr(mod.BinarizeTreeTransformer().transform(t))
                for t in trees]
        out += [repr(mod.CollapseUnaries().transform(t)) for t in trees]
        out += [mod.HeadWordFinder().find_head_word(t) for t in trees]
        labelled = mod.TreeVectorizer().get_trees_with_labels(
            "The movie was great. The food was terrible.")
        out += [(repr(t), t.gold_label) for t in labelled]
        return out

    assert run(ttree) == run(jtree)


def test_chunk_grammar_as_documented():
    """The docstring's VP rule is ``_chunk``'s: a VP opens only at a VERB
    and takes the VERBs and ADVs after it; adverbs before a verb are an
    ADVP of their own (the reference's docstring says ``ADV* VERB+
    ADV*``)."""
    tagged = [("quickly", "ADV"), ("ran", "VERB"), ("away", "ADV"),
              ("very", "ADV"), ("red", "ADJ")]
    labels = [t.label for t in ttree._chunk(tagged)]
    assert labels == [t.label for t in jtree._chunk(tagged)]
    assert labels[:2] == ["ADVP", "VP"]
    grammar = " ".join(ttree.__doc__.split("port's copy")[0].split())
    assert "VP -> VERB (VERB|ADV)*" in grammar
    assert "ADV* VERB+ ADV*" not in grammar
