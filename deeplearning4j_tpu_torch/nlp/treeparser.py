"""Constituency tree parsing + tree vectorization (the UIMA add-on's last
capability analog).

Reference: ``deeplearning4j-nlp-uima/.../treeparser/`` —
``TreeParser.java:60`` (text -> sentence segmentation -> parse trees via
the OpenNLP chunker engines), ``TreeVectorizer.java`` (parse, binarize,
collapse unaries, attach labels for RNTN training),
``HeadWordFinder.java`` (Collins-style head tables),
``BinarizeTreeTransformer.java`` (left-factored binarization, Manning
et al.), ``CollapseUnaries.java``, and the recursive-autoencoder ``Tree``
(``deeplearning4j-nn/.../recursive/Tree.java:32`` — label, children,
tokens, goldLabel, vector).

The reference's parser is a statistical model shipped as an OpenNLP binary
(JVM infrastructure, not capability); the analog is a deterministic
rule-based shallow constituency chunker over ``annotation.pos_tag``'s
universal-ish tagset, producing the same Tree structure, the same
transform pipeline, and the same vectorized output the RNTN-style
consumers need.  Phrase grammar (greedy, left to right, longest match
first), as ``_chunk`` implements it:

    PP   -> ADP NP              (a bare ADP is X)
    NP   -> DET? ADJ* (NOUN|PRON|NUM)+
    VP   -> VERB (VERB|ADV)*    (opened only at a VERB: adverbs before it
                                 form an ADVP or ADJP of their own)
    ADJP -> ADV* ADJ+           (when not absorbed by an NP)
    ADVP -> ADV+                (not followed by an ADJ)
    S    -> (NP|VP|PP|ADJP|ADVP|X|PUNCT)+

The port's copy of ``deeplearning4j_tpu/nlp/treeparser.py``: no framework,
so its outputs equal the reference's exactly.  Its docstring states the
VP rule ``_chunk`` follows; the reference's states ``ADV* VERB+ ADV*``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Sequence

import numpy as np

from deeplearning4j_tpu_torch.nlp.annotation import (
    pos_tag, sentiment_score, split_sentences,
)

PHRASE_LABELS = ("NP", "VP", "PP", "ADJP", "ADVP", "X", "PUNCT")


@dataclasses.dataclass
class Tree:
    """≙ ``recursive/Tree.java:32``: label + children + covered tokens,
    with the RNTN-side fields (``vector``, ``gold_label``, ``value``)."""
    label: str
    children: List["Tree"] = dataclasses.field(default_factory=list)
    token: Optional[str] = None          # set on leaves only
    vector: Optional[np.ndarray] = None  # set by TreeVectorizer on leaves
    gold_label: Optional[str] = None
    value: float = 0.0                   # prediction slot (RNTN)

    def is_leaf(self) -> bool:
        return not self.children

    def is_preterminal(self) -> bool:
        return len(self.children) == 1 and self.children[0].is_leaf()

    def tokens(self) -> List[str]:
        if self.is_leaf():
            return [self.token] if self.token is not None else []
        out: List[str] = []
        for c in self.children:
            out.extend(c.tokens())
        return out

    def leaves(self) -> List["Tree"]:
        if self.is_leaf():
            return [self]
        out: List[Tree] = []
        for c in self.children:
            out.extend(c.leaves())
        return out

    def depth(self) -> int:
        if self.is_leaf():
            return 0
        return 1 + max(c.depth() for c in self.children)

    def set_gold_label_recursive(self, label: str) -> None:
        self.gold_label = label
        for c in self.children:
            c.set_gold_label_recursive(label)

    def __repr__(self) -> str:  # Penn-style bracketing, e.g. (NP (DET the))
        if self.is_leaf():
            return self.token or ""
        inner = " ".join(repr(c) for c in self.children)
        return f"({self.label} {inner})"


# ------------------------------------------------------------------ parser

def _chunk(tagged: Sequence) -> List[Tree]:
    """Greedy shallow parse of (token, tag) pairs into phrase subtrees."""
    def pre(i) -> Tree:  # preterminal: (TAG token)
        tok, tag = tagged[i]
        return Tree(tag, [Tree(tok, token=tok)])

    n = len(tagged)
    out: List[Tree] = []
    i = 0

    def tag(i):
        return tagged[i][1]

    def parse_np(i):
        """DET? ADJ* (NOUN|PRON|NUM)+ starting at i, or None."""
        j = i
        kids: List[Tree] = []
        if j < n and tag(j) == "DET":
            kids.append(pre(j))
            j += 1
        while j < n and tag(j) == "ADJ":
            kids.append(pre(j))
            j += 1
        heads = 0
        while j < n and tag(j) in ("NOUN", "PRON", "NUM"):
            kids.append(pre(j))
            j += 1
            heads += 1
        if heads == 0:
            return None, i
        return Tree("NP", kids), j

    while i < n:
        t = tag(i)
        if t == "ADP":  # PP -> ADP NP (falls back to bare ADP as X)
            np_tree, j = parse_np(i + 1)
            if np_tree is not None:
                out.append(Tree("PP", [pre(i), np_tree]))
                i = j
                continue
            out.append(Tree("X", [pre(i)]))
            i += 1
            continue
        np_tree, j = parse_np(i)
        if np_tree is not None:
            out.append(np_tree)
            i = j
            continue
        if t == "VERB":  # VP -> VERB+ ADV*
            kids = [pre(i)]
            i += 1
            while i < n and tag(i) in ("VERB", "ADV"):
                kids.append(pre(i))
                i += 1
            out.append(Tree("VP", kids))
            continue
        if t == "ADV":  # ADV* ADJ+ -> ADJP; ADV+ alone -> ADVP
            kids = [pre(i)]
            i += 1
            while i < n and tag(i) == "ADV":
                kids.append(pre(i))
                i += 1
            if i < n and tag(i) == "ADJ":
                while i < n and tag(i) == "ADJ":
                    kids.append(pre(i))
                    i += 1
                out.append(Tree("ADJP", kids))
            else:
                out.append(Tree("ADVP", kids))
            continue
        if t == "ADJ":
            kids = [pre(i)]
            i += 1
            while i < n and tag(i) == "ADJ":
                kids.append(pre(i))
                i += 1
            out.append(Tree("ADJP", kids))
            continue
        out.append(Tree("PUNCT" if t == "PUNCT" else "X", [pre(i)]))
        i += 1
    return out


class TreeParser:
    """Text -> one constituency ``Tree`` per sentence (≙
    ``TreeParser.getTrees(String)``: segment, tokenize, parse)."""

    def __init__(self, tokenizer_factory=None):
        if tokenizer_factory is None:
            from deeplearning4j_tpu_torch.nlp.tokenization import (
                DefaultTokenizerFactory,
            )
            tokenizer_factory = DefaultTokenizerFactory()
        self.tokenizer_factory = tokenizer_factory

    def get_trees(self, text: str,
                  pre_processor: Optional[Callable[[str], str]] = None
                  ) -> List[Tree]:
        if not text:
            return []
        if pre_processor is not None:
            text = pre_processor(text)
        trees = []
        for sent in split_sentences(text):
            tokens = self.tokenizer_factory.create(sent).tokens()
            if not tokens:
                continue
            trees.append(Tree("S", _chunk(pos_tag(tokens))))
        return trees

    def get_trees_with_labels(self, text: str, labels: List[str]
                              ) -> List[Tree]:
        """≙ ``TreeParser.getTreesWithLabels``: one gold label per
        sentence, propagated to every node (RNTN training target)."""
        trees = self.get_trees(text)
        if len(labels) not in (1, len(trees)):
            raise ValueError(
                f"{len(labels)} labels for {len(trees)} sentences")
        for tree, label in zip(
                trees, labels * len(trees) if len(labels) == 1 else labels):
            tree.set_gold_label_recursive(label)
        return trees


# --------------------------------------------------------------- head words

class HeadWordFinder:
    """Collins-style head tables over the universal-ish tagset (≙
    ``HeadWordFinder.java``'s head1/head2 Penn tables): per phrase label,
    an ordered preference list and a search direction."""

    _RULES = {
        # label: (direction, [preferred child labels, most-preferred first])
        "NP": ("right", ["NOUN", "PRON", "NUM", "NP", "ADJ"]),
        "VP": ("left", ["VERB", "VP"]),
        "PP": ("left", ["ADP", "NP"]),
        "ADJP": ("right", ["ADJ", "ADV"]),
        "ADVP": ("right", ["ADV"]),
        "S": ("left", ["VP", "NP", "S"]),
    }

    def find_head(self, tree: Tree) -> Optional[Tree]:
        """The head PRETERMINAL of the subtree (None for empty/leaf)."""
        if tree.is_leaf():
            return None
        if tree.is_preterminal():
            return tree
        direction, prefs = self._RULES.get(
            tree.label.lstrip("@"), ("left", []))
        kids = (tree.children if direction == "left"
                else list(reversed(tree.children)))
        for want in prefs:
            for child in kids:
                if child.label.lstrip("@") == want:
                    return self.find_head(child)
        return self.find_head(kids[0])

    def find_head_word(self, tree: Tree) -> Optional[str]:
        head = self.find_head(tree)
        if head is None:
            return None
        toks = head.tokens()
        return toks[0] if toks else None


# --------------------------------------------------------------- transforms

class BinarizeTreeTransformer:
    """Left-factored binarization (≙ ``BinarizeTreeTransformer.java``,
    after Manning et al.): a node with > 2 children becomes a left-leaning
    chain of intermediate ``@Label`` nodes."""

    def transform(self, tree: Optional[Tree]) -> Optional[Tree]:
        if tree is None or tree.is_leaf():
            return tree
        kids = [self.transform(c) for c in tree.children]
        while len(kids) > 2:
            left = Tree(f"@{tree.label}", kids[:2],
                        gold_label=tree.gold_label)
            kids = [left] + kids[2:]
        return dataclasses.replace(tree, children=kids)


class CollapseUnaries:
    """Collapse unary chains X -> Y -> ... (≙ ``CollapseUnaries.java``),
    keeping the TOP label and never collapsing preterminals (the POS level
    stays, exactly like the reference's CNF step)."""

    def transform(self, tree: Optional[Tree]) -> Optional[Tree]:
        if tree is None or tree.is_leaf() or tree.is_preterminal():
            return tree
        node = tree
        while (len(node.children) == 1
               and not node.children[0].is_leaf()
               and not node.children[0].is_preterminal()):
            node = node.children[0]
        kids = [self.transform(c) for c in node.children]
        return dataclasses.replace(tree, children=kids)


# --------------------------------------------------------------- vectorizer

class TreeVectorizer:
    """Parse -> binarize -> collapse unaries (-> attach word vectors):
    ≙ ``TreeVectorizer.java`` ('vectorization of strings appropriate for
    an RNTN')."""

    def __init__(self, parser: Optional[TreeParser] = None,
                 tree_transformer=None, cnf_transformer=None):
        self.parser = parser or TreeParser()
        self.tree_transformer = tree_transformer or BinarizeTreeTransformer()
        self.cnf_transformer = cnf_transformer or CollapseUnaries()

    def get_trees(self, sentences: str) -> List[Tree]:
        out = []
        for t in self.parser.get_trees(sentences):
            out.append(self.cnf_transformer.transform(
                self.tree_transformer.transform(t)))
        return out

    def get_trees_with_labels(self, sentences: str,
                              labels: Optional[List[str]] = None
                              ) -> List[Tree]:
        """With explicit ``labels`` (one, or one per sentence) they are
        propagated like the reference's goldLabel; without, each sentence
        gets its lexicon sentiment sign (the reference's SentiWordNet-fed
        default corpus usage)."""
        if labels is not None:
            base = self.parser.get_trees_with_labels(sentences, labels)
        else:
            base = self.parser.get_trees(sentences)
            for t in base:
                s = sentiment_score(t.tokens())
                t.set_gold_label_recursive(
                    "positive" if s > 0 else "negative" if s < 0
                    else "neutral")
        return [self.cnf_transformer.transform(
            self.tree_transformer.transform(t)) for t in base]

    def vectorize(self, sentences: str, word_vectors,
                  labels: Optional[List[str]] = None) -> List[Tree]:
        """Attach ``word_vectors`` lookups (``WordVectors`` /
        ``SequenceVectors`` facade) at the leaves; OOV words get zeros,
        like the reference lookup table's default row."""
        trees = self.get_trees_with_labels(sentences, labels)
        dim = None
        for tree in trees:
            for leaf in tree.leaves():
                v = (word_vectors.get_word_vector(leaf.token.lower())
                     if leaf.token else None)
                if v is not None:
                    v = np.asarray(v, np.float32)
                    dim = len(v)
                leaf.vector = v
        if dim is not None:  # second pass: zeros for OOV, consistent dim
            for tree in trees:
                for leaf in tree.leaves():
                    if leaf.vector is None:
                        leaf.vector = np.zeros(dim, np.float32)
        return trees
