"""GloVe: co-occurrence counting + weighted-least-squares embedding fit —
counterpart of ``deeplearning4j_tpu/nlp/glove.py``.

Reference: ``models/glove/Glove.java``, ``models/glove/AbstractCoOccurrences
.java`` (streaming window-weighted co-occurrence counts spilled through
binary round/shadow buffers; 1/d weighting),
``models/embeddings/learning/impl/elements/GloVe.java`` (per-pair AdaGrad
update, xMax=100, alpha=0.75).

As in the reference package, counting accumulates in a host dict up to a pair budget, then
spills sorted (key=row*V+col, weight) runs to disk;
``SpillingCoOccurrences`` external-merges the runs (heap merge, duplicates
summed) and streams chunks — so the co-occurrence table is never required
to fit in RAM, the capability the reference's shadow-copy buffers provide.
The counting is the reference's host code unchanged (the same pairs
in the same order, so one ``RandomState`` gives both packages the same
batches).  The optimisation loop ships shuffled (row, col, Xij) batches
to ``learning.glove_step``, AdaGrad scatter updates on the device: on
the card one captured CUDA graph for the batch shape, replayed with the
batch staged from pinned memory; the loss is summed on the device and
read when ``cum_loss`` is asked for.
"""

from __future__ import annotations

import heapq
import os
import tempfile
from collections import defaultdict
from typing import Dict, Iterable, Iterator, Optional, Tuple

import numpy as np
import torch

from deeplearning4j_tpu_torch.backend.device import resolve_device
from deeplearning4j_tpu_torch.models import capture
from deeplearning4j_tpu_torch.nlp import learning
from deeplearning4j_tpu_torch.nlp.documents import CollectionSentenceIterator, SentenceIterator
from deeplearning4j_tpu_torch.nlp.lookup import InMemoryLookupTable
from deeplearning4j_tpu_torch.nlp.tokenization import DefaultTokenizerFactory, TokenizerFactory
from deeplearning4j_tpu_torch.nlp.vocab import (
    Sequence,
    VocabCache,
    VocabConstructor,
    VocabWord,
)
from deeplearning4j_tpu_torch.nlp.wordvectors import WordVectors


class CoOccurrences:
    """Symmetric window-weighted co-occurrence counts (weight 1/distance).
    ≙ ``AbstractCoOccurrences.java``."""

    def __init__(self, vocab: VocabCache, window: int = 15,
                 symmetric: bool = True):
        self.vocab = vocab
        self.window = window
        self.symmetric = symmetric
        self.counts: Dict[Tuple[int, int], float] = defaultdict(float)

    def _count_sentence(self, tokens: list) -> None:
        idx = [self.vocab.index_of(t) for t in tokens]
        idx = [i for i in idx if i >= 0]
        n = len(idx)
        for i in range(n):
            for d in range(1, self.window + 1):
                j = i + d
                if j >= n:
                    break
                w = 1.0 / d
                self.counts[(idx[i], idx[j])] += w
                if self.symmetric:
                    self.counts[(idx[j], idx[i])] += w

    def _after_sentence(self) -> None:
        """Hook: SpillingCoOccurrences flushes here when over budget."""

    def fit_sentences(self, token_lists: Iterable[list]) -> "CoOccurrences":
        for tokens in token_lists:
            self._count_sentence(tokens)
            self._after_sentence()
        return self

    def as_arrays(self):
        if not self.counts:
            return (np.empty(0, np.int32), np.empty(0, np.int32),
                    np.empty(0, np.float32))
        items = list(self.counts.items())
        rows = np.array([k[0] for k, _ in items], np.int32)
        cols = np.array([k[1] for k, _ in items], np.int32)
        vals = np.array([v for _, v in items], np.float32)
        return rows, cols, vals


class SpillingCoOccurrences(CoOccurrences):
    """Out-of-core co-occurrence counting (≙ ``AbstractCoOccurrences.java``'s
    binary spill files with shadow-copy round buffers, re-derived as sorted
    spill runs + external heap merge).

    Counts accumulate in the in-RAM dict until ``memory_pairs`` distinct
    pairs, then the dict is flushed as a sorted (uint64 key = row*V+col,
    float32 weight) run file.  ``stream_chunks`` heap-merges all runs plus
    the live dict, summing duplicate keys, and yields (rows, cols, vals)
    chunks — the full table never needs to fit in memory.
    """

    def __init__(self, vocab: VocabCache, window: int = 15,
                 symmetric: bool = True, memory_pairs: int = 2_000_000,
                 tmp_dir: Optional[str] = None):
        super().__init__(vocab, window, symmetric)
        self.memory_pairs = max(1, memory_pairs)
        self._owns_tmp = tmp_dir is None
        self._tmp_dir = tmp_dir or tempfile.mkdtemp(prefix="glove_cooc_")
        self._spills = []          # file paths of sorted runs
        self.n_spills = 0

    def _flush(self):
        if not self.counts:
            return
        V = len(self.vocab)
        keys = np.fromiter(
            (r * V + c for (r, c) in self.counts), np.uint64,
            count=len(self.counts))
        vals = np.fromiter(self.counts.values(), np.float32,
                           count=len(self.counts))
        order = np.argsort(keys, kind="stable")
        base = os.path.join(self._tmp_dir, f"run{self.n_spills:05d}")
        # raw .npy so merge can mmap and read block-wise (npz would force a
        # whole-run load, defeating the out-of-core point)
        np.save(base + ".keys.npy", keys[order])
        np.save(base + ".vals.npy", vals[order])
        self._spills.append(base)
        self.n_spills += 1
        self.counts.clear()

    def _after_sentence(self) -> None:
        if len(self.counts) >= self.memory_pairs:
            self._flush()

    @staticmethod
    def _iter_run(base: str, block: int = 1 << 16):
        """Stream one sorted run from disk in bounded blocks (mmap-backed;
        RAM is O(block), never O(run))."""
        keys = np.load(base + ".keys.npy", mmap_mode="r")
        vals = np.load(base + ".vals.npy", mmap_mode="r")
        for i in range(0, len(keys), block):
            yield from zip(keys[i:i + block].tolist(),
                           vals[i:i + block].tolist())

    def _run_streams(self) -> list:
        streams = [self._iter_run(base) for base in self._spills]
        if self.counts:
            V = len(self.vocab)
            items = sorted((r * V + c, v) for (r, c), v in self.counts.items())
            streams.append(iter(items))
        return streams

    def stream_chunks(self, chunk_size: int = 1 << 20
                      ) -> Iterator[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
        """Merged unique (rows, cols, vals) in key order, in bounded chunks."""
        V = len(self.vocab)
        merged = heapq.merge(*self._run_streams())
        keys, vals = [], []
        cur_key, cur_val = None, 0.0
        for k, v in merged:
            if k == cur_key:
                cur_val += v
                continue
            if cur_key is not None:
                keys.append(cur_key)
                vals.append(cur_val)
                if len(keys) >= chunk_size:
                    ka = np.asarray(keys, np.uint64)
                    yield ((ka // V).astype(np.int32),
                           (ka % V).astype(np.int32),
                           np.asarray(vals, np.float32))
                    keys, vals = [], []
            cur_key, cur_val = k, v
        if cur_key is not None:
            keys.append(cur_key)
            vals.append(cur_val)
        if keys:
            ka = np.asarray(keys, np.uint64)
            yield ((ka // V).astype(np.int32), (ka % V).astype(np.int32),
                   np.asarray(vals, np.float32))

    def as_arrays(self):
        """Materialise the merged table (compat path; spills permitting)."""
        parts = list(self.stream_chunks())
        if not parts:
            return (np.empty(0, np.int32), np.empty(0, np.int32),
                    np.empty(0, np.float32))
        return (np.concatenate([p[0] for p in parts]),
                np.concatenate([p[1] for p in parts]),
                np.concatenate([p[2] for p in parts]))

    def close(self):
        for base in self._spills:
            for suffix in (".keys.npy", ".vals.npy"):
                try:
                    os.unlink(base + suffix)
                except OSError:
                    pass
        self._spills = []
        if self._owns_tmp:
            try:
                os.rmdir(self._tmp_dir)
            except OSError:
                pass  # non-empty (foreign files) or already gone
            self._owns_tmp = False


class Glove(WordVectors):
    def __init__(self, config=None, sentence_iterator: SentenceIterator = None,
                 tokenizer_factory: TokenizerFactory = None,
                 layer_size: int = 100, window: int = 15, epochs: int = 5,
                 learning_rate: float = 0.05, x_max: float = 100.0,
                 alpha: float = 0.75, min_word_frequency: int = 1,
                 batch_size: int = 1024, seed: int = 12345,
                 symmetric: bool = True, memory_pairs: Optional[int] = None,
                 device=None):
        self.sentence_iterator = sentence_iterator
        self.tokenizer_factory = tokenizer_factory or DefaultTokenizerFactory()
        self.layer_size = layer_size
        self.window = window
        self.epochs = epochs
        self.learning_rate = learning_rate
        self.x_max = x_max
        self.alpha = alpha
        self.min_word_frequency = min_word_frequency
        self.batch_size = batch_size
        self.seed = seed
        self.symmetric = symmetric
        self.memory_pairs = memory_pairs  # spill budget; None = in-RAM
        self.vocab: Optional[VocabCache] = None
        self.lookup: Optional[InMemoryLookupTable] = None
        self.device = resolve_device(device)
        self._loss_sum = torch.zeros((), dtype=torch.float64,
                                     device=self.device)
        self._programs: Optional[learning.StepPrograms] = None

    @property
    def cum_loss(self) -> float:
        """The summed batch losses of every fit so far (a read from the
        device)."""
        return float(self._loss_sum)

    @property
    def programs(self) -> Optional[learning.StepPrograms]:
        """The last fit's step program (captures and replays)."""
        return self._programs

    def _token_lists(self):
        self.sentence_iterator.reset()
        while self.sentence_iterator.has_next():
            s = self.sentence_iterator.next_sentence()
            if s:
                toks = self.tokenizer_factory.create(s).tokens()
                if toks:
                    yield toks

    # seam for the distributed variant (DistributedGlove shards this)
    _glove_step = staticmethod(learning.glove_step)

    def _body(self, rows, cols, xij, mask, key, scalars):
        loss = self._glove_step(*self._state, rows, cols, xij, mask,
                                scalars["lr"], scalars["x_max"],
                                scalars["alpha"])
        self._loss_sum.add_(loss)
        return loss

    def _train_pairs(self, rows, cols, vals, rs):
        """One pass over a (rows, cols, vals) block in shuffled fixed-size
        batches through the AdaGrad step."""
        n = len(rows)
        B = self.batch_size
        perm = rs.permutation(n)
        scalars = [("lr", self.learning_rate), ("x_max", self.x_max),
                   ("alpha", self.alpha)]
        for i0 in range(0, n, B):
            sel = perm[i0:i0 + B]
            pad = B - len(sel)
            mask = np.concatenate([np.ones(len(sel), np.float32),
                                   np.zeros(pad, np.float32)])
            r = np.concatenate([rows[sel], np.zeros(pad, np.int32)])
            c = np.concatenate([cols[sel], np.zeros(pad, np.int32)])
            x = np.concatenate([vals[sel], np.ones(pad, np.float32)])
            self._programs.call("glove", self._body,
                                {"rows": r, "cols": c, "xij": x,
                                 "mask": mask}, None, scalars)

    def fit(self) -> "Glove":
        # vocab
        def seqs():
            for toks in self._token_lists():
                seq = Sequence()
                for t in toks:
                    seq.add_element(VocabWord(label=t))
                yield seq

        self.vocab = VocabConstructor(
            min_element_frequency=self.min_word_frequency).build_vocab(seqs())
        V, D = len(self.vocab), self.layer_size
        if self.memory_pairs:
            cooc = SpillingCoOccurrences(self.vocab, self.window,
                                         self.symmetric,
                                         memory_pairs=self.memory_pairs)
        else:
            cooc = CoOccurrences(self.vocab, self.window, self.symmetric)
        cooc.fit_sentences(self._token_lists())

        rs = np.random.RandomState(self.seed)
        dev = self.device
        w, wc = (torch.as_tensor((rs.rand(V, D).astype(np.float32) - 0.5)
                                 / D).to(dev) for _ in range(2))

        def full(shape, value):
            return torch.full(shape, value, dtype=torch.float32, device=dev)

        self._state = (w, wc, full((V,), 0.0), full((V,), 0.0),
                       full((V, D), 1.0), full((V, D), 1.0),
                       full((V,), 1.0), full((V,), 1.0))
        if self._programs is not None:
            capture.release(self._programs)
        self._programs = learning.StepPrograms(dev, {
            **dict(zip(("w", "wc", "b", "bc", "hw", "hwc", "hb", "hbc"),
                       self._state)),
            "loss_sum": self._loss_sum},
            capture=getattr(self, "_capture", True))

        try:
            spilled = isinstance(cooc, SpillingCoOccurrences) and cooc.n_spills
            if spilled:
                # out-of-core: each epoch streams merged chunks; shuffling is
                # within-chunk (the reference's round-buffer pass has the same
                # locality), so RAM stays bounded by chunk_size
                for _ in range(self.epochs):
                    for rows, cols, vals in cooc.stream_chunks():
                        self._train_pairs(rows, cols, vals, rs)
            else:
                rows, cols, vals = cooc.as_arrays()
                for _ in range(self.epochs):
                    self._train_pairs(rows, cols, vals, rs)
        finally:  # spill files must not outlive a failed fit
            if isinstance(cooc, SpillingCoOccurrences):
                cooc.close()
        # final vectors: w + w̃ (standard GloVe practice)
        self.lookup = InMemoryLookupTable(self.vocab, D, seed=self.seed,
                                          use_hs=False, device=dev)
        self.lookup.syn0 = w + wc
        self.lookup._build_neg_cdf()
        return self

    class Builder:
        def __init__(self):
            self._kw = {}
            self._iterator = None
            self._tokenizer = None

        def device(self, device):
            """Where the matrices live: ``cuda`` (the default) or ``cpu``."""
            self._kw["device"] = device
            return self

        def iterate(self, iterator):
            if isinstance(iterator, (list, tuple)):
                iterator = CollectionSentenceIterator(iterator)
            self._iterator = iterator
            return self

        def tokenizer_factory(self, tf):
            self._tokenizer = tf
            return self

        def layer_size(self, n):
            self._kw["layer_size"] = n
            return self

        def window_size(self, n):
            self._kw["window"] = n
            return self

        def epochs(self, n):
            self._kw["epochs"] = n
            return self

        def learning_rate(self, lr):
            self._kw["learning_rate"] = lr
            return self

        def x_max(self, x):
            self._kw["x_max"] = x
            return self

        def alpha(self, a):
            self._kw["alpha"] = a
            return self

        def min_word_frequency(self, n):
            self._kw["min_word_frequency"] = n
            return self

        def batch_size(self, n):
            self._kw["batch_size"] = n
            return self

        def seed(self, s):
            self._kw["seed"] = s
            return self

        def max_memory_pairs(self, n):
            """Spill-to-disk budget: at most n distinct co-occurrence pairs
            held in RAM (reference maxMemory on AbstractCoOccurrences)."""
            self._kw["memory_pairs"] = n
            return self

        def symmetric(self, b):
            self._kw["symmetric"] = b
            return self

        def build(self) -> "Glove":
            if self._iterator is None:
                raise ValueError("Glove.Builder: iterate(...) required")
            return Glove(sentence_iterator=self._iterator,
                         tokenizer_factory=self._tokenizer, **self._kw)
