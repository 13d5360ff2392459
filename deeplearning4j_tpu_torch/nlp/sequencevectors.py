"""SequenceVectors, the generic embedding-training engine — counterpart
of ``deeplearning4j_tpu/nlp/sequencevectors.py``.

Reference: ``models/sequencevectors/SequenceVectors.java:148-235`` (fit:
build vocab → Huffman → resetWeights → epochs of Hogwild training with
a linear lr anneal) and its Builder (:735).

As in the reference package, the host turns sequences into index arrays
and fixed-size padded, masked batches of window pairs (numpy, on the
same ``RandomState`` stream, so subsampling and the reduced windows
match the reference's draw for draw), and each batch is one device
program (``nlp/learning.py``): on the card a captured CUDA graph a
padded batch shape, replayed with the batch's index buffers staged from
pinned memory.  Two things differ from the reference, which is slower
for them and computes the same values:

- the Huffman ``points``/``codes``/``lengths`` tables go to the device
  once a fit, and each step gathers its batch's rows there (the
  reference uploads the whole tables again every batch);
- the loss is summed on the device, in float64 as the reference's
  Python float, and read when ``cum_loss`` is asked for (the reference
  syncs on every batch to read it).

Generic over element streams: Word2Vec feeds tokenised sentences,
ParagraphVectors labelled documents (labels become special vocab
elements trained by DBOW/DM — ``impl/sequence/{DBOW,DM}``).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Iterable, List, Optional, Tuple

import numpy as np
import torch

from deeplearning4j_tpu_torch.backend import rng
from deeplearning4j_tpu_torch.backend.device import resolve_device
from deeplearning4j_tpu_torch.models import capture
from deeplearning4j_tpu_torch.nlp import learning
from deeplearning4j_tpu_torch.nlp.lookup import InMemoryLookupTable
from deeplearning4j_tpu_torch.nlp.vocab import (
    Sequence,
    SequenceElement,
    VocabCache,
    VocabConstructor,
    build_huffman,
    codes_matrix,
)
from deeplearning4j_tpu_torch.nlp.wordvectors import WordVectors


@dataclass
class VectorsConfiguration:
    """≙ the reference Builder knobs (``SequenceVectors.Builder`` :735)."""

    layer_size: int = 100
    window: int = 5
    negative: int = 0                  # K negative samples; 0 = off
    use_hierarchic_softmax: bool = True
    min_word_frequency: int = 1
    epochs: int = 1
    iterations: int = 1                # passes over each batch
    learning_rate: float = 0.025
    min_learning_rate: float = 1e-4
    subsampling: float = 0.0           # e.g. 1e-3; 0 = off
    seed: int = 12345
    batch_size: int = 512
    elements_algorithm: str = "skipgram"   # skipgram | cbow
    sequence_algorithm: str = "dbow"       # dbow | dm (PV only)
    train_elements: bool = True
    train_sequences: bool = False      # PV: train label vectors
    use_adagrad: bool = False


class SequenceVectors(WordVectors):
    def __init__(self, config: VectorsConfiguration,
                 sequence_provider: Callable[[], Iterable[Sequence]],
                 device=None):
        """``sequence_provider`` returns a fresh iterable per epoch
        (≙ iterator reset semantics).  The matrices live on ``device``:
        ``cuda`` unless the caller names the CPU."""
        self.config = config
        self.sequence_provider = sequence_provider
        self.device = resolve_device(device)
        self.vocab: Optional[VocabCache] = None
        self.lookup: Optional[InMemoryLookupTable] = None
        self._rs = np.random.RandomState(config.seed)
        self._keys = rng.KeyStream(config.seed)
        self._codes = self._points = self._code_lengths = None
        self._tables = {}
        self._loss_sum = torch.zeros((), dtype=torch.float64,
                                     device=self.device)
        self._programs: Optional[learning.StepPrograms] = None

    @property
    def cum_loss(self) -> float:
        """The summed batch losses of every fit so far (a read from the
        device)."""
        return float(self._loss_sum)

    # ------------------------------------------------------------------ fit
    def fit(self) -> "SequenceVectors":
        cfg = self.config
        if self.vocab is None:
            self.vocab = VocabConstructor(
                min_element_frequency=cfg.min_word_frequency
            ).build_vocab(self.sequence_provider())
        if cfg.use_hierarchic_softmax:
            build_huffman(self.vocab)
            self._codes, self._points, self._code_lengths = codes_matrix(self.vocab)
        self.lookup = InMemoryLookupTable(
            self.vocab, cfg.layer_size, seed=cfg.seed,
            negative=cfg.negative, use_hs=cfg.use_hierarchic_softmax,
            use_adagrad=cfg.use_adagrad, device=self.device)
        self.lookup.reset_weights()
        self._start_programs()

        total_words = self.vocab.total_word_count * max(cfg.epochs, 1)
        processed = 0
        for _ in range(cfg.epochs):
            for batch in self._batches():
                lr = max(cfg.min_learning_rate,
                         cfg.learning_rate * (1.0 - processed / max(total_words, 1.0)))
                for _ in range(cfg.iterations):
                    self._apply_batch(batch, lr)
                processed += batch["n_words"]
        return self

    def _start_programs(self) -> None:
        """The fit's device tables and step programs (an earlier fit's
        graphs dropped)."""
        if self._programs is not None:
            capture.release(self._programs)
        dev = self.device
        self._tables = {}
        if self.config.use_hierarchic_softmax:
            self._tables = {
                "codes": torch.as_tensor(self._codes).to(dev),
                "points": torch.as_tensor(self._points).to(dev),
                "lengths": torch.as_tensor(self._code_lengths).to(dev)}
        lk = self.lookup
        self._programs = learning.StepPrograms(dev, {
            "syn0": lk.syn0, "syn1": lk.syn1, "syn1neg": lk.syn1neg,
            "neg_cdf": lk._neg_cdf, "loss_sum": self._loss_sum,
            **self._tables}, capture=getattr(self, "_capture", True))

    @property
    def programs(self) -> Optional[learning.StepPrograms]:
        """The last fit's step programs (captures and replays)."""
        return self._programs

    # ------------------------------------------------- pair/batch generation
    def _sequence_indices(self, seq: Sequence) -> Tuple[np.ndarray, Optional[int]]:
        idx = [self.vocab.index_of(el.label if isinstance(el, SequenceElement)
                                   else str(el))
               for el in seq.elements]
        idx = np.array([i for i in idx if i >= 0], np.int32)
        cfg = self.config
        if cfg.subsampling > 0 and len(idx):
            freqs = np.array(
                [self.vocab.element_at_index(i).element_frequency for i in idx],
                np.float64)
            ran = (np.sqrt(freqs / (cfg.subsampling * self.vocab.total_word_count)) + 1) \
                * (cfg.subsampling * self.vocab.total_word_count) / np.maximum(freqs, 1e-12)
            idx = idx[self._rs.rand(len(idx)) < ran]
        label_idx = None
        if seq.sequence_label is not None:
            li = self.vocab.index_of(seq.sequence_label.label)
            label_idx = li if li >= 0 else None
        return idx, label_idx

    def _window_pairs(self, idx: np.ndarray):
        """Skip-gram pairs (input=context row, target=center) with reduced
        windows — vectorised per shift distance."""
        n = len(idx)
        if n < 2:
            return np.empty((0, 2), np.int32), np.empty((0,), np.int32)
        b = self._rs.randint(1, self.config.window + 1, size=n)
        inputs, targets, centers_pos = [], [], []
        for s in range(1, self.config.window + 1):
            m = b >= s
            # context at center-s (center index i >= s)
            sel = np.nonzero(m[s:])[0] + s
            inputs.append(idx[sel - s]); targets.append(idx[sel]); centers_pos.append(sel)
            # context at center+s (none when s >= n: the reference's
            # m[:n - s] wraps round there and indexes past the end)
            sel2 = np.nonzero(m[:max(n - s, 0)])[0]
            inputs.append(idx[sel2 + s]); targets.append(idx[sel2]); centers_pos.append(sel2)
        return (np.stack([np.concatenate(inputs), np.concatenate(targets)], 1),
                np.concatenate(centers_pos))

    def _context_groups(self, idx: np.ndarray):
        """CBOW groups: per center, the (−1-padded) context window."""
        n = len(idx)
        C = 2 * self.config.window
        if n < 2:
            return (np.empty((0, C), np.int32), np.empty((0,), np.int32))
        b = self._rs.randint(1, self.config.window + 1, size=n)
        ctx = np.full((n, C), -1, np.int32)
        for i in range(n):
            lo, hi = max(0, i - b[i]), min(n, i + b[i] + 1)
            members = np.concatenate([idx[lo:i], idx[i + 1:hi]])
            ctx[i, :len(members)] = members
        return ctx, idx

    def _batches(self):
        """Assemble fixed-size training batches from the sequence stream."""
        cfg = self.config
        algo = cfg.elements_algorithm
        buf_inputs: List[np.ndarray] = []
        buf_targets: List[np.ndarray] = []
        buf_ctx: List[np.ndarray] = []
        count = 0
        n_words = 0

        def flush():
            nonlocal buf_inputs, buf_targets, buf_ctx, count, n_words
            if count == 0:
                return None
            if algo == "skipgram" or not cfg.train_elements:
                inputs = np.concatenate(buf_inputs) if buf_inputs else np.empty(0, np.int32)
                targets = np.concatenate(buf_targets) if buf_targets else np.empty(0, np.int32)
                batch = {"kind": "sg", "inputs": inputs, "targets": targets,
                         "n_words": n_words}
            else:
                ctx = np.concatenate(buf_ctx) if buf_ctx else np.empty((0, 2 * cfg.window), np.int32)
                targets = np.concatenate(buf_targets) if buf_targets else np.empty(0, np.int32)
                batch = {"kind": "cbow", "contexts": ctx, "targets": targets,
                         "n_words": n_words}
            buf_inputs, buf_targets, buf_ctx = [], [], []
            count = 0
            n_words = 0
            return batch

        for seq in self.sequence_provider():
            idx, label_idx = self._sequence_indices(seq)
            n_words += len(idx)
            if cfg.train_elements:
                if algo == "skipgram":
                    pairs, _ = self._window_pairs(idx)
                    if len(pairs):
                        buf_inputs.append(pairs[:, 0])
                        buf_targets.append(pairs[:, 1])
                        count += len(pairs)
                else:  # cbow
                    ctx, centers = self._context_groups(idx)
                    if cfg.train_sequences and label_idx is not None and len(centers):
                        ctx = np.concatenate(
                            [ctx, np.full((len(ctx), 1), label_idx, np.int32)], 1)
                    if len(centers):
                        buf_ctx.append(ctx)
                        buf_targets.append(centers)
                        count += len(centers)
            if cfg.train_sequences and label_idx is not None:
                if cfg.sequence_algorithm == "dbow" or not cfg.train_elements:
                    # DBOW: label row predicts every word of the sequence
                    if len(idx):
                        buf_inputs.append(np.full(len(idx), label_idx, np.int32))
                        buf_targets.append(idx)
                        count += len(idx)
                elif cfg.sequence_algorithm == "dm" and algo == "skipgram":
                    # DM with skip-gram elements: label also predicts words
                    if len(idx):
                        buf_inputs.append(np.full(len(idx), label_idx, np.int32))
                        buf_targets.append(idx)
                        count += len(idx)
            if count >= cfg.batch_size:
                yield flush()
        tail = flush()
        if tail is not None:
            yield tail

    # --------------------------------------------------------- batch apply
    def _next_key(self) -> int:
        """The next negative-sampling draw's seed."""
        return rng.seed_of(self._keys.next())

    def _pad(self, arr: np.ndarray, B: int, fill=0):
        pad = B - len(arr)
        if pad <= 0:
            return arr
        pad_block = np.full((pad,) + arr.shape[1:], fill, arr.dtype)
        return np.concatenate([arr, pad_block], 0)

    def _padded(self, n: int) -> int:
        """The batch's padded size: one program a power of two at least
        the configured batch size."""
        return max(self.config.batch_size,
                   int(2 ** math.ceil(math.log2(max(n, 1)))))

    def _apply_batch(self, batch, lr: float) -> None:
        cfg = self.config
        n = len(batch["targets"])
        if n == 0:
            return
        B = self._padded(n)
        inputs = {"targets": self._pad(batch["targets"], B),
                  "mask": self._pad(np.ones(n, np.float32), B)}
        seed = self._next_key() if cfg.negative > 0 else None
        if batch["kind"] == "sg":
            inputs["inputs"] = self._pad(batch["inputs"], B)
            body = self._sg_body
        else:
            inputs["contexts"] = self._pad(batch["contexts"], B, fill=-1)
            body = self._cbow_body
        self._programs.call(batch["kind"], body, inputs, seed, [("lr", lr)])

    def _path(self, targets):
        """The center words' Huffman paths: points, codes and the mask of
        their lengths, gathered from the device tables."""
        t = self._tables
        ln = t["lengths"][targets]
        L = t["codes"].shape[1]
        code_mask = (torch.arange(L, device=targets.device)[None, :]
                     < ln[:, None]).to(torch.float32)
        return t["points"][targets], t["codes"][targets], code_mask

    def _step(self, name: str, fn, a, b, *args, lr):
        """One of ``learning``'s steps on matrices ``a`` and ``b`` (the
        distributed engine shards it over its slots)."""
        return fn(a, b, *args, lr)

    def _summed(self, losses):
        """Each step's loss into the fit's float64 sum, in order."""
        for loss in losses:
            self._loss_sum.add_(loss)
        return (torch.stack(losses).sum() if losses
                else torch.zeros((), device=self._loss_sum.device))

    def _sg_body(self, inputs, targets, mask, key, scalars):
        cfg, lk, lr = self.config, self.lookup, scalars["lr"]
        losses = []
        if cfg.negative > 0:
            negs = lk.sample_negatives(key, (targets.shape[0], cfg.negative))
            losses.append(self._step(
                "sg_ns", learning.sg_ns_step, lk.syn0, lk.syn1neg, inputs,
                targets, negs, mask, lr=lr))
        if cfg.use_hierarchic_softmax:
            pts, cds, code_mask = self._path(targets)
            losses.append(self._step(
                "sg_hs", learning.sg_hs_step, lk.syn0, lk.syn1, inputs, pts,
                cds, code_mask, mask, lr=lr))
        return self._summed(losses)

    def _cbow_body(self, contexts, targets, mask, key, scalars):
        cfg, lk, lr = self.config, self.lookup, scalars["lr"]
        ctx_mask = (contexts >= 0).to(torch.float32)
        losses = []
        if cfg.negative > 0:
            negs = lk.sample_negatives(key, (targets.shape[0], cfg.negative))
            losses.append(self._step(
                "cbow_ns", learning.cbow_ns_step, lk.syn0, lk.syn1neg,
                contexts, ctx_mask, targets, negs, mask, lr=lr))
        if cfg.use_hierarchic_softmax:
            pts, cds, code_mask = self._path(targets)
            losses.append(self._step(
                "cbow_hs", learning.cbow_hs_step, lk.syn0, lk.syn1, contexts,
                ctx_mask, pts, cds, code_mask, mask, lr=lr))
        return self._summed(losses)

    # ------------------------------------------------- WordVectors surface
    @property
    def syn0(self):
        return self.lookup.syn0

    def vocab_cache(self) -> VocabCache:
        return self.vocab
