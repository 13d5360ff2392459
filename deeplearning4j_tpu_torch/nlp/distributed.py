"""Distributed embedding training — counterpart of
``deeplearning4j_tpu/nlp/distributed.py`` (the Spark-NLP scaleout) over
the port's slot meshes (``backend/mesh.py``).

Reference: ``spark/dl4j-spark-nlp/.../word2vec/Word2Vec.java:61,130-195``
— TextPipeline builds the vocab with Spark accumulators, executors train
their partitions, and syn0 is averaged across partitions.

 * vocab build: multithreaded host-side counting (the accumulator
   analog);
 * training: every pair batch is sharded over the mesh's first axis;
   each slot runs the SAME step (``nlp/learning.py``) on its shard
   against its replica of the matrices, and the replicas' deltas are
   recombined by collectives over the slot dimension (``mesh.psum``,
   ``mesh.pmean``, recorded in the collective census), every batch.

A mesh is slots in one process (on the card, slots of ``cuda:0``): a
slot's replica is slot k of a ``[K, ...]`` stack, and the whole sharded
step is one captured CUDA graph a padded batch shape.  A mesh over
several devices raises (ROADMAP A10).  On the card ``index_add_`` is
not ordered, so two runs from one seed agree to rounding, not bit for
bit; the reference's one-device programs are deterministic.

**Across processes** (a mesh made after
``parallel.initialize_distributed``, ``backend/mesh.py``) every process
builds the same global batch (the pairs, subsampling and reduced
windows from the model's ``RandomState``, the negatives from its
``KeyStream``, both seeded by the configuration alone), runs the steps
of its own slots, and gathers the count-weighted deltas and the counts
(GloVe: the eight state tensors' deltas) of every slot in slot order
(``mesh.process_gather_slots``), which the one-process formula then
reduces: two processes of two slots give the one-process four-slot
bits.  The steps run eagerly there (a gloo collective cannot be
captured).  Before its first batch each process checks that the
vocabulary, the Huffman codes and points and the initial tables (GloVe:
its co-occurrence triples and state) hash alike on every rank
(``mesh.check_agreement``): a mismatch raises, never trains two
vocabularies.  Each batch moves every local slot's whole ``[V, D]``
deltas, where only the touched rows change.

``DistributedWord2Vec`` on a 1-slot mesh reproduces ``Word2Vec`` to
rounding (the equivalence oracle, ≙ TestSparkWord2Vec-style parity).
"""

from __future__ import annotations

import hashlib
import math
import threading
from collections import Counter
from typing import List, Optional

import numpy as np
import torch

from deeplearning4j_tpu_torch.backend import mesh as mesh_mod
from deeplearning4j_tpu_torch.nlp import learning
from deeplearning4j_tpu_torch.nlp.documents import SentenceIterator
from deeplearning4j_tpu_torch.nlp.glove import Glove
from deeplearning4j_tpu_torch.nlp.sequencevectors import VectorsConfiguration
from deeplearning4j_tpu_torch.nlp.tokenization import (
    DefaultTokenizerFactory, TokenizerFactory,
)
from deeplearning4j_tpu_torch.nlp.vocab import digest as vocab_digest
from deeplearning4j_tpu_torch.nlp.word2vec import Word2Vec


def parallel_vocab_count(sentences: List[str],
                         tokenizer_factory: TokenizerFactory,
                         n_threads: int = 4) -> Counter:
    """Multithreaded token counting — the TextPipeline accumulator analog
    (``spark/text/functions/TextPipeline.java``)."""
    chunks = np.array_split(np.asarray(sentences, dtype=object),
                            max(n_threads, 1))
    counters = [Counter() for _ in chunks]

    def count(i):
        tf = tokenizer_factory
        for s in chunks[i]:
            counters[i].update(tf.create(str(s)).tokens())

    threads = [threading.Thread(target=count, args=(i,))
               for i in range(len(chunks))]
    [t.start() for t in threads]
    [t.join() for t in threads]
    total = Counter()
    for c in counters:
        total.update(c)
    return total


def _replicas(t: torch.Tensor, k: int) -> torch.Tensor:
    """Each of ``k`` slots' copy of the replicated ``t``: ``[k, *t.shape]``."""
    return t.unsqueeze(0).repeat((k,) + (1,) * t.dim())


def _shards(t: torch.Tensor, k: int) -> torch.Tensor:
    """``t`` split over ``k`` slots along its first dimension, in slot
    order: ``[k, n/k, ...]``."""
    return t.reshape((k, -1) + tuple(t.shape[1:]))


def _digest(head: bytes, arrays) -> bytes:
    """sha256 of ``head`` and the bytes of ``arrays`` (numpy arrays or
    tensors; None skipped), in order."""
    h = hashlib.sha256(head)
    for a in arrays:
        if a is None:
            continue
        if torch.is_tensor(a):
            a = a.detach().cpu().contiguous().view(torch.uint8).numpy()
        h.update(np.ascontiguousarray(a).tobytes())
    return h.digest()


def _eager_across(model, mesh) -> None:
    """Across processes a step holds a gloo collective, which a CUDA
    graph cannot capture: the model's programs run eagerly."""
    if mesh.spans_processes:
        model._capture = False


class DistributedWord2Vec(Word2Vec):
    """Word2Vec whose steps run on every slot of a mesh.

    Batches are zero-padded to a multiple of the mesh's size; padded rows
    carry mask 0 so they contribute nothing (the masking the serial
    engine uses for its power-of-two padding).
    """

    def __init__(self, config: VectorsConfiguration,
                 sentence_iterator: SentenceIterator,
                 tokenizer_factory: Optional[TokenizerFactory] = None,
                 mesh: Optional[mesh_mod.Mesh] = None):
        mesh = mesh or mesh_mod.default_mesh()
        super().__init__(config, sentence_iterator,
                         tokenizer_factory or DefaultTokenizerFactory(),
                         device=mesh.device)
        self.mesh = mesh
        self._axis = mesh.axis_names[0]
        _eager_across(self, mesh)

    def _start_programs(self) -> None:
        if self.mesh.spans_processes:
            lk = self.lookup
            mesh_mod.check_agreement(
                "DistributedWord2Vec's vocabulary and Huffman tree",
                _digest(vocab_digest(self.vocab),
                        [self._codes, self._points, self._code_lengths]))
            mesh_mod.check_agreement(
                "DistributedWord2Vec's initial lookup tables",
                _digest(b"tables", [lk.syn0, lk.syn1, lk.syn1neg,
                                    lk._neg_cdf]))
        super()._start_programs()

    # Which rows of each matrix a step touches, and with what occurrence
    # weights: what turns each slot's collision-mean deltas back into the
    # global mean (see _step).
    @staticmethod
    def _row_specs(name, sharded):
        def bcast(mask, idx2d):
            return mask[:, None].expand(idx2d.shape).reshape(-1)

        if name == "sg_ns":
            inputs, targets, negs, mask = sharded
            out = torch.cat([targets[:, None], negs.to(targets.dtype)], 1)
            return (inputs, mask), (out.reshape(-1), bcast(mask, out))
        if name == "sg_hs":
            inputs, pts, _cds, code_mask, mask = sharded
            return ((inputs, mask),
                    (pts.reshape(-1), (code_mask * mask[:, None]).reshape(-1)))
        if name == "cbow_ns":
            ctx, ctx_mask, targets, negs, mask = sharded
            out = torch.cat([targets[:, None], negs.to(targets.dtype)], 1)
            return ((torch.clamp(ctx, min=0).reshape(-1),
                     (ctx_mask * mask[:, None]).reshape(-1)),
                    (out.reshape(-1), bcast(mask, out)))
        if name == "cbow_hs":
            ctx, ctx_mask, pts, _cds, code_mask, mask = sharded
            return ((torch.clamp(ctx, min=0).reshape(-1),
                     (ctx_mask * mask[:, None]).reshape(-1)),
                    (pts.reshape(-1), (code_mask * mask[:, None]).reshape(-1)))
        raise KeyError(name)

    def _step(self, name: str, fn, a, b, *sharded, lr):
        """``fn`` on every slot: slot k runs it on its shard against its
        replica of ``a`` and ``b``.  The step applies a collision MEAN per
        row over its (local) shard, so a slot's delta is
        sum_local/count_local; multiplied back by the local count, summed
        over the slots with the counts (``psum``) and divided again, it
        gives Σsums/Σcounts, the serial step's update on the whole batch
        (the reference's ``_get_sharded``, :121-158).  Across processes
        this process runs its own slots and the per-slot stacks are
        gathered in slot order before the sums (module docstring)."""
        K = self.mesh.shape[self._axis]
        mine = self.mesh.local_slots
        ra, rb = _replicas(a, len(mine)), _replicas(b, len(mine))
        shards = [_shards(s, K) for s in sharded]
        losses, ca, cb = [], [], []
        for k, g in enumerate(mine):
            local = [s[g] for s in shards]
            losses.append(fn(ra[k], rb[k], *local, lr))
            (ia, wa), (ib, wb) = self._row_specs(name, local)
            ca.append(torch.zeros((a.shape[0],), dtype=a.dtype,
                                  device=a.device).index_add_(0, ia, wa))
            cb.append(torch.zeros((b.shape[0],), dtype=b.dtype,
                                  device=b.device).index_add_(0, ib, wb))
        ca, cb = torch.stack(ca), torch.stack(cb)
        wa, wb = (ra - a) * ca[..., None], (rb - b) * cb[..., None]
        losses = torch.stack(losses)
        if self.mesh.spans_processes:
            ca, cb, wa, wb, losses = mesh_mod.process_gather_slots_many(
                [ca, cb, wa, wb, losses])
        ca_tot = mesh_mod.psum(ca)
        cb_tot = mesh_mod.psum(cb)
        da = mesh_mod.psum(wa) / torch.clamp(ca_tot, min=1.0)[:, None]
        db = mesh_mod.psum(wb) / torch.clamp(cb_tot, min=1.0)[:, None]
        a.add_(da)
        b.add_(db)
        return mesh_mod.psum(losses)

    def _padded(self, n: int) -> int:
        """Global batch size: power-of-two >= n AND divisible by the
        mesh's size."""
        ndev = self.mesh.size
        B = max(self.config.batch_size,
                int(2 ** math.ceil(math.log2(max(n, 1)))))
        return int(np.ceil(B / ndev) * ndev)

    class Builder(Word2Vec.Builder):
        def __init__(self):
            super().__init__()
            self._mesh = None

        def mesh(self, mesh: mesh_mod.Mesh) -> "DistributedWord2Vec.Builder":
            self._mesh = mesh
            return self

        def build(self) -> "DistributedWord2Vec":
            if self._iterator is None:
                raise ValueError("Word2Vec.Builder: iterate(...) is required")
            return DistributedWord2Vec(self._cfg, self._iterator,
                                       self._tokenizer, mesh=self._mesh)


class DistributedGlove(Glove):
    """GloVe whose weighted-least-squares batches shard over the mesh.

    ≙ ``spark/dl4j-spark-nlp/.../glove/Glove.java`` (partition-parallel
    training with per-partition averaging).  Co-occurrence triples shard
    over the mesh's first axis; each slot runs the AdaGrad step on its
    slice against its replica of the state, and the parameter and
    accumulator deltas are ``pmean``-ed — the reference's
    partition-averaged semantics per batch (AdaGrad's nonlinearity makes
    exact serial equivalence impossible here, as it was for Spark)."""

    def __init__(self, *args, mesh: Optional[mesh_mod.Mesh] = None, **kw):
        mesh = mesh or mesh_mod.default_mesh()
        kw["device"] = mesh.device
        super().__init__(*args, **kw)
        self.mesh = mesh
        ndev = mesh.shape[mesh.axis_names[0]]
        if self.batch_size % ndev:
            self.batch_size = int(np.ceil(self.batch_size / ndev) * ndev)
        self._glove_step = self._sharded_step
        self._agreed = None
        _eager_across(self, mesh)

    def _train_pairs(self, rows, cols, vals, rs):
        """Across processes, first the check that every rank trains the
        same vocabulary and triples (and, at a fit's first block, the
        same initial state)."""
        if self.mesh.spans_processes:
            first = self._agreed is not self._state
            mesh_mod.check_agreement(
                "DistributedGlove's vocabulary and co-occurrence triples"
                + (" and initial state" if first else ""),
                _digest(vocab_digest(self.vocab),
                        [rows, cols, vals]
                        + (list(self._state) if first else [])))
            self._agreed = self._state
        super()._train_pairs(rows, cols, vals, rs)

    def _sharded_step(self, *args):
        """The reference's ``shard_map`` of ``glove_step`` (:255-267):
        slot k's step on its shard and replica, then each state tensor
        moved by the mean of the slots' deltas; the losses summed.
        Across processes this process's slots, the deltas gathered in
        slot order before the mean."""
        state, batch, (lr, x_max, alpha) = args[:8], args[8:12], args[12:]
        K = self.mesh.shape[self.mesh.axis_names[0]]
        mine = self.mesh.local_slots
        reps = [_replicas(t, len(mine)) for t in state]
        shards = [_shards(t, K) for t in batch]
        losses = torch.stack([
            learning.glove_step(
                *[r[k] for r in reps], *[s[g] for s in shards], lr, x_max,
                alpha)
            for k, g in enumerate(mine)])
        deltas = [rep - old for old, rep in zip(state, reps)]
        if self.mesh.spans_processes:
            *deltas, losses = mesh_mod.process_gather_slots_many(
                deltas + [losses])
        for old, d in zip(state, deltas):
            old.add_(mesh_mod.pmean(d))
        return mesh_mod.psum(losses)

    class Builder(Glove.Builder):
        def __init__(self):
            super().__init__()
            self._mesh = None

        def mesh(self, mesh: mesh_mod.Mesh) -> "DistributedGlove.Builder":
            self._mesh = mesh
            return self

        def build(self) -> "DistributedGlove":
            if self._iterator is None:
                raise ValueError("Glove.Builder: iterate(...) required")
            kw = {k: v for k, v in self._kw.items() if k != "device"}
            return DistributedGlove(sentence_iterator=self._iterator,
                                    tokenizer_factory=self._tokenizer,
                                    mesh=self._mesh, **kw)
