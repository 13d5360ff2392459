"""Weight lookup table — counterpart of ``deeplearning4j_tpu/nlp/lookup.py``:
syn0/syn1/syn1Neg and the negative-sampling distribution.

Reference: ``models/embeddings/inmemory/InMemoryLookupTable.java:62-138``
— ``syn0`` (input embeddings), ``syn1`` (hierarchical-softmax inner
nodes), ``syn1Neg`` (negative-sampling output weights), the
unigram^0.75 sampling table and ``resetWeights``.

The matrices are tensors on the table's device (``cuda`` unless the
caller names the CPU); ``reset_weights`` draws them from the seeded
numpy stream the reference draws from, so one seed gives one set of
weights in both packages.  Negative sampling is inverse-CDF
``searchsorted`` over the unigram^0.75 cumulative.  Its uniforms come
from the port's counter-based streams (``backend/rng.py``), keyed by a
device key, so a captured step draws new negatives at every replay from
the key the host rewrites; JAX's ``jax.random.uniform`` cannot be
reproduced in torch.  ``sample_negatives`` is the one seam a test
replaces to feed both packages the same negatives.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from deeplearning4j_tpu_torch.backend import rng
from deeplearning4j_tpu_torch.backend.device import resolve_device
from deeplearning4j_tpu_torch.nlp.vocab import VocabCache


class InMemoryLookupTable:
    def __init__(self, cache: VocabCache, vector_length: int,
                 seed: int = 12345, negative: float = 0.0,
                 use_hs: bool = True, use_adagrad: bool = False,
                 device=None):
        self.cache = cache
        self.vector_length = int(vector_length)
        self.seed = seed
        self.negative = negative
        self.use_hs = use_hs
        self.use_adagrad = use_adagrad
        self.device = resolve_device(device)
        self.syn0: Optional[torch.Tensor] = None
        self.syn1: Optional[torch.Tensor] = None
        self.syn1neg: Optional[torch.Tensor] = None
        # the reference allocates these under use_adagrad and no step reads
        # them (ROADMAP C2); kept, with the same null effect
        self.syn0_hist: Optional[torch.Tensor] = None
        self.syn1_hist: Optional[torch.Tensor] = None
        self.syn1neg_hist: Optional[torch.Tensor] = None
        self._neg_cdf: Optional[torch.Tensor] = None

    # ------------------------------------------------------------------ init
    def _zeros(self, *shape) -> torch.Tensor:
        return torch.zeros(shape, dtype=torch.float32, device=self.device)

    def reset_weights(self) -> None:
        """≙ ``InMemoryLookupTable.resetWeights`` :133-138 (uniform in
        [-0.5/D, 0.5/D), syn1 zeros)."""
        V, D = len(self.cache), self.vector_length
        rs = np.random.RandomState(self.seed)
        self.syn0 = torch.as_tensor(
            (rs.rand(V, D).astype(np.float32) - 0.5) / D).to(self.device)
        if self.use_hs:
            self.syn1 = self._zeros(V, D)
        if self.negative > 0:
            self.syn1neg = self._zeros(V, D)
        if self.use_adagrad:
            self.syn0_hist = self._zeros(V, D)
            self.syn1_hist = self._zeros(V, D) if self.use_hs else None
            self.syn1neg_hist = (self._zeros(V, D) if self.negative > 0
                                 else None)
        self._build_neg_cdf()

    def _build_neg_cdf(self) -> None:
        """Unigram^0.75 cumulative distribution for inverse-CDF sampling
        (in place of the reference's materialised ``table``)."""
        freqs = np.array([w.element_frequency
                          for w in self.cache.vocab_words()], np.float64)
        if len(freqs) == 0:
            self._neg_cdf = None
            return
        p = freqs ** 0.75
        p /= p.sum()
        self._neg_cdf = torch.as_tensor(
            np.cumsum(p).astype(np.float32)).to(self.device)

    def sample_negatives(self, key, shape) -> torch.Tensor:
        """Negative-sample word indices ~ unigram^0.75, int32 of
        ``shape``, drawn from ``key`` (a device key or a generator).  A
        uniform past the cumulative's last float32 value takes the last
        row, never the row count."""
        u = rng.uniform(key, shape, self.device)
        idx = torch.searchsorted(self._neg_cdf, u)
        return torch.clamp(idx, max=self._neg_cdf.shape[0] - 1).to(
            torch.int32)

    # ----------------------------------------------------------------- query
    def vector(self, label: str) -> Optional[np.ndarray]:
        idx = self.cache.index_of(label)
        if idx < 0 or self.syn0 is None:
            return None
        return self.syn0[idx].cpu().numpy()

    def put_vector(self, label: str, vec) -> None:
        idx = self.cache.index_of(label)
        if idx < 0:
            raise KeyError(label)
        with torch.no_grad():
            self.syn0[idx] = torch.as_tensor(np.asarray(vec),
                                             dtype=self.syn0.dtype)

    @property
    def num_words(self) -> int:
        return len(self.cache)
