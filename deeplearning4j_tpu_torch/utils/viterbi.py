"""Viterbi decoding — most-likely state sequence under a transition model;
counterpart of ``deeplearning4j_tpu/utils/viterbi.py``.

Reference: ``deeplearning4j-nn/.../util/Viterbi.java`` (decodes binarized
label sequences given emission probabilities and a transition weight).

The reference's forward max-product recursion is a ``lax.scan`` over
time.  Here it is a device loop over time: a step adds, takes the max
and the argmax over ``[S, S]`` in float32, operations that are exact,
and ``torch.argmax`` returns the first maximum as ``jnp.argmax`` does,
so the path and the score are the reference's bit for bit.  On the card
``CHUNK`` steps are captured as one CUDA graph (the first chunk runs
eagerly, then is captured), replayed over the sequence with each
chunk's emissions copied into its static input on the device; the steps
left over run eagerly.  The backtrace runs on the host.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from deeplearning4j_tpu_torch.backend.device import (
    capture_graph, resolve_device, warm_on_side_stream,
)

# time steps one captured graph holds
CHUNK = 256
# captured graphs and their replays so far, in this process
counts = {"captures": 0, "replays": 0}


def _forward(em: torch.Tensor, tr: torch.Tensor, capture: bool):
    """The max-product recursion over ``em`` [T, S] and ``tr`` [S, S]:
    (the final scores [S], the back-pointers [T - 1, S])."""
    T, S = em.shape
    delta = em[0].clone()
    backptrs = torch.empty((T - 1, S), dtype=torch.int64, device=em.device)

    def steps(em_rows, out):
        for t in range(em_rows.shape[0]):
            # delta [S]: best score ending in each state at t-1
            scores = delta[:, None] + tr               # [S_prev, S_next]
            torch.argmax(scores, 0, out=out[t])
            delta.copy_(torch.amax(scores, 0) + em_rows[t])

    done = 0
    if capture and T - 1 >= CHUNK:
        em_in = torch.empty((CHUNK, S), dtype=em.dtype, device=em.device)
        bp_out = torch.empty((CHUNK, S), dtype=torch.int64, device=em.device)

        def chunk():
            steps(em_in, bp_out)

        em_in.copy_(em[1:1 + CHUNK])
        warm_on_side_stream(chunk, em.device)
        backptrs[:CHUNK].copy_(bp_out)
        graph, _ = capture_graph(chunk)
        counts["captures"] += 1
        done = CHUNK
        while done + CHUNK <= T - 1:
            em_in.copy_(em[1 + done:1 + done + CHUNK])
            graph.replay()
            counts["replays"] += 1
            backptrs[done:done + CHUNK].copy_(bp_out)
            done += CHUNK
    steps(em[1 + done:], backptrs[done:])
    return delta, backptrs


def viterbi_decode(emission_logprobs, transition_logprobs, device=None
                   ) -> Tuple[np.ndarray, float]:
    """Most likely state path.

    emission_logprobs  [T, S] — per-timestep state log-scores
    transition_logprobs [S, S] — log P(next=j | prev=i)

    The recursion runs on ``device`` (``cuda`` unless the caller names
    the CPU).  Returns (path [T] int array, path log-score).
    """
    dev = resolve_device(device)

    def put(a):
        if torch.is_tensor(a):
            return a.detach().to(dev, torch.float32)
        return torch.as_tensor(np.asarray(a, np.float32)).to(dev)

    em, tr = put(emission_logprobs), put(transition_logprobs)
    T, S = em.shape
    if tuple(tr.shape) != (S, S):
        raise ValueError(f"transition matrix {tuple(tr.shape)} != ({S},{S})")
    delta, backptrs = _forward(em, tr, capture=dev.type == "cuda")
    backptrs = backptrs.cpu().numpy()          # [T-1, S]
    path = np.empty(T, np.int64)
    path[-1] = int(torch.argmax(delta))
    for t in range(T - 2, -1, -1):
        path[t] = backptrs[t, path[t + 1]]
    return path, float(torch.max(delta))


class Viterbi:
    """Reference-shaped facade (``util/Viterbi.java``): binary label
    smoothing with a possibility-of-transition prior.  Decodes on
    ``device`` (``cuda`` unless the caller names the CPU)."""

    def __init__(self, possible_labels, meta_stability: float = 0.9,
                 p_correct: float = 0.99, device=None):
        self.labels = np.asarray(possible_labels)
        if len(self.labels) < 2:
            raise ValueError("need >= 2 possible labels")
        self.meta_stability = meta_stability
        self.p_correct = p_correct
        self.device = resolve_device(device)

    def decode(self, observed_labels) -> Tuple[np.ndarray, float]:
        """Smooth an observed label sequence: each observation emits its
        label with p_correct; transitions prefer staying (meta_stability)."""
        obs = np.asarray(observed_labels)
        S = len(self.labels)
        label_to_idx = {l: i for i, l in enumerate(self.labels.tolist())}
        idx = np.array([label_to_idx[l] for l in obs.tolist()])
        T = len(idx)
        eps = 1e-6
        em = np.full((T, S), np.log((1 - self.p_correct) / max(S - 1, 1) + eps),
                     np.float32)
        em[np.arange(T), idx] = np.log(self.p_correct)
        tr = np.full((S, S), np.log((1 - self.meta_stability) / max(S - 1, 1)
                                    + eps), np.float32)
        np.fill_diagonal(tr, np.log(self.meta_stability))
        path, score = viterbi_decode(em, tr, device=self.device)
        return self.labels[path], score
