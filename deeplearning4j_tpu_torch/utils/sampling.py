"""Sampling — counterpart of ``deeplearning4j_tpu/utils/sampling.py``.

The one owner of the sampling policy (temperature, top-k and nucleus
filtering, the draw) for every decode path of the port:

- ``sample_sequence``: the host loop over ``rnn_time_step`` (prime on the
  prompt, sample, feed the sample back), the oracle ``generate`` is held
  against;
- ``_sampler``: one static policy for a whole batch (``generate`` and
  ``sample_sequence``);
- ``sample_rows``: the generation engine's per-row runtime policy, all
  rows at once with no host branching, so that a CUDA graph can hold it.
  Its Gumbel noise comes from a tensor the caller fills:
  ``fill_row_noise`` draws it on the host, per sampled row, from a CPU
  ``torch.Generator`` seeded by (request seed, token index) alone, so a
  request's stream never depends on its slot or on who shares the batch.

Every draw is the Gumbel-max trick: ``argmax(filtered logits + g)`` with
``g = -log(-log(u))`` for uniform ``u``.  The reference's
``fold_in``/threefry draws cannot be reproduced in torch, so sampled
streams match the port's own, not the reference's; greedy decoding
(temperature <= 0) is the argmax in both.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

NEG = -1e30
_SEED_MASK = 2 ** 63 - 1
_TINY = torch.finfo(torch.float32).tiny


def _filter_logits(logits: torch.Tensor, top_k=None,
                   top_p=None) -> torch.Tensor:
    """Top-k / nucleus filtering: everything outside the kept set drops to
    -1e30.  ``top_k``/``top_p`` are static Python numbers (one policy for
    the batch, validated here) or per-row tensors: ``top_k`` [B] int
    (< 1 disables that row), ``top_p`` [B] float (>= 1 keeps
    everything)."""
    v = logits.shape[-1]
    if top_k is not None:
        if isinstance(top_k, (int, np.integer)):
            if top_k < 1:
                raise ValueError(f"top_k={top_k} must be >= 1")
            kth = torch.sort(logits, dim=-1).values[..., -min(int(top_k), v),
                                                    None]
        else:
            karr = top_k.to(torch.int64)
            k = torch.where(karr >= 1, karr.clamp(max=v),
                            torch.full_like(karr, v))
            sorted_desc = torch.sort(logits, dim=-1, descending=True).values
            kth = torch.gather(sorted_desc, -1, (k - 1)[..., None])
        # a scalar fill: no host-to-device copy, so a graph can hold it
        logits = logits.masked_fill(logits < kth, NEG)
    if top_p is not None:
        if isinstance(top_p, (float, int, np.floating, np.integer)):
            if not 0.0 < top_p <= 1.0:
                raise ValueError(f"top_p={top_p} must be in (0, 1]; for "
                                 "greedy use temperature=0")
            p = float(top_p)
        else:
            p = top_p.to(logits.dtype).clamp(torch.finfo(logits.dtype).tiny,
                                             1.0)[..., None]
        sorted_logits = torch.sort(logits, dim=-1, descending=True).values
        probs = torch.softmax(sorted_logits, dim=-1)
        cum = torch.cumsum(probs, dim=-1)
        # keep the smallest prefix with cumulative mass >= top_p (always
        # keep the argmax); threshold = the smallest kept logit
        keep_sorted = cum - probs < p
        cutoff = torch.where(keep_sorted, sorted_logits,
                             torch.full_like(sorted_logits, float("inf")))
        cutoff = cutoff.amin(dim=-1, keepdim=True)
        logits = logits.masked_fill(logits < cutoff, NEG)
    return logits


def gumbel(u: torch.Tensor) -> torch.Tensor:
    """Gumbel noise from uniform ``u`` in [0, 1)."""
    return -torch.log(-torch.log(u.clamp_min(_TINY)))


def step_noise(seed: int, steps: int, batch: int, vocab: int,
               device) -> torch.Tensor:
    """[steps, B, V] float32 Gumbel noise for a sampled ``generate`` or
    ``sample_sequence``, drawn on ``device`` from one generator seeded
    with ``seed``: step i of both reads slice i."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    u = torch.rand((steps, batch, vocab), generator=gen, device=device)
    return gumbel(u)


def _sampler(temperature: float, top_k: Optional[int],
             top_p: Optional[float]):
    """Static policy -> ``sample(logits [B, V], noise [B, V]) -> ids
    [B]``.  ``temperature <= 0`` is the greedy argmax (the noise is then
    not read, and may be None)."""
    if temperature and temperature > 0:
        # validate the static filters eagerly, as the reference does
        _filter_logits(torch.zeros(1, 1), top_k, top_p)

        def sample(logits, noise):
            filtered = _filter_logits(logits / float(temperature), top_k,
                                      top_p)
            return torch.argmax(filtered + noise, dim=-1)
    else:
        def sample(logits, noise):
            return torch.argmax(logits, dim=-1)

    return sample


def base_key(seed: int) -> np.ndarray:
    """A request's [2] uint32 key (the scheduler's per-slot key row): the
    seed's low and high 32 bits."""
    seed = int(seed) & (2 ** 64 - 1)
    return np.asarray([seed & 0xFFFFFFFF, seed >> 32], np.uint32)


def _draw_seed(key: np.ndarray, token_idx: int) -> int:
    """Generator seed for one draw: a mix of the request seed and the
    index of the token being drawn (splitmix64 constants)."""
    seed = int(key[0]) | (int(key[1]) << 32)
    z = (seed * 0x9E3779B97F4A7C15 + (int(token_idx) + 1)
         * 0xBF58476D1CE4E5B9) & (2 ** 64 - 1)
    z ^= z >> 31
    return z & _SEED_MASK


def fill_row_noise(noise: torch.Tensor, keys, token_idx,
                   temperature) -> None:
    """Write each sampled row's Gumbel noise into ``noise`` [B, V] (a CPU
    tensor: the engine's pinned staging buffer), from the row's own
    generator.  Greedy rows (temperature <= 0) are left as they are:
    ``sample_rows`` does not read them."""
    v = noise.shape[-1]
    for r in np.flatnonzero(np.asarray(temperature) > 0):
        gen = torch.Generator().manual_seed(_draw_seed(keys[r],
                                                       token_idx[r]))
        noise[r] = gumbel(torch.rand(v, generator=gen))


def sample_rows(logits: torch.Tensor, noise: torch.Tensor,
                temperature: torch.Tensor, top_k: torch.Tensor,
                top_p: torch.Tensor) -> torch.Tensor:
    """The engine's per-row policy for a mixed batch, all rows at once:
    ``logits`` [B, V] float32, ``noise`` [B, V] (``fill_row_noise``),
    ``temperature`` [B] (<= 0 -> greedy), ``top_k`` [B] (< 1 disables),
    ``top_p`` [B] (>= 1 disables), all on the logits' device.  Greedy and
    sampled rows are chosen by a ``torch.where``, so the call has no host
    branching and no sync.  Returns [B] int64 ids."""
    sampled = temperature > 0
    safe_t = torch.where(sampled, temperature, torch.ones_like(temperature))
    filtered = _filter_logits(logits / safe_t[:, None].to(logits.dtype),
                              top_k, top_p)
    drawn = torch.argmax(filtered + noise, dim=-1)
    return torch.where(sampled, drawn, torch.argmax(logits, dim=-1))


def _resolve_encoding(net, prompt_ids, one_hot: Optional[bool],
                      vocab_size: Optional[int]):
    """The preamble shared by ``sample_sequence`` and ``generate``:
    validate the [B, T] prompt and resolve the input encoding.  A
    sequential net whose first layer is not an embedding, or a
    single-input graph whose input no embedding reads, takes one-hot
    vectors as wide as the INPUT-side consumer's ``n_in`` (not the
    head's ``n_out``: the two differ in asymmetric-vocab nets).  A
    multi-input graph needs ``one_hot=`` (and ``vocab_size=``)."""
    from deeplearning4j_tpu_torch.models.sequential import MultiLayerNetwork
    from deeplearning4j_tpu_torch.nn.layers.dense import EmbeddingLayer

    prompt_ids = np.asarray(prompt_ids)
    if prompt_ids.ndim != 2:
        raise ValueError(f"prompt_ids must be [B, T], got {prompt_ids.shape}")
    sequential = isinstance(net, MultiLayerNetwork)
    single_in = sequential or len(net.conf.inputs) == 1
    if one_hot is None:
        if sequential:
            one_hot = not (net.layers
                           and isinstance(net.layers[0], EmbeddingLayer))
        elif single_in:
            one_hot = net._id_consumer(net.conf.inputs[0]) is None
        else:
            raise ValueError(
                "one_hot auto-detection needs a single-input net; pass "
                "one_hot= explicitly for a multi-input ComputationGraph")
    if one_hot and vocab_size is None:
        if sequential:
            vocab_size = (getattr(net.layers[0], "n_in", None)
                          if net.layers else None) or net.layers[-1].n_out
        elif single_in:
            in_name = net.conf.inputs[0]
            consumer = next((net.nodes[n] for n in net.topo
                             if in_name in net.nodes[n].inputs), None)
            layer = getattr(consumer, "layer", None)
            if layer is None or getattr(layer, "n_in", None) is None:
                raise ValueError(
                    "cannot infer the one-hot width: the graph input "
                    f"'{in_name}' feeds a vertex; pass vocab_size=")
            vocab_size = layer.n_in
        else:
            raise ValueError("pass vocab_size= explicitly for a "
                             "multi-input ComputationGraph")
    return prompt_ids, one_hot, vocab_size


def sample_sequence(net, prompt_ids, steps: int, *,
                    temperature: float = 1.0,
                    top_k: Optional[int] = None,
                    top_p: Optional[float] = None,
                    rng: Optional[int] = None,
                    one_hot: Optional[bool] = None,
                    vocab_size: Optional[int] = None) -> np.ndarray:
    """Generate ``steps`` tokens after priming with ``prompt_ids`` [B,
    T_prompt]: one ``rnn_time_step`` for the prompt, then one a token,
    each sample read back to the host and fed back.  ``one_hot`` picks
    the input encoding (auto-detected when None); ``temperature`` <= 0
    is greedy; ``top_k``/``top_p`` filter before the draw; ``rng`` is the
    seed of the sampled draws (0 when None; ``step_noise``).  Returns the
    ids [B, steps]."""
    prompt_ids, one_hot, vocab_size = _resolve_encoding(
        net, prompt_ids, one_hot, vocab_size)

    def encode(ids):
        ids = np.asarray(ids)
        if one_hot:
            return np.eye(vocab_size, dtype=np.float32)[ids]
        return ids

    net.rnn_clear_previous_state()
    # prime on the whole prompt in one chunk
    probs = net.rnn_time_step(encode(prompt_ids))
    probs = probs[:, -1] if probs.ndim == 3 else probs
    sample = _sampler(temperature, top_k, top_p)
    noise = (step_noise(0 if rng is None else rng, steps, probs.shape[0],
                        probs.shape[-1], probs.device)
             if temperature and temperature > 0 else None)
    out = []
    for i in range(steps):
        # log-probs differ from the head's logits by a per-row constant,
        # which the filters and the argmax do not see
        tok = sample(torch.log(probs.clamp_min(1e-30)),
                     None if noise is None else noise[i])
        tok = tok.cpu().numpy()
        out.append(tok)
        probs = net.rnn_time_step(encode(tok[:, None]))
        probs = probs[:, -1] if probs.ndim == 3 else probs
    return np.stack(out, axis=1)
