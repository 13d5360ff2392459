"""Generation without the engine — counterpart of
``deeplearning4j_tpu/models/decode.py``.

The reference runs a whole generation as ONE jitted XLA program: the
prompt's prefill, then the token loop as a ``lax.scan``.  The port's
counterpart of that compiled program is a captured CUDA graph: on the
card, ``generate`` prefills eagerly and then replays one graph of the
loop body (forward through the stream caches and the LSTM carries, the
logits, the draw, the token fed back) once a token.  The fed-back token,
the step index, the noise, the LSTMs' (h, c) (written back in place
after each step's forward) and the [B, steps] output live in static
device buffers, and the host reads the ids once, at the end.  On the
CPU the same body runs eagerly.  ``utils.sampling.sample_sequence`` (the
host loop over ``rnn_time_step``) is the oracle: greedy ids are the same
through both.

``MultiLayerNetwork`` and single-input single-output ``ComputationGraph``
are served; generation feeds back one token stream, so a multi-input
graph is refused with the reference's guidance.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from deeplearning4j_tpu_torch.backend.device import (
    capture_graph, warm_on_side_stream,
)
from deeplearning4j_tpu_torch.models.capture import (  # noqa: F401
    GRAPH_CACHE_SIZE, cached,
)
from deeplearning4j_tpu_torch.models.common import (
    advance_carries_, check_cache_capacity, seed_stream_caches, tree_leaves,
)
from deeplearning4j_tpu_torch.nn.layers.attention import KPOS_EMPTY
from deeplearning4j_tpu_torch.utils.sampling import (
    _resolve_encoding, _sampler, step_noise,
)


def _is_sequential(net) -> bool:
    from deeplearning4j_tpu_torch.models.sequential import MultiLayerNetwork

    return isinstance(net, MultiLayerNetwork)


def _cg_single_io(net):
    """The single input and output names of a generation-capable graph."""
    if len(net.conf.inputs) != 1 or len(net.conf.outputs) != 1:
        raise ValueError(
            "compiled decode needs a single-input single-output "
            f"ComputationGraph (got {len(net.conf.inputs)} inputs, "
            f"{len(net.conf.outputs)} outputs); use "
            "utils.sampling.sample_sequence for multi-stream graphs")
    return net.conf.inputs[0], net.conf.outputs[0]


def named_layers_of(net):
    """(name, layer) pairs of either facade, in forward order."""
    if _is_sequential(net):
        return [(l.name, l) for l in net.layers]
    _cg_single_io(net)   # generation feeds back ONE token stream
    return net._named_layers()


def head_width(net) -> int:
    """The width of the output layer's logits (the noise's last dim)."""
    if _is_sequential(net):
        return int(net.layers[-1].n_out)
    return int(net.nodes[_cg_single_io(net)[1]].layer.n_out)


def _last_logits_fwd(net):
    """(params, x, carries) -> (preoutput, new_carries) for either facade:
    the one seam the decode programs need."""
    if _is_sequential(net):
        def fwd(params, x, carries):
            h, new_carries, _ = net._forward(params, x,
                                             carries=carries or None)
            return h, new_carries
        return fwd

    in_name, out_name = _cg_single_io(net)

    def fwd(params, x, carries):
        acts, _, new_carries = net._forward(
            params, net.net_state, {in_name: x}, carries=carries or None)
        return acts[out_name], new_carries

    return fwd


def _ids_need_time_axis(net, one_hot: bool) -> bool:
    """True when id inputs need a trailing singleton axis, so that a
    ``collapse_column`` embedding reads [B, T, 1] as T column steps
    instead of collapsing a [B, 1] feed to a rank-2 column."""
    from deeplearning4j_tpu_torch.nn.layers.dense import EmbeddingLayer

    if one_hot:
        return False
    if _is_sequential(net):
        l0 = net.layers[0] if net.layers else None
        return isinstance(l0, EmbeddingLayer) and l0.collapse_column
    emb = net._id_consumer(_cg_single_io(net)[0])
    return emb is not None and emb.collapse_column


class DecodeFn:
    """What ``build_decode_fn`` returns: ``prefill`` and ``step``, the two
    halves a captured generation runs, and ``__call__``, the whole
    generation run eagerly."""

    def __init__(self, net, steps, temperature, top_k, top_p, one_hot,
                 vocab_size, expand_ids):
        self.steps = steps
        self.one_hot, self.vocab_size = one_hot, vocab_size
        self.expand_ids = expand_ids
        self.sampled = bool(temperature and temperature > 0)
        self.sample = _sampler(temperature, top_k, top_p)
        self.fwd = _last_logits_fwd(net)
        self.last_logits = None

    def encode(self, ids: torch.Tensor) -> torch.Tensor:
        """[B, T] ids -> the network's input for T steps."""
        if self.one_hot:
            return F.one_hot(ids.to(torch.int64),
                             self.vocab_size).to(torch.float32)
        return ids[..., None] if self.expand_ids else ids

    def _next(self, params, carries, x, noise):
        pre, new = self.fwd(params, x, carries)
        # recurrent state back into the carries' own tensors (the stream
        # caches were written in place by their layers)
        advance_carries_(carries, new)
        # the call's float32 logits stay on the device (in a captured
        # loop: the graph's buffer, which every replay overwrites)
        self.last_logits = pre[:, -1].float()
        return self.sample(self.last_logits, noise)

    def prefill(self, params, carries, prompt, noise) -> torch.Tensor:
        """The prompt [B, T] through the caches; the first token [B]."""
        return self._next(params, carries, self.encode(prompt), noise)

    def step(self, params, carries, tok, noise) -> torch.Tensor:
        """One fed-back token [B] through the caches; the next [B]."""
        return self._next(params, carries, self.encode(tok[:, None]), noise)

    def __call__(self, params, carries, prompt, noise=None):
        """(ids [B, steps], carries): the whole generation, eagerly.
        ``noise`` is ``step_noise``'s [steps, B, V] for a sampled policy.
        The caches end holding the prompt and the first ``steps - 1``
        tokens: the last token is never fed back."""
        at = (lambda i: None) if noise is None else (lambda i: noise[i])
        tok = self.prefill(params, carries, prompt, at(0))
        ids = [tok]
        for i in range(1, self.steps):
            tok = self.step(params, carries, tok, at(i))
            ids.append(tok)
        return torch.stack(ids, dim=1), carries


def build_decode_fn(net, steps: int, *, temperature: float = 1.0,
                    top_k: Optional[int] = None,
                    top_p: Optional[float] = None,
                    one_hot: bool = False,
                    vocab_size: Optional[int] = None,
                    expand_ids: Optional[bool] = None) -> DecodeFn:
    """The generation function of ``net`` for ``steps`` tokens (reference
    ``decode.py:63``): ``fn(params, carries, prompt, noise)`` ->
    ``(ids, carries)``, with freshly seeded stream ``carries``
    (``models.common.seed_stream_caches``), ``prompt`` [B, T_prompt]
    ids on the device and ``noise`` for a sampled policy.  The first
    token is drawn from the prompt's last logits, each later one from
    its predecessor's."""
    if steps < 1:
        raise ValueError(f"steps={steps} must be >= 1")
    if one_hot and vocab_size is None:
        raise ValueError("one_hot decoding needs vocab_size")
    if expand_ids is None:
        expand_ids = _ids_need_time_axis(net, one_hot)
    return DecodeFn(net, steps, temperature, top_k, top_p, one_hot,
                    vocab_size, expand_ids)


def _static_params(net):
    """The net's parameters in the compute dtype at the addresses every
    cached loop of the net reads: one tree a net, shared by all its
    loops, brought up to ``net.params`` at every call so that a graph
    sees the current weights.  Where the compute dtype is the
    parameters' own (float32) the tree is ``net.params``' own tensors,
    which ``fit`` updates in place, and nothing is copied; a parameter
    tensor replaced since is copied into the one the graphs read."""
    held = net._graph_params
    if held is None:
        net._graph_params = held = net.compute_params()
        return held
    for dst, src in zip(tree_leaves(held), tree_leaves(net.params)):
        if dst is not src:
            dst.copy_(src)
    return held


def _reset_caches(carries) -> None:
    """Empty stream caches and zero recurrent (h, c), in place: ``pos``
    0, rolling slots empty."""
    for c in carries.values():
        if isinstance(c, tuple):
            for t in c:
                t.zero_()
            continue
        if not isinstance(c, dict):
            continue
        if "pos" in c and "k" in c:
            c["pos"].zero_()
            if "kpos" in c:
                c["kpos"].fill_(KPOS_EMPTY)
        else:
            _reset_caches(c)


class _Generation:
    """One cached generation shape (``generate``'s key): the decode
    function, its stream caches, and on the card the static buffers and
    the captured graph of the loop body.

    Buffers: ``tok`` [B] (the token fed back), ``step`` [1] (the index
    of the token the body draws), ``ids`` [B, steps] (the output) and
    ``noise`` [steps, B, V] (a sampled policy's draws).  The parameters
    are the net's shared ``_static_params``."""

    def __init__(self, net, fn: DecodeFn, carries, batch: int):
        self.net, self.fn, self.carries = net, fn, carries
        dev = net.device
        self.capture = dev.type == "cuda"
        self.tok = torch.zeros(batch, dtype=torch.int64, device=dev)
        self.step = torch.zeros(1, dtype=torch.int64, device=dev)
        self.ids = torch.zeros(batch, fn.steps, dtype=torch.int64,
                               device=dev)
        self.noise = None
        self.step_logits = None
        self.graph = None
        self.captures = 0
        self.replays = 0

    def _body(self, params) -> None:
        noise = (None if self.noise is None else
                 self.noise.index_select(0, self.step)[0])
        nxt = self.fn.step(params, self.carries, self.tok, noise)
        # a captured loop's logits buffer, which every replay overwrites
        self.step_logits = self.fn.last_logits
        self.ids.index_copy_(1, self.step, nxt[:, None])
        self.tok.copy_(nxt)
        self.step.add_(1)

    def run(self, prompt_ids: np.ndarray, seed: int) -> np.ndarray:
        net, fn = self.net, self.fn
        dev = net.device
        b = prompt_ids.shape[0]
        if fn.sampled:
            noise = step_noise(seed, fn.steps, b, head_width(net), dev)
            if self.noise is None:
                self.noise = noise
            else:
                self.noise.copy_(noise)
        with torch.no_grad():
            params = _static_params(net)
            if self.capture and self.graph is None:
                def body():
                    self._body(params)

                _reset_caches(self.carries)
                warm_on_side_stream(body, dev)
                self.graph, _ = capture_graph(body)
                self.captures += 1
            _reset_caches(self.carries)
            prompt = torch.as_tensor(prompt_ids, device=dev)
            tok0 = fn.prefill(params, self.carries, prompt,
                              None if self.noise is None else self.noise[0])
            self.tok.copy_(tok0)
            self.ids[:, 0] = tok0
            self.step.fill_(1)
            for _ in range(fn.steps - 1):
                if self.graph is not None:
                    self.graph.replay()
                    self.replays += 1
                else:
                    self._body(params)
            # a copy: on the CPU, .cpu() would hand back the buffer itself
            return self.ids.cpu().numpy().copy()


def generate(net, prompt_ids, steps: int, *, temperature: float = 1.0,
             top_k: Optional[int] = None, top_p: Optional[float] = None,
             rng: Optional[int] = None, one_hot: Optional[bool] = None,
             vocab_size: Optional[int] = None) -> np.ndarray:
    """Generate ``steps`` tokens after ``prompt_ids`` [B, T_prompt]: the
    contract of ``utils.sampling.sample_sequence``, with the token loop
    one captured CUDA graph replayed once a token on the card (eager on
    the CPU).  ``rng`` seeds a sampled policy's noise (0 when None),
    drawn up front on the net's device.  The whole generation must fit
    the linear caches: ``t_prompt + steps - 1`` positions, checked once
    on the host (rolling caches never overflow).  The captured loop is
    cached on the net per (steps, policy, encoding, batch, prompt
    length), at most ``GRAPH_CACHE_SIZE`` loops in the net's one graph
    cache (``capture.cached``), so a repeated call captures
    nothing; every loop reads the net's one shared parameter tree.
    Returns [B, steps] int64 ids."""
    named_layers = named_layers_of(net)
    prompt_ids, one_hot, vocab_size = _resolve_encoding(
        net, prompt_ids, one_hot, vocab_size)
    b, t_prompt = prompt_ids.shape
    key = ("decode", steps, temperature, top_k, top_p, one_hot, vocab_size,
           b, t_prompt)

    def make():
        carries = seed_stream_caches(named_layers, {}, b,
                                     net.conf.compute_dtype, net.device)
        # the final token is never fed back, so the caches hold
        # t_prompt + steps - 1 positions
        check_cache_capacity(carries, t_prompt + steps - 1, pos=0)
        fn = build_decode_fn(net, steps, temperature=temperature,
                             top_k=top_k, top_p=top_p, one_hot=one_hot,
                             vocab_size=vocab_size)
        return _Generation(net, fn, carries, b)

    gen = cached(net, key, make)
    return gen.run(prompt_ids, 0 if rng is None else int(rng))
