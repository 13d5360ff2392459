"""Generation programs: bucketed prefill + ONE decode step — counterpart
of ``deeplearning4j_tpu/generation/programs.py``.

- ``prefill``: one request's (non-shared) prompt suffix, padded up to its
  bucket, forwarded as a [1, bucket] call through the paged carries —
  writes its K/V into the request's pages and samples the first token
  from the last REAL prompt position's logits.
- ``decode``: one token for EVERY slot in a single [slots, 1] call.  Idle
  slots ride along pointed at the trash page with temperature 0; the
  scheduler ignores their outputs.

- ``read_page`` / ``write_page``: one page's K/V slice out of / into
  every pool — the prefix cache's host-tier transport.

The reference compiles exactly these programs (``jax.jit``, one per
prefill bucket and one for decode) and counts any recompile.  The
port's counterpart of a compiled fixed-shape program is a captured CUDA
graph: ``warm()`` captures one graph for decode and one per prefill
bucket, each after a warm-up call on a side stream, through the
version's ``RecompileDetector`` when one is given (``detector=``: a
capture is its compile).  A program's inputs (tokens, block table,
positions, the last real index, the sampling policy and its Gumbel
noise) live in static device buffers, copied from pinned host buffers
before each replay; the graph runs the forward, the paged KV write, the
logits and the sampler (``sample_rows``), and the host reads the sampled
ids after it.  ``captures`` and ``replays`` count graphs captured and
replayed: steady-state serving captures nothing.

The KV pools (``pools``) are the engine's, passed in (``pools=``) and
shared by every model version's programs, so that a hot-swap keeps each
in-flight stream's KV: the graphs hold their addresses, so a pool tensor
is never replaced, only written in place (the paged writes, the page
transport, a reset).  Without ``pools=`` the programs make their own at
``warm``.  Warming writes only the trash page, so a version is warmed and
captured over live pools while another version serves from them.  The
page transport (``read_page``/``write_page``) copies one page's slices
to host tensors and back in place, bit for bit; it is not a graph.

On the CPU, or with ``capture=False`` (an internal switch for comparing
the two on the card), the same bodies run eagerly on the same buffers.
A capture or a replay that fails raises; nothing falls back.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from deeplearning4j_tpu_torch.backend.device import (
    capture_graph, compute_dtype, warm_on_side_stream,
)
from deeplearning4j_tpu_torch import helpers
from deeplearning4j_tpu_torch.models.common import tree_leaves
from deeplearning4j_tpu_torch.models.decode import (
    _ids_need_time_axis, _last_logits_fwd, head_width, named_layers_of,
)
from deeplearning4j_tpu_torch.utils.sampling import (
    _resolve_encoding, fill_row_noise, sample_rows,
)


def seed_paged_pools(net, num_pages: int, page_size: int, dtype,
                     device) -> Dict:
    """Paged KV pools for every pageable layer of ``net``; raises when
    the net carries state that cannot be paged."""
    pools = {}
    for name, layer in named_layers_of(net):
        if hasattr(layer, "init_paged_cache"):
            c = layer.init_paged_cache(num_pages, page_size, dtype, device)
            if c is not None:
                pools[name] = c
        elif hasattr(layer, "apply_with_carry"):
            raise ValueError(
                f"layer '{name}' ({type(layer).__name__}) carries "
                "non-pageable state; the generation engine only serves "
                "attention-cached (transformer) stacks")
    if not pools:
        raise ValueError(
            "no pageable attention layers found — the generation engine "
            "needs at least one causal SelfAttentionLayer KV cache")
    return pools


def _attach(pools, block, pos):
    """Insert the call's block table / positions into every paged leaf."""
    def walk(c):
        if isinstance(c, dict) and "pk" in c:
            return {**c, "block": block, "pos": pos}
        if isinstance(c, dict):
            return {k: walk(v) for k, v in c.items()}
        return c
    return {k: walk(v) for k, v in pools.items()}


class _Program:
    """One fixed-shape program: its inputs' device buffers and pinned
    host twins, its body, and (once captured) its graph and the static
    output the graph writes."""

    def __init__(self, body, shapes: Dict[str, Tuple[tuple, torch.dtype]],
                 device):
        pin = device.type == "cuda"
        self.body = body
        self.dev = {n: torch.zeros(s, dtype=dt, device=device)
                    for n, (s, dt) in shapes.items()}
        self.host = {n: torch.zeros(s, dtype=dt, pin_memory=pin)
                     for n, (s, dt) in shapes.items()}
        self.graph = None
        self.out = None
        self.launches = 0     # paged-kernel launches the graph holds
        self.kernels: Dict[str, int] = {}   # every kernel's, by name
        self.replays = 0

    def stage(self, **arrays) -> None:
        """Host arrays into the host buffers (``noise`` is written in
        place by the caller), then every buffer onto the device."""
        for name, a in arrays.items():
            self.host[name].numpy()[...] = a
        for name, t in self.dev.items():
            t.copy_(self.host[name], non_blocking=True)


class GenerationPrograms:
    """Prefill and decode for ONE model.  ``prefill_calls`` and
    ``decode_calls`` count every call, warm-up included; ``captures`` and
    ``replays`` the graphs captured and replayed."""

    def __init__(self, net, *, slots: int, pages_per_slot: int,
                 page_size: int, num_pages: int,
                 prefill_buckets: Tuple[int, ...], pools=None,
                 detector=None, capture=None):
        self.net = net
        self.slots = int(slots)
        self.pages_per_slot = int(pages_per_slot)
        self.page_size = int(page_size)
        self.num_pages = int(num_pages)
        self.prefill_buckets = tuple(sorted(int(b) for b in prefill_buckets))
        self.device = net.device
        on_card = self.device.type == "cuda"
        if capture and not on_card:
            raise ValueError("CUDA-graph capture needs a CUDA device")
        self.capture = on_card if capture is None else bool(capture)
        self.cache_dtype = compute_dtype(net.conf.compute_dtype)
        # the params cast to the compute dtype once, not on every call
        self.params = net.compute_params()
        _, self.one_hot, self.vocab_size = _resolve_encoding(
            net, np.zeros((1, 1), np.int64), None, None)
        self.expand_ids = _ids_need_time_axis(net, self.one_hot)
        self._fwd = _last_logits_fwd(net)
        self.prefill_calls = 0
        self.decode_calls = 0
        self.captures = 0
        self.replays = 0
        self.detector = detector
        self.pools = pools
        self._pool = None       # the graphs' shared memory pool
        self.last_logits = None
        self._programs: Dict[str, _Program] = {}
        # validate pageability eagerly (raises on recurrent stacks)
        seed_paged_pools(net, 2, page_size, self.cache_dtype, "cpu")

    def fresh_pools(self, device=None):
        """New zeroed pools for this net's geometry (on ``device``, the
        net's by default; ``"meta"`` gives their shapes and types without
        memory)."""
        return seed_paged_pools(self.net, self.num_pages, self.page_size,
                                self.cache_dtype,
                                self.device if device is None else device)

    def reset_pools(self) -> None:
        """Zero the live pools in place: the graphs hold their
        addresses."""
        for t in tree_leaves(self.pools):
            t.zero_()

    def bucket_for(self, length: int) -> int:
        for b in self.prefill_buckets:
            if length <= b:
                return b
        raise ValueError(
            f"prompt suffix of {length} tokens exceeds the largest "
            f"prefill bucket {self.prefill_buckets[-1]}")

    def _encode(self, tokens: torch.Tensor) -> torch.Tensor:
        if self.one_hot:
            return F.one_hot(tokens.to(torch.int64),
                             self.vocab_size).to(torch.float32)
        return tokens[..., None] if self.expand_ids else tokens

    def forward(self, pools, block, pos, tokens) -> torch.Tensor:
        """The network's pre-activation output [B, T, V] for ``tokens``
        [B, T] written at per-row start positions ``pos`` [B] through
        ``block`` [B, MAXP] into ``pools``, eagerly (the check of a
        program against the gather oracle)."""
        def dev(a):
            return torch.as_tensor(np.asarray(a), device=self.device)
        pre, _ = self._fwd(self.params, self._encode(dev(tokens)),
                           _attach(pools, dev(block), dev(pos)))
        return pre

    # ------------------------------------------------------------ programs
    def _decode_body(self, tokens, block, pos, noise, temps, top_ks,
                     top_ps):
        pre, _ = self._fwd(self.params, self._encode(tokens[:, None]),
                           _attach(self.pools, block, pos))
        logits = pre[:, -1].float()
        return sample_rows(logits, noise, temps, top_ks,
                           top_ps).to(torch.int32), logits

    def _prefill_body(self, tokens, block, start, last_idx, noise, temps,
                      top_ks, top_ps):
        pre, _ = self._fwd(self.params, self._encode(tokens),
                           _attach(self.pools, block, start))
        logits = pre[0].index_select(0, last_idx).float()
        return sample_rows(logits, noise, temps, top_ks,
                           top_ps).to(torch.int32), logits

    def _policy(self, rows: int):
        return {"noise": ((rows, head_width(self.net)), torch.float32),
                "temps": ((rows,), torch.float32),
                "top_ks": ((rows,), torch.int32),
                "top_ps": ((rows,), torch.float32)}

    def _make(self, name: str) -> _Program:
        s, maxp = self.slots, self.pages_per_slot
        if name == "decode":
            shapes = {"tokens": ((s,), torch.int32),
                      "block": ((s, maxp), torch.int32),
                      "pos": ((s,), torch.int32), **self._policy(s)}
            return _Program(self._decode_body, shapes, self.device)
        bucket = int(name.split("_")[1])
        shapes = {"tokens": ((1, bucket), torch.int32),
                  "block": ((1, maxp), torch.int32),
                  "start": ((1,), torch.int32),
                  "last_idx": ((1,), torch.int64), **self._policy(1)}
        return _Program(self._prefill_body, shapes, self.device)

    def _capture(self, prog: _Program) -> None:
        """Warm the program on a side stream, then capture it into the
        programs' shared graph pool, recording the paged-kernel launches
        made inside the capture: the launches its graph holds."""
        def call():
            return prog.body(**prog.dev)

        warm_on_side_stream(call, self.device)
        before = {n: c.launches for n, c in helpers.kernel_counts().items()}
        prog.graph, prog.out = capture_graph(call, self._pool)
        prog.kernels = {n: c.launches - before[n]
                        for n, c in helpers.kernel_counts().items()
                        if c.launches != before[n]}
        prog.launches = prog.kernels.get("paged_decode", 0)
        self.captures += 1

    def _run(self, prog: _Program) -> np.ndarray:
        """Replay the program's graph (or run its body eagerly); the
        sampled ids to the host.  ``last_logits`` keeps the call's float32
        logits on the device (a graph's static buffer: the next call
        overwrites it)."""
        if prog.graph is not None:
            prog.graph.replay()
            self.replays += 1
            prog.replays += 1
            ids, self.last_logits = prog.out
        else:
            ids, self.last_logits = prog.body(**prog.dev)
        return ids.cpu().numpy()

    def replayed_launches(self) -> Dict[str, int]:
        """Kernel launches the graphs' replays made, by kernel name (each
        graph's launches times its replays; host counts, no sync)."""
        out: Dict[str, int] = {}
        # a snapshot: the engine's thread adds programs as it captures
        for p in list(self._programs.values()):
            for name, n in p.kernels.items():
                out[name] = out.get(name, 0) + n * p.replays
        return out

    def graph_launches(self) -> Dict[str, int]:
        """Paged-kernel launches each captured graph holds, by program."""
        return {n: p.launches for n, p in self._programs.items()
                if p.graph is not None}

    def decode(self, block, pos, tokens, keys, token_idx, temps, top_ks,
               top_ps) -> np.ndarray:
        """One token for every slot: host arrays [S] in, [S] int32 out."""
        prog = self._programs["decode"]
        self._check("decode", tokens, pos, block)
        fill_row_noise(prog.host["noise"], keys, token_idx, temps)
        prog.stage(tokens=tokens, block=block, pos=pos, temps=temps,
                   top_ks=top_ks, top_ps=top_ps)
        with torch.no_grad():
            out = self._run(prog)
        self.decode_calls += 1
        return out

    def prefill(self, bucket, block, start, last_idx, tokens, keys,
                token_idx, temps, top_ks, top_ps) -> np.ndarray:
        """One request's prompt suffix ([1, bucket]) + first sample.
        ``start`` [1] is the suffix's global start position (0, or the
        shared-prefix length); ``last_idx`` indexes the last REAL token
        in the bucket — the padding beyond it writes scratch K/V that
        the causal mask hides until decode overwrites it."""
        if np.shape(tokens) != (1, bucket):
            raise ValueError(f"prefill_{bucket} takes [1, {bucket}] tokens, "
                             f"got {np.shape(tokens)}")
        prog = self._programs[f"prefill_{bucket}"]
        self._check(f"prefill_{bucket}", tokens, start, block)
        fill_row_noise(prog.host["noise"], keys, token_idx, temps)
        prog.stage(tokens=tokens, block=block, start=start,
                   last_idx=np.int64(last_idx), temps=temps, top_ks=top_ks,
                   top_ps=top_ps)
        with torch.no_grad():
            out = self._run(prog)
        self.prefill_calls += 1
        return out

    def _check(self, name: str, *arrays, expected: bool = False,
               captured: Optional[bool] = None) -> None:
        """The call's signature through the version's detector; a replay
        (or an eager call of a known signature) compiles nothing."""
        if self.detector is not None:
            if captured is None and self.capture:
                captured = False
            self.detector.check((name,) + arrays, {}, expected=expected,
                                captured=captured)

    # -------------------------------------------------- prefix-cache tier
    def read_page(self, page: int) -> Dict:
        """Device → host: one page's [page_size, Hkv, D] K/V slices of
        every pool, as host tensors of the pools' type."""
        def walk(c):
            if isinstance(c, dict) and "pk" in c:
                return {"pk": c["pk"][page].to("cpu", copy=True),
                        "pv": c["pv"][page].to("cpu", copy=True)}
            return {k: walk(v) for k, v in c.items()}
        return {k: walk(v) for k, v in self.pools.items()}

    def write_page(self, page: int, payload: Dict) -> None:
        """Host → device: a ``read_page`` payload into page ``page`` of
        every pool, in place (the graphs hold the pools' addresses)."""
        def walk(c, p):
            if isinstance(c, dict) and "pk" in c:
                c["pk"][page].copy_(torch.as_tensor(p["pk"]))
                c["pv"][page].copy_(torch.as_tensor(p["pv"]))
                return
            for k, v in c.items():
                walk(v, p[k])
        for k, v in self.pools.items():
            walk(v, payload[k])

    def page_nbytes(self) -> int:
        """Host bytes one offloaded page costs (every pool's K+V slice)
        — the unit of the prefix cache's host-tier budget."""
        return sum(t[0].numel() * t.element_size()
                   for t in tree_leaves(self.pools))

    def warm(self) -> int:
        """One prefill per bucket and one decode call on the pools (idle
        inputs: every write lands in the trash page), capturing each
        program's graph on the card; programs already captured are not
        captured again.  Pools the programs made themselves are made
        here and zeroed after; the engine's live pools are left as they
        are.  Returns the number of programs."""
        s, maxp = self.slots, self.pages_per_slot
        made = self.pools is None
        if made:
            self.pools = self.fresh_pools()
        if self.capture and self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        names = [f"prefill_{b}" for b in self.prefill_buckets] + ["decode"]
        for name in names:
            if name not in self._programs:
                prog = self._programs[name] = self._make(name)
                host = prog.host
                sig = (host["tokens"].numpy(),
                       host["start" if "start" in host else "pos"].numpy(),
                       host["block"].numpy())
                if self.capture:
                    with torch.no_grad():
                        self._capture(prog)
                self._check(name, *sig, expected=True,
                            captured=True if self.capture else None)
        for b in self.prefill_buckets:
            self.prefill(b, np.zeros((1, maxp), np.int32),
                         np.zeros((1,), np.int32), 0,
                         np.zeros((1, b), np.int32),
                         np.zeros((1, 2), np.uint32), np.zeros((1,), np.int32),
                         np.zeros((1,), np.float32), np.zeros((1,), np.int32),
                         np.ones((1,), np.float32))
        self.decode(np.zeros((s, maxp), np.int32), np.zeros((s,), np.int32),
                    np.zeros((s,), np.int32), np.zeros((s, 2), np.uint32),
                    np.zeros((s,), np.int32), np.zeros((s,), np.float32),
                    np.zeros((s,), np.int32), np.ones((s,), np.float32))
        if made:
            self.reset_pools()
        return len(names)
