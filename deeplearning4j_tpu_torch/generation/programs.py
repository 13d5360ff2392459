"""Generation programs: bucketed prefill + ONE decode step — counterpart
of ``deeplearning4j_tpu/generation/programs.py``.

- ``prefill``: one request's (non-shared) prompt suffix, padded up to its
  bucket, forwarded as a [1, bucket] call through the paged carries —
  writes its K/V into the request's pages and samples the first token
  from the last REAL prompt position's logits.
- ``decode``: one token for EVERY slot in a single [slots, 1] call.  Idle
  slots ride along pointed at the trash page with temperature 0; the
  scheduler ignores their outputs.

PyTorch runs eagerly, so there is nothing to compile: the reference's
AOT-warmed program set becomes one warm-up call of each on scratch
pools (it loads the CUDA kernel and the library handles before the first
request).  The KV pools are updated in place (the reference donates
them to XLA instead), so both calls hand back the same pool tensors.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from deeplearning4j_tpu_torch.backend.device import compute_dtype
from deeplearning4j_tpu_torch.models.decode import (
    _ids_need_time_axis, _last_logits_fwd, _resolve_encoding,
)
from deeplearning4j_tpu_torch.utils.sampling import sample_tokens


def named_layers_of(net) -> List[Tuple[str, object]]:
    return [(l.name, l) for l in net.layers]


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


class GenerationPrograms:
    """Prefill and decode for ONE model.  ``prefill_calls`` and
    ``decode_calls`` count every call, warm-up included."""

    def __init__(self, net, *, slots: int, pages_per_slot: int,
                 page_size: int, num_pages: int,
                 prefill_buckets: Tuple[int, ...]):
        self.net = net
        self.slots = int(slots)
        self.pages_per_slot = int(pages_per_slot)
        self.page_size = int(page_size)
        self.num_pages = int(num_pages)
        self.prefill_buckets = tuple(sorted(int(b) for b in prefill_buckets))
        self.device = net.device
        self.cache_dtype = compute_dtype(net.conf.compute_dtype)
        # the params cast to the compute dtype once, not on every call
        self.params = net.compute_params()
        self.one_hot, self.vocab_size = _resolve_encoding(net)
        self.expand_ids = _ids_need_time_axis(net, self.one_hot)
        self._fwd = _last_logits_fwd(net)
        self.prefill_calls = 0
        self.decode_calls = 0
        # validate pageability eagerly (raises on recurrent stacks)
        seed_paged_pools(net, 2, page_size, self.cache_dtype, "cpu")

    def fresh_pools(self):
        return seed_paged_pools(self.net, self.num_pages, self.page_size,
                                self.cache_dtype, self.device)

    def bucket_for(self, length: int) -> int:
        for b in self.prefill_buckets:
            if length <= b:
                return b
        raise ValueError(
            f"prompt suffix of {length} tokens exceeds the largest "
            f"prefill bucket {self.prefill_buckets[-1]}")

    def _tensor(self, a):
        return torch.as_tensor(np.asarray(a), device=self.device)

    def _encode(self, tokens: torch.Tensor) -> torch.Tensor:
        if self.one_hot:
            return F.one_hot(tokens.to(torch.int64),
                             self.vocab_size).to(torch.float32)
        return tokens[..., None] if self.expand_ids else tokens

    def forward(self, pools, block, pos, tokens) -> torch.Tensor:
        """The network's pre-activation output [B, T, V] for ``tokens``
        [B, T] written at per-row start positions ``pos`` [B] through
        ``block`` [B, MAXP]; writes their K/V into ``pools``."""
        x = self._encode(self._tensor(tokens))
        pre, _ = self._fwd(self.params, x, _attach(
            pools, self._tensor(block), self._tensor(pos)))
        return pre

    def decode(self, pools, block, pos, tokens, keys, token_idx, temps,
               top_ks, top_ps):
        """One token for every slot: host arrays [S] in, [S] int32 out."""
        pre = self.forward(pools, block, pos, np.asarray(tokens)[:, None])
        nxt = sample_tokens(pre[:, -1].float(), keys, token_idx, temps,
                            top_ks, top_ps)
        self.decode_calls += 1
        return pools, nxt.to(torch.int32).cpu().numpy()

    def prefill(self, bucket, pools, block, start, last_idx, tokens, keys,
                token_idx, temps, top_ks, top_ps):
        """One request's prompt suffix ([1, bucket]) + first sample.
        ``start`` [1] is the suffix's global start position (0, or the
        shared-prefix length); ``last_idx`` indexes the last REAL token
        in the bucket — the padding beyond it writes scratch K/V that
        the causal mask hides until decode overwrites it."""
        if np.shape(tokens) != (1, bucket):
            raise ValueError(f"prefill_{bucket} takes [1, {bucket}] tokens, "
                             f"got {np.shape(tokens)}")
        pre = self.forward(pools, block, start, tokens)
        logits = pre[0, int(last_idx)][None].float()
        tok = sample_tokens(logits, keys, token_idx, temps, top_ks, top_ps)
        self.prefill_calls += 1
        return pools, tok.to(torch.int32).cpu().numpy()

    def warm(self) -> int:
        """One prefill per bucket and one decode step on scratch pools
        (the live pools are never touched); returns the number of calls."""
        s, maxp = self.slots, self.pages_per_slot
        pools = self.fresh_pools()
        for b in self.prefill_buckets:
            self.prefill(b, pools, np.zeros((1, maxp), np.int32),
                         np.zeros((1,), np.int32), 0,
                         np.zeros((1, b), np.int32),
                         np.zeros((1, 2), np.uint32), np.zeros((1,), np.int32),
                         np.zeros((1,), np.float32), np.zeros((1,), np.int32),
                         np.ones((1,), np.float32))
        self.decode(pools, np.zeros((s, maxp), np.int32),
                    np.zeros((s,), np.int32), np.zeros((s,), np.int32),
                    np.zeros((s, 2), np.uint32), np.zeros((s,), np.int32),
                    np.zeros((s,), np.float32), np.zeros((s,), np.int32),
                    np.ones((s,), np.float32))
        del pools
        return len(self.prefill_buckets) + 1
