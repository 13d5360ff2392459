"""Persistent cross-request KV reuse: radix-tree prefix cache + host tier.

Copied from ``deeplearning4j_tpu/generation/prefix_cache.py`` (framework-free)
with its imports pointed at the port's own copies.  The engine's page
transport (``GenerationPrograms.read_page``/``write_page``) copies a
page's K/V slices to host tensors and back into the live pools in place.

The scheduler's chained-hash index only dedups prompts that are in flight
*simultaneously* — a completed request frees its pages, so the shared
system prompts / few-shot templates / re-sent chat histories that
dominate real traffic re-prefill from scratch on every request.  This
module promotes that index to a PERSISTENT radix tree over token
sequences whose nodes own refcounted KV pages that outlive the request:

- **Radix tree**: one node per ``page_size``-token chunk, children
  keyed by the exact token tuple (no hash, no collisions).  A node's KV
  content is a function of the WHOLE chain from the root (attention
  mixes every earlier position into each page), which the tree
  structure encodes for free — matching IS chain-hashing.
- **Retention**: on request completion the scheduler's existing
  ``cache.free(req.pages)`` drops the request's refs, but the tree
  holds ONE allocator ref per resident node, so prompt pages stay
  cached (LRU-ordered) instead of returning to the free list.  Decode
  tail pages are never registered and free exactly as before.
- **Admission pricing**: a hit drops the pages a request must prefill
  from ⌈prompt/page⌉ to ⌈suffix/page⌉, so more requests admit at the
  same page budget.  Refs on matched nodes are taken FIRST — before
  any eviction runs — so a mid-admission hit can never have its pages
  evicted out from under it.
- **Eviction order**: only unpinned nodes whose allocator refcount is
  exactly the tree's own (no in-flight sharer) are candidates, coldest
  ``last_use`` first, deepest first on ties (leaves before the chain
  that leads to them).  Victims spill to the host-RAM tier when the
  byte budget allows; otherwise childless victims are dropped outright
  (an interior node is never dropped while children are reachable —
  that would orphan valid KV).
- **Host tier** (serving-side twin of the training checkpointing
  device→host ``snapshot_trees``): an offloaded node's page slice is
  copied to host memory through the engine's pool transport and its
  device page freed; a later hit restores the payload into a freshly
  allocated page.  Round-trips are bit-exact (tested).
- **Pinning**: sessions ``pin()`` their conversation prefix so
  multi-turn chats never re-prefill history; pinned nodes are exempt
  from offload AND eviction.  ``unpin`` of an unknown/already-released
  pin id raises.
- **Invalidation**: cached KV is a function of the weights.  The
  engine stamps the tree with the serving version key; the decode loop
  invalidates the whole tree the first iteration it observes a
  hot-swap/rollback (and whenever the pools are reseeded).  A match
  against a node carrying a stale version tag raises
  ``StalePrefixError`` — that is a correctness bug, never a fallback.

Thread-ownership: allocator- and pool-touching methods (``admit``,
``invalidate``, payload transport) run only on the engine's single
decode thread (or before it starts).  ``pin``/``unpin``/``stats`` are
client-thread-safe: they touch only tree bookkeeping under the lock.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Sequence, Tuple

from deeplearning4j_tpu_torch.generation.paged_cache import (
    PagedKVCache, PageExhaustedError,
)


class StalePrefixError(AssertionError):
    """A radix-tree match produced a node prefilled under DIFFERENT
    weights than the serving version — a stale hit would silently serve
    tokens conditioned on a dead model, so this is an assertion, not a
    recoverable miss."""


class PrefixCacheConfig:
    """Knobs for the persistent prefix cache (``GenerationEngine``
    accepts an instance — or ``True`` for these defaults — as its
    ``prefix_cache=`` argument)."""

    def __init__(self, host_budget_bytes: int = 64 << 20):
        if host_budget_bytes < 0:
            raise ValueError(
                f"host_budget_bytes={host_budget_bytes} must be >= 0")
        self.host_budget_bytes = int(host_budget_bytes)


class _Node:
    """One ``page_size``-token chunk of some cached prompt chain."""

    __slots__ = ("chunk", "parent", "children", "page", "host", "pins",
                 "last_use", "version", "depth")

    def __init__(self, chunk: Tuple[int, ...], parent: "Optional[_Node]",
                 page: Optional[int], version: str, depth: int):
        self.chunk = chunk
        self.parent = parent
        self.children: "Dict[Tuple[int, ...], _Node]" = {}
        self.page = page          # device page id, or None when offloaded
        self.host = None          # host payload pytree when offloaded
        self.pins = 0
        self.last_use = 0
        self.version = version
        self.depth = depth


class AdmitResult:
    """What one cache-aware admission decided (scheduler stores it on
    the request so a failed prefill can unwind its created nodes)."""

    __slots__ = ("pages", "shared_len", "created", "restored_pages",
                 "offloaded_pages")

    def __init__(self, pages: List[int], shared_len: int,
                 created: List[_Node], restored_pages: int,
                 offloaded_pages: int):
        self.pages = pages
        self.shared_len = shared_len
        self.created = created
        self.restored_pages = restored_pages
        self.offloaded_pages = offloaded_pages


class PrefixCache:
    """See module docstring.  ``transport`` must expose
    ``cache_read_page(page) -> host payload`` and
    ``cache_write_page(page, payload)`` over the live pools (the engine
    wires its page transport; unit tests pass a numpy one);
    without a transport (or a known ``page_bytes``) the host tier is
    disabled and evictions drop pages outright."""

    def __init__(self, cache: PagedKVCache, *,
                 host_budget_bytes: int = 64 << 20,
                 transport=None, page_bytes: Optional[int] = None,
                 metrics=None):
        self.cache = cache
        self.page_size = cache.page_size
        self.host_budget_bytes = int(host_budget_bytes)
        self.transport = transport
        self.page_bytes = page_bytes
        self.metrics = metrics
        self.version: str = ""
        self._lock = threading.RLock()
        self._root = _Node((), None, None, "", 0)
        self._all: "set[_Node]" = set()
        self._clock = 0
        self._pins: Dict[int, List[_Node]] = {}
        self._next_pin = 0
        # counters mirrored into stats()/metrics
        self.hits = 0
        self.misses = 0
        self.offload_total = 0
        self.restore_total = 0
        self.host_bytes = 0
        self.evictions: Dict[str, int] = {}

    # -------------------------------------------------------------- wiring
    def attach(self, transport, page_bytes: int) -> None:
        """Engine hookup: the pool transport and the host bytes one page
        costs (sum of per-layer K+V slice nbytes) for budget math."""
        with self._lock:
            self.transport = transport
            self.page_bytes = int(page_bytes)

    def set_version(self, tag: str) -> None:
        with self._lock:
            self.version = str(tag)

    # ------------------------------------------------------------ admission
    def admit(self, prompt: Sequence[int],
              max_new_tokens: int) -> AdmitResult:
        """Cache-aware admission: one transaction that matches the
        longest cached page-aligned prefix, refs it, evicts/offloads
        cold nodes to make room, restores offloaded hits, allocates the
        fresh remainder, and registers this prompt's new full pages as
        tree nodes.  Raises ``PageExhaustedError`` — with every taken
        ref unwound — when unpinned refcount-free nodes cannot yield
        enough room (the scheduler keeps the request queued)."""
        with self._lock:
            prompt = [int(t) for t in prompt]
            occupancy = len(prompt) + max(1, int(max_new_tokens)) - 1
            total = self.cache.pages_needed(occupancy)
            if total > self.cache.pages_per_slot:
                raise ValueError(
                    f"request needs {total} pages "
                    f"({len(prompt)} prompt + {max_new_tokens} new tokens) "
                    f"but the block table holds {self.cache.pages_per_slot} "
                    f"(max_context={self.cache.max_context})")
            # longest cached page-aligned prefix, capped so at least ONE
            # prompt token is left to prefill (its logits seed sampling)
            matched = self._match(prompt, (len(prompt) - 1) // self.page_size)
            # refs FIRST: a matched resident page must be un-evictable
            # before any room-making below can consider it.  A ref only
            # exists for RESIDENT matches — a host-tier match has no
            # page yet — so every matched node also takes a temporary
            # admission pin: pins exclude a node from _make_room's
            # victim set AND from _drop_host_leaf, which could otherwise
            # drop a cold matched host node (detaching it from the tree
            # and nulling the payload the restore loop is about to
            # write back).
            for n in matched:
                if n.page is not None:
                    self.cache.ref(n.page)
                n.pins += 1
            to_restore = [n for n in matched if n.page is None]
            fresh_count = total - len(matched)
            offload_before = self.offload_total
            try:
                self._make_room(fresh_count + len(to_restore))
            except PageExhaustedError:
                for n in matched:       # unwind: request refs and the
                    if n.page is not None:   # admission pins — the
                        self.cache.free([n.page])  # tree's ref stays
                    n.pins -= 1
                raise
            # restore offloaded hits into fresh device pages (payload
            # written through the transport NOW — admit runs on the
            # decode thread, which owns the pools)
            for n in to_restore:
                page = self.cache.alloc(1)[0]   # tree's ref
                self.cache.ref(page)            # this request's ref
                self.transport.cache_write_page(page, n.host)
                n.page = page
                n.host = None
                self.host_bytes -= self.page_bytes
                self.restore_total += 1
                if self.metrics is not None:
                    self.metrics.prefix_cache_restores.inc()
            for n in matched:   # restore done: every matched node is
                n.pins -= 1     # resident + request-ref'd, so the
                                # admission pins have done their job
            fresh = self.cache.alloc(fresh_count)
            pages = [n.page for n in matched] + fresh
            # register this request's freshly prefilled full prompt
            # pages as new tree nodes (tree takes its own ref on each)
            created: List[_Node] = []
            parent = matched[-1] if matched else self._root
            for i in range(len(matched), len(prompt) // self.page_size):
                chunk = tuple(prompt[i * self.page_size:
                                     (i + 1) * self.page_size])
                existing = parent.children.get(chunk)
                if existing is not None:
                    # a node deeper than the match cap (the last prompt
                    # token always prefills, so a fully-paged prompt can
                    # out-run its own match): keep the cached node — its
                    # KV is the same deterministic function of the chain
                    # — and leave this request's fresh page private
                    parent = existing
                    continue
                node = _Node(chunk, parent, pages[i], self.version,
                             parent.depth + 1)
                self.cache.ref(pages[i])
                parent.children[chunk] = node
                self._all.add(node)
                created.append(node)
                parent = node
            self._clock += 1
            for n in matched + created:
                n.last_use = self._clock
            self.cache.shared_pages += len(matched)
            self.cache.fresh_pages += fresh_count
            if matched:
                self.hits += 1
            else:
                self.misses += 1
            if self.metrics is not None:
                (self.metrics.prefix_cache_hits if matched
                 else self.metrics.prefix_cache_misses).inc()
            return AdmitResult(pages, len(matched) * self.page_size,
                               created, len(to_restore),
                               self.offload_total - offload_before)

    def _match(self, prompt: List[int], max_pages: int) -> List[_Node]:
        # private helpers re-take the RLock their public callers already
        # hold: free (reentrant) and keeps the lock discipline checkable
        with self._lock:
            node, matched = self._root, []
            for i in range(max_pages):
                child = node.children.get(
                    tuple(prompt[i * self.page_size:
                                 (i + 1) * self.page_size]))
                if child is None:
                    break
                if child.version != self.version:
                    raise StalePrefixError(
                        f"radix node prefilled under version "
                        f"{child.version!r} matched while serving "
                        f"{self.version!r} — invalidation on swap failed")
                matched.append(child)
                node = child
            return matched

    # ------------------------------------------------------------- eviction
    def _tree_only(self, node: _Node) -> bool:
        """True when the tree's own ref is the page's ONLY ref (no
        in-flight request shares it)."""
        return (node.page is not None
                and self.cache.refcount(node.page) == 1)

    def _make_room(self, needed: int) -> None:
        """Free device pages until ``needed`` fit, spilling victims to
        the host tier when the budget allows, dropping childless ones
        otherwise.  Never touches pinned nodes or pages an in-flight
        request still references."""
        with self._lock:
            while self.cache.free_pages < needed:
                victims = [n for n in self._all
                           if self._tree_only(n) and n.pins == 0]
                if not victims:
                    raise PageExhaustedError(
                        f"need {needed} pages, {self.cache.free_pages} "
                        f"free and no unpinned refcount-free cache node "
                        f"to evict")
                victim = min(victims,
                             key=lambda n: (n.last_use, -n.depth))
                if self._host_has_room():
                    self._offload(victim)
                else:
                    # dropping an interior node would orphan reachable
                    # descendants; walk down to the coldest childless one
                    droppable = [n for n in victims if not n.children]
                    if not droppable:
                        # resident interiors whose children are host-only:
                        # clear cold host leaves first, then loop
                        if not self._drop_host_leaf("capacity"):
                            raise PageExhaustedError(
                                f"need {needed} pages, "
                                f"{self.cache.free_pages} free and every "
                                "droppable node is pinned or in flight")
                        continue
                    self._drop(min(droppable,
                                   key=lambda n: (n.last_use, -n.depth)),
                               "capacity")

    def _host_has_room(self) -> bool:
        with self._lock:
            if self.transport is None or not self.page_bytes:
                return False
            while (self.host_bytes + self.page_bytes
                   > self.host_budget_bytes):
                if not self._drop_host_leaf("host_capacity"):
                    return False
            return True

    def _offload(self, node: _Node) -> None:
        """Device → host: copy the page slice out through the transport,
        free the device page (the tree's ref), keep the node."""
        with self._lock:
            node.host = self.transport.cache_read_page(node.page)
            self.cache.free([node.page])
            node.page = None
            self.host_bytes += self.page_bytes
            self.offload_total += 1
            if self.metrics is not None:
                self.metrics.prefix_cache_offloads.inc()

    def _drop_host_leaf(self, reason: str) -> bool:
        """Evict the coldest childless host-tier node; returns False
        when none exists (every host node is pinned or interior)."""
        with self._lock:
            leaves = [n for n in self._all
                      if n.host is not None and n.pins == 0
                      and not n.children]
            if not leaves:
                return False
            self._drop(min(leaves, key=lambda n: n.last_use), reason)
            return True

    def _drop(self, node: _Node, reason: str) -> None:
        """Remove one childless node entirely (device page freed or host
        bytes returned)."""
        with self._lock:
            if node.children:
                raise AssertionError(
                    "dropping an interior radix node would orphan its "
                    "children")
            if node.page is not None:
                self.cache.free([node.page])
            if node.host is not None:
                self.host_bytes -= self.page_bytes or 0
            node.parent.children.pop(node.chunk, None)
            self._all.discard(node)
            self.evictions[reason] = self.evictions.get(reason, 0) + 1
            if self.metrics is not None:
                self.metrics.prefix_cache_evictions.inc(reason=reason)

    def forget(self, result: AdmitResult) -> None:
        """Unwind the nodes one failed admission created: its prefill
        never wrote them, so a later match would serve garbage.  Runs
        BEFORE the scheduler frees the request's pages (the tree refs
        dropped here are the nodes' own)."""
        with self._lock:
            for node in reversed(result.created):
                if node.chunk in node.parent.children:
                    self._drop(node, "abort")

    # ------------------------------------------------------------- pinning
    def pin(self, prompt: Sequence[int]) -> int:
        """Pin every currently-cached page of ``prompt``'s prefix
        against offload and eviction; returns a pin id for ``unpin``.
        Multi-turn sessions pin their history after each turn so the
        next turn's prefill only ever covers the new tokens."""
        with self._lock:
            prompt = [int(t) for t in prompt]
            nodes = self._match(prompt, len(prompt) // self.page_size)
            for n in nodes:
                n.pins += 1
            self._clock += 1
            for n in nodes:
                n.last_use = self._clock
            pin_id = self._next_pin
            self._next_pin += 1
            self._pins[pin_id] = nodes
            return pin_id

    def unpin(self, pin_id: int) -> None:
        """Release one pin.  Unknown or already-released ids raise
        ``KeyError`` — a double unpin means the session's refcounting
        is broken and silently ignoring it would mask real leaks."""
        with self._lock:
            nodes = self._pins.pop(pin_id)   # KeyError on double unpin
            for n in nodes:
                if n.pins < 1:
                    raise AssertionError(
                        f"pin underflow on node depth={n.depth}")
                n.pins -= 1

    def pinned_pages(self) -> int:
        with self._lock:
            return sum(1 for n in self._all if n.pins > 0)

    # -------------------------------------------------------- invalidation
    def invalidate(self, reason: str) -> int:
        """Drop the WHOLE tree (cached KV is a function of the weights
        and of the live pools): every tree-held device ref is freed —
        pages an in-flight request still shares survive under the
        request's own refs — the host tier is emptied, and existing
        pins go stale (their one legal ``unpin`` still works).
        Returns the number of nodes invalidated."""
        with self._lock:
            count = len(self._all)
            for node in self._all:
                if node.page is not None:
                    self.cache.free([node.page])
                    node.page = None
                node.host = None
            self._all.clear()
            self._root.children.clear()
            self.host_bytes = 0
            for pid in self._pins:
                self._pins[pid] = []
            if count:
                self.evictions[reason] = (self.evictions.get(reason, 0)
                                          + count)
                if self.metrics is not None:
                    self.metrics.prefix_cache_evictions.inc(count,
                                                            reason=reason)
            return count

    # ---------------------------------------------------------------- stats
    def resident_pages(self) -> int:
        with self._lock:
            return sum(1 for n in self._all if n.page is not None)

    def host_pages(self) -> int:
        with self._lock:
            return sum(1 for n in self._all if n.host is not None)

    def stats(self) -> dict:
        with self._lock:
            total = self.hits + self.misses
            return {
                "version": self.version,
                "nodes": len(self._all),
                "resident_pages": self.resident_pages(),
                "host_pages": self.host_pages(),
                "host_tier_bytes": self.host_bytes,
                "host_budget_bytes": self.host_budget_bytes,
                "pinned_pages": self.pinned_pages(),
                "pins_open": sum(1 for v in self._pins.values() if v),
                "hits": self.hits,
                "misses": self.misses,
                "hit_rate": round(self.hits / total, 4) if total else 0.0,
                "offload_total": self.offload_total,
                "restore_total": self.restore_total,
                "evictions_total": dict(self.evictions),
            }
