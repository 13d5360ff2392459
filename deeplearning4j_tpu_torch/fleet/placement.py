"""Placement policy core for the serving-fleet router: pure scoring math.

STDLIB ONLY on purpose — no package imports at all.  The router's
placement decision must be simulatable without jax, numpy, or even the
rest of this package: ``scripts/ci_checks.py`` gate 6 loads THIS FILE by
path (the same pattern ``check_bench_regression.py`` uses for
``observability/regression.py``) and runs ``placement_selftest()`` as a
millisecond-fast pre-test gate.  ``fleet/router.py`` builds the live
router (handles, retries, metrics, spans) on top of these primitives.

The policy, in order:

1. **canary split** — when a traffic split is armed (fleet rollout's
   canary phase), a seeded per-request coin sends that fraction of
   placements to the canary replica.  Seeded means deterministic: the
   same seed and request sequence reproduce the same split, exactly like
   ``ServingEngine.start_canary``'s seeded router.
2. **sticky session** — a session pinned to a live replica keeps landing
   there (its prefix pages are pinned in that replica's radix tree);
   a pin to a drained/dead replica falls through to scoring so the
   caller can re-pin on the survivor.
3. **prefix-cache affinity** — each replica is scored by the longest
   expected radix-tree prefix match, in PAGES, exactly how the engine's
   admission prices a hit: a prompt whose first ``shared_len`` tokens
   are already resident costs ``ceil((len - shared)/page)`` instead of
   ``ceil(len/page)``, so the score IS the pages saved
   (``shared_len // page_size``).  The router cannot see the remote
   radix tree itself, so it keeps a **shadow index** per replica — the
   page-aligned chunk paths of every prompt it placed there — validated
   against the replica's PUBLISHED tree version tag: a hot-swap or
   restart bumps the version and the shadow resets to zero, never
   predicting hits against an invalidated tree.  An overloaded replica
   (active + queued ≥ ``overload_factor`` × slots) forfeits its
   affinity score: a cache hit is not worth an unbounded queue.
4. **least-loaded fallback / tiebreak** — lowest ``active + queued``,
   then most free pages, then a SEEDED tie rank (stable across
   processes: ``random.Random(str)`` hashes the string arithmetically,
   not via PYTHONHASHSEED), so placement under ties is deterministic
   for a given seed and request index.
"""

from __future__ import annotations

import random
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

# placement reasons, in decision order
CANARY = "canary"
PINNED = "pinned"
AFFINITY = "affinity"
LEAST_LOADED = "least_loaded"

DEFAULT_OVERLOAD_FACTOR = 2.0


def tie_rank(seed: int, n: int, replica_id: str) -> float:
    """Deterministic per-(request, replica) tie rank in [0, 1): stable
    across processes and dict orderings (str seeding is arithmetic)."""
    return random.Random(f"{seed}:{n}:{replica_id}").random()


def canary_coin(seed: int, n: int) -> float:
    """The seeded traffic-split coin for request index ``n``."""
    return random.Random(f"canary:{seed}:{n}").random()


class ShadowIndex:
    """Router-side approximation of one replica's radix tree.

    Children keyed by exact ``page_size``-token chunk tuples — the same
    chain-identity rule as ``generation/prefix_cache.py`` (no hashing,
    no partial-chunk nodes).  Inserts record where the router SENT
    prompts; ``matched_pages`` predicts what a resubmitted prefix would
    find resident.  It is a hint, not a ledger: when the replica's
    published tree version moves (hot-swap, rollback, restart, pool
    reset) the whole shadow drops, and when the node budget fills the
    shadow clears rather than evicting piecemeal — a cold mis-predict
    costs one suboptimal placement, never a wrong answer.
    """

    __slots__ = ("page_size", "max_pages", "version", "_root", "pages")

    def __init__(self, page_size: int, max_pages: int = 8192):
        if page_size < 1:
            raise ValueError(f"page_size must be >= 1, got {page_size}")
        self.page_size = int(page_size)
        self.max_pages = int(max_pages)
        self.version: Optional[str] = None
        self._root: Dict[Tuple[int, ...], dict] = {}
        self.pages = 0

    def observe_version(self, version: Optional[str]) -> bool:
        """Sync with the replica's published tree version; returns True
        when the shadow was reset (version moved)."""
        if version == self.version:
            return False
        self.version = version
        self.clear()
        return True

    def clear(self) -> None:
        self._root = {}
        self.pages = 0

    def _chunks(self, tokens: Sequence[int]) -> List[Tuple[int, ...]]:
        p = self.page_size
        whole = (len(tokens) // p) * p
        return [tuple(int(t) for t in tokens[i:i + p])
                for i in range(0, whole, p)]

    def insert(self, tokens: Sequence[int]) -> int:
        """Record a placed prompt; returns the number of NEW pages."""
        node, added = self._root, 0
        for chunk in self._chunks(tokens):
            child = node.get(chunk)
            if child is None:
                if self.pages >= self.max_pages:
                    # budget full: restart the hint rather than evict —
                    # see class docstring
                    self.clear()
                    node = self._root
                child = node[chunk] = {}
                self.pages += 1
                added += 1
            node = child
        return added

    def matched_pages(self, tokens: Sequence[int]) -> int:
        """Longest recorded prefix of ``tokens``, in whole pages."""
        node, n = self._root, 0
        for chunk in self._chunks(tokens):
            node = node.get(chunk)
            if node is None:
                break
            n += 1
        return n


class ReplicaView:
    """One routing-table row: everything placement needs to know about a
    replica, refreshed from the fleet aggregator's ``workers()`` table
    (load + cache version + health) and the router's own observations
    (attached handle, admin drain, observed death, local in-flight)."""

    __slots__ = ("replica_id", "healthy", "stale", "draining", "dead",
                 "slots", "active", "queued", "free_pages",
                 "cache_version", "shadow", "inflight")

    def __init__(self, replica_id: str, *, page_size: int = 16,
                 slots: int = 8, shadow_max_pages: int = 8192):
        self.replica_id = str(replica_id)
        self.healthy: Optional[bool] = None   # None = not reported
        self.stale = False
        self.draining = False                 # admin drain (rollout, ops)
        self.dead = False                     # router-observed transport death
        self.slots = int(slots)
        self.active = 0
        self.queued = 0
        self.free_pages = 0
        self.cache_version: Optional[str] = None
        self.shadow = ShadowIndex(page_size, max_pages=shadow_max_pages)
        self.inflight = 0                     # router-local, between snapshots

    @property
    def live(self) -> bool:
        return (not self.stale and not self.draining and not self.dead
                and self.healthy is not False)

    @property
    def load(self) -> int:
        """Active + queued work.  The published snapshot lags by the
        publish interval, so the router's own in-flight count floors it
        — a burst between snapshots must not pile onto one replica."""
        return max(self.active + self.queued, self.inflight)

    def as_dict(self) -> Dict[str, Any]:
        return {"replica": self.replica_id, "live": self.live,
                "healthy": self.healthy, "stale": self.stale,
                "draining": self.draining, "dead": self.dead,
                "slots": self.slots, "active": self.active,
                "queued": self.queued, "inflight": self.inflight,
                "free_pages": self.free_pages,
                "cache_version": self.cache_version,
                "shadow_pages": self.shadow.pages}


def live_views(views: Iterable[ReplicaView],
               exclude: Iterable[str] = ()) -> List[ReplicaView]:
    ex = set(exclude)
    return [v for v in views if v.live and v.replica_id not in ex]


def score(view: ReplicaView, prompt: Sequence[int], *,
          overload_factor: float = DEFAULT_OVERLOAD_FACTOR
          ) -> Dict[str, Any]:
    """One replica's placement score for one prompt (pages saved +
    load), with the overload forfeit applied (module docstring §3)."""
    pages = view.shadow.matched_pages(prompt)
    overloaded = view.load >= overload_factor * max(1, view.slots)
    return {"affinity_pages": 0 if overloaded else pages,
            "raw_affinity_pages": pages, "overloaded": overloaded,
            "load": view.load, "free_pages": view.free_pages}


def choose(views: Sequence[ReplicaView], prompt: Sequence[int], *,
           seed: int = 0, n: int = 0,
           session_replica: Optional[str] = None,
           split: Optional[Tuple[str, float, int]] = None,
           exclude: Iterable[str] = (),
           overload_factor: float = DEFAULT_OVERLOAD_FACTOR,
           policy: str = "affinity",
           ) -> Tuple[Optional[str], str, Dict[str, Dict[str, Any]]]:
    """The placement decision (module docstring).  Returns
    ``(replica_id, reason, scores)``; ``replica_id`` is None when no
    live candidate remains.  ``split`` is ``(canary_id, fraction,
    split_seed)``; ``policy="random"`` is the bench's seeded-random
    control arm (still health-gated, no affinity/load scoring)."""
    cands = live_views(views, exclude)
    scores = {v.replica_id: score(v, prompt,
                                  overload_factor=overload_factor)
              for v in cands}
    if not cands:
        return None, "no_live_replica", scores
    by_id = {v.replica_id: v for v in cands}

    if split is not None:
        canary_id, fraction, split_seed = split
        if canary_id in by_id and canary_coin(split_seed, n) < fraction:
            return canary_id, CANARY, scores

    if session_replica is not None and session_replica in by_id:
        return session_replica, PINNED, scores

    if policy == "random":
        order = sorted(by_id)
        return order[int(tie_rank(seed, n, "random") * len(order))
                     % len(order)], "random", scores

    def key(v: ReplicaView):
        s = scores[v.replica_id]
        return (-s["affinity_pages"], s["load"], -s["free_pages"],
                tie_rank(seed, n, v.replica_id), v.replica_id)

    best = min(cands, key=key)
    reason = (AFFINITY if scores[best.replica_id]["affinity_pages"] > 0
              else LEAST_LOADED)
    return best.replica_id, reason, scores


# ------------------------------------------------------------- self-test
def _sim_fleet(n: int, page_size: int = 4, slots: int = 4
               ) -> List[ReplicaView]:
    out = []
    for i in range(n):
        v = ReplicaView(f"r{i}", page_size=page_size, slots=slots)
        v.healthy, v.free_pages = True, 64
        v.cache_version = "v1"
        v.shadow.observe_version("v1")
        out.append(v)
    return out


def _sim_workload(rng: random.Random, sessions: int, requests: int,
                  page_size: int) -> List[List[int]]:
    """Session-heavy prompts: each session reuses a long shared prefix
    (the multi-turn shape the prefix cache exists for)."""
    prefixes = [[rng.randrange(200) for _ in range(4 * page_size)]
                for _ in range(sessions)]
    return [prefixes[rng.randrange(sessions)]
            + [rng.randrange(200) for _ in range(page_size)]
            for _ in range(requests)]


def _sim_run(policy: str, seed: int, page_size: int = 4
             ) -> Tuple[List[str], float]:
    """Route a seeded session workload over a 4-replica fleet whose
    per-replica caches are modeled by the shadow indexes themselves
    (insert-on-place ≙ the replica retaining the prompt's pages);
    returns (placements, fleet hit rate in pages)."""
    views = _sim_fleet(4, page_size=page_size)
    rng = random.Random(1234)
    prompts = _sim_workload(rng, sessions=6, requests=120, page_size=page_size)
    chosen_seq: List[str] = []
    hit_pages = total_pages = 0
    for n, prompt in enumerate(prompts):
        rid, _, scores = choose(views, prompt, seed=seed, n=n, policy=policy)
        assert rid is not None
        v = next(x for x in views if x.replica_id == rid)
        hit_pages += v.shadow.matched_pages(prompt)
        total_pages += len(prompt) // page_size
        v.shadow.insert(prompt)
        chosen_seq.append(rid)
    return chosen_seq, hit_pages / max(1, total_pages)


def placement_selftest(verbose: bool = False) -> int:
    """CI gate 6: the placement policy's behavioral contract, simulated
    with zero processes and zero jax.  Returns 0 on pass, 1 on fail."""
    failures: List[str] = []

    def check(name: str, ok: bool, detail: str = "") -> None:
        if verbose or not ok:
            print(f"placement_selftest: {'ok  ' if ok else 'FAIL'} {name}"
                  + (f" ({detail})" if detail else ""))
        if not ok:
            failures.append(name)

    page = 4
    # 1. deterministic under seeded ties: identical empty fleets, twice
    a, _ = _sim_run("affinity", seed=7, page_size=page)
    b, _ = _sim_run("affinity", seed=7, page_size=page)
    check("deterministic_same_seed", a == b)
    c, _ = _sim_run("affinity", seed=8, page_size=page)
    check("seed_changes_tiebreaks", a != c,
          "different seeds must break fresh-fleet ties differently")

    # 2. affinity: a session keeps landing on the replica holding it,
    #    and the fleet hit rate beats seeded-random placement
    _, hit_aff = _sim_run("affinity", seed=7, page_size=page)
    _, hit_rand = _sim_run("random", seed=7, page_size=page)
    check("affinity_beats_random", hit_aff > hit_rand,
          f"affinity {hit_aff:.3f} vs random {hit_rand:.3f}")
    views = _sim_fleet(2, page_size=page)
    prompt = list(range(3 * page))
    first, _, _ = choose(views, prompt, n=0)
    next(v for v in views if v.replica_id == first).shadow.insert(prompt)
    again, reason, scores = choose(views, prompt, n=1)
    check("session_sticks_via_affinity",
          again == first and reason == AFFINITY
          and scores[first]["affinity_pages"] == 3, f"{reason} {scores}")

    # 3. version tag invalidation: a swap/restart drops the shadow
    v0 = next(v for v in views if v.replica_id == first)
    v0.shadow.observe_version("v2")
    _, reason, scores = choose(views, prompt, n=2)
    check("version_bump_resets_shadow",
          scores[first]["affinity_pages"] == 0 and reason == LEAST_LOADED,
          f"{reason} {scores}")

    # 4. membership gating: stale / unhealthy / draining / dead replicas
    #    never take placements; an empty fleet says so
    views = _sim_fleet(3, page_size=page)
    views[0].stale = True
    views[1].healthy = False
    rid, reason, _ = choose(views, prompt, n=0)
    check("drained_excluded", rid == "r2", f"{rid} ({reason})")
    views[2].dead = True
    rid, reason, _ = choose(views, prompt, n=1)
    check("empty_fleet_reported",
          rid is None and reason == "no_live_replica")
    views[2].dead, views[2].draining = False, True
    rid, _, _ = choose(views, prompt, n=2)
    check("admin_drain_excluded", rid is None)

    # 5. least-loaded fallback + overload forfeits affinity
    views = _sim_fleet(2, page_size=page)
    views[0].shadow.insert(prompt)
    views[0].active, views[0].queued = 6, 3   # 9 >= 2.0 * 4 slots
    rid, reason, scores = choose(views, prompt, n=0)
    check("overload_forfeits_affinity",
          rid == "r1" and reason == LEAST_LOADED
          and scores["r0"]["overloaded"]
          and scores["r0"]["raw_affinity_pages"] == 3,
          f"{rid} {reason} {scores}")

    # 6. seeded canary split: deterministic and near the fraction (the
    #    split share = placements WON BY THE COIN; the canary can still
    #    win ordinary least-loaded ties on top of it)
    views = _sim_fleet(4, page_size=page)
    picks = [choose(views, prompt, n=n, split=("r2", 0.25, 5))
             for n in range(400)]
    share = sum(1 for _, reason, _ in picks
                if reason == CANARY) / len(picks)
    check("canary_split_near_fraction", 0.15 < share < 0.35,
          f"share {share:.3f}")
    picks2 = [choose(views, prompt, n=n, split=("r2", 0.25, 5))
              for n in range(400)]
    check("canary_split_deterministic",
          [p[0] for p in picks] == [p[0] for p in picks2])

    # 7. sticky pin honored while live, falls through when drained
    views = _sim_fleet(3, page_size=page)
    rid, reason, _ = choose(views, prompt, n=0, session_replica="r1")
    check("pin_honored", rid == "r1" and reason == PINNED)
    views[1].dead = True
    rid, reason, _ = choose(views, prompt, n=1, session_replica="r1")
    check("pin_falls_through_on_death",
          rid in ("r0", "r2") and reason != PINNED, f"{rid} {reason}")

    if failures:
        print(f"placement_selftest: FAIL ({len(failures)}): "
              + ", ".join(failures))
        return 1
    if verbose:
        print("placement_selftest: all checks passed")
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(placement_selftest(verbose=True))
