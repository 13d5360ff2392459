"""Bench regression sentinel: compare a fresh ``bench_full.json`` against a
committed baseline with per-metric direction + tolerance rules.

Copied from ``deeplearning4j_tpu/observability/regression.py`` (stdlib
only).  ``KERNEL_TRUST_RULES`` names the port's kernel registry
(``observability/kerneldiff.py`` ``KERNELS``): the port's sweep is
compared with a baseline the caller wrote (``kerneldiff --out``), never
with the JAX package's ``kernel_trust.json``.

Until now the perf trajectory was advisory: ``bench.py`` wrote numbers, a
human eyeballed them.  This module gives it teeth — a rule says which
field of which bench entry matters, which DIRECTION is good, and how much
relative slack the (noisy, CPU-jittered) measurement gets before a change
counts as a regression.  ``scripts/check_bench_regression.py`` wraps it as
a CI gate: exit 0 clean, exit 1 on any regression.

STDLIB ONLY on purpose: the checker script must run in milliseconds with
no jax import, and the module is imported by file path from ``scripts/``
(same pattern as ``check_metrics_docs.py``).

Rule addressing: bench entries live in ``doc["all"]``, each with a
``metric`` name like ``"Decode tokens/sec (d256 L4, b4, ...)"`` — the
part after `` (`` encodes the config and changes across platforms, so
rules match on the PREFIX before it.  ``field`` is a dotted path inside
the entry (``"value"``, ``"variants.gqa2_rolling.tokens_per_sec"``).
With ``scope="doc"`` the rule skips the entry lookup and resolves
``field`` from the DOCUMENT root instead — how the memory sentinels
address ``observability.memory.sentinels.*`` (the ``metric`` string is
then only the display name).
"""

from __future__ import annotations

import json
from typing import Any, Dict, List, Optional

HIGHER = "higher"   # bigger is better (throughput)
LOWER = "lower"     # smaller is better (latency, step time)


class Rule:
    """One metric's regression policy."""

    __slots__ = ("metric", "field", "direction", "tolerance", "required",
                 "scope")

    def __init__(self, metric: str, field: str = "value",
                 direction: str = HIGHER, tolerance: float = 0.15,
                 required: bool = True, scope: str = "all"):
        if direction not in (HIGHER, LOWER):
            raise ValueError(
                f"direction must be {HIGHER!r} or {LOWER!r}, got {direction!r}")
        if tolerance < 0:
            raise ValueError(f"tolerance must be >= 0, got {tolerance}")
        if scope not in ("all", "doc"):
            raise ValueError(f"scope must be 'all' or 'doc', got {scope!r}")
        self.metric = str(metric)
        self.field = str(field)
        self.direction = direction
        self.tolerance = float(tolerance)
        self.required = bool(required)
        self.scope = scope

    @property
    def key(self) -> str:
        return f"{self.metric} :: {self.field}"

    def to_dict(self) -> Dict[str, Any]:
        return {"metric": self.metric, "field": self.field,
                "direction": self.direction, "tolerance": self.tolerance,
                "required": self.required, "scope": self.scope}

    @staticmethod
    def from_dict(d: Dict[str, Any]) -> "Rule":
        unknown = set(d) - {"metric", "field", "direction", "tolerance",
                            "required", "scope"}
        if unknown:
            raise ValueError(f"unknown rule keys: {sorted(unknown)}")
        if "metric" not in d:
            raise ValueError(f"rule needs a 'metric': {d!r}")
        return Rule(d["metric"], d.get("field", "value"),
                    d.get("direction", HIGHER), d.get("tolerance", 0.15),
                    d.get("required", True), d.get("scope", "all"))


# The committed policy over bench_full.json.  Tolerances are wide (0.4)
# because the CPU bench's run-to-run spread reaches ~25% (bench.py
# SPREAD_THRESHOLD discussion); the sentinel is for collapses, not jitter.
DEFAULT_RULES: List[Rule] = [
    Rule("ResNet-50 images/sec/chip", tolerance=0.4),
    Rule("LeNet-MNIST train step time", direction=LOWER, tolerance=0.4),
    Rule("GravesLSTM char-LM throughput", tolerance=0.4),
    Rule("Transformer char-LM tokens/sec", tolerance=0.4),
    Rule("Decode tokens/sec", tolerance=0.4),
    Rule("Decode tokens/sec", field="variants.gqa2_rolling.tokens_per_sec",
         tolerance=0.4, required=False),
    # continuous-batching generation (bench_generation): the aggregate
    # 16-client decode throughput is the headline the paged-KV engine
    # exists for; the speedup-vs-single-stream ratio guards the batching
    # win itself (an aggregate that only tracks single-stream drift
    # would let the scheduler silently serialize); the exact zero rule
    # pins the decode-side AOT-warmup contract.
    Rule("Generation tokens/sec", tolerance=0.4),
    Rule("Generation tokens/sec", field="speedup_vs_single_stream",
         tolerance=0.4, required=False),
    Rule("Generation tokens/sec", field="p99_ttft_ms", direction=LOWER,
         tolerance=1.0, required=False),
    Rule("Generation tokens/sec", field="steady_state_compiles",
         direction=LOWER, tolerance=0.0, required=False),
    # persistent prefix cache: ttft_collapse_ok pins "a hit's
    # p99 TTFT is <= 0.3x a cold miss's" (1 = collapse held; direction=
    # higher + tolerance=0 means any drop to 0 regresses), and
    # hit_rate_nonzero pins "the steady state actually hits the cache" —
    # a change that silently stops matching (version-tag bug, tree never
    # populated) fails immediately rather than showing up as a slow
    # TTFT drift
    Rule("Generation tokens/sec", field="prefix_cache.ttft_collapse_ok",
         tolerance=0.0, required=False),
    Rule("Generation tokens/sec", field="prefix_cache.hit_rate_nonzero",
         tolerance=0.0, required=False),
    Rule("Generation tokens/sec",
         field="prefix_cache.steady_state_compiles",
         direction=LOWER, tolerance=0.0, required=False),
    # decode SLO attribution: the ITL histogram must stay
    # populated under the 16-client window, the per-phase breakdown must
    # keep reconciling with the decode loop's busy wall (within 10% —
    # phase_sum_ok pins it), and serializing a federated snapshot must
    # stay host-side only (publisher_host_sync_free: any new device
    # sync drops the sentinel to 0 and fails immediately)
    Rule("Generation tokens/sec", field="slo.itl_populated",
         tolerance=0.0, required=False),
    Rule("Generation tokens/sec", field="slo.phase_sum_ok",
         tolerance=0.0, required=False),
    Rule("Generation tokens/sec", field="slo.publisher_host_sync_free",
         tolerance=0.0, required=False),
    # fused paged decode: speedup_vs_gather pins the measured
    # fused-vs-gather-oracle throughput ratio on this container;
    # fused_no_slower (1 = the fused default is at least as fast) and
    # gather_share_collapsed (1 = the per-token decode-step cost the
    # gather used to pay has collapsed) are exact sentinels — a change
    # that silently routes decode back through the materialized gather
    # drops them to 0 and fails immediately; the exact-zero compile rule
    # pins the fused program set's AOT-warmup contract
    Rule("Generation tokens/sec", field="fused_decode.speedup_vs_gather",
         tolerance=0.4, required=False),
    Rule("Generation tokens/sec", field="fused_decode.fused_no_slower",
         tolerance=0.0, required=False),
    Rule("Generation tokens/sec",
         field="fused_decode.gather_share_collapsed",
         tolerance=0.0, required=False),
    Rule("Generation tokens/sec",
         field="fused_decode.steady_state_compiles",
         direction=LOWER, tolerance=0.0, required=False),
    Rule("Long-context train tokens/sec", tolerance=0.4),
    Rule("Serving rows/sec", tolerance=0.4),
    Rule("Serving rows/sec", field="p99_ms", direction=LOWER, tolerance=1.0,
         required=False),
    # zero-compile contract: the baseline is 0, so ANY steady-state
    # compile regresses regardless of tolerance (0 * (1+tol) == 0)
    Rule("Serving rows/sec", field="steady_state_compiles", direction=LOWER,
         tolerance=0.0, required=False),
    Rule("Checkpoint save throughput", tolerance=0.4),
    Rule("Elastic DP samples/sec", tolerance=0.4),
    Rule("Elastic DP samples/sec", field="degraded_vs_lockstep_speedup",
         tolerance=0.5, required=False),
    # stream-to-serving model freshness: seconds from a published event to
    # a swapped-in model serving it, under concurrent load (bench_online).
    # Smaller is better; tolerance is wide because the window includes
    # eval + canary + watch phases whose sleeps jitter on a loaded CPU.
    Rule("Online stream-to-serving freshness", direction=LOWER,
         tolerance=1.0),
    Rule("Online stream-to-serving freshness", field="promoted",
         tolerance=0.0, required=False),
    # stability engine (bench_stability): the guarded train step must not
    # drift slower — the device-side non-finite mask + loss scaling ride
    # inside the XLA program, so a step-time collapse here means the
    # guard fell off the fused path.  Recovery = poison onset -> guard
    # skips -> sentinel verdict -> checkpoint rewind -> training resumed;
    # wide tolerance because the drill includes checkpoint I/O.
    Rule("Stability guarded step", direction=LOWER, tolerance=0.4),
    Rule("Stability guarded step", field="recovery_ms", direction=LOWER,
         tolerance=1.0, required=False),
    # training introspection (bench_introspection): the stats-on fit step
    # must not drift slower — the per-layer reductions are fused into the
    # XLA step and the harvest is one batched transfer per 10th step, so
    # a collapse here means the collection fell off the fused path (or a
    # per-report host-sync storm came back).
    Rule("Introspected train step", direction=LOWER, tolerance=0.4),
    # precision ledger (bench_numerics): the numerics-on fit step must
    # not drift slower (the range stats ride inside the XLA step like
    # the introspection reductions); ledger_overhead_ok pins the <5%
    # overhead contract itself (1 = within budget, direction=higher +
    # tolerance=0 means any drop to 0 regresses), and the exact-zero
    # rule pins "enabling the ledger adds NO steady-state recompiles"
    Rule("Numerics-ledger train step", direction=LOWER, tolerance=0.4),
    Rule("Numerics-ledger train step", field="ledger_overhead_ok",
         tolerance=0.0, required=False),
    Rule("Numerics-ledger train step", field="steady_state_compiles",
         direction=LOWER, tolerance=0.0, required=False),
    # fleet telemetry plane (bench_fleet): publish->ingest lag
    # across the two-process federation must stay bounded (lower; wide
    # tolerance — the HTTP long-poll handoff jitters on a loaded CPU),
    # publisher_overhead_ok pins the <2%-on-the-train-step contract, and
    # the kill/restart drill's verdicts must stay 1: the dead worker is
    # detected AND named, and the restarted epoch merges with no
    # double-count and no reset-to-zero
    Rule("Fleet telemetry ingest lag", direction=LOWER, tolerance=3.0),
    Rule("Fleet telemetry ingest lag", field="publisher_overhead_ok",
         tolerance=0.0, required=False),
    Rule("Fleet telemetry ingest lag", field="federation.stale_detected",
         tolerance=0.0, required=False),
    Rule("Fleet telemetry ingest lag",
         field="federation.stale_worker_named",
         tolerance=0.0, required=False),
    Rule("Fleet telemetry ingest lag",
         field="federation.restart_merge_ok",
         tolerance=0.0, required=False),
    # serving fleet (bench_fleet_serving): the 4-replica
    # aggregate is the headline; scaling_4x_ok pins the >=3.0x floor of
    # the 4-vs-1 aggregate (1 = floor held; direction=higher +
    # tolerance=0 means any drop to 0 regresses) with the raw speedup
    # tracked alongside; affinity_beats_random pins "cache-aware
    # placement finds more resident prefixes than the seeded-random
    # control"; zero_queued_errors pins the failover contract (a
    # SIGKILLed replica's queued requests land on survivors with no
    # client-visible error) and rejoin/rollback verdicts pin the
    # lifecycle halves; the exact-zero compile rule pins steady-state
    # traffic across the scaling+affinity arms (captured before the
    # kill drill — a restart legitimately re-runs its AOT warmup)
    Rule("Fleet serving tokens/sec", tolerance=0.4),
    Rule("Fleet serving tokens/sec", field="scaling.speedup_4x_vs_1",
         tolerance=0.4, required=False),
    Rule("Fleet serving tokens/sec", field="scaling.scaling_4x_ok",
         tolerance=0.0, required=False),
    Rule("Fleet serving tokens/sec", field="p99_ttft_ms",
         direction=LOWER, tolerance=1.0, required=False),
    Rule("Fleet serving tokens/sec",
         field="affinity.affinity_beats_random",
         tolerance=0.0, required=False),
    Rule("Fleet serving tokens/sec",
         field="failover.zero_queued_errors",
         tolerance=0.0, required=False),
    Rule("Fleet serving tokens/sec", field="failover.recovery_ms",
         direction=LOWER, tolerance=3.0, required=False),
    Rule("Fleet serving tokens/sec", field="failover.restart_rejoined",
         tolerance=0.0, required=False),
    Rule("Fleet serving tokens/sec", field="rollout.promoted",
         tolerance=0.0, required=False),
    Rule("Fleet serving tokens/sec", field="rollout.rolled_back_all",
         tolerance=0.0, required=False),
    Rule("Fleet serving tokens/sec", field="steady_state_compiles",
         direction=LOWER, tolerance=0.0, required=False),
    # memory & collective-communication sentinels (bench _memory_measure
    # -> observability.memory.sentinels): FLIPPED to the ZeRO baselines
    # by update sharding (arXiv 2004.13336) — the
    # sentinels now pin the SHARDED numbers: updater-state replication
    # ~1 (was K), params ~1, the window's collective/wire bytes in the
    # all-to-all + all-gather decomposition (at or below the old
    # all-reduce wire bytes), and per-device train-state bytes at the
    # sharded level.  direction=lower + tolerance=0 means "any increase
    # regresses" — a change that silently knocks the wrapper back to
    # replicated updater state fails the replication rule immediately.
    # Optional because the section needs the virtual mesh (subprocess,
    # like the elastic bench).
    Rule("Memory: updater replication (4-replica DP, ZeRO)", scope="doc",
         field="observability.memory.sentinels.updater_replication_factor",
         direction=LOWER, tolerance=0.0, required=False),
    Rule("Memory: param replication (4-replica DP, ZeRO)", scope="doc",
         field="observability.memory.sentinels.param_replication_factor",
         direction=LOWER, tolerance=0.0, required=False),
    Rule("Memory: collective bytes/step (4-replica DP, ZeRO)", scope="doc",
         field="observability.memory.sentinels.collective_bytes_per_step",
         direction=LOWER, tolerance=0.25, required=False),
    Rule("Memory: wire bytes/step (4-replica DP, ZeRO)", scope="doc",
         field="observability.memory.sentinels.wire_bytes_per_step",
         direction=LOWER, tolerance=0.25, required=False),
    Rule("Memory: per-device train bytes (4-replica DP, ZeRO)", scope="doc",
         field="observability.memory.sentinels.per_device_bytes",
         direction=LOWER, tolerance=0.25, required=False),
    # the ZeRO window's zero-steady-state-recompile contract: the
    # baseline is EXACTLY 0, so any steady-state compile of the sharded
    # window regresses regardless of tolerance (0 * (1+tol) == 0)
    Rule("Memory: ZeRO window steady-state recompiles", scope="doc",
         field=("observability.memory.sentinels"
                ".zero_steady_state_recompiles"),
         direction=LOWER, tolerance=0.0, required=False),
    # bench_zero: ZeRO step time must stay in the replicated band (the
    # sharded update + gather must not fall off the fused path), and the
    # per-device-bytes ratio guards the memory win itself (~(2+K)/(3K)
    # for adam; a ratio drifting toward 1 means the sharding fell off)
    Rule("ZeRO DP step time", direction=LOWER, tolerance=0.4),
    Rule("ZeRO DP step time", field="per_device_bytes_ratio",
         direction=LOWER, tolerance=0.1, required=False),
]


# The policy over a baseline written by the port's own sweep
# (``python -m deeplearning4j_tpu_torch.observability.kerneldiff --out
# PATH``, then ``--baseline PATH``).  Worst-config max-rel-error per
# kernel: direction=lower with a 1.0 tolerance — a doubling of any
# kernel's divergence regresses.  The doc-scope rule pins "no config
# anywhere fails its budget" exactly (baseline 0, tolerance 0).
KERNEL_TRUST_RULES: List[Rule] = [
    Rule("Kernel max rel error (flash_attention_fwd)", direction=LOWER,
         tolerance=1.0),
    Rule("Kernel max rel error (paged_decode_attention)", direction=LOWER,
         tolerance=1.0),
    Rule("Kernel max rel error (dropout_residual_norm)", direction=LOWER,
         tolerance=1.0),
    Rule("Kernel max rel error (lrn_fwd)", direction=LOWER,
         tolerance=1.0, required=False),
    Rule("Kernel max rel error (batch_norm_inference)", direction=LOWER,
         tolerance=1.0, required=False),
    Rule("Kernel max rel error (batch_norm_train_fwd)", direction=LOWER,
         tolerance=1.0, required=False),
    Rule("Kernel trust failing configs", scope="doc",
         field="summary.failing_configs", direction=LOWER, tolerance=0.0),
]


def load_rules(path: str) -> List[Rule]:
    """Rules from a JSON file: a list of rule dicts (see Rule.from_dict)."""
    with open(path) as f:
        data = json.load(f)
    if not isinstance(data, list):
        raise ValueError(f"{path}: rules file must be a JSON list")
    return [Rule.from_dict(d) for d in data]


# ------------------------------------------------------------- extraction
def _find_entry(doc: Dict[str, Any], metric_prefix: str) -> Optional[Dict]:
    for entry in doc.get("all", []) or []:
        if str(entry.get("metric", "")).startswith(metric_prefix):
            return entry
    return None


def _get_field(entry: Dict[str, Any], dotted: str) -> Optional[float]:
    cur: Any = entry
    for part in dotted.split("."):
        if not isinstance(cur, dict) or part not in cur:
            return None
        cur = cur[part]
    if isinstance(cur, bool) or not isinstance(cur, (int, float)):
        return None
    return float(cur)


def extract(doc: Dict[str, Any], rule: Rule) -> Optional[float]:
    if rule.scope == "doc":
        return _get_field(doc, rule.field)
    entry = _find_entry(doc, rule.metric)
    if entry is None:
        return None
    return _get_field(entry, rule.field)


# -------------------------------------------------------------- comparison
class Verdict:
    """One rule's outcome: ``status`` in {"ok", "improved", "regressed",
    "missing", "no_baseline"}."""

    __slots__ = ("rule", "status", "baseline", "fresh", "limit", "detail")

    def __init__(self, rule: Rule, status: str, baseline, fresh, limit,
                 detail: str):
        self.rule = rule
        self.status = status
        self.baseline = baseline
        self.fresh = fresh
        self.limit = limit
        self.detail = detail

    def to_dict(self) -> Dict[str, Any]:
        return {"metric": self.rule.metric, "field": self.rule.field,
                "direction": self.rule.direction,
                "tolerance": self.rule.tolerance, "status": self.status,
                "baseline": self.baseline, "fresh": self.fresh,
                "limit": self.limit, "detail": self.detail}


class Report:
    def __init__(self, verdicts: List[Verdict]):
        self.verdicts = verdicts

    @property
    def regressions(self) -> List[Verdict]:
        return [v for v in self.verdicts if v.status == "regressed"]

    @property
    def exit_code(self) -> int:
        return 1 if self.regressions else 0

    def to_dict(self) -> Dict[str, Any]:
        return {"regressed": len(self.regressions),
                "checked": len(self.verdicts),
                "verdicts": [v.to_dict() for v in self.verdicts]}

    def format(self) -> str:
        lines = []
        for v in self.verdicts:
            mark = {"ok": "ok       ", "improved": "improved ",
                    "regressed": "REGRESSED", "missing": "missing  ",
                    "no_baseline": "skipped  "}[v.status]
            lines.append(f"{mark} {v.rule.key}: {v.detail}")
        n = len(self.regressions)
        lines.append(f"{'FAIL' if n else 'PASS'}: {n} regression(s) in "
                     f"{len(self.verdicts)} checked rule(s)")
        return "\n".join(lines)


def compare(baseline: Dict[str, Any], fresh: Dict[str, Any],
            rules: Optional[List[Rule]] = None) -> Report:
    """Evaluate every rule: a fresh value past ``baseline * (1 ± tol)``
    in the BAD direction regresses; a missing fresh value regresses when
    the rule is ``required``; a MISSING baseline skips the rule
    (``no_baseline`` — there is nothing to hold the line against).  A
    zero baseline is enforced, not skipped: with ``direction=lower`` and
    ``tolerance=0`` it means "any increase regresses" — the
    steady-state-compiles contract depends on exactly that."""
    verdicts: List[Verdict] = []
    for rule in (rules if rules is not None else DEFAULT_RULES):
        base = extract(baseline, rule)
        new = extract(fresh, rule)
        if base is None:
            verdicts.append(Verdict(rule, "no_baseline", None, new, None,
                                    "no baseline value"))
            continue
        if new is None:
            status = "regressed" if rule.required else "missing"
            verdicts.append(Verdict(
                rule, status, base, None, None,
                "value missing from fresh run"
                + ("" if rule.required else " (optional)")))
            continue
        if rule.direction == HIGHER:
            limit = base * (1.0 - rule.tolerance)
            regressed = new < limit
            improved = new > base
        else:
            limit = base * (1.0 + rule.tolerance)
            regressed = new > limit
            improved = new < base
        status = ("regressed" if regressed
                  else "improved" if improved else "ok")
        arrow = "<" if rule.direction == HIGHER else ">"
        detail = (f"fresh {new:g} vs baseline {base:g} "
                  f"(fails when {arrow} {limit:g})")
        verdicts.append(Verdict(rule, status, base, new, limit, detail))
    return Report(verdicts)


def check_files(baseline_path: str, fresh_path: str,
                rules: Optional[List[Rule]] = None) -> Report:
    with open(baseline_path) as f:
        baseline = json.load(f)
    with open(fresh_path) as f:
        fresh = json.load(f)
    return compare(baseline, fresh, rules)
