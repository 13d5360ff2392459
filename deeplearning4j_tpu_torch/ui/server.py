"""Training UI server + remote stats listener.

Reference: ``deeplearning4j-ui/.../UiServer.java:25-33`` (Dropwizard/Jetty
app: REST endpoints + static assets + live charts) and
``deeplearning4j-ui-remote-iterationlisteners/.../RemoteFlowIterationListener
.java`` (train cluster POSTs stats to a remote UI host).

Redesign: stdlib ``http.server`` on a background thread; endpoints return
JSON from a StatsStorage; a single self-contained HTML page renders score
curves + histograms with inline SVG (no external JS, no CDN).  The remote
listener POSTs StatsReport JSON to ``/collect``.

Port: a copy of ``deeplearning4j_tpu/ui/server.py`` with its imports
rewritten; every endpoint answers the same JSON for the same storage.
``GET /memory`` keeps the reference's keys: ``device_memory`` is the
card's ``torch.cuda`` statistics (``observability/memory.py``), and
``ledgers`` and ``programs`` stay empty until the sharding ledger
(``observability/shardstats.py``, ROADMAP A10) is ported.  The server's
threads touch no tensor: a training step is never waited on or
disturbed by a client.
"""

from __future__ import annotations

import json
import math
import queue as queue_mod
import threading
import urllib.parse
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, List, Optional

from deeplearning4j_tpu_torch.observability.health import (
    HealthEvaluator, default_training_rules,
)
from deeplearning4j_tpu_torch.observability.metrics import get_registry
from deeplearning4j_tpu_torch.optimize.listeners import IterationListener
from deeplearning4j_tpu_torch.ui.stats import StatsReport, StatsUpdateConfiguration
from deeplearning4j_tpu_torch.ui.storage import InMemoryStatsStorage, StatsStorage

# metric selectors the comparison / drill-down endpoints understand:
# plain report fields, or "<kind>:<layer>" per-layer introspection series
_REPORT_METRICS = {"score", "iteration_time_ms", "samples_per_second"}
_LAYER_METRICS = {
    "gradient_norm": ("gradient_stats", "norm"),
    "update_norm": ("update_stats", "norm"),
    "update_ratio": ("update_stats", "ratio"),
    "param_norm": ("update_stats", "param_norm"),
    "dead_fraction": ("activation_stats", "zero_fraction"),
    "activation_mean": ("activation_stats", "mean"),
    "activation_std": ("activation_stats", "std"),
}


def _metric_value(u: StatsReport, metric: str):
    """One report's value for a metric selector, or None."""
    if metric in _REPORT_METRICS:
        v = getattr(u, metric)
        return v if v is not None and not (isinstance(v, float)
                                           and math.isnan(v)) else None
    kind, _, layer = metric.partition(":")
    spec = _LAYER_METRICS.get(kind)
    if spec is None or not layer:
        raise ValueError(f"unknown metric '{metric}'")
    entry = (getattr(u, spec[0]) or {}).get(layer)
    if not entry:
        return None
    v = entry.get(spec[1])
    return v if v is not None and not (isinstance(v, float)
                                       and math.isnan(v)) else None

_PAGE = """<!DOCTYPE html>
<html><head><title>deeplearning4j_tpu_torch training UI</title>
<style>
 body{font-family:sans-serif;margin:24px;background:#fafafa;color:#222}
 h1{font-size:20px} h2{font-size:16px;margin-top:28px}
 .card{background:#fff;border:1px solid #ddd;border-radius:6px;
       padding:12px;margin:12px 0;max-width:720px}
 svg{background:#fff} table{border-collapse:collapse}
 td,th{border:1px solid #ccc;padding:4px 8px;font-size:13px}
</style></head>
<body><h1>deeplearning4j_tpu_torch training UI</h1><div id="root">loading…</div>
<script>
function poly(xs, ys, w, h, pad){
  const xmin=Math.min(...xs), xmax=Math.max(...xs);
  const ymin=Math.min(...ys), ymax=Math.max(...ys);
  const sx=x=>pad+(x-xmin)/Math.max(xmax-xmin,1e-9)*(w-2*pad);
  const sy=y=>h-pad-(y-ymin)/Math.max(ymax-ymin,1e-9)*(h-2*pad);
  return xs.map((x,i)=>`${sx(x).toFixed(1)},${sy(ys[i]).toFixed(1)}`).join(' ');
}
function lineChart(title, xs, ys){
  const w=680,h=260,p=30;
  return `<div class="card"><h2>${title}</h2>
   <svg width="${w}" height="${h}">
    <polyline fill="none" stroke="#1f77b4" stroke-width="1.5"
      points="${poly(xs,ys,w,h,p)}"/>
    <text x="${p}" y="14" font-size="11">last: ${ys[ys.length-1].toPrecision(5)}</text>
   </svg></div>`;
}
function histChart(title, bins, counts){
  const w=680,h=160,p=25; const maxc=Math.max(...counts,1);
  const bw=(w-2*p)/counts.length;
  const bars=counts.map((c,i)=>`<rect x="${(p+i*bw).toFixed(1)}"
    y="${(h-p-(c/maxc)*(h-2*p)).toFixed(1)}" width="${(bw-1).toFixed(1)}"
    height="${((c/maxc)*(h-2*p)).toFixed(1)}" fill="#2ca02c"/>`).join('');
  return `<div class="card"><h2>${title}</h2>
    <svg width="${w}" height="${h}">${bars}</svg></div>`;
}
async function refresh(){
  const sessions = await (await fetch('train/sessions')).json();
  let html='';
  for(const sid of sessions){
    const data = await (await fetch('train/overview?sid='+sid)).json();
    html += `<h2>session ${sid}</h2>`;
    if(data.iterations.length>1)
      html += lineChart('score vs iteration', data.iterations, data.scores);
    if(data.iteration_times.length>1)
      html += lineChart('iteration time (ms)', data.iterations, data.iteration_times);
    const intro = await (await fetch('train/introspection?sid='+sid)).json();
    for(const layer of (intro.layers||[]).slice(0,6)){
      const s = intro.series[layer]||{};
      const g=s.gradient_norm, r=s.update_ratio, d=s.dead_fraction;
      if(g && g.values.length>1)
        html += lineChart('gradient norm: '+layer, g.iterations, g.values);
      if(r && r.values.length>1)
        html += lineChart('update:param ratio: '+layer, r.iterations, r.values);
      if(d && d.values.some(v=>v>0))
        html += lineChart('dead fraction: '+layer, d.iterations, d.values);
    }
    const latest = data.latest_histograms || {};
    for(const k of Object.keys(latest).slice(0,8)){
      html += histChart('param histogram: '+k, latest[k].bins, latest[k].counts);
    }
  }
  document.getElementById('root').innerHTML = html || 'no sessions yet';
}
refresh(); setInterval(refresh, 3000);
// live view: any SSE update triggers an immediate redraw (polling stays
// as the fallback when EventSource is unavailable)
try{
  let pending = false;
  const es = new EventSource('train/stream');
  es.onmessage = () => {
    if(pending) return;
    pending = true;
    setTimeout(() => { pending = false; refresh(); }, 250);
  };
}catch(e){}
</script></body></html>
"""


class UIServer:
    """≙ ``UiServer.java``: hosts the dashboard + REST + /collect ingest.

    Operational endpoints (a training process embedding this server is
    scrape- and probe-able without a separate exporter):

    - ``GET /metrics`` — Prometheus text scrape of the process-wide
      metrics registry (fit/phase/compile/worker families).
    - ``GET /health`` — SLO verdict from a ``HealthEvaluator``
      (``health=`` to customize; defaults to ``default_training_rules()``:
      a recompile budget, plus whatever step-p99/throughput/straggler
      limits the caller configures); 200 healthy / 503 with the failing
      rules detailed.
    - ``GET /memory`` — the sharding ledger (per-tree per-device bytes,
      replication factors, ZeRO projection) plus per-program memory /
      collective accounting when a ``ShardStatsCollector`` is installed,
      and the PJRT device stats (docs/observability.md "Memory &
      communication").
    - ``GET /generation/cache`` — paged-pool occupancy + persistent
      prefix-cache stats of an attached ``GenerationEngine``
      (``attach_generation``); 404 until one is attached.
    - ``GET /fleet`` / ``GET /fleet/metrics`` — an attached
      ``FleetAggregator``'s per-worker table and its merged
      worker-labeled registry (``attach_fleet``); 404 until one is
      attached.
    """

    def __init__(self, storage: Optional[StatsStorage] = None, port: int = 0,
                 registry=None, health: Optional[HealthEvaluator] = None):
        self.storage = storage or InMemoryStatsStorage()
        self._registry = registry
        self.generation = None   # attach_generation()
        self.fleet = None        # attach_fleet()
        self.health = health or HealthEvaluator(
            default_training_rules(), component="training",
            registry=registry)
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None
        self._requested_port = port
        # set on stop(): live SSE handler threads poll it between
        # heartbeats so shutdown never waits on an open stream
        self._stopping = threading.Event()

    def attach_generation(self, engine) -> None:
        """Expose a ``GenerationEngine``'s cache stats on
        ``GET /generation/cache`` (the serving-side twin of /memory)."""
        self.generation = engine

    def attach_fleet(self, aggregator) -> None:
        """Expose a ``FleetAggregator``'s per-worker table on
        ``GET /fleet`` and its merged worker-labeled registry on
        ``GET /fleet/metrics`` — the training UI doubles as the
        fleet-operator console without running a second HTTP server."""
        self.fleet = aggregator

    # ------------------------------------------------------------- queries
    def compare_sessions(self, sids: List[str],
                         metric: str = "score") -> Dict[str, Any]:
        """Overlay N sessions' series by iteration — the run-comparison
        view (same LR sweep, before/after a fix, replica A vs B).
        ``metric``: a report field (``score``, ``iteration_time_ms``,
        ``samples_per_second``) or ``<kind>:<layer>`` with kind one of
        gradient_norm / update_norm / update_ratio / param_norm /
        dead_fraction / activation_mean / activation_std."""
        if metric not in _REPORT_METRICS:
            kind, _, layer = metric.partition(":")
            if kind not in _LAYER_METRICS or not layer:
                raise ValueError(f"unknown metric '{metric}'")
        sessions: Dict[str, Any] = {}
        for sid in sids:
            its, vals = [], []
            for u in self.storage.get_updates(sid):
                v = _metric_value(u, metric)
                if v is None:
                    continue
                its.append(u.iteration)
                vals.append(v)
            sessions[sid] = {"iterations": its, "values": vals}
        return {"metric": metric, "sessions": sessions}

    def layer_detail(self, sid: str, layer: str) -> Dict[str, Any]:
        """Per-layer drill-down as a UI component tree
        (``ui.components``): gradient/update-norm, update:param ratio,
        activation mean/std, dead fraction — per-replica series when the
        session ran under a data-parallel master — plus the layer's
        latest param histograms."""
        from deeplearning4j_tpu_torch.ui.components import (
            ChartHistogram, ChartLine, ComponentDiv, ComponentTable,
        )

        ups = self.storage.get_updates(sid)
        div = ComponentDiv()

        def series_chart(title, metric):
            chart = ChartLine(title)
            its, vals = [], []
            for u in ups:
                v = _metric_value(u, f"{metric}:{layer}")
                if v is not None:
                    its.append(u.iteration)
                    vals.append(v)
            if its:
                chart.add_series(metric, its, vals)
            return chart, bool(its)

        for title, metric in (("gradient norm", "gradient_norm"),
                              ("update norm", "update_norm"),
                              ("update:param ratio", "update_ratio"),
                              ("activation mean", "activation_mean"),
                              ("activation std", "activation_std"),
                              ("dead fraction", "dead_fraction")):
            chart, has = series_chart(f"{layer}: {title}", metric)
            if has:
                div.children.append(chart)
        # per-replica gradient-norm overlay (wrapper runs)
        per_rep = ChartLine(f"{layer}: per-replica gradient norm")
        n_rep = 0
        for u in ups:
            entry = (u.gradient_stats or {}).get(layer) or {}
            n_rep = max(n_rep, len(entry.get("per_replica") or ()))
        for k in range(n_rep):
            its, vals = [], []
            for u in ups:
                col = ((u.gradient_stats or {}).get(layer) or {}).get(
                    "per_replica")
                if col is not None and k < len(col) \
                        and math.isfinite(col[k]):
                    its.append(u.iteration)
                    vals.append(col[k])
            if its:
                per_rep.add_series(f"replica {k}", its, vals)
        if per_rep.series:
            div.children.append(per_rep)
        if ups:
            last = ups[-1]
            for name, h in (last.param_histograms or {}).items():
                if not name.startswith(f"{layer}/"):
                    continue
                hist = ChartHistogram(f"param histogram: {name}")
                for lo, hi, c in zip(h["bins"][:-1], h["bins"][1:],
                                     h["counts"]):
                    hist.add_bin(lo, hi, c)
                div.children.append(hist)
            rows = []
            for metric in _LAYER_METRICS:
                v = _metric_value(last, f"{metric}:{layer}")
                if v is not None:
                    rows.append((metric, f"{v:.6g}"))
            if rows:
                div.children.append(
                    ComponentTable(["stat", "latest"], rows))
        return div.to_dict()

    def introspection_series(self, sid: str) -> Dict[str, Any]:
        """All per-layer introspection series of one session (feeds the
        dashboard's layer charts)."""
        ups = self.storage.get_updates(sid)
        layers: List[str] = []
        for u in ups:
            for name in (u.gradient_stats or {}):
                if name not in layers:
                    layers.append(name)
            for name in (u.activation_stats or {}):
                if name not in layers:
                    layers.append(name)
        out: Dict[str, Any] = {"layers": layers, "series": {}}
        for layer in layers:
            entry: Dict[str, Any] = {}
            for m in _LAYER_METRICS:
                # per-metric iteration axis: a NaN/absent value (e.g. a
                # guarded no-op step's ratio) is SKIPPED, never emitted
                # as null — a shared axis would force null padding and
                # crash/skew the dashboard's chart renderer
                its: List[int] = []
                vals: List[float] = []
                for u in ups:
                    v = _metric_value(u, f"{m}:{layer}")
                    if v is None:
                        continue
                    its.append(u.iteration)
                    vals.append(v)
                if vals:
                    entry[m] = {"iterations": its, "values": vals}
            out["series"][layer] = entry
        return out

    def numerics_report(self, sid: str) -> Dict[str, Any]:
        """The most recent precision-ledger harvest of one session plus
        its rendered operator table (``GET /train/numerics``)."""
        from deeplearning4j_tpu_torch.observability import numerics
        ups = self.storage.get_updates(sid)
        latest = None
        for u in reversed(ups):
            if getattr(u, "numerics", None):
                latest = u.numerics
                break
        if latest is None:
            return {"numerics": None, "ledger": None}
        return {"numerics": latest,
                "ledger": numerics.format_precision_ledger(latest)}

    # ------------------------------------------------------------ lifecycle
    def start(self) -> int:
        storage = self.storage
        ui = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet
                pass

            def _json(self, obj, code=200):
                body = json.dumps(obj).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def _sse(self, sid: Optional[str], replay: bool) -> None:
                """Server-Sent-Events live stream of StatsReport updates
                (``sid=`` filters to one session; ``replay=1`` first
                replays the stored history, so a late-attaching client —
                or a post-crash reopen of a FileStatsStorage — sees the
                whole run).  Heartbeats every second keep dead-client
                detection prompt; the stream ends on client disconnect
                or server stop."""
                q: "queue_mod.Queue" = queue_mod.Queue(maxsize=1024)

                def on_update(rep):
                    if sid and rep.session_id != sid:
                        return
                    try:
                        q.put_nowait(rep)
                    except queue_mod.Full:
                        pass   # slow client: drop rather than block training

                storage.add_listener(on_update)
                try:
                    self.send_response(200)
                    self.send_header("Content-Type", "text/event-stream")
                    self.send_header("Cache-Control", "no-cache")
                    self.end_headers()
                    if replay:
                        sids = [sid] if sid else storage.list_session_ids()
                        for s in sids:
                            for rep in storage.get_updates(s):
                                self._event(rep)
                    while not ui._stopping.is_set():
                        try:
                            rep = q.get(timeout=1.0)
                        except queue_mod.Empty:
                            self.wfile.write(b": keep-alive\n\n")
                            self.wfile.flush()
                            continue
                        self._event(rep)
                except (BrokenPipeError, ConnectionResetError, OSError):
                    pass   # client went away — normal stream teardown
                finally:
                    storage.remove_listener(on_update)

            def _event(self, rep) -> None:
                self.wfile.write(b"data: " + rep.to_json().encode()
                                 + b"\n\n")
                self.wfile.flush()

            def do_GET(self):
                path, _, query = self.path.partition("?")
                params = {k: urllib.parse.unquote(v) for k, v in
                          (p.split("=", 1) for p in query.split("&")
                           if "=" in p)}
                if path.endswith("/train/stream") or path == "/stream":
                    self._sse(params.get("sid"),
                              params.get("replay") in ("1", "true"))
                elif path.endswith("/train/compare") or path == "/compare":
                    sids = [s for s in params.get("sids", "").split(",") if s]
                    try:
                        self._json(ui.compare_sessions(
                            sids, params.get("metric", "score")))
                    except ValueError as e:
                        self._json({"error": str(e)}, 400)
                elif path.endswith("/train/layer"):
                    sid, layer = params.get("sid"), params.get("layer")
                    if not sid or not layer:
                        self._json({"error": "sid= and layer= required"},
                                   400)
                    else:
                        self._json(ui.layer_detail(sid, layer))
                elif path.endswith("/train/introspection"):
                    self._json(ui.introspection_series(params.get("sid")))
                elif path.endswith("/train/numerics"):
                    self._json(ui.numerics_report(params.get("sid")))
                elif path in ("/", "/train", "/train/"):
                    body = _PAGE.encode()
                    self.send_response(200)
                    self.send_header("Content-Type", "text/html")
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                elif path.endswith("/train/sessions") or path == "/sessions":
                    self._json(storage.list_session_ids())
                elif path.endswith("/train/overview") or path == "/overview":
                    sid = params.get("sid")
                    ups = storage.get_updates(sid) if sid else []
                    latest_hist = {}
                    if ups and ups[-1].param_histograms:
                        latest_hist = ups[-1].param_histograms
                    self._json({
                        "iterations": [u.iteration for u in ups],
                        "scores": [u.score for u in ups],
                        "iteration_times": [u.iteration_time_ms for u in ups],
                        "latest_histograms": latest_hist,
                    })
                elif path.endswith("/train/memory"):
                    sid = params.get("sid")
                    ups = storage.get_updates(sid) if sid else []
                    self._json([u.memory for u in ups])
                elif path == "/metrics":
                    reg = (ui._registry if ui._registry is not None
                           else get_registry())
                    body = reg.to_prometheus().encode()
                    self.send_response(200)
                    self.send_header(
                        "Content-Type",
                        "text/plain; version=0.0.4; charset=utf-8")
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                elif path == "/memory":
                    # the reference's keys: the sharding ledger and the
                    # per-program accounting (empty until shardstats is
                    # ported, ROADMAP A10) beside the card's memory
                    from deeplearning4j_tpu_torch.observability.memory import (
                        device_memory_stats,
                    )

                    self._json({"ledgers": {}, "programs": {},
                                "device_memory": device_memory_stats()})
                elif path == "/generation/cache":
                    # a serving-side panel in the training UI: the
                    # attached generation engine's paged-pool occupancy
                    # + persistent prefix-cache stats
                    if ui.generation is None:
                        self._json({"error": "no generation engine "
                                    "attached (UIServer."
                                    "attach_generation)"}, 404)
                    else:
                        self._json(ui.generation.cache_stats())
                elif path == "/fleet":
                    # per-worker snapshot table + staleness (the
                    # aggregator's own /fleet, mirrored into the UI)
                    if ui.fleet is None:
                        self._json({"error": "no fleet aggregator "
                                    "attached (UIServer.attach_fleet)"},
                                   404)
                    else:
                        self._json(ui.fleet.fleet_table())
                elif path == "/fleet/metrics":
                    if ui.fleet is None:
                        self._json({"error": "no fleet aggregator "
                                    "attached (UIServer.attach_fleet)"},
                                   404)
                    else:
                        reg = ui.fleet.registry()
                        ui.fleet.evaluate_health(reg)
                        body = reg.to_prometheus().encode()
                        self.send_response(200)
                        self.send_header(
                            "Content-Type",
                            "text/plain; version=0.0.4; charset=utf-8")
                        self.send_header("Content-Length",
                                         str(len(body)))
                        self.end_headers()
                        self.wfile.write(body)
                elif path == "/health":
                    verdict = ui.health.evaluate()
                    self._json(verdict.to_dict(),
                               code=200 if verdict.healthy else 503)
                else:
                    self._json({"error": "not found", "path": path}, 404)

            def do_POST(self):
                if self.path.rstrip("/").endswith("/collect"):
                    n = int(self.headers.get("Content-Length", 0))
                    rep = StatsReport.from_json(self.rfile.read(n).decode())
                    storage.put_update(rep)
                    self._json({"ok": True})
                else:
                    self._json({"error": "not found"}, 404)

        self._stopping.clear()
        self._httpd = ThreadingHTTPServer(("127.0.0.1", self._requested_port),
                                          Handler)
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True)
        self._thread.start()
        return self._httpd.server_address[1]

    @property
    def port(self) -> Optional[int]:
        return self._httpd.server_address[1] if self._httpd else None

    def stop(self) -> None:
        self._stopping.set()   # unblock live SSE streams within one beat
        if self._httpd:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
        if self._thread is not None:
            # shutdown() unblocked serve_forever — bounded join so a
            # stop/start cycle never races the old acceptor thread
            self._thread.join(timeout=5.0)
            self._thread = None


class RemoteStatsListener(IterationListener):
    """POSTs per-iteration StatsReports to a remote UI server.
    ≙ ``RemoteFlowIterationListener.java`` (train host ≠ UI host)."""

    def __init__(self, url: str, session_id: str = "remote",
                 frequency: int = 1, timeout: float = 2.0):
        self.url = url.rstrip("/") + "/collect"
        self.session_id = session_id
        self.frequency = frequency
        self.timeout = timeout

    def iteration_done(self, model, iteration: int) -> None:
        if iteration % max(self.frequency, 1) != 0:
            return
        import time as _time

        rep = StatsReport(session_id=self.session_id, iteration=iteration,
                          timestamp=_time.time(),
                          score=float(getattr(model, "score_value", float("nan"))))
        data = rep.to_json().encode()
        req = urllib.request.Request(
            self.url, data=data, headers={"Content-Type": "application/json"})
        try:
            urllib.request.urlopen(req, timeout=self.timeout)
        except Exception:
            pass  # UI down must never kill training (reference behavior)
