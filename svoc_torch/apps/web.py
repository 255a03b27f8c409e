"""The console's web UI: one stdlib HTTP server, dependency-free.

Mirrors :mod:`svoc_tpu.apps.web` (``web.py:1-846``): the page (its own
copy of the reference's HTML), every route of ``web.py:342-752`` and
:func:`serve` (``:753``), with the reference's status codes and guards
(the Host check against DNS rebinding, the Origin check on POSTs, the
``MAX_SSE_STREAMS`` cap).  ``python -m svoc_torch.apps.web`` takes the
CLI's flags (``--device`` included, default ``cuda``) plus ``--port``
and ``--host``.  The routes:

- ``POST /api/query`` — body = command text, response = console lines
  (the same :class:`svoc_torch.apps.commands.CommandConsole` dispatcher
  the CLI uses),
- ``GET /api/state`` — the last fetch preview + cached chain state,
  driving the plots and progress bars,
- ``GET /api/events`` — server-sent-events stream pushing
  ``{"state_version": N}`` the moment the session state changes
  (``?journal=1`` adds the flight recorder's typed frames).  The
  page is push-first with the poll loop demoted to a slow reconnect
  fallback.  Concurrent streams are capped (``MAX_SSE_STREAMS``) —
  each holds one ThreadingHTTPServer thread, and an abandoned tab
  must not exhaust the thread pool,
- ``GET /metrics`` — Prometheus text exposition of the shared
  observability registry (stage-span histograms, counters, timers,
  device gauges sampled on demand; docs/OBSERVABILITY.md),
- ``GET /api/profile`` (the attached profiler's start/stop/status),
  ``GET /api/audit/<lineage>`` (one block's audit record, 404 when
  unknown) and ``GET /metrics/fleet`` (the fleet plane's merged
  exposition, 404 when none is enabled),
- ``POST /api/submit`` — the serving tier's request path
  (docs/SERVING.md): ``{"claim": ..., "text": ...}`` through cache /
  admission; 200 = served (``admitted``/``cached``), 429 = shed, 404 =
  unknown claim, 503 = no serving tier attached.

Start with ``python -m svoc_torch.apps.web`` or ``serve(console)``.
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional, Tuple

from svoc_torch.apps.commands import CommandConsole

_PAGE = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>svoc console</title>
<style>
 body { font-family: monospace; background: #111; color: #ddd; margin: 1rem; }
 h2 { color: #8cf; }
 #plots { display: flex; flex-wrap: wrap; gap: 1rem; }
 canvas { background: #1a1a2a; border: 1px solid #345; }
 #console { background: #000; padding: .5rem; height: 14rem; overflow-y: scroll;
            white-space: pre-wrap; border: 1px solid #345; }
 #cmd { width: 100%; background: #222; color: #ddd; border: 1px solid #345;
        font-family: monospace; padding: .3rem; }
 .bar { background: #333; height: 1rem; width: 20rem; }
 .bar > div { height: 100%; background: #4c4; }
 .bar.low > div { background: #c44; }
</style></head>
<body>
<h2>svoc — stochastic vector oracle consensus</h2>
<div>reliability first pass <div class="bar" id="rel1"><div style="width:0"></div></div>
     reliability second pass <div class="bar" id="rel2"><div style="width:0"></div></div>
     trend <canvas id="rel2spark" width="160" height="16"
            style="vertical-align:middle"></canvas>
     <span id="rel2warn" style="color:#e55"></span></div>
<div id="resil" style="color:#9ab; margin:.3rem 0"></div>
<div id="plots"></div>
<button id="replace-btn">Oracle Replacement</button>
<div id="replace-menu" style="display:none; border:1px solid #345; padding:.5rem; margin:.5rem 0">
  <h3>propose replacement</h3>
  as admin <select id="rp-admin"></select>
  replace oracle <select id="rp-old"></select>
  with address <input id="rp-new" placeholder="0x...">
  <button id="rp-send">propose</button>
  <button id="rp-clear">clear my proposition</button>
  <h3>vote</h3>
  as admin <select id="vt-admin"></select>
  on proposition of admin <select id="vt-which"></select>
  <button id="vt-yes">yes</button> <button id="vt-no">no</button>
  <div id="rp-props" style="white-space: pre-line"></div>
</div>
<div id="console"></div>
<input id="cmd" placeholder="command ('help' to list)" autofocus>
<script>
const consoleEl = document.getElementById('console');
function writeLines(lines) {
  for (const l of lines) {
    if (l === '\\x1b[clear]') { consoleEl.textContent = ''; continue; }
    consoleEl.textContent += l + '\\n';
  }
  consoleEl.scrollTop = consoleEl.scrollHeight;
}
async function query(text) {
  const r = await fetch('/api/query', {method: 'POST', body: text});
  writeLines(await r.json());
  refresh();
}
document.getElementById('cmd').addEventListener('keydown', e => {
  if (e.key === 'Enter') { query(e.target.value); e.target.value = ''; }
});
function drawScatter(canvas, pts, colors, mean, median, names) {
  const ctx = canvas.getContext('2d');
  ctx.clearRect(0, 0, canvas.width, canvas.height);
  const pad = 20, w = canvas.width - 2 * pad, h = canvas.height - 2 * pad;
  // axis label names per pair (reference columnNames,
  // oracle_scheduler.py:113-118 / simulation_graphics.js:8-80)
  ctx.fillStyle = '#89a';
  ctx.font = '11px monospace';
  ctx.fillText(names[0], canvas.width / 2 - 4 * names[0].length, canvas.height - 4);
  ctx.save();
  ctx.translate(10, canvas.height / 2 + 4 * names[1].length);
  ctx.rotate(-Math.PI / 2);
  ctx.fillText(names[1], 0, 0);
  ctx.restore();
  const xs = pts.map(p => p[0]).concat([mean[0], median[0]]);
  const ys = pts.map(p => p[1]).concat([mean[1], median[1]]);
  const x0 = Math.min(...xs), x1 = Math.max(...xs);
  const y0 = Math.min(...ys), y1 = Math.max(...ys);
  const sx = v => pad + w * (v - x0) / (x1 - x0 + 1e-9);
  const sy = v => pad + h * (1 - (v - y0) / (y1 - y0 + 1e-9));
  pts.forEach((p, i) => {
    ctx.fillStyle = colors[i];
    ctx.beginPath(); ctx.arc(sx(p[0]), sy(p[1]), 4, 0, 7); ctx.fill();
  });
  ctx.fillStyle = '#8cf';
  ctx.fillRect(sx(mean[0]) - 3, sy(mean[1]) - 3, 6, 6);
  ctx.fillStyle = '#fc3';
  ctx.fillRect(sx(median[0]) - 3, sy(median[1]) - 3, 6, 6);
}
function fillSelect(el, items) {
  const prev = el.value;  // keep the operator's pick across refresh()
  el.innerHTML = '';
  items.forEach((label, i) => {
    const o = document.createElement('option');
    o.value = i; o.textContent = i + ': ' + label;
    el.appendChild(o);
  });
  if (prev !== '' && Number(prev) < items.length) el.value = prev;
}
function updateReplacementMenu(s) {
  // reference modal: admin/oracle selectors populated from chain
  // state (oracle_management.js:23-62, index.html:10-71)
  const admins = s.admin_list || [], oracles = s.oracle_list || [];
  for (const id of ['rp-admin', 'vt-admin', 'vt-which'])
    fillSelect(document.getElementById(id), admins);
  fillSelect(document.getElementById('rp-old'), oracles);
  const props = document.getElementById('rp-props');
  props.textContent = (s.replacement_propositions || [])
    .map((p, i) => 'admin ' + i + ': ' + (p === null ? 'None' : JSON.stringify(p)))
    .join('\\n');
}
let lastVersion = null;
async function refresh(s) {
  if (!s) {  // poll loop passes the state it already fetched
    const r = await fetch('/api/state');
    s = await r.json();
  }
  lastVersion = s.state_version;
  for (const [id, v] of [['rel1', s.reliability_first_pass],
                         ['rel2', s.reliability_second_pass]]) {
    const bar = document.getElementById(id);
    const pct = Math.max(0, Math.min(100, (v || 0) * 100));
    bar.firstElementChild.style.width = pct + '%';
    bar.classList.toggle('low', pct < 50);  // sepolia_graphics.js:53-69
  }
  // rel2 TRAJECTORY sparkline: a capture approach shows as a slide,
  // not a low level (docs/ALGORITHM.md section 5 security note).
  const spark = document.getElementById('rel2spark');
  const sctx = spark.getContext('2d');
  sctx.clearRect(0, 0, spark.width, spark.height);
  const hist = s.rel2_history || [];
  if (hist.length >= 2) {
    // y normalized to the window's own range: the alarm slide is a few
    // percent absolute and would be sub-pixel on a [0,1] scale.
    const lo = Math.min(...hist), hi = Math.max(...hist);
    const span = Math.max(hi - lo, 1e-6);
    sctx.strokeStyle = s.rel2_falling ? '#e55' : '#5b5';
    sctx.beginPath();
    hist.forEach((v, i) => {
      const x = i * (spark.width - 2) / (hist.length - 1) + 1;
      const y = spark.height - 1 - ((v - lo) / span) * (spark.height - 2);
      i ? sctx.lineTo(x, y) : sctx.moveTo(x, y);
    });
    sctx.stroke();
  }
  document.getElementById('rel2warn').textContent =
    s.rel2_falling ? '⚠ falling' : '';
  // Resilience status line: auto flags, breaker state, fleet health
  // (docs/RESILIENCE.md) — toggling a flag bumps state_version, so
  // this repaints live through the same push channel as everything.
  const rs = s.resilience || {};
  const onoff = v => v ? 'on' : 'off';
  const quarantined = (rs.quarantined || []).join(',');
  document.getElementById('resil').textContent =
    'auto fetch:' + onoff(s.auto_fetch)
    + ' commit:' + onoff(s.auto_commit)
    + ' resume:' + onoff(s.auto_resume)
    + ' · breaker: ' + (rs.breaker || 'n/a')
    + ' · replacements: ' + (rs.replacements || 0)
    + (quarantined ? ' · quarantined slots: ' + quarantined : '')
    + (rs.lineage ? ' · block: ' + rs.lineage : '');
  updateReplacementMenu(s);
  const plots = document.getElementById('plots');
  plots.innerHTML = '';
  if (!s.preview) return;
  const vals = s.preview.values, ranks = s.preview.normalized_ranks;
  const labels = s.labels || [];
  const dim = vals[0].length;
  for (let c = 0; c + 1 < dim; c += 2) {  // one plot per label pair
    const canvas = document.createElement('canvas');
    canvas.width = 260; canvas.height = 220;
    plots.appendChild(canvas);
    const pts = vals.map(v => [v[c], v[c + 1]]);
    // red when normalized rank <= 0.2 (simulation_graphics.js:97-99)
    const colors = ranks.map(r => r <= 0.2 ? '#e55' : '#5b5');
    drawScatter(canvas, pts,
      colors,
      [s.preview.mean[c], s.preview.mean[c + 1]],
      [s.preview.median[c], s.preview.median[c + 1]],
      [labels[c] || ('dim ' + c), labels[c + 1] || ('dim ' + (c + 1))]);
  }
}
document.getElementById('replace-btn').addEventListener('click', () => {
  const m = document.getElementById('replace-menu');
  m.style.display = m.style.display === 'none' ? 'block' : 'none';
});
document.getElementById('rp-send').addEventListener('click', () => {
  query('update_proposition ' + document.getElementById('rp-admin').value
    + ' ' + document.getElementById('rp-old').value
    + ' ' + document.getElementById('rp-new').value);
});
document.getElementById('rp-clear').addEventListener('click', () => {
  query('update_proposition ' + document.getElementById('rp-admin').value + ' None');
});
for (const [id, ans] of [['vt-yes', 'yes'], ['vt-no', 'no']])
  document.getElementById(id).addEventListener('click', () => {
    query('vote_for_a_proposition ' + document.getElementById('vt-admin').value
      + ' ' + document.getElementById('vt-which').value + ' ' + ans);
  });
query('help');  // boot with the command list (main.js:45); its
                // completion handler performs the initial refresh()
// Live refresh, PUSH-FIRST (reference eel parity: the UI repaints on
// every fetch push, simulation_graphics.js:85): /api/events streams a
// state_version the moment the session changes; each push triggers one
// /api/state fetch + redraw.  The poll loop stays only as a slow
// fallback while the event stream is down (server restarting) —
// EventSource auto-reconnects.  ?journal=1 opts this stream into the
// flight recorder's TYPED frames too (docs/OBSERVABILITY.md §events);
// the unnamed state_version frames below are unchanged, and the named
// 'journal' frames land in their own listener.
let pushAlive = false;
let pushedVersion = null, pushRefreshing = false;
const events = new EventSource('/api/events?journal=1');
// Alert-class journal events surface in the console as they happen —
// the 2 a.m. story (quarantine → breaker → replacement → SLO burn)
// narrates itself instead of hiding in aggregate bars.
const alertTypes = ['slo.alert', 'breaker.transition',
                    'supervisor.replacement', 'quarantine.verdict',
                    'postmortem.bundle'];
events.addEventListener('journal', ev => {
  const e = JSON.parse(ev.data);
  if (!alertTypes.includes(e.type)) return;
  // Clean verdicts are per-block routine; only refusals narrate.
  if (e.type === 'quarantine.verdict'
      && !(e.data && e.data.reasons && Object.keys(e.data.reasons).length))
    return;
  writeLines(['⚠ ' + e.type + (e.lineage ? ' [' + e.lineage + ']' : '')
              + ' ' + JSON.stringify(e.data)]);
});
// Reconnect resets the catch-up target: a pushed version from the
// PREVIOUS server process is not comparable to the new process's
// versions (a restarted server counts from 0 again, so a stale high
// target would spin the catch-up loop forever against a server that
// can never reach it).
events.onopen = () => { pushAlive = true; pushedVersion = null; };
events.onerror = () => { pushAlive = false; pushedVersion = null; };
events.onmessage = async (ev) => {
  pushAlive = true;
  pushedVersion = JSON.parse(ev.data).state_version;
  if (pushRefreshing) return;  // serialized: out-of-order /api/state
  pushRefreshing = true;       // responses could paint stale state
  try {
    // catch up to at least the pushed version; versions are monotonic,
    // so a fetch that returns NEWER than the push exits immediately
    // (no spin), a transient fetch failure retries after a pause, and
    // a SUCCESSFUL fetch that still trails the target (rapid pushes,
    // or a version skew after restart) paces itself instead of
    // hammering /api/state in a busy-loop.
    while (pushedVersion !== null && pushedVersion > lastVersion) {
      try { await refresh(); }
      catch (e) { await new Promise(res => setTimeout(res, 500)); }
      if (pushedVersion !== null && pushedVersion > lastVersion)
        await new Promise(res => setTimeout(res, 250));
    }
  } finally { pushRefreshing = false; }
};
let polling = false;
setInterval(async () => {
  if (pushAlive || polling) return;  // fallback only; never stack polls
  polling = true;
  try {
    const r = await fetch('/api/state');
    const s = await r.json();
    if (s.state_version !== lastVersion) await refresh(s);
  } catch (e) { /* server restarting; retry next tick */ }
  polling = false;
}, 5000);
</script></body></html>
"""


class _Handler(BaseHTTPRequestHandler):
    console: CommandConsole  # set by serve()

    #: Concurrent /api/events streams allowed — each parks one
    #: ThreadingHTTPServer thread in the push loop, so without a cap a
    #: handful of abandoned tabs (or a reconnect storm) would starve
    #: the query/state handlers of threads.  Excess clients get 503 +
    #: Retry-After and fall back to the page's poll loop.
    MAX_SSE_STREAMS = 16

    def _host_ok(self) -> bool:
        """DNS-rebinding guard for loopback serving: the Host header
        must name the bound address (a rebound evil.example resolving
        to 127.0.0.1 sends its own name).  Wildcard binds opted into
        remote clients (serve() warned), so any Host is accepted."""
        bound = self.server.server_address[0]
        if bound in ("0.0.0.0", "::"):
            return True
        host = self.headers.get("Host", "")
        hostname = (
            host.split("]")[0] + "]" if host.startswith("[") else host.rsplit(":", 1)[0]
        )
        return hostname in {"127.0.0.1", "localhost", "[::1]", bound}

    def _send(self, code: int, body: bytes, ctype: str) -> None:
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):  # noqa: N802 (stdlib API)
        if not self._host_ok():
            self._send(403, b"unexpected Host header", "text/plain")
            return
        if self.path == "/":
            self._send(200, _PAGE.encode(), "text/html; charset=utf-8")
        elif self.path == "/api/state":
            session = self.console.session
            # Consistent snapshots: the adapter lock guards the cache
            # against a concurrent 'resume' rehydrating it key-by-key
            # ("dictionary changed size during iteration"); the session
            # lock pairs preview with its state_version.  ORDER MATTERS:
            # the version is read BEFORE the cache, so data can only be
            # fresher than its label — a stale-cache/new-version pairing
            # would make the browser's version comparison skip the next
            # poll's fresh redraw.
            with session.lock:
                preview = session.last_preview
                state_version = session.state_version
            state = session.adapter.cache_snapshot()

            def fmt(x):
                """Addresses as the reference displays them
                (hex for ints, contract.py to_hex)."""
                from svoc_torch.io.chain import to_hex

                return to_hex(x) if isinstance(x, int) else str(x)

            trend = session.adapter.rel2_trend()
            payload = {
                "state_version": state_version,
                "auto_fetch": session.auto_fetch,
                "auto_commit": session.auto_commit,
                "auto_resume": session.auto_resume,
                # breaker / fleet-health state (docs/RESILIENCE.md);
                # cheap — no chain I/O behind it.
                "resilience": session.resilience_snapshot(),
                "reliability_first_pass": state.get("reliability_first_pass"),
                "reliability_second_pass": state.get("reliability_second_pass"),
                # trajectory, not just level: capture is invisible in
                # the level (docs/ALGORITHM.md §5 security note).  The
                # FULL trend window ships (≤256 floats) so the warn
                # flag and the sparkline always describe the same data.
                "rel2_history": trend["history"],
                "rel2_falling": trend["falling"],
                "consensus": state.get("consensus"),
                "consensus_active": state.get("consensus_active"),
                "labels": session.label_names,
                "admin_list": [fmt(a) for a in state.get("admin_list") or []],
                "oracle_list": [fmt(o) for o in state.get("oracle_list") or []],
                "replacement_propositions": [
                    None if p is None else [p[0], fmt(p[1])]
                    for p in state.get("replacement_propositions") or []
                ],
                "preview": None
                if preview is None
                else {
                    "values": preview["values"].tolist(),
                    "mean": preview["mean"].tolist(),
                    "median": preview["median"].tolist(),
                    "normalized_ranks": preview["normalized_ranks"].tolist(),
                },
            }
            # Multi-claim fabric (docs/FABRIC.md): when a MultiSession
            # is attached to the console, /api/state carries every
            # claim's snapshot — per-claim consensus slice, commit
            # outcome, supervisor health, and block lineage.
            fabric = getattr(self.console, "fabric", None)
            if fabric is not None:
                # One snapshot serves both sections: the per-claim map
                # and the fabric's pinned dispatch routing
                # (docs/FABRIC.md §mesh — consensus_impl, claim mesh,
                # pipelining), so a pull-mode deployment surfaces the
                # routing even without a serving tier attached and a
                # future snapshot field never needs a second edit here.
                fabric_snapshot = fabric.snapshot()
                payload["claims"] = fabric_snapshot.pop("claims")
                payload["fabric"] = fabric_snapshot
            # Serving tier (docs/SERVING.md): queues, admission
            # accounting, cache stats, live burn rate, and the
            # request-latency percentiles — the operator's saturation
            # view, refreshed with every state poll.
            serving = getattr(self.console, "serving", None)
            if serving is not None:
                payload["serving"] = serving.snapshot()
            # Durability layer (docs/RESILIENCE.md §durability):
            # snapshot freshness + commit-intent WAL health, so an
            # operator can see at a glance whether a restart would
            # recover warm (and whether a cycle is awaiting
            # reconciliation).
            durability = getattr(self.console, "durability", None)
            if durability is not None:
                payload["durability"] = durability.status()
            # Cluster plane (docs/CLUSTER.md): placement map + epoch,
            # per-replica liveness/accounting, and the migration/
            # failover counters — the fleet operator's routing view.
            cluster = getattr(self.console, "cluster", None)
            if cluster is not None:
                payload["cluster"] = cluster.snapshot()
            # Reconfiguration plane (docs/RECONFIG.md): transition
            # phase, fleet epoch, holds/deferred depth, and the tail
            # of the committed epoch chain.
            reconfig = getattr(self.console, "reconfig", None)
            if reconfig is not None:
                payload["reconfig"] = reconfig.status()
            # Fleet observability plane (docs/OBSERVABILITY.md
            # §fleet-plane): source roster, hop-chain count, per-source
            # observation accounting, fleet SLO alerts, anomalies.
            fleetplane = getattr(self.console, "fleetplane", None)
            if fleetplane is not None:
                payload["fleet_obs"] = fleetplane.snapshot()
            self._send(200, json.dumps(payload).encode(), "application/json")
        elif self.path == "/api/events" or self.path.startswith("/api/events?"):
            self._serve_events()
        elif self.path == "/api/profile" or self.path.startswith("/api/profile?"):
            self._serve_profile()
        elif self.path.startswith("/api/audit/"):
            # Per-block audit record (docs/OBSERVABILITY.md §lineage):
            # events + spans + summary joined on one lineage id.
            lineage = self.path[len("/api/audit/") :].split("?", 1)[0]
            record = self.console.session.audit(lineage or None)
            if not record.get("found"):
                self._send(
                    404,
                    json.dumps(record).encode(),
                    "application/json",
                )
            else:
                self._send(
                    200, json.dumps(record).encode(), "application/json"
                )
        elif self.path == "/metrics/fleet":
            # Merged fleet exposition (docs/OBSERVABILITY.md
            # §fleet-plane): counters summed across sources + the
            # retired ledger, gauges replica-labeled.  404-typed when
            # no plane is attached or it is disabled — a scraper must
            # be able to tell "off" from "empty fleet".
            fleetplane = getattr(self.console, "fleetplane", None)
            if fleetplane is None or not fleetplane.enabled:
                self._send(
                    404,
                    json.dumps({"error": "fleet plane not enabled"}).encode(),
                    "application/json",
                )
            else:
                self._send(
                    200,
                    fleetplane.render_prometheus_fleet().encode(),
                    "text/plain; version=0.0.4; charset=utf-8",
                )
        elif self.path == "/metrics":
            # Prometheus text exposition of the shared registry.  The
            # runtime gauges (device memory, kernel builds) are sampled
            # here, on demand — never on the hot path.
            from svoc_torch.utils.metrics import registry, sample_runtime_gauges

            sample_runtime_gauges(registry)
            self._send(
                200,
                registry.render_prometheus().encode(),
                "text/plain; version=0.0.4; charset=utf-8",
            )
        else:
            self._send(404, b"not found", "text/plain")

    def _serve_events(self) -> None:
        """Server-sent-events push channel: one tiny ``data:`` frame per
        session state change (the reference's eel-websocket push,
        ``main.js:26``, on a stdlib transport).  Each open stream holds
        one ThreadingHTTPServer thread; the loop exits on client
        disconnect (write fails) or server shutdown (the ``__shutdown``
        flag ``serve``'s closer sets), a 15 s heartbeat comment bounds
        how long a silent dead connection lingers, and concurrent
        streams are capped at ``MAX_SSE_STREAMS`` (503 + Retry-After
        beyond it — the page's poll fallback covers rejected clients).

        ``?journal=1`` opts the stream into TYPED event frames: every
        new flight-recorder event (``svoc_torch.utils.events``) arrives
        as a named ``event: journal`` SSE frame alongside the unnamed
        ``state_version`` frames (which are unchanged — the page's
        ``onmessage`` handler and old clients never see named frames).
        Frames per tick are capped so a journal burst cannot wedge the
        write loop."""
        import time as _time

        want_journal = "journal=1" in (
            self.path.split("?", 1)[1] if "?" in self.path else ""
        )

        # Admission under the server-wide lock: racing opens must not
        # both pass the check and overshoot the cap.
        with self.server.svoc_sse_lock:
            if self.server.svoc_sse_streams >= self.MAX_SSE_STREAMS:
                self.send_response(503)
                self.send_header("Retry-After", "5")
                body = b"too many event streams"
                self.send_header("Content-Type", "text/plain")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
                from svoc_torch.utils.metrics import registry as _metrics

                _metrics.counter("sse_rejected").add(1)
                return
            self.server.svoc_sse_streams += 1
        session = self.console.session
        try:
            self.send_response(200)
            self.send_header("Content-Type", "text/event-stream")
            self.send_header("Cache-Control", "no-cache")
            self.end_headers()
            last_version = None
            last_write = 0.0
            last_seq = 0
            if want_journal:
                from svoc_torch.utils.events import journal as _journal

                # Stream only NEW events — a reconnecting tab must not
                # replay the whole ring through its own frames.
                last_seq = _journal.last_seq()
            while not getattr(self.server, "svoc_shutting_down", False):
                with session.lock:
                    version = session.state_version
                now = _time.monotonic()
                if version != last_version:
                    frame = json.dumps({"state_version": version})
                    self.wfile.write(f"data: {frame}\n\n".encode())
                    self.wfile.flush()
                    last_version, last_write = version, now
                elif now - last_write > 15.0:
                    self.wfile.write(b": keepalive\n\n")  # SSE comment
                    self.wfile.flush()
                    last_write = now
                if want_journal:
                    # ≤ 50 typed frames per tick: a journal burst drains
                    # over a few ticks instead of wedging this write
                    # loop (the busy-loop guard the cap test pins).
                    # Truncation is VISIBLE, not silent
                    # (docs/OBSERVABILITY.md §events): a capped tick
                    # marks its LAST frame ``truncated: true`` and
                    # counts the backlog it deferred in
                    # ``sse_frames_dropped{stream="journal"}`` — a
                    # consumer can tell "caught up" from "drinking from
                    # a burst through a straw".
                    batch = _journal.since(last_seq, limit=50)
                    if batch:
                        backlog = _journal.last_seq() - batch[-1].seq
                        for i, rec in enumerate(batch):
                            if backlog > 0 and i == len(batch) - 1:
                                payload = rec.as_dict()
                                payload["truncated"] = True
                                data = json.dumps(payload, sort_keys=True)
                            else:
                                data = rec.to_json()
                            self.wfile.write(
                                f"event: journal\ndata: {data}\n\n".encode()
                            )
                            last_seq = rec.seq
                        if backlog > 0:
                            from svoc_torch.utils.metrics import (
                                registry as _metrics,
                            )

                            _metrics.counter(
                                "sse_frames_dropped",
                                labels={"stream": "journal"},
                            ).add(backlog)
                        self.wfile.flush()
                        last_write = now
                _time.sleep(0.25)
        except (OSError, ValueError):
            # Client went away (BrokenPipe/Reset) or the handler's
            # wfile was torn down mid-write ("I/O operation on closed
            # file" surfaces as ValueError) — either way this stream is
            # done; the slot release below is what matters.
            return
        finally:
            with self.server.svoc_sse_lock:
                self.server.svoc_sse_streams -= 1

    def _serve_profile(self) -> None:
        """``GET /api/profile`` — on-demand profiler control
        (docs/OBSERVABILITY.md §cost-attribution).  ``?action=start``
        (optional ``&duration_s=``), ``?action=stop``, or
        ``?action=status`` (default).  503 when no profiler is
        attached; the profiler itself never raises — a capture error
        comes back as its status dict (500)."""
        profiler = getattr(self.console, "profiler", None)
        if profiler is None:
            self._send(
                503,
                json.dumps({"error": "no profiler attached"}).encode(),
                "application/json",
            )
            return
        query = self.path.split("?", 1)[1] if "?" in self.path else ""
        params = dict(
            p.split("=", 1) for p in query.split("&") if "=" in p
        )
        action = params.get("action", "status")
        if action == "start":
            try:
                duration_s = (
                    float(params["duration_s"])
                    if "duration_s" in params
                    else None
                )
            except ValueError:
                self._send(
                    400,
                    json.dumps({"error": "duration_s must be a number"}).encode(),
                    "application/json",
                )
                return
            result = profiler.start(duration_s=duration_s)
        elif action == "stop":
            result = profiler.stop()
        elif action == "status":
            result = profiler.status()
        else:
            self._send(
                400,
                json.dumps({"error": f"unknown action {action!r}"}).encode(),
                "application/json",
            )
            return
        code = 500 if result.get("status") == "error" else 200
        self._send(code, json.dumps(result).encode(), "application/json")

    def do_POST(self):  # noqa: N802
        if self.path not in ("/api/query", "/api/submit"):
            self._send(404, b"not found", "text/plain")
            return
        # CSRF guard: a text/plain POST is a "simple request", so any
        # page open in a local browser could otherwise drive the session
        # (incl. chain transactions and 'exit').  Browsers always attach
        # Origin to cross-origin POSTs — reject when it names another
        # host; header-free clients (curl, tests) pass.  _host_ok()
        # additionally blocks DNS rebinding, where Origin and Host match
        # each other but name the attacker's domain.
        if not self._host_ok():
            self._send(403, b"unexpected Host header", "text/plain")
            return
        origin = self.headers.get("Origin")
        if origin is not None and origin.split("://", 1)[-1] != self.headers.get(
            "Host", ""
        ):
            self._send(403, b"cross-origin request rejected", "text/plain")
            return
        length = int(self.headers.get("Content-Length", "0"))
        text = self.rfile.read(length).decode("utf-8", "replace")
        if self.path == "/api/submit":
            self._serve_submit(text)
            return
        lines = self.console.query(text)
        self._send(200, json.dumps(lines).encode(), "application/json")

    def _serve_submit(self, body: str) -> None:
        """``POST /api/submit`` — the serving tier's ingestion edge
        (docs/SERVING.md §api).  Body: ``{"claim": ..., "text": ...}``.
        Status codes carry the admission verdict: 200 for served
        (``admitted``/``cached``), **429** for ``shed`` (the standard
        shed-load response — well-behaved clients back off, which is
        the point of admission control), 404 for an unknown claim, 503
        when no serving tier is attached."""
        serving = getattr(self.console, "serving", None)
        if serving is None:
            self._send(
                503,
                json.dumps({"error": "no serving tier attached"}).encode(),
                "application/json",
            )
            return
        try:
            request = json.loads(body)
            claim = request["claim"]
            text = request["text"]
        except (ValueError, TypeError, KeyError):
            self._send(
                400,
                json.dumps(
                    {"error": 'body must be {"claim": ..., "text": ...}'}
                ).encode(),
                "application/json",
            )
            return
        if not isinstance(claim, str) or not isinstance(text, str):
            self._send(
                400,
                json.dumps({"error": "claim and text must be strings"}).encode(),
                "application/json",
            )
            return
        try:
            response = serving.submit(claim, text)
        except KeyError:
            self._send(
                404,
                json.dumps({"error": f"unknown claim {claim!r}"}).encode(),
                "application/json",
            )
            return
        code = 429 if response["status"] == "shed" else 200
        self._send(code, json.dumps(response).encode(), "application/json")

    def log_message(self, *args):  # silence request logging
        pass


def serve(
    console: CommandConsole,
    host: str = "127.0.0.1",
    port: int = 8100,
    block: bool = True,
) -> Tuple[ThreadingHTTPServer, Optional[threading.Thread]]:
    """Start the UI server.  ``block=False`` runs it on a daemon thread
    and returns ``(server, thread)`` (the test/embedding mode; the
    reference's ``eel.start(block=False)``, ``web_interface.py:61-67``)."""
    handler = type("BoundHandler", (_Handler,), {"console": console})
    if host not in ("127.0.0.1", "localhost", "::1"):
        import warnings

        warnings.warn(
            f"svoc web UI binding to non-loopback host {host!r}: the "
            "query endpoint executes console commands (incl. chain "
            "transactions) for anyone who can reach it",
            stacklevel=2,
        )
    server = ThreadingHTTPServer((host, port), handler)
    # Cooperative stop flag for the long-lived /api/events streams
    # (daemon threads — this bounds their lifetime under test servers
    # that start and stop within one process).
    server.svoc_shutting_down = False
    # Live SSE stream accounting (the MAX_SSE_STREAMS cap).
    server.svoc_sse_streams = 0
    server.svoc_sse_lock = threading.Lock()
    orig_shutdown = server.shutdown

    def shutdown():
        server.svoc_shutting_down = True
        orig_shutdown()

    server.shutdown = shutdown
    if block:  # pragma: no cover — interactive mode
        server.serve_forever()
        return server, None
    # Tight poll interval: shutdown() blocks a full poll period, and
    # embedded/test servers start and stop constantly — the stdlib
    # default of 0.5 s turns every teardown into half a second.
    thread = threading.Thread(
        target=lambda: server.serve_forever(poll_interval=0.05), daemon=True
    )
    thread.start()
    return server, thread


def main(argv=None) -> int:  # pragma: no cover — interactive entry
    import argparse

    from svoc_torch.apps.cli import build_parser, session_device

    parser = build_parser()
    parser.add_argument("--port", type=int, default=8100)
    parser.add_argument("--host", default="127.0.0.1")
    args = parser.parse_args(argv)

    from svoc_torch.apps.session import Session, SessionConfig
    from svoc_torch.io.comment_store import CommentStore
    from svoc_torch.io.scraper import SyntheticSource

    store = CommentStore(args.db)
    if store.count() == 0 and args.seed_comments:
        store.save(SyntheticSource(batch=args.seed_comments)())
    from svoc_torch.apps.cli import build_adapter

    session = Session(
        config=SessionConfig(
            n_oracles=args.n_oracles,
            n_failing=args.n_failing,
            dimension=args.dimension,
            refresh_rate_s=args.refresh,
            scraper_rate_s=args.rate,
            live_scraper=args.live_scraper,
            quant_inference="int8" if args.int8 else None,
        ),
        store=store,
        adapter=build_adapter(args),
        device=session_device(args),
    )
    console = CommandConsole(session, write=print)
    # Startup resume+fetch (reference main.py:51-54).  fetch is the
    # only stage that touches the device; a failure is reported by the
    # console itself (CommandConsole.query catches and emits errors)
    # and does not prevent the server from starting.  Pass
    # --disable_startup_fetch for fully device-free startup.
    console.query("resume")
    if not args.disable_startup_fetch:
        console.query("fetch")
    print(f"svoc web UI on http://{args.host}:{args.port}")
    serve(console, host=args.host, port=args.port, block=True)
    return 0


if __name__ == "__main__":  # pragma: no cover
    raise SystemExit(main())
