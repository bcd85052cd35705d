"""GET /debug/dashboard: a self-contained live fleet dashboard.

Port of pilosa_tpu/net/dashboard.py: one HTML file, with inline CSS, JS
and SVG sparklines and no external asset or URL, so it works air-gapped
from any node's port. It reads the JSON routes operators script against:
/cluster/stats (the fleet table and each node's sparkline tail, once a
refresh), /debug/timeseries (this node's rings, incrementally with the
since cursor), /debug/usage (top principals and SLO burn), /debug/heat
(the fragment heat grid) and /debug/events (the event feed).

The JAX page draws XLA compile series (`xla.compiles`,
`xla.compiles_per_s`). A port node compiles nothing per shape (its CUDA
kernels are built once per process), so this page has no compile series
and draws what the card has instead, under the port's gauge names
(server.py sample_gauges): the caching allocator's device memory
(`device.bytes_in_use`, `device.bytes_reserved`) and kernel launches
(`kernels.dispatches_per_s`). A gauge a node does not report shows as a
dash, so a fleet of port and JAX nodes renders from either side.
"""

from __future__ import annotations

DASHBOARD_HTML = """<!DOCTYPE html>
<html lang="en">
<head>
<meta charset="utf-8">
<meta name="viewport" content="width=device-width, initial-scale=1">
<title>pilosa-tpu-torch fleet telemetry</title>
<style>
:root {
  color-scheme: light;
  --surface: #fcfcfb; --panel: #f0efec;
  --text: #0b0b0b; --text-2: #52514e; --grid: #d8d7d2;
  --series: #2a78d6;
  --good: #008300; --warn: #eda100; --bad: #e34948; --muted: #52514e;
}
@media (prefers-color-scheme: dark) {
  :root {
    color-scheme: dark;
    --surface: #1a1a19; --panel: #262625;
    --text: #ffffff; --text-2: #c3c2b7; --grid: #3a3a38;
    --series: #3987e5;
    --good: #1baf7a; --warn: #c98500; --bad: #e66767; --muted: #c3c2b7;
  }
}
* { box-sizing: border-box; }
body { margin: 0; padding: 16px 20px; background: var(--surface);
  color: var(--text);
  font: 13px/1.45 ui-monospace, SFMono-Regular, Menlo, Consolas, monospace; }
h1 { font-size: 16px; margin: 0 0 2px; font-weight: 600; }
h2 { font-size: 13px; margin: 18px 0 6px; color: var(--text-2);
  font-weight: 600; text-transform: uppercase; letter-spacing: .04em; }
.sub { color: var(--text-2); margin-bottom: 12px; }
table { border-collapse: collapse; width: 100%; }
th, td { text-align: left; padding: 4px 10px 4px 0; white-space: nowrap; }
th { color: var(--text-2); font-weight: 600; border-bottom: 1px solid
  var(--grid); }
tr + tr td { border-top: 1px solid var(--grid); }
td.num, th.num { text-align: right; }
.health { font-weight: 600; }
.health .dot { display: inline-block; width: 9px; height: 9px;
  border-radius: 50%; margin-right: 6px; vertical-align: baseline; }
.health-green  { color: var(--good); } .health-green  .dot { background: var(--good); }
.health-yellow { color: var(--warn); } .health-yellow .dot { background: var(--warn); border-radius: 2px; }
.health-red    { color: var(--bad); }  .health-red    .dot { background: var(--bad); border-radius: 0; }
.health-legacy, .health-unknown { color: var(--muted); }
.health-legacy .dot, .health-unknown .dot { background: none;
  border: 1.5px solid var(--muted); }
.reasons { color: var(--text-2); white-space: normal; max-width: 340px; }
svg.spark { display: block; }
svg.spark polyline { fill: none; stroke: var(--series); stroke-width: 2;
  stroke-linejoin: round; stroke-linecap: round; }
svg.spark line.base { stroke: var(--grid); stroke-width: 1; }
.tiles { display: flex; flex-wrap: wrap; gap: 12px; }
.tile { background: var(--panel); border-radius: 6px; padding: 10px 12px;
  min-width: 230px; }
.tile .name { color: var(--text-2); font-size: 11px; }
.tile .val { font-size: 18px; font-weight: 600; margin: 2px 0 6px; }
.heatgrid { display: flex; flex-wrap: wrap; gap: 3px; max-width: 860px; }
.heatgrid .cell { width: 34px; height: 22px; border-radius: 3px;
  background: var(--series); }
#err { color: var(--bad); }
a { color: var(--series); }
</style>
</head>
<body>
<h1>pilosa-tpu-torch fleet telemetry</h1>
<div class="sub" id="meta">loading&hellip;</div>
<div id="err"></div>

<h2>SLO burn</h2>
<div class="tiles" id="slo"></div>

<h2>Top principals (usage)</h2>
<table id="usage"><thead><tr>
  <th>principal</th><th class="num">device ms</th><th class="num">HBM moved</th>
  <th class="num">RPC bytes</th><th class="num">queue ms</th>
  <th class="num">queries</th><th class="num">errors</th>
  <th class="num">cache hits</th>
</tr></thead><tbody></tbody></table>

<h2>Fragment heat</h2>
<div class="sub" id="heatmeta"></div>
<div id="heatgrid" class="heatgrid"></div>

<h2>Event feed (flight recorder)</h2>
<div class="sub" id="eventsmeta"></div>
<table id="events"><thead><tr>
  <th>time</th><th>type</th><th class="reasons">detail</th>
</tr></thead><tbody></tbody></table>

<h2>Fleet</h2>
<table id="fleet"><thead><tr>
  <th>health</th><th>node</th><th>state</th><th class="num">uptime</th>
  <th>version</th><th class="num">rss</th><th class="num">HBM resident</th>
  <th class="num">hit rate</th><th class="num">device in use</th>
  <th class="num">launches / s</th>
  <th class="num">damaged</th><th>residency bytes</th><th>queue depth</th>
  <th class="reasons">why</th>
</tr></thead><tbody></tbody></table>

<h2>This node (full-resolution rings)</h2>
<div class="sub">no compile series: the node builds its CUDA kernels once
per process and compiles nothing per shape; device memory is the CUDA
caching allocator's, launches are the hand-written kernels'</div>
<div class="tiles" id="local"></div>

<script>
"use strict";
// local ring accumulated incrementally: /debug/timeseries?since=<cursor>
// transfers each sample exactly once regardless of refresh rate
let cursor = 0;
const localSamples = [];   // bounded client-side to the server ring size
let localLimit = 720;
const LOCAL_SERIES = [
  ["residency.bytes", "device resident bytes", fmtBytes],
  ["residency.hit_rate", "residency hit rate (window)", fmtRatio],
  ["residency.evictions_per_s", "evictions / s", fmtNum],
  ["batcher.queue_depth", "batcher queue depth", fmtNum],
  ["batcher.avg_wait_ms", "batch wait ms (window)", fmtNum],
  ["plancache.hit_rate", "plan-cache hit rate (window)", fmtRatio],
  ["heat.skew", "fragment heat skew (hottest / mean)", fmtNum],
  ["heat.hot_fragments", "hot fragments", fmtNum],
  ["planner.reorders_per_s", "planner reorders / s", fmtNum],
  ["hybrid.sparse_bytes", "hybrid sparse resident bytes", fmtBytes],
  ["hybrid.run_bytes", "hybrid run resident bytes", fmtBytes],
  ["ingest.sets_per_s", "ingest mutations / s", fmtNum],
  ["ingest.wal_appends_per_s", "ingest WAL group commits / s", fmtNum],
  ["usage.queries_per_s", "accounted queries / s", fmtNum],
  ["qos.admitted_per_s", "QoS admitted / s", fmtNum],
  ["qos.shed_per_s", "QoS shed / s", fmtNum],
  ["qos.throttled_per_s", "QoS throttled (429) / s", fmtNum],
  ["qos.estimated_wait_ms", "QoS est. wait ms", fmtNum],
  ["kernels.dispatches_per_s", "kernel launches / s", fmtNum],
  ["kernels.avg_dispatch_ms", "kernel dispatch ms (window)", fmtNum],
  ["kernels.h2d_bytes_per_s", "host-to-device bytes / s", fmtBytes],
  ["device.bytes_in_use", "device memory in use (allocator)", fmtBytes],
  ["device.bytes_reserved", "device memory reserved (allocator)", fmtBytes],
  ["process.rss_bytes", "process RSS", fmtBytes],
];

function fmtBytes(v) {
  if (v == null) return "–";
  const u = ["B", "KiB", "MiB", "GiB", "TiB"];
  let i = 0;
  while (v >= 1024 && i < u.length - 1) { v /= 1024; i++; }
  return (i ? v.toFixed(1) : v) + " " + u[i];
}
function fmtNum(v) {
  if (v == null) return "–";
  return Math.abs(v) >= 100 ? Math.round(v).toString()
       : (Math.round(v * 100) / 100).toString();
}
function fmtRatio(v) { return v == null ? "–" : (100 * v).toFixed(1) + "%"; }
function fmtUptime(s) {
  if (s == null) return "–";
  s = Math.floor(s);
  const d = Math.floor(s / 86400), h = Math.floor(s % 86400 / 3600),
        m = Math.floor(s % 3600 / 60);
  return d ? d + "d" + h + "h" : h ? h + "h" + m + "m" : m + "m" + s % 60 + "s";
}

// inline SVG sparkline: thin 2px line, baseline rule, <title> hover text.
// Built as markup (the HTML parser namespaces <svg> itself) so the page
// contains no URL strings at all — the air-gap test stays trivially true.
function esc(s) {
  return String(s).replace(/&/g, "&amp;").replace(/</g, "&lt;");
}
function spark(values, w, h, fmt) {
  const host = document.createElement("span");
  let inner = '<line class="base" x1="0" y1="' + (h - 1) + '" x2="' + w +
              '" y2="' + (h - 1) + '"></line>';
  const pts = values.filter(v => v != null && isFinite(v));
  if (pts.length > 1) {
    const lo = Math.min(...pts), hi = Math.max(...pts);
    const span = (hi - lo) || 1;
    const step = w / (values.length - 1);
    const coords = values.map((v, i) => {
      if (v == null || !isFinite(v)) v = lo;
      const y = h - 3 - (h - 6) * (v - lo) / span;
      return (i * step).toFixed(1) + "," + y.toFixed(1);
    }).join(" ");
    inner += '<polyline points="' + coords + '"></polyline>' +
      "<title>" + esc("min " + fmt(lo) + " · max " + fmt(hi) +
                      " · last " + fmt(pts[pts.length - 1])) + "</title>";
  }
  host.innerHTML = '<svg class="spark" width="' + w + '" height="' + h +
    '" viewBox="0 0 ' + w + " " + h + '">' + inner + "</svg>";
  return host.firstChild;
}

function seriesOf(samples, name) {
  return samples.map(s => {
    const v = (s.gauges || {})[name];
    return typeof v === "number" ? v : null;
  });
}

function healthCell(score, reasons) {
  const td = document.createElement("td");
  td.className = "health health-" + score;
  const dot = document.createElement("span");
  dot.className = "dot";
  td.appendChild(dot);
  td.appendChild(document.createTextNode(score));
  if (reasons && reasons.length) td.title = reasons.join("; ");
  return td;
}

function td(text, num) {
  const el = document.createElement("td");
  if (num) el.className = "num";
  el.textContent = text;
  return el;
}

function renderFleet(doc) {
  const meta = document.getElementById("meta");
  const f = doc.fleet || {};
  meta.textContent = "fleet " + (f.health || "?") + " · " +
    (f.nodes || []).length + " node(s)" +
    Object.entries(f.counts || {}).filter(([, n]) => n)
      .map(([k, n]) => " · " + n + " " + k).join("") +
    " · reported by " + (doc.generatedBy || "?") + " at " +
    new Date().toLocaleTimeString();
  const body = document.querySelector("#fleet tbody");
  body.textContent = "";
  for (const n of (f.nodes || [])) {
    const tr = document.createElement("tr");
    const h = n.health || {};
    tr.appendChild(healthCell(h.score || "unknown", h.reasons));
    tr.appendChild(td((n.id || "?").slice(0, 12) + "  " + (n.uri || "")));
    tr.appendChild(td(n.state || "–"));
    tr.appendChild(td(fmtUptime(n.uptimeSeconds), true));
    tr.appendChild(td(n.version || "–"));
    const g = (n.gauges || {});
    tr.appendChild(td(fmtBytes(g["process.rss_bytes"]), true));
    tr.appendChild(td(fmtBytes(g["residency.bytes"]), true));
    tr.appendChild(td(fmtRatio(g["residency.hit_rate"]), true));
    tr.appendChild(td(fmtBytes(g["device.bytes_in_use"]), true));
    tr.appendChild(td(fmtNum(g["kernels.dispatches_per_s"]), true));
    tr.appendChild(td(fmtNum(n.damagedFragments || 0), true));
    const samples = (n.timeseries || {}).samples || [];
    for (const name of ["residency.bytes", "batcher.queue_depth"]) {
      const cell = document.createElement("td");
      cell.appendChild(spark(seriesOf(samples, name), 120, 26,
        name === "residency.bytes" ? fmtBytes : fmtNum));
      tr.appendChild(cell);
    }
    const why = document.createElement("td");
    why.className = "reasons";
    why.textContent = (h.reasons || []).join("; ");
    tr.appendChild(why);
    body.appendChild(tr);
  }
}

function renderLocal() {
  const root = document.getElementById("local");
  root.textContent = "";
  for (const [name, label, fmt] of LOCAL_SERIES) {
    const vals = seriesOf(localSamples, name);
    if (!vals.some(v => v != null)) continue;
    const tile = document.createElement("div");
    tile.className = "tile";
    const nm = document.createElement("div");
    nm.className = "name"; nm.textContent = label;
    const last = [...vals].reverse().find(v => v != null);
    const val = document.createElement("div");
    val.className = "val"; val.textContent = fmt(last);
    tile.appendChild(nm); tile.appendChild(val);
    tile.appendChild(spark(vals, 220, 40, fmt));
    root.appendChild(tile);
  }
  if (!root.children.length) {
    root.textContent = "no samples yet (telemetry sampler off or warming)";
  }
}

// per-principal usage table + SLO burn tiles (GET /debug/usage: this
// node's ledger, the burn-rate evaluation riding along)
function renderUsage(doc) {
  const body = document.querySelector("#usage tbody");
  body.textContent = "";
  const entries = Object.entries(doc.principals || {}).slice(0, 12);
  for (const [name, e] of entries) {
    const tr = document.createElement("tr");
    tr.appendChild(td(name));
    tr.appendChild(td(fmtNum(e.deviceMs), true));
    tr.appendChild(td(fmtBytes(e.hbmBytes), true));
    tr.appendChild(td(fmtBytes(e.rpcBytes), true));
    tr.appendChild(td(fmtNum(e.queueMs), true));
    tr.appendChild(td(fmtNum(e.queries), true));
    tr.appendChild(td(fmtNum(e.errors), true));
    tr.appendChild(td(fmtNum(e.planCacheHits), true));
    body.appendChild(tr);
  }
  if (!entries.length) {
    const tr = document.createElement("tr");
    tr.appendChild(td("no accounted traffic yet"));
    body.appendChild(tr);
  }
  const root = document.getElementById("slo");
  root.textContent = "";
  for (const [name, ob] of Object.entries(doc.slo || {})) {
    const tile = document.createElement("div");
    tile.className = "tile";
    const nm = document.createElement("div");
    nm.className = "name";
    nm.textContent = name + " (target " + (100 * ob.target).toFixed(2) +
      "%" + (ob.latencyMs ? " < " + ob.latencyMs + " ms" : "") + ")";
    const val = document.createElement("div");
    val.className = "val health health-" + ob.status;
    const dot = document.createElement("span");
    dot.className = "dot";
    val.appendChild(dot);
    val.appendChild(document.createTextNode(
      ob.status + " · burn " + fmtNum(ob.burnShort) + "x (5m) / " +
      fmtNum(ob.burnLong) + "x (1h)"));
    tile.appendChild(nm); tile.appendChild(val);
    root.appendChild(tile);
  }
  if (!root.children.length) {
    root.textContent = "no [slo] objectives configured";
  }
}

// fragment heat grid (GET /debug/heat): one cell per hot fragment,
// intensity = score relative to the hottest — the at-a-glance "is one
// fragment set carrying the node" panel; hover for the coordinate
function renderHeat(doc) {
  const meta = document.getElementById("heatmeta");
  meta.textContent = (doc.trackedFragments || 0) + " tracked · " +
    (doc.hotFragments || 0) + " hot · skew " + fmtNum(doc.skew || 1) +
    "x · " + (doc.spilledFragments || 0) + " spilled" +
    (doc.enabled === false ? " · TRACKING OFF" : "");
  const grid = document.getElementById("heatgrid");
  grid.textContent = "";
  const entries = (doc.hot || []).slice(0, 48);
  const max = entries.length ? entries[0].score || 0 : 0;
  for (const e of entries) {
    const cell = document.createElement("div");
    cell.className = "cell";
    const rel = max > 0 ? (e.score || 0) / max : 0;
    cell.style.opacity = (0.15 + 0.85 * rel).toFixed(2);
    cell.title = e.index + "/" + e.field + "/" + e.view + "/" + e.shard +
      "  score=" + e.score + "  reads/s=" + e.readsPerS;
    grid.appendChild(cell);
  }
  if (!entries.length) {
    grid.textContent = "no heated fragments yet";
  }
}

// flight-recorder event feed (GET /debug/events): incremental via the
// same since-cursor discipline as the time-series ring — each event
// crosses the wire once; newest 40 rendered, lifecycle before log
let eventsCursor = 0;
const eventRows = [];
function renderEvents(doc) {
  for (const e of (doc.events || [])) eventRows.push(e);
  while (eventRows.length > 200) eventRows.shift();
  const meta = document.getElementById("eventsmeta");
  meta.textContent = eventRows.length + " retained client-side" +
    (doc.enabled === false ? " · RECORDER OFF" : "") +
    " · merged cluster view: GET /cluster/events or the timeline subcommand";
  const body = document.querySelector("#events tbody");
  body.textContent = "";
  const skip = { hlc: 1, ts: 1, type: 1, node: 1, seq: 1, trace: 1 };
  for (const e of eventRows.slice(-40).reverse()) {
    const tr = document.createElement("tr");
    tr.appendChild(td(new Date((e.hlc || [0])[0]).toLocaleTimeString()));
    const ty = td(e.type);
    if (e.type === "health.transition") {
      ty.className = "health health-" + (e.toScore || "yellow");
    }
    tr.appendChild(ty);
    const detail = Object.keys(e).filter(k => !skip[k]).sort()
      .map(k => k + "=" + JSON.stringify(e[k])).join(" ");
    const dt = document.createElement("td");
    dt.className = "reasons";
    dt.textContent = detail;
    tr.appendChild(dt);
    body.appendChild(tr);
  }
  if (!eventRows.length) {
    const tr = document.createElement("tr");
    tr.appendChild(td("no events yet"));
    body.appendChild(tr);
  }
}

async function refresh() {
  const err = document.getElementById("err");
  try {
    const ts = await (await fetch("/debug/timeseries?since=" + cursor)).json();
    cursor = ts.seq || cursor;
    if (ts.ringSize) localLimit = ts.ringSize;
    for (const s of (ts.samples || [])) localSamples.push(s);
    while (localSamples.length > localLimit) localSamples.shift();
    renderLocal();
    const us = await (await fetch("/debug/usage?top=12")).json();
    renderUsage(us);
    const ht = await (await fetch("/debug/heat?top=48")).json();
    renderHeat(ht);
    const ev = await (await fetch("/debug/events?since=" + eventsCursor)).json();
    eventsCursor = ev.seq || eventsCursor;
    renderEvents(ev);
    const cs = await (await fetch("/cluster/stats")).json();
    renderFleet(cs);
    err.textContent = "";
  } catch (e) {
    err.textContent = "refresh failed: " + e;
  }
  setTimeout(refresh, 4000);
}
refresh();
</script>
</body>
</html>
"""


def render_dashboard() -> str:
    return DASHBOARD_HTML
