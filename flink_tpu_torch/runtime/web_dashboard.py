"""Single-file web dashboard served by the REST server at '/'.

A deliberately dependency-free stand-in for the reference's Angular SPA
(flink-runtime-web/web-dashboard): one HTML document with inline JS that
polls the same public REST endpoints a human or script would use
(/overview, /jobs, /jobs/<id>, /jobs/<id>/metrics, /jobs/<id>/traces) and
renders job state, throughput, busy ratio, checkpoints, restarts, and the
checkpoint span feed. Deep links: Prometheus text at /metrics, flame graphs
at /flamegraph.

Counterpart of `flink_tpu/runtime/web_dashboard.py`: the same panels over
the same payloads (the device plane's table reads `/jobs/<id>/device`),
titled for the port.
"""

DASHBOARD_HTML = """<!DOCTYPE html>
<html><head><title>flink-tpu-torch dashboard</title>
<meta charset="utf-8">
<style>
 :root { --bg:#101418; --panel:#161b22; --line:#2e3440; --fg:#d8dee9;
         --dim:#7a8494; --ok:#a3be8c; --info:#81a1c1; --bad:#bf616a;
         --warn:#ebcb8b; }
 body { font-family: ui-monospace, Menlo, monospace; margin: 0;
        background: var(--bg); color: var(--fg); }
 header { padding: 14px 22px; border-bottom: 1px solid var(--line);
          display: flex; gap: 18px; align-items: baseline; }
 h1 { font-size: 1.05rem; margin: 0; }
 h3 { font-size: 0.82rem; margin: 14px 0 4px; color: var(--dim);
      font-weight: normal; text-transform: uppercase; letter-spacing: 1px; }
 #overview { color: var(--dim); }
 header a { color: var(--info); text-decoration: none; margin-left: 10px; }
 main { padding: 18px 22px; }
 table { border-collapse: collapse; width: 100%; }
 td, th { border-bottom: 1px solid var(--line); padding: 7px 12px;
          text-align: left; font-size: 0.86rem; }
 th { color: var(--dim); font-weight: normal; }
 tr.job { cursor: pointer; }
 tr.job:hover { background: var(--panel); }
 .RUNNING { color: var(--ok); } .FINISHED { color: var(--info); }
 .FAILED { color: var(--bad); }
 .CANCELED, .RESTARTING, .RESCALING, .CREATED { color: var(--warn); }
 .detail { background: var(--panel); }
 .detail td { padding: 12px 16px; }
 .kv { display: grid; grid-template-columns: repeat(auto-fill, minmax(210px, 1fr));
       gap: 6px 18px; margin-bottom: 8px; }
 .kv div span { color: var(--dim); margin-right: 6px; }
 .spans { margin-top: 8px; color: var(--dim); font-size: 0.8rem;
          max-height: 140px; overflow-y: auto; }
 .empty { color: var(--dim); padding: 30px 0; }
</style></head>
<body>
<header>
  <h1>flink-tpu-torch &mdash; streaming on CUDA</h1>
  <div id="overview">loading&hellip;</div>
  <nav>
    <a href="/metrics">prometheus</a>
    <a href="/flamegraph">flamegraph</a>
  </nav>
</header>
<main>
  <table id="jobs"><thead>
    <tr><th>job id</th><th>name</th><th>status</th><th>records in</th>
        <th>rec/s</th><th>busy</th><th>restarts</th><th>checkpoints</th></tr>
  </thead><tbody id="rows"></tbody></table>
  <div id="none" class="empty" hidden>no jobs submitted yet</div>
</main>
<script>
const open = new Set();
const esc = (v) => String(v).replace(/[&<>"']/g,
  c => ({"&":"&amp;","<":"&lt;",">":"&gt;",'"':"&quot;","'":"&#39;"}[c]));
const fmt = (v, d=1) => v == null ? "-" :
  (typeof v === "number" ? (v >= 1e6 ? (v/1e6).toFixed(d)+"M"
   : v >= 1e3 ? (v/1e3).toFixed(d)+"k" : (Number.isInteger(v) ? v : v.toFixed(d))) : v);
async function j(url) { const r = await fetch(url); return r.json(); }

function kv(obj) {
  return '<div class="kv">' + Object.entries(obj).map(
    ([k, v]) => `<div><span>${k}</span>${v}</div>`).join("") + "</div>";
}

const bpClass = (r) => r > 0.5 ? "FAILED" : (r > 0.1 ? "CANCELED" : "RUNNING");
const cpClass = (s) => s === "COMPLETED" ? "RUNNING"
  : (s === "FAILED" ? "FAILED" : "CREATED");

function checkpointSection(cps) {
  // checkpoint & recovery observability: lifetime counts, last restore,
  // and the bounded per-checkpoint history ring (/jobs/:id/checkpoints)
  if (!cps || !cps.counts || !(cps.counts.total || cps.counts.failed)) return "";
  const rows = (cps.history || []).slice(0, 8).map(c => `<tr>
    <td>${esc(c.id)}</td>
    <td class="${cpClass(c.status)}">${esc(c.status)}${c.is_savepoint ? " (sp)" : ""}</td>
    <td>${fmt(c.end_to_end_duration_ms)}</td>
    <td>${fmt(c.sync_duration_ms)} / ${fmt(c.async_duration_ms)}</td>
    <td>${fmt(c.state_size_bytes)}</td>
    <td>${esc((c.failure_cause ?? "").slice(0, 60))}</td></tr>`);
  const r = cps.latest?.restored;
  return "<h3>checkpoints</h3>" + kv({
    "completed": fmt(cps.counts.completed),
    "failed": fmt(cps.counts.failed),
    "in progress": fmt(cps.counts.in_progress),
    "last restore": r == null ? "-" :
      `chk ${r.checkpoint_id ?? "?"} in ${fmt(r.restore_duration_ms)}ms`,
  }) + (rows.length ? `<table><thead><tr><th>id</th><th>status</th>
    <th>e2e ms</th><th>sync/async ms</th><th>bytes</th><th>failure</th></tr>
    </thead><tbody>${rows.join("")}</tbody></table>` : "");
}

function exceptionSection(exc) {
  // bounded exception history + recovery timeline (/jobs/:id/exceptions)
  if (!exc || !(exc.entries ?? []).length) return "";
  const entries = exc.entries.slice(0, 6).map(e => esc(
    `#${e.restart_number} ${new Date(e.timestamp_ms).toISOString()} ` +
    `[${e.task ?? "?"}${e.task_manager ? " @ " + e.task_manager : ""}] ` +
    e.exception)).join("<br>");
  const recs = (exc.recoveries ?? []).slice(0, 4).map(r => esc(
    `${r.kind === "rescale" ? "rescale" : "restart"} #${r.restart_number}: ` +
    `rewound to chk ${r.restored_checkpoint_id ?? "none"}, ` +
    `restore ${fmt(r.restore_duration_ms)}ms, downtime ${fmt(r.downtime_ms)}ms` +
    (r.steps_replayed != null ? `, ${r.steps_replayed} steps replayed` : "") +
    (r.events_replayed != null ? `, ${fmt(r.events_replayed)} events replayed` : "")
  )).join("<br>");
  return `<h3>exceptions</h3><div class="spans">${entries}</div>` +
    (recs ? `<div class="spans">${recs}</div>` : "");
}

function autoscalerSection(a) {
  // elastic autoscaler (/jobs/:id/autoscaler): parallelism, rescale
  // counters and the bounded decision log (signals seen -> action ->
  // outcome); hidden for jobs with no autoscaler and no decisions
  if (!a || (!a.enabled && !(a.decisions ?? []).length && !a.num_rescales))
    return "";
  const actClass = (d) => d.outcome === "executed" ? "RUNNING"
    : (String(d.outcome).startsWith("rejected") ? "FAILED" : "CREATED");
  const rows = (a.decisions ?? []).slice(0, 8).map(d => `<tr>
    <td>${new Date(d.timestamp_ms).toISOString().slice(11, 19)}</td>
    <td>${esc(d.action)} ${d.parallelism}&rarr;${d.target}</td>
    <td>${fmt(d.signals?.utilization, 2)}</td>
    <td class="${actClass(d)}">${esc(d.outcome)}</td>
    <td>${fmt(d.duration_ms)}</td>
    <td>${esc(String(d.reason).slice(0, 70))}</td></tr>`);
  return "<h3>autoscaler</h3>" + kv({
    "policy": esc(a.policy ?? "off"),
    "parallelism": fmt(a.parallelism),
    "rescales": fmt(a.num_rescales),
    "last rescale ms": fmt(a.last_rescale_duration_ms),
  }) + (rows.length ? `<table><thead><tr><th>at</th><th>action</th>
    <th>util</th><th>outcome</th><th>rescale ms</th><th>reason</th></tr>
    </thead><tbody>${rows.join("")}</tbody></table>` : "");
}

function deviceSection(dev) {
  // device plane (/jobs/:id/device): compile/recompile counters with the
  // bounded cause-attributed event ring, per-operator roofline %, phase
  // counters and key-skew telemetry; hidden when the plane is off
  if (!dev || !dev.enabled) return "";
  const c = dev.compile ?? {};
  const storm = c.recompileStorm
    ? '<span class="FAILED">STORM</span>' : "ok";
  const evs = (c.events ?? []).slice(-8).reverse().map(e => esc(
    `${e.program} [${e.cause}] ${fmt(e.duration_ms)}ms ` +
    `${e.signature ?? ""}`)).join("<br>");
  const ops = Object.entries(dev.operators ?? {}).map(([uid, o]) => `<tr>
    <td>${esc(uid)}</td>
    <td>${fmt(o.compile?.numCompiles)} / ${fmt(o.compile?.numRecompiles)}</td>
    <td>${fmt(o.hbmUtilizationPct, 2)} / ${fmt(o.flopsUtilizationPct, 2)}</td>
    <td>${fmt(o.phases?.ingestRecords)} / ${fmt(o.phases?.fireSteps)}
        / ${fmt(o.phases?.purgeSteps)}</td>
    <td>${fmt(o.keys?.keySkew, 2)}</td>
    <td>${fmt(o.keys?.activeKeys)}</td>
    <td>${esc((o.keys?.hotKeys ?? []).slice(0, 3)
        .map(h => h[0] + ":" + fmt(h[1])).join(" "))}</td></tr>`);
  const prof = dev.profiler ?? {};
  return "<h3>device plane</h3>" + kv({
    "compiles": fmt(c.numCompiles),
    "recompiles": fmt(c.numRecompiles),
    "compile ms": fmt(c.compileTimeMsTotal),
    "recompile storm": storm,
    "profiler captures": prof.enabled
      ? `${fmt(prof.captures)} &rarr; ${esc(prof.last_capture_dir ?? "-")}`
      : "off",
  }) + (ops.length ? `<table><thead><tr><th>operator</th>
    <th>compiles/re</th><th>hbm/flops %</th><th>ingest/fire/purge</th>
    <th>key skew</th><th>active keys</th><th>hot keys</th></tr></thead>
    <tbody>${ops.join("")}</tbody></table>` : "")
    + skewTable(dev)
    + tierTable(dev)
    + (evs ? `<div class="spans">${evs}</div>` : "");
}

function skewTable(dev) {
  // mesh skew panel (parallel.mesh.*): per-device resident load from the
  // key-stats fold, plus the skew-rebalance routing table when
  // parallel.mesh.skew-rebalance drives placement — an imbalanced mesh
  // must be visible as its worst device AND as what the rebalancer last
  // did about it
  const rows = Object.entries(dev.operators ?? {})
    .filter(([, o]) => (o.keys?.perDevice ?? []).length || o.routing)
    .map(([uid, o]) => {
      const per = (o.keys?.perDevice ?? [])
        .map(d => `${d.device}:${fmt(d.records)}`).join(" ");
      const r = o.routing ?? {};
      return `<tr><td>${esc(uid)}</td>
        <td>${fmt(o.keys?.meshLoadSkew, 2)}</td>
        <td>${esc(per)}</td>
        <td>${r.version !== undefined ? fmt(r.version) : "static"}</td>
        <td>${fmt(r.movedGroups)} / ${fmt(r.numKeyGroups)}</td></tr>`;
    });
  if (!rows.length) return "";
  return `<h3>mesh skew</h3><table><thead><tr><th>operator</th>
    <th>mesh load skew</th><th>per-device records</th>
    <th>routing version</th><th>moved/groups</th></tr></thead>
    <tbody>${rows.join("")}</tbody></table>`;
}

function tierTable(dev) {
  // million-key state plane (state.tier.*): vocabulary size vs resident
  // HBM rows, eviction/promotion churn, cold-tier footprint and the
  // incremental-checkpoint delta size per operator
  const rows = Object.entries(dev.operators ?? {})
    .filter(([, o]) => o.tier)
    .map(([uid, o]) => `<tr><td>${esc(uid)}</td>
      <td>${fmt(o.tier.vocabSize)}</td>
      <td>${fmt(o.tier.residentKeys)} / ${fmt(o.tier.hotKeyCapacity)}</td>
      <td>${fmt(o.tier.evictions)} / ${fmt(o.tier.promotions)}</td>
      <td>${fmt(o.tier.spilledBytes)}</td>
      <td>${o.tier.changelogEnabled ? fmt(o.tier.changelogBytes) : "off"}</td>
      <td>${esc(o.tier.evictionPolicy ?? "")}</td></tr>`);
  if (!rows.length) return "";
  return `<h3>state tier</h3><table><thead><tr><th>operator</th>
    <th>vocab</th><th>resident/cap</th><th>evict/promote</th>
    <th>spilled bytes</th><th>changelog bytes</th><th>policy</th>
    </tr></thead><tbody>${rows.join("")}</tbody></table>`;
}

function latencySection(lat) {
  // emission-latency plane (/jobs/:id/latency): event-time tail per
  // operator (window close -> host-visible) plus the stall-attribution
  // report mapping tail outliers onto concurrent control-plane spans
  // (checkpoint, restore/rescale, compile); hidden with no samples
  if (!lat || !(lat.samples > 0)) return "";
  const ops = Object.entries(lat.operators ?? {}).map(([uid, o]) => {
    const h = o.emissionLatencyMs ?? {};
    return `<tr><td>${esc(uid)}</td>
    <td>${fmt(h.p50, 1)} / ${fmt(h.p99, 1)} / ${fmt(h.p999, 1)}</td>
    <td>${fmt(h.max, 1)}</td>
    <td>${fmt(h.count)}</td>
    <td>${fmt(o.watermarkLagMs, 1)}</td></tr>`;
  });
  const att = lat.attribution ?? {};
  const owners = Object.entries(att.attributed ?? {}).map(([k, v]) => `<tr>
    <td>${esc(k)}</td><td>${fmt(v.count)}</td>
    <td>${fmt(v.maxLatencyMs, 1)}</td></tr>`);
  return "<h3>emission latency</h3>" + kv({
    "p50 / p99 / p999 ms": `${fmt(lat.p50_ms, 1)} / ${fmt(lat.p99_ms, 1)}` +
      ` / ${fmt(lat.p999_ms, 1)}`,
    "samples": fmt(lat.samples),
    "watermark lag ms": fmt(lat.watermarkLagMs, 1),
    "stall outliers": fmt(att.outliers),
    "unattributed": fmt(att.unattributed),
  }) + (ops.length ? `<table><thead><tr><th>operator</th>
    <th>p50/p99/p999 ms</th><th>max ms</th><th>samples</th>
    <th>wm lag ms</th></tr></thead><tbody>${ops.join("")}</tbody>
    </table>` : "")
    + (owners.length ? `<table><thead><tr><th>stall owner span</th>
    <th>outliers</th><th>max ms</th></tr></thead>
    <tbody>${owners.join("")}</tbody></table>` : "");
}

function sparkline(points, w = 180, h = 26) {
  // inline-SVG sparkline over [t, v] pairs from the history rings —
  // dependency-free, one polyline per series
  if (!points || points.length < 2) return "";
  const ts = points.map(p => p[0]), vs = points.map(p => p[1]);
  const t0 = Math.min(...ts), t1 = Math.max(...ts);
  const v0 = Math.min(...vs), v1 = Math.max(...vs);
  const sx = t => t1 > t0 ? (t - t0) / (t1 - t0) * (w - 2) + 1 : w / 2;
  const sy = v => v1 > v0 ? h - 2 - (v - v0) / (v1 - v0) * (h - 4) : h / 2;
  const pts = points.map(p => `${sx(p[0]).toFixed(1)},${sy(p[1]).toFixed(1)}`);
  return `<svg width="${w}" height="${h}" style="vertical-align:middle">
    <polyline fill="none" stroke="#81a1c1" stroke-width="1.2"
      points="${pts.join(" ")}"/></svg>`;
}

function historySection(hist) {
  // metrics history plane (/jobs/:id/history): per-key bounded rings —
  // counters shown as rates, histograms as their p50/p99 sub-series;
  // hidden until the first sampling tick lands
  if (!hist || !hist.series || !Object.keys(hist.series).length) return "";
  const rows = Object.entries(hist.series)
    .filter(([, s]) => (s.points ?? []).length >= 2)
    .slice(0, 14)
    .map(([key, s]) => {
      const last = s.points[s.points.length - 1][1];
      return `<tr><td>${esc(key)}</td>
        <td>${esc(s.kind)}</td>
        <td>${sparkline(s.points)}</td>
        <td>${fmt(last, 2)}</td></tr>`;
    });
  if (!rows.length) return "";
  return `<h3>history (${fmt(hist.sample_count)} samples @ ` +
    `${fmt(hist.interval_ms)}ms)</h3>` +
    `<table><thead><tr><th>metric</th><th>kind</th><th>trend</th>
    <th>last</th></tr></thead><tbody>${rows.join("")}</tbody></table>`;
}

function doctorSection(doc) {
  // job doctor (/jobs/:id/doctor): ranked, evidence-attributed bottleneck
  // diagnosis over the recent history window joined with the span stream
  if (!doc || !(doc.diagnoses ?? []).length && doc.verdict === "unknown")
    return "";
  const vClass = doc.verdict === "healthy" ? "RUNNING"
    : (doc.verdict === "unknown" ? "CREATED" : "FAILED");
  const rows = (doc.diagnoses ?? []).slice(0, 6).map(d => `<tr>
    <td class="${d.score >= 0.5 ? "FAILED" : "CREATED"}">${esc(d.family)}</td>
    <td>${fmt(d.score, 2)}</td>
    <td>${esc(String(d.summary ?? "").slice(0, 90))}</td>
    <td>${esc(Object.entries(d.evidence ?? {}).slice(0, 4)
        .map(([k, v]) => `${k}=${fmt(v, 2)}`).join(" "))}</td></tr>`);
  return `<h3>doctor: <span class="${vClass}">${esc(doc.verdict)}</span>` +
    ` (${fmt(doc.watchdog_events)} watchdog events)</h3>` +
    (rows.length ? `<table><thead><tr><th>family</th><th>score</th>
    <th>summary</th><th>evidence</th></tr></thead>
    <tbody>${rows.join("")}</tbody></table>` : "");
}

function operatorTable(metrics) {
  // per-operator observability: latency-marker percentiles, device time,
  // HBM state footprint — parsed from the job.operator.<uid>.* scope
  const ops = {};
  for (const [k, v] of Object.entries(metrics)) {
    const m = k.match(/^job\\.operator\\.([^.]+)\\.(.+)$/);
    if (m) (ops[m[1]] ??= {})[m[2]] = v;
  }
  const rows = Object.entries(ops).map(([uid, m]) => {
    const lat = m["latencyMs"] || {};
    const disp = m["deviceDispatchMs"] || {};
    return `<tr><td>${esc(uid)}</td>
      <td>${fmt(lat.p50)} / ${fmt(lat.p99)}</td>
      <td>${fmt(disp.p50)} / ${fmt(disp.p99)}</td>
      <td>${fmt(m["deviceTimeMsTotal"])}</td>
      <td>${fmt(m["stateBytes"])}</td>
      <td>${fmt(m["stateKeyCount"])}</td>
      <td>${fmt(m["numLateRecordsDropped"])}</td></tr>`;
  });
  if (!rows.length) return "";
  return `<table><thead><tr><th>operator</th><th>latency p50/p99 ms</th>
    <th>dispatch p50/p99 ms</th><th>device ms</th><th>state bytes</th>
    <th>keys</th><th>late dropped</th></tr></thead>
    <tbody>${rows.join("")}</tbody></table>`;
}

async function detailRow(id) {
  const [info, metrics, traces, cps, exc, auto, dev, lat, hist, doc] =
    await Promise.all([
    j(`/jobs/${id}`), j(`/jobs/${id}/metrics`),
    j(`/jobs/${id}/traces`).catch(() => ({resourceSpans: []})),
    j(`/jobs/${id}/checkpoints`).catch(() => null),
    j(`/jobs/${id}/exceptions`).catch(() => null),
    j(`/jobs/${id}/autoscaler`).catch(() => null),
    j(`/jobs/${id}/device`).catch(() => null),
    j(`/jobs/${id}/latency`).catch(() => null),
    j(`/jobs/${id}/history`).catch(() => null),
    j(`/jobs/${id}/doctor`).catch(() => null),
  ]);
  const spans = (traces.resourceSpans[0]?.scopeSpans[0]?.spans ?? []);
  const spanRows = spans.slice(-12).reverse().map(s => {
    const ms = (Number(s.endTimeUnixNano) - Number(s.startTimeUnixNano)) / 1e6;
    const at = Object.fromEntries(
      s.attributes.map(a => [a.key, Object.values(a.value)[0]]));
    return esc(`${s.name} #${at.checkpointId ?? ""} ${ms.toFixed(1)}ms ` +
               `${at.status ?? ""} ${fmt(Number(at.stateSizeBytes))}B ` +
               `trace:${(s.traceId ?? "").slice(0, 8)}`);
  }).join("<br>");
  const latency = metrics["job.stepLatencyMs"] || {};
  const bp = metrics["job.backPressuredTimeRatio"] ?? 0;
  // per-channel exchange byte rates (job.exchange.numBytes{In,Out}PerSecond.<ch>)
  // summed to task totals — nonzero only for jobs with cross-host exchanges
  const exch = dir => Object.entries(metrics)
    .filter(([k]) => k.includes(`exchange.numBytes${dir}PerSecond`))
    .reduce((a, [, v]) => a + (Number(v) || 0), 0);
  const exchOut = exch("Out"), exchIn = exch("In");
  const idle = metrics["job.idleTimeRatio"] ?? 0;
  return kv({
    "records/s": fmt(metrics["job.numRecordsInPerSecond"]),
    "busy ratio": fmt(metrics["job.busyTimeRatio"], 2),
    // idle-subtask indicator: a (sub)task coasting at >=95% idle is
    // starved — skewed keys or a slow upstream, not healthy headroom
    "idle ratio": idle >= 0.95
      ? `<span class="CANCELED">${fmt(idle, 2)} idle</span>` : fmt(idle, 2),
    "backpressured": `<span class="${bpClass(bp)}">${fmt(bp, 2)}</span>`,
    "wm skew ms": fmt(metrics["job.watermarkSkewMs"]),
    "step p50 ms": fmt(latency.p50), "step p99 ms": fmt(latency.p99),
    "device ms total": fmt(metrics["job.deviceTimeMsTotal"]),
    "exchange out B/s": fmt(exchOut), "exchange in B/s": fmt(exchIn),
    "late dropped": fmt(Object.entries(metrics).find(
        ([k]) => k.endsWith("numLateRecordsDropped"))?.[1]),
    "error": esc(info.error ?? "none"),
  }) + operatorTable(metrics)
    + doctorSection(doc)
    + historySection(hist)
    + latencySection(lat)
    + deviceSection(dev)
    + autoscalerSection(auto)
    + checkpointSection(cps) + exceptionSection(exc)
    + (spanRows ? `<div class="spans">${spanRows}</div>` : "");
}

async function refresh() {
  const [ov, jobs] = await Promise.all([j("/overview"), j("/jobs")]);
  document.getElementById("overview").textContent =
    `${ov.jobs} jobs ` + Object.entries(ov.by_status ?? {})
      .map(([s, n]) => `${s.toLowerCase()}:${n}`).join(" ");
  const tbody = document.getElementById("rows");
  document.getElementById("none").hidden = jobs.jobs.length > 0;
  const rows = [];
  const fetched = await Promise.all(jobs.jobs.map(job => Promise.all([
    j(`/jobs/${job.id}`),
    j(`/jobs/${job.id}/metrics`).catch(() => ({})),
  ])));
  for (const [i, job] of jobs.jobs.entries()) {
    const [d, m] = fetched[i];
    rows.push(`<tr class="job" onclick="toggle('${esc(job.id)}')">
      <td>${esc(job.id)}</td><td>${esc(job.name)}</td>
      <td class="${esc(job.status)}">${esc(job.status)}</td>
      <td>${fmt(d.records_in)}</td>
      <td>${fmt(m["job.numRecordsInPerSecond"])}</td>
      <td>${fmt(m["job.busyTimeRatio"], 2)}</td>
      <td>${d.num_restarts ?? 0}</td>
      <td>${d.num_checkpoints ?? 0}</td></tr>`);
    if (open.has(job.id)) {
      rows.push(`<tr class="detail"><td colspan="8">` +
                await detailRow(job.id) + `</td></tr>`);
    }
  }
  tbody.innerHTML = rows.join("");
}
function toggle(id) { open.has(id) ? open.delete(id) : open.add(id); refresh(); }
// self-rescheduling: a slow refresh never overlaps the next one
async function tick() {
  try { await refresh(); } finally { setTimeout(tick, 2000); }
}
tick();
</script>
</body></html>"""
