// Page renderers. Each view gets the <main> node, returns an optional
// dispose() for timers/listeners. Counterpart of the reference pages
// (Dashboard, AuditLog, EndpointPlayground, LoadBalancerPlayground, etc).

import { api, me, onEvent, toast } from "/dashboard/app.js";
import { barChart, fmtNum, lineChart } from "/dashboard/charts.js";

function h(html) {
  const t = document.createElement("template");
  t.innerHTML = html.trim();
  return t.content.firstChild;
}

function esc(s) {
  return String(s ?? "").replace(/[&<>"']/g, (c) => ({
    "&": "&amp;", "<": "&lt;", ">": "&gt;", '"': "&quot;", "'": "&#39;",
  })[c]);
}

function fmtBytes(n) {
  if (!n) return "0";
  const units = ["B", "KiB", "MiB", "GiB", "TiB"];
  let i = 0, v = n;
  while (v >= 1024 && i < units.length - 1) { v /= 1024; i++; }
  return `${v.toFixed(v >= 10 ? 0 : 1)} ${units[i]}`;
}

function fmtTs(ts) {
  if (!ts) return "—";
  return new Date(ts * 1000).toLocaleString();
}

function statusBadge(status) {
  return `<span class="badge"><span class="dot ${esc(status)}"></span>${esc(status)}</span>`;
}

// ------------------------------------------------------------------ overview

export async function overview(view) {
  view.appendChild(h(`<h1>Overview</h1>`));
  const cards = h(`<div class="cards"></div>`);
  const chartBox = document.createElement("div");
  const tpsBox = document.createElement("div");
  view.appendChild(cards);
  view.appendChild(chartBox);
  view.appendChild(h(`<h2>Measured throughput (tokens/sec EMA)</h2>`));
  view.appendChild(tpsBox);

  async function refresh() {
    const [ov, hist, tps] = await Promise.all([
      api("/api/dashboard/overview"),
      api("/api/dashboard/request-history"),
      api("/api/dashboard/model-tps"),
    ]);
    cards.innerHTML = `
      <div class="card"><div class="tile-label">Endpoints online</div>
        <div class="tile-value">${ov.endpoints.online}<span class="muted">/${ov.endpoints.total}</span></div>
        <div class="tile-sub">${ov.models.total} models</div></div>
      <div class="card"><div class="tile-label">Requests today</div>
        <div class="tile-value">${fmtNum(ov.requests.today)}</div>
        <div class="tile-sub">${ov.requests.active} active · ${fmtNum(ov.requests.errors_today)} errors</div></div>
      <div class="card"><div class="tile-label">Tokens today</div>
        <div class="tile-value">${fmtNum(ov.tokens_today.prompt + ov.tokens_today.completion)}</div>
        <div class="tile-sub">${fmtNum(ov.tokens_today.prompt)} in · ${fmtNum(ov.tokens_today.completion)} out</div></div>
      <div class="card"><div class="tile-label">TPU HBM in use</div>
        <div class="tile-value">${ov.tpu.hbm_total_bytes
          ? Math.round(100 * ov.tpu.hbm_used_bytes / ov.tpu.hbm_total_bytes) + "%"
          : "—"}</div>
        <div class="tile-sub">${ov.tpu.total_chips} chips · ${fmtBytes(ov.tpu.hbm_used_bytes)} / ${fmtBytes(ov.tpu.hbm_total_bytes)}</div></div>`;

    const minutes = hist.minutes;
    const labels = minutes.map((m) =>
      new Date(m.ts * 1000).toLocaleTimeString([], { hour: "2-digit", minute: "2-digit" }));
    lineChart(chartBox, {
      title: "Requests per minute (last hour)",
      labels,
      series: [
        { name: "requests", color: "--series-1", values: minutes.map((m) => m.requests) },
        { name: "errors", color: "--status-serious", values: minutes.map((m) => m.errors) },
      ],
    });

    const entries = Object.entries(tps.tps);
    tpsBox.innerHTML = entries.length ? "" : `<p class="muted">No TPS measurements yet.</p>`;
    if (entries.length) {
      const rows = entries.map(([key, v]) => {
        // key is "eid:model:kind" where model itself may contain colons
        // (e.g. ollama "llama3:8b") — split at the first and last colon
        const i = key.indexOf(":"), j = key.lastIndexOf(":");
        const eid = key.slice(0, i), model = key.slice(i + 1, j),
              kind = key.slice(j + 1);
        return `<tr><td class="mono">${esc(eid.slice(0, 8))}</td>
          <td>${esc(model)}</td><td>${esc(kind)}</td>
          <td><b>${fmtNum(v.ema_tps)}</b> tok/s</td><td>${v.samples}</td></tr>`;
      }).join("");
      tpsBox.innerHTML = `<table><thead><tr><th>endpoint</th><th>model</th>
        <th>api</th><th>TPS (EMA)</th><th>samples</th></tr></thead>
        <tbody>${rows}</tbody></table>`;
    }
  }

  await refresh();
  const timer = setInterval(() => refresh().catch(() => {}), 15000);
  const off = onEvent((ev) => {
    if (["TpsUpdated", "EndpointStatusChanged", "TelemetryUpdated"].includes(ev.type)) {
      refresh().catch(() => {});
    }
  });
  return () => { clearInterval(timer); off(); };
}

// ----------------------------------------------------------------- endpoints

export async function endpoints(view) {
  view.appendChild(h(`<h1>Endpoints</h1>`));
  const form = h(`<div class="formrow">
    <input id="ep-url" placeholder="http://host:port" size="28">
    <input id="ep-name" placeholder="name (optional)" size="14">
    <select id="ep-type">
      <option value="">auto-detect</option>
      <option value="tpu">tpu</option><option value="xllm">xllm</option>
      <option value="ollama">ollama</option><option value="vllm">vllm</option>
      <option value="lm_studio">lm_studio</option>
      <option value="llama_cpp">llama_cpp</option>
      <option value="openai_compatible">openai_compatible</option>
    </select>
    <input id="ep-key" placeholder="api key (optional)" size="16">
    <button class="primary" id="ep-add">Register</button>
  </div>`);
  view.appendChild(form);
  const box = document.createElement("div");
  view.appendChild(box);

  async function refresh() {
    const body = await api("/api/endpoints");
    if (!body.endpoints.length) {
      box.innerHTML = `<p class="muted">No endpoints registered.</p>`;
      return;
    }
    box.innerHTML = "";
    const table = h(`<table><thead><tr>
      <th>status</th><th>name</th><th>type</th><th>latency</th>
      <th>HBM</th><th>models</th><th></th></tr></thead><tbody></tbody></table>`);
    const tbody = table.querySelector("tbody");
    for (const ep of body.endpoints) {
      const acc = ep.accelerator || {};
      const pct = acc.hbm_total_bytes
        ? acc.hbm_used_bytes / acc.hbm_total_bytes : null;
      const models = (ep.models || []).map((m) => m.canonical_name);
      const shown = models.slice(0, 3).map(esc).join(", ") +
        (models.length > 3 ? ` +${models.length - 3}` : "");
      const row = h(`<tr>
        <td>${statusBadge(ep.status)}</td>
        <td><b>${esc(ep.name)}</b><br><span class="muted mono">${esc(ep.base_url)}</span></td>
        <td>${esc(ep.endpoint_type)}</td>
        <td>${ep.latency_ms != null ? ep.latency_ms.toFixed(1) + " ms" : "—"}</td>
        <td>${pct == null ? "—"
          : `<div class="gauge ${pct > 0.85 ? "hot" : ""}" title="${fmtBytes(acc.hbm_used_bytes)} / ${fmtBytes(acc.hbm_total_bytes)}">
               <div style="width:${Math.min(100, pct * 100).toFixed(0)}%"></div></div>`}</td>
        <td>${shown || '<span class="muted">none</span>'}</td>
        <td>
          <button data-act="test">test</button>
          <button data-act="sync">sync</button>
          <button data-act="info">info</button>
          <button data-act="del" class="danger">remove</button>
        </td></tr>`);
      row.querySelector('[data-act="test"]').addEventListener("click", async () => {
        try {
          const r = await api(`/api/endpoints/${ep.id}/test`, { method: "POST" });
          toast(r.ok ? `OK: ${r.detected_type} in ${r.latency_ms}ms`
                     : `Failed: ${r.error}`, !r.ok);
        } catch (e) { toast(e.message, true); }
      });
      row.querySelector('[data-act="sync"]').addEventListener("click", async () => {
        try {
          const r = await api(`/api/endpoints/${ep.id}/sync`, { method: "POST" });
          toast(`Synced: +${r.added} −${r.removed}`);
          refresh();
        } catch (e) { toast(e.message, true); }
      });
      row.querySelector('[data-act="info"]').addEventListener("click", async () => {
        try {
          const r = await api(`/api/endpoints/${ep.id}/system-info`);
          if (!r.available) { toast("No device info exposed by this runtime"); return; }
          const detail = h(`<tr class="detail-row"><td colspan="7">
            <pre class="mono">${esc(JSON.stringify(r.info, null, 2))}</pre></td></tr>`);
          const old = tbody.querySelector(".detail-row");
          if (old) old.remove();
          row.after(detail);
        } catch (e) { toast(e.message, true); }
      });
      row.querySelector('[data-act="del"]').addEventListener("click", async () => {
        if (!confirm(`Remove endpoint ${ep.name}?`)) return;
        try {
          await api(`/api/endpoints/${ep.id}`, { method: "DELETE" });
          refresh();
        } catch (e) { toast(e.message, true); }
      });
      tbody.appendChild(row);
    }
    box.appendChild(table);
  }

  form.querySelector("#ep-add").addEventListener("click", async () => {
    const payload = {
      base_url: form.querySelector("#ep-url").value.trim(),
      name: form.querySelector("#ep-name").value.trim() || undefined,
      endpoint_type: form.querySelector("#ep-type").value || undefined,
      api_key: form.querySelector("#ep-key").value || undefined,
    };
    try {
      await api("/api/endpoints", { method: "POST", body: payload });
      form.querySelector("#ep-url").value = "";
      toast("Endpoint registered");
      refresh();
    } catch (e) { toast(e.message, true); }
  });

  await refresh();
  const off = onEvent((ev) => {
    if (["EndpointStatusChanged", "EndpointRegistered", "EndpointRemoved",
         "TelemetryUpdated"].includes(ev.type)) refresh().catch(() => {});
  });
  return off;
}

// ------------------------------------------------------------------ requests

export async function requests(view) {
  view.appendChild(h(`<h1>Requests</h1>`));
  const filters = h(`<div class="filters">
    <input id="rq-model" placeholder="model">
    <input id="rq-status" placeholder="status code" size="8">
    <button id="rq-go">Filter</button>
  </div>`);
  view.appendChild(filters);
  const box = document.createElement("div");
  const detail = document.createElement("div");
  view.appendChild(box);
  view.appendChild(detail);

  async function refresh() {
    const params = new URLSearchParams();
    const model = filters.querySelector("#rq-model").value.trim();
    const status = filters.querySelector("#rq-status").value.trim();
    if (model) params.set("model", model);
    if (status) params.set("status", status);
    params.set("limit", "100");
    const body = await api(`/api/dashboard/requests?${params}`);
    if (!body.records.length) {
      box.innerHTML = `<p class="muted">No request records.</p>`;
      return;
    }
    const rows = body.records.map((r) => `
      <tr class="clickable" data-id="${esc(r.id)}">
        <td class="mono">${fmtTs(r.ts)}</td>
        <td>${esc(r.model || "—")}</td>
        <td>${esc(r.endpoint_name || "—")}</td>
        <td>${r.status_code >= 400
            ? `<span class="badge"><span class="dot offline"></span>${r.status_code}</span>`
            : r.status_code}</td>
        <td>${(r.duration_ms || 0).toFixed(0)} ms</td>
        <td>${fmtNum(r.prompt_tokens)} / ${fmtNum(r.completion_tokens)}</td>
        <td>${r.stream ? "stream" : ""}</td></tr>`).join("");
    box.innerHTML = `<table><thead><tr><th>time</th><th>model</th>
      <th>endpoint</th><th>status</th><th>duration</th><th>tokens in/out</th>
      <th></th></tr></thead><tbody>${rows}</tbody></table>`;
    box.querySelectorAll("tr.clickable").forEach((tr) =>
      tr.addEventListener("click", async () => {
        const rec = await api(`/api/dashboard/requests/${tr.dataset.id}`);
        detail.innerHTML = `<h2>Record ${esc(rec.id.slice(0, 8))}</h2>
          <div class="card"><pre class="mono">${esc(JSON.stringify(rec, null, 2))}</pre></div>`;
        detail.scrollIntoView({ behavior: "smooth" });
      }));
  }

  filters.querySelector("#rq-go").addEventListener("click", () =>
    refresh().catch((e) => toast(e.message, true)));
  await refresh();
}

// -------------------------------------------------------------------- tokens

export async function tokens(view) {
  view.appendChild(h(`<h1>Token stats</h1>`));
  const chartBox = document.createElement("div");
  const byModel = document.createElement("div");
  view.appendChild(chartBox);
  view.appendChild(h(`<h2>By model (30 days)</h2>`));
  view.appendChild(byModel);

  const stats = await api("/api/dashboard/token-stats?days=30");
  const daily = stats.daily;
  barChart(chartBox, {
    title: "Tokens per day (30 days)",
    labels: daily.map((d) => d.date.slice(5)),
    series: [
      { name: "prompt", color: "--series-1", values: daily.map((d) => d.pt || 0) },
      { name: "completion", color: "--series-3", values: daily.map((d) => d.ct || 0) },
    ],
  });
  const rows = stats.by_model.map((m) => `
    <tr><td>${esc(m.model)}</td><td>${fmtNum(m.requests)}</td>
    <td>${fmtNum(m.pt || 0)}</td><td>${fmtNum(m.ct || 0)}</td></tr>`).join("");
  byModel.innerHTML = stats.by_model.length
    ? `<table><thead><tr><th>model</th><th>requests</th><th>prompt tokens</th>
       <th>completion tokens</th></tr></thead><tbody>${rows}</tbody></table>`
    : `<p class="muted">No data yet.</p>`;
}

// ------------------------------------------------------------------- clients

export async function clients(view) {
  view.appendChild(h(`<h1>Clients</h1>`));
  const controls = h(`<div class="formrow">
    <label>Alert threshold (req/hour)
      <input id="cl-threshold" size="6"></label>
    <button class="primary" id="cl-save">Save</button>
  </div>`);
  view.appendChild(controls);
  const rankBox = document.createElement("div");
  const keyBox = document.createElement("div");
  view.appendChild(rankBox);
  view.appendChild(h(`<h2>By API key (7 days)</h2>`));
  view.appendChild(keyBox);

  async function refresh() {
    const body = await api("/api/dashboard/clients?days=7");
    controls.querySelector("#cl-threshold").value = body.ip_alert_threshold;
    const rows = (body.ranking || []).map((r) => `
      <tr>
        <td class="mono">${esc(r.client_ip)}
          ${r.is_alert
            ? `<span class="badge"><span class="dot offline"></span>alert</span>`
            : ""}</td>
        <td>${fmtNum(r.requests)}</td>
        <td>${fmtNum(r.errors || 0)}</td>
        <td>${fmtNum(r.pt || 0)} / ${fmtNum(r.ct || 0)}</td></tr>`).join("");
    rankBox.innerHTML = rows
      ? `<table><thead><tr><th>client ip</th><th>requests</th><th>errors</th>
         <th>tokens in/out</th></tr></thead><tbody>${rows}</tbody></table>`
      : `<p class="muted">No client traffic recorded.</p>`;
    const keyRows = (body.by_api_key || []).map((r) => `
      <tr><td class="mono">${esc(r.api_key_id)}</td>
      <td>${fmtNum(r.requests)}</td><td>${fmtNum(r.ct || 0)}</td></tr>`).join("");
    keyBox.innerHTML = keyRows
      ? `<table><thead><tr><th>api key</th><th>requests</th>
         <th>completion tokens</th></tr></thead><tbody>${keyRows}</tbody></table>`
      : `<p class="muted">No API-key traffic.</p>`;
  }

  controls.querySelector("#cl-save").addEventListener("click", async () => {
    try {
      await api("/api/dashboard/settings", {
        method: "PUT",
        body: { key: "ip_alert_threshold",
                value: controls.querySelector("#cl-threshold").value.trim() },
      });
      toast("Threshold saved");
      refresh();
    } catch (e) { toast(e.message, true); }
  });

  await refresh();
}

// ---------------------------------------------------------------- playground

export async function playground(view) {
  view.appendChild(h(`<h1>Playground</h1>`));
  const eps = await api("/api/endpoints");
  const models = await api("/v1/models").catch(() => ({ data: [] }));
  const epOptions = eps.endpoints
    .map((e) => `<option value="${esc(e.id)}">${esc(e.name)}</option>`).join("");
  const modelOptions = (models.data || [])
    .map((m) => `<option>${esc(m.id)}</option>`).join("");
  const ui = h(`<div>
    <div class="formrow">
      <select id="pg-mode">
        <option value="lb">via load balancer (/v1/chat/completions)</option>
        <option value="pin">pinned endpoint (playground proxy)</option>
      </select>
      <select id="pg-model">${modelOptions || "<option value=''>no models</option>"}</select>
      <select id="pg-endpoint" class="hidden">${epOptions}</select>
      <label><input type="checkbox" id="pg-stream" checked> stream</label>
    </div>
    <div class="chat-log" id="pg-log"></div>
    <div class="formrow">
      <textarea id="pg-input" rows="2" placeholder="Say something…" style="flex:1"></textarea>
      <button class="primary" id="pg-send">Send</button>
    </div>
  </div>`);
  view.appendChild(ui);
  const log = ui.querySelector("#pg-log");
  const history = [];

  ui.querySelector("#pg-mode").addEventListener("change", (ev) => {
    ui.querySelector("#pg-endpoint").classList.toggle("hidden", ev.target.value !== "pin");
    ui.querySelector("#pg-stream").disabled = ev.target.value === "pin";
  });

  function addMsg(who, text) {
    const node = h(`<div class="msg"><div class="who">${esc(who)}</div>
      <pre>${esc(text)}</pre></div>`);
    log.appendChild(node);
    log.scrollTop = log.scrollHeight;
    return node.querySelector("pre");
  }

  async function send() {
    const input = ui.querySelector("#pg-input");
    const text = input.value.trim();
    if (!text) return;
    input.value = "";
    addMsg(me()?.username || "you", text);
    history.push({ role: "user", content: text });
    const mode = ui.querySelector("#pg-mode").value;
    const model = ui.querySelector("#pg-model").value;
    const stream = ui.querySelector("#pg-stream").checked && mode === "lb";
    const out = addMsg(model || "assistant", "…");
    const btn = ui.querySelector("#pg-send");
    btn.disabled = true;
    try {
      const url = mode === "lb"
        ? "/v1/chat/completions"
        : `/api/endpoints/${ui.querySelector("#pg-endpoint").value}/chat/completions`;
      const resp = await fetch(url, {
        method: "POST",
        headers: {
          "Content-Type": "application/json",
          "Authorization": `Bearer ${localStorage.getItem("llmlb_token")}`,
        },
        body: JSON.stringify({
          model, stream, max_tokens: 512,
          messages: history.slice(-12),
        }),
      });
      if (!resp.ok) {
        const err = await resp.json().catch(() => null);
        throw new Error(err?.error?.message || err?.error || `HTTP ${resp.status}`);
      }
      let full = "";
      if (stream) {
        const reader = resp.body.getReader();
        const dec = new TextDecoder();
        let buf = "";
        for (;;) {
          const { value, done } = await reader.read();
          if (done) break;
          buf += dec.decode(value, { stream: true });
          const lines = buf.split("\n");
          buf = lines.pop();
          for (const line of lines) {
            if (!line.startsWith("data:")) continue;
            const data = line.slice(5).trim();
            if (data === "[DONE]") continue;
            try {
              const chunk = JSON.parse(data);
              const delta = chunk.choices?.[0]?.delta?.content || "";
              if (delta) { full += delta; out.textContent = full; }
            } catch { /* partial frame */ }
          }
          log.scrollTop = log.scrollHeight;
        }
      } else {
        const body = await resp.json();
        full = body.choices?.[0]?.message?.content ?? JSON.stringify(body);
        out.textContent = full;
      }
      history.push({ role: "assistant", content: full });
    } catch (e) {
      out.textContent = `error: ${e.message}`;
    } finally {
      btn.disabled = false;
    }
  }

  ui.querySelector("#pg-send").addEventListener("click", send);
  ui.querySelector("#pg-input").addEventListener("keydown", (ev) => {
    if (ev.key === "Enter" && !ev.shiftKey) { ev.preventDefault(); send(); }
  });
}

// --------------------------------------------------------------------- audit

export async function audit(view) {
  view.appendChild(h(`<h1>Audit log</h1>`));
  const filters = h(`<div class="filters">
    <input id="au-q" placeholder="search (FTS)">
    <input id="au-actor" placeholder="actor" size="12">
    <input id="au-path" placeholder="path prefix" size="14">
    <button id="au-go">Search</button>
    <button id="au-verify">Verify chain</button>
  </div>`);
  view.appendChild(filters);
  const box = document.createElement("div");
  view.appendChild(box);

  async function refresh() {
    const params = new URLSearchParams();
    for (const [id, key] of [["au-q", "q"], ["au-actor", "actor"], ["au-path", "path"]]) {
      const v = filters.querySelector(`#${id}`).value.trim();
      if (v) params.set(key, v);
    }
    params.set("limit", "200");
    const body = await api(`/api/audit-log?${params}`);
    if (!body.entries.length) {
      box.innerHTML = `<p class="muted">No matching entries.</p>`;
      return;
    }
    const rows = body.entries.map((e) => `
      <tr><td class="mono">${fmtTs(e.ts)}</td>
      <td>${esc(e.actor || "anonymous")}<br><span class="muted">${esc(e.actor_type || "")}</span></td>
      <td class="mono">${esc(e.method)} ${esc(e.path)}</td>
      <td>${e.status >= 400
          ? `<span class="badge"><span class="dot offline"></span>${e.status}</span>` : e.status}</td>
      <td>${(e.duration_ms || 0).toFixed(1)} ms</td>
      <td class="mono">${esc(e.ip || "")}</td></tr>`).join("");
    box.innerHTML = `<table><thead><tr><th>time</th><th>actor</th>
      <th>request</th><th>status</th><th>duration</th><th>ip</th></tr></thead>
      <tbody>${rows}</tbody></table>`;
  }

  filters.querySelector("#au-go").addEventListener("click", () =>
    refresh().catch((e) => toast(e.message, true)));
  filters.querySelector("#au-verify").addEventListener("click", async () => {
    try {
      const r = await api("/api/audit-log/verify", { method: "POST" });
      toast(r.ok ? "Audit chain verified — no tampering detected"
                 : `CHAIN BROKEN: ${r.error}`, !r.ok);
    } catch (e) { toast(e.message, true); }
  });
  await refresh();
}

// -------------------------------------------------------- users / keys / invites

export async function access(view) {
  view.appendChild(h(`<h1>Users &amp; API keys</h1>`));
  const usersBox = document.createElement("div");
  const keysBox = document.createElement("div");
  const invBox = document.createElement("div");
  view.appendChild(h(`<h2>Users</h2>`));
  view.appendChild(usersBox);
  view.appendChild(h(`<h2>API keys</h2>`));
  view.appendChild(keysBox);
  view.appendChild(h(`<h2>Invitations</h2>`));
  view.appendChild(invBox);

  async function refreshUsers() {
    const body = await api("/api/users").catch(() => null);
    if (!body) { usersBox.innerHTML = `<p class="muted">Admin only.</p>`; return; }
    const rows = body.users.map((u) => `
      <tr><td><b>${esc(u.username)}</b></td><td>${esc(u.role)}</td>
      <td>${u.must_change_password ? "must change password" : ""}</td>
      <td><button data-id="${esc(u.id)}" class="danger">delete</button></td></tr>`).join("");
    usersBox.innerHTML = `<table><thead><tr><th>user</th><th>role</th><th></th>
      <th></th></tr></thead><tbody>${rows}</tbody></table>`;
    usersBox.querySelectorAll("button").forEach((b) =>
      b.addEventListener("click", async () => {
        if (!confirm("Delete user?")) return;
        try { await api(`/api/users/${b.dataset.id}`, { method: "DELETE" }); refreshUsers(); }
        catch (e) { toast(e.message, true); }
      }));
  }

  async function refreshKeys() {
    const body = await api("/api/api-keys");
    const rows = (body.api_keys || []).map((k) => `
      <tr><td><b>${esc(k.name)}</b> <span class="muted mono">${esc(k.key_prefix)}…</span></td>
      <td class="mono">${(k.permissions || []).map(esc).join(", ")}</td>
      <td>${fmtTs(k.created_at)}</td>
      <td><button data-id="${esc(k.id)}" class="danger">revoke</button></td></tr>`).join("");
    keysBox.innerHTML = `
      <div class="formrow">
        <input id="key-name" placeholder="key name">
        <select id="key-perms" multiple size="3">
          <option value="openai.inference" selected>openai.inference</option>
          <option value="openai.models.read">openai.models.read</option>
          <option value="endpoints.read">endpoints.read</option>
          <option value="endpoints.manage">endpoints.manage</option>
          <option value="metrics.read">metrics.read</option>
          <option value="logs.read">logs.read</option>
        </select>
        <button class="primary" id="key-add">Create key</button>
      </div>
      ${rows ? `<table><thead><tr><th>key</th><th>permissions</th><th>created</th>
        <th></th></tr></thead><tbody>${rows}</tbody></table>`
             : '<p class="muted">No API keys.</p>'}`;
    keysBox.querySelector("#key-add").addEventListener("click", async () => {
      const name = keysBox.querySelector("#key-name").value.trim() || "key";
      const perms = [...keysBox.querySelector("#key-perms").selectedOptions].map((o) => o.value);
      try {
        const r = await api("/api/api-keys", { method: "POST",
                            body: { name, permissions: perms } });
        prompt("API key (copy now — shown once):", r.api_key);
        refreshKeys();
      } catch (e) { toast(e.message, true); }
    });
    keysBox.querySelectorAll("button.danger").forEach((b) =>
      b.addEventListener("click", async () => {
        try { await api(`/api/api-keys/${b.dataset.id}`, { method: "DELETE" }); refreshKeys(); }
        catch (e) { toast(e.message, true); }
      }));
  }

  async function refreshInvites() {
    const body = await api("/api/invitations").catch(() => null);
    if (!body) { invBox.innerHTML = `<p class="muted">Admin only.</p>`; return; }
    const rows = (body.invitations || []).map((i) => `
      <tr><td class="mono">${esc(i.code)}</td><td>${esc(i.role)}</td>
      <td>${i.used_by ? "used" : "open"}</td>
      <td><button data-id="${esc(i.id)}" class="danger">delete</button></td></tr>`).join("");
    invBox.innerHTML = `
      <div class="formrow">
        <select id="inv-role"><option>viewer</option><option>admin</option></select>
        <button class="primary" id="inv-add">Create invitation</button>
      </div>
      ${rows ? `<table><thead><tr><th>code</th><th>role</th><th>state</th><th></th>
        </tr></thead><tbody>${rows}</tbody></table>`
             : '<p class="muted">No invitations.</p>'}`;
    invBox.querySelector("#inv-add").addEventListener("click", async () => {
      try {
        await api("/api/invitations", { method: "POST",
                  body: { role: invBox.querySelector("#inv-role").value } });
        refreshInvites();
      } catch (e) { toast(e.message, true); }
    });
    invBox.querySelectorAll("button.danger").forEach((b) =>
      b.addEventListener("click", async () => {
        try { await api(`/api/invitations/${b.dataset.id}`, { method: "DELETE" }); refreshInvites(); }
        catch (e) { toast(e.message, true); }
      }));
  }

  await Promise.all([refreshUsers(), refreshKeys(), refreshInvites()]);
}

// -------------------------------------------------------------------- system

export async function system(view) {
  view.appendChild(h(`<h1>System</h1>`));
  const sysBox = document.createElement("div");
  const logBox = document.createElement("div");
  view.appendChild(sysBox);
  view.appendChild(h(`<h2>Gateway log</h2>`));
  view.appendChild(logBox);

  async function refresh() {
    const sys = await api("/api/system");
    const upd = sys.update || {};
    sysBox.innerHTML = `
      <div class="cards">
        <div class="card"><div class="tile-label">Version</div>
          <div class="tile-value">${esc(sys.version || "dev")}</div></div>
        <div class="card"><div class="tile-label">Update state</div>
          <div class="tile-value" style="font-size:18px">${esc(upd.state || "n/a")}</div>
          <div class="tile-sub">${esc(upd.available_version || "")}</div></div>
      </div>
      <div class="formrow">
        <button id="upd-check">Check for updates</button>
        <button id="upd-apply" class="primary">Apply update</button>
      </div>`;
    sysBox.querySelector("#upd-check").addEventListener("click", async () => {
      try {
        const r = await api("/api/system/update/check", { method: "POST" });
        toast(r.available ? `Update available: ${r.version}` : "Up to date");
        refresh();
      } catch (e) { toast(e.message, true); }
    });
    sysBox.querySelector("#upd-apply").addEventListener("click", async () => {
      if (!confirm("Drain traffic and apply the update?")) return;
      try {
        await api("/api/system/update/apply", { method: "POST", body: {} });
        toast("Update apply started (draining)");
      } catch (e) { toast(e.message, true); }
    });
  }

  async function refreshLogs() {
    const body = await api("/api/dashboard/logs/lb?lines=200");
    logBox.innerHTML = body.available
      ? `<div class="logbox mono">${body.lines.map(esc).join("<br>")}</div>`
      : `<p class="muted">File logging is not enabled on this server.</p>`;
    const inner = logBox.querySelector(".logbox");
    if (inner) inner.scrollTop = inner.scrollHeight;
  }

  await refresh();
  await refreshLogs().catch(() => {
    logBox.innerHTML = `<p class="muted">Log tail unavailable.</p>`;
  });
  const timer = setInterval(() => refreshLogs().catch(() => {}), 10000);
  return () => clearInterval(timer);
}
