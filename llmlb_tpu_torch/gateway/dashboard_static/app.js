// SPA core: api client, auth/session, hash router, live WebSocket feed.
// Counterpart of the reference dashboard's App.tsx + hooks/useWebSocket.ts.

import * as views from "/dashboard/views.js";

// ----------------------------------------------------------------- api client

export function token() {
  return localStorage.getItem("llmlb_token") || "";
}

export function me() {
  try {
    return JSON.parse(localStorage.getItem("llmlb_user") || "null");
  } catch {
    return null;
  }
}

export async function api(path, opts = {}) {
  const headers = { ...(opts.headers || {}) };
  if (token()) headers["Authorization"] = `Bearer ${token()}`;
  if (opts.body !== undefined && !(opts.body instanceof FormData)) {
    headers["Content-Type"] = "application/json";
    opts = { ...opts, body: JSON.stringify(opts.body) };
  }
  const resp = await fetch(path, { ...opts, headers });
  if (resp.status === 401 && !path.startsWith("/api/auth/login")) {
    showLogin();
    throw new Error("authentication required");
  }
  let body = null;
  try {
    body = await resp.json();
  } catch {
    body = null;
  }
  if (!resp.ok) {
    const msg = body && (body.error?.message || body.error || resp.statusText);
    throw new Error(typeof msg === "string" ? msg : JSON.stringify(msg));
  }
  return body;
}

export function toast(message, isError = false) {
  const root = document.getElementById("toasts");
  const node = document.createElement("div");
  node.className = "toast" + (isError ? " error" : "");
  node.textContent = message;
  root.appendChild(node);
  setTimeout(() => node.remove(), 5000);
}

// --------------------------------------------------------------------- login

function showLogin() {
  closeWs();
  document.getElementById("shell").classList.add("hidden");
  const root = document.getElementById("login-root");
  root.classList.remove("hidden");
  root.innerHTML = `
    <div class="card login-card">
      <h1>llmlb<span class="brand-tpu">tpu</span></h1>
      <div class="login-error" id="login-error"></div>
      <input id="login-user" placeholder="username" autocomplete="username">
      <input id="login-pass" type="password" placeholder="password"
             autocomplete="current-password">
      <button class="primary" id="login-btn">Sign in</button>
    </div>`;
  const submit = async () => {
    const err = document.getElementById("login-error");
    err.textContent = "";
    try {
      const body = await api("/api/auth/login", {
        method: "POST",
        body: {
          username: document.getElementById("login-user").value,
          password: document.getElementById("login-pass").value,
        },
      });
      localStorage.setItem("llmlb_token", body.token);
      localStorage.setItem("llmlb_user", JSON.stringify(body.user));
      root.classList.add("hidden");
      boot();
    } catch (e) {
      err.textContent = e.message || "login failed";
    }
  };
  document.getElementById("login-btn").addEventListener("click", submit);
  // showLogin() can run many times (every 401); keep exactly one handler
  // on the persistent root node or Enter would submit N times
  if (root._onEnter) root.removeEventListener("keydown", root._onEnter);
  root._onEnter = (ev) => {
    if (ev.key === "Enter") submit();
  };
  root.addEventListener("keydown", root._onEnter);
  document.getElementById("login-user").focus();
}

// ------------------------------------------------------------------ live feed

let ws = null;
const wsListeners = new Set();

export function onEvent(fn) {
  wsListeners.add(fn);
  return () => wsListeners.delete(fn);
}

function closeWs() {
  if (ws) {
    ws.onclose = null;
    ws.close();
    ws = null;
  }
}

function connectWs() {
  closeWs();
  const proto = location.protocol === "https:" ? "wss" : "ws";
  ws = new WebSocket(
    `${proto}://${location.host}/ws/dashboard?token=${encodeURIComponent(token())}`
  );
  const dot = document.getElementById("ws-dot");
  ws.onopen = () => dot.className = "dot online";
  ws.onclose = () => {
    dot.className = "dot offline";
    setTimeout(() => {
      if (token()) connectWs();
    }, 3000);
  };
  ws.onmessage = (msg) => {
    let event;
    try {
      event = JSON.parse(msg.data);
    } catch {
      return;
    }
    for (const fn of wsListeners) {
      try {
        fn(event);
      } catch { /* a broken view listener must not kill the feed */ }
    }
  };
}

// -------------------------------------------------------------------- router

const routes = {
  overview: views.overview,
  endpoints: views.endpoints,
  requests: views.requests,
  tokens: views.tokens,
  clients: views.clients,
  playground: views.playground,
  audit: views.audit,
  access: views.access,
  system: views.system,
};

let disposeView = null;

async function render() {
  const name = (location.hash || "#/overview").replace(/^#\//, "").split("?")[0];
  const route = routes[name] || views.overview;
  document.querySelectorAll(".sidebar a").forEach((a) =>
    a.classList.toggle("active", a.dataset.nav === name));
  if (disposeView) {
    try { disposeView(); } catch { /* ignore */ }
    disposeView = null;
  }
  const view = document.getElementById("view");
  view.innerHTML = "";
  try {
    disposeView = await route(view) || null;
  } catch (e) {
    // textContent, not innerHTML: error strings can echo server/upstream
    // content and must never execute in the admin session
    view.innerHTML = "<h1>Something went wrong</h1>";
    const p = document.createElement("p");
    p.className = "muted";
    p.textContent = e.message || String(e);
    view.appendChild(p);
  }
}

function boot() {
  document.getElementById("shell").classList.remove("hidden");
  const user = me();
  document.getElementById("whoami").textContent =
    user ? `${user.username} (${user.role})` : "";
  connectWs();
  render();
}

window.addEventListener("hashchange", render);

document.addEventListener("DOMContentLoaded", () => {
  document.getElementById("logout").addEventListener("click", async () => {
    try {
      await api("/api/auth/logout", { method: "POST" });
    } catch { /* cookie may already be gone */ }
    localStorage.removeItem("llmlb_token");
    localStorage.removeItem("llmlb_user");
    showLogin();
  });
  if (token()) {
    boot();
  } else {
    showLogin();
  }
});
