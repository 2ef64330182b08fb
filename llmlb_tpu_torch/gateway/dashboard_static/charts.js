// SVG chart helpers: line chart with crosshair tooltip, grouped bar chart.
// Mark specs: 2px lines, >=8px hover markers, recessive grid, legend for
// multi-series, tooltips on hover; series colors come from CSS custom
// properties so light/dark swap without touching chart code.

const NS = "http://www.w3.org/2000/svg";

function el(tag, attrs = {}) {
  const node = document.createElementNS(NS, tag);
  for (const [k, v] of Object.entries(attrs)) node.setAttribute(k, v);
  return node;
}

function cssVar(name) {
  return getComputedStyle(document.documentElement).getPropertyValue(name).trim();
}

let tooltipNode = null;
function tooltip() {
  if (!tooltipNode) {
    tooltipNode = document.createElement("div");
    tooltipNode.className = "chart-tooltip";
    document.body.appendChild(tooltipNode);
  }
  return tooltipNode;
}

function showTip(html, x, y) {
  const t = tooltip();
  t.innerHTML = html;
  t.style.display = "block";
  const w = t.offsetWidth, h = t.offsetHeight;
  const vx = Math.min(x + 14, window.innerWidth - w - 8);
  const vy = Math.max(8, y - h - 10);
  t.style.left = `${vx}px`;
  t.style.top = `${vy}px`;
}

export function hideTip() {
  if (tooltipNode) tooltipNode.style.display = "none";
}

function niceTicks(max, n = 4) {
  if (max <= 0) return [0, 1];
  const step = Math.pow(10, Math.floor(Math.log10(max / n)));
  const mult = [1, 2, 5, 10].find((m) => max / (m * step) <= n) || 10;
  const tick = mult * step;
  const ticks = [];
  for (let v = 0; v <= max + tick * 0.001; v += tick) ticks.push(v);
  return ticks;
}

export function fmtNum(v) {
  if (v >= 1e9) return (v / 1e9).toFixed(1) + "B";
  if (v >= 1e6) return (v / 1e6).toFixed(1) + "M";
  if (v >= 1e3) return (v / 1e3).toFixed(1) + "k";
  return String(Math.round(v * 100) / 100);
}

// series: [{name, color, values: [..]}], labels: x labels (same length)
export function lineChart(container, { series, labels, height = 180, title }) {
  container.innerHTML = "";
  const card = document.createElement("div");
  card.className = "card chart-card";
  if (title) {
    const t = document.createElement("div");
    t.className = "chart-title";
    t.textContent = title;
    card.appendChild(t);
  }
  if (series.length > 1) {
    const legend = document.createElement("div");
    legend.className = "chart-legend";
    for (const s of series) {
      const item = document.createElement("span");
      const sw = document.createElement("span");
      sw.className = "legend-swatch";
      sw.style.background = cssVar(s.color);
      item.appendChild(sw);
      item.appendChild(document.createTextNode(s.name));
      legend.appendChild(item);
    }
    card.appendChild(legend);
  }

  const width = Math.max(320, card.clientWidth || container.clientWidth || 640);
  const pad = { l: 42, r: 12, t: 8, b: 22 };
  const svg = el("svg", {
    viewBox: `0 0 ${width} ${height}`, class: "chart-svg", width: "100%",
    role: "img", "aria-label": title || "line chart",
  });
  const W = width - pad.l - pad.r, H = height - pad.t - pad.b;
  const n = labels.length;
  const maxY = Math.max(1, ...series.flatMap((s) => s.values));
  const x = (i) => pad.l + (n <= 1 ? W / 2 : (i / (n - 1)) * W);
  const y = (v) => pad.t + H - (v / maxY) * H;

  for (const tv of niceTicks(maxY)) {
    svg.appendChild(el("line", {
      x1: pad.l, x2: pad.l + W, y1: y(tv), y2: y(tv), class: "gridline",
    }));
    const lab = el("text", { x: pad.l - 6, y: y(tv) + 3, "text-anchor": "end" });
    lab.textContent = fmtNum(tv);
    svg.appendChild(lab);
  }
  svg.appendChild(el("line", {
    x1: pad.l, x2: pad.l + W, y1: pad.t + H, y2: pad.t + H, class: "axisline",
  }));
  const labelEvery = Math.max(1, Math.ceil(n / 8));
  labels.forEach((lb, i) => {
    if (i % labelEvery) return;
    const t = el("text", { x: x(i), y: height - 6, "text-anchor": "middle" });
    t.textContent = lb;
    svg.appendChild(t);
  });

  for (const s of series) {
    if (!n) continue;
    const d = s.values.map((v, i) =>
      `${i ? "L" : "M"}${x(i).toFixed(1)},${y(v).toFixed(1)}`).join("");
    svg.appendChild(el("path", {
      d, fill: "none", stroke: cssVar(s.color), "stroke-width": 2,
      "stroke-linejoin": "round", "stroke-linecap": "round",
    }));
  }

  // crosshair + hover markers
  const cross = el("line", {
    y1: pad.t, y2: pad.t + H, class: "axisline", "stroke-dasharray": "3,3",
    visibility: "hidden",
  });
  svg.appendChild(cross);
  const markers = series.map((s) => {
    const m = el("circle", {
      r: 4, fill: cssVar(s.color), stroke: cssVar("--surface-1"),
      "stroke-width": 2, visibility: "hidden",
    });
    svg.appendChild(m);
    return m;
  });

  svg.addEventListener("mousemove", (ev) => {
    if (!n) return;
    const rect = svg.getBoundingClientRect();
    const px = ((ev.clientX - rect.left) / rect.width) * width;
    const i = Math.round(((px - pad.l) / Math.max(W, 1)) * (n - 1));
    if (i < 0 || i >= n) return;
    cross.setAttribute("x1", x(i));
    cross.setAttribute("x2", x(i));
    cross.setAttribute("visibility", "visible");
    series.forEach((s, si) => {
      markers[si].setAttribute("cx", x(i));
      markers[si].setAttribute("cy", y(s.values[i]));
      markers[si].setAttribute("visibility", "visible");
    });
    const rows = series.map((s) =>
      `<div><span class="legend-swatch" style="background:${cssVar(s.color)}"></span>` +
      `${s.name}: <b>${fmtNum(s.values[i])}</b></div>`).join("");
    showTip(`<div class="tt-title">${labels[i]}</div>${rows}`,
            ev.clientX, ev.clientY);
  });
  svg.addEventListener("mouseleave", () => {
    cross.setAttribute("visibility", "hidden");
    markers.forEach((m) => m.setAttribute("visibility", "hidden"));
    hideTip();
  });

  card.appendChild(svg);
  container.appendChild(card);
}

// Grouped bars: series as in lineChart; 4px rounded tops, 2px gaps.
export function barChart(container, { series, labels, height = 180, title }) {
  container.innerHTML = "";
  const card = document.createElement("div");
  card.className = "card chart-card";
  if (title) {
    const t = document.createElement("div");
    t.className = "chart-title";
    t.textContent = title;
    card.appendChild(t);
  }
  if (series.length > 1) {
    const legend = document.createElement("div");
    legend.className = "chart-legend";
    for (const s of series) {
      const item = document.createElement("span");
      const sw = document.createElement("span");
      sw.className = "legend-swatch";
      sw.style.background = cssVar(s.color);
      item.appendChild(sw);
      item.appendChild(document.createTextNode(s.name));
      legend.appendChild(item);
    }
    card.appendChild(legend);
  }
  const width = Math.max(320, card.clientWidth || container.clientWidth || 640);
  const pad = { l: 46, r: 12, t: 8, b: 22 };
  const svg = el("svg", {
    viewBox: `0 0 ${width} ${height}`, class: "chart-svg", width: "100%",
    role: "img", "aria-label": title || "bar chart",
  });
  const W = width - pad.l - pad.r, H = height - pad.t - pad.b;
  const n = labels.length;
  const maxY = Math.max(1, ...series.flatMap((s) => s.values));
  const y = (v) => pad.t + H - (v / maxY) * H;

  for (const tv of niceTicks(maxY)) {
    svg.appendChild(el("line", {
      x1: pad.l, x2: pad.l + W, y1: y(tv), y2: y(tv), class: "gridline",
    }));
    const lab = el("text", { x: pad.l - 6, y: y(tv) + 3, "text-anchor": "end" });
    lab.textContent = fmtNum(tv);
    svg.appendChild(lab);
  }
  svg.appendChild(el("line", {
    x1: pad.l, x2: pad.l + W, y1: pad.t + H, y2: pad.t + H, class: "axisline",
  }));

  const group = W / Math.max(n, 1);
  const barW = Math.max(3, Math.min(26, (group - 8) / series.length - 2));
  const labelEvery = Math.max(1, Math.ceil(n / 10));
  labels.forEach((lb, i) => {
    if (i % labelEvery) return;
    const t = el("text", {
      x: pad.l + group * i + group / 2, y: height - 6, "text-anchor": "middle",
    });
    t.textContent = lb;
    svg.appendChild(t);
  });

  labels.forEach((lb, i) => {
    series.forEach((s, si) => {
      const v = s.values[i] || 0;
      const total = series.length * barW + (series.length - 1) * 2;
      const bx = pad.l + group * i + (group - total) / 2 + si * (barW + 2);
      const by = y(v), bh = pad.t + H - by;
      const r = Math.min(4, bh);
      const bar = el("path", {
        d: `M${bx},${pad.t + H} v${-(bh - r)} q0,-${r} ${r},-${r} ` +
           `h${barW - 2 * r} q${r},0 ${r},${r} v${bh - r} z`,
        fill: cssVar(s.color),
      });
      bar.addEventListener("mousemove", (ev) =>
        showTip(`<div class="tt-title">${lb}</div>` +
                `${s.name}: <b>${fmtNum(v)}</b>`, ev.clientX, ev.clientY));
      bar.addEventListener("mouseleave", hideTip);
      svg.appendChild(bar);
    });
  });

  card.appendChild(svg);
  container.appendChild(card);
}
