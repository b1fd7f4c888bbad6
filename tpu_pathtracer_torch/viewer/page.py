"""The viewer's single-file browser page (no external assets), a copy of
`tpu_pathtracer.viewer.page`.

A vanilla-JS stand-in for the reference's Tweakpane panel + OrbitControls +
NProgress bar + fps graph (src/main.ts:78-400): the panel is generated from
GET /spec, the image polls /state and refetches /frame.png when the image
version changes, and mouse drag / wheel / shift-drag map to orbit
rotate / zoom / pan.
"""

PAGE_HTML = r"""<!doctype html>
<html lang="en"><head><meta charset="utf-8">
<title>tpu-pathtracer</title>
<style>
  :root { --bg:#101014; --panel:#1b1b22; --row:#24242e; --fg:#d8d8e0;
          --dim:#8a8a96; --acc:#5aa2ff; }
  * { box-sizing: border-box; }
  body { margin:0; background:var(--bg); color:var(--fg);
         font:13px/1.45 ui-monospace, SFMono-Regular, Menlo, monospace;
         display:flex; height:100vh; overflow:hidden; }
  #view { flex:1; display:flex; align-items:center; justify-content:center;
          position:relative; min-width:0; }
  #frame { max-width:96%; max-height:96%; image-rendering:pixelated;
           cursor:grab; user-select:none; -webkit-user-drag:none;
           background:#000; }
  #frame:active { cursor:grabbing; }
  #progress { position:absolute; top:0; left:0; height:3px;
              background:var(--acc); width:0%; transition:width .2s; }
  #panel { width:320px; background:var(--panel); overflow-y:auto;
           padding:10px 12px; border-left:1px solid #2e2e3a; }
  h1 { font-size:13px; margin:2px 0 10px; color:var(--acc);
       letter-spacing:.5px; }
  .row { display:flex; align-items:center; justify-content:space-between;
         background:var(--row); border-radius:4px; padding:5px 8px;
         margin:4px 0; gap:8px; }
  .row label { color:var(--dim); white-space:nowrap; }
  .row .val { min-width:44px; text-align:right; color:var(--fg); }
  input[type=range] { flex:1; accent-color:var(--acc); min-width:0; }
  select, button { background:#2e2e3a; color:var(--fg); border:0;
                   border-radius:3px; padding:3px 8px; font:inherit; }
  button { cursor:pointer; }
  button:hover { background:#3a3a4a; }
  #buttons { display:flex; gap:6px; margin:8px 0; }
  #buttons button { flex:1; }
  .stat { display:flex; justify-content:space-between; color:var(--dim);
          padding:1px 8px; }
  .stat b { color:var(--fg); font-weight:normal; }
  .sect { margin:12px 0 4px; color:var(--dim); text-transform:uppercase;
          font-size:10px; letter-spacing:1px; }
  input[type=file] { width:100%; font-size:11px; color:var(--dim); }
  #err { color:#ff7a7a; white-space:pre-wrap; }
</style></head><body>
<div id="view">
  <div id="progress"></div>
  <img id="frame" alt="render" draggable="false">
</div>
<div id="panel">
  <h1>tpu-pathtracer</h1>
  <div class="stat"><span>status</span><b id="status">–</b></div>
  <div class="stat"><span>fps / frame</span><b id="fps">–</b></div>
  <div class="stat"><span>resolution</span><b id="res">–</b></div>
  <div class="stat"><span>scene</span><b id="scenestats">–</b></div>
  <div id="timings"></div>
  <div id="buttons">
    <button id="start">start</button>
    <button id="pause">pause</button>
    <button id="reset">reset</button>
    <button id="shot">screenshot</button>
  </div>
  <div id="controls"></div>
  <div class="sect">import</div>
  <div class="row"><label>.glb scene</label>
    <input type="file" id="upscene" accept=".glb"></div>
  <div class="row"><label>.hdr env</label>
    <input type="file" id="upenv" accept=".hdr"></div>
  <div id="err"></div>
</div>
<script>
"use strict";
const $ = id => document.getElementById(id);
const err = m => { $("err").textContent = m || ""; };
async function api(path, opts) {
  const r = await fetch(path, opts);
  const j = await r.json().catch(() => ({}));
  if (!r.ok) { err(j.error || r.statusText); throw new Error(j.error); }
  err(""); return j;
}
const post = (path, obj) => api(path, {method:"POST", body:JSON.stringify(obj)});

let params = {}, lastVersion = -1, inflight = false;

function makeControl(spec) {
  const row = document.createElement("div"); row.className = "row";
  const label = document.createElement("label"); label.textContent = spec.label;
  row.appendChild(label);
  const send = v => post("/params", {[spec.name]: v});
  if (spec.kind === "bool") {
    const cb = document.createElement("input"); cb.type = "checkbox";
    cb.onchange = () => send(cb.checked);
    cb.dataset.param = spec.name; row.appendChild(cb);
  } else if (spec.kind === "select") {
    const sel = document.createElement("select");
    for (const o of spec.options) {
      const opt = document.createElement("option");
      opt.value = o; opt.textContent = o; sel.appendChild(opt);
    }
    sel.onchange = () => send(isNaN(+sel.value) ? sel.value : +sel.value);
    sel.dataset.param = spec.name; row.appendChild(sel);
  } else {
    const r = document.createElement("input"); r.type = "range";
    r.min = spec.min; r.max = spec.max; r.step = spec.step;
    const val = document.createElement("span"); val.className = "val";
    r.oninput = () => { val.textContent = r.value; };
    r.onchange = () => send(+r.value);
    r.dataset.param = spec.name; val.dataset.paramval = spec.name;
    row.appendChild(r); row.appendChild(val);
  }
  return row;
}

function syncControls() {
  for (const el of document.querySelectorAll("[data-param]")) {
    if (document.activeElement === el) continue;
    const v = params[el.dataset.param];
    if (v === undefined) continue;
    if (el.type === "checkbox") el.checked = !!v; else el.value = v;
  }
  for (const el of document.querySelectorAll("[data-paramval]"))
    el.textContent = params[el.dataset.paramval];
}

async function boot() {
  const spec = await api("/spec");
  const box = $("controls");
  for (const s of spec) box.appendChild(makeControl(s));
  poll();
  setInterval(poll, 150);
}

async function poll() {
  if (inflight) return; inflight = true;
  try {
    const s = await api("/state");
    params = s.params; syncControls();
    $("status").textContent =
      `${s.status} — ${s.samples} spp (${Math.round(s.progress * 100)}%)`;
    $("fps").textContent = `${s.fps} / ${s.frame_ms} ms`;
    const r = s.resolution;
    $("res").textContent =
      `${r.width}×${r.height} @ ${r.scaled_width}×${r.scaled_height}`;
    const st = s.scene_stats;
    $("scenestats").textContent =
      `${st.triangles} tris · ${st.materials} mats · ${st.bvh_nodes} nodes`;
    $("progress").style.width = `${Math.round(s.progress * 100)}%`;
    const t = $("timings");
    t.innerHTML = s.timing_enabled
      ? Object.entries(s.timings_us).map(([k, v]) =>
          `<div class="stat"><span>${k}</span><b>${v} µs</b></div>`).join("")
      : "";
    if (s.version !== lastVersion) {
      lastVersion = s.version;
      $("frame").src = `/frame.png?v=${s.version}`;
    }
  } catch (e) { /* shown via err() */ }
  inflight = false;
}

// buttons
for (const a of ["start", "pause", "reset"])
  $(a).onclick = () => post("/control", {action: a});
$("shot").onclick = () => {
  const a = document.createElement("a");
  a.href = `/frame.png?v=${lastVersion}`; a.download = "render.png";
  a.click();
};

// orbit controls: drag=rotate, shift/right-drag=pan, wheel=zoom
// (reference: OrbitControls, src/main.ts:366-371)
const frame = $("frame");
let drag = null, accum = {da: 0, de: 0, dx: 0, dy: 0}, camTimer = null;
function flushCam() {
  camTimer = null;
  const ops = {};
  if (accum.da || accum.de) ops.rotate = [accum.da, accum.de];
  if (accum.dx || accum.dy) ops.pan = [accum.dx, accum.dy];
  accum = {da: 0, de: 0, dx: 0, dy: 0};
  if (Object.keys(ops).length) post("/camera", ops);
}
frame.addEventListener("pointerdown", e => {
  drag = {x: e.clientX, y: e.clientY, pan: e.shiftKey || e.button === 2};
  frame.setPointerCapture(e.pointerId);
});
frame.addEventListener("pointermove", e => {
  if (!drag) return;
  const dx = e.clientX - drag.x, dy = e.clientY - drag.y;
  drag.x = e.clientX; drag.y = e.clientY;
  if (drag.pan) { accum.dx += -dx * 0.004; accum.dy += dy * 0.004; }
  else { accum.da += -dx * 0.008; accum.de += dy * 0.008; }
  if (!camTimer) camTimer = setTimeout(flushCam, 60);
});
frame.addEventListener("pointerup", () => { drag = null; flushCam(); });
frame.addEventListener("contextmenu", e => e.preventDefault());
frame.addEventListener("wheel", e => {
  e.preventDefault();
  post("/camera", {zoom: Math.exp(e.deltaY * 0.001)});
}, {passive: false});

// uploads
$("upscene").onchange = async e => {
  const f = e.target.files[0]; if (!f) return;
  await api("/upload/scene", {method: "POST", body: await f.arrayBuffer()});
};
$("upenv").onchange = async e => {
  const f = e.target.files[0]; if (!f) return;
  await api("/upload/env", {method: "POST", body: await f.arrayBuffer()});
};

boot();
</script></body></html>
"""
