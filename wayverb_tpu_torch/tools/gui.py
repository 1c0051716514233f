"""Interactive front end: the reference GUI's core loop without JUCE (the
reference's ``tools/gui.py``).

The reference app (``wayverb/Source/``, about 9 kLoC of JUCE) lets a user
load a model, place the source and receiver, pick materials and quality,
run the hybrid render with live progress and a wavefront and ray view, and
audition the result.  This module keeps that loop as one standard-library
HTTP server plus a single page with no dependencies (a plain canvas: the
machine may have no network for scripts from a CDN):

 * 3-D wireframe and plan views of the loaded scene (OBJ/PLY/STL/OFF/DAE/
   DXF/FBX through ``core.scene.load_scene``, or a parametric shoebox);
 * draggable source and receiver markers (plan view) and height sliders,
   validated against the mesh as ``combined/validate.py`` does;
 * "Render": the whole hybrid pipeline (``combined.complete.run_project``)
   on a worker thread, on the server's device (the card unless ``--cpu``),
   its engine-state progress from the same ``state_callback`` the
   reference's engine events feed (``engine.h:38-48``), a cooperative
   cancel between phases;
 * a ray-path preview (a ``capture_positions`` trace) and a waveguide
   wavefront slice animation (``utils.events.iter_pressure_fields``, the
   reference's live pressure stream, ``engine.h:110-117``);
 * the IR's waveform, audition in the browser (WebAudio decodes the
   rendered WAV) and the WAV to download.

A render that raises shows as status ``"error"`` with its traceback in
``/api/progress``, as in the reference.

    python -m wayverb_tpu_torch.tools.gui [--port 8080] [--scene model.obj]
        [--cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import threading
import traceback

import numpy as np
import torch


# --------------------------------------------------------------------------
# state

class GuiState:
    def __init__(self):
        self.lock = threading.Lock()
        self.device = None             # where renders run (serve sets it)
        self.soup = None               # host TriangleSoup
        self.scene_box = None          # Box when the scene is a shoebox
        self.material_names = ["default"]
        self.status = "idle"
        self.progress = 0.0
        self.error = None
        self.running = False
        self.cancel = False
        self.signal = None             # rendered IR (np, (n,) or (2, n))
        self.sample_rate = 44100.0
        self.rays = None               # (R, depth+1, 3) polylines
        self.frames = None             # list of 2-D wavefront slices
        self.frame_extent = None


STATE = GuiState()


def load_box(dims=(5.56, 3.97, 2.81)):
    from wayverb_tpu_torch.core.geometry import Box, box_scene
    box = Box((0.0, 0.0, 0.0), tuple(float(v) for v in dims))
    with STATE.lock:
        STATE.soup = box_scene(box)
        STATE.scene_box = box
        STATE.material_names = ["default"]
    return box


def load_file(path):
    from wayverb_tpu_torch.core.scene import load_scene
    sd = load_scene(path)
    with STATE.lock:
        STATE.soup = sd.soup
        STATE.scene_box = None
        STATE.material_names = list(sd.material_names)


def scene_json():
    with STATE.lock:
        soup = STATE.soup
    if soup is None:
        return {"triangles": [], "bounds": None}
    c = soup.corners().cpu().numpy().astype(np.float64)   # (T, 3, 3)
    lo = c.reshape(-1, 3).min(axis=0)
    hi = c.reshape(-1, 3).max(axis=0)
    # cap payload for huge scenes
    tris = c if c.shape[0] <= 5000 else c[:: c.shape[0] // 5000 + 1]
    return {"triangles": np.round(tris, 4).tolist(),
            "bounds": [lo.tolist(), hi.tolist()],
            "num_triangles": int(c.shape[0]),
            "materials": STATE.material_names,
            "is_box": STATE.scene_box is not None}


class _CancelRender(Exception):
    pass


def _capture_rays(soup, surface, source, receiver, generator, device,
                  directions=None):
    """(R, depth + 1, 3) ray polylines from the source: 48 rays, 6
    bounces, on ``device`` with the scene's own backend (``auto_accel``).
    ``directions``: optional draws for ``trace``."""
    from wayverb_tpu_torch.raytracer.accel import auto_accel
    from wayverb_tpu_torch.raytracer.tracer import trace
    soup = soup.to(device)
    res = trace(soup, surface.to(device), source, receiver, generator,
                num_rays=48, depth=6, max_time=0.5, capture_positions=True,
                accel=auto_accel(soup, device), directions=directions)
    pts = res.positions.cpu().numpy().astype(np.float64)  # (depth, R, 3)
    start = np.tile(np.asarray(source, np.float64)[None, :],
                    (pts.shape[1], 1))[None]
    path = np.concatenate([start, pts], axis=0)           # (depth+1, R, 3)
    return np.transpose(path, (1, 0, 2))


def _capture_wavefront(soup, absorption, scene_box, source, receiver,
                       device):
    """Coarse-mesh pressure-slice animation (engine.h:110-117 parity): the
    y plane of the source on a 2,500 Hz mesh, 160 steps, a frame every 8,
    each quantised to ±127 of the largest |p|; with the slice's (x, z)
    extent.  (None, None) where a position maps to no inside node."""
    from wayverb_tpu_torch.utils.events import iter_pressure_fields
    from wayverb_tpu_torch.waveguide import run as wgrun
    from wayverb_tpu_torch.waveguide.descriptor import grid_spacing
    from wayverb_tpu_torch.waveguide.receivers import NodeReceiver
    from wayverb_tpu_torch.waveguide.sources import (
        HardSource, impulse_signal, rectilinear_calibration_factor)
    fs = 2500.0
    dx = grid_spacing(340.0, 1.0 / fs)
    mesh = wgrun.compute_mesh(soup, absorption, dx, fs,
                              scene_box=scene_box, device=device)
    desc = mesh.descriptor
    try:
        src = mesh.require_inside(source)
        rcv = mesh.require_inside(receiver)
    except RuntimeError:
        return None, None
    steps = 160
    amp = rectilinear_calibration_factor(desc.spacing, 400.0)
    s = HardSource(node_idx=desc.flat_index(src),
                   signal=impulse_signal(steps, amp, device))
    r = NodeReceiver(node_idx=torch.tensor(desc.flat_index(rcv),
                                           device=device))
    yslice = int(src[1])
    frames = []
    for done, field, _ in iter_pressure_fields(mesh, s, r, steps, every=8):
        sl = field[:, yslice, :].cpu().numpy().astype(np.float64)
        if STATE.cancel:
            raise _CancelRender()
        frames.append(sl)
    peak = max(max(abs(f).max() for f in frames), 1e-12)
    out = [np.round(np.clip(f / peak, -1, 1) * 127).astype(int).tolist()
           for f in frames]
    extent = [list(map(float, desc.position((0, yslice, 0))[[0, 2]])),
              list(map(float, desc.position(
                  (desc.dimensions[0] - 1, yslice,
                   desc.dimensions[2] - 1))[[0, 2]]))]
    return out, extent


def start_render(params):
    from wayverb_tpu_torch.combined import model as mdl
    from wayverb_tpu_torch.combined.complete import run_project

    def cb(state, progress):
        if STATE.cancel:
            raise _CancelRender()
        with STATE.lock:
            STATE.status = state
            STATE.progress = float(progress)

    def worker():
        try:
            src = tuple(float(v) for v in params["source"])
            rcv = tuple(float(v) for v in params["receiver"])
            absorption = float(params.get("absorption", 0.1))
            scattering = float(params.get("scattering", 0.1))
            capsule = mdl.CapsuleModel(
                name=str(params.get("capsule", "omni")),
                kind="hrtf" if params.get("capsule") in ("left", "right")
                else "microphone",
                channel=1 if params.get("capsule") == "right" else 0,
                shape=0.5 if params.get("capsule") == "cardioid" else 0.0)
            project = mdl.Project(
                sources=[mdl.SourceModel(name="s", position=src)],
                receivers=[mdl.ReceiverModel(name="r", position=rcv,
                                             capsules=[capsule])],
                materials=[mdl.MaterialModel(
                    name=n, absorption=[absorption] * 8,
                    scattering=[scattering] * 8)
                    for n in STATE.material_names],
                raytracer=mdl.RaytracerModel(
                    rays=int(params.get("rays", 1 << 13)),
                    maximum_image_source_order=2),
                waveguide=mdl.WaveguideModel(
                    cutoff=float(params.get("cutoff", 400.0))),
                output=mdl.OutputModel(
                    sample_rate=float(params.get("sample_rate", 44100.0))))
            with STATE.lock:
                soup, box, device = STATE.soup, STATE.scene_box, STATE.device
            generator = torch.Generator(device).manual_seed(
                int(params.get("seed", 0)))
            channels = run_project(project, soup, generator,
                                   scene_box=box, write_files=False,
                                   state_callback=cb, device=device)
            sig = np.stack([c.signal for c in channels]) \
                if len(channels) > 1 else channels[0].signal
            cb("capturing rays", 1.0)
            rays = _capture_rays(soup, project.surface_table(device="cpu"),
                                 src, rcv, generator, device)
            cb("capturing wavefront", 1.0)
            frames, extent = _capture_wavefront(
                soup, np.full((len(STATE.material_names), 8), absorption),
                box, src, rcv, device)
            with STATE.lock:
                STATE.signal = np.asarray(sig)
                STATE.sample_rate = project.output.sample_rate
                STATE.rays = rays
                STATE.frames = frames
                STATE.frame_extent = extent
                STATE.status = "done"
                STATE.progress = 1.0
        except _CancelRender:
            with STATE.lock:
                STATE.status = "cancelled"
        except Exception:
            with STATE.lock:
                STATE.error = traceback.format_exc(limit=6)
                STATE.status = "error"
        finally:
            with STATE.lock:
                STATE.running = False

    with STATE.lock:
        if STATE.running:
            return False
        STATE.running = True
        STATE.cancel = False
        STATE.error = None
        STATE.signal = None
        STATE.status = "starting"
        STATE.progress = 0.0
    threading.Thread(target=worker, daemon=True).start()
    return True


def result_wav_bytes():
    from wayverb_tpu_torch.utils.audio import write_wav
    with STATE.lock:
        sig, sr = STATE.signal, STATE.sample_rate
    if sig is None:
        return None
    with tempfile.NamedTemporaryFile(suffix=".wav", delete=False) as f:
        path = f.name
    try:
        write_wav(path, sig, sr)
        with open(path, "rb") as fh:
            return fh.read()
    finally:
        os.unlink(path)


# --------------------------------------------------------------------------
# HTTP plumbing

def make_handler():
    from http.server import BaseHTTPRequestHandler

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def _json(self, obj, code=200):
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _read_json(self):
            n = int(self.headers.get("Content-Length", 0))
            return json.loads(self.rfile.read(n) or b"{}")

        def do_GET(self):
            if self.path in ("/", "/index.html"):
                body = PAGE.encode()
                self.send_response(200)
                self.send_header("Content-Type",
                                 "text/html; charset=utf-8")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
            elif self.path == "/api/scene":
                self._json(scene_json())
            elif self.path == "/api/progress":
                with STATE.lock:
                    self._json({"status": STATE.status,
                                "progress": STATE.progress,
                                "running": STATE.running,
                                "error": STATE.error,
                                "has_result": STATE.signal is not None})
            elif self.path == "/api/result":
                with STATE.lock:
                    sig, sr = STATE.signal, STATE.sample_rate
                    rays = STATE.rays
                    frames, ext = STATE.frames, STATE.frame_extent
                if sig is None:
                    self._json({"error": "no result"}, 404)
                    return
                mono = sig if sig.ndim == 1 else sig[0]
                deci = max(1, len(mono) // 4000)
                self._json({
                    "ir": np.round(mono[::deci], 5).tolist(),
                    "decimation": deci, "sample_rate": sr,
                    "channels": 1 if sig.ndim == 1 else sig.shape[0],
                    "rays": (np.round(rays, 3).tolist()
                             if rays is not None else None),
                    "frames": frames, "frame_extent": ext})
            elif self.path == "/api/result.wav":
                data = result_wav_bytes()
                if data is None:
                    self._json({"error": "no result"}, 404)
                    return
                self.send_response(200)
                self.send_header("Content-Type", "audio/wav")
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)
            else:
                self._json({"error": "not found"}, 404)

        def do_POST(self):
            try:
                req = self._read_json()
                if self.path == "/api/load":
                    if "path" in req:
                        load_file(req["path"])
                    else:
                        load_box(req.get("dims", (5.56, 3.97, 2.81)))
                    self._json(scene_json())
                elif self.path == "/api/render":
                    ok = start_render(req)
                    self._json({"started": ok})
                elif self.path == "/api/cancel":
                    with STATE.lock:
                        STATE.cancel = True
                    self._json({"ok": True})
                else:
                    self._json({"error": "not found"}, 404)
            except Exception:
                self._json({"error": traceback.format_exc(limit=4)}, 500)

    return Handler


PAGE = r"""<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>wayverb_tpu_torch (PyTorch + CUDA)</title>
<style>
 body { font: 13px system-ui, sans-serif; margin: 0; background: #16181d;
        color: #d8dbe2; display: flex; flex-wrap: wrap; gap: 10px;
        padding: 10px; }
 .panel { background: #1f2229; border: 1px solid #2c3038;
          border-radius: 6px; padding: 10px; }
 canvas { background: #121419; border-radius: 4px; display: block; }
 h3 { margin: 0 0 6px; font-size: 13px; color: #9fb4d8; }
 button { background: #2d5bd1; color: #fff; border: 0; padding: 6px 14px;
          border-radius: 4px; cursor: pointer; margin-right: 6px; }
 button.sec { background: #3a3f49; }
 input, select { background: #14161b; color: #d8dbe2;
          border: 1px solid #2c3038; border-radius: 3px; padding: 3px;
          width: 64px; }
 #status { color: #8fd18f; min-height: 18px; }
 label { margin-right: 8px; }
</style></head><body>
<div class="panel">
  <h3>Scene · plan view (drag S/R)</h3>
  <canvas id="plan" width="460" height="380"></canvas>
  <div style="margin-top:6px">
    S height <input id="sy" type="number" step="0.1" value="1.2">
    R height <input id="ry" type="number" step="0.1" value="1.6">
    <span id="coords"></span>
  </div>
</div>
<div class="panel">
  <h3>3-D wireframe (drag to orbit)</h3>
  <canvas id="view3d" width="460" height="380"></canvas>
</div>
<div class="panel" style="min-width:460px">
  <h3>Render</h3>
  <div style="margin-bottom:6px">
    box <input id="bw" value="5.56"> × <input id="bh" value="3.97">
    × <input id="bd" value="2.81">
    <button class="sec" onclick="loadBox()">load box</button>
    <input id="objpath" style="width:180px" placeholder="path/to/model.obj">
    <button class="sec" onclick="loadObj()">load file</button>
  </div>
  <div style="margin-bottom:6px">
    absorption <input id="abs" value="0.1" step="0.02" type="number">
    cutoff Hz <input id="cutoff" value="400">
    rays <input id="rays" value="8192">
    capsule <select id="capsule">
      <option>omni</option><option>cardioid</option>
      <option>left</option><option>right</option></select>
  </div>
  <button onclick="render()">render</button>
  <button class="sec" onclick="cancel()">cancel</button>
  <button class="sec" id="play" disabled onclick="play()">play IR</button>
  <a id="dl" style="display:none;color:#9fb4d8" href="/api/result.wav"
     download="ir.wav">download wav</a>
  <div id="status"></div>
  <h3 style="margin-top:8px">Impulse response</h3>
  <canvas id="ir" width="440" height="140"></canvas>
  <h3 style="margin-top:8px">Wavefront slice</h3>
  <canvas id="wave" width="440" height="200"></canvas>
</div>
<script>
let scene = null, S = [1.5, 1.2, 1.0], R = [4.0, 1.6, 2.0];
let dragging = null, result = null, frameTimer = null;
let yaw = 0.8, pitch = 0.5, orbiting = false, lastXY = null;
const plan = document.getElementById('plan'),
      v3 = document.getElementById('view3d');

function b(id){ return document.getElementById(id); }
function planScale(){
  const [lo, hi] = scene.bounds;
  const w = hi[0]-lo[0], d = hi[2]-lo[2];
  const s = Math.min((plan.width-40)/w, (plan.height-40)/d);
  return {lo, s, ox: 20, oy: 20};
}
function toPlan(p){ const m = planScale();
  return [m.ox + (p[0]-m.lo[0])*m.s, m.oy + (p[2]-m.lo[2])*m.s]; }
function fromPlan(x, y){ const m = planScale();
  return [(x-m.ox)/m.s + m.lo[0], (y-m.oy)/m.s + m.lo[2]]; }

function drawPlan(frame){
  if (!scene) return;
  const g = plan.getContext('2d');
  g.clearRect(0,0,plan.width,plan.height);
  if (frame && result && result.frame_extent){
    const [a, bb] = result.frame_extent;
    const p0 = toPlan([a[0],0,a[1]]), p1 = toPlan([bb[0],0,bb[1]]);
    const img = g.createImageData(frame[0].length, frame.length);
    for (let i=0;i<frame.length;i++) for(let j=0;j<frame[0].length;j++){
      const v = frame[i][j], k = 4*(j + i*frame[0].length);
      img.data[k] = v>0 ? 90+v : 90; img.data[k+1] = 60;
      img.data[k+2] = v<0 ? 90-v : 90; img.data[k+3] = 160;
    }
    const off = document.createElement('canvas');
    off.width = frame[0].length; off.height = frame.length;
    off.getContext('2d').putImageData(img,0,0);
    g.save();
    g.translate(p0[0], p0[1]);
    g.scale((p1[0]-p0[0])/frame.length, (p1[1]-p0[1])/frame[0].length);
    g.rotate(Math.PI/2); g.scale(1,-1);
    g.drawImage(off, 0, 0);
    g.restore();
  }
  g.strokeStyle = '#4a5160';
  for (const t of scene.triangles){
    g.beginPath();
    const p = t.map(toPlan);
    g.moveTo(p[0][0], p[0][1]); g.lineTo(p[1][0], p[1][1]);
    g.lineTo(p[2][0], p[2][1]); g.closePath(); g.stroke();
  }
  for (const [p, c, n] of [[S, '#e3b341', 'S'], [R, '#5bc0de', 'R']]){
    const q = toPlan(p);
    g.fillStyle = c; g.beginPath();
    g.arc(q[0], q[1], 8, 0, 7); g.fill();
    g.fillStyle = '#16181d'; g.textAlign = 'center';
    g.fillText(n, q[0], q[1]+4);
  }
  b('coords').textContent =
    ` S(${S.map(v=>v.toFixed(2))}) R(${R.map(v=>v.toFixed(2))})`;
}

function project3(p, cen, scale){
  const cy=Math.cos(yaw), sy=Math.sin(yaw),
        cp=Math.cos(pitch), sp=Math.sin(pitch);
  let x=(p[0]-cen[0])*scale, y=(p[1]-cen[1])*scale, z=(p[2]-cen[2])*scale;
  let x1 = cy*x + sy*z, z1 = -sy*x + cy*z;
  let y1 = cp*y - sp*z1, z2 = sp*y + cp*z1;
  const d = 4 / (4 + z2);
  return [v3.width/2 + x1*120*d, v3.height/2 - y1*120*d];
}
function draw3d(){
  if (!scene) return;
  const g = v3.getContext('2d');
  g.clearRect(0,0,v3.width,v3.height);
  const [lo, hi] = scene.bounds;
  const cen = [ (lo[0]+hi[0])/2, (lo[1]+hi[1])/2, (lo[2]+hi[2])/2 ];
  const scale = 2/Math.max(hi[0]-lo[0], hi[1]-lo[1], hi[2]-lo[2]);
  g.strokeStyle = '#39404d';
  for (const t of scene.triangles){
    const p = t.map(q=>project3(q, cen, scale));
    g.beginPath(); g.moveTo(p[0][0],p[0][1]); g.lineTo(p[1][0],p[1][1]);
    g.lineTo(p[2][0],p[2][1]); g.closePath(); g.stroke();
  }
  if (result && result.rays){
    g.strokeStyle = 'rgba(227,179,65,0.35)';
    for (const path of result.rays){
      g.beginPath();
      const p = path.map(q=>project3(q, cen, scale));
      g.moveTo(p[0][0], p[0][1]);
      for (let i=1;i<p.length;i++) g.lineTo(p[i][0], p[i][1]);
      g.stroke();
    }
  }
  for (const [p, c] of [[S, '#e3b341'], [R, '#5bc0de']]){
    const q = project3(p, cen, scale);
    g.fillStyle = c; g.beginPath(); g.arc(q[0],q[1],6,0,7); g.fill();
  }
}

function drawIR(){
  const g = b('ir').getContext('2d');
  g.clearRect(0,0,440,140);
  if (!result) return;
  g.strokeStyle = '#8fd18f'; g.beginPath();
  const ir = result.ir, n = ir.length;
  let peak = 1e-9; for (const v of ir) peak = Math.max(peak, Math.abs(v));
  for (let i=0;i<n;i++){
    const x = i/n*440, y = 70 - ir[i]/peak*65;
    i ? g.lineTo(x,y) : g.moveTo(x,y);
  }
  g.stroke();
}

async function refreshScene(){
  scene = await (await fetch('/api/scene')).json();
  if (scene.bounds){
    const [lo, hi] = scene.bounds;
    S = [lo[0]+(hi[0]-lo[0])*0.3, parseFloat(b('sy').value),
         lo[2]+(hi[2]-lo[2])*0.3];
    R = [lo[0]+(hi[0]-lo[0])*0.7, parseFloat(b('ry').value),
         lo[2]+(hi[2]-lo[2])*0.7];
  }
  drawPlan(); draw3d();
}
async function loadBox(){
  await fetch('/api/load', {method:'POST', body: JSON.stringify(
    {dims: [parseFloat(b('bw').value), parseFloat(b('bh').value),
            parseFloat(b('bd').value)]})});
  result = null; await refreshScene();
}
async function loadObj(){
  const r = await fetch('/api/load', {method:'POST',
    body: JSON.stringify({path: b('objpath').value})});
  if (!r.ok) b('status').textContent = 'load failed';
  result = null; await refreshScene();
}
async function render(){
  S[1] = parseFloat(b('sy').value); R[1] = parseFloat(b('ry').value);
  await fetch('/api/render', {method:'POST', body: JSON.stringify({
    source: S, receiver: R,
    absorption: parseFloat(b('abs').value),
    cutoff: parseFloat(b('cutoff').value),
    rays: parseInt(b('rays').value),
    capsule: b('capsule').value})});
  poll();
}
async function cancel(){ await fetch('/api/cancel', {method:'POST'}); }
async function poll(){
  const p = await (await fetch('/api/progress')).json();
  b('status').textContent = p.error ? ('error: ' + p.error.slice(0, 300))
    : `${p.status} — ${(p.progress*100).toFixed(0)}%`;
  if (p.running) { setTimeout(poll, 700); return; }
  if (p.has_result){
    result = await (await fetch('/api/result')).json();
    b('play').disabled = false;
    b('dl').style.display = 'inline';
    drawIR(); draw3d(); animateWave();
  }
}
function animateWave(){
  if (!result || !result.frames) return;
  if (frameTimer) clearInterval(frameTimer);
  let i = 0;
  const g = b('wave').getContext('2d');
  frameTimer = setInterval(()=>{
    const f = result.frames[i % result.frames.length]; i++;
    const img = g.createImageData(f.length, f[0].length);
    for (let x=0;x<f.length;x++) for (let z=0;z<f[0].length;z++){
      const v = f[x][z], k = 4*(x + z*f.length);
      img.data[k] = v>0 ? 90+v : 90; img.data[k+1] = 70;
      img.data[k+2] = v<0 ? 90-v : 90; img.data[k+3] = 255;
    }
    const off = document.createElement('canvas');
    off.width = f.length; off.height = f[0].length;
    off.getContext('2d').putImageData(img, 0, 0);
    g.imageSmoothingEnabled = false;
    g.clearRect(0,0,440,200);
    g.drawImage(off, 0, 0, 440, 200);
  }, 120);
}
async function play(){
  const buf = await (await fetch('/api/result.wav')).arrayBuffer();
  const ctx = new AudioContext();
  const audio = await ctx.decodeAudioData(buf);
  const srcn = ctx.createBufferSource();
  srcn.buffer = audio; srcn.connect(ctx.destination); srcn.start();
}

plan.addEventListener('mousedown', e=>{
  const r = plan.getBoundingClientRect();
  const x = e.clientX-r.left, y = e.clientY-r.top;
  for (const [p, n] of [[S,'S'],[R,'R']]){
    const q = toPlan(p);
    if ((q[0]-x)**2 + (q[1]-y)**2 < 120) dragging = n;
  }
});
plan.addEventListener('mousemove', e=>{
  if (!dragging) return;
  const r = plan.getBoundingClientRect();
  const [x, z] = fromPlan(e.clientX-r.left, e.clientY-r.top);
  (dragging==='S' ? S : R)[0] = x;
  (dragging==='S' ? S : R)[2] = z;
  drawPlan(); draw3d();
});
window.addEventListener('mouseup', ()=>{ dragging = null; orbiting=false; });
v3.addEventListener('mousedown', e=>{ orbiting = true;
  lastXY = [e.clientX, e.clientY]; });
v3.addEventListener('mousemove', e=>{
  if (!orbiting) return;
  yaw += (e.clientX-lastXY[0])*0.01; pitch += (e.clientY-lastXY[1])*0.01;
  pitch = Math.max(-1.4, Math.min(1.4, pitch));
  lastXY = [e.clientX, e.clientY]; draw3d();
});
refreshScene();
</script></body></html>
"""


def serve(port=8080, scene_path=None, device=None):
    """The server on ``127.0.0.1:port`` (0: any free port), renders on
    ``device`` (default: the card; raises where there is none).  The caller
    runs ``serve_forever``."""
    from http.server import ThreadingHTTPServer
    from wayverb_tpu_torch.tools._cli import device_for
    device = device_for(False) if device is None else torch.device(device)
    with STATE.lock:
        STATE.device = device
    if scene_path:
        load_file(scene_path)
    else:
        load_box()
    httpd = ThreadingHTTPServer(("127.0.0.1", port), make_handler())
    print(f"wayverb_tpu_torch gui: "
          f"http://127.0.0.1:{httpd.server_address[1]}/", flush=True)
    return httpd


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--port", type=int, default=8080)
    ap.add_argument("--scene", default=None)
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args(argv)
    from wayverb_tpu_torch.tools._cli import device_for
    httpd = serve(args.port, args.scene, device_for(args.cpu))
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        httpd.server_close()
    return {"url": f"http://127.0.0.1:{httpd.server_address[1]}/"}


if __name__ == "__main__":
    main()
