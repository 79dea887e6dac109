"""Live viewer: web waterfall + full per-RX control surface.

The reference's interactive loop — watch the pan-adaptor waterfall, click
to tune, adjust each RX (reference gui.py:1222-1398 UpdatePSD, 1769-1896
MouseClickRF, 1900-2038 FreqSelect, 382-468 per-RX freq boxes + AF
gain/mute, 1672-1765 video/AF BW menus, 521-598 pan controls;
Plotting.py:634-686 spot rendering) — reproduced headlessly: a stdlib
HTTP server streams DisplayEngine frames to an embedded HTML/canvas page,
and every control posts a pure params swap back through `executive.post`
(block-boundary mutation, zero recompiles). No Qt, no dependencies.

Surface:
  * RF PSD + waterfall with bandmap spot overlay (labels at their
    frequencies, colors from the UDP SpotTable) and click-to-tune with
    spot snapping;
  * SO2V/dual-VFO mouse semantics: left click tunes the selected RX,
    RIGHT click tunes RX1 (VFO-B), middle click swaps RX0/RX1
    (reference gui.py:1769-1896);
  * a pane per RX: frequency, mode, video BW, AF BW menus, AF gain and
    squelch sliders, mute — plus the selected RX's AF waterfall;
  * a tuning-step menu driving dial buttons, the mouse wheel, and
    click-to-tune rounding (reference demod-panel step selector,
    gui.py:474-516), and top-row RF/WF/AF/BB pane show/hide toggles
    (reference gui.py:121-221);
  * a live RTTY panel (decoded text + per-channel state) when the
    decoder runs (reference rtty.py:92-371 RTTY_GUI);
  * waterfall rows cross the wire as base64 uint8, not JSON int lists.

    python -m pysdr_tpu_torch ... --psd --web 8080    # then open localhost:8080

The port's own copy of pysdr_tpu/runtime/webview.py, with its imports
rewritten to pysdr_tpu_torch: the port imports nothing of the JAX package.
"""

from __future__ import annotations

import base64
import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

import numpy as np

from pysdr_tpu_torch import tables

# ---------------------------------------------------------------------------
# Declarative UI wiring spec. The page's dynamic behavior (which element
# drives which endpoint, with what value semantics) is DATA, not
# hand-written JS: the <script> below wires controls from this spec at
# runtime, and tests/test_webdom.py executes the SAME spec against a
# live server with a Python mini-DOM — so a renamed endpoint, query
# param, or element id breaks a test, not just the page (VERDICT r4 #4).
#
# kinds: "value" sends el.value; "checked" sends 1/0.
# "reload": re-poll that pane's JSON after the POST settles.
UI_SPEC = {
    "static": [
        {"id": "dr", "url": "display?dr={v}", "kind": "value"},
        {"id": "pk", "url": "display?peaks={v}", "kind": "checked"},
        {"id": "devgain", "url": "device?gain={v}", "kind": "value",
         "reload": "dev"},
        {"id": "devppm", "url": "device?ppm={v}", "kind": "value",
         "reload": "dev"},
        {"id": "devant", "url": "device?ant={v}", "kind": "value",
         "reload": "dev"},
        {"id": "rigband", "url": "rig?op=band&v={v}", "kind": "value",
         "reload": "rig"},
        {"id": "rigmode", "url": "rig?op=mode&v={v}", "kind": "value",
         "reload": "rig"},
        {"id": "rigrit", "url": "rig?op=rit&v={v}", "kind": "value",
         "reload": "rig"},
        {"id": "rigpwr", "url": "rig?op=tx_pwr&v={v}", "kind": "value",
         "reload": "rig"},
        {"id": "rigmic", "url": "rig?op=mic_gain&v={v}", "kind": "value",
         "reload": "rig"},
        {"id": "rigmon", "url": "rig?op=monitor&v={v}", "kind": "value",
         "reload": "rig"},
        {"id": "rigant", "url": "rig?op=ant&v={v}", "kind": "value",
         "reload": "rig"},
        {"id": "rigff", "url": "rig?op=follow_freq&v={v}",
         "kind": "checked", "reload": "rig"},
        {"id": "rigfb", "url": "rig?op=follow_band&v={v}",
         "kind": "checked", "reload": "rig"},
        {"id": "rigcl", "url": "rig?op=clar&v={v}", "kind": "checked",
         "reload": "rig"},
        # top-row save-raw-IQ toggle (reference gui.py:1184-1219);
        # records into the server's --save-dir
        {"id": "rec", "url": "record?iq={v}", "kind": "checked"},
    ],
    # per-RX row controls: element id is prefix+rx_index
    "row": [
        {"prefix": "f", "url": "tune?rx={i}&f={v}", "kind": "value"},
        {"prefix": "m", "url": "mode?rx={i}&m={v}", "kind": "value"},
        {"prefix": "vb", "url": "videobw?rx={i}&v={v}", "kind": "value"},
        {"prefix": "ab", "url": "afbw?rx={i}&v={v}", "kind": "value"},
        {"prefix": "g", "url": "gain?rx={i}&v={v}", "kind": "value"},
        {"prefix": "sq", "url": "squelch?rx={i}&v={v}", "kind": "value"},
        {"prefix": "mu", "url": "mute?rx={i}&v={v}", "kind": "checked"},
    ],
    # top-row pane show/hide toggles (reference gui.py:121-221)
    "panes": [
        {"id": "shrf", "targets": ["psd"]},
        {"id": "shwf", "targets": ["wf"]},
        {"id": "shaf", "targets": ["af", "tm"]},
        {"id": "shbb", "targets": ["bbl", "bb"]},
    ],
    # tuning-step menu (reference demod panel step selector,
    # gui.py:474-516): drives the dial buttons, the mouse wheel, and
    # click-to-tune rounding
    "steps_hz": [1, 10, 100, 500, 1000, 5000, 10000, 100000, 1000000],
}

# Per-RX table row template (instantiated by buildRows with the JS
# template-literal variables i/r/d in scope). Kept as data so tests can
# extract the generated per-RX element ids.
ROW_TEMPLATE = """<td>${i}</td>
   <td><input id="f${i}" size=10 value="${r.fc}"></td>
   <td><select id="m${i}">${opt(d.modes,r.mode,v=>v)}</select></td>
   <td><select id="vb${i}">${opt(d.video_bws,r.video_bw,v=>v?v/1e3+'k':'Max')}</select></td>
   <td><select id="ab${i}">${opt(d.af_bws,r.af_bw,v=>v?v/1e3+'k':'Max')}</select></td>
   <td><input id="g${i}" type="range" min="0" max="3" step="0.1" value="${r.gain}"></td>
   <td><input id="sq${i}" size=4 value="${r.squelch}"></td>
   <td><input id="mu${i}" type="checkbox" ${r.muted?'checked':''}></td>
   <td id="lv${i}"></td>"""

PAGE_TEMPLATE = """<!DOCTYPE html>
<html><head><title>pysdr_tpu</title><style>
 body{background:#111;color:#ddd;font:13px monospace;margin:14px}
 canvas{display:block;margin:4px 0;image-rendering:pixelated}
 select,button,input{background:#222;color:#ddd;border:1px solid #555}
 #freq{color:#8cf;font-size:18px}
 table{border-collapse:collapse} td,th{padding:1px 8px;text-align:left}
 tr.sel{background:#233} tr{cursor:pointer}
 #rtty{white-space:pre;background:#0a0a0a;border:1px solid #333;
       padding:4px;height:130px;overflow-y:scroll;display:none}
 .lbl{color:#999}
</style></head><body>
<div><span id="freq">--</span> Hz
 <span class="lbl">step</span><select id="step"></select>
 <button id="stup">&#9650;</button><button id="stdn">&#9660;</button>
 <select id="preset"><option value="">presets...</option></select>
 <span class="lbl">DR</span>
 <input id="dr" type="range" min="20" max="100" step="5" value="60"
  style="width:80px">
 <label class="lbl"><input id="pk" type="checkbox" checked>peaks</label>
 <select id="cmap"><option>viridis</option><option>jet</option>
  <option>gray</option></select>
 <label class="lbl"><input id="shrf" type="checkbox" checked>RF</label>
 <label class="lbl"><input id="shwf" type="checkbox" checked>WF</label>
 <label class="lbl"><input id="shaf" type="checkbox" checked>AF</label>
 <label class="lbl"><input id="shbb" type="checkbox" checked>BB</label>
 <label class="lbl"><input id="rec" type="checkbox">REC</label>
 <span id="peaks" class="lbl"></span></div>
<canvas id="psd" width="1024" height="120"></canvas>
<canvas id="wf" width="1024" height="240"></canvas>
<div class="lbl">click: tune selected RX &middot; right-click: VFO-B (RX1)
 &middot; middle-click: VFO swap</div>
<table id="rxt"><thead><tr><th>RX</th><th>freq Hz</th><th>mode</th>
 <th>video BW</th><th>AF BW</th><th>gain</th><th>squelch dB</th>
 <th>mute</th><th>level</th></tr></thead><tbody></tbody></table>
<canvas id="af" width="512" height="160"></canvas>
<canvas id="tm" width="512" height="60"></canvas>
<div id="bbl" class="lbl" style="display:none">BB (baseband)</div>
<canvas id="bb" width="512" height="120" style="display:none"></canvas>
<div id="devpane" style="border:1px solid #333;padding:4px;margin:4px 0">
 <b>DEV</b>
 <span class="lbl">RF gain</span>
 <input id="devgain" type="range" min="0" max="48" step="1"
  style="width:90px"><span id="devgainv" class="lbl"></span>
 <span class="lbl">PPM</span><input id="devppm" size=4>
 <span class="lbl">ANT</span><select id="devant"><option>RX</option>
  <option>A</option><option>B</option><option>Hi-Z</option></select>
 <span id="devinfo" class="lbl"></span>
</div>
<div id="rigpane"
 style="display:none;border:1px solid #333;padding:4px;margin:4px 0">
 <b>RIG</b> <span id="rigfreq">--</span> Hz
 <select id="rigband"><option value="">band...</option></select>
 <select id="rigmode"><option>USB</option><option>LSB</option>
  <option>CW</option><option>AM</option><option>FM</option>
  <option>RTTY</option></select>
 <span class="lbl">RIT</span><input id="rigrit" size=5>
 <span class="lbl">PWR</span>
 <input id="rigpwr" type="range" min="0" max="1" step="0.05"
  style="width:70px">
 <span class="lbl">MIC</span>
 <input id="rigmic" type="range" min="0" max="1" step="0.05"
  style="width:70px">
 <span class="lbl">MON</span>
 <input id="rigmon" type="range" min="0" max="1" step="0.05"
  style="width:70px">
 <span class="lbl">ANT</span><select id="rigant">
  <option value="0">A</option><option value="1">B</option></select>
 <button onclick="rigSet('vfo','A')">VFO A</button>
 <button onclick="rigSet('vfo','B')">VFO B</button>
 <label class="lbl"><input id="rigff" type="checkbox">follow-freq</label>
 <label class="lbl"><input id="rigfb" type="checkbox">follow-band</label>
 <label class="lbl"><input id="rigcl" type="checkbox">CLAR</label>
</div>
<canvas id="rwf" width="1024" height="100" style="display:none"></canvas>
<div id="rtty"></div>
<script>
const SPEC=__UI_SPEC__;
const wf=document.getElementById('wf'),psd=document.getElementById('psd');
const af=document.getElementById('af');
const wctx=wf.getContext('2d'),pctx=psd.getContext('2d');
const actx=af.getContext('2d');
let f0=0,f1=1,sel=0,nrx=1,built=false,meta=null,curFc=0;
function ctlVal(el,kind){return kind=='checked'?(el.checked?1:0):el.value;}
function wireOne(el,c,i){
 el.onchange=()=>{let u=c.url.replace('{v}',
   encodeURIComponent(ctlVal(el,c.kind)));
  if(i!==undefined)u=u.replace('{i}',i);
  fetch(u).then(()=>{if(c.reload=='rig')setTimeout(loadRig,100);
                     if(c.reload=='dev')setTimeout(loadDev,100);});};}
for(const c of SPEC.static)wireOne(document.getElementById(c.id),c);
// tuning-step selector (reference gui.py:474-516): dial buttons,
// mouse wheel, and click rounding all move by the selected step
{const st=document.getElementById('step');
 for(const s of SPEC.steps_hz){const o=document.createElement('option');
  o.value=s;o.text=s>=1e6?s/1e6+'M':(s>=1e3?s/1e3+'k':s+'');st.add(o);}
 st.value=1000;}
function stepHz(){return +document.getElementById('step').value;}
function nudge(dir){if(curFc)
 fetch('tune?rx='+sel+'&f='+(curFc+dir*stepHz()).toFixed(0));}
document.getElementById('stup').onclick=()=>nudge(1);
document.getElementById('stdn').onclick=()=>nudge(-1);
function paneOn(id){const e=document.getElementById(id);
 return !e||e.checked;}
function applyPanes(){for(const p of SPEC.panes)
 for(const t of p.targets){const el=document.getElementById(t);
  if(el&&el.dataset.has!=='0')
   el.style.display=paneOn(p.id)?'block':'none';}}
for(const p of SPEC.panes)
 document.getElementById(p.id).onchange=applyPanes;
const LUTS={
 viridis:v=>{const t=v/255;return [255*(0.267+t*0.726),
  255*(0.005+t*0.901),255*(0.329+(t<0.5?t*0.44:0.551-(t-0.5)*0.81))];},
 jet:v=>{const t=v/255;return [255*Math.min(1,Math.max(0,1.5-Math.abs(4*t-3))),
  255*Math.min(1,Math.max(0,1.5-Math.abs(4*t-2))),
  255*Math.min(1,Math.max(0,1.5-Math.abs(4*t-1)))];},
 gray:v=>[v,v,v]};
function lut(v){return LUTS[document.getElementById('cmap').value||'viridis'](v);}
fetch('presets.json').then(r=>r.json()).then(ps=>{
 const sel=document.getElementById('preset');
 for(const p of ps){const o=document.createElement('option');
  o.value=p.freq_hz+','+p.mode;o.text=p.name+' ('+p.group+')';sel.add(o);}
 sel.onchange=()=>{const [f,m]=sel.value.split(',');
  if(f){fetch('tune?rx=0&f='+f);fetch('mode?rx=0&m='+m);}};});
function b64u8(s){const b=atob(s);const a=new Uint8Array(b.length);
 for(let i=0;i<b.length;i++)a[i]=b.charCodeAt(i);return a;}
function drawWF(ctx,cv,b64,rows,cols){
 if(cv.width!=cols)cv.width=cols;
 const u=b64u8(b64),img=ctx.createImageData(cols,rows);
 for(let i=0;i<rows*cols;i++){const c=lut(u[i]);
  img.data[4*i]=c[0];img.data[4*i+1]=c[1];img.data[4*i+2]=c[2];img.data[4*i+3]=255;}
 ctx.putImageData(img,0,0);}
function drawPSD(ctx,cv,p,spots,g0,g1){
 ctx.fillStyle='#111';ctx.fillRect(0,0,cv.width,cv.height);
 const lo=Math.min(...p),hi=Math.max(...p)+1e-6;
 ctx.strokeStyle='#8cf';ctx.beginPath();
 for(let x=0;x<p.length;x++){const y=cv.height-1-(p[x]-lo)/(hi-lo)*(cv.height-2);
  x?ctx.lineTo(x,y):ctx.moveTo(x,y);}
 ctx.stroke();
 if(spots)for(const s of spots){
  const x=(s.f-g0)/(g1-g0)*cv.width;if(x<0||x>cv.width)continue;
  ctx.fillStyle={'r':'#f66','b':'#66f','g':'#6f6','y':'#ff6'}[s.color]||'#ff6';
  ctx.fillRect(x,0,1,cv.height);ctx.fillText(s.label,x+2,10);}}
function buildRows(d){
 const tb=document.querySelector('#rxt tbody');tb.innerHTML='';
 d.rx.forEach((r,i)=>{
  const tr=document.createElement('tr');tr.id='rx'+i;
  tr.onclick=(e)=>{if(e.target.tagName==='TD'){sel=i;}};
  const opt=(list,cur,fmt)=>list.map(v=>
   `<option value="${v}" ${v==cur?'selected':''}>${fmt(v)}</option>`).join('');
  tr.innerHTML=`__ROW_TEMPLATE__`;
  tb.appendChild(tr);
  for(const c of SPEC.row)
   wireOne(document.getElementById(c.prefix+i),c,i);});
 built=true;}
async function tick(){
 try{
  const r=await fetch('frame.json?rx='+sel);const d=await r.json();
  if(!d.ok){setTimeout(tick,400);return}
  f0=d.rf.f0;f1=d.rf.f1;nrx=d.n_rx;curFc=d.rx[sel].fc;
  document.getElementById('freq').textContent=d.rx[sel].fc.toFixed(0);
  document.getElementById('peaks').textContent=
    'peaks: '+d.rf.peaks.map(p=>p.toFixed(0)).join(' ');
  if(!built)buildRows(d);
  d.rx.forEach((r,i)=>{
   const row=document.getElementById('rx'+i);
   if(row)row.className=(i==sel)?'sel':'';
   const lv=document.getElementById('lv'+i);
   if(lv)lv.textContent=r.level.toFixed(2);
   const fi=document.getElementById('f'+i);
   if(fi&&document.activeElement!==fi)fi.value=r.fc;
   const mi=document.getElementById('m'+i);
   if(mi&&document.activeElement!==mi)mi.value=r.mode;});
  drawWF(wctx,wf,d.rf.wf_b64,d.rf.rows,d.rf.cols);
  drawPSD(pctx,psd,d.rf.psd,d.rf.spots,f0,f1);
  if(d.af){drawWF(actx,af,d.af.wf_b64,d.af.rows,d.af.cols);
   if(d.af.time){const tm=document.getElementById('tm'),
    tctx=tm.getContext('2d');tctx.fillStyle='#111';
    tctx.fillRect(0,0,tm.width,tm.height);
    tctx.strokeStyle='#7e7';tctx.beginPath();
    const mx=Math.max(...d.af.time,1e-6);
    d.af.time.forEach((v,i)=>{const x=i/d.af.time.length*tm.width,
     y=tm.height-1-v/mx*(tm.height-2);i?tctx.lineTo(x,y):tctx.moveTo(x,y);});
    tctx.stroke();}}
  {const bbcv=document.getElementById('bb'),
    bbl=document.getElementById('bbl');
   bbl.dataset.has=bbcv.dataset.has=d.bb?'1':'0';
   const on=d.bb&&paneOn('shbb');
   bbl.style.display=bbcv.style.display=on?'block':'none';
   if(on)drawWF(bbcv.getContext('2d'),bbcv,d.bb.wf_b64,d.bb.rows,d.bb.cols);}
  applyPanes();
  if(d.rtty){const el=document.getElementById('rtty');el.style.display='block';
   const rr=await fetch('rtty.json');const t=await rr.json();
   if(t.wf_b64){const rw=document.getElementById('rwf');
    rw.style.display='block';
    drawWF(rw.getContext('2d'),rw,t.wf_b64,t.rows,t.cols);}
   el.textContent=t.channels.map(c=>
     `ch${c.idx} ${c.freq_hz.toFixed(0)} Hz ${c.locked?'*':' '} ${c.text}`
    ).join('\\n');el.scrollTop=el.scrollHeight;}
 }catch(e){}
 setTimeout(tick,200);}
function rigSet(op,v){fetch('rig?op='+op+'&v='+encodeURIComponent(v))
 .then(()=>setTimeout(loadRig,100));}
async function loadRig(){try{
 const d=await (await fetch('rig.json')).json();
 if(!d.active)return;
 document.getElementById('rigpane').style.display='block';
 document.getElementById('rigfreq').textContent=d.freq.toFixed(0);
 const bs=document.getElementById('rigband');
 if(bs.options.length<2)for(const b of d.bands){
  const o=document.createElement('option');o.value=b;o.text=b;bs.add(o);}
 const set=(id,v)=>{const e=document.getElementById(id);
  if(document.activeElement!==e)e.value=v;};
 set('rigmode',d.mode);set('rigrit',d.rit);set('rigpwr',d.tx_pwr);
 set('rigmic',d.mic_gain);set('rigmon',d.monitor);set('rigant',d.ant);
 if('follow_freq' in d){
  document.getElementById('rigff').checked=d.follow_freq;
  document.getElementById('rigfb').checked=d.follow_band;
  document.getElementById('rigcl').checked=d.clar;}
}catch(e){}}
async function loadDev(){try{
 const d=await (await fetch('device.json')).json();
 if(!d.ok){document.getElementById('devpane').style.display='none';return;}
 const set=(id,v)=>{const e=document.getElementById(id);
  if(document.activeElement!==e)e.value=v;};
 set('devgain',d.gain_db);set('devppm',d.ppm);set('devant',d.antenna);
 document.getElementById('devgainv').textContent=d.gain_db+' dB';
 document.getElementById('devinfo').textContent=
  (d.fs/1e6).toFixed(3)+' Msps @ '+(d.fc/1e6).toFixed(3)+' MHz';
}catch(e){}}
loadRig();loadDev();setInterval(loadRig,2000);setInterval(loadDev,2000);
function fAt(ev,el){const r=el.getBoundingClientRect();
 const f=f0+(ev.clientX-r.left)/r.width*(f1-f0);
 return Math.round(f/stepHz())*stepHz();}  // clicks snap to the step
for(const el of [wf,psd]){
 el.onclick=e=>fetch('tune?rx='+sel+'&f='+fAt(e,el).toFixed(0));
 el.oncontextmenu=e=>{e.preventDefault();
  if(nrx>1)fetch('tune?rx=1&f='+fAt(e,el).toFixed(0));};
 el.onauxclick=e=>{if(e.button==1){e.preventDefault();fetch('vfo_swap');}};
 el.onwheel=e=>{e.preventDefault();nudge(-Math.sign(e.deltaY));};}
tick();
</script></body></html>
"""

# the served page: spec + row template injected as data
PAGE = (PAGE_TEMPLATE
        .replace("__UI_SPEC__", json.dumps(UI_SPEC))
        .replace("__ROW_TEMPLATE__", ROW_TEMPLATE))


class _Handler(BaseHTTPRequestHandler):
    def log_message(self, *a):   # silent
        pass

    def _send(self, body: bytes, ctype: str):
        self.send_response(200)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):  # noqa: N802 (stdlib API)
        try:
            self._route()
        except (KeyError, ValueError, IndexError) as e:
            # malformed/missing query params must not 500 with a
            # traceback: answer 400 and keep the connection usable
            self.send_error(400, f"bad request: {e!r}")

    def _route(self):
        view: WebViewer = self.server.view  # type: ignore
        url = urlparse(self.path)
        q = parse_qs(url.query)

        def qi(name, default=0):
            return int(q.get(name, [str(default)])[0])

        def qf(name):
            return float(q[name][0])

        if url.path in ("/", "/index.html"):
            return self._send(PAGE.encode(), "text/html")
        if url.path == "/frame.json":
            return self._send(
                json.dumps(view.frame_json(sel=qi("rx"))).encode(),
                "application/json")
        if url.path == "/rtty.json":
            return self._send(json.dumps(view.rtty_json()).encode(),
                              "application/json")
        if url.path == "/tune":
            view.tune(qf("f"), qi("rx"))
            return self._send(b"ok", "text/plain")
        if url.path == "/mode":
            view.set_mode(q["m"][0], qi("rx"))
            return self._send(b"ok", "text/plain")
        if url.path == "/gain":
            view.post("set_af_gain", qi("rx"), qf("v"))
            return self._send(b"ok", "text/plain")
        if url.path == "/squelch":
            view.post("set_squelch", qi("rx"), qf("v"))
            return self._send(b"ok", "text/plain")
        if url.path == "/afbw":
            view.post("set_af_bw", qi("rx"), qf("v"))
            return self._send(b"ok", "text/plain")
        if url.path == "/videobw":
            view.post("set_video_bw", qi("rx"), qf("v"))
            return self._send(b"ok", "text/plain")
        if url.path == "/mute":
            view.post("set_mute", qi("rx"), bool(qi("v")))
            return self._send(b"ok", "text/plain")
        if url.path == "/vfo_swap":
            view.vfo_swap()
            return self._send(b"ok", "text/plain")
        if url.path == "/display":
            # pan-adaptor controls (reference gui.py:521-598): DR and
            # peak picking are pure value swaps on the display pipeline,
            # applied at a block boundary via the command queue like every
            # other control (never mutated from the HTTP thread while
            # _on_block reads them)
            dr = qf("dr") if "dr" in q else None
            pk = bool(qi("peaks")) if "peaks" in q else None
            view.set_pan(dr=dr, peaks=pk)
            return self._send(b"ok", "text/plain")
        if url.path == "/presets.json":
            return self._send(json.dumps(view.presets_json()).encode(),
                              "application/json")
        if url.path == "/rig.json":
            return self._send(json.dumps(view.rig_json()).encode(),
                              "application/json")
        if url.path == "/rig":
            view.rig_set(q["op"][0], q.get("v", [""])[0])
            return self._send(b"ok", "text/plain")
        if url.path == "/device.json":
            return self._send(json.dumps(view.device_json()).encode(),
                              "application/json")
        if url.path == "/device":
            view.device_set(
                gain=qf("gain") if "gain" in q else None,
                ppm=qf("ppm") if "ppm" in q else None,
                ant=q["ant"][0] if "ant" in q else None)
            return self._send(b"ok", "text/plain")
        if url.path == "/record":
            view.record(bool(qi("iq")),
                        q.get("dir", [view.save_dir])[0])
            return self._send(b"ok", "text/plain")
        self.send_error(404)


def _wf_b64(fr) -> dict:
    """Waterfall as base64 uint8 rows — the binary wire format (the old
    nested-int-list JSON shipped ~0.5 MB/poll at 1024x100)."""
    wf = np.ascontiguousarray(fr.waterfall_u8)
    step = max(1, wf.shape[1] // 1024)
    wf = wf[:, ::step]
    return {"wf_b64": base64.b64encode(wf.tobytes()).decode(),
            "rows": int(wf.shape[0]), "cols": int(wf.shape[1]),
            "psd": np.asarray(fr.psd_db[::step], np.float64)
                     .round(1).tolist(),
            "f0": float(fr.freqs_hz[0]), "f1": float(fr.freqs_hz[-1])}


class WebViewer:
    """Bridges (DisplayEngine, Executive[, RTTY]) to the browser."""

    def __init__(self, display, executive, port: int = 8080,
                 host: str = "127.0.0.1", rtty_state=None,
                 presets_file: str | None = None,
                 save_iq_dtype: str = "complex64",
                 save_dir: str = ".",
                 rig=None, source=None, follower=None):
        self.display = display
        self.ex = executive
        self.rtty_state = rtty_state   # callable -> dict | None
        self.presets_file = presets_file
        self.save_iq_dtype = save_iq_dtype   # honors CLI --save-iq-dtype
        self.save_dir = save_dir             # honors CLI --save-dir
        self.rig = rig                 # runtime.rig.RigConnection | None
        self.source = source           # device model (io.synth surface)
        self.follower = follower       # runtime.rig.RigFollower | None
        self._presets = None
        self.server = ThreadingHTTPServer((host, port), _Handler)
        self.server.daemon_threads = True
        self.server.view = self  # type: ignore
        self.port = self.server.server_address[1]
        self._thread = None

    # --- data plane ---

    def _rx_cfgs(self):
        bank = self.ex.bank
        if hasattr(bank, "_rx_cfgs"):
            return bank._rx_cfgs, True
        return bank._ch_cfgs, False          # ChannelizerBank

    def _rx_row(self, i, rc, is_rx) -> dict:
        if is_rx:
            fc = rc.fc_hz
        else:
            bank = self.ex.bank
            fc = float(bank.cfg.center_freqs_hz()[i] + rc.fine_offset_hz)
        video_bw = rc.video_bw_hz
        af_fr = self.display.frames.get(f"AF{i}")
        level = float(np.mean(af_fr.time_y)) if af_fr is not None else 0.0
        return {"fc": fc, "mode": tables.MODE_NAMES[rc.mode],
                "video_bw": video_bw, "af_bw": rc.af_bw_hz,
                "gain": rc.af_gain, "squelch": rc.squelch_db,
                "muted": bool(rc.muted), "level": level}

    def frame_json(self, sel: int = 0) -> dict:
        fr = self.display.frames.get("RF")
        if fr is None:
            return {"ok": False}
        cfgs, is_rx = self._rx_cfgs()
        sel = max(0, min(sel, len(cfgs) - 1))
        rf = _wf_b64(fr)
        rf["peaks"] = np.asarray(fr.peak_freqs_hz, np.float64).tolist()
        rf["spots"] = [{"f": s.freq_hz, "label": s.label, "color": s.color}
                       for s in self.display.rf.spots]
        out = {
            "ok": True, "n_rx": len(cfgs), "sel": sel,
            "modes": list(tables.MODE_NAMES.values()),
            "video_bws": [bw for bw in tables.VIDEO_BWS_HZ],
            "af_bws": [bw for bw in tables.AF_BWS_HZ],
            "rf": rf,
            "rx": [self._rx_row(i, rc, is_rx)
                   for i, rc in enumerate(cfgs)],
            "rtty": self.rtty_state is not None,
        }
        af_fr = self.display.frames.get(f"AF{sel}")
        if af_fr is not None:
            out["af"] = _wf_b64(af_fr)
            # time pane: the |x| envelope strip completing the reference
            # three-box (time + PSD + waterfall, Plotting.py:312-753)
            out["af"]["time"] = np.asarray(
                af_fr.time_y, np.float64).round(4).tolist()
        # BB domain for the selected RX (reference RF/BB/AF three-domain
        # plotting with the show-BB toggle, gui.py:121-221)
        bb_fr = self.display.frames.get(f"BB{sel}")
        if bb_fr is not None:
            out["bb"] = _wf_b64(bb_fr)
        return out

    def presets_json(self) -> list:
        """Station preset list for the viewer's preset tabs (reference
        presets.xls tabs, gui.py:408-435)."""
        if self._presets is None:
            from pysdr_tpu_torch.runtime import presets as pre
            plist, _ = pre.load(self.presets_file)
            self._presets = [
                {"name": p.name, "freq_hz": p.freq_hz,
                 "mode": tables.MODE_NAMES[p.mode], "group": p.group}
                for p in plist]
        return self._presets

    def rtty_json(self) -> dict:
        """Live RTTY panel state (the reference RTTY window's waterfall +
        decoded-text list, rtty.py:92-371) — per-channel frequency, lock
        flag, and rolling decoded text."""
        if self.rtty_state is None:
            return {"channels": []}
        return self.rtty_state()

    # --- control plane (FreqSelect / ModeSelect / sliders) ---

    _PER_RX_METHODS = frozenset({
        "retune", "set_mode", "set_video_bw", "set_af_bw",
        "set_af_gain", "set_squelch", "set_agc", "set_mute"})

    def post(self, method, *args):
        """Guarded executive post: only control methods the active bank
        implements, with the RX index clamped (an out-of-range rx from a
        hand-typed URL must not reach the DSP thread)."""
        if hasattr(self.ex.bank, method):
            if method in self._PER_RX_METHODS and args:
                n = len(self._rx_cfgs()[0])
                args = (max(0, min(int(args[0]), n - 1)),) + args[1:]
            self.ex.post(method, *args)

    def tune(self, freq_hz: float, rx: int = 0):
        # snap to a bandmap spot when close (reference click snapping,
        # gui.py:1797-1830)
        spot = self.display.rf.spots.snap(freq_hz, max_dist_hz=2e3)
        if spot is not None:
            freq_hz = spot.freq_hz
        cfgs, is_rx = self._rx_cfgs()
        rx = max(0, min(rx, len(cfgs) - 1))   # never post a bad index
        if is_rx:
            self.ex.post("retune", rx, freq_hz)
        else:
            # channelizer: retune = fine offset within the nearest channel
            bank = self.ex.bank
            ch = bank.channel_of(freq_hz)
            off = freq_hz - float(bank.cfg.center_freqs_hz()[ch])
            self.ex.post("retune", ch, off)
        # the RF pane tracks the DEVICE passband, which in-passband
        # retunes do not move; device-follow retunes re-center it via
        # the bank's on_device_retune chain (app.py)

    def set_mode(self, name: str, rx: int = 0):
        self.post("set_mode", rx, tables.mode_from_name(name))

    # --- rig-control pane (reference RIG_CONTROL tab,
    # rig_control.py:45-366: band/mode/antenna groups, TX power/mic/
    # monitor sliders, VFO ops, sub-band jump). Ops talk straight to the
    # external rig over its rigctl socket — the bank then tracks the rig
    # through the RigFollower loop, exactly like the reference tab. ---

    def rig_json(self) -> dict:
        r = self.rig
        if r is None or not getattr(r, "active", False):
            return {"active": False}
        from pysdr_tpu_torch.runtime.hopper import BANDS_KHZ
        out = {"active": True, "freq": r.get_freq(),
               "mode": r.get_mode(), "vfo": r.get_vfo(),
               "rit": r.read_clarifier(), "tx_pwr": r.read_tx_pwr(),
               "mic_gain": r.read_mic_gain(),
               "monitor": r.read_monitor_level(), "ant": r.get_ant(),
               "bands": list(BANDS_KHZ)}
        f = self.follower
        if f is not None:
            # the pan panel's follow-freq / follow-band / CLAR toggles
            # (reference gui.py:521-598)
            out["follow_freq"] = f.follow_freq
            out["follow_band"] = f.follow_band
            out["clar"] = f.use_clarifier
        return out

    def rig_set(self, op: str, v: str):
        f = self.follower
        if f is not None and op in ("follow_freq", "follow_band", "clar"):
            attr = {"follow_freq": "follow_freq",
                    "follow_band": "follow_band",
                    "clar": "use_clarifier"}[op]
            setattr(f, attr, bool(int(float(v))))
            return
        r = self.rig
        if r is None or not getattr(r, "active", False):
            return
        if op == "freq":
            r.set_freq(float(v))
        elif op == "mode":
            r.set_mode(v)
        elif op == "rit":
            r.set_clarifier(float(v))
        elif op == "tx_pwr":
            r.set_tx_pwr(float(v))
        elif op == "mic_gain":
            r.set_mic_gain(float(v))
        elif op == "monitor":
            r.set_monitor_level(float(v))
        elif op == "ant":
            r.select_ant(int(float(v)))
        elif op == "band":
            r.select_band(v)
        elif op == "vfo":
            r.set_vfo(v)

    # --- device-settings pane (reference device panel, gui.py:229-379:
    # antenna/LNA gain/PPM/srate controls). Mutations land at a block
    # boundary: the executive's hot loop reads the source. ---

    def device_json(self) -> dict:
        s = self.source
        if s is None or not hasattr(s, "get_gain"):
            return {"ok": False}
        return {"ok": True, "gain_db": s.get_gain(),
                "ppm": s.get_freq_correction(),
                "antenna": s.get_antenna(),
                "fs": float(getattr(s, "srate", 0.0)),
                "fc": float(getattr(s, "fc", 0.0) or 0.0)}

    def device_set(self, gain: float | None = None,
                   ppm: float | None = None, ant: str | None = None):
        s = self.source
        if s is None or not hasattr(s, "set_gain"):
            return

        def apply(ex):
            if gain is not None:
                s.set_gain(gain)
            if ppm is not None:
                s.set_freq_correction(ppm)
            if ant is not None:
                s.set_antenna(ant)
        self.ex.post(apply)

    def set_pan(self, dr: float | None = None, peaks: bool | None = None):
        """Pan-adaptor DR / peak-picking swaps, queued to the block
        boundary (the one control that previously bypassed the
        command-queue discipline)."""
        rf_cfg = self.display.rf.cfg

        def apply(ex):
            if dr is not None:
                rf_cfg.pan_dr_db = dr
            if peaks is not None:
                rf_cfg.use_peaks = peaks
        self.ex.post(apply)

    def record(self, on: bool, save_dir: str | None = None):
        """Start/stop raw IQ recording mid-run (the GUI's save-raw
        toggle, reference gui.py:1184-1219) — applied at a block
        boundary so no block is half-written."""
        import os

        from pysdr_tpu_torch.io import datfile

        if save_dir is None:
            save_dir = self.save_dir
        cfgs, is_rx = self._rx_cfgs()
        fc = cfgs[0].fc_hz if is_rx else self.ex.bank.cfg.fc_hz

        def apply(ex):
            if on and ex.raw_writer is None:
                ex.raw_writer = datfile.DatWriter(
                    os.path.join(save_dir,
                                 datfile.timestamped_name("raw_iq")),
                    fs=ex.bank.design.fs_in, fc=fc,
                    dtype=self.save_iq_dtype)
            elif not on and ex.raw_writer is not None:
                w = ex.raw_writer
                ex.raw_writer = None
                w.close()
        self.ex.post(apply)

    def vfo_swap(self):
        """Middle-click VFO A/B swap (reference gui.py:1838-1861): RX0 and
        RX1 exchange frequencies, applied at the next block boundary."""
        cfgs, is_rx = self._rx_cfgs()
        if not is_rx or len(cfgs) < 2:
            return
        fa, fb = cfgs[0].fc_hz, cfgs[1].fc_hz
        self.ex.post("retune", 0, fb)
        self.ex.post("retune", 1, fa)

    # --- lifecycle ---

    def start(self):
        self._thread = threading.Thread(target=self.server.serve_forever,
                                        daemon=True)
        self._thread.start()
        return self

    def stop(self):
        self.server.shutdown()
        self.server.server_close()
