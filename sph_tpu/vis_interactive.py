"""Interactive hierarchy explorer — self-contained HTML export.

Reference parity target: vis/Renderer.cpp (1042 LoC interactive OpenGL/ImGui
explorer: level maps, kNN edge overlay with distance/similarity weighting,
shortest-path overlay between picked nodes, random-walk similarity colormap
on click, point/line visual settings).  This environment is headless and has
zero network egress, so the equivalent here is an exported
single-file HTML app: all data embedded as JSON, all rendering vanilla-JS
canvas (pan/zoom/pick), no external dependencies.

Capabilities (mirroring Renderer.cpp's ImGui controls):
  - level slider: image-space label map + embedding scatter per level
  - kNN edge overlay with opacity slider and distance/similarity/all
    weighting modes (Renderer.cpp:634-639)
  - click a component: its random-walk similarity row paints both views
    with a sqrt colormap (Renderer.cpp:581-631)
  - shift-click two components: BFS/Dijkstra shortest path drawn over the
    embedding and listed (Renderer.cpp:573-579), geodesic (graph) path vs
    straight euclidean line
  - point size / opacity / background controls

Usage:
    from sph_tpu.vis_interactive import export_explorer
    export_explorer(ch, embeddings={1: emb}, path="explorer.html")

Validation status: the build image has no browser or JS runtime, so the
embedded script is hand-reviewed and the exported payload is covered by
tests (tests/test_vis_interactive.py parses the embedded JSON and checks
label/edge/walk domains); open the file in any browser to use it.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Optional

import numpy as np

# walk rows and kNN edges are embedded only for levels at or below this
# component count (level 0 of a real scene would be tens of MB of JSON)
MAX_EMBED_COMPONENTS = 12000


def _level_payload(ch, level: int, emb: Optional[np.ndarray]) -> dict:
    h = ch.image_hierarchy.hierarchy
    n = int(h.num_components[level])
    out: dict = {"n": n}

    # image-space labels at this level (flat, row-major); level 0 is the
    # identity pixel->component map
    if level == 0:
        labels = np.arange(int(h.num_components[0]), dtype=np.int32)
    else:
        labels = h.pixel_components[level]
    out["labels"] = np.asarray(labels, np.int32).tolist()

    if emb is not None:
        e = np.asarray(emb, np.float32)
        assert e.shape[0] == n, (e.shape, n)
        out["emb"] = [[round(float(x), 4), round(float(y), 4)]
                      for x, y in e]

    if n <= MAX_EMBED_COMPONENTS:
        # similarity graph at this level (the symmetrized prob dist)
        pd = None
        try:
            pd = ch.level_similarities.get_prob_dist(level)
        except Exception:
            pass
        edges = []
        if pd is not None and pd.num_rows == n:
            idx, val = pd.indices, pd.values
            for i in range(pd.num_rows):
                for j in range(pd.width):
                    t = int(idx[i, j])
                    if t < 0 or t <= i:            # undirected: emit once
                        continue
                    v = max(round(float(val[i, j]), 6), 1e-6)
                    edges.append([i, t, v])
        out["edges"] = edges

        # similarity rows for the click-to-paint overlay: the hierarchy's
        # random-walk matrix when walk-based sims were computed, else the
        # level's probability rows (Renderer.cpp paints walk mass; both
        # are "similarity from the clicked component")
        w = (h.random_walks[level]
             if level < len(h.random_walks) else pd)
        if w is not None and w.num_rows == n:
            rows = []
            for i in range(w.num_rows):
                cols = [int(c) for c in w.indices[i] if c >= 0]
                vals = [round(float(v), 6)
                        for c, v in zip(w.indices[i], w.values[i]) if c >= 0]
                rows.append([cols, vals])
            out["walks"] = rows
    return out


def build_explorer_data(ch, embeddings: Optional[Dict[int, np.ndarray]] = None,
                        title: str = "sph_tpu hierarchy explorer",
                        live: bool = False) -> dict:
    """The explorer's full JSON payload (shared by the static export and
    the live server; `live` reveals the recompute controls in the UI)."""
    h = ch.image_hierarchy.hierarchy
    embeddings = embeddings or {}
    return {
        "title": title,
        "live": bool(live),
        "rows": int(h.settings.num_rows),
        "cols": int(h.settings.num_cols),
        "num_levels": int(h.num_levels),
        "num_components": [int(c) for c in h.num_components],
        "levels": {
            str(lv): _level_payload(ch, lv, embeddings.get(lv))
            for lv in range(h.num_levels)
        },
    }


def render_explorer_html(data: dict) -> str:
    return _HTML_TEMPLATE.replace("/*__DATA__*/null",
                                  json.dumps(data, separators=(",", ":")))


def export_explorer(ch, embeddings: Optional[Dict[int, np.ndarray]] = None,
                    path: str = "explorer.html",
                    title: str = "sph_tpu hierarchy explorer") -> str:
    """Serialize a computed ComputeHierarchy (+ optional per-level
    embeddings) into a standalone interactive HTML file."""
    html = render_explorer_html(build_explorer_data(ch, embeddings, title))
    with open(path, "w") as f:
        f.write(html)
    return os.path.abspath(path)


_HTML_TEMPLATE = r"""<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>sph_tpu explorer</title>
<style>
 body{margin:0;font:13px system-ui,sans-serif;background:#14161a;color:#ddd;
      display:flex;height:100vh;overflow:hidden}
 #panel{width:270px;padding:12px;background:#1c1f26;overflow-y:auto;
        flex-shrink:0}
 #views{flex:1;display:flex;flex-direction:row}
 .view{flex:1;position:relative;min-width:0}
 canvas{position:absolute;inset:0;width:100%;height:100%}
 .vlabel{position:absolute;top:6px;left:10px;color:#8af;z-index:2;
         font-weight:600}
 label{display:block;margin:10px 0 2px;color:#9ab}
 input[type=range]{width:100%}
 .hint{color:#789;font-size:11px;margin-top:12px;line-height:1.5}
 #info{margin-top:10px;padding:8px;background:#23262e;border-radius:6px;
       min-height:52px;font-size:12px;white-space:pre-line}
 select,button{background:#2a2e38;color:#ddd;border:1px solid #444;
        border-radius:4px;padding:3px 8px;margin-top:4px}
 h3{margin:4px 0 8px;font-size:14px;color:#cdf}
</style></head><body>
<div id="panel">
 <h3 id="title"></h3>
 <label>Level: <span id="lvlLabel"></span></label>
 <input type="range" id="level" min="0" max="1" step="1" value="1">
 <label>Point size <span id="psLabel"></span></label>
 <input type="range" id="psize" min="1" max="20" step="0.5" value="5">
 <label>Point opacity</label>
 <input type="range" id="popacity" min="0.05" max="1" step="0.05" value="0.9">
 <label>kNN edges opacity</label>
 <input type="range" id="eopacity" min="0" max="1" step="0.05" value="0">
 <label>Edge weighting</label>
 <select id="eweight">
  <option value="all">All (uniform)</option>
  <option value="sim" selected>Similarity</option>
 </select>
 <label>Overlay</label>
 <select id="overlay">
  <option value="labels" selected>Component labels</option>
  <option value="walk">Walk similarity (click a point)</option>
 </select>
 <button id="clearSel">Clear selection</button>
 <div id="live" style="display:none">
  <h3>Live recompute</h3>
  <label>kNN k <span id="lkLabel">16</span></label>
  <input type="range" id="lk" min="2" max="64" step="1" value="16">
  <label>walks <span id="lwLabel">50</span> &times; steps
   <span id="llLabel">10</span></label>
  <input type="range" id="lw" min="5" max="200" step="5" value="50">
  <input type="range" id="ll" min="2" max="40" step="1" value="10">
  <button id="reKnn">Recompute kNN edges</button>
  <button id="reWalks">Recompute walks</button>
  <div id="liveInfo" class="hint"></div>
 </div>
 <div id="info">click: select / walk overlay
shift-click 2nd node: shortest path</div>
 <div class="hint">Drag to pan, wheel to zoom (each view independently).
 Left view: image space (level label map). Right view: embedding
 (when exported for this level). Shortest path runs Dijkstra over the
 level kNN graph with -log(similarity) weights — the geodesic polyline
 (orange) vs the straight euclidean segment (cyan), mirroring the
 reference explorer's path overlay.</div>
</div>
<div id="views">
 <div class="view"><span class="vlabel">image space</span>
  <canvas id="imgC"></canvas></div>
 <div class="view"><span class="vlabel">embedding</span>
  <canvas id="embC"></canvas></div>
</div>
<script>
const DATA = /*__DATA__*/null;
const $=id=>document.getElementById(id);
$("title").textContent = DATA.title;
const lvlIn=$("level"); lvlIn.max = DATA.num_levels-1;
let LV = Math.min(1, DATA.num_levels-1); lvlIn.value = LV;
let sel=-1, sel2=-1, path=[];

function hsl(i,n){return `hsl(${(i*137.508)%360},62%,${45+((i*7)%20)}%)`;}
function walkColor(v,max){ const t=Math.sqrt(Math.min(v/ (max||1),1));
 return `rgb(${Math.round(40+215*t)},${Math.round(40+80*t)},${Math.round(160-120*t)})`;}

class View{
 constructor(canvas){this.c=canvas;this.ctx=canvas.getContext("2d");
  this.s=1;this.tx=0;this.ty=0;this.drag=null;
  canvas.addEventListener("wheel",e=>{e.preventDefault();
   const f=Math.exp(-e.deltaY*0.0015);
   const r=canvas.getBoundingClientRect();
   const x=e.clientX-r.left,y=e.clientY-r.top;
   this.tx=x-(x-this.tx)*f; this.ty=y-(y-this.ty)*f; this.s*=f; draw();});
  canvas.addEventListener("mousedown",e=>{this.drag=[e.clientX,e.clientY];});
  window.addEventListener("mousemove",e=>{if(!this.drag)return;
   this.tx+=e.clientX-this.drag[0]; this.ty+=e.clientY-this.drag[1];
   this.drag=[e.clientX,e.clientY]; draw();});
  window.addEventListener("mouseup",()=>{this.drag=null;});
 }
 resize(){const r=this.c.parentElement.getBoundingClientRect();
  this.c.width=r.width*devicePixelRatio;this.c.height=r.height*devicePixelRatio;}
 apply(){this.ctx.setTransform(devicePixelRatio,0,0,devicePixelRatio,0,0);
  this.ctx.translate(this.tx,this.ty);this.ctx.scale(this.s,this.s);}
}
const iv=new View($("imgC")), ev=new View($("embC"));

function level(){return DATA.levels[String(LV)];}
function fitEmb(){ // world->screen mapping for embedding view
 const L=level(); if(!L.emb) return null;
 let x0=1e9,x1=-1e9,y0=1e9,y1=-1e9;
 for(const p of L.emb){x0=Math.min(x0,p[0]);x1=Math.max(x1,p[0]);
  y0=Math.min(y0,p[1]);y1=Math.max(y1,p[1]);}
 const r=ev.c.getBoundingClientRect(), m=30;
 const s=Math.min((r.width-2*m)/Math.max(x1-x0,1e-9),
                  (r.height-2*m)/Math.max(y1-y0,1e-9));
 return p=>[m+(p[0]-x0)*s, m+(p[1]-y0)*s];
}
function walkRow(i){const L=level();
 if(!L.walks||!L.walks[i])return null;
 const [cols,vals]=L.walks[i]; const m={}; let mx=0;
 for(let j=0;j<cols.length;j++){m[cols[j]]=vals[j];mx=Math.max(mx,vals[j]);}
 return {m,mx};}

function colorOf(i,L,wr){
 if($("overlay").value==="walk"&&wr)
  return wr.m[i]!==undefined?walkColor(wr.m[i],wr.mx):"#333";
 return hsl(i,L.n);}

function draw(){
 const L=level();
 $("lvlLabel").textContent=`${LV} (${L.n} components)`;
 $("psLabel").textContent=$("psize").value;
 // image view: label map colored by component (or walk overlay)
 iv.resize(); const ictx=iv.ctx; ictx.save(); iv.apply();
 const wr = sel>=0?walkRow(sel):null;
 const cw=Math.min((iv.c.getBoundingClientRect().width-20)/DATA.cols,
                   (iv.c.getBoundingClientRect().height-20)/DATA.rows);
 for(let r=0;r<DATA.rows;r++)for(let c=0;c<DATA.cols;c++){
  const lab=L.labels[r*DATA.cols+c];
  ictx.fillStyle=colorOf(lab,L,wr);
  if(lab===sel)ictx.fillStyle="#fff";
  if(lab===sel2)ictx.fillStyle="#f80";
  ictx.fillRect(10+c*cw,10+r*cw,cw+0.5,cw+0.5);
 }
 ictx.restore();
 // embedding view
 ev.resize(); const ctx=ev.ctx; ctx.save(); ev.apply();
 const f=fitEmb();
 if(f){
  const eo=parseFloat($("eopacity").value);
  if(eo>0&&L.edges){ctx.globalAlpha=eo;
   for(const[a,b,w]of L.edges){const pa=f(L.emb[a]),pb=f(L.emb[b]);
    ctx.strokeStyle="#6af";
    ctx.lineWidth=$("eweight").value==="sim"?Math.min(4,w*120+0.2):0.5;
    ctx.beginPath();ctx.moveTo(pa[0],pa[1]);ctx.lineTo(pb[0],pb[1]);
    ctx.stroke();}}
  ctx.globalAlpha=1;
  if(path.length>1){ctx.strokeStyle="#f80";ctx.lineWidth=2.5;
   ctx.beginPath();const p0=f(L.emb[path[0]]);ctx.moveTo(p0[0],p0[1]);
   for(const q of path.slice(1)){const p=f(L.emb[q]);ctx.lineTo(p[0],p[1]);}
   ctx.stroke();
   ctx.strokeStyle="#0ef";ctx.lineWidth=1.2;ctx.setLineDash([6,4]);
   const a=f(L.emb[path[0]]),b=f(L.emb[path[path.length-1]]);
   ctx.beginPath();ctx.moveTo(a[0],a[1]);ctx.lineTo(b[0],b[1]);ctx.stroke();
   ctx.setLineDash([]);}
  ctx.globalAlpha=parseFloat($("popacity").value);
  const ps=parseFloat($("psize").value);
  for(let i=0;i<L.n;i++){const p=f(L.emb[i]);
   ctx.fillStyle=colorOf(i,L,wr);
   if(i===sel)ctx.fillStyle="#fff";
   if(i===sel2)ctx.fillStyle="#f80";
   ctx.beginPath();ctx.arc(p[0],p[1],i===sel||i===sel2?ps*1.6:ps,0,7);
   ctx.fill();}
 } else {
  ctx.fillStyle="#667";ctx.fillText("no embedding exported for this level",
                                    30,40);
 }
 ctx.restore();
}

function dijkstra(src,dst){
 const L=level(); if(!L.edges)return[];
 const adj={};
 for(const[a,b,w]of L.edges){const d=-Math.log(Math.max(w,1e-12));
  (adj[a]=adj[a]||[]).push([b,d]);(adj[b]=adj[b]||[]).push([a,d]);}
 const dist={},prev={},Q=new Set([src]);dist[src]=0;
 const done=new Set();
 while(Q.size){let u=-1,du=1/0;
  for(const q of Q)if(dist[q]<du){du=dist[q];u=q;}
  Q.delete(u);done.add(u);if(u===dst)break;
  for(const[v,w]of(adj[u]||[])){if(done.has(v))continue;
   const nd=du+w;if(dist[v]===undefined||nd<dist[v]){dist[v]=nd;prev[v]=u;
    Q.add(v);}}}
 if(dist[dst]===undefined)return[];
 const p=[dst];while(p[p.length-1]!==src)p.push(prev[p[p.length-1]]);
 return p.reverse();
}

function pickEmb(e){const L=level();if(!L.emb)return-1;
 const r=ev.c.getBoundingClientRect();
 const x=(e.clientX-r.left-ev.tx)/ev.s,y=(e.clientY-r.top-ev.ty)/ev.s;
 const f=fitEmb();let best=-1,bd=120;
 for(let i=0;i<L.n;i++){const p=f(L.emb[i]);
  const d=(p[0]-x)**2+(p[1]-y)**2;if(d<bd){bd=d;best=i;}}
 return best;}
function pickImg(e){const r=iv.c.getBoundingClientRect();
 const x=(e.clientX-r.left-iv.tx)/iv.s,y=(e.clientY-r.top-iv.ty)/iv.s;
 const cw=Math.min((r.width-20)/DATA.cols,(r.height-20)/DATA.rows);
 const c=Math.floor((x-10)/cw),rr=Math.floor((y-10)/cw);
 if(c<0||rr<0||c>=DATA.cols||rr>=DATA.rows)return-1;
 return level().labels[rr*DATA.cols+c];}

function clicked(i,e){if(i<0)return;
 if(e.shiftKey&&sel>=0&&i!==sel){sel2=i;path=dijkstra(sel,sel2);
  $("info").textContent=`path ${sel} -> ${sel2}: `+
   (path.length?path.join(" → "):"(disconnected)");}
 else{sel=i;sel2=-1;path=[];
  const wr=walkRow(i);
  $("info").textContent=`component ${i}`+
   (wr?`\nwalk row: ${Object.keys(wr.m).length} entries, max ${wr.mx}`:"");}
 draw();}
$("embC").addEventListener("click",e=>clicked(pickEmb(e),e));
$("imgC").addEventListener("click",e=>clicked(pickImg(e),e));
$("clearSel").onclick=()=>{sel=-1;sel2=-1;path=[];
 $("info").textContent="";draw();};
for(const id of["level","psize","popacity","eopacity","eweight","overlay"])
 $(id).addEventListener("input",()=>{LV=parseInt(lvlIn.value);
  sel=Math.min(sel,level().n-1);sel2=-1;path=[];draw();});
window.addEventListener("resize",draw);

// live mode: recompute kNN edges / random walks server-side as the
// sliders move (reference parity: vis/Renderer.cpp recomputes on slider
// change; here the pipeline's own device ops run on demand)
if(DATA.live){
 $("live").style.display="block";
 const linfo=$("liveInfo");
 for(const[idIn,idLab]of[["lk","lkLabel"],["lw","lwLabel"],["ll","llLabel"]])
  $(idIn).addEventListener("input",()=>{$(idLab).textContent=$(idIn).value;});
 async function api(url){
  linfo.textContent="computing…"; const t0=performance.now();
  const r=await fetch(url); const j=await r.json();
  linfo.textContent=`done in ${((performance.now()-t0)/1000).toFixed(2)} s`;
  if(j.error){linfo.textContent=j.error; return null;}
  return j;}
 $("reKnn").onclick=async()=>{
  const j=await api(`/api/knn?level=${LV}&k=${$("lk").value}`);
  if(j){level().edges=j.edges;$("eopacity").value=Math.max(
   parseFloat($("eopacity").value),0.4);draw();}};
 $("reWalks").onclick=async()=>{
  const j=await api(`/api/walks?level=${LV}&num=${$("lw").value}`+
                    `&len=${$("ll").value}`);
  if(j){level().walks=j.walks;$("overlay").value="walk";draw();}};
}
draw();
</script></body></html>
"""
