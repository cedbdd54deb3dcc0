"""Interactive sparse-model viewer: one self-contained HTML file (port
of ``privacy_preserving_sfm_tpu/viz/interactive.py``, byte for byte the
same output).

The reference framework's interactive surface is a Qt5/OpenGL desktop
viewer (``src/ui/model_viewer_widget.cc``: orbit/zoom navigation, point
cloud colored by the ``colormaps.cc`` quantities, camera frusta,
point-size and frustum controls).  Headless, the equivalent is an
exported artifact: the model embedded as base64 Float32Arrays and a
dependency-free canvas renderer (drag to orbit, shift-drag to pan, wheel
to zoom, color by track length, reprojection error or depth, click a
camera to highlight its frustum and show its image name).  numpy only:
no matplotlib.

``ppsfm model_viewer --html out.html`` writes it from a model directory.
"""

from __future__ import annotations

import base64
import json

import numpy as np

from privacy_preserving_sfm_torch.viz.frustum import frustum_segments


def _b64(arr: np.ndarray) -> str:
    return base64.b64encode(np.ascontiguousarray(arr, np.float32)
                            .tobytes()).decode("ascii")


def export_html(rec, out_path: str, max_points: int = 200_000) -> str:
    """Write a standalone interactive viewer for ``rec`` to ``out_path``."""
    pids = sorted(rec.points3d)
    if len(pids) > max_points:
        # Biased decimation by design: keep the max_points longest-track
        # points (the best-constrained structure), unlike render.py's
        # uniform stride — an overview artifact wants the stable points.
        order = np.argsort([-len(rec.points3d[p].track) for p in pids])
        pids = [pids[i] for i in order[:max_points]]
    xyz = (np.stack([rec.points3d[p].xyz for p in pids])
           if pids else np.zeros((0, 3)))
    track = np.array([len(rec.points3d[p].track) for p in pids], np.float32)
    error = np.array([max(rec.points3d[p].error, 0.0) for p in pids],
                     np.float32)

    reg = [iid for iid in sorted(rec.images)
           if rec.images[iid].registered]
    centers = (np.stack([rec.images[i].projection_center() for i in reg])
               if reg else np.zeros((0, 3)))
    scene_pts = np.concatenate([xyz, centers], 0)
    if len(scene_pts):
        scale = 0.05 * float(
            np.linalg.norm(np.ptp(scene_pts, axis=0)))
    else:
        scale = 1.0
    frusta = (np.concatenate([frustum_segments(rec, i, scale)
                              for i in reg])
              if reg else np.zeros((0, 2, 3)))
    names = [rec.images[i].name for i in reg]

    payload = {
        "xyz": _b64(xyz), "track": _b64(track), "error": _b64(error),
        "frusta": _b64(frusta.reshape(-1, 3)),
        "centers": _b64(centers),
        "n_points": int(len(pids)), "n_images": len(reg),
        "names": names,
        "stats": {
            "points": int(len(pids)), "images": len(reg),
            "mean_track": float(track.mean()) if len(track) else 0.0,
            "mean_error_px": float(error.mean()) if len(error) else 0.0,
        },
    }
    # Escape '<' so dataset-controlled strings (image names) can never
    # close the <script> element — the artifact must stay inert HTML
    # whatever the inputs were called.
    html = _TEMPLATE.replace(
        "__PAYLOAD__", json.dumps(payload).replace("<", "\\u003c"))
    with open(out_path, "w") as f:
        f.write(html)
    return out_path


_TEMPLATE = r"""<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>ppsfm model viewer</title>
<style>
 body{margin:0;background:#101014;color:#ddd;font:13px sans-serif;
      overflow:hidden}
 #hud{position:fixed;top:8px;left:8px;background:rgba(20,20,28,.85);
      padding:8px 10px;border-radius:6px;line-height:1.7}
 select,input[type=range]{vertical-align:middle}
 #name{position:fixed;bottom:8px;left:8px;color:#9cf}
</style></head><body>
<canvas id="c"></canvas>
<div id="hud">
 <b>ppsfm viewer</b> — <span id="stats"></span><br>
 color <select id="mode"><option>track</option><option>error</option>
 <option>depth</option></select>
 &nbsp;point <input id="psz" type="range" min="1" max="6" value="2">
 &nbsp;frusta <input id="fr" type="checkbox" checked>
 <br>drag orbit · shift-drag pan · wheel zoom
</div>
<div id="name"></div>
<script>
const D=__PAYLOAD__;
const f32=s=>new Float32Array(Uint8Array.from(atob(s),c=>c.charCodeAt(0)).buffer);
const P=f32(D.xyz),TR=f32(D.track),ER=f32(D.error),FR=f32(D.frusta);
const CC=f32(D.centers),NC=D.n_images,
      SEG=NC?(FR.length/6)/NC:0; // frustum segments per camera
let hi=-1; // highlighted camera index
const N=D.n_points;
document.getElementById('stats').textContent=
 D.stats.images+' imgs · '+D.stats.points+' pts · track '+
 D.stats.mean_track.toFixed(1)+' · reproj '+
 D.stats.mean_error_px.toFixed(3)+'px';
// center + radius
let cx=0,cy=0,cz=0;for(let i=0;i<N;i++){cx+=P[3*i];cy+=P[3*i+1];cz+=P[3*i+2];}
if(N){cx/=N;cy/=N;cz/=N;}
let rad=1e-6;for(let i=0;i<N;i++){const dx=P[3*i]-cx,dy=P[3*i+1]-cy,
 dz=P[3*i+2]-cz;rad=Math.max(rad,Math.hypot(dx,dy,dz));}
let yaw=-1.0,pitch=-0.5,dist=2.5*rad,panx=0,pany=0;
const cv=document.getElementById('c'),ctx=cv.getContext('2d');
function resize(){cv.width=innerWidth;cv.height=innerHeight;draw();}
addEventListener('resize',resize);
// viridis-ish ramp
function ramp(t){t=Math.min(1,Math.max(0,t));
 const r=Math.round(255*Math.min(1,Math.max(0,1.8*t-0.6)));
 const g=Math.round(255*Math.min(1,1.5*t+0.1));
 const b=Math.round(255*Math.min(1,Math.max(0,1.2-1.5*t)));
 return [r,g,b];}
function pct(a,q){if(!a.length)return 0;
 const s=Array.from(a).sort((x,y)=>x-y);
 return s[Math.min(s.length-1,Math.floor(q*s.length))];}
let colors=null;
function recolor(){
 const mode=document.getElementById('mode').value;
 let v;
 if(mode==='track')v=TR;else if(mode==='error')v=ER;
 else{v=new Float32Array(N);for(let i=0;i<N;i++)v[i]=P[3*i+2];}
 const lo=pct(v,0.02),hi=Math.max(pct(v,0.98),lo+1e-9);
 colors=new Uint8Array(3*N);
 for(let i=0;i<N;i++){const c=ramp((v[i]-lo)/(hi-lo));
  colors[3*i]=c[0];colors[3*i+1]=c[1];colors[3*i+2]=c[2];}
 draw();}
document.getElementById('mode').onchange=recolor;
document.getElementById('psz').oninput=draw;
document.getElementById('fr').onchange=draw;
function proj(x,y,z,M){ // world -> [sx,sy,depth]
 x-=cx;y-=cy;z-=cz;
 const x1=M[0]*x+M[1]*y+M[2]*z, y1=M[3]*x+M[4]*y+M[5]*z,
       z1=M[6]*x+M[7]*y+M[8]*z+dist;
 if(z1<1e-4)return null;
 const f=0.9*Math.min(cv.width,cv.height);
 return [cv.width/2+panx+f*x1/z1, cv.height/2+pany+f*y1/z1, z1];}
function draw(){
 if(!colors)return;
 const cyw=Math.cos(yaw),syw=Math.sin(yaw),
       cp=Math.cos(pitch),sp=Math.sin(pitch);
 // R = Rx(pitch)*Ry(yaw), row-major
 const M=[cyw,0,syw, syw*sp,cp,-cyw*sp, -syw*cp,sp,cyw*cp];
 ctx.fillStyle='#101014';ctx.fillRect(0,0,cv.width,cv.height);
 const ps=+document.getElementById('psz').value;
 const img=ctx.getImageData(0,0,cv.width,cv.height),px=img.data,
       W=cv.width,H=cv.height;
 for(let i=0;i<N;i++){
  const p=proj(P[3*i],P[3*i+1],P[3*i+2],M);if(!p)continue;
  const sx=p[0]|0,sy=p[1]|0;
  for(let a=0;a<ps;a++)for(let b=0;b<ps;b++){
   const X=sx+a,Y=sy+b;
   if(X<0||Y<0||X>=W||Y>=H)continue;
   const o=4*(Y*W+X);
   px[o]=colors[3*i];px[o+1]=colors[3*i+1];px[o+2]=colors[3*i+2];
   px[o+3]=255;}}
 ctx.putImageData(img,0,0);
 if(document.getElementById('fr').checked){
  for(const pass of [0,1]){ // normal frusta, then the highlighted one
   ctx.strokeStyle=pass?'#ffd24d':'rgba(150,170,255,0.55)';
   ctx.lineWidth=pass?2:1;
   ctx.beginPath();
   for(let s=0;s<FR.length/6;s++){
    const ishi=SEG>0&&((s/SEG)|0)===hi;
    if(ishi!==!!pass)continue;
    const a=proj(FR[6*s],FR[6*s+1],FR[6*s+2],M),
          b=proj(FR[6*s+3],FR[6*s+4],FR[6*s+5],M);
    if(!a||!b)continue;
    ctx.moveTo(a[0],a[1]);ctx.lineTo(b[0],b[1]);}
   ctx.stroke();}}}
function pickCam(ex,ey){ // nearest projected camera center within 14px
 const cyw=Math.cos(yaw),syw=Math.sin(yaw),
       cp=Math.cos(pitch),sp=Math.sin(pitch);
 const M=[cyw,0,syw, syw*sp,cp,-cyw*sp, -syw*cp,sp,cyw*cp];
 let best=-1,bd=14;
 for(let i=0;i<NC;i++){
  const p=proj(CC[3*i],CC[3*i+1],CC[3*i+2],M);if(!p)continue;
  const d=Math.hypot(p[0]-ex,p[1]-ey);
  if(d<bd){bd=d;best=i;}}
 return best;}
let drag=null,downAt=null;
cv.onmousedown=e=>{drag=[e.clientX,e.clientY,e.shiftKey||e.button===2];
 downAt=[e.clientX,e.clientY];};
addEventListener('mouseup',e=>{
 if(downAt&&Math.hypot(e.clientX-downAt[0],e.clientY-downAt[1])<3){
  hi=pickCam(e.clientX,e.clientY); // click (not drag): pick a camera
  document.getElementById('name').textContent=
   hi>=0?('camera '+hi+': '+D.names[hi]):'';
  draw();}
 drag=null;downAt=null;});
cv.oncontextmenu=e=>e.preventDefault();
addEventListener('mousemove',e=>{if(!drag)return;
 const dx=e.clientX-drag[0],dy=e.clientY-drag[1];
 if(drag[2]){panx+=dx;pany+=dy;}else{yaw+=dx*0.006;
  pitch=Math.min(1.55,Math.max(-1.55,pitch+dy*0.006));}
 drag=[e.clientX,e.clientY,drag[2]];draw();});
cv.onwheel=e=>{e.preventDefault();
 dist*=Math.exp(e.deltaY*0.0012);draw();};
resize();recolor();
</script></body></html>
"""
