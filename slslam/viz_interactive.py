"""Interactive map viewer: self-contained HTML export.

The reference ships a GLFW/OpenGL interactive scene viewer and a live
OpenCV tracking window (src/cplot.cpp:417-433: floor grid, trajectory
polyline, 3D map lines, camera frustum; drawObservation at
cplot.cpp:260-340).  An accelerator host is usually headless, so the
equivalent here is an exported **single-file HTML viewer** — no server, no
external assets, works over any file transfer:

* 3D orbit / pan / zoom (mouse drag, shift-drag, wheel) of the map lines,
  trajectory, ground truth, and a camera frustum marker;
* top-down orthographic toggle (key ``t``);
* keyframe playback (slider + space bar): the frustum walks the
  trajectory and map lines fade in at the keyframe that first observed
  them, reproducing the live-mapping view offline;
* per-keyframe stats readout (observation count, BA iterations) when
  provided.

Everything is vanilla canvas 2D with a hand-rolled perspective projection
— zero dependencies, renders in any browser.
"""

from __future__ import annotations

import json
import os
from typing import List, Optional, Sequence

import numpy as np


def export_interactive_map(out_path: str, trajectory, segments,
                           gt_rows: Optional[np.ndarray] = None,
                           first_seen: Optional[Sequence[int]] = None,
                           frame_stats: Optional[List[dict]] = None,
                           title: str = "slslam map"):
    """Write a self-contained interactive HTML viewer.

    trajectory: list of camera-to-world Pose (engine trajectory()).
    segments: (N, 6) world line segments.
    gt_rows: optional (M, >=4) save_trajectory-format rows for a GT overlay.
    first_seen: optional per-segment keyframe index for playback fade-in.
    frame_stats: optional per-keyframe dicts shown in the readout.
    """
    traj = [[float(x) for x in T.t] for T in trajectory]
    # camera orientation rows (world->cam R is T.R.T for cam-to-world T):
    # we store the cam-to-world rotation to draw the frustum
    rots = [[[float(v) for v in row] for row in T.R] for T in trajectory]
    segs = np.asarray(segments, float).reshape(-1, 6).tolist() \
        if len(np.asarray(segments).reshape(-1)) else []
    gt = None
    if gt_rows is not None and len(gt_rows):
        g = np.asarray(gt_rows, float)
        gt = np.stack([-g[:, 2], -g[:, 3], g[:, 1]], axis=1).tolist()
    fs = [int(i) for i in first_seen] if first_seen is not None else None
    data = dict(traj=traj, rots=rots, segs=segs, gt=gt, first_seen=fs,
                stats=frame_stats, title=title)

    html = _TEMPLATE.replace("__DATA__", json.dumps(data)) \
                    .replace("__TITLE__", title)
    d = os.path.dirname(os.path.abspath(out_path))
    os.makedirs(d, exist_ok=True)
    with open(out_path, "w") as f:
        f.write(html)
    return out_path


_TEMPLATE = r"""<!doctype html>
<meta charset="utf-8">
<title>__TITLE__</title>
<style>
 body{margin:0;background:#101216;color:#d8dce2;font:13px system-ui,sans-serif;overflow:hidden}
 #hud{position:fixed;left:10px;top:8px;pointer-events:none;white-space:pre;
      text-shadow:0 1px 2px #000}
 #bar{position:fixed;left:0;right:0;bottom:0;padding:8px 12px;display:flex;
      gap:10px;align-items:center;background:#181b21cc}
 #bar input[type=range]{flex:1}
 button{background:#2a2f38;color:#d8dce2;border:1px solid #3a404b;
        border-radius:4px;padding:3px 10px;cursor:pointer}
 canvas{display:block}
</style>
<canvas id="c"></canvas>
<div id="hud"></div>
<div id="bar">
 <button id="play">&#9654;</button>
 <input type="range" id="kf" min="0" value="0" step="1">
 <span id="kfl"></span>
 <button id="top">top-down (t)</button>
 <button id="fit">fit (f)</button>
</div>
<script>
const D = __DATA__;
const cv = document.getElementById('c'), ctx = cv.getContext('2d');
const N = D.traj.length, S = D.segs.length;
let kf = Math.max(0, N-1), playing = false, topdown = false;
let yaw = -0.7, pitch = 0.45, dist = 1, cx=0, cy=0, cz=0, panX=0, panY=0;
function fit(){
  let mn=[1e9,1e9,1e9], mx=[-1e9,-1e9,-1e9];
  const acc = p=>{for(let k=0;k<3;k++){mn[k]=Math.min(mn[k],p[k]);mx[k]=Math.max(mx[k],p[k]);}};
  D.traj.forEach(acc);
  D.segs.forEach(s=>{acc(s.slice(0,3));acc(s.slice(3,6));});
  if(D.gt) D.gt.forEach(acc);
  cx=(mn[0]+mx[0])/2; cy=(mn[1]+mx[1])/2; cz=(mn[2]+mx[2])/2;
  dist = 1.6*Math.max(mx[0]-mn[0],mx[1]-mn[1],mx[2]-mn[2],1);
  panX=panY=0;
}
fit();
function resize(){cv.width=innerWidth;cv.height=innerHeight-0;draw();}
addEventListener('resize',resize);
function proj(p){
  // world: x right, y down, z forward (first camera frame). Use -y as up.
  let x=p[0]-cx, y=p[1]-cy, z=p[2]-cz;
  let X,Y,Z;
  if(topdown){ X=x; Y=z; Z=dist; }
  else{
    const cyw=Math.cos(yaw), syw=Math.sin(yaw);
    let x1 =  cyw*x + syw*z, z1 = -syw*x + cyw*z;
    const cp=Math.cos(pitch), sp=Math.sin(pitch);
    let y2 =  cp*y - sp*z1,  z2 = sp*y + cp*z1;
    X=x1; Y=y2; Z=z2+dist;
  }
  if(Z<=0.05) return null;
  const f = 0.9*Math.min(cv.width,cv.height);
  return [cv.width/2 + panX + f*X/Z, cv.height/2 + panY + f*Y/Z];
}
function line(a,b,col,w){
  const A=proj(a), B=proj(b); if(!A||!B) return;
  ctx.strokeStyle=col; ctx.lineWidth=w||1;
  ctx.beginPath(); ctx.moveTo(A[0],A[1]); ctx.lineTo(B[0],B[1]); ctx.stroke();
}
function draw(){
  ctx.fillStyle='#101216'; ctx.fillRect(0,0,cv.width,cv.height);
  // floor grid (y = max-ish plane), 1 m pitch, like cplot's grid
  const g=20;
  for(let i=-g;i<=g;i++){
    line([cx+i, cy+1.5, cz-g],[cx+i, cy+1.5, cz+g],'#1d2128',1);
    line([cx-g, cy+1.5, cz+i],[cx+g, cy+1.5, cz+i],'#1d2128',1);
  }
  // map segments (fade in at first-observing keyframe during playback)
  for(let i=0;i<S;i++){
    if(D.first_seen && D.first_seen[i]>kf) continue;
    const s=D.segs[i];
    const age = D.first_seen ? kf-D.first_seen[i] : 99;
    ctx.globalAlpha = age<3 ? 0.45+0.18*age : 1.0;
    line(s.slice(0,3), s.slice(3,6), '#8a93a3', 1.1);
  }
  ctx.globalAlpha=1.0;
  if(D.gt){ for(let i=1;i<D.gt.length;i++) line(D.gt[i-1],D.gt[i],'#3d7dd4',1.4); }
  for(let i=1;i<=kf && i<N;i++) line(D.traj[i-1],D.traj[i],'#e4593b',2);
  // camera frustum at current kf
  if(N){
    const p=D.traj[kf], R=D.rots[kf], s=0.7;
    const cpt=(u,v,w)=>[p[0]+s*(R[0][0]*u+R[0][1]*v+R[0][2]*w),
                        p[1]+s*(R[1][0]*u+R[1][1]*v+R[1][2]*w),
                        p[2]+s*(R[2][0]*u+R[2][1]*v+R[2][2]*w)];
    const c4=[cpt(-.8,-.6,1),cpt(.8,-.6,1),cpt(.8,.6,1),cpt(-.8,.6,1)];
    for(let i=0;i<4;i++){ line(p,c4[i],'#f4c542',1.5); line(c4[i],c4[(i+1)%4],'#f4c542',1.5);}
  }
  const st = D.stats && D.stats[kf] ? '\n'+Object.entries(D.stats[kf]).map(([k,v])=>k+': '+v).join('\n') : '';
  document.getElementById('hud').textContent =
    D.title+'\nkeyframe '+kf+' / '+(N-1)+'  |  '+S+' map lines'+
    (D.gt?'  |  blue = ground truth':'')+st+
    '\ndrag orbit / shift-drag pan / wheel zoom / t top-down / space play';
  document.getElementById('kfl').textContent = kf+'/'+(N-1);
}
const slider=document.getElementById('kf'); slider.max=Math.max(N-1,0);
slider.value=kf;
slider.oninput=()=>{kf=+slider.value;draw();};
document.getElementById('top').onclick=()=>{topdown=!topdown;draw();};
document.getElementById('fit').onclick=()=>{fit();draw();};
const playBtn=document.getElementById('play');
playBtn.onclick=()=>{playing=!playing;playBtn.innerHTML=playing?'&#10074;&#10074;':'&#9654;';
  if(playing&&kf>=N-1)kf=0; tick();};
function tick(){ if(!playing) return;
  kf=Math.min(kf+1,N-1); slider.value=kf; draw();
  if(kf<N-1) setTimeout(tick,60); else {playing=false;playBtn.innerHTML='&#9654;';}}
let drag=null;
cv.onmousedown=e=>{drag=[e.clientX,e.clientY,e.shiftKey];};
addEventListener('mouseup',()=>drag=null);
addEventListener('mousemove',e=>{ if(!drag) return;
  const dx=e.clientX-drag[0], dy=e.clientY-drag[1];
  if(drag[2]){panX+=dx;panY+=dy;} else {yaw+=dx*0.008;pitch+=dy*0.006;
    pitch=Math.max(-1.5,Math.min(1.5,pitch));}
  drag=[e.clientX,e.clientY,drag[2]]; draw();});
cv.onwheel=e=>{dist*=Math.exp(e.deltaY*0.0012);draw();e.preventDefault();};
addEventListener('keydown',e=>{
  if(e.key==='t'){topdown=!topdown;draw();}
  if(e.key==='f'){fit();draw();}
  if(e.key===' '){playBtn.onclick();e.preventDefault();}
  if(e.key==='ArrowRight'){kf=Math.min(kf+1,N-1);slider.value=kf;draw();}
  if(e.key==='ArrowLeft'){kf=Math.max(kf-1,0);slider.value=kf;draw();}});
resize();
</script>
"""
