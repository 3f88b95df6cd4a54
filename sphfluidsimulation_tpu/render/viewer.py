"""Interactive WebGL viewer export — the reference's live view, headless.

The reference's user-facing mode is a real-time instanced draw every frame
(SphFluidSimulation.cs:106-107, InstancedIndirectColor.shader:32-44) with
a mouse orbit camera (CameraOrbit.cs:31-74). A headless accelerator has no
swapchain, so the equivalent here is an exported SELF-CONTAINED html file:
recorded rollout snapshots are embedded (base64, uint16-quantized
positions + uint8 speed ramp) and replayed by an inline WebGL1 point
renderer at interactive rates, with the reference's orbit-camera semantics
reimplemented in JS:

* drag to orbit — yaw free, pitch clamped (CameraOrbit.cs:55-58),
* scroll to zoom with a minimum distance (CameraOrbit.cs:63-67),
* speed color ramp blue→red over [low_speed, high_speed]
  (UpdateMeshProperties.compute:62-63) baked per frame,
* world transform pos·simScale − simScale/2 (UpdateMeshProperties.compute:40)
  applied at export.

No external assets or CDNs — the file opens from disk anywhere.
"""

from __future__ import annotations

import base64
import json

import numpy as np


def _quantize(snaps: np.ndarray) -> tuple[bytes, list]:
    """f32[F, N, 3] unit-cube positions -> uint16 little-endian bytes."""
    q = np.clip(snaps, 0.0, 1.0)
    return (q * 65535.0).astype("<u2").tobytes(), list(snaps.shape)


def export_html_viewer(path: str, snapshots: np.ndarray,
                       speeds: np.ndarray | None = None, *,
                       sim_scale: float = 5.0, low_speed: float = 0.0,
                       high_speed: float = 0.5, fps: float = 30.0,
                       point_size: float = 3.0,
                       title: str = "sphfluidsimulation-tpu",
                       refresh_s: float | None = None) -> str:
    """Write a standalone interactive viewer for a snapshot rollout.

    ``snapshots``: f32[F, N, 3] unit-cube positions (e.g. the
    ``snapshot_every`` output of sim.stepper.make_rollout).
    ``speeds``: optional f32[F, N] per-particle speeds for the reference's
    blue→red ramp; None renders constant blue.
    ``refresh_s``: live-run mode (cli ``run --viewer-live``): embed an
    auto-refresh so a browser pointed at the file keeps picking up the
    newest rewrite while the simulation is still running — the headless
    equivalent of the reference's draw-while-simulating view
    (SphFluidSimulation.cs:106-107). None (the default) writes the final
    static file.
    """
    snapshots = np.asarray(snapshots, np.float32)
    if snapshots.ndim != 3 or snapshots.shape[-1] != 3:
        raise ValueError(f"snapshots must be [F, N, 3], got {snapshots.shape}")
    pos_bytes, shape = _quantize(snapshots)
    f, n, _ = shape
    if speeds is not None:
        speeds = np.asarray(speeds, np.float32)
        t = np.clip((speeds - low_speed) / max(high_speed - low_speed, 1e-9),
                    0.0, 1.0)
        spd_b64 = base64.b64encode(
            (t * 255.0).astype(np.uint8).tobytes()).decode()
    else:
        spd_b64 = ""
    meta = {"frames": f, "n": n, "simScale": sim_scale, "fps": fps,
            "pointSize": point_size, "hasSpeed": speeds is not None,
            "live": refresh_s is not None}
    refresh = ("" if refresh_s is None else
               f'<meta http-equiv="refresh" content="{refresh_s:g}">')
    html = _TEMPLATE.replace("__TITLE__", title) \
        .replace("__REFRESH__", refresh) \
        .replace("__META__", json.dumps(meta)) \
        .replace("__POS_B64__", base64.b64encode(pos_bytes).decode()) \
        .replace("__SPD_B64__", spd_b64)
    # atomic replace: a live-mode browser refresh must never read a
    # half-written file
    tmp = path + ".tmp"
    with open(tmp, "w") as fh:
        fh.write(html)
    import os
    os.replace(tmp, path)
    return path


_TEMPLATE = r"""<!DOCTYPE html>
<html><head><meta charset="utf-8">__REFRESH__<title>__TITLE__</title><style>
html,body{margin:0;height:100%;background:#101018;overflow:hidden;
font:12px monospace;color:#ccd}
#hud{position:fixed;left:8px;top:8px;user-select:none}
canvas{display:block;width:100vw;height:100vh}
</style></head><body>
<canvas id="c"></canvas><div id="hud"></div>
<script>
"use strict";
const META = __META__;
function decode(b64){const s=atob(b64);const a=new Uint8Array(s.length);
for(let i=0;i<s.length;i++)a[i]=s.charCodeAt(i);return a;}
const posU16=new Uint16Array(decode("__POS_B64__").buffer);
const spd=META.hasSpeed?decode("__SPD_B64__"):null;
const F=META.frames,N=META.n,S=META.simScale;
const cv=document.getElementById("c"),hud=document.getElementById("hud");
const gl=cv.getContext("webgl");
const vs=`attribute vec3 p;attribute float s;uniform mat4 mvp;
uniform float ps;varying float vs_;
void main(){gl_Position=mvp*vec4(p,1.0);gl_PointSize=ps;vs_=s;}`;
const fs=`precision mediump float;varying float vs_;
void main(){vec2 d=gl_PointCoord-vec2(0.5);
if(dot(d,d)>0.25)discard;
gl_FragColor=vec4(vs_,0.0,1.0-vs_,1.0);}`;
function sh(t,src){const h=gl.createShader(t);gl.shaderSource(h,src);
gl.compileShader(h);return h;}
const pr=gl.createProgram();
gl.attachShader(pr,sh(gl.VERTEX_SHADER,vs));
gl.attachShader(pr,sh(gl.FRAGMENT_SHADER,fs));
gl.linkProgram(pr);gl.useProgram(pr);
const pb=gl.createBuffer(),sb=gl.createBuffer();
const pLoc=gl.getAttribLocation(pr,"p"),sLoc=gl.getAttribLocation(pr,"s");
const mvpLoc=gl.getUniformLocation(pr,"mvp");
const psLoc=gl.getUniformLocation(pr,"ps");
const fpos=new Float32Array(N*3),fspd=new Float32Array(N);
function loadFrame(k){
  const o=k*N*3;
  for(let i=0;i<N*3;i++)fpos[i]=posU16[o+i]/65535.0*S-S*0.5;
  gl.bindBuffer(gl.ARRAY_BUFFER,pb);
  gl.bufferData(gl.ARRAY_BUFFER,fpos,gl.DYNAMIC_DRAW);
  if(spd){const q=k*N;for(let i=0;i<N;i++)fspd[i]=spd[q+i]/255.0;}
  gl.bindBuffer(gl.ARRAY_BUFFER,sb);
  gl.bufferData(gl.ARRAY_BUFFER,fspd,gl.DYNAMIC_DRAW);
}
// orbit camera: CameraOrbit.cs semantics (pitch clamp, min distance)
let yaw=30*Math.PI/180,pitch=20*Math.PI/180,dist=8,drag=null;
const PITCH_MAX=89*Math.PI/180,DIST_MIN=1.5;
cv.addEventListener("mousedown",e=>drag=[e.clientX,e.clientY]);
window.addEventListener("mouseup",()=>drag=null);
window.addEventListener("mousemove",e=>{if(!drag)return;
  yaw+=(e.clientX-drag[0])*0.01;
  pitch=Math.min(PITCH_MAX,Math.max(-PITCH_MAX,
        pitch+(e.clientY-drag[1])*0.01));
  drag=[e.clientX,e.clientY];});
cv.addEventListener("wheel",e=>{e.preventDefault();
  dist=Math.max(DIST_MIN,dist+e.deltaY*0.01);},{passive:false});
let playing=true,frame=META.live?Math.max(F-1,0):0,last=0;
window.addEventListener("keydown",e=>{
  if(e.key===" ")playing=!playing;
  if(e.key==="ArrowRight")frame=(frame+1)%F;
  if(e.key==="ArrowLeft")frame=(frame+F-1)%F;});
function norm(v){const l=Math.hypot(v[0],v[1],v[2]);
  return [v[0]/l,v[1]/l,v[2]/l];}
function cross(a,b){return [a[1]*b[2]-a[2]*b[1],a[2]*b[0]-a[0]*b[2],
  a[0]*b[1]-a[1]*b[0]];}
function dot3(a,b){return a[0]*b[0]+a[1]*b[1]+a[2]*b[2];}
function mat(){
  const cy=Math.cos(yaw),sy=Math.sin(yaw),cp=Math.cos(pitch),
        sp=Math.sin(pitch);
  const eye=[dist*cp*sy,dist*sp,dist*cp*cy];
  const f=norm([-eye[0],-eye[1],-eye[2]]);   // toward origin
  const r=norm(cross(f,[0,1,0]));
  const u=cross(r,f);
  // view (look-at, column-major)
  const V=[r[0],u[0],-f[0],0, r[1],u[1],-f[1],0, r[2],u[2],-f[2],0,
           -dot3(r,eye),-dot3(u,eye),dot3(f,eye),1];
  const asp=cv.width/cv.height,t=Math.tan(0.4),near=0.1,far=100.0;
  const P=[1/(t*asp),0,0,0, 0,1/t,0,0,
           0,0,(far+near)/(near-far),-1, 0,0,2*far*near/(near-far),0];
  // M = P * V (column-major)
  const M=new Float32Array(16);
  for(let c=0;c<4;c++)for(let rr=0;rr<4;rr++){let s=0;
    for(let k=0;k<4;k++)s+=P[k*4+rr]*V[c*4+k];M[c*4+rr]=s;}
  return M;
}
function draw(t){
  if(cv.width!==innerWidth||cv.height!==innerHeight){
    cv.width=innerWidth;cv.height=innerHeight;
    gl.viewport(0,0,cv.width,cv.height);}
  if(playing&&t-last>1000/META.fps){frame=(frame+1)%F;last=t;
    loadFrame(frame);}
  gl.clearColor(0.063,0.063,0.094,1);gl.clear(gl.COLOR_BUFFER_BIT);
  gl.uniformMatrix4fv(mvpLoc,false,mat());
  gl.uniform1f(psLoc,META.pointSize);
  gl.bindBuffer(gl.ARRAY_BUFFER,pb);
  gl.enableVertexAttribArray(pLoc);
  gl.vertexAttribPointer(pLoc,3,gl.FLOAT,false,0,0);
  gl.bindBuffer(gl.ARRAY_BUFFER,sb);
  gl.enableVertexAttribArray(sLoc);
  gl.vertexAttribPointer(sLoc,1,gl.FLOAT,false,0,0);
  gl.drawArrays(gl.POINTS,0,N);
  hud.textContent=`frame ${frame+1}/${F}  n=${N}  `+
    `[space] play/pause  [←→] step  drag=orbit  wheel=zoom`;
  requestAnimationFrame(draw);
}
loadFrame(0);requestAnimationFrame(draw);
</script></body></html>
"""
