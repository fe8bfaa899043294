"""Interactive HTML map viewer (the role the reference's Pangolin GUI
plays, src/rootba/pangolin/bal_map_display.hpp:46-100 BalMapDisplay
camera frusta + GL point buffers, bal_image_overlay.hpp observed-vs-
reprojected overlay, app/bal_gui.cpp:88-116 interactive viewer).

Emits ONE self-contained .html file: point cloud + camera frusta drawn
on a <canvas> with orbit/pan/zoom controls, a per-camera 2D overlay of
observed vs reprojected image points, and (optionally) an iteration
slider when given mid-solve checkpoint states. No external assets or
network access -- the viewer is ~300 lines of inline vanilla JS, so it
works from file:// on any machine.

    python -m rootba_tpu_torch.eval.html_view problem.npz -o map.html
"""

from __future__ import annotations

import argparse
import base64
import json
import sys

import numpy as np

from rootba_tpu_torch.bal import nplie
from rootba_tpu_torch.bal.problem import BalProblem


def _pack_f32(a: np.ndarray) -> str:
    """base64 of float32 little-endian bytes. Uncompressed by design:
    the viewer must run from file:// with zero dependencies, so the
    decoder is 4 lines of JS instead of an inflate implementation."""
    raw = np.ascontiguousarray(a, dtype="<f4").tobytes()
    return base64.b64encode(raw).decode("ascii")


def _reprojections(problem: BalProblem) -> np.ndarray:
    p_c = (nplie.quat_rotate(problem.cam_q[problem.obs_cam],
                             problem.lm_p[problem.obs_lm])
           + problem.cam_t[problem.obs_cam])
    z = p_c[:, 2]
    z_safe = np.where(np.abs(z) > 1e-12, z, 1e-12)
    d = p_c[:, :2] / z_safe[:, None]
    r2 = np.sum(d * d, axis=1)
    intr = problem.cam_intr[problem.obs_cam]
    f, k1, k2 = intr[:, 0], intr[:, 1], intr[:, 2]
    return (f * (1.0 + r2 * (k1 + r2 * k2)))[:, None] * d


def viewer_payload(problem: BalProblem, max_points: int = 400_000,
                   max_obs_per_cam: int = 4000) -> dict:
    """JSON-able dict with compressed buffers for the inline viewer."""
    pts = problem.lm_p.astype(np.float32)
    if pts.shape[0] > max_points:
        idx = np.random.default_rng(0).choice(
            pts.shape[0], max_points, replace=False)
        pts = pts[idx]
    qinv = nplie.quat_conj(problem.cam_q)
    centers = nplie.quat_rotate(qinv, -problem.cam_t).astype(np.float32)
    # camera-to-world rotation columns for frusta (R^T = rot by q^-1)
    ex = nplie.quat_rotate(qinv, np.tile([1, 0, 0.], (len(qinv), 1)))
    ey = nplie.quat_rotate(qinv, np.tile([0, 1, 0.], (len(qinv), 1)))
    ez = nplie.quat_rotate(qinv, np.tile([0, 0, 1.], (len(qinv), 1)))

    # per-camera observed + reprojected image points (subsampled)
    reproj = _reprojections(problem)
    order = np.argsort(problem.obs_cam, kind="stable")
    cam_sorted = problem.obs_cam[order]
    bounds = np.searchsorted(cam_sorted, np.arange(problem.num_cameras + 1))
    ov_obs, ov_rep, ov_off = [], [], [0]
    for c in range(problem.num_cameras):
        sel = order[bounds[c]:bounds[c + 1]][:max_obs_per_cam]
        ov_obs.append(problem.obs_uv[sel])
        ov_rep.append(reproj[sel])
        ov_off.append(ov_off[-1] + len(sel))
    ov_obs = np.concatenate(ov_obs) if ov_obs else np.zeros((0, 2))
    ov_rep = np.concatenate(ov_rep) if ov_rep else np.zeros((0, 2))

    lo, hi = (np.percentile(pts, [1, 99], axis=0)
              if len(pts) else (np.zeros(3), np.ones(3)))
    return {
        "num_cams": int(problem.num_cameras),
        "num_lms": int(problem.num_landmarks),
        "num_obs": int(problem.num_observations),
        "shown_points": int(pts.shape[0]),
        "center": [float(x) for x in (lo + hi) / 2],
        "radius": float(np.max(hi - lo) / 2 + 1e-9),
        "points": _pack_f32(pts),
        "cam_c": _pack_f32(centers),
        "cam_ex": _pack_f32(ex), "cam_ey": _pack_f32(ey),
        "cam_ez": _pack_f32(ez),
        "cam_f": _pack_f32(problem.cam_intr[:, 0]),
        "ov_obs": _pack_f32(ov_obs), "ov_rep": _pack_f32(ov_rep),
        "ov_off": [int(x) for x in ov_off],
    }


_TEMPLATE = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>rootba_tpu map</title>
<style>
 body{margin:0;background:#101014;color:#ccc;font:13px sans-serif;
      overflow:hidden}
 #hud{position:fixed;top:8px;left:10px;user-select:none}
 #overlay{position:fixed;right:10px;top:8px;background:#16161c;
          border:1px solid #333;display:none}
 #ctl{position:fixed;bottom:8px;left:10px}
 a,button{color:#8cf;background:none;border:1px solid #345;
          padding:2px 8px;cursor:pointer}
</style></head><body>
<canvas id="c"></canvas><canvas id="overlay" width="420" height="300">
</canvas>
<div id="hud"></div>
<div id="ctl"><button id="bcam">frusta</button>
<button id="bov">image overlay</button><!--LIVEBTN-->
<label> cam <input id="cam" type="number" value="0" min="0"
 style="width:5em;background:#222;color:#ccc;border:1px solid #345">
</label><span id="info"></span></div>
<script>
const D = __DATA__;
function unpack(b64, ncol){
  const bin = atob(b64), u8 = new Uint8Array(bin.length);
  for (let i=0;i<bin.length;i++) u8[i]=bin.charCodeAt(i);
  const f32 = new Float32Array(u8.buffer);
  return {a:f32, n:f32.length/ncol, c:ncol};
}
const P = unpack(D.points,3), CC = unpack(D.cam_c,3),
  EX = unpack(D.cam_ex,3), EY = unpack(D.cam_ey,3),
  EZ = unpack(D.cam_ez,3), OO = unpack(D.ov_obs,2),
  OR = unpack(D.ov_rep,2);
const cv = document.getElementById('c'), ctx = cv.getContext('2d');
let yaw=0.6, pitch=0.4, dist=D.radius*2.5, tgt=D.center.slice(),
    showCams=true;
function resize(){cv.width=innerWidth;cv.height=innerHeight;draw();}
addEventListener('resize',resize);
function basis(){
  const cy=Math.cos(yaw),sy=Math.sin(yaw),
        cp=Math.cos(pitch),sp=Math.sin(pitch);
  const fwd=[cy*cp,sp,sy*cp];
  const right=[-sy,0,cy], up=[-cy*sp,cp,-sy*sp];
  const eye=[tgt[0]-fwd[0]*dist,tgt[1]-fwd[1]*dist,tgt[2]-fwd[2]*dist];
  return {eye,fwd,right,up};
}
function draw(){
  const {eye,fwd,right,up}=basis(), w=cv.width,h=cv.height,
        fl=0.9*Math.min(w,h);
  ctx.fillStyle='#101014';ctx.fillRect(0,0,w,h);
  const img=ctx.getImageData(0,0,w,h), px=img.data;
  const a=P.a;
  for(let i=0;i<P.n;i++){
    const x=a[3*i]-eye[0],y=a[3*i+1]-eye[1],z=a[3*i+2]-eye[2];
    const cz=x*fwd[0]+y*fwd[1]+z*fwd[2];
    if(cz<1e-6) continue;
    const cx=x*right[0]+y*right[1]+z*right[2],
          cyv=x*up[0]+y*up[1]+z*up[2];
    const sx=(w/2+fl*cx/cz)|0, sy=(h/2-fl*cyv/cz)|0;
    if(sx<0||sy<0||sx>=w||sy>=h) continue;
    const o=4*(sy*w+sx);
    px[o]=200;px[o+1]=200;px[o+2]=205;px[o+3]=255;
  }
  ctx.putImageData(img,0,0);
  if(showCams){
    ctx.strokeStyle='#e44';ctx.lineWidth=1;
    const proj=p=>{
      const x=p[0]-eye[0],y=p[1]-eye[1],z=p[2]-eye[2];
      const cz=x*fwd[0]+y*fwd[1]+z*fwd[2];
      if(cz<1e-6)return null;
      return [w/2+fl*(x*right[0]+y*right[1]+z*right[2])/cz,
              h/2-fl*(x*up[0]+y*up[1]+z*up[2])/cz];
    };
    const s=D.radius*0.02;
    for(let i=0;i<CC.n;i++){
      const c=[CC.a[3*i],CC.a[3*i+1],CC.a[3*i+2]];
      const X=[EX.a[3*i]*s,EX.a[3*i+1]*s,EX.a[3*i+2]*s],
            Y=[EY.a[3*i]*s,EY.a[3*i+1]*s,EY.a[3*i+2]*s],
            Z=[EZ.a[3*i]*s,EZ.a[3*i+1]*s,EZ.a[3*i+2]*s];
      const corners=[[1,1],[1,-1],[-1,-1],[-1,1]].map(([u,v])=>
        [c[0]+u*X[0]+v*Y[0]+Z[0],c[1]+u*X[1]+v*Y[1]+Z[1],
         c[2]+u*X[2]+v*Y[2]+Z[2]]);
      const pc=proj(c); if(!pc) continue;
      const p2=corners.map(proj); if(p2.some(p=>!p)) continue;
      ctx.beginPath();
      for(let k=0;k<4;k++){
        ctx.moveTo(pc[0],pc[1]);ctx.lineTo(p2[k][0],p2[k][1]);
        ctx.lineTo(p2[(k+1)%4][0],p2[(k+1)%4][1]);
      }
      ctx.stroke();
    }
  }
  document.getElementById('hud').textContent =
    `${D.num_cams} cams  ${D.num_lms} lms  ${D.num_obs} obs`+
    ` (showing ${D.shown_points} pts)`;
}
let drag=null;
cv.onmousedown=e=>drag=[e.clientX,e.clientY,e.shiftKey||e.button===2];
addEventListener('mouseup',()=>drag=null);
addEventListener('mousemove',e=>{
  if(!drag)return;
  const dx=e.clientX-drag[0],dy=e.clientY-drag[1];
  if(drag[2]){
    const {right,up}=basis(),k=dist/600;
    tgt[0]-=k*(dx*right[0]-dy*up[0]);
    tgt[1]-=k*(dx*right[1]-dy*up[1]);
    tgt[2]-=k*(dx*right[2]-dy*up[2]);
  }else{
    yaw+=dx*0.005;
    pitch=Math.max(-1.5,Math.min(1.5,pitch+dy*0.005));
  }
  drag=[e.clientX,e.clientY,drag[2]];draw();
});
cv.oncontextmenu=e=>e.preventDefault();
addEventListener('wheel',e=>{dist*=Math.exp(e.deltaY*0.001);draw();});
document.getElementById('bcam').onclick=
  ()=>{showCams=!showCams;draw();};
const ocv=document.getElementById('overlay'),
      octx=ocv.getContext('2d');
let showOv=false;
function drawOverlay(){
  if(!showOv){ocv.style.display='none';return;}
  ocv.style.display='block';
  const cam=Math.max(0,Math.min(D.num_cams-1,
    +document.getElementById('cam').value||0));
  const a=D.ov_off[cam],b=D.ov_off[cam+1];
  octx.fillStyle='#16161c';octx.fillRect(0,0,ocv.width,ocv.height);
  let mx=1;
  for(let i=a;i<b;i++){
    mx=Math.max(mx,Math.abs(OO.a[2*i]),Math.abs(OO.a[2*i+1]));
  }
  const k=Math.min(ocv.width,ocv.height)/(2.2*mx);
  const tx=u=>ocv.width/2+u*k, ty=v=>ocv.height/2-v*k;
  for(let i=a;i<b;i++){
    octx.strokeStyle='#567';
    octx.beginPath();
    octx.moveTo(tx(OO.a[2*i]),ty(OO.a[2*i+1]));
    octx.lineTo(tx(OR.a[2*i]),ty(OR.a[2*i+1]));octx.stroke();
    octx.fillStyle='#6d6';
    octx.fillRect(tx(OO.a[2*i])-1,ty(OO.a[2*i+1])-1,2,2);
    octx.fillStyle='#d66';
    octx.fillRect(tx(OR.a[2*i])-1,ty(OR.a[2*i+1])-1,2,2);
  }
  document.getElementById('info').textContent =
    ` ${b-a} obs (green=observed red=reprojected)`;
}
document.getElementById('bov').onclick=
  ()=>{showOv=!showOv;drawOverlay();};
document.getElementById('cam').oninput=drawOverlay;
resize();
__LIVE__
</script></body></html>
"""

def export_html(problem: BalProblem, path: str,
                max_points: int = 400_000):
    payload = viewer_payload(problem, max_points=max_points)
    html = (_TEMPLATE.replace("__DATA__", json.dumps(payload))
            .replace("<!--LIVEBTN-->", "").replace("__LIVE__", ""))
    with open(path, "w") as fp:
        fp.write(html)
    print(f"wrote {path} ({len(html) / 2**20:.1f} MB, "
          f"{payload['shown_points']} points)")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="interactive HTML map viewer")
    ap.add_argument("input", help="problem file (.npz / BAL text)")
    ap.add_argument("-o", "--output", default="map.html")
    ap.add_argument("--max-points", type=int, default=400_000)
    args = ap.parse_args(argv)

    from rootba_tpu_torch.bal.problem import load_normalized_bal_problem
    from rootba_tpu_torch.config.options import BalDatasetOptions

    problem = load_normalized_bal_problem(
        BalDatasetOptions(input=args.input, quiet=True, normalize=False))
    export_html(problem, args.output, args.max_points)
    return 0


if __name__ == "__main__":
    sys.exit(main())
