"""Self-contained interactive HTML viewer export (counterpart of
hold_tpu/render/html_viewer.py: numpy, base64 and cv2's JPEG on the host; the
page, its template and its scene blob are the JAX package's byte for byte).

Role parity with the reference's aitviewer scene (common/viewer.py:42-301 +
code/visualize_ckpt.py:8-76): an orbit-able 3D scene with the per-frame posed
entity meshes, the camera path, and the source video billboarded at the
active camera — exported as ONE .html file with an inline WebGL2 renderer
(no network deps), so it opens anywhere a browser exists.

Python packs per-frame vertex buffers (float32, base64) + faces + camera
matrices + JPEG billboards into a JSON blob embedded in the page; the JS
side is a ~200-line orbit viewer with flat shading via fragment derivatives.
"""

from __future__ import annotations

import base64
import json
import os

import numpy as np


def _b64(arr: np.ndarray) -> str:
    return base64.b64encode(np.ascontiguousarray(arr).tobytes()).decode()


def pack_scene(
    node_meshes: dict[str, tuple[np.ndarray, np.ndarray]],  # nid -> ((F,V,3), (T,3))
    w2c_all: np.ndarray,  # (F, 4, 4)
    K: np.ndarray,  # (3, 3)
    img_hw: tuple[int, int],
    images: list[np.ndarray] | None = None,  # per-frame uint8 RGB billboards
    colors: dict[str, tuple] | None = None,
    max_frames: int = 120,
) -> dict:
    colors = colors or {
        "right": (0.95, 0.70, 0.55), "left": (0.55, 0.70, 0.95),
        "object": (0.50, 0.85, 0.50),
    }
    F = w2c_all.shape[0]
    stride = max(1, -(-F // max_frames))
    sel = list(range(0, F, stride))

    nodes = []
    for nid, (verts, faces) in node_meshes.items():
        v = np.asarray(verts, np.float32)[sel]
        nodes.append({
            "id": nid,
            "color": list(colors.get(nid, (0.8, 0.8, 0.8))),
            "n_verts": int(v.shape[1]),
            "verts_b64": _b64(v),
            "faces_b64": _b64(np.asarray(faces, np.uint32)),
            "n_faces": int(np.asarray(faces).shape[0]),
        })

    billboards = []
    if images is not None:
        import cv2

        for i in sel:
            img = images[i]
            if img.dtype != np.uint8:
                img = (np.clip(img, 0, 1) * 255).astype(np.uint8)
            ok, buf = cv2.imencode(".jpg", img[:, :, ::-1],
                                   [cv2.IMWRITE_JPEG_QUALITY, 70])
            billboards.append(base64.b64encode(buf.tobytes()).decode() if ok else "")

    return {
        "n_frames": len(sel),
        "frame_ids": sel,
        "nodes": nodes,
        "w2c_b64": _b64(np.asarray(w2c_all, np.float32)[sel]),
        "K": np.asarray(K, np.float32)[:3, :3].tolist(),
        "img_hw": list(img_hw),
        "billboards": billboards,
    }


def export_html_viewer(out_path: str, scene_blob: dict, title: str = "hold_tpu viewer") -> str:
    html = _TEMPLATE.replace("__TITLE__", title).replace(
        "__SCENE_JSON__", json.dumps(scene_blob)
    )
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    with open(out_path, "w") as f:
        f.write(html)
    return out_path


_TEMPLATE = r"""<!doctype html>
<html><head><meta charset="utf-8"><title>__TITLE__</title>
<style>
 body{margin:0;background:#16161a;color:#ddd;font:13px sans-serif;overflow:hidden}
 #hud{position:fixed;left:10px;top:10px;background:#0008;padding:8px 10px;border-radius:6px}
 #hud input[type=range]{width:240px;vertical-align:middle}
 button{background:#333;color:#ddd;border:1px solid #555;border-radius:4px;margin-right:6px}
 canvas{display:block}
</style></head><body>
<canvas id="gl"></canvas>
<div id="hud">
 <button id="play">&#9654;</button>
 <input id="frame" type="range" min="0" value="0" step="1">
 <span id="label"></span><br>
 <label><input id="bb" type="checkbox" checked> video billboard</label>
 <label style="margin-left:10px"><input id="cams" type="checkbox" checked> cameras</label>
 <label style="margin-left:10px"><input id="follow" type="checkbox"> view from camera</label>
 <span id="ents" style="margin-left:10px"></span>
 <span style="margin-left:10px;opacity:.6">drag: orbit &middot; wheel: zoom &middot; right-drag: pan &middot; &larr;/&rarr;: frame</span>
</div>
<script>
const SCENE = __SCENE_JSON__;
function f32(b64){const s=atob(b64);const a=new Uint8Array(s.length);for(let i=0;i<s.length;i++)a[i]=s.charCodeAt(i);return new Float32Array(a.buffer);}
function u32(b64){const s=atob(b64);const a=new Uint8Array(s.length);for(let i=0;i<s.length;i++)a[i]=s.charCodeAt(i);return new Uint32Array(a.buffer);}

const cv=document.getElementById('gl'),gl=cv.getContext('webgl2');
function resize(){cv.width=innerWidth;cv.height=innerHeight;gl.viewport(0,0,cv.width,cv.height);}
addEventListener('resize',resize);resize();

const VS=`#version 300 es
in vec3 p;uniform mat4 mvp,model;out vec3 wp;
void main(){wp=(model*vec4(p,1.)).xyz;gl_Position=mvp*vec4(p,1.);}`;
const FS=`#version 300 es
precision highp float;in vec3 wp;uniform vec3 color;uniform float alpha;out vec4 o;
void main(){vec3 n=normalize(cross(dFdx(wp),dFdy(wp)));
 float l=.45+.55*abs(dot(n,normalize(vec3(.3,.7,.6))));o=vec4(color*l,alpha);}`;
const TVS=`#version 300 es
in vec3 p;in vec2 t;uniform mat4 mvp;out vec2 uv;
void main(){uv=t;gl_Position=mvp*vec4(p,1.);}`;
const TFS=`#version 300 es
precision highp float;in vec2 uv;uniform sampler2D tex;out vec4 o;
void main(){o=vec4(texture(tex,uv).rgb,1.);}`;
const LVS=`#version 300 es
in vec3 p;uniform mat4 mvp;void main(){gl_Position=mvp*vec4(p,1.);}`;
const LFS=`#version 300 es
precision highp float;uniform vec3 color;out vec4 o;void main(){o=vec4(color,1.);}`;
function prog(vs,fs){function sh(t,s){const h=gl.createShader(t);gl.shaderSource(h,s);gl.compileShader(h);
 if(!gl.getShaderParameter(h,gl.COMPILE_STATUS))throw gl.getShaderInfoLog(h);return h;}
 const p=gl.createProgram();gl.attachShader(p,sh(gl.VERTEX_SHADER,vs));gl.attachShader(p,sh(gl.FRAGMENT_SHADER,fs));
 gl.linkProgram(p);return p;}
const P=prog(VS,FS),PT=prog(TVS,TFS),PL=prog(LVS,LFS);

// mat helpers (column-major)
function mul(a,b){const o=new Float32Array(16);for(let c=0;c<4;c++)for(let r=0;r<4;r++){let s=0;for(let k=0;k<4;k++)s+=a[k*4+r]*b[c*4+k];o[c*4+r]=s;}return o;}
function persp(fy,ar,n,f){const t=1/Math.tan(fy/2);return new Float32Array([t/ar,0,0,0, 0,t,0,0, 0,0,(f+n)/(n-f),-1, 0,0,2*f*n/(n-f),0]);}
function lookat(e,c,up){const z=norm3(sub3(e,c)),x=norm3(cross3(up,z)),y=cross3(z,x);
 return new Float32Array([x[0],y[0],z[0],0, x[1],y[1],z[1],0, x[2],y[2],z[2],0, -dot3(x,e),-dot3(y,e),-dot3(z,e),1]);}
function sub3(a,b){return[a[0]-b[0],a[1]-b[1],a[2]-b[2]];}
function cross3(a,b){return[a[1]*b[2]-a[2]*b[1],a[2]*b[0]-a[0]*b[2],a[0]*b[1]-a[1]*b[0]];}
function dot3(a,b){return a[0]*b[0]+a[1]*b[1]+a[2]*b[2];}
function norm3(a){const l=Math.hypot(a[0],a[1],a[2])||1;return[a[0]/l,a[1]/l,a[2]/l];}
const I4=new Float32Array([1,0,0,0,0,1,0,0,0,0,1,0,0,0,0,1]);

// unpack scene
const nodes=SCENE.nodes.map(n=>{
 const verts=f32(n.verts_b64),faces=u32(n.faces_b64);
 const vbo=gl.createBuffer(),ibo=gl.createBuffer();
 gl.bindBuffer(gl.ELEMENT_ARRAY_BUFFER,ibo);
 gl.bufferData(gl.ELEMENT_ARRAY_BUFFER,faces,gl.STATIC_DRAW);
 return{...n,verts,vbo,ibo,idxN:faces.length};});
const w2c=f32(SCENE.w2c_b64);const NF=SCENE.n_frames;
function c2w(i){ // invert rigid w2c (row-major in blob)
 const m=w2c.subarray(i*16,i*16+16);
 const R=[[m[0],m[1],m[2]],[m[4],m[5],m[6]],[m[8],m[9],m[10]]],t=[m[3],m[7],m[11]];
 const Rt=[[R[0][0],R[1][0],R[2][0]],[R[0][1],R[1][1],R[2][1]],[R[0][2],R[1][2],R[2][2]]];
 const c=[-dot3(Rt[0],t),-dot3(Rt[1],t),-dot3(Rt[2],t)];return{R:Rt,c};}

// scene center/extent from frame-0 verts
let ctr=[0,0,0],cnt=0;
for(const n of nodes){for(let v=0;v<n.n_verts;v++){ctr[0]+=n.verts[v*3];ctr[1]+=n.verts[v*3+1];ctr[2]+=n.verts[v*3+2];cnt++;}}
if(cnt){ctr=[ctr[0]/cnt,ctr[1]/cnt,ctr[2]/cnt];}
let rad=0.3;for(const n of nodes){for(let v=0;v<n.n_verts;v+=7){rad=Math.max(rad,Math.hypot(n.verts[v*3]-ctr[0],n.verts[v*3+1]-ctr[1],n.verts[v*3+2]-ctr[2]));}}

// billboard textures (lazy-decoded)
const texs=new Array(NF).fill(null);
function tex(i){if(texs[i]||!SCENE.billboards.length)return texs[i];
 const t=gl.createTexture();gl.bindTexture(gl.TEXTURE_2D,t);
 gl.texImage2D(gl.TEXTURE_2D,0,gl.RGB,1,1,0,gl.RGB,gl.UNSIGNED_BYTE,new Uint8Array([40,40,40]));
 const im=new Image();im.onload=()=>{gl.bindTexture(gl.TEXTURE_2D,t);
  gl.texImage2D(gl.TEXTURE_2D,0,gl.RGB,gl.RGB,gl.UNSIGNED_BYTE,im);
  gl.texParameteri(gl.TEXTURE_2D,gl.TEXTURE_MIN_FILTER,gl.LINEAR);};
 im.src='data:image/jpeg;base64,'+SCENE.billboards[i];texs[i]=t;return t;}

// orbit state
let az=.7,el=.4,dist=rad*3.2,pan=[0,0,0],frame=0,playing=false;
cv.addEventListener('contextmenu',e=>e.preventDefault());
let drag=null;
cv.addEventListener('pointerdown',e=>{drag={x:e.clientX,y:e.clientY,b:e.button};cv.setPointerCapture(e.pointerId);});
cv.addEventListener('pointerup',()=>drag=null);
cv.addEventListener('pointermove',e=>{if(!drag)return;const dx=e.clientX-drag.x,dy=e.clientY-drag.y;drag.x=e.clientX;drag.y=e.clientY;
 if(drag.b===2){const s=dist*0.0015;
  const fwd=[Math.cos(el)*Math.sin(az),Math.sin(el),Math.cos(el)*Math.cos(az)];
  const right=norm3(cross3(fwd,[0,1,0])),up=cross3(right,fwd);
  pan[0]+=(-dx*right[0]+dy*up[0])*s;pan[1]+=(-dx*right[1]+dy*up[1])*s;pan[2]+=(-dx*right[2]+dy*up[2])*s;}
 else{az-=dx*.005;el=Math.max(-1.5,Math.min(1.5,el+dy*.005));}});
cv.addEventListener('wheel',e=>{dist*=Math.exp(e.deltaY*.001);});

const slider=document.getElementById('frame');slider.max=NF-1;
slider.oninput=()=>{frame=+slider.value;};
document.getElementById('play').onclick=()=>{playing=!playing;};
addEventListener('keydown',e=>{ // frame scrub from the keyboard
 if(e.key==='ArrowRight'){frame=(frame+1)%NF;slider.value=frame;}
 if(e.key==='ArrowLeft'){frame=(frame+NF-1)%NF;slider.value=frame;}
 if(e.key===' '){playing=!playing;e.preventDefault();}});
// per-entity visibility toggles (aitviewer scene-tree workflow analog)
const vis={};
for(const n of nodes){vis[n.id]=true;
 const l=document.createElement('label');l.style.marginLeft='10px';
 const c=document.createElement('input');c.type='checkbox';c.checked=true;
 c.onchange=()=>{vis[n.id]=c.checked;};
 l.appendChild(c);l.appendChild(document.createTextNode(' '+n.id));
 document.getElementById('ents').appendChild(l);}
let quadB=gl.createBuffer();

function drawMesh(n,fi){
 gl.useProgram(P);
 gl.bindBuffer(gl.ARRAY_BUFFER,n.vbo);
 gl.bufferData(gl.ARRAY_BUFFER,n.verts.subarray(fi*n.n_verts*3,(fi+1)*n.n_verts*3),gl.DYNAMIC_DRAW);
 const lp=gl.getAttribLocation(P,'p');gl.enableVertexAttribArray(lp);
 gl.vertexAttribPointer(lp,3,gl.FLOAT,false,0,0);
 gl.bindBuffer(gl.ELEMENT_ARRAY_BUFFER,n.ibo);
 gl.uniformMatrix4fv(gl.getUniformLocation(P,'mvp'),false,MVP);
 gl.uniformMatrix4fv(gl.getUniformLocation(P,'model'),false,I4);
 gl.uniform3fv(gl.getUniformLocation(P,'color'),n.color);
 gl.uniform1f(gl.getUniformLocation(P,'alpha'),1.0);
 gl.drawElements(gl.TRIANGLES,n.idxN,gl.UNSIGNED_INT,0);}

function camLines(){ // frusta of every camera + path
 const [H,W]=SCENE.img_hw,K=SCENE.K,d=rad*.35;
 const pts=[];
 for(let i=0;i<NF;i++){const{R,c}=c2w(i);
  const corn=[[0,0],[W,0],[W,H],[0,H]].map(([u,v])=>{
   const x=(u-K[0][2])/K[0][0]*d,y=(v-K[1][2])/K[1][1]*d;
   return[c[0]+R[0][0]*x+R[0][1]*y+R[0][2]*d, c[1]+R[1][0]*x+R[1][1]*y+R[1][2]*d, c[2]+R[2][0]*x+R[2][1]*y+R[2][2]*d];});
  for(let k=0;k<4;k++){pts.push(...c,...corn[k],...corn[k],...corn[(k+1)%4]);}
  if(i+1<NF){const n=c2w(i+1);pts.push(...c,...n.c);}}
 return new Float32Array(pts);}
const camBuf=gl.createBuffer();let camPts=camLines();
gl.bindBuffer(gl.ARRAY_BUFFER,camBuf);gl.bufferData(gl.ARRAY_BUFFER,camPts,gl.STATIC_DRAW);

let MVP=I4,last=0;
function draw(ts){
 if(playing&&ts-last>100){frame=(frame+1)%NF;slider.value=frame;last=ts;}
 gl.enable(gl.DEPTH_TEST);gl.clearColor(.086,.086,.1,1);
 gl.clear(gl.COLOR_BUFFER_BIT|gl.DEPTH_BUFFER_BIT);
 if(document.getElementById('follow').checked){
  // look through the ACTIVE TRAINING CAMERA: OpenCV w2c (x right, y down,
  // z forward, row-major) -> GL view = diag(1,-1,-1) * w2c, column-major
  const m=w2c.subarray(frame*16,frame*16+16);
  const V=new Float32Array([m[0],-m[4],-m[8],0, m[1],-m[5],-m[9],0,
                            m[2],-m[6],-m[10],0, m[3],-m[7],-m[11],1]);
  const fy=2*Math.atan(SCENE.img_hw[0]/(2*SCENE.K[1][1]));
  MVP=mul(persp(fy,cv.width/cv.height,rad*.01,rad*40),V);
 }else{
  const eye=[ctr[0]+pan[0]+dist*Math.cos(el)*Math.sin(az),
             ctr[1]+pan[1]+dist*Math.sin(el),
             ctr[2]+pan[2]+dist*Math.cos(el)*Math.cos(az)];
  const V=lookat(eye,[ctr[0]+pan[0],ctr[1]+pan[1],ctr[2]+pan[2]],[0,1,0]);
  MVP=mul(persp(.9,cv.width/cv.height,rad*.01,rad*40),V);
 }
 for(const n of nodes)if(vis[n.id])drawMesh(n,frame);
 if(document.getElementById('cams').checked){
  gl.useProgram(PL);gl.bindBuffer(gl.ARRAY_BUFFER,camBuf);
  const lp=gl.getAttribLocation(PL,'p');gl.enableVertexAttribArray(lp);
  gl.vertexAttribPointer(lp,3,gl.FLOAT,false,0,0);
  gl.uniformMatrix4fv(gl.getUniformLocation(PL,'mvp'),false,MVP);
  gl.uniform3fv(gl.getUniformLocation(PL,'color'),[.55,.55,.2]);
  gl.drawArrays(gl.LINES,0,camPts.length/3);}
 if(document.getElementById('bb').checked&&SCENE.billboards.length){
  const{R,c}=c2w(frame);const[H,W]=SCENE.img_hw,K=SCENE.K,d=rad*1.6;
  const corn=[[0,0],[W,0],[0,H],[W,H]].map(([u,v])=>{
   const x=(u-K[0][2])/K[0][0]*d,y=(v-K[1][2])/K[1][1]*d;
   return[c[0]+R[0][0]*x+R[0][1]*y+R[0][2]*d, c[1]+R[1][0]*x+R[1][1]*y+R[1][2]*d, c[2]+R[2][0]*x+R[2][1]*y+R[2][2]*d];});
  const q=new Float32Array([...corn[0],0,0, ...corn[1],1,0, ...corn[2],0,1, ...corn[3],1,1]);
  gl.useProgram(PT);gl.bindBuffer(gl.ARRAY_BUFFER,quadB);
  gl.bufferData(gl.ARRAY_BUFFER,q,gl.DYNAMIC_DRAW);
  const lp=gl.getAttribLocation(PT,'p'),lt=gl.getAttribLocation(PT,'t');
  gl.enableVertexAttribArray(lp);gl.vertexAttribPointer(lp,3,gl.FLOAT,false,20,0);
  gl.enableVertexAttribArray(lt);gl.vertexAttribPointer(lt,2,gl.FLOAT,false,20,12);
  gl.uniformMatrix4fv(gl.getUniformLocation(PT,'mvp'),false,MVP);
  gl.bindTexture(gl.TEXTURE_2D,tex(frame));
  gl.drawArrays(gl.TRIANGLE_STRIP,0,4);}
 document.getElementById('label').textContent=
  'frame '+SCENE.frame_ids[frame]+' ('+(frame+1)+'/'+NF+')';
 requestAnimationFrame(draw);}
requestAnimationFrame(draw);
</script></body></html>
"""
