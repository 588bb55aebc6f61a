"""Interactive 3D scene plots (cameras + points, pre/post BA) as standalone
HTML.

A copy of the JAX package's utils/plotting.py (reference
code/utils/plot_utils.py:124-186, ``plot_cameras_before_and_after_ba`` with
plotly). Instead of plotly, the viewer is a small self-contained canvas
renderer embedded in the HTML — zero dependencies, works offline, drag to
rotate / wheel to zoom.
"""

from __future__ import annotations

import json
from typing import Dict, List, Optional

import numpy as np

from gasfm_tpu_torch.utils import paths

_VIEWER_JS = """
const state = {rx: -0.6, ry: 0.6, zoom: 1.0, dragging: false, lx: 0, ly: 0};
const canvas = document.getElementById('c');
const ctx = canvas.getContext('2d');
function project(p) {
  const cx = Math.cos(state.rx), sx = Math.sin(state.rx);
  const cy = Math.cos(state.ry), sy = Math.sin(state.ry);
  let [x, y, z] = p;
  let x1 = cy * x + sy * z, z1 = -sy * x + cy * z;
  let y1 = cx * y - sx * z1, z2 = sx * y + cx * z1;
  const s = state.zoom * Math.min(canvas.width, canvas.height) * 0.35;
  return [canvas.width / 2 + s * x1, canvas.height / 2 - s * y1, z2];
}
function draw() {
  ctx.fillStyle = '#111'; ctx.fillRect(0, 0, canvas.width, canvas.height);
  for (const layer of DATA.layers) {
    if (!document.getElementById(layer.id).checked) continue;
    ctx.fillStyle = layer.color;
    for (const p of layer.points) {
      const [px, py] = project(p);
      ctx.fillRect(px - layer.size / 2, py - layer.size / 2, layer.size, layer.size);
    }
  }
  ctx.fillStyle = '#ccc'; ctx.font = '13px sans-serif';
  ctx.fillText(DATA.title, 10, 20);
}
canvas.addEventListener('mousedown', e => {state.dragging = true; state.lx = e.clientX; state.ly = e.clientY;});
window.addEventListener('mouseup', () => state.dragging = false);
window.addEventListener('mousemove', e => {
  if (!state.dragging) return;
  state.ry += (e.clientX - state.lx) * 0.01; state.rx += (e.clientY - state.ly) * 0.01;
  state.lx = e.clientX; state.ly = e.clientY; draw();
});
canvas.addEventListener('wheel', e => {e.preventDefault(); state.zoom *= e.deltaY < 0 ? 1.1 : 0.9; draw();});
document.querySelectorAll('input').forEach(el => el.addEventListener('change', draw));
draw();
"""


def _normalize_points(pts: np.ndarray, center: np.ndarray, scale: float) -> List[List[float]]:
    out = (pts - center) / scale
    out = np.clip(out, -5, 5)
    return [[float(a), float(b), float(c)] for a, b, c in out]


def write_scene_html(path: str, title: str, layers: List[Dict]) -> str:
    """layers: [{id, label, color, size, points (n,3) ndarray}, ...]"""
    all_pts = np.concatenate([l["points"] for l in layers if len(l["points"])], axis=0)
    center = np.median(all_pts, axis=0)
    scale = max(float(np.percentile(np.linalg.norm(all_pts - center, axis=1), 90)), 1e-6)
    data = {
        "title": title,
        "layers": [
            {
                "id": l["id"],
                "color": l["color"],
                "size": l.get("size", 2),
                "points": _normalize_points(np.asarray(l["points"], dtype=np.float64), center, scale),
            }
            for l in layers
        ],
    }
    checkboxes = "".join(
        f'<label style="color:{l["color"]}"><input type="checkbox" id="{l["id"]}" checked> {l["label"]}</label> '
        for l in layers
    )
    html = f"""<!DOCTYPE html><html><head><meta charset="utf-8"><title>{title}</title></head>
<body style="margin:0;background:#111;color:#eee;font-family:sans-serif">
<div style="padding:6px">{checkboxes}</div>
<canvas id="c" width="1200" height="800"></canvas>
<script>const DATA = {json.dumps(data)};{_VIEWER_JS}</script>
</body></html>"""
    with open(path, "w") as f:
        f.write(html)
    return path


def plot_cameras_before_and_after_ba(
    outputs: Dict,
    errors: Dict,
    conf,
    phase,
    scene: str,
    epoch: Optional[int],
    bundle_adjustment: bool,
    additional_identifiers: Optional[List[str]] = None,
) -> str:
    """Parity: reference plot_utils.plot_cameras_before_and_after_ba
    (plot_utils.py:124-186): GT cameras, aligned predicted cameras, aligned
    predicted structure, and (optionally) post-BA cameras/structure."""
    path = paths.path_to_plots(
        conf, phase, epoch=epoch, scene=scene, additional_identifiers=additional_identifiers
    )
    layers = []
    if "cam_centers_gt" in outputs:
        layers.append({"id": "gt_cams", "label": "GT cameras", "color": "#4dd2ff",
                       "size": 5, "points": outputs["cam_centers_gt"]})
    if "ts_fixed" in outputs:
        layers.append({"id": "pred_cams", "label": "Pred cameras (aligned)", "color": "#ff9f43",
                       "size": 5, "points": outputs["ts_fixed"]})
    if outputs.get("pts3D_pred_fixed") is not None:
        pts = outputs["pts3D_pred_fixed"]
        pts = (pts[:3] / np.where(pts[3:] == 0, 1.0, pts[3:])).T
        layers.append({"id": "pred_pts", "label": "Pred points", "color": "#a0a0a0",
                       "size": 1, "points": pts})
    if bundle_adjustment and "ts_ba_fixed" in outputs:
        layers.append({"id": "ba_cams", "label": "Post-BA cameras", "color": "#2ecc71",
                       "size": 5, "points": outputs["ts_ba_fixed"]})
        if outputs.get("Xs_ba_fixed") is not None:
            pts = outputs["Xs_ba_fixed"]
            pts = (pts[:3] / np.where(pts[3:] == 0, 1.0, pts[3:])).T
            layers.append({"id": "ba_pts", "label": "Post-BA points", "color": "#5e8d5a",
                           "size": 1, "points": pts})
    title = f"{scene} — R_err_mean={errors.get('R_err_mean', float('nan')):.3f}°, " \
            f"our_repro={errors.get('our_repro', float('nan')):.3f}px"
    return write_scene_html(path, title, layers)
