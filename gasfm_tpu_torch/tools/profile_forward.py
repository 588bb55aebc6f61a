"""Where a forward request's time goes on the card.

    python -m gasfm_tpu_torch.tools.profile_forward [--scene dense|powerlaw] [--requests 3]

Builds the flagship GraphAttnSfMNet (9 layers, 4 heads, widths
32/64/1024/2048, seeded init) and one of the two synthetic bench scenes,
warms up with two requests, then traces ``--requests`` requests (forward +
ESFM loss through ``TrainingSession``) with ``torch.profiler``. Prints the
wall time per request, the device time per kernel name (top 15), the
hand-written kernels' share, the number of kernel launches per request, and
the device busy share: summed kernel time over wall time (one stream, so
kernels never overlap). Writes the Chrome trace to
``chiprun_out/profile_forward_<scene>.json``.
"""

from __future__ import annotations

import argparse
import collections
import time
from pathlib import Path

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from gasfm_tpu_torch.data.synthetic import generate_synthetic_scene
from gasfm_tpu_torch.losses import ESFMLoss
from gasfm_tpu_torch.models.gasfm import GraphAttnSfMNet
from gasfm_tpu_torch.train.loop import TrainingSession
from gasfm_tpu_torch.utils.device import resolve_device

# The flagship GASFM (confs/gasfm/optim_euc_gasfm.conf) and the two synthetic
# bench scenes of the JAX package's bench.py: dense (~116k edges, 14 edges
# per point) and power-law track lengths (~70k edges, 3 edges per point).
FLAGSHIP = dict(num_layers=9, n_heads=4, n_feat_proj=32, n_feat_scenepoint=64,
                n_feat_view=1024, n_feat_global=2048, stateful_global_features=True,
                add_skipconn_from_init_projfeat=True)
SCENES = {
    "dense": dict(n_views=128, n_points=8192, visibility=0.2, seed=0),
    "powerlaw": dict(n_views=133, n_points=24576, track_length_dist="powerlaw", seed=0),
}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--scene", choices=sorted(SCENES), default="dense")
    ap.add_argument("--requests", type=int, default=3)
    ap.add_argument("--device", default=None, help="default: cuda")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    model = GraphAttnSfMNet(**FLAGSHIP, generator=torch.Generator().manual_seed(0))
    session = TrainingSession(model, ESFMLoss(1e-4, True, 1.0), device=dev)
    scene = generate_synthetic_scene(**SCENES[args.scene]).to_scene_graph(device=dev)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)

    def request():
        session.loss(session.forward(scene), scene)

    for _ in range(2):
        request()
    sync()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if dev.type == "cuda" else [])
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        for _ in range(args.requests):
            request()
        sync()
        wall_us = (time.perf_counter() - t0) * 1e6

    kernels = collections.defaultdict(lambda: [0, 0.0])
    for evt in prof.events():
        if evt.device_type == DeviceType.CUDA:
            k = kernels[evt.name]
            k[0] += 1
            k[1] += evt.time_range.elapsed_us()
    total = sum(t for _, t in kernels.values())
    ours = sum(t for name, (_, t) in kernels.items() if "gasfm::" in name)
    launches = sum(c for c, _ in kernels.values())
    R = args.requests
    g = scene.graph
    print(f"scene {args.scene}: {g.num_cams} views, {g.num_pts} points, {g.num_edges} edges; "
          f"device {torch.cuda.get_device_name(dev) if dev.type == 'cuda' else 'cpu'}")
    print(f"wall {wall_us / R / 1e3:.3f} ms/request; device kernel time "
          f"{total / R / 1e3:.3f} ms/request; device busy share {total / wall_us:.4f}; "
          f"{launches / R:.1f} kernel launches/request; hand-written kernels "
          f"{ours / R / 1e3:.3f} ms/request ({ours / max(total, 1e-9):.4f} of device time)")
    for name, (count, t) in sorted(kernels.items(), key=lambda kv: -kv[1][1])[:15]:
        print(f"  {t / R / 1e3:9.4f} ms/request  {count / R:6.1f} launches/request  {name[:110]}")
    out = Path(__file__).resolve().parents[2] / "chiprun_out"
    out.mkdir(exist_ok=True)
    prof.export_chrome_trace(str(out / f"profile_forward_{args.scene}.json"))


if __name__ == "__main__":
    main()
